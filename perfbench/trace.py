"""The traced window: ``torch.profiler`` over the card, reduced to what
the per-layer readers and the ``breakdown`` need.

``chip_smoke.py``'s method (kernel time by name from the profiler's
records): in a long process the profiler was found now and then to drop
kernel records, so a window counts only when it holds as
many records of each checked kernel as the port's launch counters say
were launched; otherwise the run traces a shorter window.  The checked
kernels are ``CHECKED`` and those a configuration names (``kernels``).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

SHORT_GAP_S = 50e-6       # idle gaps shorter than this are launch gaps


# the kernels every window is checked for: {substring of the kernel's
# name: "<module of the port>:<wrapper with a .launches counter>"}
CHECKED = {"sidekit_fe_kernel": "dsp.fe_kernel:sidekit_features",
           "viterbi_kernel": "decode.viterbi:viterbi_scan"}


def kernel_counters(config=None):
    """The port's launch counters by the name of the kernel each
    launches: ``CHECKED`` and the configuration's ``kernels``, which a
    configuration that brings a kernel of its own names the same way."""
    import importlib

    out = {}
    for key, where in dict(CHECKED, **(config or {}).get("kernels",
                                                          {})).items():
        mod, _, attr = where.partition(":")
        wrapper = getattr(importlib.import_module(
            "inaspeechsegmenter_tpu_torch." + mod), attr, None)
        if not hasattr(wrapper, "launches"):
            raise ValueError(f"kernels: {key!r} names {where!r}, which is "
                             f"no wrapper of the port with a .launches "
                             f"counter")
        out[key] = wrapper
    return out


def launches(config=None):
    return {k: w.launches for k, w in kernel_counters(config).items()}


def traced(fn, cuda=True, config=None):
    """``fn()`` under the profiler -> (fn's value, profiler, window
    seconds, launch deltas of ``config``'s counters).  ``cuda=False``
    (the CPU tests) traces the host alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    sync()
    before = launches(config)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        value = fn()
        sync()
        window = time.perf_counter() - t0
    after = launches(config)
    return value, prof, window, {k: after[k] - before[k] for k in after}


def reduce(prof, window_s, launched):
    """-> dict(complete, kernels {name: [records, seconds]}, busy_s,
    window_s, device_ops, idle_gaps)."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CPU:
            cpu.append((e.time_range.start, e.time_range.end, e.name))
    kernels = defaultdict(lambda: [0, 0.0])
    for a, b, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (b - a) * 1e-6
    complete = all(sum(v[0] for n, v in kernels.items() if key in n) == cnt
                   for key, cnt in launched.items())
    dev.sort()
    busy, gaps = 0.0, []
    end = None
    for a, b, _ in dev:
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    cpu.sort()
    starts = [c[0] for c in cpu]
    idle = defaultdict(float)
    for a, b in gaps:
        d = (b - a) * 1e-6
        if d < SHORT_GAP_S:
            idle["launch gaps under 50 us"] += d
            continue
        idle[_host_at(cpu, starts, 0.5 * (a + b))] += d
    top = sorted(((n, v[1]) for n, v in kernels.items()),
                 key=lambda x: -x[1])[:10]
    return {"complete": complete, "kernels": dict(kernels),
            "busy_s": busy * 1e-6, "window_s": window_s,
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n[:120], s] for n, s in sorted(
                idle.items(), key=lambda x: -x[1])[:10]]}


def _host_at(cpu, starts, t, scan=4000):
    """What the host was doing at ``t``: the latest-starting host event
    that covers it."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        if cpu[j][1] >= t:
            return "host: " + cpu[j][2]
    return "host: Python outside any profiled op"


def kernel_seconds(red, key):
    """Records and device seconds of the kernels whose name holds
    ``key``."""
    n = s = 0
    for name, (c, sec) in red["kernels"].items():
        if key in name:
            n += c
            s += sec
    return n, s
