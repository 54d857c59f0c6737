"""The program's own spans and counters in a traced window.

The port times its layers with ``utils.timing.span`` (host seconds and
calls, always; a ``record_function`` region while a profiler records) and
counts with ``utils.timing.count``.  Two readings of them go into the
reduced trace:

- ``program``: the change of ``utils.timing.snapshot()`` over the traced
  attempt, every thread's spans and counters (``snapshot`` / ``delta``);
- ``spans``: the user annotations of the profile named like the program's
  spans, with their host seconds, calls and the device seconds of the
  kernels launched under them, children included (``reduce_spans``).  The
  benchmark's profiler records the thread that drives the cell's calls
  alone, so these are that thread's spans.

``run.py``'s traced attempt takes both readings (``red["spans"]``,
``red["program"]``); a metric's reader reads them through ``host_s``,
``device_s`` and ``counter``.  Where a reduced trace lacks the readings,
the accessors return None.
"""

from __future__ import annotations

import bisect

# the first word of every span name of the port (``utils/timing.py``)
PREFIXES = ("prefetch.", "seg.", "cnn.", "vfs.", "xvec.")


def snapshot():
    """``utils.timing.snapshot()`` of the port."""
    from inaspeechsegmenter_tpu_torch.utils import timing

    return timing.snapshot()


def delta(before, after):
    """What the spans and counters gained from ``before`` to ``after``:
    {"spans": {name: [seconds, calls]}, "counters": {name: n}}."""
    spans = {}
    for name, (s, c) in after["spans"].items():
        s0, c0 = before["spans"].get(name, (0.0, 0))
        if c > c0:
            spans[name] = [s - s0, c - c0]
    counters = {k: n - before["counters"].get(k, 0)
                for k, n in after["counters"].items()
                if n != before["counters"].get(k, 0)}
    return {"spans": spans, "counters": counters}


def reduce_spans(prof):
    """-> {name: {"device_s", "host_s", "calls"}} of the profile's host
    user annotations named like the program's spans (the profiler's own
    records, ``kineto_results``)."""
    return span_times(prof.profiler.kineto_results.events())


def span_times(events):
    """``reduce_spans`` on the profiler's records.

    A device record (kernel, copy or memset) launched inside a recorded
    PyTorch operator holds that operator's id (``linked_correlation_id``)
    and the id of its launch (``correlation_id``); the host record of the
    launch holds the same pair.  The launch's host time places the work
    in every span open then, each name once.  Work launched outside a
    recorded operator belongs to no span: the port's ctypes kernels, and
    every launch of a thread the profiler does not record.  The pair is
    matched, not one id, because the profiler numbers operators and
    launches apart and the two numberings meet.  A launch is placed by its
    time, not its thread, because every record carries the same thread;
    so the spans must be one thread's, as under the benchmark's profiler
    of one thread."""
    from torch.autograd import DeviceType

    spans, launches, work = [], {}, []
    for e in events:
        cpu = e.device_type() == DeviceType.CPU
        if e.is_user_annotation():
            if cpu and e.name().startswith(PREFIXES):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              e.name()))
        elif e.linked_correlation_id() > 0:
            key = (e.correlation_id(), e.linked_correlation_id())
            if cpu:
                launches[key] = e.start_ns()
            else:
                work.append((key, e.duration_ns()))
    spans.sort(key=lambda s: (s[0], -s[1]))     # a parent before its child
    out = {}
    for a, b, name in spans:
        r = out.setdefault(name, {"device_s": 0.0, "host_s": 0.0,
                                  "calls": 0})
        r["host_s"] += (b - a) * 1e-9
        r["calls"] += 1
    # each span's parent: spans of one thread nest
    parent, stack = [], []
    for i, (a, b, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] < b:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(i)
    starts = [a for a, _, _ in spans]
    for key, ns in work:
        t = launches.get(key)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        seen = set()
        while i is not None and i >= 0:
            a, b, name = spans[i]
            if b >= t and name not in seen:
                seen.add(name)
                out[name]["device_s"] += ns * 1e-9
            i = parent[i]
    return out


# -- the readers' access -----------------------------------------------------

def host_s(ctx, name):
    """Host seconds of span ``name`` over the traced attempt (every
    thread), or None where the reduced trace has no ``program``."""
    prog = ctx["trace"].get("program")
    if prog is None:
        return None
    return prog["spans"].get(name, [0.0, 0])[0]


def device_s(ctx, name):
    """Device seconds of the kernels under span ``name`` (the profiled
    thread's), or None where there are none."""
    r = ctx["trace"].get("spans", {}).get(name)
    return r["device_s"] if r and r["device_s"] else None


def counter(ctx, name):
    """Counter ``name``'s gain over the traced attempt, or None where the
    reduced trace has no ``program``."""
    prog = ctx["trace"].get("program")
    if prog is None:
        return None
    return prog["counters"].get(name, 0)
