"""The constructors' bounded guard before their first touch of the card.

Counterpart of ``inaspeechsegmenter_tpu/utils/env.py``.  ``Segmenter()``,
``DnnSegmenter()`` and ``VoiceFemininityScoring()`` on a CUDA device call
``torch.cuda.is_available()``, then upload their weights; on a driver
that stalls (a wedged card, a node whose driver hangs in ``cuInit``) the
first of these blocks in the calling process, where nothing can cancel
it.  :func:`require_device` probes the driver first, in a subprocess that
can be killed, and raises a ``TimeoutError`` after ``ISS_CTOR_LINK_WAIT``
seconds (default 600; ``<= 0`` skips the guard) instead of hanging.

The probe does not import ``torch`` (whose import costs seconds): it
loads ``libcuda.so.1`` through ``ctypes`` and calls ``cuInit``,
``cuDeviceGetCount``, ``cuDeviceGet`` and a primary-context retain and
release of the device asked for.  A driver that answers "no device" ends
the guard at once: the constructor's own device check then names the
fault.

The JAX package's ``apply_platform_env`` has no counterpart: the port's
device is an explicit argument, never a process-wide platform choice.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

# one successful probe, or a CUDA context this process already made,
# covers every later constructor in the process
_DEVICE_OK = False

# exit 0 when the driver gives a context on device ORDINAL; the ordinal
# is the process's own (CUDA_VISIBLE_DEVICES applies as in torch)
PROBE_CODE = """\
import ctypes, sys
try:
    lib = ctypes.CDLL("libcuda.so.1")
except OSError:
    sys.exit(3)
n, dev, ctx = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_void_p()
release = getattr(lib, "cuDevicePrimaryCtxRelease_v2", None) \\
    or lib.cuDevicePrimaryCtxRelease
if lib.cuInit(0) or lib.cuDeviceGetCount(ctypes.byref(n)):
    sys.exit(4)
if n.value <= ORDINAL or lib.cuDeviceGet(ctypes.byref(dev), ORDINAL):
    sys.exit(5)
if lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev) or release(dev):
    sys.exit(6)
"""


def probe_device(device="cuda", timeout=120.0):
    """One probe of the driver in a subprocess -> True (a context was
    made on ``device``), False (the driver answered without one: no
    driver, no such device) or None (no answer within ``timeout`` s; the
    child is killed)."""
    device = torch.device(device)
    code = PROBE_CODE.replace("ORDINAL", str(device.index or 0))
    try:
        r = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return None
    return r.returncode == 0


def _wait(device, max_wait, probe_timeout, retry_failed):
    """Probe until an answer (or, with ``retry_failed``, until a context)
    or ``max_wait`` s have passed -> the last probe's result."""
    global _DEVICE_OK
    deadline = time.monotonic() + max_wait
    while True:
        left = deadline - time.monotonic()
        r = probe_device(device, max(0.1, min(probe_timeout, left)))
        if r:
            _DEVICE_OK = True       # constructors need no second probe
            return True
        if (r is False and not retry_failed) or time.monotonic() >= deadline:
            return r
        print("[wait_for_device] the CUDA driver did not give a context; "
              "retrying", file=sys.stderr, flush=True)
        if r is False:
            time.sleep(min(1.0, max(0.0, deadline - time.monotonic())))


def wait_for_device(max_wait=1800.0, probe_timeout=120.0, device="cuda"):
    """Block until the driver gives a context on ``device``, or give up:
    True when it does, False when ``max_wait`` seconds pass first.  Each
    probe runs in a subprocess killed after ``probe_timeout`` seconds (a
    stalled in-process call cannot be cancelled); a probe that fails is
    retried after a second, one that hangs at once."""
    return _wait(device, max_wait, probe_timeout, retry_failed=True) is True


def require_device(what="constructor", device="cuda"):
    """Bounded guard before a constructor's first device touch.

    Free for a CPU ``device``, after one success in this process, and
    when this process already made a CUDA context
    (``torch.cuda.is_initialized()``: the first contact succeeded).
    Otherwise probes the driver (:func:`probe_device`) until it answers,
    for at most ``ISS_CTOR_LINK_WAIT`` seconds (default 600; ``<= 0``
    skips the guard), and raises ``TimeoutError`` when it never does.
    Call it before anything that may initialise CUDA in-process,
    ``torch.cuda.is_available()`` included.
    """
    global _DEVICE_OK
    if _DEVICE_OK or torch.device(device).type != "cuda":
        return
    if torch.cuda.is_initialized():
        _DEVICE_OK = True
        return
    wait = float(os.environ.get("ISS_CTOR_LINK_WAIT", "600"))
    if wait <= 0:
        _DEVICE_OK = True
        return
    if _wait(device, wait, min(120.0, wait), retry_failed=False) is None:
        raise TimeoutError(
            f"{what}: the CUDA driver did not answer a probe within "
            f"ISS_CTOR_LINK_WAIT={wait:g}s: the card or its driver appears "
            "stalled. Raise ISS_CTOR_LINK_WAIT to keep waiting, set it <=0 "
            "to skip this guard, or pass device='cpu' to run without the "
            "card.")
