"""Per-stage timing: ``Segmenter.timers`` and a profiler region.

Copy of ``inaspeechsegmenter_tpu/utils/timing.py``: each stage (decode /
features / segment) is timed, accumulated and queryable.  The trace
helper wraps ``torch.profiler`` (the JAX package's wraps
``jax.profiler``).  A stage timed on the host clock ends where its work
waits for the device; on CUDA the segment stage does (the labels are
copied to the host), the features stage only enqueues.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict


class StageTimers:
    def __init__(self, *stages):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        # batch_process times decode/features on concurrent producer
        # threads; the += accumulation must not lose updates
        self._lock = threading.Lock()
        for s in stages:
            self.totals[s] = 0.0
            self.counts[s] = 0

    @contextlib.contextmanager
    def time(self, stage):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[stage] += dt
                self.counts[stage] += 1

    def summary(self):
        return {s: dict(total_s=self.totals[s], calls=self.counts[s])
                for s in self.totals}

    def reset(self):
        for s in list(self.totals):
            self.totals[s] = 0.0
            self.counts[s] = 0


@contextlib.contextmanager
def torch_trace(logdir):
    """Profile the enclosed region with ``torch.profiler`` (host activity,
    and the CUDA device's when one is visible) and write its Chrome trace
    to ``logdir/trace.json``.  Yields the profiler (``key_averages()``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
