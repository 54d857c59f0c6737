"""Spans, counters and per-stage timing: ``Segmenter.timers`` and a
profiler region.

``span(name)`` times a region of the port on the host clock and adds it,
with one call, to process-wide totals; ``count(name, n)`` adds to a
process-wide counter; ``snapshot()`` reads both.  A span also enters
``torch.profiler.record_function(name)``, but only while a profiler
records its thread: it then shares the profiler's clock with the device
trace, and the spans nested on one thread give each its parent.  With no
profiler a span costs a clock pair and a locked update (1.8 us on an
H100 host); a ``record_function`` alone costs four times that.

A profiler of its own thread alone (``torch.profiler.profile()``'s
default) sets ``torch.autograd._profiler_enabled()`` on that thread and
on no other, so the other threads' spans stay off it.  A profiler of
every thread leaves that flag False on every thread, so ``torch_trace``
says that it records them all (``_ALL_THREADS``).

``StageTimers`` (copy of ``inaspeechsegmenter_tpu/utils/timing.py``)
times each segmentation stage (decode / features / segment) as the span
``seg.<stage>`` and keeps its own totals.  A stage timed on the host
clock ends where its work waits for the device; on CUDA the segment
stage does (the labels are copied to the host), the features stage only
enqueues.  ``torch_trace`` wraps ``torch.profiler`` (the JAX package's
wraps ``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch

_LOCK = threading.Lock()
_SPANS = {}         # name -> [host seconds, calls]
_COUNTERS = defaultdict(int)
_ALL_THREADS = False    # True while torch_trace records every thread


def _profiling():
    """True while a ``torch.profiler`` profile records this thread."""
    return _ALL_THREADS or torch.autograd._profiler_enabled()


class span:
    """``with span(name):`` adds the region's host seconds and one call to
    ``name``'s totals, and is a ``record_function`` region while a
    profiler records its thread.  ``seconds``: the region's host seconds,
    once it has ended."""

    __slots__ = ("name", "seconds", "_t0", "_rf")

    def __init__(self, name):
        self.name = name
        self.seconds = 0.0
        self._rf = None

    def __enter__(self):
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        with _LOCK:
            tot = _SPANS.get(self.name)
            if tot is None:
                _SPANS[self.name] = [self.seconds, 1]
            else:
                tot[0] += self.seconds
                tot[1] += 1
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


def count(name, n=1):
    """Add ``n`` to the process-wide counter ``name``."""
    with _LOCK:
        _COUNTERS[name] += n


def snapshot():
    """The process-wide totals so far: ``{"spans": {name: [seconds,
    calls]}, "counters": {name: n}}`` (a copy)."""
    with _LOCK:
        return {"spans": {k: list(v) for k, v in _SPANS.items()},
                "counters": dict(_COUNTERS)}


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
        region = span("seg." + stage)
        try:
            with region:
                yield
        finally:
            with self._lock:
                self.totals[stage] += region.seconds
                self.counts[stage] += 1

    def summary(self):
        return {s: dict(total_s=self.totals[s], calls=self.counts[s])
                for s in self.totals}

    def reset(self):
        for s in list(self.totals):
            self.totals[s] = 0.0
            self.counts[s] = 0


def _all_threads_config():
    """The profiler's setting that records every thread (the batch
    paths' producer threads too), where this torch has it."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@contextlib.contextmanager
def torch_trace(logdir):
    """Profile the enclosed region with ``torch.profiler`` (host activity
    of every thread, and the CUDA device's when one is visible) and write
    its Chrome trace to ``logdir/trace.json``.  Yields the profiler
    (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    global _ALL_THREADS
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    config = _all_threads_config()
    with profile(activities=acts, experimental_config=config) as prof:
        _ALL_THREADS = config is not None
        try:
            yield prof
        finally:
            _ALL_THREADS = False
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
