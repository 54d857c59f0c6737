"""Open loop of short clips: a pool of clips, offered at a fixed rate to
one service worker that segments each with the system's per-file call
(``Segmenter.__call__``), one at a time, in order of arrival.  The worker
thread is made in set-up and warms every clip of the pool once.

The arrival gaps are the (i + 1/2) / n quantiles of an exponential law
of mean 1 / ``rate`` (a Poisson process's gaps, the same set for every
seed) in the seed's order, and the clips the pool cycled in the seed's
order.  A clip's latency runs from the time it was due to the return of
its segments, so a stall delays every clip behind it; the window offers
``seconds`` of arrivals and then waits, at most ``drain_s`` more, for the
clips already offered.  A clip not served by then counts as missing.
How late the generator offered each clip, and how many clips due in the
window were still waiting at its close (a backlog that grows with the
window marks a rate the worker does not sustain), are reported beside
it.

Parameters: ``clips``, ``min_s``, ``max_s``, ``quiet_share``,
``silence_share``, ``silence_gap_s`` (as ``batch``), ``rate`` (clips a
second), ``drain_s``.
"""

from __future__ import annotations

import os
import queue
import threading
import time

import numpy as np

from perfbench import signals


class Worker:
    """The service worker: one thread, kept from set-up to the end of the
    run, that segments the clips put on its queue one at a time.  Its
    warm-up calls run on the same thread as the window's, so the window
    finds every per-thread library handle already made."""

    def __init__(self, system):
        self.system = system
        self.q = queue.Queue()
        self.done = {}
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        from torch.profiler import record_function

        while True:
            with record_function("perfbench.clip_wait"):
                item = self.q.get()
            if item is None:
                return
            if item == "capture":
                self.system.start_capture()
                continue
            k, path, ev = item
            t_start = time.perf_counter()
            try:
                out, ok = self.system.call(path), True
            except Exception as exc:   # a failed clip is a missing one
                out, ok = repr(exc), False
            self.done[k] = (t_start, time.perf_counter(), out, ok)
            if ev is not None:
                ev.set()

    def call(self, k, path):
        """Serve one clip and wait for it (set-up only)."""
        ev = threading.Event()
        self.q.put((k, path, ev))
        ev.wait()
        return self.done.pop(k)

    def stop(self, timeout):
        self.q.put(None)
        self.thread.join(timeout=timeout)


def prepare(ctx):
    p = ctx.params
    files = signals.corpus(os.path.join(ctx.tmp, "clips"), ctx.seed,
                           ctx.device, p["clips"], p["min_s"], p["max_s"],
                           p["quiet_share"], p["silence_share"],
                           p["silence_gap_s"], prefix="c")
    return {"files": files, "rng": np.random.default_rng([int(ctx.seed), 11])}


def warm(ctx, state):
    state["worker"] = Worker(ctx.system)
    for k, (w, _) in enumerate(state["files"]):
        state["worker"].call(("warm", k), w)


def schedule(rng, rate, seconds, n_pool):
    """(due times from 0, clip indices) of one window."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    due = np.cumsum(rng.permutation(gaps))
    due = due * (seconds / due[-1]) if due[-1] > seconds else due
    cycles = -(-n // n_pool)
    order = np.concatenate([rng.permutation(n_pool) for _ in range(cycles)])
    return due, order[:n]


def run(ctx, state, seconds):
    p = ctx.params
    files, worker = state["files"], state["worker"]
    due, order = schedule(state["rng"], p["rate"], seconds, len(files))
    worker.done.clear()
    worker.q.put("capture")
    late = np.zeros(len(due))
    t0 = time.perf_counter()
    for k, d in enumerate(due):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[k] = time.perf_counter() - (t0 + d)
        worker.q.put((k, files[order[k]][0], None))
    drain = t0 + seconds + p["drain_s"]
    while len(worker.done) < len(due) and time.perf_counter() < drain:
        time.sleep(0.005)
    t1 = time.perf_counter()
    done = dict(worker.done)
    lat, service, inst = [], [], []
    for k, d in enumerate(due):
        w, n = files[order[k]]
        r = done.get(k)
        if r is None or not r[3]:
            lat.append(np.inf)
            inst.append({"path": w, "n": n, "out": None, "ok": False})
            continue
        lat.append(r[1] - (t0 + d))
        service.append(r[1] - r[0])
        inst.append({"path": w, "n": n, "out": r[2], "ok": True})
    lat = np.asarray(lat) * 1e3
    close = t0 + seconds
    backlog = sum(1 for k, d in enumerate(due) if t0 + d <= close
                  and (k not in done or done[k][1] > close))
    fifth = max(1, len(lat) // 5)
    audio = sum(i["n"] for i in inst if i["ok"]) / signals.SR
    return {"instances": inst, "t0": t0, "t1": t1, "audio_s": audio,
            "values": {"p95_ms": float(np.percentile(lat, 95)),
                       "p50_ms": float(np.percentile(lat, 50))},
            "service_ms": [s * 1e3 for s in service],
            "info": {"offered": len(due),
                     "late_p50_ms": float(np.median(late) * 1e3),
                     "late_max_ms": float(late.max() * 1e3),
                     "latency_p50_ms": float(np.percentile(lat, 50)),
                     "latency_max_ms": float(lat.max()),
                     "backlog_at_close": backlog,
                     "service_mean_ms": (float(np.mean(service)) * 1e3
                                         if service else None),
                     "p95_first_fifth_ms": float(np.percentile(lat[:fifth],
                                                               95)),
                     "p95_last_fifth_ms": float(np.percentile(lat[-fifth:],
                                                              95))}}


def close(state):
    if "worker" in state:
        state["worker"].stop(timeout=60)
