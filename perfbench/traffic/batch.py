"""Closed loop over an archive: the corpus, cycled in calls of
``batch_files`` files through the system's batch entry
(``Segmenter.batch_process``, ``VoiceFemininityScoring.batch_score``),
each call's answers written to files of their own.

The window runs whole calls and ends with the first call that ends after
``seconds``; its rate is all the audio seconds of the files completed over
all the time from the start of the first call to the end of the last.

Parameters (``workloads/<cell>.json``): ``files``, ``min_s``, ``max_s``
(the log-uniform law of the file lengths), ``quiet_share`` (sections
40-50 dB down), ``silence_share`` and ``silence_gap_s`` (digital silence),
``batch_files``.
"""

from __future__ import annotations

import os
import time

from perfbench import signals


def prepare(ctx):
    p = ctx.params
    files = signals.corpus(os.path.join(ctx.tmp, "corpus"), ctx.seed,
                           ctx.device, p["files"], p["min_s"], p["max_s"],
                           p["quiet_share"], p["silence_share"],
                           p["silence_gap_s"])
    return {"files": files, "next": 0, "calls": 0}


def _call(ctx, state):
    files, k = state["files"], ctx.params["batch_files"]
    chosen = [files[(state["next"] + i) % len(files)] for i in range(k)]
    state["next"] = (state["next"] + k) % len(files)
    out_dir = os.path.join(ctx.tmp, "out", f"c{state['calls']:05d}")
    state["calls"] += 1
    outs = [os.path.join(out_dir, os.path.basename(w)[:-4] + ".csv")
            for w, _ in chosen]
    status = ctx.system.batch([w for w, _ in chosen], outs)
    return [{"path": w, "n": n, "out": o, "ok": s == 0}
            for (w, n), o, s in zip(chosen, outs, status)]


def warm(ctx, state):
    """One pass over the corpus: every shape the window will use."""
    for _ in range(-(-len(state["files"]) // ctx.params["batch_files"])):
        _call(ctx, state)
    state["next"] = 0


def run(ctx, state, seconds):
    done = []
    t0 = time.perf_counter()
    while True:
        done += _call(ctx, state)
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    audio = sum(i["n"] for i in done if i["ok"]) / signals.SR
    return {"instances": done, "t0": t0, "t1": t1,
            "values": {"audio_s_per_s": audio / (t1 - t0)},
            "audio_s": audio, "info": {"calls": state["calls"]}}


def close(state):
    """Nothing outlives a call."""
