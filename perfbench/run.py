#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the weights and the corpus from the seed (under ``TMPDIR``),
builds the port's object through its public constructor and warms the
cell's shapes; the window then drives the cell's traffic for ``seconds``.
With ``--trace 0`` the last line of standard output reports the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled window of at most ``TRACE_SECONDS``.  Every run then holds a sample of the window's answers
against the configuration's plain reference (``correct``) and prints each
number compared beside its limit, last on standard error and last in the
result line.

It exits non-zero, printing no result, without a CUDA device (or with
fewer than the cell asks for), when the port cannot be imported, and when
JAX or the JAX package has been loaded.  Every ``ISS_*`` variable is
cleared first: the benchmark measures the port's defaults, except for the
one switch in ``PINNABLE`` that a configuration may fix (its
``environment``, with the reason); a configuration that sets any other
is refused.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "inaspeechsegmenter_tpu")
# The only program switch a configuration may fix, and the values it may
# take.  The port's default frontend rule (ISS_FRONTEND=auto) times one
# pageable 8 MB copy and takes the host frontend below 250 MB/s; on the
# H100's host that copy now and then stalls, and a run then measures
# another program (no features kernel, 40% of the window idle).  The pin
# holds the frontend the rule picks when the copy does not stall, until a
# change to the program steadies the rule (PERF.md, Open questions).
PINNABLE = {"ISS_FRONTEND": ("kernel",)}
TRACE_SECONDS = 10.0    # the traced window: reducing a 30 s trace of the
                        # dense cell took 200 s on an H100 host, near the
                        # run's limit


def process_age_s():
    """Seconds since this process started (``/proc``), else None."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


_T_IMPORT = time.perf_counter()


def setup_seconds():
    age = process_age_s()
    if age is not None:
        return age
    return time.perf_counter() - _T_IMPORT


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name begins with the last)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class Ctx:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _merge(base, over):
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def _sample(instances, rng, budget_s):
    """Indices of the ok instances to check: the longest, then others
    drawn from the seed while their audio fits ``budget_s``."""
    ok = [i for i, r in enumerate(instances) if r["ok"]]
    if not ok:
        return []
    first = max(ok, key=lambda i: instances[i]["n"])
    chosen, total = [first], instances[first]["n"] / 16000
    for i in rng.permutation(ok):
        i = int(i)
        d = instances[i]["n"] / 16000
        if i != first and total + d <= budget_s:
            chosen.append(i)
            total += d
    return sorted(chosen)


@contextlib.contextmanager
def _environment(env):
    """The configuration's variables for the run, restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pinned_environment(config):
    """The configuration's ``environment``, refused unless each variable
    is in ``PINNABLE`` with one of its values."""
    env = dict(config.get("environment", {}))
    for k, v in env.items():
        if v not in PINNABLE.get(k, ()):
            raise ValueError(f"configs/{config['name']}.json sets {k}={v}:"
                             f" a configuration may fix only {PINNABLE}")
    return env


def run_cell(cell, seed, seconds, trace, device="cuda", overrides=None):
    """One run -> (result dict, [(number, value, limit)], info lines)."""
    import numpy as np
    import torch

    from perfbench import counts, signals, spans, spec, weights

    bench = spec.benchmark()
    overrides = overrides or {}
    wl = _merge(spec.workload(cell), overrides.get("workload"))
    # a workload file that BENCHMARK.json does not name yet (a cell kept
    # for later) runs too, and reports only the metrics of every cell
    entry = next((w for w in bench["workloads"] if w["name"] == cell), wl)
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{cell}.json names {wl['config']} / "
                         f"{wl['traffic']}, BENCHMARK.json "
                         f"{entry['config']} / {entry['traffic']}")
    cfg = _merge(spec.config(wl["config"]), overrides.get("config"))
    info = []
    cuda = torch.device(device).type == "cuda"

    with _environment(pinned_environment(cfg)), \
            tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        w = weights.make(cfg, seed, device)
        model_dir = weights.write_model_dir(cfg, w, os.path.join(tmp, "m"),
                                            seed)
        traffic = spec.module("traffic", wl["generator"])
        ctx = Ctx(params=wl["params"], seed=seed, device=device, tmp=tmp,
                  system=None)
        state = traffic.prepare(ctx)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        system = spec.module("systems", cfg["system"]).System(
            cfg, w, model_dir, device)
        ctx.system = system
        traffic.warm(ctx, state)
        if cuda:
            torch.cuda.synchronize()
        setup_s = setup_seconds()

        from perfbench import trace as tr

        red, rec = None, None
        records = []
        launched0 = tr.launches(cfg)
        system.start_capture()
        if not trace:
            rec = traffic.run(ctx, state, seconds)
            records.append(rec)
        else:
            for attempt in range(3):
                d0 = system.decode_seconds()
                s0 = spans.snapshot()
                span = min(seconds, TRACE_SECONDS) / 2 ** attempt
                rec, prof, window, launched = tr.traced(
                    lambda: traffic.run(ctx, state, span), cuda, cfg)
                records.append(rec)
                red = tr.reduce(prof, window, launched)
                red["spans"] = spans.reduce_spans(prof)
                del prof
                d1 = system.decode_seconds()
                red["program"] = spans.delta(s0, spans.snapshot())
                info.append(f"trace attempt {attempt}: {window:.3f} s, "
                            f"launches {launched}, records "
                            + str({k: tr.kernel_seconds(red, k)[0]
                                   for k in launched}))
                if red["complete"]:
                    break
            red["decode_s"] = None if d0 is None else d1 - d0
            info.append("program spans in the trace (device s, host s, "
                        "calls): " + json.dumps(
                            {k: [v["device_s"], v["host_s"], v["calls"]]
                             for k, v in sorted(red["spans"].items())}))
            info.append("program counters in the trace: "
                        + json.dumps(red["program"]["counters"]))
        traffic.close(state)
        if cuda:
            torch.cuda.synchronize()
        system.stop_capture()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        n_done = sum(i["ok"] for r in records for i in r["instances"])
        info.append("system: " + json.dumps(system.describe()))
        info.append("launches a file in the window: " + json.dumps(
            {k: (v - launched0[k]) / max(n_done, 1)
             for k, v in tr.launches(cfg).items()}))

        instances = [i for r in records for i in r["instances"]]
        ok = [i for i in instances if i["ok"]]
        answers = [system.answer(i["out"]) for i in ok]
        for i, a in zip(ok, answers):
            i["answer"] = a
        aligned = system.align(answers)
        info.append("the answers hold: " + json.dumps(system.work(answers)))
        system.close()
        ctx.system = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # the reference, on a sample of the window's answers
        rng = np.random.default_rng([int(seed), 5])
        pick = _sample(ok, rng, wl["check"]["sample_s"])
        ref = spec.module("reference", cfg["name"])
        models = ref.build(cfg, w, device)
        numbers = dict(system.NUMBERS)
        t_ref = time.perf_counter()
        for i in pick:
            r = ref.reference(models, cfg, signals.read_pcm(ok[i]["path"]),
                              device)
            system.compare(answers[i], aligned[i], r, numbers)
        info.append(f"reference: {len(pick)} answers, "
                    f"{sum(ok[i]['n'] for i in pick) / 16000:.1f} audio s, "
                    f"{time.perf_counter() - t_ref:.1f} s")
        numbers["failed"] = len(instances) - len(ok)
        limits = wl["check"]["limits"]
        checks = [(k, numbers[k], limits[k]) for k in limits]
        correct = bool(pick) and all(v <= lim for _, v, lim in checks)

        metrics = {}
        want = spec.cell_metrics(bench, cell, trace)
        if not trace:
            vals = dict(rec["values"], setup_s=setup_s)
            for m in want:
                key = wl["report"].get(m["name"], m["name"])
                metrics[m["name"]] = {"value": vals[key], "unit": m["unit"]}
        else:
            rctx = {"trace": red, "window_s": red["window_s"],
                    "instances": [i for i in rec["instances"] if i["ok"]],
                    "audio_s": rec["audio_s"], "decode_s": red["decode_s"],
                    "service_ms": rec.get("service_ms"), "config": cfg,
                    "counts": counts}
            for m in want:
                v = spec.metric_reader(m["name"])(rctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name() if cuda else "cpu",
               "count": 1, "memory_peak_bytes": int(peak)}
        if trace:
            dev.update(busy_s=red["busy_s"], window_s=red["window_s"])
        result = {"correct": correct, "attempted": len(instances),
                  "failed": len(instances) - len(ok), "metrics": metrics,
                  "device": dev}
        if trace:
            result["breakdown"] = {"device_ops": red["device_ops"],
                                   "idle_gaps": red["idle_gaps"]}
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, v, lim in checks}
        info.append("window: " + json.dumps(dict(rec.get("info", {}),
                                                 **rec.get("values", {}))))
        info.append(f"memory_peak_bytes {peak}")
        info.append("numbers (not all compared): " + json.dumps(numbers))
        info.append(f"audio in the window: {rec['audio_s']:.1f} s in "
                    f"{len(ok)} answers")
        return result, checks, info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("ISS_")]:
        del os.environ[k]

    import torch

    from perfbench import spec

    chips = spec.cell_entry(spec.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 3
    return emit(*run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace)))


def emit(result, checks, info):
    """Print a run: the information lines, then each number compared
    beside its limit as the last lines of standard error, then the result
    as the last line of standard output -> the exit code (4, with no
    result, where JAX or the JAX package was loaded)."""
    bad = forbidden_modules()
    if bad:
        log(f"no result: modules loaded in the benchmark's process: {bad}")
        return 4
    for line in info:
        print(line, flush=True)
    for k, v, lim in checks:
        log(f"check {k} {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
