#!/usr/bin/env python3
"""Readings for the limits of ``correct`` and the rate of an open-loop
cell, many runs in one process (the ``torch`` import and the kernel
library paid once).

    # the program on a dozen seeds, then the control (TF32: the port's
    # tier ``high`` for the CNNs and the ResNet) on three
    python3 perfbench/calibrate.py --workload seg_archive_dense \
        --seeds 101,102,... --control-seeds 201,202,203 --seconds 10
    # an open-loop cell's latency at several offered rates (the cell
    # need not be in BENCHMARK.json yet)
    python3 perfbench/calibrate.py --workload seg_clips_open \
        --sweep 44,52,56,60 --seeds 301,302 --seconds 30

Prints one JSON line a run: the numbers compared (``checks``), ``correct``,
the end-to-end metrics the cell reports, the window's own values and
information (``window``: a latency cell's p95, its backlog at the close),
and the information lines.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import run  # noqa: E402

CONTROL = {"ISS_CNN_PRECISION": "high", "ISS_XVEC_PRECISION": "high"}


def one(cell, seed, seconds, mode, overrides=None):
    res, checks, info = run.run_cell(cell, seed, seconds, False,
                                     overrides=overrides)
    window = json.loads(next(i for i in info
                             if i.startswith("window: "))[len("window: "):])
    line = {"workload": cell, "seed": seed, "mode": mode,
            "correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"],
            "checks": {k: v for k, v, _ in checks},
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "window": window, "info": info}
    print(json.dumps(line), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--sweep", default="")
    args = ap.parse_args()
    for k in [k for k in os.environ if k.startswith("ISS_")]:
        del os.environ[k]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if args.sweep:
        for rate in [float(r) for r in args.sweep.split(",")]:
            for seed in seeds:
                one(args.workload, seed, args.seconds, f"rate {rate}",
                    {"workload": {"params": {"rate": rate}}})
        return 0
    for seed in seeds:
        one(args.workload, seed, args.seconds, "program")
    os.environ.update(CONTROL)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        one(args.workload, seed, args.seconds, "control")
    return 0


if __name__ == "__main__":
    sys.exit(main())
