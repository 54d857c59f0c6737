"""Whole runs at a tiny size on the CPU: the result line has exactly the
contract's keys, the reference agrees with the port, a run without a card
prints nothing, and nothing a run loads is JAX or the JAX package."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from perfbench import run, spec, tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(cell, trace, capsys, seconds=1.0, seed=2 ** 31 + 77):
    cfg = spec.workload(cell)["config"]
    res, checks, info = run.run_cell(cell, seed, seconds, trace, "cpu",
                                     tiny.overrides(cfg))
    assert run.emit(res, checks, info) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_prints_the_contract_line(cell, trace, capsys):
    res, err = _run(cell, trace, capsys)
    keys = set(res) - {"checks"}
    assert keys == KEYS | ({"breakdown"} if trace else set())
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    want = {m["name"] for m in spec.cell_metrics(spec.benchmark(), cell,
                                                 trace)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    lines = [ln for ln in err.strip().splitlines() if ln.startswith("check ")]
    assert len(lines) == len(res["checks"]) and err.strip().splitlines()[
        -len(lines):] == lines


KEPT = sorted(f[:-5] for f in os.listdir(os.path.join(spec.HERE,
                                                     "workloads"))
              if f.endswith(".json") and f[:-5] not in CELLS)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", KEPT)
def test_cells_kept_for_later_still_run(cell, trace, capsys):
    """A workload file that BENCHMARK.json does not name (a cell kept for
    a later benchmark) runs whole and reads correct, reporting only the
    metrics every cell reports."""
    res, err = _run(cell, trace, capsys)
    assert res["correct"] is True and res["failed"] == 0
    want = {m["name"] for m in spec.cell_metrics(spec.benchmark(), cell,
                                                 trace)}
    assert set(res["metrics"]) == want


def test_reference_agrees_with_the_port_at_small_widths(capsys):
    res, _ = _run("seg_archive_dense", 0, capsys, seed=5)
    c = res["checks"]
    assert c["log_posterior_gap"]["value"] < 1e-4
    assert c["label_frames_differ"]["value"] == 0
    res, _ = _run("vfs_archive_dense", 0, capsys, seed=6)
    assert res["checks"]["xvector_gap"]["value"] < 1e-4
    assert res["checks"]["answers_differ"]["value"] == 0


def test_without_a_card_no_result(tmp_path):
    """On a host without CUDA the command exits non-zero and prints no
    result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
         "seg_archive_dense", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_no_jax_in_a_run():
    """A whole tiny run in a fresh process loads no module whose top-level
    name is jax, jaxlib, flax or the JAX package (the port's name begins
    with the last, so the names are compared whole)."""
    code = ("import sys, json\n"
            "from perfbench import run, tiny\n"
            "for cell, cfg in (('seg_archive_dense', 'ina_smn_gender'),"
            " ('vfs_archive_dense', 'vbx_resnet101_vfs')):\n"
            "    run.run_cell(cell, 3, 1.0, 1, 'cpu', tiny.overrides(cfg))\n"
            "tops = sorted({m.split('.', 1)[0] for m in sys.modules})\n"
            "print(json.dumps(tops))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(env, PYTHONPATH=spec.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "inaspeechsegmenter_tpu_torch" in tops
    assert not tops & set(run.FORBIDDEN)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "inaspeechsegmenter_tpu_torch_x",
                        sys.modules[__name__])
    base = set(run.forbidden_modules())
    assert "inaspeechsegmenter_tpu_torch_x" not in base
    monkeypatch.setitem(sys.modules, "inaspeechsegmenter_tpu.sub",
                        sys.modules[__name__])
    assert "inaspeechsegmenter_tpu" in run.forbidden_modules()
