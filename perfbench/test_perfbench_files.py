"""The benchmark's files: every name in BENCHMARK.json resolves to a file,
every file loads, the contract's shapes hold, and a cell or a metric added
as new files is found without editing any file that is there."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 65536
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("perfbench/")
    data = spec.config(cfg["name"])
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert os.path.exists(os.path.join(spec.HERE, "systems",
                                       data["system"] + ".py"))
    assert os.path.exists(os.path.join(spec.HERE, "reference",
                                       cfg["name"] + ".py"))
    assert os.path.join(spec.ROOT, cfg["file"]) == os.path.join(
        spec.HERE, "configs", cfg["name"] + ".json")
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_workload_file(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and NAME.match(cell["name"])
    assert NAME.match(cell["traffic"]) and len(cell["why"]) <= 200
    wl = spec.workload(cell["name"])
    assert (wl["config"], wl["traffic"]) == (cell["config"], cell["traffic"])
    assert os.path.exists(os.path.join(spec.HERE, "traffic",
                                       wl["generator"] + ".py"))
    for name, key in wl["report"].items():
        assert any(m["name"] == name for m in BENCH["end_to_end"])
    assert all(v >= 0 for v in wl["check"]["limits"].values())
    names = {m["name"] for m in spec.cell_metrics(BENCH, cell["name"], 0)}
    assert "setup_s" in names and len(names) >= 2
    assert spec.cell_metrics(BENCH, cell["name"], 1)


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moves = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
        assert moves
        for cell in m["workloads"]:
            assert cell in moves[0].get("workloads", [cell])
        assert callable(spec.metric_reader(m["name"]))
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_fix_only_the_pinnable_switch(cfg):
    from perfbench import run

    data = spec.config(cfg["name"])
    assert set(run.pinned_environment(data)) <= set(run.PINNABLE)
    for env in ({"ISS_CNN_PRECISION": "high"}, {"ISS_FRONTEND": "host"}):
        with pytest.raises(ValueError):
            run.pinned_environment(dict(data, environment=env))


def test_setup_metric():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]


def test_new_cell_and_metric_are_found_as_new_files(tmp_path):
    """A copy of the benchmark with one more workload file, one more
    metric file and their entries: the harness finds both by name and runs
    the new cell, with no existing file edited."""
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    wl = spec.workload("seg_archive_dense")
    wl.update(name="seg_archive_sparse_new", traffic="archive_sparse_new")
    wl["params"]["quiet_share"] = 0.5
    (tmp_path / "perfbench" / "workloads" / "seg_archive_sparse_new.json"
     ).write_text(json.dumps(wl))
    (tmp_path / "perfbench" / "metrics" / "audio_h_in_window.py").write_text(
        "def read(ctx):\n    return ctx['audio_s'] / 3600.0\n")
    bench["workloads"].append({"name": wl["name"], "config": wl["config"],
                               "traffic": wl["traffic"], "chips": 1,
                               "why": "a new cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "seg_audio_s_per_s":
            m["workloads"].append(wl["name"])
    bench["per_layer"].append({"name": "audio_h_in_window", "unit": "h",
                               "better": "higher", "source": "host_clock",
                               "layer": "window", "moves":
                               "seg_audio_s_per_s",
                               "workloads": [wl["name"]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(os.path.join(spec.ROOT, "inaspeechsegmenter_tpu_torch"),
                    tmp_path / "inaspeechsegmenter_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import json, sys\n"
        "from perfbench import run, tiny\n"
        "res, checks, info = run.run_cell('seg_archive_sparse_new', 3, 1.0,"
        " 1, device='cpu', overrides=tiny.overrides('ina_smn_gender'))\n"
        "sys.exit(run.emit(res, checks, info))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["audio_h_in_window"]["unit"] == "h"
    assert res["correct"] is True


TOY_KIND = '''"""``toy_xvector``: a Conv1d stem, BatchNorm, statistics pooling and an
embedding, in a tree of arrays."""

import math

from perfbench.weights import bn_list

TINY = {"channels": 16}


def shapes(m):
    c = m["channels"]
    return {"conv": (c, m["feat_dim"], m["kernel"]), "bn": c,
            "embed": (2 * c, m["embed_dim"])}


def draws(m):
    s = shapes(m)
    return (math.prod(s["conv"]) + 2 * s["bn"] + math.prod(s["embed"])
            + s["embed"][1], 2 * s["bn"])


def draw(m, d):
    s = shapes(m)
    conv = d.normal(s["conv"], math.sqrt(2.0 / math.prod(s["conv"][1:])))
    return {"layers": None, "torch": {
        "conv": conv, "bn": bn_list(d, s["bn"]),
        "embed": {"w": d.normal(s["embed"], 0.05),
                  "b": d.normal((s["embed"][1],), 0.05)}}}
'''

TOY_SYSTEM = '''"""VFS of the port with a toy x-vector kind beside it: the toy's drawn
shapes are reported in ``describe``."""

from perfbench.systems.vfs import System as VfsSystem


class System(VfsSystem):
    def __init__(self, config, weights, model_dir, device):
        super().__init__(config, weights, model_dir, device)
        self.toy_conv = list(weights["toy"]["torch"]["conv"].shape)

    def describe(self):
        return dict(super().describe(), toy_conv=self.toy_conv)
'''

TOY_REFERENCE = '''"""The toy configuration's reference: VFS's."""

from perfbench.reference import vbx_resnet101_vfs as vfs


def build(config, weights, device):
    return vfs.build(config, weights, device)


def reference(models, config, pcm, device):
    return vfs.reference(models, config, pcm, device)
'''

TOY_METRICS = {
    "vfs_score_s_per_audio_h.toy": '''from perfbench import spans


def read(ctx):
    s = spans.host_s(ctx, "vfs.score")
    if s is None or not ctx["audio_s"]:
        return None
    return s / (ctx["audio_s"] / 3600.0)
''',
    "xvec_windows_per_audio_h.toy": '''from perfbench import spans


def read(ctx):
    n = spans.counter(ctx, "xvec.windows")
    if not n or not ctx["audio_s"]:
        return None
    return n / (ctx["audio_s"] / 3600.0)
'''}


def _tree_bytes(root):
    out = {}
    for d, _, names in os.walk(root):
        if "__pycache__" in d:
            continue
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_new_kind_kernel_and_span_readers_are_found_as_new_files(tmp_path):
    """A copy of the benchmark with a configuration of a model kind the
    harness has never seen, naming a kernel of the port under
    ``kernels``, with its system, reference and a VFS workload, and two
    per-layer metrics that read a span and a counter of the port: every
    part is a new file (and entries in BENCHMARK.json), no file that is
    there is edited, and the new cell runs traced to a correct result
    with both metrics read."""
    pb = tmp_path / "perfbench"
    shutil.copytree(spec.HERE, pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_bytes(pb)
    cfg = spec.config("vbx_resnet101_vfs")
    cfg.update(name="toy_vfs", system="toy",
               kernels={"sidekit_fe": "dsp.fe_kernel:sidekit_features"})
    cfg["models"]["toy"] = {"kind": "toy_xvector", "feat_dim": 80,
                            "channels": 1024, "kernel": 5, "embed_dim": 192}
    wl = spec.workload("vfs_archive_dense")
    wl.update(name="toy_vfs_archive", config="toy_vfs",
              traffic="archive_toy", report={"vfs_audio_s_per_s":
                                             "audio_s_per_s"})
    new = {"kinds/toy_xvector.py": TOY_KIND, "systems/toy.py": TOY_SYSTEM,
           "reference/toy_vfs.py": TOY_REFERENCE,
           "configs/toy_vfs.json": json.dumps(cfg),
           "workloads/toy_vfs_archive.json": json.dumps(wl)}
    new.update({f"metrics/{k}.py": v for k, v in TOY_METRICS.items()})
    for rel, text in new.items():
        assert not (pb / rel).exists()
        (pb / rel).write_text(text)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "toy_vfs", "source": cfg["source"],
                             "file": "perfbench/configs/toy_vfs.json",
                             "reduced": [], "why": "a new model kind"})
    bench["workloads"].append({"name": wl["name"], "config": "toy_vfs",
                               "traffic": wl["traffic"], "chips": 1,
                               "why": "a new cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "vfs_audio_s_per_s":
            m["workloads"].append(wl["name"])
    for name, source in (("vfs_score_s_per_audio_h.toy", "program_span"),
                         ("xvec_windows_per_audio_h.toy",
                          "program_counter")):
        bench["per_layer"].append({
            "name": name, "unit": "1/audio_h", "better": "lower",
            "source": source, "layer": "toy", "moves": "vfs_audio_s_per_s",
            "workloads": [wl["name"]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(os.path.join(spec.ROOT, "inaspeechsegmenter_tpu_torch"),
                    tmp_path / "inaspeechsegmenter_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import json, sys\n"
        "from perfbench import run, tiny\n"
        "res, checks, info = run.run_cell('toy_vfs_archive', 2 ** 31 + 3,"
        " 1.0, 1, device='cpu', overrides=tiny.overrides('toy_vfs'))\n"
        "sys.exit(run.emit(res, checks, info))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    assert res["correct"] is True, res["checks"]
    for name in TOY_METRICS:
        assert res["metrics"][name]["value"] > 0
    # the kind's own draw at its TINY size, the configuration's kernel
    # among the checked ones
    assert '"toy_conv": [16, 80, 5]' in out.stdout
    assert any(ln.startswith("trace attempt 0:") and "'sidekit_fe': 0" in ln
               for ln in lines)
    after = _tree_bytes(pb)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == set(new)


def test_a_configuration_names_its_own_kernel_counters():
    from perfbench import trace

    assert set(trace.launches()) == set(trace.CHECKED)
    for cfg in BENCH["configs"]:
        assert "kernels" not in spec.config(cfg["name"])
    own = {"kernels": {"cnn_epilogue_kernel": "models.layers:cnn_epilogue"}}
    assert set(trace.launches(own)) == set(trace.CHECKED) | {
        "cnn_epilogue_kernel"}
    for where in ("models.layers:ConvChain", "models.layers:nowhere"):
        with pytest.raises(ValueError, match="launches"):
            trace.kernel_counters({"kernels": {"k": where}})


def _files(kind, ext):
    d = os.path.join(spec.HERE, kind)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("__"))


@pytest.mark.parametrize("name", _files("workloads", ".json"))
def test_every_workload_file_loads(name):
    wl = spec.workload(name)
    assert wl["name"] == name and wl["why"] and wl["who"]
    assert os.path.exists(os.path.join(spec.HERE, "configs",
                                       wl["config"] + ".json"))
    assert os.path.exists(os.path.join(spec.HERE, "traffic",
                                       wl["generator"] + ".py"))
    assert set(wl["check"]["limits"]) <= set(spec.module(
        "systems", spec.config(wl["config"])["system"]).System.NUMBERS) | {
        "failed"}


@pytest.mark.parametrize("name", _files("metrics", ".py"))
def test_every_metric_file_loads_and_is_named(name):
    assert callable(spec.metric_reader(name))
    assert any(m["name"] == name for m in BENCH["per_layer"])
