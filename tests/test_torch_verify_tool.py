"""PyTorch port: ``tools.verify_weights``, the released-weights acceptance
kit, against the JAX package's ``tools/verify_weights.py``.

Counterpart of ``tests/test_verify_tool.py``: ``seg_diff_detail`` and the
``--report-only`` topology reports on real-format Keras ``.hdf5`` files
written here with h5py (the tool itself reads them without it), an
unsupported layer flagged FAIL with exit 1, the JSON record with the JAX
tool's keys, and the golden battery's SKIPs when the media fixtures are
not found.  Both tools run on the same model directory and give the same
records.  No test reads the reference media.
"""

import importlib.util
import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
from inaspeechsegmenter_tpu_torch.tools import verify_weights as vw
from inaspeechsegmenter_tpu_torch.vfs import save_resnet_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "verify_weights.py")
TINY = ("bottleneck", (1, 1, 1, 1), 8, 64, 256)


def _write_h5(path, layers, layer_weights):
    cfg = {"class_name": "Sequential",
           "config": {"name": "m", "layers": layers}}
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg).encode()
        f.attrs["keras_version"] = b"2.8.0"
        f.attrs["backend"] = b"tensorflow"
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = [n.encode() for n in layer_weights]
        for lname, wlist in layer_weights.items():
            g = mw.create_group(lname)
            g.attrs["weight_names"] = [wn.encode() for wn, _ in wlist]
            for wn, arr in wlist:
                node = g
                parts = wn.split("/")
                for p in parts[:-1]:
                    node = node.require_group(p)
                node.create_dataset(parts[-1], data=arr)


def _patch_cnn_h5(path, nmel, nout, rng):
    k = rng.standard_normal((3, 3, 1, 4)).astype(np.float32)
    kb = np.zeros(4, np.float32)
    d = rng.standard_normal((4 * 68 * nmel, nout)).astype(np.float32)
    db = np.zeros(nout, np.float32)
    _write_h5(path, [
        {"class_name": "Conv2D", "config": {
            "name": "c0", "filters": 4, "kernel_size": [3, 3],
            "padding": "same", "activation": "relu", "use_bias": True,
            "batch_input_shape": [None, 68, nmel, 1]}},
        {"class_name": "Flatten", "config": {"name": "fl"}},
        {"class_name": "Dense", "config": {
            "name": "d0", "units": nout, "activation": "softmax",
            "use_bias": True}},
    ], {"c0": [("c0/kernel:0", k), ("c0/bias:0", kb)],
        "d0": [("d0/kernel:0", d), ("d0/bias:0", db)]})


def _mlp_h5(path, rng):
    w = rng.standard_normal((256, 1)).astype(np.float32)
    b = np.zeros(1, np.float32)
    _write_h5(path, [
        {"class_name": "Dense", "config": {
            "name": "g0", "units": 1, "activation": "sigmoid",
            "use_bias": True, "batch_input_shape": [None, 256]}},
    ], {"g0": [("g0/kernel:0", w), ("g0/bias:0", b)]})


def _real_format_dir(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "models"
    d.mkdir()
    _patch_cnn_h5(str(d / "keras_speech_music_cnn.hdf5"), 21, 2, rng)
    _patch_cnn_h5(str(d / "keras_speech_music_noise_cnn.hdf5"), 21, 3, rng)
    _patch_cnn_h5(str(d / "keras_male_female_cnn.hdf5"), 24, 2, rng)
    _mlp_h5(str(d / "interspeech2023_all.hdf5"), rng)
    _mlp_h5(str(d / "interspeech2023_cvfr.hdf5"), rng)
    net = ResNetXVector(*TINY)
    save_resnet_npz(str(d / "raw_81.npz"), net.init_params(seed=0))
    return d


def _run(tool, model_dir, tmp_path, *args, tag="port"):
    """Run the port's tool (``-m``, on the CPU) or the JAX one on
    ``model_dir`` -> (exit status, stdout, JSON record)."""
    jpath = str(tmp_path / f"report_{tag}.json")
    env = dict(os.environ, ISS_TPU_MODEL_DIR=str(model_dir),
               JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    for name in ("ISS_CNN_PRECISION", "ISS_XVEC_PRECISION",
                 "ISS_VERIFY_JSON"):
        env.pop(name, None)
    cmd = ([sys.executable, "-m",
            "inaspeechsegmenter_tpu_torch.tools.verify_weights", "--device",
            "cpu"] if tool == "port" else [sys.executable, JAX_TOOL])
    cwd = tmp_path / f"cwd_{tag}"
    cwd.mkdir()
    r = subprocess.run([*cmd, *args, "--json", jpath], capture_output=True,
                       text=True, env=env, cwd=str(cwd), timeout=240)
    with open(jpath) as fh:
        return r.returncode, r.stdout + r.stderr, json.load(fh)


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_verify_weights",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_seg_diff_detail_quantifies_parity_misses():
    gold = [("male", 0.0, 5.0), ("noEnergy", 5.0, 10.0)]
    jitter = [("male", 0.0, 5.0), ("noEnergy", 5.0, 10.0)]
    assert "0.0000%" in vw.seg_diff_detail(gold, jitter)
    shifted = [("male", 0.0, 5.02), ("noEnergy", 5.02, 10.0)]
    d = vw.seg_diff_detail(gold, shifted)
    assert "0.2000%" in d and "OVER" in d and "1/1 matched" in d
    small = [("male", 0.0, 5.002), ("noEnergy", 5.002, 10.0)]
    assert "within the 0.1% budget" in vw.seg_diff_detail(gold, small)
    wrong = [("music", 0.0, 10.0)]
    assert "100.0000%" in vw.seg_diff_detail(gold, wrong)
    jax_vw = _jax_tool()
    for got in (jitter, shifted, small, wrong):
        assert vw.seg_diff_detail(gold, got) == \
            jax_vw.seg_diff_detail(gold, got)


def test_seg_diff_detail_reads_golden_csvs(tmp_path):
    from inaspeechsegmenter_tpu_torch import seg2csv

    gold = [("male", 0.0, 5.0), ("noEnergy", 5.0, 10.0)]
    seg2csv(gold, str(tmp_path / "gold.csv"))
    assert vw.golden_csv(str(tmp_path), "gold.csv") == gold
    d = vw.seg_diff_detail(str(tmp_path / "gold.csv"),
                           [("male", 0.0, 5.02), ("noEnergy", 5.02, 10.0)])
    assert "0.2000%" in d and "OVER" in d


def test_report_only_on_real_format_files(tmp_path):
    d = _real_format_dir(tmp_path)
    rc, out, rep = _run("port", d, tmp_path, "--report-only")
    assert rc == 0, out
    # every hdf5 got a topology PASS and a forward PASS
    assert out.count("topology") >= 5
    assert "FAIL" not in out
    assert "UNSUPPORTED" not in out
    assert out.count(": forward") == 5
    assert "keras_version=2.8.0 backend=tensorflow" in out
    assert rep["ok"] and rep["verified"]
    assert rep["summary"] == {"pass": 11, "fail": 0, "skip": 0}
    assert rep["models"]["keras_speech_music_cnn.hdf5"].endswith(".hdf5")
    assert rep["models"]["raw_81.pth"].endswith("raw_81.npz")
    assert rep["models"]["final.onnx"] is None
    assert {e["status"] for e in rep["results"]} == {"PASS"}
    assert rep["precision"] == {"cnn": "highest", "xvec": "highest"}
    assert rep["device"] == "cpu"


def test_report_matches_the_jax_tool(tmp_path):
    d = _real_format_dir(tmp_path)
    rc, _, rep = _run("port", d, tmp_path, "--report-only")
    jrc, jout, jrep = _run("jax", d, tmp_path, "--report-only", tag="jax")
    assert rc == jrc == 0, jout
    assert set(jrep) <= set(rep)
    assert set(rep) - set(jrep) == {"device"}
    assert [(e["name"], e["status"]) for e in rep["results"]] == \
        [(e["name"], e["status"]) for e in jrep["results"]]
    assert rep["models"] == jrep["models"]
    for key in ("ok", "verified", "summary", "precision"):
        assert rep[key] == jrep[key], key


def test_report_flags_unsupported_layer(tmp_path):
    rng = np.random.default_rng(1)
    d = tmp_path / "models"
    d.mkdir()
    w = rng.standard_normal((16, 2)).astype(np.float32)
    _write_h5(str(d / "keras_speech_music_cnn.hdf5"), [
        {"class_name": "LSTM", "config": {
            "name": "l0", "units": 16,
            "batch_input_shape": [None, 10, 4]}},
        {"class_name": "Dense", "config": {
            "name": "d0", "units": 2, "activation": "softmax",
            "use_bias": True}},
    ], {"d0": [("d0/kernel:0", w), ("d0/bias:0", np.zeros(2, np.float32))]})
    rc, out, rep = _run("port", d, tmp_path, "--report-only")
    assert rc == 1      # unsupported layer type -> FAIL
    assert "UNSUPPORTED" in out and "LSTM" in out
    assert not rep["ok"]
    assert [e["status"] for e in rep["results"]] == ["FAIL"]


def test_synthetic_stand_ins_are_reported_as_such(tmp_path):
    from inaspeechsegmenter_tpu_torch.models.synthetic import (
        install_synthetic_models)

    d = install_synthetic_models(str(tmp_path / "models"), size="small")
    rc, out, rep = _run("port", d, tmp_path, "--report-only")
    assert rc == 0, out
    assert out.count("SYNTHETIC stand-in") == 5
    assert not rep["verified"] and rep["summary"]["pass"] == 0
    assert [k for k, v in rep["models"].items() if v == "synthetic"] == \
        vw.HDF5_MODELS


@pytest.mark.parametrize("media", ["none found", "fixtures missing"])
def test_golden_battery_skips_without_media(tmp_path, media):
    d = _real_format_dir(tmp_path)
    args = []
    if media == "fixtures missing":
        (tmp_path / "media").mkdir()
        args = ["--media-dir", str(tmp_path / "media")]
    rc, out, rep = _run("port", d, tmp_path, *args)
    assert rc == 0, out
    skips = [e["name"] for e in rep["results"] if e["status"] == "SKIP"]
    if media == "none found":
        assert rep["media_dir"] is None and skips == ["golden battery"]
    else:
        assert rep["media_dir"] == str(tmp_path / "media")
        assert skips == ["segmentation golden battery",
                         "x-vector embedding vs test.h5",
                         "VFS score on lamartine.wav"]
    assert rep["summary"]["pass"] == 11 and rep["summary"]["fail"] == 0


def test_precision_set_explicitly_is_honoured(tmp_path, monkeypatch):
    d = _real_format_dir(tmp_path)
    monkeypatch.setenv("ISS_TPU_MODEL_DIR", str(d))
    monkeypatch.setenv("ISS_CNN_PRECISION", "high")
    monkeypatch.setenv("ISS_XVEC_PRECISION", "bf16")
    monkeypatch.chdir(tmp_path)
    jpath = str(tmp_path / "r.json")
    assert vw.main(["--report-only", "--device", "cpu", "--json",
                    jpath]) == 0
    with open(jpath) as fh:
        assert json.load(fh)["precision"] == {"cnn": "high", "xvec": "bf16"}


def test_default_device_needs_a_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("ISS_CNN_PRECISION", "ISS_XVEC_PRECISION"):
        monkeypatch.setenv(name, "highest")    # restored after main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vw.main(["--report-only"])
