"""The plain reference against the port on the CPU, stage by stage, at
small widths (this test imports both; the reference imports neither the
port nor JAX)."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from perfbench import signals, spec, tiny, weights
from perfbench.kinds import patch_cnn
from perfbench.reference import plain


@pytest.fixture(scope="module")
def pcm():
    rng = np.random.default_rng(3)
    g = torch.Generator()
    g.manual_seed(3)
    return signals.render(16000 * 9, rng, g, "cpu", 0.25, 0.1,
                          (0.5, 1.5)).numpy()


def test_reference_imports_neither_port_nor_jax():
    for name in os.listdir(os.path.join(spec.HERE, "reference")):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(spec.HERE, "reference",
                                           name)).read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module or "" for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)]
        tops = {m.split(".", 1)[0] for m in mods}
        assert not tops & {"jax", "jaxlib", "flax", "inaspeechsegmenter_tpu",
                           "inaspeechsegmenter_tpu_torch"}, name


def test_sidekit_features(pcm):
    from inaspeechsegmenter_tpu_torch.dsp import sidekit

    ms, le = plain.sidekit_features(pcm)
    pm, pl = sidekit.mspec_loge(torch.from_numpy(pcm),
                                sidekit.frontend_consts("cpu"))
    fin = np.isfinite(le)
    assert np.array_equal(fin, np.isfinite(pl.numpy()))
    assert np.max(np.abs(le[fin] - pl.numpy()[fin])) < 1e-4
    ok = np.isfinite(ms)
    assert np.array_equal(ok, np.isfinite(pm.numpy()))
    assert np.max(np.abs(ms[ok] - pm.numpy()[ok])) < 1e-3


def test_fbanks_equal_the_ports():
    from inaspeechsegmenter_tpu_torch.dsp import mel

    fb, _ = mel.htk_triangular_fbank(16000, 512, 100, 8000, 0, 24)
    assert np.allclose(plain.sidekit_fbank(), fb, atol=1e-7)
    kb = mel.kaldi_mel_fbank(400, 16000, numchans=64, lofreq=20.0,
                             hifreq=7600, htk_bug=False)
    assert np.allclose(plain.kaldi_fbank(), kb, atol=1e-12)


@pytest.mark.parametrize("k", [2, 3])
def test_viterbi_equals_the_ports_plain_scan(k):
    from inaspeechsegmenter_tpu_torch.decode.viterbi import (
        viterbi_scan_plain)

    rng = np.random.default_rng(k)
    em = np.log(rng.dirichlet(np.ones(k), 3000)).astype(np.float32)
    reset = rng.random(3000) < 0.01
    reset[0] = True
    tr = plain.diag_trans_exp(2, k).astype(np.float32)
    ini = np.full(k, np.log(1.0 / k), np.float32)
    want = viterbi_scan_plain(*(torch.from_numpy(a) for a in (
        em, tr, ini, reset))).numpy()
    assert np.array_equal(plain.viterbi(em, tr, ini, reset), want)


def test_patch_cnn_equals_the_ports():
    from inaspeechsegmenter_tpu_torch.models.native import ImportedModel

    cfg = spec.config("ina_smn_gender")
    m = dict(cfg["models"]["vad"], **tiny.SMALL_CNN)
    layers, _ = patch_cnn.layers(m)
    w = weights.make({"models": {"vad": m}}, 4, "cpu")["vad"]
    port = ImportedModel({"layers": layers, "inputs": None,
                          "outputs": None}, w["numpy"])
    x = torch.randn(17, 68, 21, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = port(x[..., None])
        ref = plain.PatchCNN(layers, w["torch"])(x)
    assert torch.allclose(got, ref, atol=1e-6)


def test_vbx_features_equal_the_ports_f32_path(pcm):
    from inaspeechsegmenter_tpu_torch.dsp.vbx import VbxFrontend

    got = VbxFrontend("cpu").features(pcm.astype(np.float64) / 32768.0)
    ref = plain.vbx_features(pcm)
    assert got.shape == ref.shape
    assert np.max(np.abs(got.numpy() - ref)) < 2e-3


def test_resnet_equals_the_ports():
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector

    cfg = spec.config("vbx_resnet101_vfs")
    m = dict(cfg["models"]["resnet"], **tiny.SMALL_RESNET)
    w = weights.make({"models": {"resnet": m}}, 5, "cpu")["resnet"]
    net = ResNetXVector(m["block"], m["num_blocks"], m["m_channels"],
                        m["feat_dim"], m["embed_dim"]).load_jax_params(
        w["numpy"])
    x = torch.randn(3, 144, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = net(x.transpose(1, 2))
        ref = plain.resnet_embed(w["torch"], x)
    assert plain.relative_gap(got.numpy(), ref.numpy()) < 1e-5


def test_timeline_and_selection_match_the_ports():
    from inaspeechsegmenter_tpu_torch.annotations import SpeechTimeline
    from inaspeechsegmenter_tpu_torch.vfs import add_needed_vectors

    rng = np.random.default_rng(9)
    edges = np.cumsum(rng.uniform(0.1, 2.0, 40))
    iv = [(float(a), float(b)) for a, b in zip(edges[::2], edges[1::2])]
    mine, theirs = plain.Timeline(iv), SpeechTimeline(iv)
    for t in rng.uniform(0, edges[-1], 200):
        assert mine.contains(t) == theirs.contains_point(t)
        assert mine.overlap(t, t + 1.44) == pytest.approx(
            theirs.overlap_duration(t, t + 1.44))
    assert mine.total() == pytest.approx(theirs.total_duration())
    segs = [(round(s / 100, 3), round(s / 100 + 1.44, 3))
            for s in range(0, int(edges[-1] * 100) - 144, 24)]
    items = [(seg, np.full(2, i, np.float32)) for i, seg in enumerate(segs)]
    kept = plain.select_xvectors(items, mine, 0.7)
    n_x, mid = [], []
    for i, seg in enumerate(segs):
        if theirs.contains_point((seg[0] + seg[1]) / 2):
            r = theirs.overlap_duration(*seg) / (seg[1] - seg[0])
            if r >= 0.7:
                n_x.append((i, seg, None))
            mid.append((r, i, seg, None))
    want = add_needed_vectors(n_x, mid)
    assert [s for s, _ in kept] == [s for _, s, _ in want]
