"""The frozen counts equal FlopCounterMode on the plain nets and the
shapes' arithmetic."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts, spec, weights
from perfbench.reference import plain


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("stage", ["vad", "gender"])
def test_patch_cnn_flops(stage):
    m = spec.config("ina_smn_gender")["models"][stage]
    w = weights.make({"models": {stage: m}}, 1, "cpu")[stage]
    net = plain.PatchCNN(w["layers"], w["torch"])
    x = torch.zeros(1, 68, m["nmel"])
    assert _flops(lambda: net(x)) == counts.patch_cnn_flops(m)


def test_mlp_flops():
    m = spec.config("vbx_resnet101_vfs")["models"]["mlp"]
    w = weights.make({"models": {"mlp": m}}, 1, "cpu")["mlp"]
    net = plain.PatchCNN(w["layers"], w["torch"])
    assert _flops(lambda: net(torch.zeros(1, 256))) == counts.mlp_flops(m)


@pytest.mark.parametrize("frames", [144, 37])
def test_resnet101_flops(frames):
    m = spec.config("vbx_resnet101_vfs")["models"]["resnet"]
    w = weights.make({"models": {"resnet": m}}, 1, "cpu")["resnet"]
    x = torch.zeros(1, frames, 64)
    with torch.no_grad():
        got = _flops(lambda: plain.resnet_embed(w["torch"], x))
    assert got == counts.resnet_flops(m, frames)


def test_features_and_viterbi_work_from_shapes():
    n = 16000 * 600
    t = (n - 400) // 160 + 1
    nnz = int(np.count_nonzero(plain.sidekit_fbank()))
    b, ops = counts.features_work(n)
    assert b == 2 * n + 100 * t
    assert ops == t * (10240 + 3084 + 1200 + 800 + 771 + 2 * nnz + 25)
    assert counts.viterbi_work(1000, 3) == (12000 + 1000 + 4000 + 48,
                                           1000 * 24)
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12) == pytest.approx(1.0)
    assert counts.share(1.0, 0.0) is None and counts.share(0.0, 1.0) is None
    assert counts.share(1.0, 2.0) == 50.0


def test_segment_rows_come_from_the_labels():
    stages = spec.config("ina_smn_gender")["stages"]
    labels = np.array([0, 0, 1, 2, 3, 4, 5, 5, 0, 1])
    assert counts.segment_rows(labels, stages) == {"vad": 7, "gender": 3}
    vad_only = {k: v for k, v in stages.items() if k != "gender"}
    assert counts.segment_rows(labels, vad_only) == {"vad": 7}
    m = spec.config("ina_smn_gender")["models"]
    cfg = {"models": m, "stages": stages}
    inst = [{"answer": labels}, {"answer": labels[:4]}]
    assert counts.cnn_flops(inst, cfg) == (
        9 * counts.patch_cnn_flops(m["vad"])
        + 3 * counts.patch_cnn_flops(m["gender"]))


def test_vfs_flops_come_from_the_answer():
    m = spec.config("vbx_resnet101_vfs")["models"]
    win = counts.resnet_flops(m["resnet"], 144)
    # 16,000 samples -> 100 VBx frames: no full window, and the tail from
    # frame 24 (as plain.xvector_windows cuts it), 76 frames
    assert counts.vbx_frames(16000) == 100
    assert counts.vfs_flops((None, 0.0, 0), 16000, m) == 0
    assert counts.vfs_flops((1.0, 0.5, 1), 16000, m) == (
        25 * counts.patch_cnn_flops(m["vad"]) + counts.mlp_flops(m["mlp"])
        + counts.resnet_flops(m["resnet"], 76))
    # 60 s: 6,000 frames, starts 0..5832, a tail of 6000 - 5832 - 24
    # frames; one of the 200 retained windows is priced as the tail
    n = 60 * 16000
    assert counts.vbx_frames(n) == 6000
    got = counts.vfs_flops((0.5, 50.0, 200), n, m)
    assert got == (2500 * counts.patch_cnn_flops(m["vad"])
                   + 200 * counts.mlp_flops(m["mlp"])
                   + counts.resnet_flops(m["resnet"], 144) + 199 * win)
    assert counts.resnet_flops(m["resnet"], 6000 - 5832 - 24) \
        == counts.resnet_flops(m["resnet"], 144)


def test_vbx_frames_match_the_reference_features():
    for n in (400, 16000, 16000 * 7 + 123):
        pcm = np.zeros(n, np.int16)
        assert len(plain.vbx_features(pcm)) == counts.vbx_frames(n)


@pytest.mark.parametrize("frames", [100, 6000, 6050, 3011])
def test_tail_window_as_the_reference_cuts_it(frames):
    """The tail that ``vfs_flops`` prices is the reference's last window,
    on a file that is speech throughout."""
    tl = plain.Timeline([(0.0, frames / 100.0 + 1.0)])
    wins = plain.xvector_windows(frames, frames / 100.0, tl)
    m = spec.config("vbx_resnet101_vfs")["models"]
    n = (frames - 1) * 160 + counts.VBX_LEAD
    assert counts.vbx_frames(n) == frames
    last = wins[-1][1] - wins[-1][0]
    one = counts.vfs_flops((None, 0.0, 1), n, m) - counts.mlp_flops(m["mlp"])
    assert one == counts.resnet_flops(m["resnet"], last)
