"""A run with the timed path broken underneath reads ``correct`` false:
once for each fault a cell can have (its answers altered where they are
produced; half of a model's batch left out and the mean of the rest put
in its place).  Runs skip the look for a card and go through everything
else at a tiny size on the CPU.  The steps of a training run and an
exchange between chips do not exist in these cells."""

from __future__ import annotations

import pytest
import torch

from perfbench import run, spec, tiny

SEG_CELLS = [w["name"] for w in spec.benchmark()["workloads"]
             if w["config"] == "ina_smn_gender"]


def _correct(cell, seed=2 ** 31 + 91):
    cfg = spec.workload(cell)["config"]
    res, checks, _ = run.run_cell(cell, seed, 1.0, 0, "cpu",
                                  tiny.overrides(cfg))
    return res["correct"], {k: v for k, v, _ in checks}


def _half_batch(forward):
    def broken(self, x):
        half = max(1, x.shape[0] // 2)
        out = forward(self, x[:half])
        rest = out.mean(dim=0, keepdim=True).expand(
            x.shape[0] - half, *out.shape[1:])
        return torch.cat([out, rest])
    return broken


@pytest.mark.parametrize("cell", SEG_CELLS)
def test_labels_altered(cell, monkeypatch):
    from inaspeechsegmenter_tpu_torch.pipeline import FusedPipeline

    run_ = FusedPipeline.run

    def altered(self, *a, **kw):
        ids = run_(self, *a, **kw).clone()
        g = (ids == 4) | (ids == 5)
        ids[g] = 9 - ids[g]              # female <-> male
        return ids

    monkeypatch.setattr(FusedPipeline, "run", altered)
    ok, numbers = _correct(cell)
    assert not ok and numbers["label_frames_differ"] > 0


@pytest.mark.parametrize("cell", SEG_CELLS)
def test_half_a_cnn_batch_left_out(cell, monkeypatch):
    from inaspeechsegmenter_tpu_torch.models.native import ImportedModel

    monkeypatch.setattr(ImportedModel, "forward",
                        _half_batch(ImportedModel.forward))
    ok, numbers = _correct(cell)
    assert not ok and numbers["log_posterior_gap"] > 1e-2


def test_vfs_score_altered(monkeypatch):
    from inaspeechsegmenter_tpu_torch import vfs

    score = vfs.get_femininity_score
    monkeypatch.setattr(vfs, "get_femininity_score",
                        lambda g: score(g) + 0.125)
    ok, numbers = _correct("vfs_archive_dense")
    assert not ok and numbers["scores_inconsistent"] > 0


def test_vfs_half_a_resnet_batch_left_out(monkeypatch):
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector

    fwd = ResNetXVector.forward

    def broken(self, x, n_valid=None):
        if n_valid is not None or x.shape[0] < 2:
            return fwd(self, x, n_valid)
        return _half_batch(lambda s, v: fwd(s, v))(self, x)

    monkeypatch.setattr(ResNetXVector, "forward", broken)
    ok, numbers = _correct("vfs_archive_dense")
    assert not ok and numbers["xvector_gap"] > 1e-2
