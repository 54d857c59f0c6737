"""The controls on the card: the port at the nearest precision below the
configurations' (TF32 for float32 with TF32 off, the port's own tier
``high``), at full widths on a short corpus, reads ``correct`` false.
Needs an NVIDIA GPU: ``python -m pytest perfbench -m cuda`` on the card;
elsewhere it skips."""

from __future__ import annotations

import pytest

from perfbench import run

pytestmark = pytest.mark.cuda

SHORT = {"workload": {"params": {"files": 3, "min_s": 20, "max_s": 60,
                                 "batch_files": 3, "clips": 6,
                                 "rate": 2.0}}}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.parametrize("cell", ["seg_archive_dense", "vfs_archive_dense"])
def test_tf32_control_is_not_correct(cell, card, monkeypatch):
    monkeypatch.setenv("ISS_CNN_PRECISION", "high")
    monkeypatch.setenv("ISS_XVEC_PRECISION", "high")
    res, checks, _ = run.run_cell(cell, 2 ** 31 + 404, 2.0, 0, card, SHORT)
    assert res["correct"] is False, checks


@pytest.mark.parametrize("cell", ["seg_archive_dense", "vfs_archive_dense"])
def test_port_at_its_own_precision_is_correct(cell, card):
    res, checks, _ = run.run_cell(cell, 2 ** 31 + 405, 2.0, 0, card, SHORT)
    assert res["correct"] is True, checks
