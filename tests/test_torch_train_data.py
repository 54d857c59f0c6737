"""PyTorch port: ``train.data`` (``patch_dataset``, ``class_weights``)
against the JAX package's, on the same seeded signals and annotations.

Tolerance: patches within atol 1e-4 (each is normalized by its own mean
and std from features that agree to 1e-4, ``test_torch_features.py``);
labels, kept patches and times equal.  The port runs on ``device="cpu"``,
its features kernel's plain version.
"""

import numpy as np
import pytest

from inaspeechsegmenter_tpu.export import seg2csv as jax_seg2csv
from inaspeechsegmenter_tpu.train import class_weights as jax_class_weights
from inaspeechsegmenter_tpu.train import patch_dataset as jax_patch_dataset
from inaspeechsegmenter_tpu.train.data import ENGINES as JAX_ENGINES
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.export import seg2csv
from inaspeechsegmenter_tpu_torch.train import (ENGINES, class_weights,
                                                patch_dataset)
from torch_parity_helpers import speechlike, to_int16

ATOL = 1e-4
ANNOT = [("speech", 0.0, 2.5), ("noEnergy", 2.5, 3.1), ("music", 3.1, 5.0),
         ("female", 5.0, 6.5), ("noise", 6.5, 8.0), ("male", 8.2, 10.0)]


def _signal(seed):
    return speechlike(10.0, seed, silences=[(2.5, 3.1), (7.0, 7.2)])


def _assert_same(got, want):
    assert len(got) == len(want)
    assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("engine,stride,min_coverage", [
    ("sm", 1, 0.65), ("smn", 3, 0.65), ("smn", 1, 1.0), ("smn", 2, 0.4),
    ("gender", 1, 0.65), ("gender", 2, 1.0)])
def test_patch_dataset_matches_jax(engine, stride, min_coverage):
    pairs = [(_signal(1), ANNOT), (_signal(2), ANNOT[::-1][:3])]
    kw = dict(engine=engine, min_coverage=min_coverage, stride=stride,
              return_times=True)
    got = patch_dataset(pairs, device="cpu", **kw)
    want = jax_patch_dataset(pairs, **kw)
    assert len(got[0]) > 0
    _assert_same(got, want)


def test_wav_and_csv_inputs_match_jax(tmp_path):
    """Media paths decode through the port's reader (int16 -> /32768) and
    csv annotations through its csv reader, as the JAX package's do."""
    wav, csv_port, csv_jax = (str(tmp_path / n)
                              for n in ("a.wav", "p.csv", "j.csv"))
    write_wav(wav, to_int16(_signal(3)), 16000)
    seg2csv(ANNOT, csv_port)
    jax_seg2csv(ANNOT, csv_jax)
    got = patch_dataset([(wav, csv_port)], "smn", ffmpeg=None, device="cpu")
    _assert_same(got, jax_patch_dataset([(wav, csv_jax)], "smn",
                                        ffmpeg=None))
    mem = patch_dataset([(wav, ANNOT)], "smn", ffmpeg=None, device="cpu")
    np.testing.assert_array_equal(got[0], mem[0])


def test_short_and_empty_files_warn_as_jax():
    short = _signal(4)[:int(0.3 * 16000)]
    ok = _signal(5)[:4 * 16000]
    with pytest.warns(UserWarning, match="skipped"):
        got = patch_dataset([(short, [("speech", 0.0, 0.3)]),
                             (ok, [("speech", 0.0, 4.0)])], "smn",
                            device="cpu")
    _assert_same(got, jax_patch_dataset([(ok, [("speech", 0.0, 4.0)])],
                                        "smn"))
    with pytest.warns(UserWarning, match="contributed nothing"):
        x, y, t = patch_dataset([(ok, [("noEnergy", 0.0, 4.0)])], "gender",
                                return_times=True, device="cpu")
    assert x.shape == (0, 68, 24, 1) and y.shape == (0,) and \
        t.shape == (0, 2)
    with pytest.raises(ValueError, match="unknown engine"):
        patch_dataset([], engine="bogus", device="cpu")


@pytest.mark.parametrize("y,n", [([0, 0, 0, 1], 2), ([0, 0, 1, 1], 3),
                                 ([2, 2, 1, 0, 0, 0, 0], 3), ([], 2)])
def test_class_weights_equal_jax(y, n):
    got = class_weights(np.array(y, np.int64), n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_class_weights(np.array(y), n))
    assert ENGINES == JAX_ENGINES


def test_patch_dataset_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        patch_dataset([(_signal(1), ANNOT)], "smn")
