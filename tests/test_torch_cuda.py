"""PyTorch port on the GPU: each CUDA kernel against its plain version.

Marked ``cuda``: every test needs an NVIDIA GPU and nvcc, and skips where
there is none.  On the GPU host (which has no jax, so the suite's
conftest cannot load there):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Features: finite masks equal, mspec within rtol/atol 1e-4, loge within
1e-5 (float32 sums in another order).  Viterbi: states bit-equal,
including exact ties, -inf and NaN scores.
"""

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
from inaspeechsegmenter_tpu_torch.decode.transitions import diag_trans_exp
from inaspeechsegmenter_tpu_torch.dsp import fe_kernel, sidekit
from torch_parity_helpers import speechlike, to_int16

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n_samples", [400, 400 + 160 * 16, 16000 * 7 + 123])
@pytest.mark.parametrize("kind", ["f32", "int16"])
def test_features_kernel_matches_plain(dev, kind, n_samples):
    sig = speechlike(n_samples / 16000, seed=n_samples,
                     silences=[(0.2, 0.9)])[:n_samples]
    arr = to_int16(sig) if kind == "int16" else sig
    x = torch.from_numpy(arr).to(dev)
    consts = sidekit.frontend_consts(dev)
    before = fe_kernel.sidekit_features.launches
    mk, lk = fe_kernel.sidekit_features(x, consts)
    torch.cuda.synchronize()
    assert fe_kernel.sidekit_features.launches == before + 1
    mp, lp = fe_kernel.sidekit_features_plain(x, consts)
    mk, lk, mp, lp = (a.cpu().numpy() for a in (mk, lk, mp, lp))
    assert mk.shape == mp.shape == (sidekit.frame_count(n_samples), 24)
    fin = np.isfinite(mp)
    np.testing.assert_array_equal(np.isfinite(mk), fin)
    np.testing.assert_allclose(mk[fin], mp[fin], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.isfinite(lk), np.isfinite(lp))
    finl = np.isfinite(lp)
    np.testing.assert_allclose(lk[finl], lp[finl], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [1, 2047, 2048, 2 * 2048 + 5])
@pytest.mark.parametrize("kind", ["random", "resets", "ties", "nan"])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_viterbi_kernel_bit_equal(dev, K, kind, T):
    rng = np.random.default_rng(T + 7 * K)
    if kind in ("ties", "nan"):
        with np.errstate(divide="ignore"):
            em = np.log(rng.integers(0, 3, size=(T, K)) / 2.0)
        if kind == "nan":
            em[rng.random(T) < 0.02] = -np.inf     # all -inf: NaN scores
            em[rng.random(T) < 0.01, 0] = np.nan
    else:
        em = np.log(rng.dirichlet(np.ones(K), T))
    reset = rng.random(T) < (0.3 if kind == "resets" else 0.01)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        em.astype(np.float32), diag_trans_exp(0.7, K).astype(np.float32),
        np.full(K, np.log(1.0 / K), np.float32), reset)]
    before = tv.viterbi_scan.launches
    got = tv.viterbi_scan(*args)
    torch.cuda.synchronize()
    assert tv.viterbi_scan.launches == before + 1
    want = tv.viterbi_scan_plain(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    consts = sidekit.frontend_consts(dev)
    with pytest.raises(ValueError, match="float32 or int16"):
        fe_kernel.sidekit_features(torch.zeros(1000, dtype=torch.float64,
                                               device=dev), consts)
    with pytest.raises(ValueError, match="contiguous"):
        fe_kernel.sidekit_features(torch.zeros(2000, device=dev)[::2],
                                   consts)
    em = torch.zeros((10, 4), device=dev)
    with pytest.raises(ValueError, match="1..3 states"):
        tv.viterbi_scan(em, em, em, em)
    em = torch.zeros((10, 2), device=dev)
    with pytest.raises(ValueError, match="reset"):
        tv.viterbi_scan(em, torch.zeros((2, 2), device=dev),
                        torch.zeros(2, device=dev),
                        torch.zeros(10, device=dev))


def test_segmenter_cuda_matches_cpu(dev, tmp_path):
    from inaspeechsegmenter_tpu_torch import Segmenter
    from inaspeechsegmenter_tpu_torch.models.synthetic import (
        install_synthetic_models)

    models = install_synthetic_models(str(tmp_path), size="small")
    sig = to_int16(speechlike(20.0, seed=23, silences=[(4.0, 4.7),
                                                       (13.2, 13.5)]))
    fe0, vt0 = fe_kernel.sidekit_features.launches, tv.viterbi_scan.launches
    got = Segmenter("smn", True, ffmpeg=None, device=dev,
                    model_dir=models).segment_signal(sig)
    assert fe_kernel.sidekit_features.launches == fe0 + 1
    assert tv.viterbi_scan.launches == vt0 + 3
    want = Segmenter("smn", True, ffmpeg=None, device="cpu",
                     model_dir=models).segment_signal(sig)
    assert got == want
