"""PyTorch port: the VBx frontend against the JAX package's f32 path.

The host half (Kaldi mel bank, int16 scaling, seeded dither, mirror pad) is
numpy in both packages and must be array-equal.  The device half must agree
within atol 5e-4: float32 DFT sums in another order (the lowest bands, which
pre-emphasis attenuates, lose the most digits) plus the CMVN cumsum's
float32 rounding, which grows with the file (measured <= 2e-4 up to 6,000
frames).  The JAX package is pinned to its reference f32 path with
``ISS_VBX_UPLOAD=f32``.
"""

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu.dsp import mel as jmel
from inaspeechsegmenter_tpu.dsp import vbx as jvbx
from inaspeechsegmenter_tpu_torch.dsp import mel as tmel
from inaspeechsegmenter_tpu_torch.dsp import vbx as tvbx
from torch_parity_helpers import speechlike, to_int16

ATOL = 5e-4


def vbx_signal(n_frames, seed):
    """float64 signal of int16-scaled noise with n_frames VBx frames and a
    stretch of digital silence."""
    n = (n_frames - 1) * 160 + 80
    sig = to_int16(speechlike(n / 16000 + 0.01, seed=seed,
                              silences=[(0.3, 0.8)]))[:n]
    return sig.astype(np.float64) / 32768.0


@pytest.fixture
def jax_fe(monkeypatch):
    monkeypatch.setenv("ISS_VBX_UPLOAD", "f32")
    return jvbx.VbxFrontend()


@pytest.mark.parametrize("args", [
    (400, 16000, 64, 20.0, 7600, False),
    (400, 16000, 40, 64.0, 8000, True),
    (512, 8000, 20, 0.0, None, True),
])
def test_kaldi_mel_fbank_array_equal(args):
    winlen, fs, nch, lo, hi, bug = args
    want = jmel.kaldi_mel_fbank(winlen, fs, numchans=nch, lofreq=lo,
                                hifreq=hi, htk_bug=bug)
    got = tmel.kaldi_mel_fbank(winlen, fs, numchans=nch, lofreq=lo,
                               hifreq=hi, htk_bug=bug)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_povey_window_is_symmetric_linspace():
    w = tvbx.povey_window()
    np.testing.assert_array_equal(w, jvbx.povey_window())
    # linspace(0, 2pi, 400): N-1 denominator, symmetric, zero at both ends
    assert w[0] == 0.0 and abs(w[-1]) < 1e-12
    np.testing.assert_allclose(w, w[::-1], atol=1e-12)
    periodic = torch.hann_window(400, dtype=torch.float64).numpy() ** 0.85
    assert not np.allclose(w, periodic, atol=1e-4)


@pytest.mark.parametrize("n_frames", [250, 1100])
def test_preprocess_signal_array_equal(n_frames):
    sig = vbx_signal(n_frames, seed=n_frames)
    got = tvbx.preprocess_signal(sig)
    want = jvbx.preprocess_signal(sig)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tvbx.add_dither_seeded(np.arange(10)),
                                  jvbx.add_dither_seeded(np.arange(10)))


@pytest.mark.parametrize("chunk", [4096, 256])
@pytest.mark.parametrize("n_frames", [250, 300, 1100])
def test_features_match_jax(jax_fe, monkeypatch, n_frames, chunk):
    """Fewer than 300 frames (the CMVN window shrinks to the file), exactly
    300, and more than 1024 (past the JAX package's first bucket); chunk 256
    splits the frame matrix at several boundaries."""
    monkeypatch.setattr(tvbx, "CHUNK", chunk)
    sig = vbx_signal(n_frames, seed=n_frames)
    want = np.asarray(jax_fe.features(sig))
    got = tvbx.VbxFrontend("cpu").features(sig)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == (n_frames, 64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_digital_silence_gives_finite_features(jax_fe):
    """log(max(1, .)): the floor is 1, so silence is finite, never -inf."""
    sig = np.zeros(16000 * 3)
    got = tvbx.VbxFrontend("cpu").features(sig).numpy()
    assert got.shape == (300, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jax_fe.features(sig)),
                               rtol=0, atol=ATOL)


def test_cmvn_window_clamps():
    """CMVN over a ramp: window min(n, 300), starts clamped to [0, n-win]."""
    fe = tvbx.VbxFrontend("cpu")
    for n in (50, 300, 700):
        x = torch.arange(n, dtype=torch.float32)[:, None].repeat(1, 2)
        got = fe._cmvn(x)[:, 0].numpy()
        w = min(n, 300)
        ws = np.clip(np.arange(n) - 150, 0, n - w)
        want = np.arange(n) - (ws + (w - 1) / 2.0)
        np.testing.assert_allclose(got, want, atol=1e-3)
