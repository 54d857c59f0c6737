"""PyTorch port: the SIDEKIT frontend against the JAX frontends.

On the CPU the port's kernel wrapper runs its plain version (a transcription
of ``sidekit.py::_chunk_feats``); it is held against the JAX jnp frontend
and the JAX Pallas kernel in interpret mode, on the same seeded signals.
Tolerances: mspec rtol/atol 1e-4 and loge 1e-5 (float32 DFTs summed in
different orders, as tests/test_pallas_fe.py); the finite masks — the -inf
rows of digital silence — must be equal.
"""

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu.dsp import SidekitFrontend
from inaspeechsegmenter_tpu.dsp.pallas_fe import PallasSidekitFrontend
from inaspeechsegmenter_tpu_torch.dsp import fe_kernel, sidekit
from inaspeechsegmenter_tpu_torch.dsp.fe_kernel import KernelSidekitFrontend
from torch_parity_helpers import speechlike, to_int16

SIGNALS = {
    "f32": lambda: speechlike(3.0, seed=11),
    "int16_silence": lambda: to_int16(speechlike(3.0, seed=12,
                                                 silences=[(1.0, 1.6)])),
    "f32_silence": lambda: speechlike(3.0, seed=13, silences=[(0.0, 0.5),
                                                             (2.2, 2.3)]),
}


@pytest.fixture(scope="module")
def jax_frontends():
    return {"jnp": SidekitFrontend(),
            "pallas": PallasSidekitFrontend(interpret=True)}


@pytest.fixture(scope="module")
def port_frontend():
    return KernelSidekitFrontend("cpu")


def _assert_features_close(m, lg, m_ref, l_ref):
    fin = np.isfinite(m_ref)
    np.testing.assert_array_equal(np.isfinite(m), fin)
    np.testing.assert_allclose(m[fin], m_ref[fin], rtol=1e-4, atol=1e-4)
    finl = np.isfinite(l_ref)
    np.testing.assert_array_equal(np.isfinite(lg), finl)
    np.testing.assert_allclose(lg[finl], l_ref[finl], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
@pytest.mark.parametrize("kind", sorted(SIGNALS))
def test_port_frontend_matches_jax(jax_frontends, port_frontend, kind, ref):
    sig = SIGNALS[kind]()
    m_ref, l_ref = jax_frontends[ref].mspec_loge_np(sig)
    m, lg, t = port_frontend.mspec_loge(sig)
    # a CPU tensor runs the plain version: the kernel is never launched
    assert fe_kernel.sidekit_features.launches == 0
    assert t == sidekit.frame_count(len(sig)) == len(m_ref)
    assert m.dtype == lg.dtype == torch.float32
    assert m.device.type == "cpu"
    _assert_features_close(m.numpy(), lg.numpy(), m_ref, l_ref)


def test_digital_silence_rows_are_minus_inf(port_frontend):
    sig = to_int16(speechlike(3.0, seed=12, silences=[(1.0, 1.6)]))
    m, lg, _ = port_frontend.mspec_loge(sig)
    # frames lying wholly inside [1.0, 1.6) s are exactly silent
    f_first = -(-16000 // 160)
    f_last = (int(1.6 * 16000) - 400) // 160
    silent = np.zeros(len(lg), bool)
    silent[f_first:f_last + 1] = True
    assert np.all(np.isneginf(m.numpy()[silent]))
    assert np.all(np.isneginf(lg.numpy()[silent]))
    assert np.all(np.isfinite(lg.numpy()[~silent]))


def test_int16_and_float_agree(port_frontend):
    sig16 = to_int16(speechlike(1.0, seed=5))
    m16, l16, _ = port_frontend.mspec_loge(sig16)
    mf, lf, _ = port_frontend.mspec_loge(sig16.astype(np.float32) / 32768.0)
    np.testing.assert_array_equal(m16.numpy(), mf.numpy())
    np.testing.assert_array_equal(l16.numpy(), lf.numpy())


@pytest.mark.parametrize("n", [0, 399, 400, 559, 560])
def test_frame_count_edges(port_frontend, n):
    m, lg, t = port_frontend.mspec_loge(np.ones(n, np.float32))
    assert t == sidekit.frame_count(n) == (0 if n < 400 else (n - 400) // 160 + 1)
    assert m.shape == (t, 24) and lg.shape == (t,)


def test_wrapper_rejects_other_devices():
    sig = torch.zeros(1000, device="meta")
    consts = sidekit.frontend_consts("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        fe_kernel.sidekit_features(sig, consts)


def _fft_features(sig, consts):
    """The kernel's formulation on the CPU: the power spectrum of a float32
    FFT of each zero-padded 512-point frame (``torch.fft.rfft``, a stand-in
    for the kernel's rounding), the mel bands summed over their nonzero
    bins only, and the log."""
    x = sidekit.to_float_signal(sig)
    t = sidekit.frame_count(x.shape[0])
    frames = x.unfold(0, sidekit.WIN, sidekit.HOP)[:t]
    shifted = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    frames = frames - sidekit.PREFAC * shifted
    loge = torch.log(torch.sum(frames * frames, dim=1))
    spec = torch.fft.rfft(frames * consts.window, n=sidekit.NFFT)
    power = spec.real * spec.real + spec.imag * spec.imag
    mel = torch.stack([power[:, lo:hi] @ consts.fbank_t[lo:hi, m]
                       for m, (lo, hi) in enumerate(consts.band_range.tolist())],
                      dim=1)
    return torch.log(mel), loge


@pytest.mark.parametrize("kind", ["int16", "float32"])
def test_fft_formulation_within_kernel_tolerance(kind):
    """The smoke run's seeded noise mix (a quarter of its sections 40-50 dB
    down, stretches of digital silence) through the FFT formulation meets
    the kernel's tolerance against the plain dense-DFT version."""
    from chip_smoke import seeded_mix, silences_every, to_int16 as smoke_int16

    base = seeded_mix(60, seed=60, silences=silences_every(60))
    sig = torch.from_numpy(smoke_int16(base) if kind == "int16" else base)
    consts = sidekit.frontend_consts("cpu")
    m, lg = _fft_features(sig, consts)
    m_ref, l_ref = fe_kernel.sidekit_features_plain(sig, consts)
    fin = np.isfinite(m_ref.numpy())
    assert fin.any() and not fin.all()
    _assert_features_close(m.numpy(), lg.numpy(), m_ref.numpy(),
                           l_ref.numpy())


def test_band_ranges_cover_every_nonzero_filter_bin():
    consts = sidekit.frontend_consts("cpu")
    fb = consts.fbank_t.numpy()
    for m, (lo, hi) in enumerate(consts.band_range.numpy()):
        nz = np.flatnonzero(fb[:, m])
        assert lo == nz[0] and hi == nz[-1] + 1
    tw = consts.twiddle.numpy()
    want = np.exp(-2j * np.pi * np.arange(256) / 512)
    np.testing.assert_array_equal(tw[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], want.imag.astype(np.float32))
