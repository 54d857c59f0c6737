"""PyTorch port: the int16 VBx device grid against the JAX package.

Both sides run their int16 path on the CPU
(``torch_parity_helpers.int16_grid_on_cpu``: by default both take it on
an accelerator only).  Tolerance of the port against JAX:
``dsp.vbx.device_atol(n_frames, blocked=True)``: 5e-4 for the float32 DFT
sums in another order, plus the CMVN cumsum's drift, which the grid
bounds by one block's extent (8,800 frames) instead of the file's length.

Within the port the grid is exact by construction, and these hold bit for
bit: a ``VbxPcmStream`` fed in random pieces against the whole signal;
``VbxPcmStreamOnline``'s safe blocks, as they land, against the offline
features, and its ``finalize()``; ``features_from_pcm`` against
``_features_i16``.  The dither cache grown in steps continues the
MT19937(3) stream, equal to the JAX package's cache.  The f32 path, the
CPU's, is unchanged.
"""

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu.dsp import vbx as jvbx
from inaspeechsegmenter_tpu_torch.dsp import vbx as tvbx
from torch_parity_helpers import int16_grid_on_cpu, speechlike, to_int16

# 9,000 frames: two blocks of the grid, the second one partial
N_TWO_BLOCKS = (9000 - 1) * 160 + 80


def i16_signal(n, seed):
    sig = to_int16(speechlike(n / 16000 + 0.01, seed=seed,
                              silences=[(1.0, 1.8)]))[:n]
    assert len(sig) == n
    return sig


@pytest.fixture
def int16_path(monkeypatch):
    int16_grid_on_cpu(monkeypatch)


@pytest.fixture(scope="module")
def fe():
    return tvbx.VbxFrontend("cpu")


@pytest.fixture(scope="module")
def two_blocks(fe):
    sig = i16_signal(N_TWO_BLOCKS, seed=5)
    return sig, fe._features_i16(sig, len(sig)).numpy()


@pytest.mark.parametrize("n", [400, 16000 * 3 + 77, N_TWO_BLOCKS])
def test_features_i16_match_jax(int16_path, fe, n):
    sig = i16_signal(n, seed=n % 1000)
    want = np.asarray(jvbx.VbxFrontend()._features_i16(sig, n))
    got = fe._features_i16(sig, n)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    n_frames = (n - 80) // 160 + 1
    assert got.shape == want.shape == (n_frames, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tvbx.device_atol(n_frames, blocked=True))
    # features() of the float signal takes the same path when it is on
    np.testing.assert_array_equal(
        fe.features(sig.astype(np.float64) / 32768.0).numpy(), got.numpy())


def test_stream_in_random_pieces_equals_whole(fe, two_blocks):
    sig, whole = two_blocks
    rng = np.random.default_rng(1)
    for trial in range(2):
        stream = tvbx.VbxPcmStream(fe, len(sig))
        pos, ready = 0, []
        while pos < len(sig):
            k = int(rng.integers(1, 600_000 if trial else 20_000))
            stream.append(sig[pos:pos + k])
            pos += k
            ready.append(stream.frames_ready)
            fr = stream.frames_ready
            np.testing.assert_array_equal(stream.fea_buffer[:fr].numpy(),
                                          whole[:fr])
        np.testing.assert_array_equal(stream.finish().numpy(), whole)
        assert ready == sorted(ready) and ready[-1] == len(whole)


def test_online_stream_safe_blocks_equal_offline(fe, two_blocks):
    sig, whole = two_blocks
    online = tvbx.VbxPcmStreamOnline(fe)
    rng = np.random.default_rng(2)
    pos, seen = 0, set()
    while pos < len(sig):
        k = int(rng.integers(1, 200_000))
        online.append(torch.from_numpy(sig[pos:pos + k]))
        pos += k
        fr = online.frames_ready
        seen.add(fr)
        np.testing.assert_array_equal(online.fea_buffer[:fr].numpy(),
                                      whole[:fr])
    # the first block is final before the end (its halo + GUARD passed)
    assert tvbx.VBX_BLK in seen
    final = online.finalize()
    np.testing.assert_array_equal(final.numpy(), whole)
    assert online.finalize() is final
    with pytest.raises(RuntimeError):
        online.append(sig[:10])


def test_features_from_pcm_equals_features_i16(fe, two_blocks):
    sig, whole = two_blocks
    one = fe.features_from_pcm([torch.from_numpy(sig)], len(sig))
    np.testing.assert_array_equal(one.numpy(), whole)
    # parts that tile the signal; parts that fall short raise
    cut = 700_000
    parts = [torch.from_numpy(sig[:cut]), torch.from_numpy(sig[cut:])]
    np.testing.assert_array_equal(
        fe.features_from_pcm(parts, len(sig)).numpy(), whole)
    with pytest.raises(RuntimeError, match="incomplete"):
        fe.features_from_pcm(parts[:1], len(sig))


def test_dither_growth_continues_the_stream(monkeypatch):
    monkeypatch.setattr(tvbx, "DITHER_STEP", 1000)
    fe = tvbx.VbxFrontend("cpu")
    a = fe._dither_buffer(1500).clone()
    assert fe._dither_len == 2000
    b = fe._dither_buffer(4500)
    assert fe._dither_len == 5000 and fe._dither_full(10).shape[0] == 5000
    want = (8.0 * (2.0 * np.random.RandomState(3).rand(5000) - 1.0)).astype(
        np.float32)
    np.testing.assert_array_equal(a.numpy(), want[:1500])
    np.testing.assert_array_equal(b.numpy(), want[:4500])
    jax_fe = jvbx.VbxFrontend()
    np.testing.assert_array_equal(np.asarray(jax_fe._dither_buffer(4500)),
                                  b.numpy())


def test_f32_path_unchanged(monkeypatch, fe):
    sig = i16_signal(16000 * 2 + 5, seed=3).astype(np.float64) / 32768.0
    ref = fe.device_features(torch.from_numpy(tvbx.host_segment(sig)))
    # the CPU takes the f32 path, whatever the JAX package's variable says
    monkeypatch.setenv("ISS_VBX_UPLOAD", "int16")
    np.testing.assert_array_equal(fe.features(sig).numpy(), ref.numpy())
    monkeypatch.setenv("ISS_VBX_UPLOAD", "f32")
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jvbx.VbxFrontend().features(sig)), rtol=0,
        atol=5e-4)


def test_short_or_unscalable_signals_take_the_f32_path(int16_path, fe):
    """Under 400 samples, or a float signal past int16's range, the int16
    path cannot take it."""
    short = np.linspace(-0.5, 0.5, 399)
    loud = np.full(2000, 1.5)
    for sig in (short, loud):
        want = fe.device_features(torch.from_numpy(tvbx.host_segment(sig)))
        np.testing.assert_array_equal(fe.features(sig).numpy(), want.numpy())


def test_vbx_i16_enabled(monkeypatch):
    """The device alone picks the path."""
    for mode in ("int16", "f32"):
        monkeypatch.setenv("ISS_VBX_UPLOAD", mode)
        assert not tvbx.vbx_i16_enabled("cpu")
        assert tvbx.vbx_i16_enabled(torch.device("cuda", 0))
        assert tvbx.vbx_i16_enabled("cuda")
    with pytest.raises(ValueError):
        tvbx.VbxPcmStream(tvbx.VbxFrontend("cpu"), 399)


def test_device_atol_blocked_is_bounded():
    assert tvbx.device_atol(10 ** 6, blocked=True) == tvbx.device_atol(
        tvbx._EXT, blocked=True)
    assert tvbx.device_atol(5000, blocked=True) == tvbx.device_atol(5000)
    assert tvbx.device_atol(10 ** 6, blocked=True) < 2e-3
