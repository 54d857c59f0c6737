"""PyTorch port: the streaming path against the JAX package's.

Both packages run on the same ``size="small"`` synthetic weights and the
same seeded signals of 2-4.5 feature chunks (CHUNK = 4096 frames, ~41 s).

- Group features (one launch per group of chunks): finite masks equal,
  mspec within rtol/atol 1e-4 and loge within 1e-5 of the JAX
  ``SidekitFrontend.group_feats`` (float32 DFTs summed in another order,
  the tolerance of tests/test_torch_features.py).  Against the port's own
  whole-signal features the same rows are held within the same tolerance:
  the plain version's last, zero-padded group runs a full CHUNK-row matmul
  where the whole signal runs a partial one.
- ``chunk_emissions`` on the JAX package's features: within atol 1e-5 of
  the JAX ``chunk_emissions`` for the first, a middle and the last chunk
  and a zero right halo (float32 convolutions in another order, the
  tolerance of tests/test_torch_cnn.py).
- ``stream_decode`` on the JAX package's features and emissions, with and
  without the ``ext`` suffix triple: labels exactly equal.
- ``run_streaming`` labels exactly equal the port's fused ``run``.
"""

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu_torch import Segmenter
from inaspeechsegmenter_tpu_torch.dsp.sidekit import CHUNK, HOP, frame_count
from torch_parity_helpers import speechlike, to_int16

MIX_CHUNKS = 3.4


@pytest.fixture(scope="module")
def port_seg(synthetic_model_dir):
    return Segmenter("smn", True, ffmpeg=None, device="cpu",
                     model_dir=synthetic_model_dir)


@pytest.fixture(scope="module")
def jax_seg(synthetic_model_dir):
    from inaspeechsegmenter_tpu import Segmenter as JaxSegmenter

    return JaxSegmenter(vad_engine="smn", detect_gender=True, ffmpeg=None,
                        allow_download=False)


def _mix(chunks, seed, silences=((20.0, 21.0), (21.3, 22.0), (95.0, 97.0))):
    n = int(chunks * CHUNK * HOP)
    return to_int16(speechlike(n / 16000, seed=seed, silences=silences))


@pytest.fixture(scope="module")
def jax_chunks(jax_seg):
    """The JAX package's per-chunk features of the 3.4-chunk mix, and the
    same as CPU tensors."""
    sig = _mix(MIX_CHUNKS, seed=41)
    chunks, t = jax_seg.frontend.mspec_loge_chunks(sig)
    host = [(np.asarray(m), np.asarray(lg)) for m, lg in chunks]
    port = [(torch.from_numpy(m.copy()), torch.from_numpy(lg.copy()))
            for m, lg in host]
    return chunks, port, t


def _assert_features_close(m, lg, m_ref, l_ref):
    fin = np.isfinite(m_ref)
    np.testing.assert_array_equal(np.isfinite(m), fin)
    np.testing.assert_allclose(m[fin], m_ref[fin], rtol=1e-4, atol=1e-4)
    finl = np.isfinite(l_ref)
    np.testing.assert_array_equal(np.isfinite(lg), finl)
    np.testing.assert_allclose(lg[finl], l_ref[finl], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["int16", "float32"])
@pytest.mark.parametrize("k", [1, 3])
def test_group_feats_match_jax(port_seg, jax_seg, kind, k):
    sig = _mix(k + 0.5, seed=40 + k, silences=((3.0, 5.5),))
    if kind == "float32":
        sig = sig.astype(np.float32) / 32768.0
    raw = sig[:(k * CHUNK + 2) * HOP]
    got, pcm = port_seg.frontend.group_feats(raw, k)
    want, _ = jax_seg.frontend.group_feats(raw, k)
    assert pcm is None and len(got) == len(want) == k
    for (m, lg), (mj, lj) in zip(got, want):
        assert m.shape == (CHUNK, 24) and lg.shape == (CHUNK,)
        _assert_features_close(m.numpy(), lg.numpy(), np.asarray(mj),
                               np.asarray(lj))


def test_group_rows_match_whole_signal(port_seg):
    sig = _mix(4.3, seed=43)
    t = frame_count(len(sig))
    chunks, t_chunks = port_seg.frontend.mspec_loge_chunks(sig)
    assert t_chunks == t and len(chunks) == 5        # 2 groups: 3 + 2
    mspec, loge, _ = port_seg.frontend.mspec_loge(sig)
    m = torch.cat([c[0] for c in chunks])[:t].numpy()
    lg = torch.cat([c[1] for c in chunks])[:t].numpy()
    _assert_features_close(m, lg, mspec.numpy(), loge.numpy())
    with pytest.raises(ValueError, match="samples"):
        port_seg.frontend.group_feats(sig[:CHUNK * HOP], 1)


@pytest.mark.parametrize("case", ["first", "middle", "last", "zero_right"])
def test_chunk_emissions_match_jax(port_seg, jax_seg, jax_chunks, case):
    chunks, port_chunks, _ = jax_chunks
    c = {"first": 0, "middle": 1, "last": len(chunks) - 1,
         "zero_right": 1}[case]
    zero_right = case == "zero_right"
    want, _ = jax_seg.pipeline.chunk_emissions(
        jax_seg.vad.model.params, None, chunks, c, zero_right=zero_right)
    got, got_g = port_seg.pipeline.chunk_emissions(port_chunks, c,
                                                   zero_right=zero_right)
    assert got.shape == (CHUNK // 2, 3) and got_g is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    if case == "first":
        # the left replicate: frames 0..17 all read window 0
        np.testing.assert_array_equal(got[:17].numpy(),
                                      np.broadcast_to(got[17].numpy(),
                                                      (17, 3)))


@pytest.mark.parametrize("suffix", [False, True])
def test_stream_decode_matches_jax(port_seg, jax_seg, jax_chunks, suffix):
    """The tail on the same features and VAD emissions; with ``suffix`` a
    decode of chunks 1.. only, with chunk 0's finite log-energy statistics
    and a near-one-hot energy initial state (the online suffix decode)."""
    chunks, port_chunks, t = jax_chunks
    vp, gp = jax_seg.vad.model.params, jax_seg.gender.model.params
    probs = [np.asarray(jax_seg.pipeline.chunk_emissions(
        vp, None, chunks, c)[0]) for c in range(len(chunks))]
    ext = None
    c0 = 0
    if suffix:
        c0 = 1
        lg0 = np.asarray(chunks[0][1])
        fin = np.isfinite(lg0)
        e_init = np.full(2, np.log(1e-200), np.float32)
        e_init[0] = 0.0
        ext = (float(lg0[fin].sum()), float(fin.sum()), e_init)
    n = t - c0 * CHUNK
    n20 = (n + 1) // 2
    want = np.asarray(jax_seg.pipeline.stream_decode(
        vp, gp, chunks[c0:], probs[c0:], None, n, n, n20, ext=ext))[:n20]
    got = port_seg.pipeline.stream_decode(
        port_chunks[c0:], [torch.from_numpy(p) for p in probs[c0:]], n, n,
        n20, ext=ext)
    assert got.dtype == torch.int32 and got.shape == (n20,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 in want and len(np.unique(want)) >= 2
    if not suffix:
        # the energy, VAD and gender decodes all shaped the result
        assert set(np.unique(want)) & {4, 5}


@pytest.mark.parametrize("chunks,seed,kind", [(2.2, 44, "int16"),
                                              (3.4, 45, "float32"),
                                              (4.5, 46, "int16")])
def test_run_streaming_equals_fused(port_seg, chunks, seed, kind):
    sig = _mix(chunks, seed=seed)
    if kind == "float32":
        sig = sig.astype(np.float32) / 32768.0
    feats, t = port_seg.frontend.mspec_loge_chunks(sig)
    n20 = (t + 1) // 2
    got = port_seg.pipeline.run_streaming(feats, t, t, n20)
    mspec, loge, _ = port_seg.frontend.mspec_loge(sig)
    want = port_seg.pipeline.run(mspec, loge, t, t, n20)
    np.testing.assert_array_equal(got.numpy(), want.numpy())

