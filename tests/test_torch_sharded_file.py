"""PyTorch port: the sequence-parallel single-file decode
(``FusedPipeline.run_sharded``, ``ParallelEngine.__call__``) on meshes of
repeated CPU slots, against the port's fused ``run`` and the JAX package's
``run_sharded`` on its 8 virtual CPU devices.

Labels must be EQUAL, on the same features and the same ``size="small"``
weights: the chunk decomposition is the streaming one, so what is under
test is the split over slots, the zero windows past either end of the
file, the left-edge repair of chunk 0 and the gathered speculative gender
emissions.  Random features (the JAX test's) give noEnergy and one VAD
class; the voiced features reach speech, hence the gender decode.
"""

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu_torch import Segmenter
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.dsp.sidekit import CHUNK
from inaspeechsegmenter_tpu_torch.parallel import ParallelEngine, make_mesh
from inaspeechsegmenter_tpu_torch.segmenter import patch_counts
from torch_parity_helpers import to_int16, voiced, write_fake_ffmpeg


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def port_seg(synthetic_model_dir):
    return Segmenter("smn", True, ffmpeg=None, device="cpu",
                     model_dir=synthetic_model_dir)


@pytest.fixture(scope="module")
def jax_seg(synthetic_model_dir):
    from inaspeechsegmenter_tpu import Segmenter as JaxSegmenter

    return JaxSegmenter(vad_engine="smn", detect_gender=True, ffmpeg=None,
                        allow_download=False)


@pytest.fixture(scope="module")
def jax_engine(jax_seg):
    from inaspeechsegmenter_tpu.parallel import ParallelEngine as JaxEngine

    return JaxEngine(jax_seg)


def random_feats(t, seed, rows=None):
    """The JAX test's features: silence stretches, the rest noise."""
    rng = np.random.default_rng(seed)
    rows = rows or t
    mspec = rng.standard_normal((rows, 24)).astype(np.float32)
    loge = rng.standard_normal(rows).astype(np.float32)
    loge[: t // 5] = -20.0
    loge[t // 2: t // 2 + t // 10] = -20.0
    loge[t:] = -np.inf
    return mspec, loge


def voiced_feats(seg, seconds, seed):
    sig = to_int16(voiced(seconds, seed, silences=[(3.0, 4.0)]))
    mspec, loge, t, difflen = seg._sig2feats(sig)
    assert difflen == 0
    return mspec.numpy(), loge.numpy()


def jax_run_sharded(jax_seg, mesh, mspec, loge, t):
    """The JAX run_sharded on the features padded to its row bucket."""
    import jax.numpy as jnp

    from inaspeechsegmenter_tpu.pipeline import bucket_chunks

    rows = len(mspec)
    bucket = bucket_chunks(-(-rows // CHUNK)) * CHUNK
    mspec_pad = np.zeros((bucket, 24), np.float32)
    mspec_pad[:rows] = mspec
    loge_pad = np.full(bucket, -np.inf, np.float32)
    loge_pad[:len(loge)] = loge
    nfp, n20 = patch_counts(t, 0)
    gp = jax_seg.gender.model.params if jax_seg.detect_gender else None
    return np.asarray(jax_seg.pipeline.run_sharded(
        jax_seg.vad.model.params, gp, jnp.asarray(mspec_pad),
        jnp.asarray(loge_pad), t, nfp, n20, mesh))[:n20]


def port_both(seg, mesh, mspec, loge, t):
    """(run_sharded, run) label ids of the port."""
    m, lg = torch.from_numpy(mspec), torch.from_numpy(loge)
    nfp, n20 = patch_counts(t, 0)
    got = seg.pipeline.run_sharded(m, lg, t, nfp, n20, mesh).numpy()
    want = seg.pipeline.run(m, lg, t, nfp, n20).numpy()
    assert got.shape == (n20,)
    return got, want


@pytest.mark.parametrize("case", ["random-5000-on-8", "random-40000-on-8",
                                  "sub-chunk-on-8", "3-chunks-on-5",
                                  "voiced-on-8", "voiced-on-2"])
def test_sharded_equals_fused_and_jax(port_seg, jax_seg, jax_engine, case):
    from inaspeechsegmenter_tpu.parallel.mesh import make_mesh as jax_mesh

    n_slots = int(case.rsplit("-", 1)[1])
    if case.startswith("random"):
        t = int(case.split("-")[1])
        mspec, loge = random_feats(t, seed=t)
    elif case == "sub-chunk-on-8":
        # rows shorter than one chunk, loge -inf past t (the dry run's case)
        t = 2048 - 100
        mspec, loge = random_feats(t, seed=7, rows=2048)
    elif case == "3-chunks-on-5":
        # 3 chunks on 5 slots: two slots run nothing
        t = 3 * CHUNK - 77
        mspec, loge = random_feats(t, seed=8)
    else:
        mspec, loge = voiced_feats(port_seg, 100.0, seed=9)
        t = len(loge)
        assert -(-t // CHUNK) == 3
    got, want = port_both(port_seg, cpu_mesh(n_slots), mspec, loge, t)
    np.testing.assert_array_equal(got, want)
    jmesh = jax_engine.mesh if n_slots == 8 else jax_mesh(n_slots)
    np.testing.assert_array_equal(
        got, jax_run_sharded(jax_seg, jmesh, mspec, loge, t))
    if case.startswith("voiced"):
        # speech frames took gender labels from the gathered emissions
        assert {0, 4} <= set(np.unique(got).tolist())


def test_sharded_no_gender(synthetic_model_dir, jax_engine):
    from inaspeechsegmenter_tpu import Segmenter as JaxSegmenter

    seg = Segmenter("smn", False, ffmpeg=None, device="cpu",
                    model_dir=synthetic_model_dir)
    jseg = JaxSegmenter(vad_engine="smn", detect_gender=False, ffmpeg=None,
                        allow_download=False)
    t = 3 * CHUNK - 77
    mspec, loge = random_feats(t, seed=10)
    got, want = port_both(seg, cpu_mesh(8), mspec, loge, t)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_run_sharded(jseg, jax_engine.mesh, mspec, loge, t))


def test_sharded_short_media_difflen(port_seg, jax_seg, jax_engine):
    """t < 68 frames (difflen > 0): the left-edge repair and the
    right-edge repair overlap (one patch row covers the file)."""
    sig = (np.random.default_rng(11).standard_normal(8000) * 3000
           ).astype(np.int16)
    with pytest.warns(UserWarning, match="duration is short"):
        feats = port_seg._sig2feats(sig, "<short>")
    assert feats[3] > 0
    engine = ParallelEngine(port_seg, cpu_mesh(8))
    got = engine.segment_feats_sharded(*feats, 0)
    assert got == port_seg._segment(*feats, 0)
    with pytest.warns(UserWarning, match="duration is short"):
        jfeats = jax_seg._sig2feats(sig, "<short>")
    assert got == jax_engine.segment_feats_sharded(*jfeats, 0)


def test_engine_call_and_start_sec(port_seg, jax_seg, jax_engine, tmp_path,
                                   monkeypatch):
    """User surface: engine(file[, start, stop]) == Segmenter(file[, ...])
    and the JAX engine's, the offset added to every time (a window needs
    ffmpeg: both packages decode through the same stand-in)."""
    wav = str(tmp_path / "voiced.wav")
    write_wav(wav, to_int16(voiced(70.0, seed=12, silences=[(10.0, 11.0)])),
              16000)
    silence = str(tmp_path / "silence2sec.wav")
    write_wav(silence, np.zeros(32000, np.int16), 16000)
    engine = ParallelEngine(port_seg, cpu_mesh(4))
    for f in (wav, silence):
        got = engine(f)
        assert got == port_seg(f) == jax_engine(f), f
    ffmpeg = write_fake_ffmpeg(tmp_path)
    monkeypatch.setattr(port_seg, "ffmpeg", ffmpeg)
    monkeypatch.setattr(jax_seg, "ffmpeg", ffmpeg)
    got = engine(wav, start_sec=7.5, stop_sec=61.0)
    assert got[0][1] == 7.5
    assert got == port_seg(wav, start_sec=7.5, stop_sec=61.0)
    assert got == jax_engine(wav, start_sec=7.5, stop_sec=61.0)
    feats = port_seg._media2feats(wav)
    base = engine.segment_feats_sharded(*feats, 0)
    off = engine.segment_feats_sharded(*feats, 7.5)
    assert off == [(lab, a + 7.5, b + 7.5) for lab, a, b in base]


@pytest.mark.parametrize("n_slots", [3, 8])
def test_gathered_emissions_equal_the_fused_emissions(port_seg, monkeypatch,
                                                      n_slots):
    """The VAD and gender emissions that reach the tail, frame by frame,
    equal the fused path's CNN outputs on every frame left of the right
    replicate edge (which the tail repairs), chunk 0's left edge (frames
    < LPAD, repaired after the gather) included: labels alone would
    hide an emission error the Viterbi smooths over."""
    from inaspeechsegmenter_tpu_torch.dsp.patches import LPAD, n_rows_of

    mspec, loge = voiced_feats(port_seg, 100.0, seed=13)
    t = len(loge)
    mesh = cpu_mesh(n_slots)
    pipes, _ = port_seg.pipeline.slots(mesh)
    seen = {}
    tail = pipes[0]._tail
    monkeypatch.setattr(pipes[0], "_tail", lambda *a, probs_g=None, **k: (
        seen.update(v=a[2].clone(), g=probs_g.clone()), tail(
            *a, probs_g=probs_g, **k))[1])
    m, lg = torch.from_numpy(mspec), torch.from_numpy(loge)
    nfp, n20 = patch_counts(t, 0)
    port_seg.pipeline.run_sharded(m, lg, t, nfp, n20, mesh)
    edge = n_rows_of(nfp) + LPAD
    assert edge > LPAD and seen["v"].shape[0] >= edge
    every = torch.ones(n20, dtype=torch.bool)
    p = port_seg.pipeline
    for key, model, nmel, nout in (("v", p.vad_model, p.vad_nmel,
                                    p.vad_nout),
                                   ("g", p.g_model, p.g_nmel, p.g_nout)):
        want = p._cnn_probs(model, m, nfp, nmel, nout, every)[:edge]
        torch.testing.assert_close(seen[key][:edge], want, rtol=1e-5,
                                   atol=1e-6)
