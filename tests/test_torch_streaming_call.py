"""PyTorch port: ``Segmenter.segment_signal``'s interleaved streaming call
path, the speculative gender emissions and the pipeline's JAX-named API,
against the JAX package.

Both packages run on the same ``size="small"`` synthetic weights and the
same seeded signals (CHUNK = 4096 frames, ~41 s a chunk).

- ``segment_signal`` for ``ISS_STREAMING`` 0 / 1 x ``ISS_STREAM_GENDER``
  0 / 1, int16 and float, on a 2.2-chunk signal (streamed), a one-chunk
  signal and one under 68 frames (both fused on the group's rows): the
  lseg exactly equal to the JAX package's under the same switches, and
  streamed equal to fused.
- ``chunk_emissions(gender=True)``: VAD and gender emissions within atol
  1e-5 of the JAX ``chunk_emissions`` with gender params (float32
  convolutions summed in another order, tests/test_torch_cnn.py's
  tolerance).
- ``return_pcm``: one part a group, the parts tiling the signal in order
  with no overlap and no lookahead; the VFS tuple on the int16 grid the
  same streamed and fused; ``ISS_STREAMING=0`` keeps the overlapped VFS
  scorer off.
- ``OnlineSegmenter`` under ``ISS_STREAMING=0`` (a passthrough) and under
  ``ISS_STREAM_GENDER=1``, also when the switch turns on mid-stream:
  ``finalize()`` equal to the offline labels.
- ``bucket_chunks`` / ``bucket_rows`` equal to JAX's over 1-10,000,
  ``default_viterbi_mode``, and ``FusedPipeline(viterbi_mode=...,
  skip_inactive=False)`` giving the same labels.
"""

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu_torch import OnlineSegmenter, Segmenter
from inaspeechsegmenter_tpu_torch import VoiceFemininityScoring
from inaspeechsegmenter_tpu_torch import pipeline as tpipe
from inaspeechsegmenter_tpu_torch.dsp.sidekit import CHUNK, HOP
from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
from torch_parity_helpers import (int16_grid_on_cpu, speechlike, to_int16,
                                  voiced)

SWITCHES = [("0", "0"), ("0", "1"), ("1", "0"), ("1", "1")]


@pytest.fixture(scope="module")
def port_seg(synthetic_model_dir):
    return Segmenter("smn", True, ffmpeg=None, device="cpu",
                     model_dir=synthetic_model_dir)


@pytest.fixture(scope="module")
def jax_seg(synthetic_model_dir):
    from inaspeechsegmenter_tpu import Segmenter as JaxSegmenter

    return JaxSegmenter(vad_engine="smn", detect_gender=True, ffmpeg=None,
                        allow_download=False)


def _signal(length, kind):
    """Tone sections (``voiced``: the small synthetic VAD calls most of
    them speech) with digital silences.  ``multi``: 2.05 chunks (three
    chunks, one group); ``two_chunks``: 1.05 chunks; ``one_chunk``: 12 s;
    ``short``: 0.5 s (48 frames, under 68)."""
    seconds = {"multi": 2.05 * CHUNK * HOP / 16000,
               "two_chunks": 1.05 * CHUNK * HOP / 16000, "one_chunk": 12.0,
               "short": 0.5}[length]
    sig = to_int16(voiced(seconds, seed=61, silences=(
        (20.0, 21.0), (21.3, 22.0), (60.0, 62.0))))
    return sig if kind == "int16" else sig.astype(np.float32) / 32768.0


@pytest.fixture(scope="module")
def fused_lseg(port_seg):
    """The port's default (fused) lseg of each signal."""
    cache = {}

    def get(length, kind):
        if (length, kind) not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.delenv("ISS_STREAMING", raising=False)
                cache[length, kind] = port_seg.segment_signal(
                    _signal(length, kind))
        return cache[length, kind]
    return get


@pytest.mark.parametrize("kind", ["int16", "float32"])
@pytest.mark.parametrize("streaming,gender", SWITCHES)
def test_segment_signal_matches_jax_and_fused(port_seg, jax_seg, fused_lseg,
                                              monkeypatch, streaming, gender,
                                              kind):
    sig = _signal("two_chunks", kind)
    monkeypatch.setenv("ISS_STREAMING", streaming)
    monkeypatch.setenv("ISS_STREAM_GENDER", gender)
    got = port_seg.segment_signal(sig)
    assert got == jax_seg.segment_signal(sig)
    assert got == fused_lseg("two_chunks", kind)
    labels = {lab for lab, _, _ in got}
    assert "noEnergy" in labels and labels & {"male", "female"}


@pytest.mark.parametrize("length", ["one_chunk", "short"])
@pytest.mark.parametrize("streaming,gender", [("1", "0"), ("1", "1")])
def test_short_media_take_the_fused_path(port_seg, jax_seg, fused_lseg,
                                         monkeypatch, streaming, gender,
                                         length):
    sig = _signal(length, "int16")
    monkeypatch.setenv("ISS_STREAMING", streaming)
    monkeypatch.setenv("ISS_STREAM_GENDER", gender)
    calls = []
    real = port_seg.pipeline.stream_decode
    monkeypatch.setattr(port_seg.pipeline, "stream_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = port_seg.segment_signal(sig)
    assert got == jax_seg.segment_signal(sig) == fused_lseg(length, "int16")
    assert calls == []


def test_streaming_path_queues_emissions_before_the_last_group(
        port_seg, monkeypatch):
    """With one chunk a group, each chunk's emissions are computed as soon
    as its right neighbour's group has its features, before the next
    group is uploaded; the decode takes the gender emissions per chunk."""
    monkeypatch.setenv("ISS_STREAMING", "1")
    monkeypatch.setenv("ISS_STREAM_GENDER", "1")
    monkeypatch.setenv("ISS_UPLOAD_CHUNKS", "1")
    events = []
    pipe = port_seg.pipeline
    real_emit, real_decode = pipe.chunk_emissions, pipe.stream_decode
    real_group = port_seg.frontend.group_feats

    def emit(chunks, c, zero_right=False, gender=False):
        events.append(("emit", c, gender))
        return real_emit(chunks, c, zero_right=zero_right, gender=gender)

    def decode(*a, **k):
        events.append(("decode", k.get("probs_g") is not None))
        return real_decode(*a, **k)

    def group(raw, k, keep_pcm=False):
        events.append(("group", k))
        return real_group(raw, k, keep_pcm)

    monkeypatch.setattr(pipe, "chunk_emissions", emit)
    monkeypatch.setattr(pipe, "stream_decode", decode)
    monkeypatch.setattr(port_seg.frontend, "group_feats", group)
    port_seg.segment_signal(_signal("multi", "int16"))
    assert events == [("group", 1), ("group", 1), ("emit", 0, True),
                      ("group", 1), ("emit", 1, True), ("emit", 2, True),
                      ("decode", True)]


def test_chunk_emissions_with_gender_match_jax(port_seg, jax_seg):
    sig = _signal("two_chunks", "int16")
    chunks, _ = jax_seg.frontend.mspec_loge_chunks(sig)
    port = [(torch.from_numpy(np.asarray(m).copy()),
             torch.from_numpy(np.asarray(lg).copy())) for m, lg in chunks]
    vp, gp = jax_seg.vad.model.params, jax_seg.gender.model.params
    for c in range(len(chunks)):
        want_v, want_g = jax_seg.pipeline.chunk_emissions(vp, gp, chunks, c)
        got_v, got_g = port_seg.pipeline.chunk_emissions(port, c,
                                                         gender=True)
        assert got_v.shape == (CHUNK // 2, 3) and got_g.shape == (CHUNK // 2,
                                                                   2)
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   rtol=0, atol=1e-5)
        if c == 0:
            first_v = got_v
    pv, pg = port_seg.pipeline.chunk_emissions(port, 0)
    assert pg is None and torch.equal(pv, first_v)


@pytest.mark.parametrize("case", ["groups_of_1", "past_last_chunk",
                                  "float"])
def test_return_pcm_parts_tile_the_signal(port_seg, fused_lseg, monkeypatch,
                                          case):
    monkeypatch.setenv("ISS_STREAMING", "1")
    monkeypatch.setenv("ISS_UPLOAD_CHUNKS", "1")
    if case == "past_last_chunk":
        # its last samples fall past its last chunk's frames: the groups
        # grow by one chunk and the parts still end at the signal's end
        n = CHUNK * HOP + 390
        sig = to_int16(speechlike(n / 16000, seed=62))
    else:
        sig = _signal("multi", "int16")
    if case == "float":
        lseg, parts = port_seg.segment_signal(
            _signal("two_chunks", "float32"), return_pcm=True)
        assert parts is None and lseg == fused_lseg("two_chunks", "float32")
        return
    lseg, parts = port_seg.segment_signal(sig, return_pcm=True)
    n_groups = {"groups_of_1": 3, "past_last_chunk": 2}[case]
    assert len(parts) == n_groups
    assert all(p.dtype == torch.int16 for p in parts)
    assert [p.shape[0] for p in parts[:-1]] == [CHUNK * HOP] * (n_groups - 1)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), sig)
    if case != "past_last_chunk":
        assert lseg == fused_lseg("multi", "int16")


def test_vfs_tuple_unchanged_by_streaming(synthetic_model_dir, monkeypatch):
    int16_grid_on_cpu(monkeypatch)
    net = ResNetXVector("bottleneck", (1, 1, 1, 1), 8, 64, 256)
    vfs = VoiceFemininityScoring("bgc", ffmpeg=None, device="cpu",
                                 model_dir=synthetic_model_dir,
                                 xvector_net=net,
                                 xvector_params=net.init_params(seed=7))
    sig = to_int16(voiced(1.3 * CHUNK * HOP / 16000, seed=63,
                          silences=((30.0, 33.0),)))
    monkeypatch.setenv("ISS_STREAMING", "0")
    want = vfs.score_signal(sig)
    monkeypatch.setenv("ISS_STREAMING", "1")
    monkeypatch.setenv("ISS_UPLOAD_CHUNKS", "1")
    got = vfs.score_signal(sig)
    assert got == want and want[1] > 0 and want[2] > 0
    # the kill switch also keeps the overlapped scorer off, as in JAX
    monkeypatch.setenv("ISS_VFS_OVERLAP", "1")
    assert vfs._overlap_eligible()
    monkeypatch.setenv("ISS_STREAMING", "0")
    assert not vfs._overlap_eligible()


def _online_final(seg, sig, block, flip=None):
    """Feed ``sig`` in ``block``-sample pieces, one chunk a feature group,
    polling once two chunks exist (before, a poll re-segments the whole
    buffer) and at the end; ``flip()`` runs once two chunks exist."""
    online = OnlineSegmenter(seg)
    online._group = 1
    for pos in range(0, len(sig), block):
        online.feed(sig[pos:pos + block])
        if online.chunks_ready >= 2:
            if flip is not None:
                flip()
                flip = None
            online.current()
    online.current()
    return online, online.finalize()


@pytest.mark.parametrize("case", ["passthrough", "gender", "flip"])
def test_online_finalize_equals_offline(port_seg, fused_lseg, monkeypatch,
                                        case):
    # the flip needs a chunk cached before it: two groups of one chunk
    length = "multi" if case == "flip" else "two_chunks"
    sig = _signal(length, "int16")
    if case == "passthrough":
        monkeypatch.setenv("ISS_STREAMING", "0")
    elif case == "gender":
        monkeypatch.setenv("ISS_STREAM_GENDER", "1")
    else:
        monkeypatch.setenv("ISS_STREAM_GENDER", "0")
    online, final = _online_final(
        port_seg, sig, 5 * 16000,
        flip=(lambda: monkeypatch.setenv("ISS_STREAM_GENDER", "1"))
        if case == "flip" else None)
    assert final == fused_lseg(length, "int16")
    assert online._passthrough == (case == "passthrough")
    if case == "passthrough":
        assert online.chunks_ready == 0 and online.buffered_samples == len(sig)
    elif case == "gender":
        assert all(pg is not None for _, pg in online._probs.values())
    else:
        # chunk 0 was cached before the switch: the tail's gender pass ran
        gparts = [online._probs[c][1] for c in sorted(online._probs)]
        assert len(gparts) == 2
        assert gparts[0] is None and gparts[-1] is not None


def test_bucket_ladder_equals_jax():
    from inaspeechsegmenter_tpu.pipeline import bucket_chunks, bucket_rows

    for n in range(1, 10_001):
        assert tpipe.bucket_chunks(n) == bucket_chunks(n), n
        assert tpipe.bucket_rows(n) == bucket_rows(n), n
    assert tpipe.bucket_rows(0) == bucket_rows(0) == CHUNK


def test_default_viterbi_mode(monkeypatch):
    monkeypatch.delenv("ISS_VITERBI_MODE", raising=False)
    assert tpipe.default_viterbi_mode("cpu") == "scan"
    assert tpipe.default_viterbi_mode(torch.device("cuda", 0)) == "blocked"
    for mode in ("scan", "parallel", "blocked"):
        monkeypatch.setenv("ISS_VITERBI_MODE", mode)
        assert tpipe.default_viterbi_mode("cpu") == mode
        assert tpipe.default_viterbi_mode("cuda") == mode
    monkeypatch.setenv("ISS_VITERBI_MODE", "fastest")
    assert tpipe.default_viterbi_mode("cpu") == "scan"


def test_fused_pipeline_modes_give_the_same_labels(port_seg):
    sig = _signal("one_chunk", "int16")
    mspec, loge, t = port_seg.frontend.mspec_loge(sig)
    n20 = (t + 1) // 2
    stages = (port_seg.vad.as_pipeline_stage(),
              port_seg.gender.as_pipeline_stage())
    want = port_seg.pipeline.run(mspec, loge, t, t, n20)
    assert port_seg.pipeline.viterbi_mode == "scan"
    for mode in ("scan", "parallel", "blocked"):
        for skip in (True, False):
            pipe = tpipe.FusedPipeline(*stages, 0.03, mode, skip,
                                       device="cpu")
            assert pipe.viterbi_mode == mode and pipe.skip_inactive == skip
            torch.testing.assert_close(pipe.run(mspec, loge, t, t, n20),
                                       want, rtol=0, atol=0)
    with pytest.raises(KeyError):
        tpipe.FusedPipeline(*stages, viterbi_mode="fastest", device="cpu")
