"""PyTorch port: online segmentation, follow mode and online VFS against the
JAX package.

Both packages run on the same ``size="small"`` synthetic weights and the
same seeded signals of up to 4.3 feature chunks (CHUNK = 4096 frames,
~41 s).  Every comparison is exact: segment lists (labels and float
seconds), commit indices, committed label ids, csv bytes and the
``(score, speech_duration, nb_vectors)`` tuples.

- ``OnlineSegmenter.current()`` after every feed equals the JAX object's
  under the same feeds, with ``COMMIT_MAXBACK`` lowered to 2 on both and
  one chunk per feature group, so that commits (forced and at silence
  boundaries) and suffix decodes happen within a few chunks.
- ``finalize()`` equals the JAX ``finalize()`` and both packages'
  ``segment_signal`` (the port's is the fused path).
- ``OnlineVFS`` (the tiny x-vector net of tests/test_torch_vfs.py):
  float32 feeds take the buffered path on both sides, int16 feeds on the
  int16 grid (``torch_parity_helpers.int16_grid_on_cpu``) the stream path
  (``VbxPcmStreamOnline``, no PCM kept past 400 samples) on both;
  provisional ``current()`` after every feed and ``finalize()`` equal the
  JAX object's, and ``finalize()`` equals the port's ``score_signal``.
"""

import functools
import struct
import threading
import time

import numpy as np
import pytest

from inaspeechsegmenter_tpu_torch import (OnlineSegmenter, OnlineVFS,
                                          Segmenter, VoiceFemininityScoring)
from inaspeechsegmenter_tpu_torch import vfs as tvfs
from inaspeechsegmenter_tpu_torch.audio.wav import WavFormatError, write_wav
from inaspeechsegmenter_tpu_torch.dsp.sidekit import CHUNK, HOP
from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
from inaspeechsegmenter_tpu_torch.online import follow_wav
from torch_parity_helpers import (int16_grid_on_cpu, speechlike, to_int16,
                                  voiced)

TINY = ("bottleneck", (1, 1, 1, 1), 8, 64, 256)
FMT = struct.pack("<HHIIHH", 1, 1, 16000, 32000, 2, 16)


@pytest.fixture(scope="module")
def port_seg(synthetic_model_dir):
    return Segmenter("smn", True, ffmpeg=None, device="cpu",
                     model_dir=synthetic_model_dir)


@pytest.fixture(scope="module")
def jax_seg(synthetic_model_dir):
    from inaspeechsegmenter_tpu import Segmenter as JaxSegmenter

    return JaxSegmenter(vad_engine="smn", detect_gender=True, ffmpeg=None,
                        allow_download=False)


def _mix(chunks, seed, silences=()):
    n = int(chunks * CHUNK * HOP)
    return to_int16(speechlike(n / 16000, seed=seed, silences=silences))


def _silent_seams(chunks):
    """8 s of digital silence across every chunk boundary."""
    edge = CHUNK * HOP / 16000
    return [(b * edge - 4.0, b * edge + 4.0) for b in range(1, int(chunks))]


def _feed_blocks(onlines, sig, seed, lo=1, hi=40000):
    """Feed every online object the same random-size blocks (1 sample up
    to 2.5 s, zero-length feeds included)."""
    rng = np.random.default_rng(seed)
    pos = 0
    while pos < len(sig):
        size = int(rng.choice([0, 1, 7, 160, 1601, 16000, 40000,
                               rng.integers(lo, hi)]))
        for o in onlines:
            o.feed(sig[pos:pos + size])
        pos += size


# -- OnlineSegmenter ------------------------------------------------------------

@pytest.mark.parametrize("case", ["forced", "silence"])
def test_current_matches_jax_after_every_feed(port_seg, jax_seg, monkeypatch,
                                              case):
    from inaspeechsegmenter_tpu import OnlineSegmenter as JaxOnline

    monkeypatch.setenv("ISS_UPLOAD_CHUNKS", "1")
    chunks = 4.3
    sig = _mix(chunks, seed=51,
               silences=_silent_seams(chunks) if case == "silence" else ())
    port, jx = OnlineSegmenter(port_seg), JaxOnline(jax_seg)
    port._group = 1                      # one chunk a group, as JAX's above
    port.COMMIT_MAXBACK = jx.COMMIT_MAXBACK = 2
    commits = []
    block = 20 * 16000
    for pos in range(0, len(sig), block):
        port.feed(sig[pos:pos + block])
        jx.feed(sig[pos:pos + block])
        assert port.current() == jx.current()
        assert port._commit == jx._commit
        np.testing.assert_array_equal(port._committed_ids, jx._committed_ids)
        commits.append(port._commit)
    # commits happened, and suffix decodes ran after them
    assert commits[-1] >= 2
    if case == "silence":
        assert not port._commit_act      # committed at noEnergy seams
    want = port_seg.segment_signal(sig)
    assert port.finalize() == jx.finalize() == want
    assert port.finalize() == want                  # idempotent


@pytest.mark.parametrize("kind", ["int16", "float32"])
def test_finalize_matches_jax_and_segment_signal(port_seg, jax_seg, kind):
    from inaspeechsegmenter_tpu import OnlineSegmenter as JaxOnline

    sig = _mix(3.4, seed=52, silences=((30.0, 31.0), (31.3, 32.0)))
    if kind == "float32":
        sig = sig.astype(np.float32) / 32768.0
    port, jx = OnlineSegmenter(port_seg), JaxOnline(jax_seg)
    _feed_blocks([port, jx], sig, seed=53)
    got = port.finalize()
    assert got == jx.finalize() == port_seg.segment_signal(sig)
    assert {lab for lab, _, _ in got} >= {"noEnergy"}


def test_start_sec_and_short_media(port_seg, jax_seg):
    sig = _mix(2.5, seed=54)
    online = OnlineSegmenter(port_seg, start_sec=7.5)
    online.feed(sig)
    got = online.finalize()
    assert got == jax_seg.segment_signal(sig, start_sec=7.5)
    assert got == port_seg.segment_signal(sig, start_sec=7.5)
    assert got[0][1] == 7.5
    # sub-chunk media: the fused short-media path, before and after
    short = _mix(0.12, seed=55)                     # ~5 s
    online = OnlineSegmenter(port_seg)
    online.feed(short[:32000]).feed(short[32000:])
    assert online.current() == port_seg.segment_signal(short)
    assert online.finalize() == jax_seg.segment_signal(short)
    # under one 25 ms analysis window there is nothing to label yet, and
    # finalizing then fails like the offline path does
    tiny = OnlineSegmenter(port_seg)
    tiny.feed(np.zeros(256, np.int16))
    assert tiny.current() == []
    with pytest.raises(ValueError, match="too short"), \
            pytest.warns(UserWarning, match="short"):
        tiny.finalize()


def test_feed_contract(port_seg):
    online = OnlineSegmenter(port_seg)
    buf = np.full(1600, 100, np.int16)
    online.feed(buf)
    buf[:] = -100                        # the caller reuses its buffer
    online.feed(buf)
    sig = online._materialize()
    assert (sig[:1600] == 100).all() and (sig[1600:] == -100).all()
    with pytest.raises(TypeError, match="dtype"):
        online.feed(np.zeros(100, np.float32))
    online.feed(_mix(0.08, seed=56))
    online.finalize()
    with pytest.raises(RuntimeError, match="finalize"):
        online.feed(np.zeros(100, np.int16))


def test_polls_reuse_cache_and_memory_is_bounded(port_seg, monkeypatch):
    """Polls between feature-group completions launch nothing; raw PCM
    is dropped once its group is computed."""
    sig = _mix(3.4, seed=57)
    online = OnlineSegmenter(port_seg)
    online.feed(sig)
    first = online.current()
    assert online.chunks_ready == 3 and online._consumed > 0
    assert online.buffered_samples <= (online._group + 1) * CHUNK * HOP
    calls = []
    pipe = port_seg.pipeline
    for name in ("stream_decode", "chunk_emissions"):
        real = getattr(pipe, name)
        monkeypatch.setattr(pipe, name, functools.partial(
            lambda real, *a, **k: (calls.append(1), real(*a, **k))[1], real))
    again = online.current()
    again[0] = ("mutated", -1.0, -1.0)   # caller-side mutation
    assert online.current() == first and calls == []
    online.feed(sig[:100])               # less than a frame of new audio
    assert online.current() == first and calls == []


# -- follow mode ------------------------------------------------------------------

def _header(data_size=0xFFFFFFFF, fmt=FMT):
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", data_size))


def _growing_wav(path, sig, piece, delay, data_size=0xFFFFFFFF, close=False):
    """A recorder writing to disk: the header in two steps with a BOGUS
    data size, then samples in pieces; with ``close``, the close sequence
    (the true size back-patched, then a tagger's LIST chunk appended)."""
    header = _header(data_size)

    def run():
        with open(path, "wb") as f:
            f.write(header[:16])
            f.flush()
            time.sleep(delay)
            f.write(header[16:])
            f.flush()
            for pos in range(0, len(sig), piece):
                time.sleep(delay)
                f.write(sig[pos:pos + piece].astype("<i2").tobytes())
                f.flush()
            if close:
                f.seek(len(header) - 4)
                f.write(struct.pack("<I", 2 * len(sig)))
                f.seek(0, 2)
                junk = b"\x7f\x01" * 2000       # loud if misread as PCM
                f.write(b"LIST" + struct.pack("<I", len(junk) + 4)
                        + b"INFO" + junk)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def test_follow_growing_file(port_seg, jax_seg, tmp_path):
    sig = _mix(0.72, seed=61)                        # 30 s, sub-chunk
    path = str(tmp_path / "grow.wav")
    th = _growing_wav(path, sig, piece=16000 * 5, delay=0.15)
    updates = []
    got = follow_wav(path, port_seg, idle_timeout=2.0, poll=0.1,
                     on_update=lambda o: updates.append(o.seconds_fed))
    th.join(timeout=10)
    assert not th.is_alive()
    assert got == jax_seg.segment_signal(sig) == port_seg.segment_signal(sig)
    assert len(updates) >= 2 and updates == sorted(updates)


@pytest.mark.parametrize("placeholder", [0xFFFFFFFF, 16000])
def test_follow_close_sequence(port_seg, jax_seg, tmp_path, placeholder):
    """Growth with a bogus (or small fixed) data size, then the close
    back-patch and a trailing tag chunk: no metadata byte is fed as audio,
    and a fixed placeholder does not stall live feeding."""
    sig = _mix(0.24, seed=62)                        # 10 s
    path = str(tmp_path / "close.wav")
    th = _growing_wav(path, sig, piece=16000 * 2, delay=0.1,
                      data_size=placeholder, close=True)
    progressed = []
    got = follow_wav(path, port_seg, idle_timeout=2.0, poll=0.05,
                     on_update=lambda o: progressed.append(
                         (time.monotonic(), o.seconds_fed * 32000)))
    th.join(timeout=10)
    assert not th.is_alive()
    assert got == jax_seg.segment_signal(sig)
    if placeholder == 16000:
        # fed past the placeholder's bound well before the close (~5 s in)
        early = [t for t, fed in progressed if fed > placeholder]
        assert early and early[0] < progressed[0][0] + 3.0


def test_follow_trailing_metadata_and_extensible_fmt(port_seg, jax_seg,
                                                     tmp_path):
    sig = _mix(0.2, seed=63)                         # 8 s
    tagged = str(tmp_path / "tagged.wav")
    write_wav(tagged, sig, 16000)                    # correct declared sizes
    with open(tagged, "ab") as f:
        junk = b"\x7f\x01" * 4000
        f.write(b"LIST" + struct.pack("<I", len(junk) + 4) + b"INFO" + junk)
    want = jax_seg.segment_signal(sig)
    assert follow_wav(tagged, port_seg, idle_timeout=1.0, poll=0.05) == want
    sub = struct.pack("<H", 1) + b"\x00" * 14        # SubFormat GUID: PCM
    ext_fmt = (struct.pack("<HHIIHH", 0xFFFE, 1, 16000, 32000, 2, 16)
               + struct.pack("<HHI", 22, 16, 1) + sub)
    ext = tmp_path / "ext.wav"
    ext.write_bytes(_header(fmt=ext_fmt) + sig.astype("<i2").tobytes())
    assert follow_wav(str(ext), port_seg, idle_timeout=0.5,
                      poll=0.05) == want


def test_follow_backlog_reads_are_bounded(port_seg, jax_seg, tmp_path):
    """Attaching to an already-long file drains the backlog in reads of
    at most one feature group, not one whole-file blob."""
    sig = _mix(4.2, seed=64)
    path = tmp_path / "backlog.wav"
    path.write_bytes(_header() + sig.astype("<i2").tobytes())
    fed = []
    got = follow_wav(str(path), port_seg, idle_timeout=0.5, poll=0.05,
                     on_update=lambda o: fed.append(o._total))
    steps = np.diff([0] + fed)
    assert (steps <= (3 * CHUNK + 2) * HOP).all() and len(fed) >= 2
    assert got == jax_seg.segment_signal(sig)


def test_follow_no_audio_and_wrong_format(port_seg, tmp_path):
    with pytest.raises(TimeoutError, match="never appeared"):
        follow_wav(str(tmp_path / "ghost.wav"), port_seg, idle_timeout=0.5,
                   poll=0.05)
    header_only = tmp_path / "headeronly.wav"
    header_only.write_bytes(_header())
    with pytest.raises(TimeoutError, match="no data payload"):
        follow_wav(str(header_only), port_seg, idle_timeout=0.5, poll=0.05)
    stereo = struct.pack("<HHIIHH", 1, 2, 44100, 176400, 4, 16)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(_header(0, stereo) + b"\x00" * 64)
    with pytest.raises(WavFormatError, match="PCM16 mono 16 kHz"):
        follow_wav(str(bad), port_seg, idle_timeout=1.0, poll=0.05)


def test_cli_segment_follow(port_seg, jax_seg, synthetic_model_dir, tmp_path,
                            capsys):
    from inaspeechsegmenter_tpu.export import seg2csv as jax_seg2csv
    from inaspeechsegmenter_tpu_torch.cli import segment

    sig = _mix(0.5, seed=65)                         # 20 s
    path = str(tmp_path / "live.wav")
    out = tmp_path / "out"
    out.mkdir()
    # the recording need not exist when the CLI starts
    th = _growing_wav(path, sig, piece=16000 * 10, delay=0.1)
    segment.main(["-i", path, "-o", str(out), "-b", "none", "--device",
                  "cpu", "--follow", "--follow_idle", "2"])
    th.join(timeout=10)
    assert "finalized" in capsys.readouterr().out
    want = tmp_path / "want.csv"
    jax_seg2csv(jax_seg.segment_signal(sig), str(want))
    assert (out / "live.csv").read_bytes() == want.read_bytes()
    with pytest.raises(SystemExit):
        segment.main(["-i", path, path, "-o", str(out), "--follow"])


# -- OnlineVFS ------------------------------------------------------------------

@pytest.fixture
def jax_reference_path(monkeypatch):
    monkeypatch.setenv("ISS_VFS_OVERLAP", "0")
    monkeypatch.setenv("ISS_VBX_UPLOAD", "f32")


@pytest.fixture(scope="module")
def xparams():
    from inaspeechsegmenter_tpu.models.resnet import ResNetXVector as JaxRes

    return JaxRes(*TINY).init_params(seed=7)


@pytest.fixture(scope="module")
def port_vfs(synthetic_model_dir, xparams):
    return VoiceFemininityScoring(
        "vfp", ffmpeg=None, device="cpu", model_dir=synthetic_model_dir,
        xvector_net=ResNetXVector(*TINY), xvector_params=xparams)


@pytest.fixture(scope="module")
def jax_vfs(synthetic_model_dir, xparams):
    from inaspeechsegmenter_tpu import vfs as jvfs
    from inaspeechsegmenter_tpu.models.resnet import ResNetXVector as JaxRes

    return jvfs.VoiceFemininityScoring(
        "vfp", allow_download=False, ffmpeg=None,
        xvector_net=JaxRes(*TINY), xvector_params=xparams)


def test_online_vfs_matches_jax(port_vfs, jax_vfs, jax_reference_path):
    from inaspeechsegmenter_tpu import OnlineVFS as JaxOnlineVFS

    sig = voiced(95.0, seed=5, silences=[(12.0, 13.0), (60.0, 61.5)])
    port, jx = OnlineVFS(port_vfs, "live"), JaxOnlineVFS(jax_vfs, "live")
    provisional = []
    for pos in range(0, len(sig), 16000 * 20):
        port.feed(sig[pos:pos + 16000 * 20])
        jx.feed(sig[pos:pos + 16000 * 20])
        got = port.current()
        assert got == jx.current()
        provisional.append(got)
    assert any(p[2] > 0 for p in provisional)    # windows were embedded
    got = port.finalize()
    assert got == jx.finalize() == port_vfs.score_signal(sig, "live")
    assert got[0] is not None and got[2] > 0
    with pytest.raises(RuntimeError, match="finalize"):
        port.feed(sig[:100])
    assert OnlineVFS(port_vfs).finalize() == (None, 0.0, 0)


def test_online_vfs_int16_stream_matches_jax(port_vfs, jax_vfs,
                                             monkeypatch):
    """The int16 grid on both sides: features from the online stream,
    cached embeddings reused by ``finalize()``."""
    from inaspeechsegmenter_tpu import OnlineVFS as JaxOnlineVFS

    monkeypatch.setenv("ISS_VFS_OVERLAP", "0")
    int16_grid_on_cpu(monkeypatch)
    sig = to_int16(voiced(95.0, seed=5, silences=[(12.0, 13.0),
                                                  (60.0, 61.5)]))
    port, jx = OnlineVFS(port_vfs, "live"), JaxOnlineVFS(jax_vfs, "live")
    bounds = [0, 100, 450] + list(range(16000 * 15, len(sig), 16000 * 15))
    provisional = []
    for a, b in zip(bounds, bounds[1:] + [len(sig)]):
        port.feed(sig[a:b])
        jx.feed(sig[a:b])
        assert port._use_stream and jx._use_stream
        # the raw PCM is dropped once 400 samples have arrived
        assert port.buffered_samples == (b if a < 400 else 0)
        assert len(port._parts) == len(jx._parts)
        got = port.current()
        assert got == jx.current()
        provisional.append(got)
    assert port._stream.frames_ready == 8192
    assert any(p[2] > 0 for p in provisional)    # windows were embedded
    n_cached = len(port._emb)
    got = port.finalize()
    assert got == jx.finalize() == port_vfs.score_signal(sig, "live")
    assert got[0] is not None and got[2] > n_cached > 0


def test_cli_vfs_follow(port_vfs, synthetic_model_dir, xparams, tmp_path,
                        monkeypatch, capsys):
    from inaspeechsegmenter_tpu_torch.cli import vfs as cli

    monkeypatch.setattr(tvfs, "VoiceFemininityScoring", functools.partial(
        tvfs.VoiceFemininityScoring, model_dir=synthetic_model_dir,
        xvector_net=ResNetXVector(*TINY), xvector_params=xparams))
    sig = to_int16(voiced(20.0, seed=2, silences=[(4.0, 4.7)]))
    path = str(tmp_path / "live.wav")
    out = tmp_path / "out"
    out.mkdir()
    th = _growing_wav(path, sig, piece=16000 * 10, delay=0.1)
    got = cli.main(["-i", path, "-o", str(out), "-c", "vfp", "-b", "none",
                    "--device", "cpu", "--follow", "--follow_idle", "2"])
    th.join(timeout=10)
    assert "finalized" in capsys.readouterr().out
    assert got == port_vfs.score_signal(sig, "live") and got[2] > 0
    want = tmp_path / "want.csv"
    tvfs.score_to_csv(got, str(want))
    assert (out / "live.csv").read_bytes() == want.read_bytes()
    for extra in (["--skipifexist"], [path]):
        with pytest.raises(SystemExit):
            cli.main(["-i", path, "-o", str(out), "--follow", *extra])


def test_online_classes_are_exported():
    import inaspeechsegmenter_tpu_torch as port

    from inaspeechsegmenter_tpu_torch import online

    assert {"OnlineSegmenter", "OnlineVFS"} <= set(port.__all__)
    assert port.OnlineSegmenter is online.OnlineSegmenter
    assert port.OnlineVFS is online.OnlineVFS
