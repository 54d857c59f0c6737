"""PyTorch port: the lossless PCM16 upload codec against the JAX package.

- Encoders: the port's ``pack_zero_elide``, ``pack_bits`` (numpy, and the
  native encoder of the port's own ``native/issaudio.cc`` build) and
  ``pack_best`` give the JAX package's buffers byte for byte, and decline
  where it declines, on every content class of ``tests/test_codec.py``.
- Decoders: the port's plain ``unpack_bits`` / ``unpack_zero_elide`` (what
  a CPU tensor runs) equal the JAX decoders (jnp on the CPU) and the
  source signal exactly, on the same cases and a seeded fuzz; a numpy
  model of the CUDA kernels' algorithm (``csrc/codec.cu``: the per-tile
  width ranks, the lane-chunked scans in wrapping 32-bit arithmetic) is
  held to the plain version exactly.
- ``group_shipped_bytes`` equals the JAX package's at ``ISS_UPLOAD_CHUNKS``
  1, 3 and 5, and equals the bytes the port's upload path ships.
- End to end on the CPU with ``ISS_UPLOAD_CODEC=1``: segmentation, VFS
  tuples (int16 grid, from the VAD's upload and from the VBx frontend's
  own) and the online finalize equal the codec-off port and the JAX
  package with its codec forced.

Every comparison is exact: the codec is lossless.
"""

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu.dsp import codec as jcodec
from inaspeechsegmenter_tpu_torch.dsp import codec, fe_kernel
from inaspeechsegmenter_tpu_torch.dsp.codec import BLOCK, PAGE
from torch_parity_helpers import (bin_edges, content_mix, elide_signal,
                                  every_width_and_order, fuzz_signal,
                                  int16_grid_on_cpu, mixed_signal,
                                  odd_widths, speechlike, to_int16,
                                  white_noise)

SR = 16000


CASES = {
    "mixed": content_mix,
    "bin_edges": bin_edges,
    "odd_widths": odd_widths,
    "white_noise": white_noise,
    "all_zero": lambda: np.zeros(3 * PAGE * BLOCK, np.int16),
    "zero_heavy": lambda: mixed_signal(4 * PAGE + 3, 0.9),
    "sub_page_zeros": lambda: np.concatenate(
        [np.zeros((PAGE // 2) * BLOCK, np.int16),
         elide_signal(3 * PAGE // 2, 0, seed=4)]),
    "elide": lambda: elide_signal(2049, 200, seed=5),
    "unaligned_slice": lambda: mixed_signal(8 * PAGE, 0.5, seed=2)[
        4 * BLOCK:4 * BLOCK + 4 * PAGE * BLOCK],
    "speechlike": lambda: to_int16(speechlike(8.0, seed=3,
                                              silences=[(2.0, 3.5)])),
}


def _sig(case):
    sig = np.ascontiguousarray(CASES[case]())
    return sig[:len(sig) // BLOCK * BLOCK]


# -- encoders -----------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_encoders_byte_equal_to_jax(case):
    sig = _sig(case)
    for mine, theirs in (
            (codec.pack_zero_elide(sig), jcodec.pack_zero_elide(sig)),
            (codec.pack_bits(sig, allow_native=False),
             jcodec.pack_bits(sig, allow_native=False)),
            (codec.pack_bits(sig, min_save=-1.0, allow_native=False),
             jcodec.pack_bits(sig, min_save=-1.0, allow_native=False))):
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert mine.dtype == theirs.dtype
            np.testing.assert_array_equal(mine, theirs)
    a, b = codec.pack_best(sig), jcodec.pack_best(sig)
    assert (a is None) == (b is None)
    if a is not None:
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])


@pytest.fixture(scope="module")
def native_build_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("native"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_encoder_byte_equal(case, native_build_dir, monkeypatch):
    """The port's native build (``native/issaudio.cc``, built with the host
    compiler) packs byte-identically to the numpy encoder, declines
    included."""
    from inaspeechsegmenter_tpu_torch.audio import native

    if native.find_cxx() is None:
        pytest.skip("no C++ compiler to build the native library")
    monkeypatch.setenv("ISS_TORCH_BUILD_DIR", native_build_dir)
    monkeypatch.delenv("ISS_AUDIO_LIB", raising=False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_PACK_OK", False)
    sig = _sig(case)
    for ms in (0.05, -1.0):
        nat = native.pack_bits(sig, ms)
        assert nat is not None, "the native encoder did not load"
        ref = codec.pack_bits(sig, min_save=ms, allow_native=False)
        if ref is None:
            assert len(nat) == 0
        else:
            np.testing.assert_array_equal(nat, ref)
            np.testing.assert_array_equal(codec.pack_bits(sig, ms), ref)


def test_native_pack_version_gate():
    """A pre-0.3 library (codec format v1) is refused, so the numpy v2
    encoder runs instead (the JAX loader's gate)."""
    from inaspeechsegmenter_tpu_torch.audio.native import _pack_format_ok

    class FakeLib:
        def __init__(self, ver):
            self.iss_version = lambda: ver

    assert not _pack_format_ok(FakeLib(b"issaudio-0.2.0"))
    assert _pack_format_ok(FakeLib(b"issaudio-0.3.0"))
    assert _pack_format_ok(FakeLib(b"issaudio-1.0.0"))
    assert not _pack_format_ok(FakeLib(b"garbage"))
    assert not _pack_format_ok(object())


def test_pack_best_prefers_bits_then_elide(monkeypatch):
    tone = (np.sin(2 * np.pi * 300 * np.arange(SR * 20) / SR)
            * 5000).astype(np.int16)
    assert codec.pack_best(tone)[0] == "bits"
    assert codec.pack_best(_sig("elide"))[0] == "elide"
    assert codec.pack_best(_sig("white_noise")) is None
    monkeypatch.setenv("ISS_UPLOAD_PACK", "0")
    assert codec.pack_best(_sig("zero_heavy"))[0] == "elide"
    assert codec.pack_best(tone) is None


@pytest.mark.parametrize("bad", [np.zeros(BLOCK, np.int32),
                                 np.zeros(BLOCK + 1, np.int16),
                                 np.zeros((2, BLOCK), np.int16)])
def test_encoders_reject_bad_input(bad):
    for enc in (codec.pack_zero_elide, codec.pack_bits):
        with pytest.raises(ValueError):
            enc(bad)


# -- decoders -----------------------------------------------------------------

def _jax_decode(kind, buf, nb):
    import jax.numpy as jnp

    fn = jcodec.unpack_bits if kind == "bits" else jcodec.unpack_zero_elide
    return np.asarray(fn(jnp.asarray(buf), nb))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_decoders_exact(case):
    sig = _sig(case)
    nb = len(sig) // BLOCK
    packed = [("bits", codec.pack_bits(sig, min_save=-1.0,
                                       allow_native=False)),
              ("elide", codec.pack_zero_elide(sig))]
    for kind, buf in packed:
        if buf is None:
            continue
        fn = codec.unpack_bits if kind == "bits" else codec.unpack_zero_elide
        out = fn(torch.from_numpy(buf), nb).numpy()
        np.testing.assert_array_equal(out, sig)
        np.testing.assert_array_equal(out, _jax_decode(kind, buf, nb))
    assert codec.unpack_bits.launches == codec.unpack_zero_elide.launches == 0


@pytest.mark.parametrize("trial", range(20))
def test_plain_bits_decoder_fuzz(trial):
    sig = fuzz_signal(100 + trial)
    buf = codec.pack_bits(sig, min_save=-1.0, allow_native=False)
    out = codec.unpack_bits(torch.from_numpy(buf), len(sig) // BLOCK)
    np.testing.assert_array_equal(out.numpy(), sig)


def _model_ranks(w):
    """The CUDA rank pass (bits_rank_kernel): tiles of 1024 blocks, a
    block's rank within its warp among the blocks of its width, the
    per-width exclusive scan over the tile's 32 warps, a carry a width."""
    nb = len(w)
    rank = np.zeros(nb, np.int64)
    carry = np.zeros(17, np.int64)
    for base in range(0, nb, 1024):
        tile = w[base:base + 1024]
        warp_cnt = np.zeros((32, 17), np.int64)
        in_warp = np.zeros(len(tile), np.int64)
        for i, wi in enumerate(tile):
            lo = i - i % 32
            group = tile[lo:lo + 32]
            in_warp[i] = int((group[:i - lo] == wi).sum())
            if in_warp[i] == 0:
                warp_cnt[i // 32, wi] = int((group == wi).sum())
        off = np.cumsum(warp_cnt, 0) - warp_cnt + carry
        carry += warp_cnt.sum(0)
        rank[base:base + len(tile)] = off[np.arange(len(tile)) // 32,
                                          tile] + in_warp
    return rank, carry


def _model_unpack_bits(buf, nb):
    """The CUDA decode (bits_decode_kernel) in numpy: offsets from the
    ranks and the per-width totals, the block's bytes staged with zeros
    past 40*w, ten slots a lane, scans of the lane sums, all in wrapping
    32-bit unsigned arithmetic; the low 16 bits stored."""
    hp = len(buf) - 5 * nb
    meta = buf[hp + 4 * nb:].astype(np.int64)
    w = meta & 0x1F
    w[w > 16] = 0
    rank, totals = _model_ranks(w)
    sub = (40 * np.arange(17) + 31) // 32
    size = totals * sub
    size[0] = 0
    base = np.cumsum(size) - size
    out = np.zeros((nb, BLOCK), np.uint32)
    u32 = np.uint32
    for b in range(nb):
        wb, order = int(w[b]), int(meta[b] >> 5)
        h = buf[hp + 4 * b:hp + 4 * b + 4].astype(np.int64)
        x0 = u32(((h[0] | h[1] << 8) ^ 0x8000) - 0x8000 & 0xFFFFFFFF)
        x1 = u32(((h[2] | h[3] << 8) ^ 0x8000) - 0x8000 & 0xFFFFFFFF)
        dx = u32((int(x1) - int(x0)) & 0xFFFFFFFF)
        off = int(base[wb] + rank[b] * sub[wb]) * 32
        span = np.zeros(40 * 16 + 8, np.uint32)
        take = max(0, min(40 * wb, hp - off))
        span[:take] = buf[off:off + take]
        slot = np.arange(BLOCK)
        bit = slot * wb
        by = bit >> 3
        v = span[by] | (span[by + 1] << u32(8)) | (span[by + 2] << u32(16))
        z = (v >> (bit & 7).astype(np.uint32)) & u32((1 << wb) - 1)
        r = np.where(slot < 318, (z >> u32(1)) ^ (u32(0) - (z & u32(1))),
                     u32(0)).astype(np.uint32)
        lanes = r.reshape(32, 10)
        excl = np.cumsum(lanes.sum(1, dtype=np.uint32), dtype=np.uint32) \
            - lanes.sum(1, dtype=np.uint32)
        c1 = (excl[:, None] + np.cumsum(lanes, 1, dtype=np.uint32)).reshape(-1)
        if order == 0:
            body = r
        elif order == 1:
            body = x1 + c1
        else:
            d = (dx + c1).reshape(32, 10)
            excl2 = np.cumsum(d.sum(1, dtype=np.uint32), dtype=np.uint32) \
                - d.sum(1, dtype=np.uint32)
            body = x1 + (excl2[:, None] + np.cumsum(d, 1, dtype=np.uint32)
                         ).reshape(-1)
        out[b, 0], out[b, 1] = x0, x1
        out[b, 2:] = body[:318]
    return (out & u32(0xFFFF)).astype(np.uint16).view(np.int16).reshape(-1)


@pytest.mark.parametrize("case", ["mixed", "bin_edges", "odd_widths",
                                  "speechlike", "all_zero"])
def test_kernel_model_matches_plain(case):
    """The CUDA algorithm, modelled in numpy, equals the plain decoder on
    more than one tile of 1024 blocks, every width and every order."""
    sig = _sig(case)
    nb = len(sig) // BLOCK
    buf = codec.pack_bits(sig, min_save=-1.0, allow_native=False)
    np.testing.assert_array_equal(_model_unpack_bits(buf, nb), sig)


def test_kernel_model_ranks_match_width_cumsum():
    rng = np.random.default_rng(8)
    w = rng.integers(0, 17, 3000)
    w[1000:1200] = 5                    # runs across warps and tiles
    rank, totals = _model_ranks(w)
    onehot = np.eye(17, dtype=np.int64)[w]
    want = (np.cumsum(onehot, 0) - onehot)[np.arange(len(w)), w]
    np.testing.assert_array_equal(rank, want)
    np.testing.assert_array_equal(totals, onehot.sum(0))


def test_every_width_and_order_once():
    """One block at each width 0..16 and each order 0..2, plus the
    decoder's result written into a slice of a larger buffer."""
    sig = every_width_and_order()
    nb = len(sig) // BLOCK
    buf = codec.pack_bits(sig, min_save=-1.0, allow_native=False)
    meta = buf[-nb:]
    assert set(meta & 0x1F) >= set(range(0, 17, 4))
    assert set(meta >> 5) == {0, 1, 2}
    big = torch.full((nb * BLOCK + 2 * BLOCK,), 7, dtype=torch.int16)
    view = big[BLOCK:BLOCK + nb * BLOCK]
    assert codec.unpack_bits(torch.from_numpy(buf), nb, out=view) is view
    np.testing.assert_array_equal(view.numpy(), sig)
    assert (big[:BLOCK] == 7).all() and (big[-BLOCK:] == 7).all()
    np.testing.assert_array_equal(_model_unpack_bits(buf, nb), sig)


def test_decoders_reject_bad_input():
    sig = _sig("zero_heavy")
    nb = len(sig) // BLOCK
    bits = torch.from_numpy(codec.pack_bits(sig, allow_native=False))
    elide = torch.from_numpy(codec.pack_zero_elide(sig))
    for fn, buf in ((codec.unpack_bits, bits),
                    (codec.unpack_zero_elide, elide)):
        with pytest.raises(ValueError, match="1-D"):
            fn(buf.to(torch.int32), nb)
        with pytest.raises(ValueError, match="hold"):
            fn(buf, nb + 1)
        with pytest.raises(ValueError, match="hold"):
            fn(buf[:-1], nb)
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.stack([buf, buf], 1).reshape(-1)[::2], nb)
        with pytest.raises(ValueError, match="out"):
            fn(buf, nb, out=torch.empty(nb * BLOCK - 1, dtype=torch.int16))


def test_ship_routes(monkeypatch):
    """``ship`` decodes what ``pack_best`` chose, raw when it declines,
    into ``out`` when given."""
    for case, kind in (("mixed", "bits"), ("elide", "elide"),
                       ("white_noise", None)):
        sig = _sig(case)
        p = codec.pack_best(sig)
        assert (p[0] if p else None) == kind
        np.testing.assert_array_equal(codec.ship(sig, "cpu").numpy(), sig)
        out = torch.empty(len(sig), dtype=torch.int16)
        assert codec.ship(sig, "cpu", out=out) is out
        np.testing.assert_array_equal(out.numpy(), sig)


# -- shipped bytes ------------------------------------------------------------

@pytest.mark.parametrize("chunks", ["1", "3", "5"])
def test_group_shipped_bytes_matches_jax(chunks, monkeypatch):
    from inaspeechsegmenter_tpu.dsp.sidekit import group_shipped_bytes

    monkeypatch.setenv("ISS_UPLOAD_CODEC", "1")
    monkeypatch.setenv("ISS_UPLOAD_CHUNKS", chunks)
    rng = np.random.default_rng(6)
    sig = to_int16(speechlike(200.0, seed=6, silences=[(30.0, 70.0)]))
    sig[SR * 100:SR * 104] = rng.integers(-32768, 32768, SR * 4)
    for s in (sig, sig[:SR * 50], sig[:300]):
        got = fe_kernel.group_shipped_bytes(s)
        assert got == group_shipped_bytes(s)
        assert got[0] < got[1]
    monkeypatch.setenv("ISS_UPLOAD_CODEC", "0")
    shipped, raw = fe_kernel.group_shipped_bytes(sig)
    assert shipped == raw


def test_upload_switches(monkeypatch):
    """``ISS_UPLOAD_CODEC``: ``auto`` (the default) takes the raw upload,
    the port's measured rule on the card; ``1`` forces the codec."""
    monkeypatch.delenv("ISS_UPLOAD_CODEC", raising=False)
    assert not fe_kernel.upload_codec_enabled()
    for mode, want in (("auto", False), ("1", True), ("on", True),
                       ("0", False), ("off", False)):
        monkeypatch.setenv("ISS_UPLOAD_CODEC", mode)
        assert fe_kernel.upload_codec_enabled() is want
    monkeypatch.delenv("ISS_UPLOAD_CHUNKS", raising=False)
    assert fe_kernel.upload_chunks() == 3
    monkeypatch.setenv("ISS_UPLOAD_CHUNKS", "0")
    assert fe_kernel.upload_chunks() == 1
    monkeypatch.setenv("ISS_UPLOAD_CHUNKS", "5")
    assert fe_kernel.upload_chunks() == 5


def _spy_pack_best(monkeypatch, kinds=None):
    """Record the bytes of every ``pack_best`` decision of the port's
    upload path (and its route in ``kinds``)."""
    shipped = []
    real = codec.pack_best

    def spy(raw):
        p = real(raw)
        shipped.append(2 * len(raw) if p is None else p[1].nbytes)
        if kinds is not None:
            kinds.append(p[0] if p else None)
        return p

    monkeypatch.setattr(codec, "pack_best", spy)
    return shipped


@pytest.mark.parametrize("chunks", ["1", "3"])
def test_frontend_features_identical_with_codec(chunks, monkeypatch):
    """Codec on against off: the same features bit for bit on the whole-file
    path (the decoded groups overlap by one block) and the group path, the
    kept PCM equal to the signal, and the bytes shipped equal to
    ``group_shipped_bytes``."""
    monkeypatch.setenv("ISS_UPLOAD_CHUNKS", chunks)
    sig = to_int16(speechlike(90.0, seed=7, silences=[(10.0, 25.0)]))
    sig = np.r_[sig, np.int16(5) * np.ones(37, np.int16)]   # ragged tail
    fe = fe_kernel.KernelSidekitFrontend("cpu")
    monkeypatch.setenv("ISS_UPLOAD_CODEC", "0")
    m0, l0, t0, p0 = fe.mspec_loge(sig, keep_pcm=True)
    g0 = [c for cg, _ in fe.iter_group_feats(sig) for c in cg]
    monkeypatch.setenv("ISS_UPLOAD_CODEC", "1")
    want = fe_kernel.group_shipped_bytes(sig)[0]
    shipped = _spy_pack_best(monkeypatch)
    m1, l1, t1 = fe.mspec_loge(sig)
    assert sum(shipped) == want
    assert len(shipped) == -(-3 // int(chunks))     # 3 chunks
    _, _, _, p1 = fe.mspec_loge(sig, keep_pcm=True)
    g1 = [c for cg, _ in fe.iter_group_feats(sig) for c in cg]
    assert t0 == t1
    assert torch.equal(m0, m1) and torch.equal(l0, l1)
    np.testing.assert_array_equal(p1.numpy(), sig)
    np.testing.assert_array_equal(p0.numpy(), sig)
    for (a, b), (c, d) in zip(g0, g1):
        assert torch.equal(a, c) and torch.equal(b, d)


def test_float_input_skips_codec(monkeypatch):
    monkeypatch.setenv("ISS_UPLOAD_CODEC", "1")
    shipped = _spy_pack_best(monkeypatch)
    m, _, t = fe_kernel.KernelSidekitFrontend("cpu").mspec_loge(
        np.zeros(SR * 3, np.float32))
    assert t == (SR * 3 - 400) // 160 + 1 and not shipped


# -- end to end ---------------------------------------------------------------

@pytest.fixture(scope="module")
def port_seg(synthetic_model_dir):
    from inaspeechsegmenter_tpu_torch import Segmenter

    return Segmenter("smn", True, ffmpeg=None, device="cpu",
                     model_dir=synthetic_model_dir)


@pytest.fixture(scope="module")
def jax_seg(synthetic_model_dir):
    from inaspeechsegmenter_tpu import Segmenter as JaxSegmenter

    return JaxSegmenter(vad_engine="smn", detect_gender=True, ffmpeg=None,
                        allow_download=False)


def test_segmenter_with_codec_matches_off_and_jax(port_seg, jax_seg,
                                                  monkeypatch):
    """Two chunks of a speech-like mix (the bits route) and exactly one
    chunk of full-scale noise with 200 silent blocks (the elide route)."""
    sig = to_int16(speechlike(45.0, seed=31, silences=[(5.0, 6.0),
                                                       (20.0, 24.0)]))
    noise = elide_signal(2049, 200, seed=32)     # (CHUNK + 2) * HOP
    real = codec.pack_best
    for s, kind in ((sig, "bits"), (noise, "elide")):
        monkeypatch.setenv("ISS_UPLOAD_CODEC", "0")
        off = port_seg.segment_signal(s)
        monkeypatch.setenv("ISS_UPLOAD_CODEC", "1")
        kinds = []
        _spy_pack_best(monkeypatch, kinds)
        on = port_seg.segment_signal(s)
        monkeypatch.setattr(codec, "pack_best", real)
        assert kinds == [kind]
        assert on == off
        assert on == jax_seg.segment_signal(s)


def test_online_finalize_with_codec(port_seg, jax_seg, monkeypatch):
    from inaspeechsegmenter_tpu_torch import OnlineSegmenter

    monkeypatch.setenv("ISS_UPLOAD_CODEC", "1")
    monkeypatch.setenv("ISS_UPLOAD_CHUNKS", "1")
    sig = to_int16(speechlike(95.0, seed=33, silences=[(40.0, 44.0)]))
    online = OnlineSegmenter(port_seg)
    assert online._group == 1
    shipped = _spy_pack_best(monkeypatch)
    for pos in range(0, len(sig), SR * 7):
        online.feed(sig[pos:pos + SR * 7])
    got = online.finalize()
    assert len(shipped) == 3            # one decision a one-chunk group
    monkeypatch.setenv("ISS_UPLOAD_CODEC", "0")
    assert got == port_seg.segment_signal(sig)
    monkeypatch.setenv("ISS_UPLOAD_CODEC", "1")
    assert got == jax_seg.segment_signal(sig)


TINY = ("bottleneck", (1, 1, 1, 1), 8, 64, 256)


def test_vfs_with_codec_matches_off_and_jax(synthetic_model_dir, monkeypatch):
    """The int16 VBx grid on both packages (the JAX serial path): with the
    codec on, the port's features come from the VAD's decoded upload (the
    tuple equals the codec-off port's and the JAX package's), and under
    the host frontend from the VBx frontend's own packed upload (the
    tuple equals the JAX package's under its host frontend)."""
    from inaspeechsegmenter_tpu import vfs as jvfs
    from inaspeechsegmenter_tpu.dsp.host_fe import (
        HostSidekitFrontend as JaxHost)
    from inaspeechsegmenter_tpu.models.resnet import ResNetXVector as JaxNet
    from inaspeechsegmenter_tpu_torch import VoiceFemininityScoring
    from inaspeechsegmenter_tpu_torch.dsp import host_fe
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
    from torch_parity_helpers import voiced

    int16_grid_on_cpu(monkeypatch)
    monkeypatch.setenv("ISS_VFS_OVERLAP", "0")
    params = JaxNet(*TINY).init_params(seed=7)
    port = VoiceFemininityScoring(
        "vfp", ffmpeg=None, device="cpu", model_dir=synthetic_model_dir,
        xvector_net=ResNetXVector(*TINY), xvector_params=params)
    jx = jvfs.VoiceFemininityScoring(
        "vfp", allow_download=False, ffmpeg=None,
        xvector_net=JaxNet(*TINY), xvector_params=params)
    sig = to_int16(voiced(20.0, seed=2, silences=[(4.0, 4.7),
                                                  (13.2, 13.5)]))
    monkeypatch.setenv("ISS_UPLOAD_CODEC", "0")
    off = port.score_signal(sig)
    monkeypatch.setenv("ISS_UPLOAD_CODEC", "1")
    assert port.score_signal(sig) == off
    assert off == jx.score_signal(sig)
    assert off[0] is not None and off[2] > 0
    kinds = []
    _spy_pack_best(monkeypatch, kinds)
    port.vad.frontend = host_fe.HostSidekitFrontend("cpu")
    jx.vad.frontend = JaxHost()
    host = port.score_signal(sig)
    assert kinds == ["bits"]            # the VBx frontend's own upload
    assert host == jx.score_signal(sig)
    assert host[0] is not None and host[2] > 0
