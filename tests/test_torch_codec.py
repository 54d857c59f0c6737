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
                                  int16_grid_on_cpu, kernel_constant,
                                  mixed_signal, odd_widths, speechlike,
                                  to_int16, white_noise)

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


# -- a numpy model of the CUDA decoders (csrc/codec.cu) -----------------------

THREADS = kernel_constant("codec.cu", "THREADS")   # a CTA, blocks a tile
SPAN_WORDS = kernel_constant("codec.cu", "SPAN_WORDS")
GRIDS = [1, 3, 132, 264]        # CTAs, past nb for the short cases
SUB = (40 * np.arange(17) + 31) // 32
U32 = np.uint32


def _model_ranges(nb, grid):
    """CTA c decodes [c*R, (c+1)*R) within nb, R = ceil(nb / grid); a CTA
    past nb has nothing to do."""
    per = -(-nb // grid)
    return [(min(nb, c * per), min(nb, c * per + per)) for c in range(grid)]


def _model_count_widths(meta, start, align):
    """count_widths in numpy: one pass of the CTA's threads over every
    meta byte (meta's address is ``align`` mod 16), bytes before
    ``start`` into one counter and the rest into another.  Each thread's
    units: a byte before the first 16-byte boundary or after the last, or
    half a 16-byte vector (a vector wholly on one side counts into that
    side's counter; the vector across ``start`` splits byte by byte and
    flushes both counters).  A counter keeps a nibble a width from 1 <<
    (4w - 4) in unsigned arithmetic (a shift of 32 or more gives 0:
    widths 0 and 17..31 count nowhere), flushed after each unit into byte
    fields, which drain every 31 flushes and at the end.  Asserts that no
    nibble reaches 16 and no byte field 256.  -> (before, after), each
    (17,) with [0] = 0 (the kernel infers width 0)."""
    seg = meta.astype(np.int64) & 0x1F
    n = len(seg)
    head = min(n, (16 - align % 16) % 16)
    nvec = (n - head) // 16 if n > head else 0
    tail0 = head + 16 * nvec
    s = (4 * np.arange(32) - 4) % 2 ** 32          # the shift of each w
    nibble = np.full(32, -1)                       # w -> nibble 0..15
    nibble[s < 32] = s[s < 32] // 4
    hi_s = (s - 32) % 2 ** 32
    nibble[hi_s < 32] = 8 + hi_s[hi_s < 32] // 4
    fields = np.zeros((2, THREADS, 16), np.int64)  # byte field of width k+1
    flushes = np.zeros((2, THREADS), np.int64)
    counts = np.zeros((2, 17), np.int64)
    t = np.arange(THREADS)

    def unit(at, size, active, flush_both):
        """A unit of ``size`` bytes at ``at`` (per thread), then flushes."""
        nib = np.zeros((2, THREADS, 16), np.int64)
        for k in range(size):
            ok = active & (at + k < n)
            idx = at[ok] + k
            side = (idx >= start).astype(np.int64)
            nb_ = nibble[seg[idx]]
            c = nb_ >= 0
            np.add.at(nib, (side[c], t[ok][c], nb_[c]), 1)
        assert nib.max() < 16
        first = at < start
        touched = [active & (flush_both | first),
                   active & (flush_both | ~first)]
        for side in (0, 1):
            act = touched[side]
            fields[side][act] += nib[side][act]
            assert fields.max() < 256
            flushes[side][act] += 1
            full = flushes[side] == 31
            counts[side, 1:] += fields[side][full].sum(0)
            fields[side][full] = 0
            flushes[side][full] = 0

    no = np.zeros(THREADS, bool)
    for r0 in range(0, head, THREADS):
        unit(r0 + t, 1, r0 + t < head, no)
    for r0 in range(0, nvec, THREADS):
        idx = r0 + t
        at = head + 16 * idx
        across = (at < start) & (at + 16 > start)
        for half in range(2):
            unit(at + 8 * half, 8, idx < nvec, across)
    for r0 in range(tail0, n, THREADS):
        unit(r0 + t, 1, r0 + t < n, no)
    counts[:, 1:] += fields.sum(1)
    return counts[0], counts[1]


def _model_rows(meta, grid, align):
    """Each block's first pool sub-row, as the CTAs of a grid compute it:
    the sweep's counts before the range and from it on, the width bases
    over the whole buffer, then per tile of THREADS blocks the in-warp
    ranks (the earlier lanes of the warp with the same width), the
    per-width exclusive scan over the warps, and the carry."""
    nb = len(meta)
    w = meta.astype(np.int64) & 0x1F
    w[w > 16] = 0
    rows = np.full(nb, -1, np.int64)
    for start, end in _model_ranges(nb, grid):
        if start >= end:
            continue
        before, after = _model_count_widths(meta, start, align)
        before[0] = start - before[1:].sum()
        after[0] = nb - start - after[1:].sum()
        size = (before + after) * SUB
        pos = np.cumsum(size) - size + before * SUB
        for t0 in range(start, end, THREADS):
            tw = w[t0:min(end, t0 + THREADS)]
            onehot = np.eye(17, dtype=np.int64)[tw]
            warp = np.arange(len(tw)) // 32
            in_warp = np.zeros(len(tw), np.int64)
            warp_cnt = np.zeros((warp[-1] + 1, 17), np.int64)
            for i in range(warp[-1] + 1):
                oh = onehot[warp == i]
                in_warp[warp == i] = (np.cumsum(oh, 0) - oh)[
                    np.arange(len(oh)), tw[warp == i]]
                warp_cnt[i] = oh.sum(0)
            warp_off = pos + (np.cumsum(warp_cnt, 0) - warp_cnt) * SUB
            rows[t0:t0 + len(tw)] = (warp_off[warp, tw]
                                     + in_warp * SUB[tw])
            pos = pos + warp_cnt.sum(0) * SUB
    return rows


def _model_unpack_bits(buf, nb, grid=132, align=0):
    """The bit decoder in numpy: the rows of ``_model_rows``; each block's
    16-byte pieces staged with zeros at and past the pool's end; slot s
    the bits [s*w, s*w + w) of the staged 32-bit little-endian words (a
    funnel shift of two words); un-zigzag, slots 318-319 zero; ten slots a
    lane, scans of the lane sums, all in wrapping 32-bit unsigned
    arithmetic; the low 16 bits stored."""
    hp = len(buf) - 5 * nb
    meta = buf[hp + 4 * nb:]
    w = meta.astype(np.int64) & 0x1F
    w[w > 16] = 0
    order = meta.astype(np.int64) >> 5
    off = 32 * _model_rows(meta, grid, (align + hp + 4 * nb) % 16)
    span = np.zeros((nb, SPAN_WORDS * 4), np.uint8)
    for b in range(nb):
        take = max(0, min(16 * -(-40 * int(w[b]) // 16), hp - off[b]))
        span[b, :take] = buf[off[b]:off[b] + take]
    words = span.view("<u4").astype(np.uint64)
    slot = np.arange(BLOCK)
    bit = slot[None, :] * w[:, None]
    wi = bit >> 5
    pair = (np.take_along_axis(words, wi + 1, 1) << np.uint64(32)) \
        | np.take_along_axis(words, wi, 1)
    z = ((pair >> (bit & 31).astype(np.uint64))
         & ((np.uint64(1) << w[:, None].astype(np.uint64)) - np.uint64(1))
         ).astype(U32)
    r = np.where(slot < 318, (z >> U32(1)) ^ (U32(0) - (z & U32(1))),
                 U32(0)).astype(U32)
    h = buf[hp:hp + 4 * nb].reshape(nb, 4).astype(np.int64)
    x0 = ((((h[:, 0] | h[:, 1] << 8) ^ 0x8000) - 0x8000)
          & 0xFFFFFFFF).astype(U32)[:, None]
    x1 = ((((h[:, 2] | h[:, 3] << 8) ^ 0x8000) - 0x8000)
          & 0xFFFFFFFF).astype(U32)[:, None]

    def lane_scan(v):                    # inclusive, 10 slots a lane
        lanes = v.reshape(nb, 32, 10)
        tot = lanes.sum(2, dtype=U32)
        excl = np.cumsum(tot, 1, dtype=U32) - tot
        return (excl[:, :, None] + np.cumsum(lanes, 2, dtype=U32)
                ).reshape(nb, BLOCK)

    c1 = lane_scan(r)
    o2 = x1 + lane_scan(((x1 - x0) + c1).astype(U32))
    body = np.where(order[:, None] == 0, r,
                    np.where(order[:, None] == 1, x1 + c1, o2))
    out = np.concatenate([x0, x1, body[:, :318]], 1).astype(U32)
    return (out & U32(0xFFFF)).astype(np.uint16).view(np.int16).reshape(-1)


def _model_unpack_zero_elide(buf, nb, grid=132):
    """The elision decoder in numpy: each CTA's carry is the sum of the
    mask values before its range (int64); per tile of THREADS blocks the
    rows are the carry plus the tile's inclusive sums, minus one, clamped
    to the pool; a block is its row times its mask value (int16,
    wrapping), zeros where the value is 0."""
    mask = buf[len(buf) - nb:].astype(np.int64)
    pool = buf[:len(buf) - nb].reshape(-1, BLOCK)
    out = np.full((nb, BLOCK), 7, np.int16)
    for start, end in _model_ranges(nb, grid):
        if start >= end:
            continue
        carry = int(mask[:start].sum())
        for t0 in range(start, end, THREADS):
            m = mask[t0:min(end, t0 + THREADS)]
            row = np.clip(carry + np.cumsum(m) - 1, 0, len(pool) - 1)
            prod = (pool[row].astype(np.int64) * m[:, None]).astype(np.int16)
            out[t0:t0 + len(m)] = np.where(m[:, None] == 0, 0, prod)
            carry += int(m.sum())
    return out.reshape(-1)


_JAX_CACHE = {}


def _jax_decode_cached(key, kind, buf, nb):
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = _jax_decode(kind, buf, nb)
    return _JAX_CACHE[key]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("case", ["mixed", "bin_edges", "odd_widths",
                                  "speechlike", "all_zero"])
def test_kernel_model_matches_plain(case, grid):
    """The CUDA bit decoder, modelled in numpy at a grid of ``grid`` CTAs,
    equals the source, the plain decoder and the JAX decoder on more than
    one tile of blocks, every width and every order."""
    sig = _sig(case)
    nb = len(sig) // BLOCK
    buf = codec.pack_bits(sig, min_save=-1.0, allow_native=False)
    got = _model_unpack_bits(buf, nb, grid)
    np.testing.assert_array_equal(got, sig)
    np.testing.assert_array_equal(
        got, codec.unpack_bits_plain(torch.from_numpy(buf), nb).numpy())
    np.testing.assert_array_equal(
        got, _jax_decode_cached(("bits", case), "bits", buf, nb))


@pytest.mark.parametrize("grid", GRIDS)
def test_kernel_model_ranks_match_width_cumsum(grid):
    """The CTAs' rows equal the width-grouped layout's (the plain
    decoder's offsets), at several alignments of the meta bytes, with
    order bits set and widths past 16 (which count as width 0)."""
    rng = np.random.default_rng(8)
    meta = rng.integers(0, 256, 3000).astype(np.uint8)
    meta[1000:1200] = 5 | (2 << 5)      # runs across warps and tiles
    w = torch.from_numpy(meta.astype(np.int64) & 0x1F)
    w = torch.where(w > 16, torch.zeros_like(w), w)
    want = codec._bits_offsets(w).numpy() // 32
    keep = w.numpy() > 0                # width 0 has no pool bytes
    for align in (0, 3, 8, 13):
        rows = _model_rows(meta, grid, align)
        np.testing.assert_array_equal(rows[keep], want[keep])


@pytest.mark.parametrize("n,align", [(0, 0), (1, 5), (15, 1), (17, 0),
                                     (4099, 7), (300_000, 3)])
def test_kernel_model_width_sweep(n, align):
    """The sweep's register counters equal histograms of the widths 1..16
    before and from ``start`` over every meta byte value, with ``start``
    on and off a vector boundary, the longest past the byte fields'
    drain."""
    meta = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    w = meta & 0x1F
    for start in sorted({0, min(n, 7), n // 2, n // 2 + 8, n}):
        got = _model_count_widths(meta, start, align)
        for part, g in zip((w[:start], w[start:]), got):
            want = np.bincount(part[(part >= 1) & (part <= 16)],
                               minlength=17)
            want[0] = 0
            np.testing.assert_array_equal(g, want)


def _elide_case(case):
    """An elision buffer -> (buf, nb, source or None): pack_zero_elide of
    a signal, or a seeded pool with a mask of each kind (2,051 blocks: no
    grid's range length divides it)."""
    if case == "packed":
        sig = _sig("elide")
        return codec.pack_zero_elide(sig), len(sig) // BLOCK, sig
    rng = np.random.default_rng(51)
    nb, n_rows = 2051, 5 * PAGE
    mask = {"all_zero": np.zeros(nb), "all_one": np.ones(nb),
            "alternating": np.arange(nb) % 2,
            "values": rng.integers(-1, 4, nb)}[case].astype(np.int16)
    pool = rng.integers(-32768, 32768, n_rows * BLOCK).astype(np.int16)
    return np.concatenate([pool, mask]), nb, None


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("case", ["packed", "all_zero", "all_one",
                                  "alternating", "values"])
def test_kernel_model_elide_matches_plain(case, grid):
    """The CUDA elision decoder, modelled at a grid of ``grid`` CTAs,
    equals the plain decoder and the JAX decoder (and the source where
    there is one): masks all zero, all one, alternating, general values
    (the carry sums values, the copy multiplies), rows past the pool."""
    buf, nb, sig = _elide_case(case)
    got = _model_unpack_zero_elide(buf, nb, grid)
    if sig is not None:
        np.testing.assert_array_equal(got, sig)
    np.testing.assert_array_equal(
        got, codec.unpack_zero_elide_plain(torch.from_numpy(buf), nb).numpy())
    np.testing.assert_array_equal(
        got, _jax_decode_cached(("elide", case), "elide", buf, nb))


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
