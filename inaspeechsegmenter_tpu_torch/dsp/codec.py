"""Lossless PCM16 upload codecs: the host encoders and the device decoders.

Port of ``inaspeechsegmenter_tpu/dsp/codec.py``.  The wire format is the
JAX package's, byte for byte (format v2): an int16 slice whose length is a
multiple of ``BLOCK`` samples ships either

* **bit-packed** (``pack_bits``): per 320-sample block the cheapest of
  three fixed predictors (order 0, 1 or 2), the first two samples
  verbatim, the 318 residuals zigzag-mapped and packed LSB-first at the
  smallest exact width 0..16, each block's bytes padded to whole 32-byte
  sub-rows; the sub-rows are grouped by width (ascending, block order
  within a width) into one uint8 pool padded to ``BYTE_PAGE`` bytes, then
  the heads (2 int16 LE a block) and the meta bytes (``order << 5 |
  width``) follow;
* or **zero-elided** (``pack_zero_elide``): the blocks that are not all
  zero, compacted into whole pages of ``PAGE`` blocks, then the int16
  0/1 mask of the blocks;
* or raw, when neither saves enough (``pack_best`` returns None).

The host encoders are numpy copies of the JAX package's (``pack_bits``
uses the native single-pass encoder of ``native/issaudio.cc`` when that
library loads, byte-identical).  The device decoders rebuild the exact
int16 signal:

* :func:`unpack_bits` and :func:`unpack_zero_elide` launch the hand CUDA
  kernels of ``csrc/codec.cu`` for a CUDA tensor (one launch and one
  count on their ``launches`` a call; nothing is allocated but the
  output) and run their plain PyTorch versions
  (:func:`unpack_bits_plain`, :func:`unpack_zero_elide_plain`,
  transcriptions of the JAX decoders) for a CPU tensor.  A CUDA tensor
  that the kernel cannot take raises; nothing falls back.
* :func:`ship` is the one upload of an int16 slice on the codec's route:
  ``pack_best`` on the host, one copy of the packed (or raw) buffer,
  the decode on the caller's current stream, optionally into a slice of
  a larger device buffer.

Whether an upload takes the codec is
``dsp.fe_kernel.upload_codec_enabled()`` (``ISS_UPLOAD_CODEC``, off by
default: on the H100 the host encode costs more than the link time it
saves, see ``dsp/fe_kernel.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import upload

BLOCK = 320   # samples a codec block (20 ms at 16 kHz; divides every
              # upload-group slice length (k*CHUNK+2)*HOP)
PAGE = 512    # blocks a zero-elision page
BYTE_PAGE = 128 * 1024   # bit-packing pool padding
SUB_ROW = 32             # bytes a pool sub-row
N_WIDTHS = 17            # exact widths 0..16


# --------------------------------------------------------------------------
# host encoders (numpy copies of the JAX package's)
# --------------------------------------------------------------------------

def pack_zero_elide(sig_i16: np.ndarray):
    """Pack an int16 slice for upload, eliding all-zero blocks.

    :param sig_i16: 1-D contiguous int16, length a multiple of ``BLOCK``.
    :return: one int16 buffer ``(n_pages*PAGE*BLOCK + nb,)`` — the
        compacted pool pages (zero-padded tail page) with the per-block 0/1
        mask appended — or None when elision would not save at least one
        full page over the raw upload.
    """
    if sig_i16.dtype != np.int16 or sig_i16.ndim != 1:
        raise ValueError("pack_zero_elide takes a 1-D int16 array")
    nb = sig_i16.shape[0] // BLOCK
    if nb * BLOCK != sig_i16.shape[0]:
        raise ValueError(f"length {sig_i16.shape[0]} is not a multiple of "
                         f"{BLOCK}")
    # zero-test through an int64 view: 4 samples a word, no abs() temporary
    mask = sig_i16.view(np.int64).reshape(nb, BLOCK // 4).any(axis=1)
    n_nz = int(np.count_nonzero(mask))
    n_pages = -(-n_nz // PAGE) if n_nz else 1
    raw_pages = -(-nb // PAGE)
    if n_pages >= raw_pages:          # nothing (or a rounding error) saved
        return None
    buf = np.zeros(n_pages * PAGE * BLOCK + nb, np.int16)
    pool = buf[:n_pages * PAGE * BLOCK].reshape(n_pages * PAGE, BLOCK)
    pool[:n_nz] = sig_i16.reshape(nb, BLOCK)[mask]
    buf[n_pages * PAGE * BLOCK:] = mask
    return buf


def _block_width(r):
    """Smallest sufficient bit width per block for int32 residual rows
    ``r`` (nb, m) under the zigzag map, from each block's min and max
    (zigzag(v) = 2v for v >= 0, -2v-1 for v < 0).  Widths above 16 mean
    "this predictor order is unusable"; order 0 always fits 16 bits."""
    zmax = np.maximum(2 * r.max(axis=1).astype(np.int64),
                      -2 * r.min(axis=1).astype(np.int64) - 1)
    # exact integer bit length: #{j in 0..15 : zmax >= 2^j}
    w = (zmax[:, None] >= (np.int64(1) << np.arange(16))).sum(axis=1)
    return np.where(zmax > 65535, 18, w.astype(np.int64))


def _sub_rows(w):
    """Pool sub-rows (32 bytes each) a block of width ``w`` occupies:
    320 slots * w bits / 8 = 40*w bytes, rounded up to whole sub-rows."""
    return (40 * w + 31) // 32


def pack_bits(sig_i16: np.ndarray, min_save: float = 0.05,
              allow_native: bool = True):
    """Pack an int16 slice with per-block predictive bit-packing.

    :param sig_i16: 1-D contiguous int16, length a multiple of ``BLOCK``.
    :param min_save: required fractional saving against the raw int16
        upload; below it the result is None.
    :param allow_native: False forces this numpy encoder; True takes the
        native encoder (``audio/native.py::pack_bits``) when its library
        loads and speaks format v2.
    :return: one uint8 buffer ``(n_pages*BYTE_PAGE + 5*nb,)`` or None.
    """
    if sig_i16.dtype != np.int16 or sig_i16.ndim != 1:
        raise ValueError("pack_bits takes a 1-D int16 array")
    nb = sig_i16.shape[0] // BLOCK
    if nb * BLOCK != sig_i16.shape[0]:
        raise ValueError(f"length {sig_i16.shape[0]} is not a multiple of "
                         f"{BLOCK}")
    if allow_native:
        from ..audio import native
        r = native.pack_bits(sig_i16, min_save)
        if r is not None:
            return r if len(r) else None
    x = sig_i16.reshape(nb, BLOCK).astype(np.int32)
    d1 = np.diff(x, axis=1)                  # (nb, 319) first differences
    r1 = d1[:, 1:]                           # order-1 residuals for n >= 2
    r2 = np.diff(d1, axis=1)                 # (nb, 318) order-2 residuals
    r0 = x[:, 2:]                            # order-0 "residuals"
    ws = np.stack([_block_width(r0), _block_width(r1), _block_width(r2)])
    order = ws.argmin(axis=0)                # ties -> lowest order
    w = ws[order, np.arange(nb)]             # (nb,) widths 0..16
    total = int(_sub_rows(w).sum()) * SUB_ROW
    n_pages = max(1, -(-total // BYTE_PAGE))
    raw_bytes = nb * BLOCK * 2
    if n_pages * BYTE_PAGE + 5 * nb >= raw_bytes * (1.0 - min_save):
        return None
    buf = np.zeros(n_pages * BYTE_PAGE + 5 * nb, np.uint8)
    pool = buf[:n_pages * BYTE_PAGE]
    hp = n_pages * BYTE_PAGE
    buf[hp:hp + 4 * nb] = x[:, :2].astype("<i2").view(np.uint8).reshape(-1)
    buf[hp + 4 * nb:] = ((order << 5) | w).astype(np.uint8)
    # residual selection and zigzag in one pass (318 -> 320 zero-padded
    # slots, so 8 samples always span whole bytes)
    rsel = np.where((order == 1)[:, None], r1,
                    np.where((order == 2)[:, None], r2, r0))
    z32 = np.zeros((nb, BLOCK), np.int32)
    z32[:, :318] = (rsel << 1) ^ (rsel >> 31)
    # the pool is grouped by width, ascending, block order within a width:
    # each group writes one contiguous slice, and the decoder recomputes
    # the offsets from the widths alone
    pos = 0
    for wv in range(1, 17):
        sel = np.nonzero(w == wv)[0]
        if not len(sel):
            continue
        z = z32[sel]
        rowb = SUB_ROW * _sub_rows(wv)
        by = np.zeros((len(sel), rowb), np.uint8)
        # little-endian bitstream at width wv: sample-major, LSB-first
        bits = ((z[:, :, None] >> np.arange(wv)) & 1).astype(np.uint8)
        by[:, :40 * wv] = np.packbits(
            bits.reshape(len(sel), BLOCK * wv), axis=1, bitorder="little")
        size = len(sel) * rowb
        pool[pos:pos + size] = by.reshape(-1)
        pos += size
    return buf


def _pack_bits_enabled() -> bool:
    """``ISS_UPLOAD_PACK``: predictive bit-packing on int16 uploads; on
    unless ``0`` / ``off`` (then elision only), as in the JAX package."""
    return os.environ.get("ISS_UPLOAD_PACK", "auto") not in ("0", "off")


def pack_best(sig_i16: np.ndarray):
    """Best lossless packing of an int16 upload slice.

    :return: ``("bits", uint8 buf)`` | ``("elide", int16 buf)`` | None
        (raw upload).
    """
    if _pack_bits_enabled():
        b = pack_bits(sig_i16)
        if b is not None:
            return ("bits", b)
    e = pack_zero_elide(sig_i16)
    if e is not None:
        return ("elide", e)
    return None


# --------------------------------------------------------------------------
# device decoders
# --------------------------------------------------------------------------

def _check_decode(buf, nb, dtype, pool_unit, what):
    """Validate a packed buffer -> the pool's length in elements."""
    if buf.dim() != 1 or buf.dtype != dtype:
        raise ValueError(f"{what}: buffer must be 1-D {dtype}, got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    if not buf.is_contiguous():
        raise ValueError(f"{what}: buffer must be contiguous")
    nb = int(nb)
    tail = 5 * nb if dtype == torch.uint8 else nb
    pool = buf.shape[0] - tail
    if nb <= 0 or pool <= 0 or pool % pool_unit:
        raise ValueError(f"{what}: a buffer of {buf.shape[0]} elements does "
                         f"not hold {nb} blocks (the pool must be whole "
                         f"pages of {pool_unit})")
    return pool


def _check_out(out, nb, device, what):
    if out is None:
        return torch.empty(nb * BLOCK, dtype=torch.int16, device=device)
    if (out.dtype != torch.int16 or out.dim() != 1
            or out.shape[0] != nb * BLOCK or not out.is_contiguous()
            or out.device != device):
        raise ValueError(f"{what}: out must be a contiguous int16 "
                         f"({nb * BLOCK},) tensor on {device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    return out


def unpack_zero_elide_plain(buf, nb):
    """Plain PyTorch inverse of :func:`pack_zero_elide` on the buffer's
    device (the JAX ``unpack_zero_elide``): a cumsum of the mask, a row
    gather of the pool, a multiply by the mask."""
    pool = buf[:buf.shape[0] - nb].reshape(-1, BLOCK)
    mask = buf[buf.shape[0] - nb:]
    idx = torch.cumsum(mask.to(torch.int32), 0) - 1
    rows = pool[idx.clamp(0, pool.shape[0] - 1)] * mask[:, None]
    return rows.reshape(-1)


def unpack_zero_elide(buf, nb, out=None):
    """Exact int16 signal ``(nb*BLOCK,)`` from a :func:`pack_zero_elide`
    buffer on the device.

    :param buf: the packed int16 buffer, 1-D and contiguous.
    :param nb: the slice's block count.
    :param out: optional contiguous int16 ``(nb*BLOCK,)`` tensor on the
        buffer's device to write (a slice of a larger buffer); returned.
    """
    pool = _check_decode(buf, nb, torch.int16, PAGE * BLOCK,
                         "unpack_zero_elide")
    nb = int(nb)
    out = _check_out(out, nb, buf.device, "unpack_zero_elide")
    if buf.device.type == "cpu":
        out.copy_(unpack_zero_elide_plain(buf, nb))
        return out
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    lib = cuda_build.library()
    with torch.cuda.device(buf.device):
        rc = lib.iss_unpack_zero_elide(
            buf.data_ptr(), pool // BLOCK, nb, out.data_ptr(), 0,
            torch.cuda.current_stream(buf.device).cuda_stream)
    cuda_build.check_launch("unpack_zero_elide", rc)
    cuda_build.count_launch(unpack_zero_elide)
    return out


unpack_zero_elide.launches = 0

_DECODE_CHUNK = 4096   # blocks a step of the plain bit decoder (memory)


def _bits_offsets(w):
    """Pool byte offset of each block under the width-grouped layout,
    from the widths alone (``w`` int64 (nb,), 0 for a block without
    pool bytes)."""
    onehot = torch.nn.functional.one_hot(w, N_WIDTHS)        # (nb, 17)
    within = (torch.cumsum(onehot, 0) - onehot).gather(1, w[:, None])[:, 0]
    sub = _sub_rows(torch.arange(N_WIDTHS, device=w.device))
    size = onehot.sum(0) * sub                               # width 0: 0
    base = torch.cumsum(size, 0) - size
    return (base[w] + within * sub[w]) * SUB_ROW


def unpack_bits_plain(buf, nb):
    """Plain PyTorch inverse of :func:`pack_bits` on the buffer's device
    (the JAX ``unpack_bits``): the pool offsets from the width meta, the
    LSB-first unpack at each block's width, un-zigzag, and the order-0/1/2
    predictor inversion by two cumsums, in int64 (the JAX program's int32
    wraps; the samples, its low 16 bits, are the same)."""
    hp = buf.shape[0] - 5 * nb
    hb = buf[hp:hp + 4 * nb].reshape(nb, 2, 2).to(torch.int64)
    heads = hb[..., 0] | (hb[..., 1] << 8)
    heads = (heads ^ 0x8000) - 0x8000                       # (nb, 2) signed
    meta = buf[hp + 4 * nb:].to(torch.int64)
    w = meta & 0x1F
    w = torch.where(w > 16, torch.zeros_like(w), w)   # the JAX program has
    order = meta >> 5                                 # no candidate past 16
    off = _bits_offsets(w)
    pool = buf[:hp].to(torch.int64)
    slot = torch.arange(BLOCK, device=buf.device)
    parts = []
    for b0 in range(0, nb, _DECODE_CHUNK):
        wc = w[b0:b0 + _DECODE_CHUNK, None]
        bit = slot * wc                                      # (c, 320)
        byte = off[b0:b0 + _DECODE_CHUNK, None] + (bit >> 3)
        v = (pool[byte.clamp(max=hp - 1)]
             | (pool[(byte + 1).clamp(max=hp - 1)] << 8)
             | (pool[(byte + 2).clamp(max=hp - 1)] << 16))
        z = (v >> (bit & 7)) & ((1 << wc) - 1)
        r = ((z >> 1) ^ -(z & 1))[:, :318]                   # un-zigzag
        x0 = heads[b0:b0 + _DECODE_CHUNK, 0:1]
        x1 = heads[b0:b0 + _DECODE_CHUNK, 1:2]
        c1 = torch.cumsum(r, 1)
        o1 = x1 + c1
        o2 = x1 + torch.cumsum((x1 - x0) + c1, 1)
        oc = order[b0:b0 + _DECODE_CHUNK, None]
        body = torch.where(oc == 0, r, torch.where(oc == 1, o1, o2))
        parts.append(torch.cat([x0, x1, body], 1).to(torch.int16))
    return torch.cat(parts).reshape(-1)


def unpack_bits(buf, nb, out=None):
    """Exact int16 signal ``(nb*BLOCK,)`` from a :func:`pack_bits` buffer
    on the device.

    :param buf: the packed uint8 buffer, 1-D and contiguous.
    :param nb: the slice's block count.
    :param out: optional contiguous int16 ``(nb*BLOCK,)`` tensor on the
        buffer's device to write (a slice of a larger buffer); returned.
    """
    hp = _check_decode(buf, nb, torch.uint8, BYTE_PAGE, "unpack_bits")
    nb = int(nb)
    out = _check_out(out, nb, buf.device, "unpack_bits")
    if buf.device.type == "cpu":
        out.copy_(unpack_bits_plain(buf, nb))
        return out
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    lib = cuda_build.library()
    with torch.cuda.device(buf.device):
        rc = lib.iss_unpack_bits(
            buf.data_ptr(), hp, nb, out.data_ptr(), 0,
            torch.cuda.current_stream(buf.device).cuda_stream)
    cuda_build.check_launch("unpack_bits", rc)
    cuda_build.count_launch(unpack_bits)
    return out


unpack_bits.launches = 0


def ship(raw, device, *, pinned=False, out=None):
    """Upload one int16 slice through the codec -> its exact samples on
    ``device`` (``out`` when given).

    ``pack_best`` decides on the host; the packed buffer (or the raw
    slice, when it declines) crosses the link in one copy, through pinned
    memory without waiting for the device's queue with ``pinned``, and is
    decoded on the current stream.

    :param raw: 1-D int16 numpy slice, length a multiple of ``BLOCK``.
    :param out: optional contiguous int16 tensor of ``len(raw)`` on
        ``device`` to decode into (a slice of a larger buffer).
    """
    device = torch.device(device)
    packed = pack_best(raw)
    host = raw if packed is None else packed[1]
    x = (upload(host, device) if pinned
         else torch.from_numpy(np.ascontiguousarray(host)).to(device))
    if packed is None:
        if out is None:
            return x
        return out.copy_(x)
    decode = unpack_bits if packed[0] == "bits" else unpack_zero_elide
    return decode(x, len(raw) // BLOCK, out=out)
