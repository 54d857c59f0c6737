"""First-party WAV (RIFF/WAVE) reader and writer.

Numpy-only copy of ``inaspeechsegmenter_tpu/audio/wav.py``: importing any
module of the JAX package imports jax (its package ``__init__`` loads the
Segmenter), and the port must run where jax is not installed.

The reference delegates WAV parsing to libsndfile via `soundfile`
(reference io.py:51,77).  Neither soundfile nor libsndfile is guaranteed in a
TPU serving image, so this module implements a minimal, dependency-free RIFF
parser supporting the formats that matter for a 16 kHz speech pipeline:
PCM 8/16/24/32-bit, IEEE float32/float64, mono or multi-channel
(multi-channel is averaged to mono by the caller if desired).

Numeric conventions follow libsndfile so results are interchangeable with the
reference: integer PCM is scaled by 1/2^(bits-1) when read as float.
"""

from __future__ import annotations

import io as _io
import struct

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavFormatError(ValueError):
    pass


def _read_chunks(f):
    """Yield (chunk_id, size, payload_offset) for every top-level RIFF chunk."""
    header = f.read(12)
    if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise WavFormatError("not a RIFF/WAVE file")
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            return
        cid, size = struct.unpack("<4sI", hdr)
        offset = f.tell()
        yield cid, size, offset
        # chunks are word-aligned
        f.seek(offset + size + (size & 1))


def read_wav(path_or_file, dtype="float64", always_2d=False):
    """Read a WAV file.

    :param path_or_file: filesystem path, bytes, or a binary file object.
    :param dtype: output dtype — 'float32', 'float64', 'int16', or 'int32'.
    :param always_2d: if True, mono files return shape (n, 1).
    :return: (signal ndarray, samplerate)

    Matches soundfile.read() semantics: mono -> 1-D array, multi-channel ->
    (n, channels); integer PCM scaled to [-1, 1) for float dtypes.
    """
    if isinstance(path_or_file, (bytes, bytearray)):
        f = _io.BytesIO(path_or_file)
        close = False
    elif hasattr(path_or_file, "read"):
        f = path_or_file
        close = False
    else:
        f = open(path_or_file, "rb")
        close = True
    try:
        return _read_wav_stream(f, dtype, always_2d)
    finally:
        if close:
            f.close()


def _read_wav_stream(f, dtype, always_2d):
    fmt = None
    data_span = None
    for cid, size, offset in _read_chunks(f):
        if cid == b"fmt ":
            f.seek(offset)
            raw = f.read(size)
            if len(raw) < 16:
                raise WavFormatError("truncated fmt chunk")
            (audio_format, channels, samplerate, _byte_rate, block_align,
             bits) = struct.unpack("<HHIIHH", raw[:16])
            if audio_format == _WAVE_FORMAT_EXTENSIBLE and len(raw) >= 26:
                # real format is the first 2 bytes of the SubFormat GUID
                audio_format = struct.unpack("<H", raw[24:26])[0]
            fmt = (audio_format, channels, samplerate, block_align, bits)
        elif cid == b"data":
            data_span = (offset, size)
            if fmt is not None:
                break
    if fmt is None or data_span is None:
        raise WavFormatError("missing fmt or data chunk")

    audio_format, channels, samplerate, block_align, bits = fmt
    offset, size = data_span
    f.seek(offset)
    payload = f.read(size)
    # a stream shorter than the declared chunk (EOF truncation) must still
    # decode whole frames — np.frombuffer requires itemsize alignment.
    # Computed from bits/channels, NOT the file's block_align field: a
    # corrupt block_align must not break the frombuffer alignment.
    frame = max(1, (bits // 8) * max(1, channels))
    if len(payload) % frame:
        payload = payload[: len(payload) - len(payload) % frame]

    if audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            data = np.frombuffer(payload, dtype="<f4")
        elif bits == 64:
            data = np.frombuffer(payload, dtype="<f8")
        else:
            raise WavFormatError(f"unsupported float bit depth {bits}")
        scale = None
    elif audio_format == _WAVE_FORMAT_PCM:
        if bits == 16:
            data = np.frombuffer(payload, dtype="<i2")
            scale = 1.0 / 32768.0
        elif bits == 32:
            data = np.frombuffer(payload, dtype="<i4")
            scale = 1.0 / 2147483648.0
        elif bits == 8:
            # 8-bit WAV is unsigned
            data = np.frombuffer(payload, dtype="u1").astype(np.int16) - 128
            scale = 1.0 / 128.0
        elif bits == 24:
            n = len(payload) // 3
            b = np.frombuffer(payload[: n * 3], dtype=np.uint8).reshape(n, 3)
            data = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            data = (data << 8) >> 8  # sign-extend 24 -> 32
            scale = 1.0 / 8388608.0
        else:
            raise WavFormatError(f"unsupported PCM bit depth {bits}")
    else:
        raise WavFormatError(f"unsupported WAV format code {audio_format:#x}")

    if channels > 1:
        data = data[: (len(data) // channels) * channels].reshape(-1, channels)

    out_dtype = np.dtype(dtype)
    # corrupt float payloads can carry inf/NaN/overflowing values: decode
    # them as-is like libsndfile, without leaking RuntimeWarnings
    with np.errstate(over="ignore", invalid="ignore"):
        return _convert(data, out_dtype, scale, bits, dtype,
                        always_2d), samplerate


def _convert(data, out_dtype, scale, bits, dtype, always_2d):
    if out_dtype.kind == "f":
        out = data.astype(out_dtype)
        if scale is not None:
            out *= out_dtype.type(scale)
    elif out_dtype == np.int16:
        if scale is None:  # float source: scale/round/clip in float64 —
            # libsndfile rounds (lrintf); truncation loses 1 LSB on ~half
            # of all samples
            out = np.clip(np.rint(data.astype(np.float64) * 32768.0),
                          -32768, 32767).astype(np.int16)
        elif bits == 16:
            out = data.copy()
        else:
            out = (data.astype(np.float64) * scale * 32768.0).astype(np.int16)
    elif out_dtype == np.int32:
        if scale is None:
            # float64 intermediate: in float32 the clip bound 2**31-1
            # rounds UP to 2**31, making the clip a no-op and wrapping
            # full-scale positive samples to INT32_MIN
            out = np.clip(np.rint(data.astype(np.float64) * 2147483648.0),
                          -(2**31), 2**31 - 1).astype(np.int32)
        else:
            out = (data.astype(np.float64) * scale * 2147483648.0).astype(np.int32)
    else:
        raise ValueError(f"unsupported output dtype {dtype}")

    if always_2d and out.ndim == 1:
        out = out[:, None]
    return out


def write_wav(path_or_file, data, samplerate, subtype="PCM_16"):
    """Write a WAV file (PCM_16, PCM_32, FLOAT, or DOUBLE subtype)."""
    data = np.asarray(data)
    if data.ndim == 1:
        channels = 1
    else:
        channels = data.shape[1]

    if subtype == "PCM_16":
        if data.dtype.kind == "f":
            payload = np.clip(np.rint(data * 32768.0), -32768, 32767).astype("<i2")
        else:
            payload = data.astype("<i2")
        bits, code = 16, _WAVE_FORMAT_PCM
    elif subtype == "PCM_32":
        if data.dtype.kind == "f":
            # float64 intermediate: a float32 product at exactly 2**31
            # passes the clip (whose bound rounds to 2**31 in float32)
            # and wraps to INT32_MIN on the cast
            payload = np.clip(np.rint(data.astype(np.float64) * 2147483648.0),
                              -(2 ** 31), 2 ** 31 - 1).astype("<i4")
        else:
            payload = data.astype("<i4")
        bits, code = 32, _WAVE_FORMAT_PCM
    elif subtype == "FLOAT":
        payload = data.astype("<f4")
        bits, code = 32, _WAVE_FORMAT_IEEE_FLOAT
    elif subtype == "DOUBLE":
        payload = data.astype("<f8")
        bits, code = 64, _WAVE_FORMAT_IEEE_FLOAT
    else:
        raise ValueError(f"unsupported subtype {subtype}")

    raw = payload.tobytes()
    block_align = channels * bits // 8
    byte_rate = samplerate * block_align
    fmt = struct.pack("<HHIIHH", code, channels, samplerate, byte_rate,
                      block_align, bits)
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(raw)) + raw
    blob = b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body

    if hasattr(path_or_file, "write"):
        path_or_file.write(blob)
    else:
        with open(path_or_file, "wb") as f:
            f.write(blob)
