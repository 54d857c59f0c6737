"""Media decode: 16 kHz WAV -> mono PCM on the host.

Port of the no-ffmpeg path of ``inaspeechsegmenter_tpu/audio/io.py``
(reference io.py:37-55): only local 16 kHz WAV files are accepted,
start/stop and urls raise NotImplementedError, and a file that is not a
WAV raises ``WavFormatError``.  ffmpeg decoding and the native resampler
are not ported yet: ``check_ffmpeg`` rejects an ffmpeg binary, and a WAV
at another rate raises.
"""

from __future__ import annotations

import struct

import numpy as np

from .wav import WavFormatError, _read_chunks, read_wav

SR = 16000


def media2sig16kmono(medianame, start_sec=None, stop_sec=None, dtype="float64"):
    """Decode a 16 kHz WAV file to a mono signal.

    :param dtype: numpy dtype, or 'auto' — int16 when the file is 16-bit
        PCM mono (a half-size device upload; int16/2^15 is the identical
        float32), float32 otherwise.
    :return: 1-D numpy array.
    """
    if start_sec is not None or stop_sec is not None:
        raise NotImplementedError(
            f"start_sec={start_sec} and stop_sec={stop_sec} cannot be set "
            f"when running without ffmpeg. Please cut down your audio "
            f"files beforehand or use ffmpeg."
        )
    if medianame.startswith("http://") or medianame.startswith("https://"):
        raise NotImplementedError(
            f"Without ffmpeg you cannot process media content on http "
            f"servers. You need to download your audio files beforehand "
            f"or use ffmpeg. You gave medianame={medianame}."
        )
    if dtype == "auto":
        dtype = "int16" if _is_pcm16_mono_16k(medianame) else "float32"
    sig, sr = read_wav(medianame, dtype=dtype)
    if sr != SR:
        raise ValueError(
            f"Without ffmpeg, only files sampled at 16000 Hz are "
            f"supported. The file {medianame} is sampled at {sr} Hz.")
    if sig.ndim > 1:
        # mono mixdown, rounded and saturated for integer dtypes
        sig = sig.mean(axis=1)
        if np.dtype(dtype).kind in "iu":
            info = np.iinfo(dtype)
            sig = np.clip(np.rint(sig), info.min, info.max)
        sig = sig.astype(dtype)
    return sig


def _is_pcm16_mono_16k(medianame):
    """Whether the real fmt chunk (found by walking the RIFF chunks, not
    by scanning bytes) says 16-bit PCM, mono, 16 kHz."""
    try:
        with open(medianame, "rb") as f:
            for cid, size, offset in _read_chunks(f):
                if cid == b"fmt ":
                    f.seek(offset)
                    raw = f.read(size)
                    if len(raw) < 16:
                        return False
                    code, channels, sr, _, _, bits = struct.unpack(
                        "<HHIIHH", raw[:16])
                    return (code, bits, channels, sr) == (1, 16, 1, SR)
    except (OSError, WavFormatError, struct.error):
        pass
    return False


def check_ffmpeg(ffmpeg):
    """Only ``ffmpeg=None`` (WAV input) is ported."""
    if ffmpeg is not None:
        raise NotImplementedError(
            "ffmpeg decoding is not ported to the PyTorch package yet; pass "
            "ffmpeg=None (16 kHz WAV input)")
    return ffmpeg
