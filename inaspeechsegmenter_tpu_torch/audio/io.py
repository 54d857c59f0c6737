"""Media decode: anything -> 16 kHz mono PCM on the host.

Port of ``inaspeechsegmenter_tpu/audio/io.py`` (reference io.py:32-79):

* With ffmpeg, any media file or url is decoded by an ffmpeg subprocess
  piping 16 kHz mono pcm_s16le WAV to stdout, with start/stop windows
  passed as ``-ss`` / ``-to``.
* With ``ffmpeg=None``, only local WAV files are accepted and
  start/stop/url raise NotImplementedError, the reference's no-ffmpeg
  contract (io.py:37-55), with the port's RIFF reader in place of
  libsndfile.  A WAV at another rate than 16 kHz goes through the native
  resampler (``audio/native.py``, built at first use), as in the JAX
  package; where it cannot be built (no C++ compiler) such a WAV raises.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
import warnings

import numpy as np

from .wav import WavFormatError, _read_chunks, read_wav

SR = 16000


def _cast_signal(sig, dtype):
    """Cast float samples to the requested dtype: integer targets are
    rounded and saturated (a bare astype would truncate and WRAP overshoot
    past full scale into opposite-sign clicks)."""
    out_dtype = np.dtype(dtype)
    if out_dtype.kind in "iu":
        info = np.iinfo(out_dtype)
        sig = np.clip(np.rint(sig), info.min, info.max)
    return sig.astype(out_dtype)


def media2sig16kmono(medianame, start_sec=None, stop_sec=None,
                     ffmpeg="ffmpeg", dtype="float64"):
    """Decode a media file to a 16 kHz mono signal.

    :param ffmpeg: the ffmpeg binary, or None for 16 kHz WAV input only.
    :param dtype: numpy dtype, or 'auto' — int16 when the source is
        losslessly 16-bit PCM mono (a half-size device upload; int16/2^15
        is the identical float32), float32 otherwise.
    :return: 1-D numpy array.
    """
    if dtype == "auto":
        return _media2sig_auto(medianame, start_sec, stop_sec, ffmpeg)
    if ffmpeg is None:
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
        sig, sr = read_wav(medianame, dtype=dtype)
        if sig.ndim > 1:
            # mono mixdown, rounded and saturated for integer dtypes
            sig = _cast_signal(sig.mean(axis=1), dtype)
        if sr != SR:
            from . import native

            if not native.available():
                raise ValueError(
                    f"Without ffmpeg, only files sampled at 16000 Hz are "
                    f"supported (no C++ compiler to build the native "
                    f"resampler). The file {medianame} is sampled at {sr} "
                    f"Hz.")
            sig = native.resample(sig.astype(np.float32), sr, SR)
            # sinc overshoot past full scale saturates, never wraps
            return _cast_signal(sig, dtype)
        return sig

    cmd = [ffmpeg, "-i", medianame, "-f", "wav", "-acodec", "pcm_s16le",
           "-ar", str(SR), "-ac", "1"]
    if start_sec is not None:
        cmd += ["-ss", "%f" % start_sec]
    if stop_sec is not None:
        cmd += ["-to", "%f" % stop_sec]
    cmd += ["pipe:1"]

    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr.decode(errors="replace"))
    # ffmpeg writes a streaming WAV with an unknown-length data chunk; the
    # RIFF sizes may be 0xFFFFFFFF — patch the actual size before parsing
    sig, sr = read_wav(_fix_streamed_riff(proc.stdout), dtype=dtype)
    if sr != SR:
        raise RuntimeError(f"{ffmpeg} returned {sr} Hz audio, not {SR} Hz")
    return sig


def _media2sig_auto(medianame, start_sec, stop_sec, ffmpeg):
    if ffmpeg is not None:
        # ffmpeg emits pcm_s16le: int16 is always exact on this path
        return media2sig16kmono(medianame, start_sec, stop_sec, ffmpeg,
                                "int16")
    if (start_sec is not None or stop_sec is not None
            or medianame.startswith("http://")
            or medianame.startswith("https://")):
        # the float path enforces (and raises) the no-ffmpeg restrictions
        return media2sig16kmono(medianame, start_sec, stop_sec, ffmpeg,
                                "float32")
    dtype = "int16" if _is_pcm16_mono_16k(medianame) else "float32"
    return media2sig16kmono(medianame, None, None, None, dtype)


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


def _fix_streamed_riff(blob: bytes) -> bytes:
    """Rewrite bogus RIFF/data sizes emitted when ffmpeg streams to a pipe."""
    if len(blob) < 44:
        return blob
    ba = bytearray(blob)
    # clamp to the 4-byte RIFF field for >= 4 GiB streams (~37 h at 16 kHz
    # mono s16le); 0xFFFFFFFE keeps the s16 sample alignment and read_wav
    # truncates payloads to whole frames
    ba[4:8] = min(len(blob) - 8, 0xFFFFFFFE).to_bytes(4, "little")
    # walk the chunk headers for the real data chunk — a raw find() can
    # land inside LIST/INFO metadata text containing "data" (ffmpeg passes
    # source tags through).  Pre-data chunk sizes are valid (ffmpeg writes
    # them before streaming); the data chunk's own bogus size is what is
    # fixed here, and the walk stops there.
    idx = -1
    pos = 12
    while pos + 8 <= len(blob):
        cid = blob[pos:pos + 4]
        size = int.from_bytes(blob[pos + 4:pos + 8], "little")
        if cid == b"data":
            idx = pos
            break
        pos += 8 + size + (size & 1)
    if idx >= 0:
        size = min(len(blob) - idx - 8, 0xFFFFFFFE)
        if len(blob) - idx - 8 > size:
            warnings.warn(
                "streamed WAV exceeds the 4 GiB RIFF limit (~37 h at "
                "16 kHz mono); audio past that point is dropped — use "
                "start_sec/stop_sec to window very long media")
        ba[idx + 4: idx + 8] = size.to_bytes(4, "little")
    return bytes(ba)


def check_ffmpeg(ffmpeg):
    """Validate the ffmpeg binary like the reference ctor
    (segmenter.py:227-231): ``None`` means WAV input only."""
    if ffmpeg is not None and shutil.which(ffmpeg) is None:
        raise Exception("ffmpeg program not found")
    return ffmpeg
