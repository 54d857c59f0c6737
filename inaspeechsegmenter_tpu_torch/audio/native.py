"""ctypes bindings for the native audio library (``native/issaudio.cc``).

Copy of the bindings of ``inaspeechsegmenter_tpu/audio/native.py``: WAV
decode, mono mixdown and the polyphase sinc resampler to 16 kHz, which
``audio/io.py`` uses for a WAV at another rate when there is no ffmpeg,
and the upload codec's single-pass bit-packing encoder (``pack_bits``,
byte-identical to ``dsp/codec.py``'s numpy encoder), bound only when the
library reports codec format v2 (``issaudio-0.3.0`` or later,
:func:`_pack_format_ok`): a stale build falls back to the numpy encoder.

The library is, in this order (the JAX package's): a prebuilt one named
by ``$ISS_AUDIO_LIB`` (a path that is missing or fails to load passes to
the next), then the port's own build.  The port builds the package's own
copy of the source, ``inaspeechsegmenter_tpu_torch/native/issaudio.cc``
(byte-equal to the repository's ``native/issaudio.cc``, so it ships in
the wheel), at first use with the host C++ compiler (``$CXX``, else
``c++``, else ``g++``) and the Makefile's flags, into
``utils.cuda_build.default_build_dir("native")`` (``build/native`` in a
checkout, the user cache in an install, ``$ISS_TORCH_BUILD_DIR`` when
set), as ``libissaudio_<hash>.so`` where the hash covers the source and
the flags; a lock makes concurrent first users build once.  It never
loads the JAX package's library nor runs ``native/Makefile``.  A failed
build raises with the compiler's output; with no compiler the library is
unavailable and a WAV at another rate than 16 kHz raises, the
reference's no-ffmpeg contract.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from ..utils.cuda_build import default_build_dir

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG_DIR, "native", "issaudio.cc")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_LOCK = threading.Lock()
_LIB = None
_TRIED = False
_PACK_OK = False   # iss_pack_bits present and speaking the current format


def build_dir():
    return default_build_dir("native")


def find_cxx():
    """The host C++ compiler, or None."""
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    return None


def library_path():
    """Where the build of the current source and flags goes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(build_dir(), f"libissaudio_{h.hexdigest()[:16]}.so")


def build():
    """Compile the library unless a build of the current source exists.

    :return: its path, or None when there is no compiler.
    :raises RuntimeError: with the compiler's output when it fails.
    """
    lib = library_path()
    if os.path.exists(lib):
        return lib
    cxx = find_cxx()
    if cxx is None:
        return None
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = os.path.join(os.path.dirname(lib),
                       f"tmp{os.getpid()}_{threading.get_ident()}_"
                       + os.path.basename(lib))
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                       capture_output=True, text=True)
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{cxx} failed to build {SOURCE}:\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, lib)      # atomic: a concurrent loader never sees half
    return lib


def _pack_format_ok(lib) -> bool:
    """True when the library's ``iss_pack_bits`` writes the current codec
    format: the bit-packing format changed in issaudio 0.3.0 (exact odd
    and even widths, 32-byte sub-rows), and an older build would encode
    buffers the decoders garble."""
    try:
        lib.iss_version.restype = ctypes.c_char_p
        ver = lib.iss_version().decode()          # "issaudio-X.Y.Z"
        parts = tuple(int(p) for p in ver.rsplit("-", 1)[1].split("."))
        return parts >= (0, 3, 0)
    except (AttributeError, IndexError, ValueError, UnicodeDecodeError):
        return False


def _bind(lib):
    global _PACK_OK
    lib.iss_wav_info.restype = ctypes.c_int64
    lib.iss_wav_info.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.iss_wav_decode_f32.restype = ctypes.c_int64
    lib.iss_wav_decode_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.iss_resample.restype = ctypes.c_int64
    lib.iss_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    _PACK_OK = hasattr(lib, "iss_pack_bits") and _pack_format_ok(lib)
    if _PACK_OK:
        lib.iss_pack_bits.restype = ctypes.c_int64
        lib.iss_pack_bits.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    return lib


def load_library():
    """The loaded library: ``$ISS_AUDIO_LIB`` when it loads, else the
    port's own build (built first if needed); None when neither exists
    (no compiler)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        env = os.environ.get("ISS_AUDIO_LIB")
        if env and os.path.exists(env):
            try:
                _LIB = _bind(ctypes.CDLL(env))
            except OSError:
                pass
        if _LIB is None:
            path = build()
            if path is not None:
                _LIB = _bind(ctypes.CDLL(path))
        _TRIED = True
    return _LIB


def available():
    return load_library() is not None


def wav_info(blob: bytes):
    """(samplerate, channels, n_frames, bits) or None."""
    lib = load_library()
    if lib is None:
        return None
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    nf = ctypes.c_int64()
    bits = ctypes.c_int32()
    ret = lib.iss_wav_info(blob, len(blob), ctypes.byref(sr),
                           ctypes.byref(ch), ctypes.byref(nf),
                           ctypes.byref(bits))
    if ret != 0:
        return None
    return sr.value, ch.value, nf.value, bits.value


def decode_mono_f32(blob: bytes):
    """Decode a WAV blob to mono float32; returns (signal, samplerate)."""
    lib = load_library()
    info = wav_info(blob)
    if lib is None or info is None:
        raise ValueError("native decode unavailable or not a WAV")
    sr, _ch, n_frames, _bits = info
    out = np.empty(n_frames, np.float32)
    n = lib.iss_wav_decode_f32(
        blob, len(blob), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_frames)
    if n < 0:
        raise ValueError("native WAV decode failed")
    return out[:n], sr


def resample(sig: np.ndarray, sr_in: int, sr_out: int = 16000):
    """Polyphase sinc resample of a float32 mono signal."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native audio library unavailable: no "
                           "$ISS_AUDIO_LIB and no C++ compiler")
    sig = np.ascontiguousarray(sig, np.float32)
    cap = int(len(sig) * sr_out / sr_in) + 16
    out = np.empty(cap, np.float32)
    n = lib.iss_resample(
        sig.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(sig),
        sr_in, sr_out, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap)
    if n < 0:
        raise ValueError("native resample failed")
    return out[:n]


def pack_bits(sig_i16: np.ndarray, min_save: float = 0.05):
    """The native encoder of ``dsp/codec.py::pack_bits``.

    :return: the packed uint8 array; a 0-length array when packing would
        not save ``min_save`` of the raw bytes (a decline); None when the
        library, its ``iss_pack_bits`` or the current format is missing,
        and the numpy encoder should run.
    """
    lib = load_library()
    if lib is None or not _PACK_OK:
        return None
    sig = np.ascontiguousarray(sig_i16, np.int16)
    nb = len(sig) // 320
    cap = nb * 640 + 5 * nb + 2 * 128 * 1024
    out = np.empty(cap, np.uint8)
    n = lib.iss_pack_bits(
        sig.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(sig),
        min_save, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        return None          # unexpected; the numpy encoder takes over
    if n == 0:
        return out[:0]       # declined
    return out[:n]


def decode_to_16k_mono(path_or_blob):
    """WAV file or bytes -> 16 kHz mono float32 signal, any input rate."""
    if isinstance(path_or_blob, (bytes, bytearray)):
        blob = bytes(path_or_blob)
    else:
        with open(path_or_blob, "rb") as f:
            blob = f.read()
    sig, sr = decode_mono_f32(blob)
    if sr != 16000:
        sig = resample(sig, sr, 16000)
    return sig
