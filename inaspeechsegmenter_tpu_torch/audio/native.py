"""ctypes bindings for the native audio library (``native/issaudio.cc``).

Copy of the bindings of ``inaspeechsegmenter_tpu/audio/native.py``: WAV
decode, mono mixdown and the polyphase sinc resampler to 16 kHz, which
``audio/io.py`` uses for a WAV at another rate when there is no ffmpeg.
The upload codec's ``pack_bits`` is not bound (the codec is not ported).

The port builds its own library at first use, from the repository's
``native/issaudio.cc``, with the host C++ compiler (``$CXX``, else
``c++``, else ``g++``) and the Makefile's flags, into the git-ignored
``build/native/`` beside the package (``$ISS_TORCH_BUILD_DIR`` moves it),
as ``libissaudio_<hash>.so`` where the hash covers the source and the
flags; a lock makes concurrent first users build once.  It never loads
the JAX package's library nor runs ``native/Makefile``, whose target lies
in the JAX package.  A failed build raises with the compiler's output;
with no compiler (or no source) the library is unavailable and a WAV at
another rate than 16 kHz raises, the reference's no-ffmpeg contract.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(PKG_DIR), "native", "issaudio.cc")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def build_dir():
    """``$ISS_TORCH_BUILD_DIR``, else ``build/native`` beside the
    package."""
    return os.environ.get("ISS_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(PKG_DIR), "build", "native")


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

    :return: its path, or None when there is no source or no compiler.
    :raises RuntimeError: with the compiler's output when it fails.
    """
    if not os.path.exists(SOURCE):
        return None
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


def load_library():
    """The loaded library (built first if needed), or None when it cannot
    be built here (no compiler or no source)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        path = build()
        if path is not None:
            lib = ctypes.CDLL(path)
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
            _LIB = lib
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
        raise RuntimeError("native audio library unavailable: no C++ "
                           "compiler or no native/issaudio.cc")
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
