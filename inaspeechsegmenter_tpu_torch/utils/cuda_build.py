"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles in its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects into one shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers: a source that includes them takes minutes to build, these take
seconds).  The library name carries a hash of the sources and flags, so an
edited kernel is rebuilt at first use and a stale library is never loaded.

Built for Hopper only (``sm_90a``).  No ``--use_fast_math``: it flushes
denormals and approximates ``logf``, and the frontend's ``-inf`` rows on
digital silence depend on an exact ``log(0)``.

Nothing is built or loaded at import: the first kernel launch calls
:func:`library`.  The first build and load hold one process-wide lock, so
threads that launch their first kernels together (the batch drivers'
producer threads) build once, into one set of temporary files.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_LOCK = threading.RLock()   # the first build and load; re-entered by library()
_LIB = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build_dir():
    """``$ISS_TORCH_BUILD_DIR``, else ``build/torch_kernels`` beside the
    package (the checkout's git-ignored ``build/``)."""
    return os.environ.get("ISS_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(PKG_DIR), "build", "torch_kernels")


def find_nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def build(verbose=False):
    """Compile the library if no build of the current sources exists.

    :return: path of the shared library.
    :raises RuntimeError: with nvcc's output when the build fails.
    """
    with _LOCK:
        return _build(verbose)


def _build(verbose):
    out_dir = build_dir()
    lib = os.path.join(out_dir, f"libiss_torch_kernels_{source_hash()}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = os.path.join(out_dir, f"tmp{os.getpid()}_{os.path.basename(lib)}")
    nvcc = find_nvcc()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources()]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
         "-o", obj, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for src, obj in zip(sources(), objs)]
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    if all(rc == 0 for _, rc in outs):
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        outs.append((link.stdout + link.stderr, link.returncode))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    text = "\n".join(out for out, _ in outs)
    if any(rc != 0 for _, rc in outs):
        raise RuntimeError(f"nvcc failed:\n{text}")
    if verbose:
        print(text, flush=True)
    os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    return lib


_P = ctypes.c_void_p
_SIGNATURES = {
    # (sig, is_int16, n_frames, window, twiddle, fbank_t, band_range, mspec,
    #  loge, stream) -> cudaError_t
    "iss_sidekit_fe": [_P, ctypes.c_int, ctypes.c_longlong, _P, _P, _P, _P,
                       _P, _P, _P],
    # (emission, reset, trans, init, T, K, max_blocks, vbuf, code, exits,
    #  ctl, states, stream)
    "iss_viterbi": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, _P, _P, _P, _P, _P, _P],
    # (emission, reset, trans, init, T, K, L, max_blocks, rows, exits, maps,
    #  sums, xb, ctl, states, stream)
    "iss_viterbi_general": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P,
                            _P, _P, _P],
}


def library():
    """The loaded kernel library (built first if needed), with every entry
    point's ``argtypes``/``restype`` declared."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(build())
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _LIB = lib
    return _LIB


def check_launch(name, rc):
    """Raise if a launch returned a non-zero ``cudaGetLastError()``."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {rc})")


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper):
    """Add one to ``wrapper.launches``; producer threads launch kernels
    too, and ``+=`` on an attribute is not atomic."""
    with _COUNT_LOCK:
        wrapper.launches += 1
