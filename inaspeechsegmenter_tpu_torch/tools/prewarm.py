"""Build the port's kernels and warm its engines before the first request.

Counterpart of the JAX package's ``tools/prewarm.py``.  On the card the
cold cost of a first request is the ``nvcc`` build of the CUDA kernels,
seconds, then the CUDA context and the cuDNN / cuBLAS handles.  This tool
pays them ahead, step by step, printing the seconds of each:

1. builds and loads the CUDA kernel library (``utils.cuda_build``) into
   its build directory (``$ISS_TORCH_BUILD_DIR``, else ``build/`` in a
   checkout, the user cache in an install);
2. builds and loads the native audio library (``audio.native``);
3. for each engine of ``--engines`` (``sm|smn[+gender]``, comma
   separated), constructs a ``Segmenter`` on ``--device`` and runs one
   short seeded signal through it: the features kernel and the K <= 3
   Viterbi kernel launch.

The JAX tool's ``--max-hours`` walks XLA's jit bucket ladder; the port
compiles nothing per shape, so it has no such flag.  Without ``nvcc``, a
C++ compiler or a CUDA device it raises: it never falls back to the CPU.

    python -m inaspeechsegmenter_tpu_torch.tools.prewarm \\
        [--engines smn+gender,sm] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

WARM_SECONDS = 5      # the seeded signal: noise with a second of silence


def warm_signal(seconds=WARM_SECONDS, seed=0):
    rng = np.random.default_rng(seed)
    sig = (rng.standard_normal(16000 * seconds) * 3000).astype(np.int16)
    sig[16000:32000] = 0
    return sig


def build_kernels():
    """Build and load the CUDA kernel library -> its path."""
    from ..utils import cuda_build

    path = cuda_build.build()
    cuda_build.library()
    return path


def build_native():
    """Build and load the native audio library -> its ctypes handle."""
    from ..audio import native

    lib = native.load_library()
    if lib is None:
        raise RuntimeError("native audio library unavailable: no "
                           "$ISS_AUDIO_LIB and no C++ compiler")
    return lib


def warm_engine(spec, device):
    """Construct the ``Segmenter`` of ``spec`` (``smn+gender``, ``sm``,
    ...) on ``device`` and segment one seeded signal -> its segments."""
    from .. import Segmenter

    engine, _, gender = spec.partition("+")
    if engine not in ("sm", "smn") or gender not in ("", "gender"):
        raise ValueError(f"unknown engine {spec!r}: expected "
                         "sm|smn[+gender]")
    seg = Segmenter(vad_engine=engine, detect_gender=bool(gender),
                    ffmpeg=None, device=device)
    return seg.segment_signal(warm_signal())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--engines", default="smn+gender",
                    help="comma list of sm|smn[+gender]")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines (default cuda)")
    args = ap.parse_args(argv)

    import torch

    import inaspeechsegmenter_tpu_torch as pkg

    from ..decode import viterbi
    from ..dsp import fe_kernel
    from ..utils import cuda_build
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    print(f"[prewarm] package {pkg.__file__}", flush=True)
    t0 = time.perf_counter()
    lib = build_kernels()
    print(f"[prewarm] CUDA kernels built and loaded in "
          f"{time.perf_counter() - t0!r} s: {lib}", flush=True)
    t0 = time.perf_counter()
    native = build_native()
    print(f"[prewarm] native audio library built and loaded in "
          f"{time.perf_counter() - t0!r} s: {native._name}", flush=True)
    for spec in args.engines.split(","):
        before = (fe_kernel.sidekit_features.launches,
                  viterbi.viterbi_scan.launches)
        t0 = time.perf_counter()
        lseg = warm_engine(spec, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"[prewarm] {spec} on {device}: {time.perf_counter() - t0!r} "
              f"s, {len(lseg)} segments, launches features "
              f"{fe_kernel.sidekit_features.launches - before[0]} viterbi "
              f"{viterbi.viterbi_scan.launches - before[1]}", flush=True)
    print(f"[prewarm] build directory {cuda_build.build_dir()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
