"""The kernel cache's scope: the counterpart of
``inaspeechsegmenter_tpu/utils/cache.py``.

The JAX package keeps a persistent XLA compilation cache, scoped per
backend because "results compiled for one host can SIGILL on another".
The port compiles nothing per shape: its cache is the directory that
``utils/cuda_build.py`` builds the kernel library into, whose file name
carries a hash of the sources, the ``nvcc`` flags and ``nvcc``'s release
line, so two toolkits that share the directory never load each other's
build.  Like the JAX cache it has no size cap and is never pruned.
"""

from __future__ import annotations

import os

from . import cuda_build


def enable_kernel_cache(path=None):
    """Create and return the kernel build directory: ``path``, else
    ``$ISS_TORCH_BUILD_DIR``, else ``cuda_build.default_build_dir``'s
    (``build/`` in a checkout, the user cache in an install).  A ``path``
    given here is exported as ``ISS_TORCH_BUILD_DIR`` for the build to
    find, as the JAX function sets the compiler's cache option.  Safe to
    call more than once."""
    if path is None:
        path = cuda_build.build_dir()
    else:
        os.environ["ISS_TORCH_BUILD_DIR"] = path
    os.makedirs(path, exist_ok=True)
    return path
