"""PyTorch/CUDA port of the inaSpeechSegmenter-TPU segmentation path.

Speech / music / noise / gender segmentation of 16 kHz audio, with the JAX
package ``inaspeechsegmenter_tpu`` as its reference.  Plain tensor code is
PyTorch; the fused SIDEKIT feature kernel and the Viterbi decode are CUDA
kernels written for Hopper (``csrc/``), each beside a plain PyTorch version
that CPU tensors run.  This package imports torch and never jax.
"""

__version__ = "0.1.0"

from .segmenter import Segmenter
from .export import seg2csv, seg2textgrid

__all__ = ["Segmenter", "seg2csv", "seg2textgrid", "__version__"]
