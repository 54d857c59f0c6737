"""PyTorch/CUDA port of inaSpeechSegmenter-TPU.

Speech / music / noise / gender segmentation of 16 kHz audio
(``Segmenter``) and voice femininity scoring (``VoiceFemininityScoring``:
VBx features, a ResNet101 x-vector network and the scoring MLP), with the
JAX package ``inaspeechsegmenter_tpu`` as their reference.  Plain tensor
code is PyTorch; the fused SIDEKIT feature kernel and the Viterbi decode
are CUDA kernels written for Hopper (``csrc/``), each beside a plain
PyTorch version that CPU tensors run.  This package imports torch and
never jax.
"""

__version__ = "0.1.0"

from .segmenter import Segmenter
from .export import seg2csv, seg2textgrid
from .vfs import VoiceFemininityScoring

__all__ = ["Segmenter", "VoiceFemininityScoring", "seg2csv", "seg2textgrid",
           "__version__"]
