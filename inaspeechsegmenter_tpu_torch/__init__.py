"""PyTorch/CUDA port of inaSpeechSegmenter-TPU.

Speech / music / noise / gender segmentation of 16 kHz audio
(``Segmenter``) and voice femininity scoring (``VoiceFemininityScoring``:
VBx features, a ResNet101 x-vector network and the scoring MLP), both also
incremental over a growing recording (``OnlineSegmenter``, ``OnlineVFS``),
with the JAX package ``inaspeechsegmenter_tpu`` as their reference.  Any
media decodes through ffmpeg; the models load by their registry names from
the released Keras ``.hdf5`` files, read without h5py, or from their
converted npz (``models``).  Plain
tensor code is PyTorch; the fused SIDEKIT feature kernel and the Viterbi
decode are CUDA kernels written for Hopper (``csrc/``), each beside a plain
PyTorch version that CPU tensors run.  This package imports torch and
never jax.
"""

__version__ = "0.1.0"

from .segmenter import Segmenter
from .export import seg2csv, seg2textgrid
from .online import OnlineSegmenter, OnlineVFS
from .vfs import VoiceFemininityScoring

__all__ = ["Segmenter", "VoiceFemininityScoring", "OnlineSegmenter",
           "OnlineVFS", "seg2csv", "seg2textgrid", "__version__"]
