"""The reference's import path ``inaSpeechSegmenter.vbx_segmenter``
(vbx_segmenter.py:92): the VFS pipeline and the reference's module-level
helpers.  Where the reference returns pyannote objects (``get_annot_VAD``,
``is_mid_speech``, vbx_segmenter.py:28-69), the port's
:class:`~inaspeechsegmenter_tpu_torch.annotations.SpeechTimeline` stands
in, as in the JAX package."""

from .annotations import SpeechTimeline
from .dsp.vbx_host import get_features
from .vfs import (EMBED_DIM, FEAT_DIM, SR, STEP, WINLEN,
                  TorchResnetExtractor, VoiceFemininityScoring,
                  add_needed_vectors, get_femininity_score)

# the reference's extractor role (vbx_segmenter.py:205-266)
VBxExtractor = TorchResnetExtractor

__all__ = ["VoiceFemininityScoring", "TorchResnetExtractor", "VBxExtractor",
           "add_needed_vectors", "get_femininity_score", "get_features",
           "get_annot_VAD", "is_mid_speech",
           "STEP", "WINLEN", "FEAT_DIM", "EMBED_DIM", "SR"]


def get_annot_VAD(vad_tuples):
    """(label, start, stop) tuples -> the speech timeline (the reference
    returns a pyannote Annotation, vbx_segmenter.py:64-69)."""
    return SpeechTimeline.from_vad(vad_tuples)


def is_mid_speech(start, stop, a_vad):
    """True when the segment's midpoint lies inside detected speech
    (reference vbx_segmenter.py:28-38)."""
    return a_vad.contains_point((start + stop) / 2)
