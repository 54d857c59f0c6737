"""The reference's import path ``inaSpeechSegmenter.pyannote_viterbi``
(pyannote_viterbi.py:118-224): the constrained ``viterbi_decoding``, here
the port's (``decode/viterbi.py``: the CUDA Viterbi kernels by default,
their plain versions with ``device="cpu"``)."""

from .decode.viterbi import (VITERBI_CONSTRAINT_FORBIDDEN,
                             VITERBI_CONSTRAINT_MANDATORY,
                             VITERBI_CONSTRAINT_NONE, viterbi_decoding)

__all__ = ["viterbi_decoding", "VITERBI_CONSTRAINT_NONE",
           "VITERBI_CONSTRAINT_FORBIDDEN", "VITERBI_CONSTRAINT_MANDATORY"]
