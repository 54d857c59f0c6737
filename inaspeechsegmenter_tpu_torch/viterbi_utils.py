"""The reference's import path ``inaSpeechSegmenter.viterbi_utils``
(viterbi_utils.py:29-49): the Viterbi parameter builders."""

from .decode.transitions import diag_trans_exp, log_trans_exp, pred2logemission

__all__ = ["pred2logemission", "log_trans_exp", "diag_trans_exp"]
