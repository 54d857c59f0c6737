"""Viterbi parameter builders.

Numpy-only copy of ``inaspeechsegmenter_tpu/decode/transitions.py`` (the
JAX package cannot be imported without jax).

Numerically identical to the reference helpers (viterbi_utils.py:29-49):
binary emissions from hard predictions, and exponential-cost transition
matrices where off-diagonal transitions cost 10**-exp.
"""

from __future__ import annotations

import numpy as np


def pred2logemission(pred, eps=1e-10):
    """(T,) binary predictions -> (T, 2) log-emissions with probability
    1-eps on the predicted state and eps on the other."""
    pred = np.asarray(pred)
    ret = np.ones((len(pred), 2)) * eps
    ret[pred == 0, 0] = 1 - eps
    ret[pred == 1, 1] = 1 - eps
    return np.log(ret)


def log_trans_exp(exp, cost0=0, cost1=0):
    """2-state transition matrix: off-diagonal cost -exp*ln(10), diagonal
    costs cost0 / cost1."""
    cost = -exp * np.log(10)
    ret = np.ones((2, 2)) * cost
    ret[0, 0] = cost0
    ret[1, 1] = cost1
    return ret


def diag_trans_exp(exp, dim):
    """dim-state transition matrix: 0 on the diagonal, -exp*ln(10) off it."""
    cost = -exp * np.log(10)
    ret = np.ones((dim, dim)) * cost
    np.fill_diagonal(ret, 0)
    return ret
