"""The numpy model of the general-K Viterbi kernel (csrc/viterbi.cu,
``iss_viterbi_general``; ``tests/viterbi_general_model.py``) held bit-equal
to the JAX scan.

The model follows the kernel's parts in its order: the values-only forward
rows (no pointer on the chain), the speculative pass and the fix-up passes
that stop at the first frame whose row is bit-equal to the stored one, the
serial walk after ``PASS_CAP`` passes, the back-pointers and argmax off the
chain (the backtrack's K-element maps), the chunk summaries, their serial
chain and each chunk's backward walk.  States must equal
``inaspeechsegmenter_tpu.decode.viterbi._viterbi_scan``'s exactly.

It also pins why the kernel needs both halves: rows that forget their entry
converge in a few passes, but a uniform ``consecutive`` expansion never
does (every cycle of its graph has length c, so its states fall into c
phase classes whose offsets are kept for ever): there the passes run to
the cap and the walk takes every chunk that they did not reach.
"""

import numpy as np
import pytest

from inaspeechsegmenter_tpu.decode.viterbi import viterbi_path as jax_path
from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
from test_torch_viterbi import _jax_scan, _model_case
from torch_parity_helpers import kernel_constant
from viterbi_general_model import (PASS_CAP, chunk_parallel_viterbi_general,
                                   consecutive_case, constrained_case)

_CASES = {}
_CONSECUTIVE = {"consecutive=2": (2, 2, 2), "consecutive=3": (3, 3, 3),
                "consecutive=10": (10, 10, 10),
                "consecutive=(3, 4, 3)": (3, 4, 3)}


def _general_case(K, kind, T):
    key = (K, kind, T)
    if key not in _CASES:
        if kind.startswith("consecutive"):
            args = consecutive_case(_CONSECUTIVE[kind], T)
        elif kind == "constrained":
            args = constrained_case(K, T)
        else:
            args = _model_case(K, kind, T)
        _CASES[key] = args, _jax_scan(*args)
    return _CASES[key]


_KINDS = ([(K, kind) for K in (4, 8, 30, 33)
           for kind in ("random", "resets", "ties", "nan", "constant")]
          + [(9, "consecutive=3"), (10, "consecutive=(3, 4, 3)"),
             (8, "constrained")])


@pytest.mark.parametrize("cap", ["kernel", 1])
@pytest.mark.parametrize("P", [1, 7, 64, "T"])
@pytest.mark.parametrize("K,kind", _KINDS)
def test_general_model_bit_equal_jax_scan(K, kind, P, cap):
    T = 1000
    P = T if P == "T" else P
    cap = PASS_CAP if cap == "kernel" else cap
    (em, tr, init, reset), want = _general_case(K, kind, T)
    assert em.shape == (T, K)
    got, passes, walked = chunk_parallel_viterbi_general(em, tr, init, reset,
                                                         P, pass_cap=cap)
    np.testing.assert_array_equal(got, want)
    n_chunks = -(-T // -(-T // P))
    assert 1 <= passes <= min(n_chunks, cap + 1)
    assert 0 <= walked < n_chunks
    if kind in ("constant", "consecutive=3"):
        # never converges: exactness advances one chunk a pass, and the walk
        # re-runs every chunk that the passes did not reach
        assert passes == min(n_chunks, cap + 1)
        assert walked == max(0, n_chunks - passes)


@pytest.mark.parametrize("consecutive", [2, 3, 10])
def test_uniform_consecutive_never_converges(consecutive):
    """The smoke's decode (consecutive=10 on 3 states, K = 30) and its
    kin: no fix-up pass stops early, so the passes run to the cap and the
    walk takes every chunk that they did not reach; the states stay
    exact."""
    T, P = 3000, 300
    (em, tr, init, reset), want = _general_case(
        3 * consecutive, f"consecutive={consecutive}", T)
    got, passes, walked = chunk_parallel_viterbi_general(em, tr, init, reset,
                                                         P)
    np.testing.assert_array_equal(got, want)
    assert passes == PASS_CAP + 1
    assert walked == P - passes


def test_a_reset_restarts_a_uniform_consecutive_decode():
    """A reset frame restarts every row, so a chunk holding one converges
    there even in a uniform expansion: with a reset every 100 frames (L =
    10) the passes reach no cap and nothing is walked."""
    T, P = 3000, 300
    (em, tr, init, _), _ = _general_case(30, "consecutive=10", T)
    reset = np.zeros(T, bool)
    reset[::100] = True
    got, passes, walked = chunk_parallel_viterbi_general(em, tr, init, reset,
                                                         P)
    np.testing.assert_array_equal(got, _jax_scan(em, tr, init, reset))
    assert passes <= 12 and walked == 0


@pytest.mark.parametrize("K,kind,found", [(8, "random", 3), (30, "random", 3),
                                          (8, "constrained", 2)])
def test_converging_inputs_take_a_handful_of_passes(K, kind, found):
    """Rows that forget their entry within a few frames (random dense
    transitions; the K = 8 constrained decode) converge at P = 64 (63
    chunks of 16 frames) in the pass count found here, the speculative pass
    included, with no chunk walked."""
    (em, tr, init, reset), want = _general_case(K, kind, 1000)
    got, passes, walked = chunk_parallel_viterbi_general(em, tr, init, reset,
                                                         64)
    np.testing.assert_array_equal(got, want)
    assert (passes, walked) == (found, 0)


def test_general_plan_follows_the_kernel():
    """The wrapper's chunking uses the kernel's constants and asks for
    what the model takes: ceil(T / L) chunks of L frames, none empty."""
    assert tv.CHUNK_MIN == kernel_constant("viterbi.cu", "CHUNK_MIN")
    assert tv.GK_WARPS == kernel_constant("viterbi.cu", "GK_WARPS")
    for T, K in ((1, 4), (17, 30), (2500, 30), (180_000, 30),
                 (180_000, 8), (300, 205), (40, 8192)):
        asked, L, P = tv.general_plan(T, K, 132)
        assert P == -(-T // L) and (P - 1) * L < T
        assert L == -(-T // asked) and P <= asked
        assert P <= 132 * (8 if K <= 32 else 1)
    assert tv.general_plan(180_000, 30, 132) == (1056, 171, 1053)


@pytest.mark.parametrize("parallel", [False, True, "scan", "parallel",
                                      "blocked"])
def test_viterbi_path_takes_the_jax_parallel_argument(parallel):
    """Every mode of the JAX ``viterbi_path`` is taken and decoded exactly:
    the states equal JAX's 'scan' and 'blocked' decodes."""
    (em, tr, init, reset), _ = _general_case(8, "random", 1000)
    got = tv.viterbi_path(em, tr, init, reset, parallel=parallel).numpy()
    for mode in ("scan", "blocked"):
        np.testing.assert_array_equal(
            got, np.asarray(jax_path(em, tr, init, reset, parallel=mode)))


def test_viterbi_path_refuses_an_unknown_mode():
    (em, tr, init, reset), _ = _general_case(4, "random", 1000)
    with pytest.raises(KeyError):
        tv.viterbi_path(em, tr, init, reset, parallel="serial")
    with pytest.raises(KeyError):
        jax_path(em, tr, init, reset, parallel="serial")
