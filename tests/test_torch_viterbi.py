"""PyTorch port: Viterbi with segment resets against the JAX decode.

States must be bit-equal to ``_viterbi_scan`` (and to ``viterbi_path``,
which defaults to it): the port performs the same float32 adds and
comparisons in the same order, with first-max argmax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu.decode.viterbi import _viterbi_scan
from inaspeechsegmenter_tpu.decode.viterbi import viterbi_path as jax_viterbi_path
from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
from inaspeechsegmenter_tpu_torch.decode.transitions import (diag_trans_exp,
                                                             log_trans_exp)


def _case(K, kind, T=4000, seed=0):
    rng = np.random.default_rng(seed + 10 * K + {"random": 0, "resets": 1,
                                                  "ties": 2}[kind])
    if kind == "ties":
        # quantized emissions and -inf entries: exact ties everywhere
        with np.errstate(divide="ignore"):
            em = np.log(rng.integers(0, 3, size=(T, K)) / 2.0
                        ).astype(np.float32)
        em[rng.random(T) < 0.01] = 0.0
    else:
        em = np.log(rng.dirichlet(np.ones(K), T)).astype(np.float32)
    p_reset = {"random": 0.002, "resets": 0.3, "ties": 0.05}[kind]
    reset = rng.random(T) < p_reset
    trans = diag_trans_exp(0.7 if kind != "ties" else 1.0, K)
    init = np.full(K, np.log(1.0 / K))
    return (em, trans.astype(np.float32), init.astype(np.float32), reset)


def _jax_scan(em, trans, init, reset):
    reset = reset.copy()
    reset[0] = True
    return np.asarray(_viterbi_scan(jnp.asarray(em), jnp.asarray(trans),
                                    jnp.asarray(init), jnp.asarray(reset)))


@pytest.mark.parametrize("kind", ["random", "resets", "ties"])
@pytest.mark.parametrize("K", [2, 3])
def test_states_equal_jax_scan(K, kind):
    em, trans, init, reset = _case(K, kind)
    want = _jax_scan(em, trans, init, reset)
    before = tv.viterbi_scan.launches
    got = tv.viterbi_path(em, trans, init, reset)
    assert tv.viterbi_scan.launches == before     # CPU: plain version
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) == K              # the decode is not trivial


@pytest.mark.parametrize("K", [2, 3])
def test_states_equal_jax_viterbi_path(K):
    em, trans, init, reset = _case(K, "random", T=1500, seed=3)
    want = np.asarray(jax_viterbi_path(em, trans, reset=reset))
    got = tv.viterbi_path(em, trans, reset=reset)
    np.testing.assert_array_equal(got.numpy(), want)


def test_energy_decode_constants():
    """The pipeline's energy decode: 2 states, log_trans_exp(150, -5),
    saturated emissions; a single reset at frame 0."""
    rng = np.random.default_rng(7)
    act = rng.random(3000) < 0.5
    act[1000:1400] = True
    lp = np.log([1e-10, 1 - 1e-10]).astype(np.float32)
    em = np.where(act[:, None], lp[None, :], lp[None, ::-1])
    trans = log_trans_exp(150, cost0=-5).astype(np.float32)
    init = np.log([0.5, 0.5]).astype(np.float32)
    reset = np.zeros(3000, bool)
    want = _jax_scan(em, trans, init, reset)
    got = tv.viterbi_path(em, trans, init, reset)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reset_zero_is_forced():
    em, trans, init, reset = _case(2, "random", T=50)
    reset[0] = False
    a = tv.viterbi_path(em, trans, init, reset).numpy()
    reset[0] = True
    b = tv.viterbi_path(em, trans, init, reset).numpy()
    np.testing.assert_array_equal(a, b)


def test_kernel_wrapper_validates_before_launch():
    em = torch.zeros((10, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tv.viterbi_scan(em, em, em, em)
