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
from torch_parity_helpers import kernel_constant


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


# ---------------------------------------------------------------------------
# A numpy model of the CUDA kernel's algorithm (csrc/viterbi.cu), one chunk
# per vector lane: speculative pass, bit-compare fix-up passes with early
# stop, the serial walk after the kernel's PASS_CAP passes, and the
# map-composition backtrack, with the kernel's code bytes (2-bit pointers
# in bits 0-5, 0b11 in bits 0-1 at a reset, the argmax in bits 6-7).

PASS_CAP = kernel_constant("viterbi.cu", "PASS_CAP")


def _takes_over(cand, best):
    return (best == best) & ~(cand <= best)


def _model_step(v, em, rst, tr, ini):
    """One frame for n chunks: v (n, K) f32 -> (v, code (n,) uint32)."""
    n, K = v.shape
    vn = np.empty_like(v)
    code = np.zeros(n, np.uint32)
    for kp in range(K):
        best = v[:, 0] + tr[0, kp]
        arg = np.zeros(n, np.uint32)
        for k in range(1, K):
            c = v[:, k] + tr[k, kp]
            t = _takes_over(c, best)
            best, arg = np.where(t, c, best), np.where(t, k, arg)
        vn[:, kp] = em[:, kp] + np.where(rst, ini[kp], best)
        code |= arg.astype(np.uint32) << (2 * kp)
    m = vn[:, 0].copy()
    am = np.zeros(n, np.uint32)
    for k in range(1, K):
        t = _takes_over(vn[:, k], m)
        m, am = np.where(t, vn[:, k], m), np.where(t, k, am)
    am = np.where(m != m, 0, am).astype(np.uint32)
    return vn - m[:, None], np.where(rst, 3, code) | (am << 6)


def _compose(a, b, K):
    """(a o b)(j) = a(b(j)) on packed maps (vectors of uint32)."""
    out = np.zeros_like(a)
    for j in range(K):
        bj = (b >> (2 * j)) & 3
        out |= ((a >> (2 * bj)) & 3) << (2 * j)
    return out


def chunk_parallel_viterbi(em, tr, init, reset, P, pass_cap=PASS_CAP):
    """-> (states (T,) int32, passes, chunks walked) of the kernel's
    algorithm on P chunks: at most ``pass_cap`` fix-up passes, then one
    walker re-runs, in order, every chunk whose entry differs from its
    left neighbour's exit, each run going on into the next chunk while it
    does not stop on a stored row."""
    T, K = em.shape
    L = -(-T // P)
    P = -(-T // L)
    rs = reset.copy()
    rs[0] = True
    start = np.arange(P) * L
    stop = np.minimum(start + L, T)
    vbuf = np.empty((T, K), np.float32)
    code = np.empty(T, np.uint32)
    bits = lambda x: x.view(np.uint32)                       # noqa: E731

    def run(ch, v, check):
        """Re-run chunks ``ch`` from rows ``v``; -> ran to the end."""
        live = np.ones(len(ch), bool)
        for i in range(L):
            act = live & (start[ch] + i < stop[ch])
            if not act.any():
                break
            t = start[ch][act] + i
            v[act], code[t] = _model_step(v[act], em[t], rs[t], tr, init)
            if check:
                same = (bits(v[act]) == bits(vbuf[t])).all(axis=1)
                live[np.flatnonzero(act)[same]] = False
                t = t[~same]
                vbuf[t] = v[act][~same]
            else:
                vbuf[t] = v[act]
        return live

    with np.errstate(invalid="ignore"):
        entry = np.zeros((P, K), np.float32)
        ex = entry.copy()
        run(np.arange(P), ex, check=False)
        passes, more = 1, P > 1
        while more and passes <= pass_cap:
            passes += 1
            new = ex[:-1].copy()                       # a grid barrier
            go = (bits(new) != bits(entry[1:])).any(axis=1)
            ch = 1 + np.flatnonzero(go)
            entry[ch] = new[go]
            v = entry[ch].copy()
            ran = run(ch, v, check=True)
            ex[ch[ran]] = v[ran]
            more = bool((ran & (ch < P - 1)).any())
        walked, i = 0, 1
        while more and i < P:                          # the serial walk
            if (bits(ex[i - 1]) == bits(entry[i])).all():
                i += 1
                continue
            v = ex[i - 1:i].copy()
            while i < P:
                walked += 1
                if not run(np.array([i]), v, check=True)[0]:
                    break
                ex[i] = v[0]
                i += 1
            i += 1

    # backtrack: F_c maps the state after chunk c to its first frame's state
    ident = sum(j << (2 * j) for j in range(K))
    ones = sum(1 << (2 * j) for j in range(K))      # a constant map's factor
    nxt0 = np.where(stop < T, code[np.minimum(stop, T - 1)], 3).astype(
        np.uint32)

    def walk(x=None):
        f = np.full(P, ident, np.uint32)
        nxt = nxt0.copy()
        out = np.empty(T, np.int32)
        for i in range(L - 1, -1, -1):
            t = start + i
            act = t < stop
            cd, nx = code[t[act]], nxt[act]
            end = (nx & 3) == 3
            if x is None:
                m = np.zeros_like(cd)
                for j in range(K):
                    m |= ((nx >> (2 * ((f[act] >> (2 * j)) & 3))) & 3) << (2 * j)
                f[act] = np.where(end, (cd >> 6) * ones, m)
            else:
                x[act] = np.where(end, cd >> 6, (nx >> (2 * x[act])) & 3)
                out[t[act]] = x[act]
            nxt[act] = cd
        return f if x is None else out

    s = walk()
    d = 1
    while d < P:                               # Hillis-Steele suffix scan
        s = np.concatenate([_compose(s[:-d], s[d:], K), s[-d:]])
        d *= 2
    later = np.concatenate([s[1:], [ident]]).astype(np.uint32)
    return walk(later & 3), passes, walked


def _model_case(K, kind, T):
    if kind == "constant":
        # score gaps that grow by 1e-5 per frame and never reach the
        # transition cost: no chunk forgets its entry
        row = (np.log(1.0 / K) - 1e-5 * np.arange(K)).astype(np.float32)
        return (np.tile(row, (T, 1)), diag_trans_exp(0.7, K).astype(
            np.float32), np.full(K, np.log(1.0 / K), np.float32),
            np.zeros(T, bool))
    if kind == "nan":
        em, trans, init, reset = _case(K, "ties", T=T, seed=5)
        rng = np.random.default_rng(T)
        em[rng.random(T) < 0.02] = -np.inf         # all -inf: NaN scores
        em[rng.random(T) < 0.01, 0] = np.nan
        return em, trans, init, reset
    return _case(K, kind, T=T)


@pytest.mark.parametrize("cap", ["kernel", 1])
@pytest.mark.parametrize("P", [1, 2, 7, 64, "T"])
@pytest.mark.parametrize("kind", ["random", "resets", "ties", "constant",
                                  "nan"])
@pytest.mark.parametrize("K", [2, 3])
def test_chunk_parallel_model_bit_equal_jax_scan(K, kind, P, cap):
    T = 1000
    P = T if P == "T" else P
    cap = PASS_CAP if cap == "kernel" else cap
    em, trans, init, reset = _model_case(K, kind, T)
    want = _jax_scan(em, trans, init, reset)
    got, passes, walked = chunk_parallel_viterbi(em, trans, init, reset, P,
                                                 pass_cap=cap)
    np.testing.assert_array_equal(got, want)
    n_chunks = -(-T // -(-T // P))
    assert 1 <= passes <= min(n_chunks, cap + 1)
    assert walked < n_chunks
    if kind == "constant":
        # the worst case: exactness advances one chunk a pass, and the walk
        # re-runs every chunk the passes did not reach
        assert passes == min(n_chunks, cap + 1)
        assert walked == max(0, n_chunks - passes)
