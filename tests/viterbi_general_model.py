"""A numpy model of the general-K Viterbi kernel's algorithm (csrc/viterbi.cu,
``iss_viterbi_general``), and seeded decode inputs for it.  numpy only, so
that the card's tests (which cannot import JAX) compare the kernel's pass
and walk counts with it; ``tests/test_torch_viterbi_general.py`` holds it
bit-equal to the JAX scan.  Change it together with the kernel.
"""

import numpy as np

from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
from inaspeechsegmenter_tpu_torch.decode.transitions import diag_trans_exp
from torch_parity_helpers import kernel_constant

PASS_CAP = kernel_constant("viterbi.cu", "PASS_CAP")


def _rows_step(v, em, rst, tr, ini):
    """One frame for n chunks, values only: v (n, K) f32 -> the next rows
    (the max of each column and of the row propagate NaN, as max.NaN and
    the kernel's NaN-on-top key do)."""
    best = (v[:, :, None] + tr[None]).max(axis=1)
    vn = em + np.where(rst[:, None], ini[None], best)
    return vn - vn.max(axis=1, keepdims=True)


def chunk_parallel_viterbi_general(em, tr, init, reset, P, pass_cap=PASS_CAP):
    """-> (states (T,) int32, passes, chunks walked) of the kernel's
    algorithm on P chunks asked (``tv.general_plan``'s chunking)."""
    T, K = em.shape
    L = -(-T // P)
    P = -(-T // L)
    rs = reset.copy()
    rs[0] = True
    start = np.arange(P) * L
    stop = np.minimum(start + L, T)
    rows = np.empty((T, K), np.float32)
    bits = lambda x: x.view(np.uint32)                       # noqa: E731

    def run(ch, v, check):
        """Re-run chunks ``ch`` from rows ``v`` (updated in place) -> which
        ran to their end without stopping on a stored row."""
        live = np.ones(len(ch), bool)
        for i in range(L):
            act = live & (start[ch] + i < stop[ch])
            if not act.any():
                break
            t = start[ch][act] + i
            new = _rows_step(v[act], em[t], rs[t], tr, init)
            v[act] = new
            if check:
                same = (bits(new) == bits(rows[t])).all(axis=1)
                live[np.flatnonzero(act)[same]] = False
                rows[t[~same]] = new[~same]
            else:
                rows[t] = new
        return live

    with np.errstate(invalid="ignore"):
        # part 2: the speculative pass, the fix-up passes, the walk
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
        while more and i < P:
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

        # part 3: the maps off the chain, by jnp.argmax's rule (numpy's:
        # the first maximum, the first NaN)
        end = np.append(rs[1:], True)
        maps = (rows[:, :, None] + tr[None]).argmax(axis=1)
        maps[end] = rows[end].argmax(axis=1)[:, None]

    # part 4: each chunk's summary F (the state at its first frame from the
    # state after its last), then the chain of summaries from the end
    f = np.tile(np.arange(K), (P, 1))
    for i in range(L - 1, -1, -1):
        t = start + i
        act = t < stop
        f[act] = np.take_along_axis(maps[t[act]], f[act], axis=1)
    xb = np.zeros(P, np.int64)
    for c in range(P - 1, 0, -1):
        xb[c - 1] = f[c, xb[c]]
    # part 5: each chunk walks backward
    states = np.empty(T, np.int32)
    x = xb.copy()
    for i in range(L - 1, -1, -1):
        t = start + i
        act = t < stop
        x[act] = maps[t[act], x[act]]
        states[t[act]] = x[act]
    return states, passes, walked


def consecutive_case(consecutive, T, seed=11):
    """viterbi_decoding's minimum-duration expansion of 3 classes, without
    resets or constraints."""
    rng = np.random.default_rng(seed)
    em3 = np.log(rng.dirichlet(np.ones(3), T)).astype(np.float32)
    em, tr, ini, _, _ = tv._expand_consecutive(
        em3, diag_trans_exp(0.7, 3), np.log(np.ones(3) / 3),
        np.zeros((T, 3)), np.asarray(consecutive))
    assert em.shape[1] == sum(consecutive)
    return (np.ascontiguousarray(em, np.float32), tr.astype(np.float32),
            ini.astype(np.float32), np.zeros(T, bool))


def constrained_case(K, T, seed=12):
    """The smoke's constrained decode at a small T: Dirichlet transitions,
    5% forbidden entries and mandatory frames applied as viterbi_decoding
    applies them, 0.1% resets."""
    rng = np.random.default_rng(seed)
    em = np.log(rng.dirichlet(np.ones(K), T)).astype(np.float32)
    tr = np.log(rng.dirichlet(np.ones(K) * 3, K)).astype(np.float32)
    em[rng.random((T, K)) < 0.05] = tv.LOG_ZERO
    for t, k in zip(rng.choice(T, T // 360 + 1, replace=False),
                    rng.integers(0, K, T // 360 + 1)):
        keep = em[t, k]
        em[t] = tv.LOG_ZERO
        em[t, k] = keep
    return em, tr, np.full(K, np.log(1.0 / K), np.float32), \
        rng.random(T) < 0.001


def dense_case(K, T, seed=13):
    """Random dense transitions (Dirichlet rows) and emissions, 0.1%
    resets: rows forget their entry within a few frames."""
    rng = np.random.default_rng(seed)
    return (np.log(rng.dirichlet(np.ones(K), T)).astype(np.float32),
            np.log(rng.dirichlet(np.ones(K) * 3, K)).astype(np.float32),
            np.full(K, np.log(1.0 / K), np.float32), rng.random(T) < 0.001)


def constant_case(K, T):
    """Score gaps that grow by 1e-5 a frame and never reach the transition
    cost, no reset: no chunk forgets its entry."""
    row = (np.log(1.0 / K) - 1e-5 * np.arange(K)).astype(np.float32)
    return (np.tile(row, (T, 1)), diag_trans_exp(0.7, K).astype(np.float32),
            np.full(K, np.log(1.0 / K), np.float32), np.zeros(T, bool))
