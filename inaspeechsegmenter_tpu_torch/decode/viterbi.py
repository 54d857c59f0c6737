"""Log-domain Viterbi decoding with segment resets.

Semantics of ``inaspeechsegmenter_tpu/decode/viterbi.py::_viterbi_scan``:
one full-sequence decode in which a per-frame ``reset`` flag starts an
independent segment (the recursion restarts from ``initial`` and the
backtrack restarts from that segment's own final argmax) — exactly the
reference's decode of each segment on its own.  Scores are renormalized
(running max subtracted) every frame.

:func:`viterbi_scan` launches the CUDA kernel ``csrc/viterbi.cu`` for CUDA
tensors (its source comment says what bounds it, how its chunk-parallel
design stays exact and how it is built) and runs :func:`viterbi_scan_plain`,
a frame loop in numpy float32 with the same operations in the same order,
for CPU tensors.  States are bit-equal between the two and to the JAX scan.
That kernel takes K <= 3 states; :func:`viterbi_scan` sends more states to
:func:`viterbi_scan_general`, the wrapper of the general-K kernel in the
same source (a values-only chain, chunk-parallel where the rows converge).

:func:`viterbi_decoding` is the reference's constrained API (initial,
minimum durations by state duplication, forbidden / mandatory frames;
``inaspeechsegmenter_tpu/decode/viterbi.py:303-383``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import resolve_device

K_MAX = 3            # states of the chunk-parallel kernel
K_GENERAL_MAX = 8192  # states of the general-K kernel
CHUNK_MIN = 16       # csrc/viterbi.cu's: frames a chunk, at least (asked)
GK_WARPS = 8         # csrc/viterbi.cu's: warp teams a block, K <= 32

VITERBI_CONSTRAINT_NONE = 0
VITERBI_CONSTRAINT_FORBIDDEN = 1
VITERBI_CONSTRAINT_MANDATORY = 2

LOG_ZERO = float(np.log(1e-200))

_LAST = {"ctl": None}   # the ctl words of the last launch of either kernel


def viterbi_scan_plain(emission, transition, initial, reset):
    """Frame loop over host values -> (T,) int32 states on emission's device."""
    em = emission.detach().cpu().numpy().astype(np.float32, copy=False)
    tr = transition.detach().cpu().numpy().astype(np.float32, copy=False)
    ini = initial.detach().cpu().numpy().astype(np.float32, copy=False)
    rs = reset.detach().cpu().numpy().astype(bool)
    T, K = em.shape
    idstates = np.arange(K)
    ptrs = np.empty((T, K), np.int64)
    amax = np.empty(T, np.int64)
    v = np.zeros(K, np.float32)
    # a frame whose scores are all -inf gives NaN, which the scan carries too
    # (max propagates NaN, argmax picks the first NaN)
    with np.errstate(invalid="ignore"):
        for t in range(T):
            tmp = v[:, None] + tr                  # tmp[k, k'] = v[k] + tr
            if rs[t] or t == 0:
                v_new = em[t] + ini
                ptrs[t] = idstates
            else:
                v_new = em[t] + tmp.max(axis=0)
                ptrs[t] = tmp.argmax(axis=0)
            v = v_new - v_new.max()                # renormalize
            amax[t] = v.argmax()
    states = np.empty(T, np.int32)
    x = 0
    for t in range(T - 1, -1, -1):
        seg_end = t == T - 1 or rs[t + 1]
        x = amax[t] if seg_end else ptrs[t + 1][x]
        states[t] = x
    return torch.from_numpy(states).to(emission.device)


def _max_blocks(dev):
    """Blocks of the kernel's cooperative grid: one per SM, at most 256."""
    return min(256, torch.cuda.get_device_properties(dev).multi_processor_count)


def _check_args(emission, transition, initial, reset, k_max):
    """Raise unless the four tensors are what the kernels take."""
    if emission.device.type != "cuda":
        raise ValueError(f"unsupported device {emission.device}")
    dev = emission.device
    if emission.dim() != 2 or emission.dtype != torch.float32:
        raise ValueError(f"emission must be (T, K) float32, got "
                         f"{emission.dtype} {tuple(emission.shape)}")
    T, K = emission.shape
    if not 1 <= K <= k_max:
        raise ValueError(f"the Viterbi kernel takes 1..{k_max} states, got {K}")
    for name, t, shape, dtype in (
            ("emission", emission, (T, K), torch.float32),
            ("transition", transition, (K, K), torch.float32),
            ("initial", initial, (K,), torch.float32),
            ("reset", reset, (T,), torch.bool)):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {dtype} {shape} tensor on "
                f"{dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def viterbi_scan(emission, transition, initial, reset):
    """emission (T, K) f32, transition (K, K), initial (K,), reset (T,) bool
    (reset[0] is forced true) -> states (T,) int32 on the same device.

    On CUDA, K <= 3 runs the chunk-parallel kernel, which spreads chunks of
    the sequence over a cooperative grid of one block per SM
    (:func:`pass_count` and :func:`walked_chunks` describe the last
    launch of either kernel); K > 3 runs :func:`viterbi_scan_general`.
    """
    if emission.device.type == "cpu":
        return viterbi_scan_plain(emission, transition, initial, reset)
    if emission.dim() == 2 and emission.shape[1] > K_MAX:
        return viterbi_scan_general(emission, transition, initial, reset)
    _check_args(emission, transition, initial, reset, K_MAX)
    dev = emission.device
    T, K = emission.shape
    states = torch.empty((T,), dtype=torch.int32, device=dev)
    if T == 0:
        return states
    # the kernel reads 8 frames at a time in 16-byte pieces
    if emission.data_ptr() % 16:
        emission = emission.clone()
    if reset.data_ptr() % 8:
        reset = reset.clone()
    blocks = _max_blocks(dev)
    groups = -(-T // 8)
    vbuf = torch.empty((groups, 4), dtype=torch.float32, device=dev)
    code = torch.empty((8 * groups,), dtype=torch.uint8, device=dev)
    exits = torch.empty((3, min(T, 256 * blocks), 4), dtype=torch.float32,
                        device=dev)
    ctl = torch.empty((5 + blocks,), dtype=torch.int32, device=dev)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        rc = lib.iss_viterbi(
            emission.data_ptr(), reset.data_ptr(), transition.data_ptr(),
            initial.data_ptr(), T, K, blocks, vbuf.data_ptr(),
            code.data_ptr(), exits.data_ptr(), ctl.data_ptr(),
            states.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch("viterbi", rc)
    cuda_build.count_launch(viterbi_scan)
    viterbi_scan.last_ctl = _LAST["ctl"] = ctl
    return states


viterbi_scan.launches = 0
viterbi_scan.last_ctl = None


def general_plan(T, K, blocks):
    """The general-K kernel's chunks on ``blocks`` blocks (one per SM) ->
    (chunks asked, frames a chunk L, chunks P = ceil(T / L)).  A chunk has
    one team: a warp for K <= 32 (``GK_WARPS`` a block), else a block."""
    teams = blocks * (GK_WARPS if K <= 32 else 1)
    asked = max(1, min(teams, -(-T // CHUNK_MIN)))
    L = -(-T // asked)
    return asked, L, -(-T // L)


def viterbi_scan_general(emission, transition, initial, reset):
    """:func:`viterbi_scan` at any K (1..``K_GENERAL_MAX``): the general-K
    kernel for CUDA tensors, and :func:`viterbi_scan_plain` for CPU
    tensors.  The kernel runs a values-only forward chain, chunk-parallel
    where the rows converge and a serial walk where they do not, then the
    back-pointers off the chain and a backtrack by map composition, all in
    one cooperative launch (``csrc/viterbi.cu``).  Has its own launch count;
    :func:`pass_count` and :func:`walked_chunks` describe its last launch
    when it was the last of the two kernels to run.
    """
    if emission.device.type == "cpu":
        return viterbi_scan_plain(emission, transition, initial, reset)
    _check_args(emission, transition, initial, reset, K_GENERAL_MAX)
    dev = emission.device
    T, K = emission.shape
    states = torch.empty((T,), dtype=torch.int32, device=dev)
    if T == 0:
        return states
    blocks = _max_blocks(dev)
    _, L, P = general_plan(T, K, blocks)
    index = torch.uint8 if K <= 256 else torch.int16
    rows = torch.empty((T, K), dtype=torch.float32, device=dev)
    exits = torch.empty((3, P, K), dtype=torch.float32, device=dev)
    maps = torch.empty((T, K), dtype=index, device=dev)
    sums = torch.empty((P, K), dtype=index, device=dev)
    xb = torch.empty((P,), dtype=torch.int32, device=dev)
    ctl = torch.empty((16,), dtype=torch.int32, device=dev)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        rc = lib.iss_viterbi_general(
            emission.data_ptr(), reset.data_ptr(), transition.data_ptr(),
            initial.data_ptr(), T, K, L, blocks, rows.data_ptr(),
            exits.data_ptr(), maps.data_ptr(), sums.data_ptr(),
            xb.data_ptr(), ctl.data_ptr(), states.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch("viterbi_general", rc)
    cuda_build.count_launch(viterbi_scan_general)
    viterbi_scan_general.last_ctl = _LAST["ctl"] = ctl
    return states


viterbi_scan_general.launches = 0
viterbi_scan_general.last_ctl = None


def pass_count():
    """Forward passes of the last Viterbi kernel launch (the speculative
    one included), a plain int; waits for that launch to finish."""
    ctl = _LAST["ctl"]
    return None if ctl is None else int(ctl[3].item())


def walked_chunks():
    """Chunks that the last launch's serial walk re-ran (0 when its passes
    converged), a plain int; waits for that launch to finish."""
    ctl = _LAST["ctl"]
    return None if ctl is None else int(ctl[4].item())


# the JAX package's decode modes; each is decoded here with the exact scan
_PARALLEL_MODES = (False, True, "scan", "parallel", "blocked")


def viterbi_path(emission, transition, initial=None, reset=None,
                 parallel=False):
    """Most probable state path, with optional independent-segment resets.

    :param emission: (T, K) log-emissions (array-like or tensor).
    :param transition: (K, K) log-transitions.
    :param initial: optional (K,) log-initial; defaults to uniform.
    :param reset: optional (T,) bool; True at frames that start a new
        independent segment (frame 0 is always a segment start).
    :param parallel: the JAX package's mode argument (False, True,
        ``'scan'``, ``'parallel'`` or ``'blocked'``); any other value
        raises ``KeyError`` as there.  Every mode runs the exact decode,
        whose states equal the JAX ``'scan'`` decode's.
    :return: (T,) int32 state tensor on the emission's device (the CPU
        for array-likes).
    """
    if parallel not in _PARALLEL_MODES:
        raise KeyError(parallel)
    device = (emission.device if isinstance(emission, torch.Tensor)
              else torch.device("cpu"))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)
                               if not isinstance(a, torch.Tensor) else a,
                               dtype=torch.float32, device=device).contiguous()

    emission = f32(emission)
    T, K = emission.shape
    transition = f32(transition)
    initial = (f32(np.full((K,), np.log(1.0 / K), np.float32))
               if initial is None else f32(initial))
    if reset is None:
        reset = torch.zeros((T,), dtype=torch.bool, device=device)
    else:
        reset = torch.as_tensor(reset, device=device).to(torch.bool).clone()
    if T:
        reset[0] = True
    return viterbi_scan(emission, transition, initial, reset.contiguous())


# -- the reference's constrained API (pyannote_viterbi.py:118-224) ------------

def _expand_consecutive(emission, transition, initial, constraint,
                        consecutive):
    """Minimum-consecutive-state constraints by state duplication: state i
    becomes C[i] chained sub-states; entering i lands on the first, each
    advances to the next, and only the last may leave (the JAX package's
    ``_expand_consecutive``, pyannote_viterbi.py:51-115)."""
    K = len(consecutive)
    new_k = int(np.sum(consecutive))
    bounds = np.concatenate([[0], np.cumsum(consecutive)])
    start, end = bounds[:-1], bounds[1:] - 1

    new_t = np.full((new_k, new_k), LOG_ZERO)
    for i in range(1, new_k):
        new_t[i - 1, i] = 0.0  # log(1): forced advance within the chain
    for i in range(K):
        for j in range(K):
            new_t[end[i], start[j]] = transition[i, j]

    new_i = np.full((new_k,), LOG_ZERO)
    new_i[start] = initial

    col_of = np.concatenate([np.full(c, i) for i, c in enumerate(consecutive)])
    return (emission[:, col_of], new_t, new_i, constraint[:, col_of],
            col_of)


def viterbi_decoding(emission, transition, initial=None, consecutive=None,
                     constraint=None, reset=None, *, device="cuda"):
    """(Constrained) Viterbi decoding with the reference signature
    (pyannote_viterbi.py:118-144) plus ``reset``.

    :param emission: (T, K) log-probabilities.
    :param transition: (K, K) log-transitions.
    :param initial: optional (K,) log-initial; uniform by default.
    :param consecutive: minimum duration, an int or one per state.
    :param constraint: optional (T, K) 0 none / 1 forbidden / 2 mandatory.
    :param reset: optional (T,) bool, independent segments (the fused
        decode's).
    :param device: where the decode runs, ``cuda`` by default (K > 3 after
        the duplication takes the general-K kernel).
    :return: numpy int (T,) most probable states.
    """
    emission = np.asarray(emission, dtype=np.float32)
    T, K = emission.shape
    if consecutive is None:
        consecutive = np.ones((K,), dtype=int)
    elif np.isscalar(consecutive):
        consecutive = int(consecutive) * np.ones((K,), dtype=int)
    else:
        consecutive = np.array(consecutive, dtype=int).reshape((K,))
    consecutive = np.maximum(1, consecutive)
    if initial is None:
        initial = np.log(np.ones((K,)) / K)
    else:
        initial = np.asarray(initial, dtype=np.float64)
    if constraint is None:
        constraint = np.zeros((T, K))
    constraint = np.asarray(constraint)
    transition = np.asarray(transition, dtype=np.float64)

    expand = bool(np.any(consecutive > 1))
    if expand:
        emission, transition, initial, constraint, col_of = \
            _expand_consecutive(emission, transition, initial, constraint,
                                consecutive)
    # forbidden / mandatory frames through the emissions
    emission = np.array(emission, dtype=np.float32, copy=True)
    emission[constraint == VITERBI_CONSTRAINT_FORBIDDEN] = LOG_ZERO
    mand_t, mand_k = np.where(constraint == VITERBI_CONSTRAINT_MANDATORY)
    for t, k in zip(mand_t, mand_k):
        keep = emission[t, k]
        emission[t, :] = LOG_ZERO
        emission[t, k] = keep

    dev = resolve_device(device)
    states = viterbi_path(torch.from_numpy(emission).to(dev), transition,
                          initial, reset).cpu().numpy()
    return col_of[states] if expand else states
