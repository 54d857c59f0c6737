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
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build

K_MAX = 3


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


def viterbi_scan(emission, transition, initial, reset):
    """emission (T, K) f32, transition (K, K), initial (K,), reset (T,) bool
    (reset[0] is forced true) -> states (T,) int32 on the same device.

    On CUDA the kernel spreads chunks of the sequence over a cooperative
    grid of one block per SM; :func:`pass_count` and :func:`walked_chunks`
    describe the last launch.
    """
    if emission.device.type == "cpu":
        return viterbi_scan_plain(emission, transition, initial, reset)
    if emission.device.type != "cuda":
        raise ValueError(f"unsupported device {emission.device}")
    dev = emission.device
    if emission.dim() != 2 or emission.dtype != torch.float32:
        raise ValueError(f"emission must be (T, K) float32, got "
                         f"{emission.dtype} {tuple(emission.shape)}")
    T, K = emission.shape
    if not 1 <= K <= K_MAX:
        raise ValueError(f"the Viterbi kernel takes 1..{K_MAX} states, got {K}")
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
    viterbi_scan.last_ctl = ctl
    return states


viterbi_scan.launches = 0
viterbi_scan.last_ctl = None


def pass_count():
    """Forward passes of the last kernel launch (the speculative one
    included), a plain int; waits for that launch to finish."""
    ctl = viterbi_scan.last_ctl
    return None if ctl is None else int(ctl[3].item())


def walked_chunks():
    """Chunks that the last launch's serial walk re-ran (0 when its passes
    converged), a plain int; waits for that launch to finish."""
    ctl = viterbi_scan.last_ctl
    return None if ctl is None else int(ctl[4].item())


def viterbi_path(emission, transition, initial=None, reset=None):
    """Most probable state path, with optional independent-segment resets.

    :param emission: (T, K) log-emissions (array-like or tensor).
    :param transition: (K, K) log-transitions.
    :param initial: optional (K,) log-initial; defaults to uniform.
    :param reset: optional (T,) bool; True at frames that start a new
        independent segment (frame 0 is always a segment start).
    :return: (T,) int32 state tensor on the emission's device (the CPU
        for array-likes).
    """
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
