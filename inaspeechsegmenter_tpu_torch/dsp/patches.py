"""Sliding-patch extraction + per-patch normalization, plain PyTorch.

Semantics of ``inaspeechsegmenter_tpu/dsp/patches.py`` (reference
segmenter.py:76-88): output frame j (one per 20 ms) reads the 68-row mel
window starting at row ``2 * clip(j - 17, 0, n_rows - 1)`` with
``n_rows = (T - 68) // 2 + 1``, normalized by its own mean and standard
deviation.  The clip reproduces the reference's replicate padding (17
copies of window 0 in front, the last valid window at the back).  The std
is the population std (``correction=0``), as ``jnp.std``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PATCH_W = 68
PATCH_STEP = 2
LPAD = PATCH_W // (2 * PATCH_STEP)  # 17


def n_rows_of(n_frames: int) -> int:
    """Number of valid stride-2 windows (at least 1: short media is padded
    to 68 frames before it gets here)."""
    return max((n_frames - PATCH_W) // PATCH_STEP + 1, 1)


def normalize_windows(flat):
    """(B, 68*nmel) windows -> (normalized, finite (B,) bool)."""
    mean = flat.mean(dim=1, keepdim=True)
    std = torch.std(flat, dim=1, correction=0, keepdim=True)
    norm = (flat - mean) / std
    return norm, torch.isfinite(norm).all(dim=1)


def windows_at(mspec, starts, nmel, max_start):
    """Windows at window indices ``starts`` (B,), all <= ``max_start`` (a
    host int, so no device sync) -> (B, 68*nmel).  Rows past the end of
    ``mspec`` read as zeros, as the JAX zero padding."""
    m = mspec[:, :nmel]
    need = PATCH_STEP * max_start + PATCH_W
    if need > m.shape[0]:
        m = F.pad(m, (0, 0, 0, need - m.shape[0]))
    rows = (PATCH_STEP * starts)[:, None] + torch.arange(
        PATCH_W, device=mspec.device)[None, :]
    return m[rows].reshape(starts.shape[0], PATCH_W * nmel)


def frame_patches(mspec, frames, n_frames, nmel):
    """Normalized patches of 20 ms output frames ``frames`` (B,) long.

    :return: (patches (B, 68, nmel), finite (B,) bool).
    """
    last = n_rows_of(n_frames) - 1
    r = (frames - LPAD).clamp(0, last)
    norm, fin = normalize_windows(windows_at(mspec, r, nmel, last))
    return norm.reshape(-1, PATCH_W, nmel), fin


def normalized_windows_ext(mspec, n_frames, nmel):
    """Every stride-2 window, normalized, with 17 replicate rows in front.

    Port of the JAX ``normalized_windows_ext``: output frame j's patch is
    row j of ``norm_ext`` for j <= n_rows + 16; frames past that use the
    also returned last valid window.

    :param mspec: (Tpad, >=nmel) with Tpad even.
    :return: (norm_ext (Tpad/2+17, 68*nmel), fin_ext (Tpad/2+17,),
              last_norm (1, 68*nmel), last_fin (1,), n_rows)
    """
    r_pad = mspec.shape[0] // 2
    norm, finite = normalize_windows(windows_at(
        mspec, torch.arange(r_pad, device=mspec.device), nmel, r_pad - 1))
    n_rows = n_rows_of(n_frames)
    norm_ext = torch.cat([norm[0:1].expand(LPAD, -1), norm])
    fin_ext = torch.cat([finite[0:1].expand(LPAD), finite])
    return (norm_ext, fin_ext, norm[n_rows - 1:n_rows],
            finite[n_rows - 1:n_rows], n_rows)
