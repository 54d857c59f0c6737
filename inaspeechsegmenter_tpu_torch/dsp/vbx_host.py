"""Host (numpy) VBx feature functions: the notebook and power-user mirror
of the device frontend.

Copy of ``inaspeechsegmenter_tpu/dsp/vbx_host.py`` (numpy only).  The
segmentation and VFS pipelines compute VBx features on the device
(:class:`~inaspeechsegmenter_tpu_torch.dsp.vbx.VbxFrontend`); these numpy
versions serve users of the reference's ``features_vbx`` /
``vbx_segmenter.get_features`` public functions (reference
features_vbx.py:12-160, vbx_segmenter.py:72-89), each reproducing the
reference math exactly, quirks included.  Held equal to the JAX
package's in tests/test_torch_reference_api.py.

The math lineage of ``fbank_htk`` / ``cmvn_floating_kaldi`` / ``add_dither``
is the BUT VBx feature code, carried here with its upstream attribution:

    Copyright Brno University of Technology (burget@fit.vutbr.cz)
    Licensed under the Apache License, Version 2.0 (the "License")
    From VBHMM x-vectors Diarization (aka VBx)
    https://github.com/BUTSpeechFIT/VBx/blob/master/VBx/features.py
"""

from __future__ import annotations

import numpy as np

from .mel import kaldi_mel_fbank
from .vbx import FEAT_DIM, SR, WIN, povey_window

__all__ = [
    "framing", "preemphasis", "add_dither", "fbank_htk",
    "cmvn_floating_kaldi", "get_features", "povey_window",
]


def framing(a, window, shift=1):
    """Overlapping frames of ``a`` along axis 0, shape (n, window, ...).

    Returns a writable copy: the reference's as_strided result is
    writable (notebook code mutates frames in place) while a
    sliding_window_view is read-only."""
    view = np.lib.stride_tricks.sliding_window_view(a, window, axis=0)
    # the window axis comes last in sliding_window_view; the VBx layout
    # wants it right after the frame axis
    out = (np.moveaxis(view, -1, 1)[::shift] if a.ndim > 1
           else view[::shift])
    return out.copy()


def preemphasis(x, coef=0.97):
    return x - np.concatenate([x[..., :1], x[..., :-1]], axis=-1) * coef


def add_dither(x, level=8):
    """HTK-style dither from numpy's GLOBAL RNG (the reference seeds
    ``np.random.seed(3)`` before calling this, vbx_segmenter.py:84)."""
    return x + level * (np.random.rand(*x.shape) * 2 - 1)


def fbank_htk(x, window, noverlap, fbank_mx, nfft=None, _E=None,
              USEPOWER=False, RAWENERGY=True, PREEMCOEF=0.97,
              ZMEANSOURCE=False, ENORMALISE=True, ESCALE=0.1, SILFLOOR=50.0,
              USEHAMMING=True):
    """HTK-style log mel-filterbank outputs, (n_frames, NUMCHANS [+1]).

    Full option surface of the reference ``fbank_htk``
    (features_vbx.py:62-120): optional raw/windowed log-energy column
    (``_E`` = 'first' / 'last' / None) with HTK energy normalisation and
    silence floor, ZMEANSOURCE per-frame mean removal, pre-emphasis,
    magnitude-vs-power control via USEPOWER.
    """
    if np.isscalar(window):
        window = np.hamming(window) if USEHAMMING else np.ones(window)
    window = np.asarray(window)
    if nfft is None:
        nfft = 2 ** int(np.ceil(np.log2(window.size)))

    frames = framing(np.asarray(x).astype("float"), window.size,
                     window.size - noverlap).copy()
    if ZMEANSOURCE:
        frames -= frames.mean(axis=1, keepdims=True)
    energy = None
    if _E is not None and RAWENERGY:
        energy = np.log((frames ** 2).sum(axis=1))
    if PREEMCOEF is not None:
        frames = preemphasis(frames, PREEMCOEF)
    frames *= window
    if _E is not None and not RAWENERGY:
        energy = np.log((frames ** 2).sum(axis=1))

    spec = np.fft.rfft(frames, nfft)
    power = spec.real ** 2 + spec.imag ** 2
    p = USEPOWER + 1 if isinstance(USEPOWER, bool) else USEPOWER
    if p != 2:
        power **= 0.5 * p
    fea = np.log(np.maximum(1.0, np.dot(power, fbank_mx)))

    if energy is None:
        return fea
    if ENORMALISE:
        energy = (energy - energy.max()) * ESCALE + 1.0
        floor = -np.log(10 ** (SILFLOOR / 10.0)) * ESCALE + 1.0
        energy[energy < floor] = floor
    cols = [fea]
    if _E == "first":
        cols.insert(0, energy[:, np.newaxis])
    elif _E in ("last", True):
        cols.append(energy[:, np.newaxis])
    return np.hstack(cols)


def cmvn_floating_kaldi(x, LC, RC, norm_vars=True):
    """Kaldi-style floating-window mean (and variance) normalization:
    LC/RC frames of left/right context, windows shifted (not shrunk) at
    the edges, global stats when the file is shorter than the window
    (reference features_vbx.py:131-160)."""
    n, dim = x.shape
    win_len = min(n, LC + RC + 1)
    win_start = np.clip(np.arange(-LC, n - LC), 0, n - win_len)
    csum = np.vstack([np.zeros((1, dim)), np.cumsum(x, axis=0)])
    x = x - (csum[win_start + win_len] - csum[win_start]) / win_len
    if norm_vars:
        csq = np.vstack([np.zeros((1, dim)), np.cumsum(x ** 2, axis=0)])
        x = x / np.sqrt((csq[win_start + win_len] - csq[win_start]) / win_len)
    return x


def get_features(signal, LC=150, RC=149):
    """float 16 kHz signal -> (T, 64) CMVN'd VBx features; the reference's
    ``vbx_segmenter.get_features`` (vbx_segmenter.py:72-89), including the
    global ``np.random.seed(3)`` dither reproducibility convention."""
    noverlap = 240
    window = povey_window(WIN)
    fbank_mx = kaldi_mel_fbank(WIN, SR, numchans=FEAT_DIM, lofreq=20.0,
                               hifreq=7600, htk_bug=False)
    np.random.seed(3)
    sig = add_dither((np.asarray(signal) * 2 ** 15).astype(int))
    seg = np.r_[sig[noverlap // 2 - 1::-1], sig, sig[-1:-WIN // 2 - 1:-1]]
    fea = fbank_htk(seg, window, noverlap, fbank_mx, USEPOWER=True,
                    ZMEANSOURCE=True)
    return cmvn_floating_kaldi(fea, LC, RC, norm_vars=False).astype(np.float32)
