"""The reference's import path ``inaSpeechSegmenter.sidekit_mfcc``:
``mfcc(sig, get_mspec=True)``, the notebook entry to its feature frontend
(reference sidekit_mfcc.py:278-352, returning ``[ceps, loge, spec,
mspec]``), and its helpers.  A numpy copy of the JAX package's module; the
segmentation pipeline computes its features with the CUDA kernel
(``dsp/fe_kernel.py``).

The reference's semantics: no-pad framing, per-frame pre-emphasis (the
first sample against itself), log-energy after the pre-emphasis and
before the window, a Hann window, the 2^ceil(log2(win)) rFFT power
spectrum, HTK-mel triangular filters, ``mspec = log(spec @ fbank.T)``,
DCT-II ortho cepstra 1..nceps.
"""

from __future__ import annotations

import numpy as np

from .dsp.mel import (htk_triangular_fbank, hz_to_mel_slaney,
                      mel_to_hz_slaney)


def hz2mel(f, htk=True):
    if htk:
        return 2595 * np.log10(1 + np.asarray(f) / 700.0)
    # Slaney scale (reference sidekit_mfcc.py:60-84), incl. the scalar
    # squeeze for shape-(1,) inputs
    z = hz_to_mel_slaney(f)
    return z[0] if z.shape == (1,) else z


def mel2hz(z, htk=True):
    if htk:
        return 700.0 * (10.0 ** (np.asarray(z) / 2595.0) - 1)
    f = mel_to_hz_slaney(z)
    return f[0] if f.shape == (1,) else f


def pre_emphasis(input_sig, pre):
    """First-order pre-emphasis filter (reference sidekit_mfcc.py:85-95):
    each sample minus `pre` times the previous one, first sample kept."""
    x = np.asarray(input_sig)
    shifted = np.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    return x - shifted * pre


def framing(sig, win_size, win_shift=1, context=(0, 0), pad='zeros'):
    """Overlapping analysis frames with optional context padding
    (reference sidekit_mfcc.py:98-116): mono input -> (n, win+context),
    multi-channel -> (n, win+context, channels)."""
    sig = np.asarray(sig)
    if sig.ndim == 1:
        sig = sig[:, None]
    n = (sig.shape[0] - win_size) // win_shift + 1
    mode = {"zeros": "constant", "edge": "edge"}[pad]
    padded = np.pad(sig, (context,) + (sig.ndim - 1) * ((0, 0),), mode)
    view = np.lib.stride_tricks.sliding_window_view(
        padded, win_size + sum(context), axis=0)
    frames = np.moveaxis(view, -1, 1)[::win_shift][:n]
    # the reference squeezes every unit axis (mono channel AND a single
    # frame): framing(sig400, 400) -> (400,), not (1, 400).  Copy: the
    # reference's as_strided result is writable (notebook code mutates
    # frames in place); a sliding_window_view is read-only
    return frames[:, None].squeeze().copy()


def trfbank(fs, nfft, lowfreq, maxfreq, nlinfilt, nlogfilt, midfreq=1000):
    """SIDEKIT triangular filterbank -> (fbank, edge_frequencies)
    (reference sidekit_mfcc.py:118-197; see dsp/mel.py for the quirks
    reproduced)."""
    return htk_triangular_fbank(fs, nfft, lowfreq, maxfreq,
                                nlinfilt, nlogfilt, midfreq)


def power_spectrum(input_sig, fs=8000, win_time=0.025, shift=0.01,
                   prefac=0.97):
    """(spec, log_energy) with the reference's exact frame semantics
    (reference sidekit_mfcc.py:200-237).  The input dtype is preserved for
    the frame math — the reference computes at float64 when fed the
    io.media2sig16kmono default float64 signal and only the spectrum is
    stored as float32 (its PARAM_TYPE)."""
    sig = np.asarray(input_sig)
    win = int(round(win_time * fs))
    hop = int(shift * fs)
    n = (len(sig) - win) // hop + 1
    if n < 1:
        raise ValueError(
            f"signal too short for one {win}-sample analysis window")
    idx = np.arange(win)[None, :] + hop * np.arange(n)[:, None]
    framed = sig[idx]
    # per-frame pre-emphasis: first sample against itself
    framed = framed - prefac * np.concatenate(
        [framed[:, :1], framed[:, :-1]], axis=1)
    log_energy = np.log((framed ** 2).sum(axis=1))
    n_fft = 2 ** int(np.ceil(np.log2(win)))
    mag = np.fft.rfft(framed * np.hanning(win), n_fft, axis=-1)
    return (mag.real ** 2 + mag.imag ** 2).astype(np.float32), log_energy


def mfcc(input_sig, lowfreq=100, maxfreq=8000, nlinfilt=0, nlogfilt=24,
         nwin=0.025, fs=16000, nceps=13, shift=0.01, get_spec=False,
         get_mspec=False, prefac=0.97):
    """Reference-signature MFCC convenience entry
    -> ``[ceps, loge, spec | None, mspec | None]``."""
    from scipy.fftpack import dct

    spec, log_energy = power_spectrum(input_sig, fs, win_time=nwin,
                                      shift=shift, prefac=prefac)
    win = int(round(nwin * fs))
    n_fft = 2 ** int(np.ceil(np.log2(win)))
    fbank, _ = htk_triangular_fbank(fs, n_fft, lowfreq, maxfreq,
                                    nlinfilt, nlogfilt)
    mspec = np.log(np.dot(spec, fbank.T))
    ceps = dct(mspec, type=2, norm="ortho", axis=-1)[:, 1:nceps + 1]
    return [ceps, log_energy,
            spec if get_spec else None,
            mspec if get_mspec else None]
