"""Mel filterbanks (host-side, setup time).

Numpy-only copies from ``inaspeechsegmenter_tpu/dsp/mel.py``:
``htk_triangular_fbank`` (reference sidekit_mfcc.py:118-197 `trfbank`:
HTK mel scale, triangular filters with 2/(hi-low) peak normalization,
assembled in FFT-bin space with the reference's floor/bin conventions) for
the SIDEKIT frontend, and ``kaldi_mel_fbank`` (reference features_vbx.py
`mel_fbank_mx`) for the VBx frontend of the VFS pipeline.
"""

from __future__ import annotations

import numpy as np


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def htk_triangular_fbank(fs, nfft, lowfreq, maxfreq, nlinfilt, nlogfilt,
                         midfreq=1000):
    """SIDEKIT-compatible triangular filterbank.

    Returns (fbank, edge_frequencies) where fbank has shape
    (nlinfilt+nlogfilt, nfft//2+1), dtype float32 — numerically identical to
    the reference `trfbank` output for every branch.
    """
    nfilt = nlinfilt + nlogfilt
    freqs = np.zeros(nfilt + 2, dtype=np.float32)

    if nlogfilt == 0:
        linsc = (maxfreq - lowfreq) / (nlinfilt + 1)
        freqs[: nlinfilt + 2] = lowfreq + np.arange(nlinfilt + 2) * linsc
    elif nlinfilt == 0:
        low_mel = hz_to_mel_htk(lowfreq)
        max_mel = hz_to_mel_htk(maxfreq)
        melsc = (max_mel - low_mel) / (nfilt + 1)
        mels = low_mel + np.arange(nlogfilt + 2) * melsc
        # float64 edge frequencies in this branch (reference quirk: the
        # float32 `frequences` array is replaced wholesale, sidekit_mfcc.py:151)
        freqs = mel_to_hz_htk(mels)
    else:
        # hybrid: linear filters below midfreq, mel-spaced above, with the
        # reference's rebalancing loop that converts log filters to linear
        # ones while the first mel step is narrower than the linear step
        # (sidekit_mfcc.py:163-171).
        linsc = (min(midfreq, maxfreq) - lowfreq) / (nlinfilt + 1)
        freqs[:nlinfilt] = lowfreq + np.arange(nlinfilt) * linsc
        low_mel = hz_to_mel_htk(min(1000, maxfreq))
        max_mel = hz_to_mel_htk(maxfreq)
        mels = np.zeros(nlogfilt + 2, dtype=np.float32)
        melsc = (max_mel - low_mel) / (nlogfilt + 1)
        while mel_to_hz_htk(melsc) < linsc:
            nlinfilt += 1
            nlogfilt -= 1
            freqs[:nlinfilt] = lowfreq + np.arange(nlinfilt) * linsc
            low_mel = hz_to_mel_htk(freqs[nlinfilt - 1] + 2 * linsc)
            max_mel = hz_to_mel_htk(maxfreq)
            mels = np.zeros(nlogfilt + 2, dtype=np.float32)
            melsc = (max_mel - low_mel) / (nlogfilt + 1)
        mels[: nlogfilt + 2] = low_mel + np.arange(nlogfilt + 2) * melsc
        freqs[nlinfilt:] = mel_to_hz_htk(mels)

    heights = 2.0 / (freqs[2:] - freqs[:-2])

    fbank = np.zeros((nfilt, nfft // 2 + 1), dtype=np.float32)
    fft_freqs = np.arange(nfft) / (1.0 * nfft) * fs

    for i in range(nfilt):
        low, cen, hi = freqs[i], freqs[i + 1], freqs[i + 2]
        lid = np.arange(np.floor(low * nfft / fs) + 1,
                        np.floor(cen * nfft / fs) + 1, dtype=np.int32)
        rid = np.arange(np.floor(cen * nfft / fs) + 1,
                        min(np.floor(hi * nfft / fs) + 1, nfft), dtype=np.int32)
        left_slope = heights[i] / (cen - low)
        right_slope = heights[i] / (hi - cen)
        fbank[i, lid] = left_slope * (fft_freqs[lid] - low)
        fbank[i, rid[:-1]] = right_slope * (hi - fft_freqs[rid[:-1]])

    return fbank, freqs


def mel_kaldi(x):
    return 1127.0 * np.log(1.0 + np.asarray(x, dtype=np.float64) / 700.0)


def mel_inv_kaldi(x):
    return (np.exp(np.asarray(x, dtype=np.float64) / 1127.0) - 1.0) * 700.0


def kaldi_mel_fbank(winlen_nfft, fs, numchans=20, lofreq=0.0, hifreq=None,
                    htk_bug=True):
    """VBx/Kaldi-compatible mel filterbank, shape (nfft//2+1, numchans).

    Numerically identical to the reference `mel_fbank_mx`
    (features_vbx.py:31-59), including the integer center-bin layout and the
    optional HTK first-bin zeroing bug.
    """
    hifreq = 0.5 * fs if not hifreq else hifreq
    if winlen_nfft > 0:
        nfft = 2 ** int(np.ceil(np.log2(winlen_nfft)))
    else:
        nfft = -int(winlen_nfft)

    fbin_mel = mel_kaldi(np.arange(nfft / 2 + 1, dtype=float) * fs / nfft)
    cbin_mel = np.linspace(mel_kaldi(lofreq), mel_kaldi(hifreq), numchans + 2)
    cind = np.floor(mel_inv_kaldi(cbin_mel) / fs * nfft).astype(int) + 1
    mfb = np.zeros((len(fbin_mel), numchans))
    for i in range(numchans):
        mfb[cind[i]: cind[i + 1], i] = (
            (cbin_mel[i] - fbin_mel[cind[i]: cind[i + 1]])
            / (cbin_mel[i] - cbin_mel[i + 1])
        )
        mfb[cind[i + 1]: cind[i + 2], i] = (
            (cbin_mel[i + 2] - fbin_mel[cind[i + 1]: cind[i + 2]])
            / (cbin_mel[i + 2] - cbin_mel[i + 1])
        )
    if lofreq > 0.0 and float(lofreq) / fs * nfft + 0.5 > cind[0] and htk_bug:
        mfb[cind[0], :] = 0.0
    return mfb


def hz_to_mel_slaney(f):
    """Slaney's mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    brkfrq = 1000.0
    brkpt = brkfrq / f_sp
    logstep = np.exp(np.log(6.4) / 27.0)
    return np.where(f < brkfrq, f / f_sp,
                    brkpt + np.log(np.maximum(f, 1e-30) / brkfrq)
                    / np.log(logstep))


def mel_to_hz_slaney(z):
    """The inverse of :func:`hz_to_mel_slaney`."""
    z = np.asarray(z, dtype=np.float64)
    f_sp = 200.0 / 3.0
    brkfrq = 1000.0
    brkpt = brkfrq / f_sp
    logstep = np.exp(np.log(6.4) / 27.0)
    return np.where(z < brkpt, f_sp * z,
                    brkfrq * np.exp(np.log(logstep) * (z - brkpt)))
