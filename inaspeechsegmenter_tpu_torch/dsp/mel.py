"""SIDEKIT triangular mel filterbank (host-side, setup time).

Numpy-only copy of ``htk_triangular_fbank`` from
``inaspeechsegmenter_tpu/dsp/mel.py`` (reference sidekit_mfcc.py:118-197
`trfbank`): HTK mel scale, triangular filters with 2/(hi-low) peak
normalization, assembled in FFT-bin space with the reference's floor/bin
conventions.  The Kaldi bank of the VBx frontend is not part of this slice.
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
