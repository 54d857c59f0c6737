"""SIDEKIT-flavor log-mel features: constants and the plain PyTorch version.

Same semantics as ``inaspeechsegmenter_tpu/dsp/sidekit.py`` (reference
sidekit_mfcc.py:200-352): 400-sample frames on a 160 hop, per-frame
pre-emphasis 0.97 (first sample against itself), log-energy after
pre-emphasis and before the window, symmetric Hann window
(``np.hanning``), a 512-point real DFT as two matmuls against the f32
cos/sin matrices, the power spectrum, 24 HTK mel bands 100-8000 Hz, and
``log``.  The constants come from the same numpy builders as the JAX
package's.

:func:`mspec_loge` here is the plain version, used on CPU tensors and as
the reference for the CUDA kernel in ``dsp/fe_kernel.py``, which is the
Segmenter's frontend.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .mel import htk_triangular_fbank

WIN = 400
HOP = 160
NFFT = 512
NBINS = NFFT // 2 + 1
NMEL = 24
PREFAC = 0.97
CHUNK = 4096  # frames per chunk: of the plain version's frame matrix and of
              # the streaming path (about 41 s of audio)


class FrontendConsts(NamedTuple):
    """Device-resident float32 constants of the frontend."""
    window: torch.Tensor     # (WIN,)  np.hanning
    dcos: torch.Tensor       # (WIN, NBINS)
    dsin: torch.Tensor       # (WIN, NBINS)
    fbank_t: torch.Tensor    # (NBINS, NMEL)
    twiddle: torch.Tensor    # (NFFT // 2, 2) exp(-2 pi i k / NFFT), FFT kernel
    band_range: torch.Tensor  # (NMEL, 2) int32 [first, last + 1) nonzero bins


def frame_count(n_samples: int) -> int:
    return (n_samples - WIN) // HOP + 1 if n_samples >= WIN else 0


def _dft_matrices(win=WIN, nfft=NFFT):
    """Real-input DFT as two (win, nfft//2+1) float32 matmul operands.

    X[k] = sum_{n<win} x[n] * exp(-2i*pi*n*k/nfft) — zero-padding to nfft is
    implicit in truncating the coefficient matrix to `win` rows.
    """
    n = np.arange(win)[:, None]
    k = np.arange(nfft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / nfft
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def _twiddles(nfft=NFFT):
    """exp(-2i*pi*k/nfft) for k < nfft/2, built in float64, as float32
    (re, im) rows: the FFT kernel's twiddles and split-step factors."""
    ang = -2.0 * np.pi * np.arange(nfft // 2) / nfft
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def _band_ranges(fbank):
    """(NMEL, 2) int32 [first, last + 1) of each band's nonzero bins."""
    out = np.zeros((fbank.shape[0], 2), np.int32)
    for m, row in enumerate(fbank):
        nz = np.flatnonzero(row)
        if nz.size:
            out[m] = nz[0], nz[-1] + 1
    return out


def frontend_consts(device, lowfreq=100, maxfreq=8000, fs=16000):
    fbank, _ = htk_triangular_fbank(fs, NFFT, lowfreq, maxfreq, 0, NMEL)
    dcos, dsin = _dft_matrices()
    arrays = (np.hanning(WIN).astype(np.float32), dcos, dsin,
              np.ascontiguousarray(fbank.T), _twiddles(), _band_ranges(fbank))
    return FrontendConsts(*(torch.from_numpy(a).to(device) for a in arrays))


def _chunk_feats(sig_slice, c: FrontendConsts):
    """((C+2)*HOP,) f32 samples -> ((C, NMEL) mspec, (C,) loge).

    Transcription of the JAX ``SidekitFrontend._chunk_feats``: frame i is
    rows i, i+1 and the first 80 samples of row i+2 of the (C+2, HOP) view.
    """
    nchunk = sig_slice.shape[0] // HOP - 2
    s2 = sig_slice.reshape(nchunk + 2, HOP)
    frames = torch.cat([s2[0:nchunk], s2[1:nchunk + 1],
                        s2[2:nchunk + 2, :WIN - 2 * HOP]], dim=1)  # (C, WIN)
    shifted = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    frames = frames - PREFAC * shifted
    loge = torch.log(torch.sum(frames * frames, dim=1))
    fw = frames * c.window
    re = fw @ c.dcos
    im = fw @ c.dsin
    spec = re * re + im * im                                      # (C, 257)
    return torch.log(spec @ c.fbank_t), loge


def to_float_signal(sig):
    """int16 PCM -> float32 by 1/32768 (exact), float -> float32."""
    if sig.dtype == torch.int16:
        return sig.to(torch.float32) * np.float32(1 / 32768.0)
    return sig.to(torch.float32)


def mspec_loge(sig, c: FrontendConsts):
    """Plain features of a 1-D f32/int16 signal tensor, on its device.

    :return: (mspec (T, NMEL), loge (T,)) float32, T = frame_count(n).
    """
    t = frame_count(sig.shape[0])
    x = to_float_signal(sig)
    need = (t + 2) * HOP
    x = torch.nn.functional.pad(x[:need], (0, max(0, need - x.shape[0])))
    ms, ls = [], []
    for f0 in range(0, t, CHUNK):
        n = min(CHUNK, t - f0)
        m, lg = _chunk_feats(x[f0 * HOP:(f0 + n + 2) * HOP], c)
        ms.append(m)
        ls.append(lg)
    if not ms:
        return (torch.empty((0, NMEL), dtype=torch.float32, device=sig.device),
                torch.empty((0,), dtype=torch.float32, device=sig.device))
    return torch.cat(ms), torch.cat(ls)
