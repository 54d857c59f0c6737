"""Host-side SIDEKIT frontend: upload features, not audio.

Port of ``inaspeechsegmenter_tpu/dsp/host_fe.py``, numpy only: the same
features as the kernel frontend (``dsp/fe_kernel.py``) computed on the
host CPU (framing 400/160, per-frame pre-emphasis 0.97, log-energy after
pre-emphasis and before the window, Hann window, 512-point rFFT power
spectrum, 24 HTK mel bands, log), then copied to the device as float32
tensors: 100 bytes a frame instead of the 320 bytes of its int16 samples.
It wins only where the host-to-device link, not the card, bounds the
throughput; ``segmenter._default_frontend`` measures the link and picks
(``ISS_FRONTEND``).

Rows past the signal's frames up to ``pad_frames_to`` are ``-inf``, the
value the kernel frontend computes for all-zero padded frames.

It has no ``group_feats`` / ``iter_group_feats``: with it the online
segmenter buffers and segments the whole signal at once, and the VFS
scorer takes its serial route with its own VBx upload, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import upload
from .mel import htk_triangular_fbank
from .sidekit import HOP, NFFT, WIN, frame_count

try:                              # scipy's pocketfft, as the JAX package
    from scipy import fft as _sfft

    def _rfft(x, n):
        return _sfft.rfft(x, n=n, axis=-1)
except ImportError:               # pragma: no cover
    def _rfft(x, n):
        return np.fft.rfft(x, n=n, axis=-1)


def _float_signal(sig):
    """int16 scaled by 1/32768 (exact), any other dtype as float32."""
    sig = np.asarray(sig)
    if sig.dtype == np.int16:
        return sig.astype(np.float32) * np.float32(1 / 32768.0)
    return np.ascontiguousarray(sig, np.float32)


class HostSidekitFrontend:
    """The frontend with the heavy math on the host CPU: ``mspec_loge``
    returns float32 tensors on ``device``."""

    def __init__(self, device, lowfreq=100, maxfreq=8000, nlinfilt=0,
                 nlogfilt=24, fs=16000, prefac=0.97, nceps=13):
        self.device = torch.device(device)
        self.fs = fs
        self.prefac = np.float32(prefac)
        self.nceps = nceps
        self.nmel = nlinfilt + nlogfilt
        fbank, _ = htk_triangular_fbank(fs, NFFT, lowfreq, maxfreq,
                                        nlinfilt, nlogfilt)
        self.fbank_t = np.ascontiguousarray(fbank.T, np.float32)  # (257, nmel)
        self.window = np.hanning(WIN).astype(np.float32)

    def _features_np(self, sig):
        """float32 signal -> ((t, nmel) mspec, (t,) loge), both float32."""
        t = frame_count(len(sig))
        if t == 0:
            return (np.zeros((0, self.nmel), np.float32),
                    np.zeros(0, np.float32))
        frames = np.lib.stride_tricks.sliding_window_view(
            sig, WIN)[::HOP][:t]
        # per-frame pre-emphasis (first sample against itself), as one
        # vectorized subtract: frames - 0.97 * frames shifted right
        pre = np.empty((t, WIN), np.float32)
        np.multiply(frames[:, :-1], self.prefac, out=pre[:, 1:])
        pre[:, 0] = frames[:, 0] * self.prefac
        pre = frames - pre
        with np.errstate(divide="ignore"):
            loge = np.log(np.einsum("ij,ij->i", pre, pre,
                                    dtype=np.float32)).astype(np.float32)
            pre *= self.window
            spec = _rfft(pre, NFFT)
            spec = (spec.real * spec.real +
                    spec.imag * spec.imag).astype(np.float32)
            mspec = np.log(spec @ self.fbank_t)
        return mspec, loge

    def mspec_loge(self, sig, pad_frames_to=None, keep_pcm=False,
                   pinned=False):
        """Host signal -> (mspec (T', nmel), loge (T',), T) on the device,
        T' = max(T, ``pad_frames_to``) with ``-inf`` rows past T.

        The kernel frontend's call shape: ``keep_pcm`` adds a fourth item,
        always None (no samples are uploaded); ``pinned`` copies the
        features through pinned memory without waiting for the device's
        queue.
        """
        mspec, loge = self._features_np(_float_signal(sig))
        t = len(loge)
        want = t if pad_frames_to is None else max(t, pad_frames_to)
        if want > t:
            mspec = np.pad(mspec, ((0, want - t), (0, 0)),
                           constant_values=-np.inf)
            loge = np.pad(loge, (0, want - t), constant_values=-np.inf)
        mspec, loge = (
            upload(np.ascontiguousarray(a), self.device) if pinned
            else torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (mspec, loge))
        return (mspec, loge, t, None) if keep_pcm else (mspec, loge, t)

    def mspec_loge_np(self, sig):
        """Trimmed numpy (mspec, loge)."""
        return self._features_np(_float_signal(sig))

    def cepstra(self, mspec):
        from scipy.fftpack import dct
        return dct(np.asarray(mspec), type=2, norm="ortho",
                   axis=-1)[:, 1:self.nceps + 1]
