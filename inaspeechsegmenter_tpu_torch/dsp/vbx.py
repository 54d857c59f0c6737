"""VBx/Kaldi-flavor 64-band log-mel frontend for x-vector extraction.

Port of the reference-exact float32 path of
``inaspeechsegmenter_tpu/dsp/vbx.py`` (reference vbx_segmenter.py:72-89
`get_features` + features_vbx.py).  The host does what depends on the RNG,
in float64 numpy exactly as the JAX package does: int16 scaling and
truncation, dither from ``np.random.RandomState(3)``, and the mirror pad
(120 samples in front, 200 behind).  Everything after runs as plain
PyTorch on the frontend's device:

- framing (400 window, 160 hop) from the (T+2, 160) row view;
- ZMEANSOURCE, the per-frame mean removed;
- pre-emphasis 0.97, the first sample against itself;
- the Povey window (Hann^0.85 over ``linspace(0, 2*pi, 400)``);
- the 512-point power spectrum as two float32 matmuls, TF32 off
  (``models.layers.precision_scope("highest")``);
- ``log(max(1, spec @ fbank))`` with a 64-channel 20-7600 Hz Kaldi bank;
- floating-window CMVN (150 frames left, 149 right, mean only) as a
  float32 cumsum
  with Kaldi's edge clamps.

The CMVN window means come from a float32 cumsum over the whole file, as
in the JAX package.  Its rounding grows with the file: the sums reach
about 20 x n_frames, so two cumsums in different orders (the CPU's
sequential one, the GPU's parallel scan) differ by a few float32 ulps of
that size, divided by the 300-frame window: ``device_atol`` bounds it.

The JAX package's int16 device-dither path (blocked 8192-frame grid,
``VbxPcmStream`` and ``VbxPcmStreamOnline``) is not ported: it serves the
link codec, the overlapped scorer and the online scorer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.layers import precision_scope
from ..utils.device import resolve_device
from .mel import kaldi_mel_fbank
from .sidekit import _dft_matrices

WIN = 400
HOP = 160
NFFT = 512
FEAT_DIM = 64
SR = 16000
CHUNK = 4096  # frames per chunk of the frame matrix (bounds its memory)
LC, RC = 150, 149  # CMVN context: frames left and right of the centre


def povey_window(winlen=WIN):
    return np.power(0.5 - 0.5 * np.cos(np.linspace(0, 2 * np.pi, winlen)), 0.85)


def add_dither_seeded(x_int, level=8, seed=3):
    """HTK-style dither on the int16-scaled signal, reproducing the
    reference's np.random.seed(3) for bit-compatible features
    (vbx_segmenter.py:84-85)."""
    rng = np.random.RandomState(seed)
    return x_int + level * (rng.rand(*x_int.shape) * 2 - 1)


def preprocess_signal(signal):
    """float64 16 kHz signal -> dithered, mirror-padded float64 array
    (vbx_segmenter.py:84-86)."""
    noverlap = 240
    sig_int = (np.asarray(signal) * 2 ** 15).astype(int)
    sig = add_dither_seeded(sig_int)
    return np.r_[sig[noverlap // 2 - 1::-1], sig, sig[-1:-WIN // 2 - 1:-1]]


class VbxFrontend:
    """Reference-exact VBx features on ``device`` (``cuda`` by default;
    without a CUDA device it raises)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        fbank = kaldi_mel_fbank(WIN, SR, numchans=FEAT_DIM, lofreq=20.0,
                                hifreq=7600, htk_bug=False)
        dcos, dsin = _dft_matrices(WIN, NFFT)
        self.fbank, self.window, self.dcos, self.dsin = (
            torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                self.device)
            for a in (fbank, povey_window(), dcos, dsin))

    def _log_fbank(self, seg):
        """((C+2)*HOP,) float32 samples -> (C, 64) log mel energies."""
        t = seg.shape[0] // HOP - 2
        s2 = seg.reshape(t + 2, HOP)
        frames = torch.cat([s2[0:t], s2[1:t + 1], s2[2:t + 2, :WIN - 2 * HOP]],
                           dim=1)                                  # (C, 400)
        frames = frames - frames.mean(dim=1, keepdim=True)       # ZMEANSOURCE
        shifted = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
        frames = frames - 0.97 * shifted                         # pre-emphasis
        fw = frames * self.window
        re = fw @ self.dcos
        im = fw @ self.dsin
        spec = re * re + im * im
        return torch.log(torch.clamp_min(spec @ self.fbank, 1.0))

    @staticmethod
    def _cmvn(x):
        """Floating-window mean normalization with Kaldi's edge handling
        (features_vbx.py:131-149, norm_vars=False)."""
        n = x.shape[0]
        win_len = min(n, LC + RC + 1)
        ws = torch.clamp(torch.arange(n, device=x.device) - LC, 0,
                         n - win_len)
        f = torch.cat([torch.zeros((1, x.shape[1]), dtype=x.dtype,
                                   device=x.device), torch.cumsum(x, dim=0)])
        return x - (f[ws + win_len] - f[ws]) / win_len

    def features(self, signal):
        """Reference-compatible entry: float64 signal -> (T, 64) float32
        tensor on ``self.device``.  The mirror pad adds 320 samples, so
        T = (n - 80) // 160 + 1 for n >= 200 samples."""
        return self.device_features(
            torch.from_numpy(host_segment(signal)).to(self.device))

    def device_features(self, seg):
        """The device half: ((T+2)*HOP,) float32 ``host_segment`` output
        on ``self.device`` -> (T, 64) features."""
        n_frames = seg.shape[0] // HOP - 2
        with precision_scope("highest"):
            parts = [self._log_fbank(seg[f0 * HOP:(f0 + min(
                CHUNK, n_frames - f0) + 2) * HOP])
                for f0 in range(0, n_frames, CHUNK)]
        if not parts:
            return torch.empty((0, FEAT_DIM), dtype=torch.float32,
                               device=seg.device)
        return self._cmvn(torch.cat(parts))


def host_segment(signal):
    """The host half: float64 signal -> the dithered, mirror-padded
    float32 samples cut or zero-padded to (T+2)*HOP, T the frame count."""
    seg = preprocess_signal(signal).astype(np.float32)
    n_frames = max(0, (len(seg) - WIN) // HOP + 1)
    need = (n_frames + 2) * HOP
    return np.pad(seg, (0, max(0, need - len(seg))))[:need]


def device_atol(n_frames):
    """Bound on |features on CUDA - features on the CPU| for a file of
    ``n_frames``: 5e-4 for the float32 DFT sums, plus the CMVN cumsum's
    rounding, 16 float32 ulps of sums that reach about 20 x n_frames, over
    the min(n_frames, 300)-frame window."""
    return 5e-4 + 16 * 2.0 ** -23 * 20 * n_frames / min(n_frames, LC + RC + 1)
