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

The int16 device path (the JAX package's, ``dsp/vbx.py:122-588`` there)
takes exact int16 samples on the device and adds a cached device dither
(the same MT19937(3) stream, drawn once per process in 2^20-sample steps),
so the host does no per-file work.  The mirror-padded signal is built in
one device buffer and the features are computed on a fixed grid of
``VBX_BLK``-frame blocks, each with a ``VBX_HALO``-frame halo and a CMVN
cumsum local to the block: a frame's value depends on the grid alone,
whether the signal arrived whole (``features_from_pcm``,
``_features_i16``) or piece by piece (``VbxPcmStream``, and
``VbxPcmStreamOnline`` for a stream of unknown length: the online VFS).
The signal differs from the f32 path's by at most one float32 rounding a
sample (the dither is added in float32), and the cumsum's drift is
bounded by the block extent instead of the file (``device_atol``).
The device picks the path (``vbx_i16_enabled``): the int16 grid on a
CUDA device, the reference-exact f32 path on the CPU.  The grid's own
upload (``_features_i16``, when no segmenter upload is reused) takes the
lossless upload codec where ``dsp.fe_kernel.upload_codec_enabled()``, as
in the JAX package: the signal zero-padded to a 1,024-frame bucket plus
the mirror tail's headroom, one ``pack_best`` decision, decoded on the
device.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..models.layers import precision_scope
from ..utils.device import resolve_device
from . import codec
from .fe_kernel import upload_codec_enabled
from .mel import kaldi_mel_fbank
from .sidekit import _dft_matrices

WIN = 400
HOP = 160
NFFT = 512
FEAT_DIM = 64
SR = 16000
CHUNK = 4096  # frames per chunk of the frame matrix (bounds its memory)
LC, RC = 150, 149  # CMVN context: frames left and right of the centre

# The int16 grid.  The CMVN window reaches up to lc + rc + 1 = 300 frames
# to either side of a frame once the global clamps engage, so a block
# computed with a 304-frame halo sees every sample any of its windows can
# touch.
VBX_BLK = 8192                   # frames owned per block
VBX_HALO = 304                   # context frames on each side (>= LC+RC+1)
_MARGIN = VBX_HALO * HOP         # left margin: block 0's halo slice >= 0
_EXT = VBX_BLK + 2 * VBX_HALO    # frames computed per block
DITHER_STEP = 1 << 20            # samples a dither growth draws, at least


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
        self._dither_dev = None      # device dither prefix
        self._dither_len = 0
        self._dither_rng = None
        # batch_score's producer threads grow the cache concurrently
        self._dither_lock = threading.Lock()

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
        T = (n - 80) // 160 + 1 for n >= 200 samples.

        With the int16 path on (``vbx_i16_enabled``) a signal of at least
        400 samples whose int16 scaling fits int16 takes it; any other
        signal, and every signal on the CPU, takes the reference-exact f32
        path.
        """
        if vbx_i16_enabled(self.device):
            sig_int = (np.asarray(signal) * 2 ** 15).astype(np.int64)
            n = len(sig_int)
            if (n >= 400 and sig_int.min() >= -32768
                    and sig_int.max() <= 32767):
                return self._features_i16(sig_int.astype(np.int16), n)
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

    # -- the int16 grid ------------------------------------------------------

    def _dither_buffer(self, n):
        """The first ``n`` samples of the device dither.

        The reference dither is the MT19937(3) sequence (vbx_segmenter.py:
        84-85), the same for every file up to its length, so it is drawn
        once on the host, ``8 * (2 * rand - 1)`` in float64 cast to
        float32 as the JAX package does, and kept on the device.  It grows
        in steps of ``DITHER_STEP`` samples; a kept ``RandomState``
        continues the stream, so a growth draws only the new samples.
        """
        with self._dither_lock:
            if n > self._dither_len:
                grow = -(-n // DITHER_STEP) * DITHER_STEP
                if self._dither_rng is None:
                    self._dither_rng = np.random.RandomState(3)
                d = (8.0 * (2.0 * self._dither_rng.rand(
                    grow - self._dither_len) - 1.0)).astype(np.float32)
                d = torch.from_numpy(d).to(self.device)
                self._dither_dev = (d if self._dither_dev is None else
                                    torch.cat([self._dither_dev, d]))
                self._dither_len = grow
            return self._dither_dev[:n]

    def _dither_full(self, n):
        """The whole device dither, grown to at least ``n`` samples: a
        stream slices it at its own positions, so it grows it once, up
        front."""
        self._dither_buffer(n)
        with self._dither_lock:
            return self._dither_dev

    @staticmethod
    def _stream_append(buf, piece, dither_full, pos, n_limit):
        """Write the dithered float32 samples of ``piece`` (int16, signal
        position ``pos``) into the seg-coordinate buffer, in place.
        Samples at or past ``n_limit`` are 0.0: dither is only ever added
        to real samples."""
        ln = piece.shape[0]
        x = piece.to(torch.float32) + dither_full[pos:pos + ln]
        if pos + ln > n_limit:
            x[max(0, n_limit - pos):].fill_(0.0)   # no host scalar copy
        start = _MARGIN + 120 + pos
        buf[start:start + ln] = x

    @staticmethod
    def _stream_front_mirror(buf):
        """seg[p] = x[119 - p] for p < 120 (vbx_segmenter.py:86), copied
        from the dithered values already written."""
        buf[_MARGIN:_MARGIN + 120] = buf[_MARGIN + 120:_MARGIN + 240].flip(0)

    @staticmethod
    def _stream_tail_mirror(buf, n):
        """seg[120 + n + j] = x[n - 1 - j] for j < 200."""
        end = _MARGIN + 120 + n
        buf[end:end + 200] = buf[end - 200:end].flip(0)

    def _block_features(self, buf, a_f, n_frames, win_len, fea_buf):
        """Fbank and blocked CMVN of the block owning frames
        [a_f, a_f + VBX_BLK); writes its rows into ``fea_buf`` in place.

        The CMVN window start ``ws = clip(i - LC, 0, n_frames - win_len)``
        takes one of three forms, selected per row: the interior (two
        static slices of the block-local cumsum), the start clamp (ws = 0,
        one value for every clamped row) and the end clamp (ws = n_frames
        - win_len, one value).
        """
        s0 = _MARGIN + (a_f - VBX_HALO) * HOP
        with precision_scope("highest"):
            fea = self._log_fbank(buf[s0:s0 + (_EXT + 2) * HOP])  # (_EXT, 64)
        g_idx = a_f - VBX_HALO + torch.arange(_EXT, device=fea.device)
        fea = torch.where(((g_idx >= 0) & (g_idx < n_frames))[:, None], fea,
                          torch.zeros_like(fea))
        f = torch.cat([fea.new_zeros((1, FEAT_DIM)),
                       torch.cumsum(fea, dim=0)])              # (_EXT + 1, 64)

        def row(j):
            # the JAX program's dynamic_slice clamps its start; a clamped
            # row is only read where its branch is not selected
            j = min(max(j, 0), _EXT)
            return f[j:j + 1]

        sum_int = (f[VBX_HALO + RC + 1:VBX_HALO + RC + 1 + VBX_BLK]
                   - f[VBX_HALO - LC:VBX_HALO - LC + VBX_BLK])
        lo = min(max(VBX_HALO - a_f, 0), _EXT)
        sum_start = row(lo + win_len) - row(lo)
        we = min(max(n_frames - win_len - (a_f - VBX_HALO), 0), _EXT)
        sum_end = row(we + win_len) - row(we)
        i_g = a_f + torch.arange(VBX_BLK, device=fea.device)
        start_m = (i_g - LC < 0)[:, None]
        int_m = ((i_g - LC >= 0) & (i_g - LC <= n_frames - win_len))[:, None]
        sums = torch.where(start_m, sum_start,
                           torch.where(int_m, sum_int, sum_end))
        fea_buf[a_f:a_f + VBX_BLK] = (fea[VBX_HALO:VBX_HALO + VBX_BLK]
                                      - sums / np.float32(win_len))

    def _features_i16(self, sig_i16, n):
        """int16 device path: (n,) exact int16 samples -> (T, 64).  The
        upload, then the blocked grid (``VbxPcmStream``).  With the codec
        on, the JAX package's upload (``dsp/vbx.py::_features_i16``
        there): the samples zero-padded to a 1,024-frame bucket plus two
        codec blocks of mirror-tail headroom, packed as one slice;
        otherwise the n raw samples."""
        sig = np.ascontiguousarray(sig_i16[:n], np.int16)
        if upload_codec_enabled():
            n_frames = (n - 80) // HOP + 1
            t_bucket = -(-n_frames // 1024) * 1024
            padded = np.zeros((t_bucket + 2) * HOP + 2 * codec.BLOCK,
                              np.int16)
            padded[:n] = sig
            pcm = codec.ship(padded, self.device)
        else:
            pcm = torch.from_numpy(sig).to(self.device)
        stream = VbxPcmStream(self, n)
        stream.append(pcm)
        return stream.finish()

    def features_from_pcm(self, pcm_parts, n):
        """VBx features from int16 samples already on the device (the VAD's
        upload, ``Segmenter.segment_signal(return_pcm=True)``), with no
        upload of their own; the same block programs as ``VbxPcmStream``,
        so equal to ``_features_i16`` bit for bit.

        :param pcm_parts: [(len_g,) int16 device tensors] that tile the
            signal in order (the port's Segmenter hands one part).
        :param n: the signal's sample count.
        """
        stream = VbxPcmStream(self, n)
        for p in pcm_parts:
            stream.append(p)
        return stream.finish()


class VbxPcmStream:
    """Blocked VBx features from int16 pieces of a signal of known length.

    Owns the device seg buffer (dithered, mirror-padded, float32) and the
    (nb * VBX_BLK, 64) feature buffer, both written in place.  ``append``
    takes exact int16 samples in order (host arrays or device tensors) and
    runs every block whose halo'd extent is final; ``fea_buffer`` hands the
    growing feature tensor to the x-vector gather.  The values are the same
    bit for bit however the signal is cut into appends (the grid is
    fixed).

    :param fe: the shared ``VbxFrontend`` (constants and dither cache).
    :param n_samples: the signal's sample count (at least 400).
    """

    def __init__(self, fe, n_samples):
        self.fe = fe
        self.n = int(n_samples)
        if self.n < WIN:
            raise ValueError("VbxPcmStream needs one full analysis window")
        self.n_frames = (self.n - 80) // HOP + 1
        self.nb = max(1, -(-self.n_frames // VBX_BLK))
        # the buffer covers the last block's slice and the mirror tail
        s_b = max(_MARGIN + ((self.nb - 1) * VBX_BLK - VBX_HALO) * HOP
                  + (_EXT + 2) * HOP, _MARGIN + 120 + self.n + 200)
        self._buf = torch.zeros(s_b, dtype=torch.float32, device=fe.device)
        self._fea = torch.zeros((self.nb * VBX_BLK, FEAT_DIM),
                                dtype=torch.float32, device=fe.device)
        # samples past the buffer are upload padding: dropped
        self._cap = s_b - _MARGIN - 120
        self._dither = fe._dither_full(self._cap)    # one growth, up front
        self._pos = 0
        self._blocks_done = 0
        self._front_done = False
        self._tail_done = False

    def append(self, piece):
        """Take the next samples (int16, host or device).  Samples past
        ``n_samples`` are zeroed."""
        ln = min(int(piece.shape[0]), self._cap - self._pos)
        if ln <= 0:
            return
        piece = _device_i16(piece[:ln], self.fe.device)
        self.fe._stream_append(self._buf, piece, self._dither, self._pos,
                               self.n)
        self._pos += ln
        if not self._front_done and self._pos >= 120:
            self.fe._stream_front_mirror(self._buf)
            self._front_done = True
        if not self._tail_done and self._pos >= self.n:
            self.fe._stream_tail_mirror(self._buf, self.n)
            self._tail_done = True
        self._run_ready_blocks()

    def _run_ready_blocks(self):
        win_len = min(self.n_frames, LC + RC + 1)
        while self._blocks_done < self.nb and self._front_done:
            b = self._blocks_done
            # the block's halo'd slice must be final: every sample it can
            # read is written, or the whole signal (and its tail) is
            slice_end = ((b + 1) * VBX_BLK + VBX_HALO + 2) * HOP
            if not (self._tail_done or 120 + self._pos >= slice_end):
                return
            self.fe._block_features(self._buf, b * VBX_BLK, self.n_frames,
                                    win_len, self._fea)
            self._blocks_done += 1

    @property
    def frames_ready(self):
        """Feature frames final so far."""
        return min(self._blocks_done * VBX_BLK, self.n_frames)

    @property
    def fea_buffer(self):
        """The (nb * VBX_BLK, 64) feature tensor; rows past
        ``frames_ready`` are not final yet."""
        return self._fea

    def finish(self):
        """All samples appended -> the (n_frames, 64) features."""
        if not (self._pos >= self.n and self._blocks_done == self.nb):
            raise RuntimeError(f"stream incomplete: {self._pos} of {self.n} "
                               f"samples, {self._blocks_done} of {self.nb} "
                               "blocks")
        return self._fea[:self.n_frames]


class VbxPcmStreamOnline:
    """``VbxPcmStream`` for a live stream of unknown length, its buffers
    grown by doubling.  A block runs once the frontier is ``GUARD`` frames
    past its halo'd extent: its rows then take only the interior and
    start CMVN branches, so they equal the offline computation on the
    finished signal bit for bit.  ``finalize()`` writes the mirror tail
    and runs the remaining blocks with the exact length.
    """

    GUARD = 16          # frontier slack before a block is final

    def __init__(self, fe, capacity=1 << 23):
        self.fe = fe
        self._pos = 0
        self._blocks_done = 0
        self._front_done = False
        self._final = None
        self._cap = 0
        self._buf = None
        self._fea = None
        self._grow(capacity)

    def _grow(self, need_samples):
        cap = max(self._cap, 1 << 23)
        while cap < need_samples:
            cap *= 2
        if cap == self._cap:
            return
        n_frames_cap = (cap - 80) // HOP + 1
        nb = max(1, -(-n_frames_cap // VBX_BLK))
        s_b = max(_MARGIN + ((nb - 1) * VBX_BLK - VBX_HALO) * HOP
                  + (_EXT + 2) * HOP, _MARGIN + 120 + cap + 200)
        buf = torch.zeros(s_b, dtype=torch.float32, device=self.fe.device)
        fea = torch.zeros((nb * VBX_BLK, FEAT_DIM), dtype=torch.float32,
                          device=self.fe.device)
        if self._buf is not None:
            buf[:self._buf.shape[0]] = self._buf
            fea[:self._fea.shape[0]] = self._fea
        self._buf, self._fea = buf, fea
        self._cap = cap
        self._nb_cap = nb
        self._dither = self.fe._dither_full(cap + 200)

    def append(self, piece):
        """Take the next live samples (int16, host or device)."""
        if self._final is not None:
            raise RuntimeError("append() after finalize()")
        ln = int(piece.shape[0])
        if ln == 0:
            return
        self._grow(self._pos + ln)
        piece = _device_i16(piece, self.fe.device)
        # every live sample is real: no limit
        self.fe._stream_append(self._buf, piece, self._dither, self._pos,
                               1 << 62)
        self._pos += ln
        if not self._front_done and self._pos >= 120:
            self.fe._stream_front_mirror(self._buf)
            self._front_done = True
        self._run_safe_blocks()

    def _frames_now(self):
        return (self._pos - 80) // HOP + 1 if self._pos >= WIN else 0

    def _run_safe_blocks(self):
        frames_now = self._frames_now()
        win_len = min(max(frames_now, 1), LC + RC + 1)
        while self._blocks_done < self._nb_cap and self._front_done:
            b = self._blocks_done
            if (b + 1) * VBX_BLK + VBX_HALO + self.GUARD > frames_now:
                return
            # only interior and start rows here: the frontier as n_frames
            # gives the values the finished signal will
            self.fe._block_features(self._buf, b * VBX_BLK, frames_now,
                                    win_len, self._fea)
            self._blocks_done += 1

    @property
    def frames_ready(self):
        """Feature frames final so far (safe blocks only)."""
        return min(self._blocks_done * VBX_BLK, max(self._frames_now(), 0))

    @property
    def fea_buffer(self):
        return self._fea

    def finalize(self):
        """The stream is complete: mirror the tail and run the remaining
        blocks with the exact length -> (n_frames, 64) features, equal to
        ``VbxPcmStream`` on the same samples."""
        if self._final is not None:
            return self._final
        n = self._pos
        if n < WIN:
            raise ValueError("finalize() below one analysis window")
        n_frames = (n - 80) // HOP + 1
        self.fe._stream_tail_mirror(self._buf, n)
        win_len = min(n_frames, LC + RC + 1)
        nb = max(1, -(-n_frames // VBX_BLK))
        while self._blocks_done < nb:
            self.fe._block_features(self._buf, self._blocks_done * VBX_BLK,
                                    n_frames, win_len, self._fea)
            self._blocks_done += 1
        self._final = self._fea[:n_frames]
        return self._final


def _device_i16(piece, device):
    """An int16 piece (numpy or tensor) as a tensor on ``device``."""
    if isinstance(piece, torch.Tensor):
        return piece.to(device)
    return torch.from_numpy(np.ascontiguousarray(piece, np.int16)).to(device)


def vbx_i16_enabled(device):
    """Whether VBx features take the int16 grid on ``device``: on a CUDA
    device, where it removes the host half; not on the CPU, where the f32
    path is the reference's to the float32 rounding."""
    return torch.device(device).type == "cuda"


def host_segment(signal):
    """The host half: float64 signal -> the dithered, mirror-padded
    float32 samples cut or zero-padded to (T+2)*HOP, T the frame count."""
    seg = preprocess_signal(signal).astype(np.float32)
    n_frames = max(0, (len(seg) - WIN) // HOP + 1)
    need = (n_frames + 2) * HOP
    return np.pad(seg, (0, max(0, need - len(seg))))[:need]


def device_atol(n_frames, blocked=False):
    """Bound on |features on CUDA - features on the CPU| for a file of
    ``n_frames``: 5e-4 for the float32 DFT sums, plus the CMVN cumsum's
    rounding, 16 float32 ulps of sums that reach about 20 x the cumsum's
    extent, over the min(n_frames, 300)-frame window.  The extent is the
    file on the f32 path; on the int16 grid (``blocked``) it is one block's
    ``_EXT`` = 8,800 frames at most, whatever the file's length."""
    extent = min(n_frames, _EXT) if blocked else n_frames
    return 5e-4 + 16 * 2.0 ** -23 * 20 * extent / min(n_frames, LC + RC + 1)
