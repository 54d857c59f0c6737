"""Fused SIDEKIT feature kernel: wrapper, plain version and frontend.

Port of the JAX package's only Pallas kernel,
``inaspeechsegmenter_tpu/dsp/pallas_fe.py::_kernel`` (the
``ISS_FRONTEND=pallas`` frontend there; the Segmenter's frontend here).
The kernel is ``csrc/sidekit_fe.cu``, an FFT in shared memory; its source
comment says what bounds it on the H100 and how its design answers that.

:func:`sidekit_features` launches the kernel for a CUDA tensor and runs the
plain PyTorch version (:func:`sidekit_features_plain`, the transcription of
``sidekit.py::_chunk_feats``) for a CPU tensor.  It never falls back from
one to the other: a CUDA tensor that the kernel cannot take raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import upload
from . import sidekit
from .sidekit import (CHUNK, HOP, NBINS, NFFT, NMEL, WIN, FrontendConsts,
                      frame_count)


def sidekit_features_plain(sig, consts: FrontendConsts):
    """Plain PyTorch features on the signal's own device."""
    return sidekit.mspec_loge(sig, consts)


def _check_consts(consts: FrontendConsts, device):
    shapes = {"window": ((WIN,), torch.float32),
              "fbank_t": ((NBINS, NMEL), torch.float32),
              "twiddle": ((NFFT // 2, 2), torch.float32),
              "band_range": ((NMEL, 2), torch.int32)}
    for name, (shape, dtype) in shapes.items():
        t = getattr(consts, name)
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"frontend constant {name} must be a contiguous {dtype} "
                f"{shape} tensor on {device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def sidekit_features(sig, consts: FrontendConsts):
    """Log-mel and log-energy of a 1-D float32 or int16 signal tensor.

    :return: (mspec (T, 24), loge (T,)) float32 on the signal's device,
        T = frame_count(len(sig)).
    """
    if sig.device.type == "cpu":
        return sidekit_features_plain(sig, consts)
    if sig.device.type != "cuda":
        raise ValueError(f"unsupported device {sig.device}")
    if sig.dim() != 1 or sig.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"signal must be 1-D float32 or int16, got "
                         f"{sig.dtype} {tuple(sig.shape)}")
    if not sig.is_contiguous():
        raise ValueError("signal must be contiguous")
    if sig.data_ptr() % 16:
        sig = sig.clone()        # the kernel copies 16-byte pieces
    _check_consts(consts, sig.device)
    t = frame_count(sig.shape[0])
    mspec = torch.empty((t, NMEL), dtype=torch.float32, device=sig.device)
    loge = torch.empty((t,), dtype=torch.float32, device=sig.device)
    if t == 0:
        return mspec, loge
    lib = cuda_build.library()
    with torch.cuda.device(sig.device):
        rc = lib.iss_sidekit_fe(
            sig.data_ptr(), int(sig.dtype == torch.int16), t,
            consts.window.data_ptr(), consts.twiddle.data_ptr(),
            consts.fbank_t.data_ptr(), consts.band_range.data_ptr(),
            mspec.data_ptr(), loge.data_ptr(),
            torch.cuda.current_stream(sig.device).cuda_stream)
    cuda_build.check_launch("sidekit_fe", rc)
    cuda_build.count_launch(sidekit_features)
    return mspec, loge


sidekit_features.launches = 0


GROUP_CHUNKS = 3   # CHUNK-frame chunks per feature group (one launch)


def _host_signal(sig):
    """int16 kept as int16 (a half-size upload), any other dtype as
    float32, contiguous."""
    arr = np.asarray(sig)
    keep = np.int16 if arr.dtype == np.int16 else np.float32
    return np.ascontiguousarray(arr, dtype=keep)


class KernelSidekitFrontend:
    """The Segmenter's frontend: host signal in, device features out.

    Two shapes of call: :meth:`mspec_loge` computes a whole signal in one
    launch (the fused path), :meth:`group_feats` / :meth:`iter_group_feats`
    one group of ``GROUP_CHUNKS`` chunks of ``CHUNK`` frames at a time (the
    streaming and online path).  The kernel computes every frame from its
    own 400 samples, so a group's rows equal the same rows of a whole-file
    launch.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.consts = sidekit.frontend_consts(self.device)

    def mspec_loge(self, sig, keep_pcm=False, pinned=False):
        """Host signal -> (mspec (T, 24), loge (T,), T) on ``self.device``.

        :param keep_pcm: also return the uploaded signal when it is int16
            (else None), as a fourth item: the VBx features of the VFS
            scorer reuse the VAD's upload (``dsp.vbx.features_from_pcm``).
        :param pinned: upload through pinned memory without waiting for
            the device's queue (``utils.device.upload``), for a caller
            that has queued work behind which the upload must not wait.
        """
        host = _host_signal(sig)
        x = (upload(host, self.device) if pinned
             else torch.from_numpy(host).to(self.device))
        mspec, loge = sidekit_features(x, self.consts)
        if keep_pcm:
            return (mspec, loge, mspec.shape[0],
                    x if x.dtype == torch.int16 else None)
        return mspec, loge, mspec.shape[0]

    def group_feats(self, raw, k, keep_pcm=False):
        """Features of ONE group: ``raw`` (host samples) covers ``k`` chunks
        plus the 2*HOP lookahead, ``(k*CHUNK + 2)*HOP`` samples, which is
        exactly ``k*CHUNK`` frames, in one launch.  The one owner of the
        group computation, shared by :meth:`iter_group_feats` and the
        online segmenter.

        :return: ([(mspec_c (CHUNK, 24), loge_c (CHUNK,))] * k, pcm), the
            JAX ``SidekitFrontend.group_feats`` shape: ``pcm`` is the
            group's uploaded int16 samples on the device with
            ``keep_pcm`` and an int16 ``raw``, else None.  With
            ``keep_pcm`` the group uploads through pinned memory: the
            overlapped VFS scorer queues work between the groups.
        """
        if len(raw) != (k * CHUNK + 2) * HOP:
            raise ValueError(f"a group of {k} chunks takes "
                             f"{(k * CHUNK + 2) * HOP} samples, got {len(raw)}")
        m, lg, _, pcm = self.mspec_loge(raw, keep_pcm=True,
                                        pinned=keep_pcm)
        return ([(m[j * CHUNK:(j + 1) * CHUNK], lg[j * CHUNK:(j + 1) * CHUNK])
                 for j in range(k)], pcm if keep_pcm else None)

    def iter_group_feats(self, sig, keep_pcm=False):
        """Yield ``(chunks_g, pcm)`` group by group over a whole signal,
        zero-padded to a whole number of chunks (at least one); each
        group's upload and launch are queued before it is yielded.

        :param keep_pcm: yield each group's uploaded int16 samples (its
            2*HOP lookahead included) for an int16 signal; the chunk count
            then grows by one where the signal's last samples would fall
            past the last chunk, so the groups' PCM covers the whole
            signal (the JAX ``iter_group_feats``).
        """
        sig = _host_signal(sig)
        n_chunks = max(1, -(-frame_count(len(sig)) // CHUNK))
        need = (n_chunks * CHUNK + 2) * HOP
        keep_pcm = keep_pcm and sig.dtype == np.int16
        if keep_pcm and len(sig) > need:
            n_chunks += 1
            need = (n_chunks * CHUNK + 2) * HOP
        sig = np.pad(sig[:need], (0, max(0, need - len(sig))))
        for g in range(0, n_chunks, GROUP_CHUNKS):
            k = min(GROUP_CHUNKS, n_chunks - g)
            yield self.group_feats(
                sig[g * CHUNK * HOP:((g + k) * CHUNK + 2) * HOP], k, keep_pcm)

    def mspec_loge_chunks(self, sig):
        """Per-chunk device features -> ([(mspec_c, loge_c)], n_frames)."""
        outs = []
        for chunks_g, _ in self.iter_group_feats(sig):
            outs.extend(chunks_g)
        return outs, frame_count(len(sig))
