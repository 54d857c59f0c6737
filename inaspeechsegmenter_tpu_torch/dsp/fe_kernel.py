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

An int16 signal reaches the device through the lossless upload codec
(``dsp/codec.py``) when :func:`upload_codec_enabled`: one ``pack_best``
decision a group of ``ISS_UPLOAD_CHUNKS`` chunks (:func:`upload_chunks`),
decoded on the device by a hand kernel into the exact samples the
features kernel then reads, as the JAX package ships them
(``inaspeechsegmenter_tpu/dsp/sidekit.py``).  ``ISS_UPLOAD_CODEC=1`` turns
it on; the default, ``auto``, takes the raw upload on every device, a
measured departure from the JAX package's ``auto`` (on for every
accelerator), recorded beside ``ISS_VFS_OVERLAP=auto``: on the H100's
PCIe link the host encode (4-10 ms a 3-chunk group) costs more than the
link time the 24% fewer bytes save, and the warm 10 min file ran 11-21%
slower with the codec (``chip_smoke.py`` phase 11, ``PERF.md`` §6).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.device import upload
from . import codec, sidekit
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


def upload_chunks():
    """``ISS_UPLOAD_CHUNKS`` (default 3, at least 1): CHUNK-frame chunks a
    group, of the codec's uploads and of the streaming and online path's
    feature launches, read at each use as the JAX package reads it."""
    return max(1, int(os.environ.get("ISS_UPLOAD_CHUNKS", "3")))


def upload_codec_enabled():
    """``ISS_UPLOAD_CODEC``: int16 uploads through the lossless codec, on
    with ``1`` (or any value but ``0``, ``off`` and ``auto``).  ``auto``,
    the default, is off on every device: on the CPU an upload is a host
    copy that packing can only slow down, as in the JAX package; on CUDA
    the port departs from the JAX package's rule (on for accelerators)
    because the codec measured slower there (the module's docstring)."""
    return os.environ.get("ISS_UPLOAD_CODEC", "auto") not in ("auto", "0",
                                                              "off")


def group_shipped_bytes(sig_i16):
    """Link bytes the whole-file upload ships for this int16 signal,
    against raw: ``(shipped_bytes, raw_bytes)``, equal when the codec is
    off.  A copy of the JAX package's accounting
    (``dsp/sidekit.py::group_shipped_bytes``): the signal zero-padded to
    whole chunks plus the 2*HOP lookahead, one ``pack_best`` decision and
    its page quantization a group of ``ISS_UPLOAD_CHUNKS`` chunks.  The
    ``keep_pcm`` upload of a signal whose last samples fall past its last
    chunk grows by one chunk; this does not count it."""
    sig = np.ascontiguousarray(sig_i16, dtype=np.int16)
    n_chunks = max(1, -(-max(frame_count(len(sig)), 1) // CHUNK))
    need = (n_chunks * CHUNK + 2) * HOP
    sig = np.pad(sig, (0, max(0, need - len(sig))))[:need]
    group = upload_chunks()
    on = upload_codec_enabled()
    shipped = raw_b = 0
    for g in range(0, n_chunks, group):
        k = min(group, n_chunks - g)
        raw = sig[g * CHUNK * HOP: ((g + k) * CHUNK + 2) * HOP]
        raw_b += 2 * len(raw)
        p = codec.pack_best(raw) if on else None
        shipped += 2 * len(raw) if p is None else p[1].nbytes
    return shipped, raw_b


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
    one group of :func:`upload_chunks` chunks of ``CHUNK`` frames at a time
    (the streaming and online path).  The kernel computes every frame from
    its own 400 samples, so a group's rows equal the same rows of a
    whole-file launch.  With the codec on, both ship each group packed and
    decode it on the device; the samples, and so the features, are the
    raw upload's.
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
        if host.dtype == np.int16 and upload_codec_enabled():
            x = self._ship_whole(host, keep_pcm, pinned)
        else:
            x = self._upload(host, pinned)
        mspec, loge = sidekit_features(x, self.consts)
        if keep_pcm:
            return (mspec, loge, mspec.shape[0],
                    x if x.dtype == torch.int16 else None)
        return mspec, loge, mspec.shape[0]

    def _upload(self, host, pinned):
        """The raw upload: pageable, or pinned without waiting for the
        device's queue (``utils.device.upload``)."""
        return (upload(host, self.device) if pinned
                else torch.from_numpy(host).to(self.device))

    def _ship_whole(self, host, keep_pcm, pinned):
        """The codec's whole-file upload of an int16 signal -> its first
        ``len(host)`` samples (at most the padded length) on the device.

        The JAX package's groups: the signal zero-padded to whole chunks
        plus the 2*HOP lookahead (one chunk more with ``keep_pcm`` when its
        last samples fall past the last chunk, as ``iter_group_feats``),
        one ``codec.ship`` a group, each decoded into its place in one
        device buffer.  Consecutive groups overlap by 2*HOP = one codec
        block; both decodes write the same samples, in stream order."""
        n = len(host)
        n_chunks = max(1, -(-max(frame_count(n), 1) // CHUNK))
        need = (n_chunks * CHUNK + 2) * HOP
        if keep_pcm and n > need:
            n_chunks += 1
            need = (n_chunks * CHUNK + 2) * HOP
        sig = np.pad(host[:need], (0, max(0, need - n)))
        pcm = torch.empty(need, dtype=torch.int16, device=self.device)
        group = upload_chunks()
        for g in range(0, n_chunks, group):
            k = min(group, n_chunks - g)
            lo, hi = g * CHUNK * HOP, ((g + k) * CHUNK + 2) * HOP
            codec.ship(sig[lo:hi], self.device, pinned=pinned,
                       out=pcm[lo:hi])
        return pcm[:min(n, need)]

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
            overlapped VFS scorer queues work between the groups.  With
            the codec on, an int16 group ships ``pack_best(raw)``.
        """
        if len(raw) != (k * CHUNK + 2) * HOP:
            raise ValueError(f"a group of {k} chunks takes "
                             f"{(k * CHUNK + 2) * HOP} samples, got {len(raw)}")
        host = _host_signal(raw)
        if host.dtype == np.int16 and upload_codec_enabled():
            x = codec.ship(host, self.device, pinned=keep_pcm)
        else:
            x = self._upload(host, keep_pcm)
        m, lg = sidekit_features(x, self.consts)
        pcm = x if keep_pcm and x.dtype == torch.int16 else None
        return ([(m[j * CHUNK:(j + 1) * CHUNK], lg[j * CHUNK:(j + 1) * CHUNK])
                 for j in range(k)], pcm)

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
        group = upload_chunks()
        for g in range(0, n_chunks, group):
            k = min(group, n_chunks - g)
            yield self.group_feats(
                sig[g * CHUNK * HOP:((g + k) * CHUNK + 2) * HOP], k, keep_pcm)

    def mspec_loge_chunks(self, sig):
        """Per-chunk device features -> ([(mspec_c, loge_c)], n_frames)."""
        outs = []
        for chunks_g, _ in self.iter_group_feats(sig):
            outs.extend(chunks_g)
        return outs, frame_count(len(sig))
