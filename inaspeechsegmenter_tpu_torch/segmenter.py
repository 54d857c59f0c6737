"""Public segmentation API — the PyTorch port of ``Segmenter``.

Same surface as ``inaspeechsegmenter_tpu/segmenter.py`` (reference
segmenter.py:111-387): ``DnnSegmenter`` subclasses with the same class
attributes and per-stage ``__call__(mspec, lseg, difflen)``, and
``Segmenter(vad_engine, detect_gender, ffmpeg, batch_size, energy_ratio,
allow_download)`` with ``__call__``, ``segment_signal``, ``segment_feats``,
``batch_process`` (skipifexist / nbtry / trydelay / status tuples) and
``timers`` — the JAX package's positional order, plus the keyword-only
``device`` and ``model_dir``.  The default device is ``cuda``; a host with
no CUDA device raises rather than running on the CPU.  Tests pass
``device="cpu"``, which runs every kernel's plain PyTorch version.

Media decode goes through ffmpeg by default (``audio/io.py``); the CNNs
load by their registry names from a released ``.hdf5`` or its converted
npz (``models/registry.py``) and run at the ``ISS_CNN_PRECISION`` tier.
Features come from the fused CUDA frontend (``dsp/fe_kernel.py``); the
decodes from the CUDA Viterbi (``decode/viterbi.py``).
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from .audio.io import check_ffmpeg, media2sig16kmono
from .decode.transitions import diag_trans_exp
from .decode.viterbi import viterbi_path
from .dsp.fe_kernel import KernelSidekitFrontend
from .dsp.patches import frame_patches
from .export import seg2csv, seg2textgrid
from .models.registry import load_patch_model
from .pipeline import FusedPipeline, rle
from .utils.device import resolve_device
from .utils.prefetch import run_prefetched, staged_producer
from .utils.timing import StageTimers


class DnnSegmenter:
    """Patch-CNN segmentation stage (abstract).

    Child classes define `nmel`, `viterbi_arg`, `model_fname`, `inlabel`,
    `outlabels` — same contract as the reference DnnSegmenter
    (segmenter.py:111-125).
    """

    def __init__(self, batch_size=32, allow_download=True, *, device="cuda",
                 model_dir=None):
        self.device = resolve_device(device)
        self.model = load_patch_model(self.model_fname, model_dir,
                                      allow_download).to(self.device)
        self.model.eval()
        self.batch_size = batch_size

    def as_pipeline_stage(self):
        return (self.model, self.nmel, len(self.outlabels), self.viterbi_arg)

    @torch.no_grad()
    def __call__(self, mspec, lseg, difflen=0):
        """Reference per-stage call (segmenter.py:52-108 of the JAX
        package): re-label the 20 ms-frame segments ``(label, start,
        stop)`` whose label is ``inlabel`` through the CNN and a Viterbi,
        and pass the others through.

        :param mspec: (T, >= nmel) log-mel rows (array or tensor).
        """
        mspec = torch.as_tensor(np.asarray(mspec, np.float32)
                                if not isinstance(mspec, torch.Tensor)
                                else mspec, dtype=torch.float32,
                                device=self.device)
        t = mspec.shape[0]
        n20 = (t + 1) // 2 - (int(difflen / 2) if difflen > 0 else 0)
        if n20 <= 0:
            return list(lseg)
        # gather + CNN in bounded chunks, as the reference's
        # keras.predict(batch_size) (segmenter.py:162-163)
        chunk = max(int(self.batch_size), 256)
        probs = []
        for j0 in range(0, n20, chunk):
            frames = torch.arange(j0, min(j0 + chunk, n20), device=self.device)
            patches, finite = frame_patches(mspec, frames, t, self.nmel)
            p = self.model(patches[..., None])
            probs.append(torch.where(finite[:, None], p,
                                     torch.full_like(p, 0.5)))
        probs = torch.cat(probs)
        inmask = np.zeros(n20, bool)
        for lab, start, stop in lseg:
            if lab == self.inlabel:
                inmask[start:stop] = True
        reset = np.zeros(n20, bool)
        reset[1:] = inmask[1:] != inmask[:-1]
        # also reset at every in-label segment start: the reference decodes
        # each segment on its own (segmenter.py:166-178), so two adjacent
        # in-label segments must not share one decode
        for lab, start, stop in lseg:
            if lab == self.inlabel and 0 < start < n20:
                reset[start] = True
        mask = torch.from_numpy(inmask).to(self.device)
        em = torch.where(mask[:, None], torch.log(probs),
                         torch.zeros_like(probs))
        states = viterbi_path(
            em, diag_trans_exp(self.viterbi_arg, len(self.outlabels)),
            reset=torch.from_numpy(reset).to(self.device)).cpu().numpy()
        ret = []
        for lab, start, stop in lseg:
            if lab != self.inlabel:
                ret.append((lab, start, stop))
                continue
            for st, a, b in rle(states[start:stop]):
                ret.append((self.outlabels[st], a + start, b + start))
        return ret


class SpeechMusic(DnnSegmenter):
    # Voice activity detection, 'sm' engine (reference segmenter.py:182-188)
    outlabels = ("speech", "music")
    model_fname = "keras_speech_music_cnn.hdf5"
    inlabel = "energy"
    nmel = 21
    viterbi_arg = 150


class SpeechMusicNoise(DnnSegmenter):
    # Voice activity detection, 'smn' engine (reference segmenter.py:190-196)
    outlabels = ("speech", "music", "noise")
    model_fname = "keras_speech_music_noise_cnn.hdf5"
    inlabel = "energy"
    nmel = 21
    viterbi_arg = 80


class Gender(DnnSegmenter):
    # Gender segmentation (reference segmenter.py:198-204)
    outlabels = ("female", "male")
    model_fname = "keras_male_female_cnn.hdf5"
    inlabel = "speech"
    nmel = 24
    viterbi_arg = 80


class Segmenter:
    def __init__(self, vad_engine="smn", detect_gender=True, ffmpeg="ffmpeg",
                 batch_size=32, energy_ratio=0.03, allow_download=True, *,
                 device="cuda", model_dir=None):
        """Load models and build the pipeline on ``device``.

        The JAX package's parameters in its order (the reference ctor's,
        segmenter.py:208-247, then ``allow_download``), plus the
        keyword-only ``device`` (explicit; ``cuda`` needs a CUDA device)
        and ``model_dir`` (the first model directory searched).
        ``ffmpeg=None`` accepts WAV input only (other rates than 16 kHz
        through the native resampler, ``audio/native.py``).
        The process's TF32 flags are left alone: each CNN forward sets its
        own tier's flags under a lock and restores them
        (``models.layers.precision_scope``), also when the prefetch
        producer threads of ``batch_process`` run it.
        """
        self.device = resolve_device(device)
        self.ffmpeg = check_ffmpeg(ffmpeg)
        self.energy_ratio = energy_ratio
        self.batch_size = batch_size

        if vad_engine not in ("sm", "smn"):
            raise ValueError(f"vad_engine must be 'sm' or 'smn', got "
                             f"{vad_engine!r}")
        vad_cls = SpeechMusic if vad_engine == "sm" else SpeechMusicNoise
        self.vad = vad_cls(batch_size, allow_download, device=self.device,
                           model_dir=model_dir)

        if detect_gender not in (True, False):
            raise ValueError(f"detect_gender must be a bool, got "
                             f"{detect_gender!r}")
        self.detect_gender = detect_gender
        if detect_gender:
            self.gender = Gender(batch_size, allow_download,
                                 device=self.device, model_dir=model_dir)

        self.frontend = KernelSidekitFrontend(self.device)
        self.pipeline = FusedPipeline(
            self.vad.as_pipeline_stage(),
            self.gender.as_pipeline_stage() if detect_gender else None,
            energy_ratio=energy_ratio, device=self.device)
        # label-id -> name table used to decode the pipeline output
        self.labels = ["noEnergy"] + list(self.vad.outlabels)
        if detect_gender:
            self.labels += list(self.gender.outlabels)
        self.timers = StageTimers("decode", "features", "segment")

    # ------------------------------------------------------------------
    def _media2feats(self, medianame, start_sec=None, stop_sec=None):
        """Decode [start_sec, stop_sec) + features -> (mspec, loge, t,
        difflen) on the device (the whole file by default)."""
        with self.timers.time("decode"):
            sig = media2sig16kmono(medianame, start_sec, stop_sec,
                                   self.ffmpeg, "auto")
        return self._sig2feats(sig, medianame)

    def _sig2feats(self, sig, medianame="<signal>", keep_pcm=False):
        """-> (mspec, loge, t, difflen), and the uploaded int16 signal
        (or None) with ``keep_pcm``."""
        with self.timers.time("features"):
            mspec, loge, t, pcm = self.frontend.mspec_loge(sig, keep_pcm=True)
        mspec, difflen = short_media_pad(mspec, t, medianame)
        if keep_pcm:
            return mspec, loge, t, difflen, pcm
        return mspec, loge, t, difflen

    def ids_to_lseg(self, ids, start_sec=0.0):
        """Frame-label ids (20 ms hop) -> [(label, start_s, stop_s)], with
        Python float seconds (the csv writes them by repr)."""
        return [(self.labels[lab], start_sec + start * .02,
                 start_sec + stop * .02)
                for lab, start, stop in rle(ids)]

    def _segment(self, mspec, loge, t, difflen, start_sec):
        n_frames_patch, n20 = patch_counts(t, difflen)
        with self.timers.time("segment"):
            ids = self.pipeline.run(mspec, loge, t, n_frames_patch, n20)
            ids = ids.cpu().numpy()[:n20]
        return self.ids_to_lseg(ids, start_sec)

    # ------------------------------------------------------------------
    def segment_feats(self, mspec, loge, difflen, start_sec):
        """Segment host-side features (API parity, segmenter.py:250-276).

        `mspec` (T,24) float32 log-mel, `loge` (T,) log-energy, `difflen`
        as produced by `_media2feats`.
        """
        loge = torch.as_tensor(np.asarray(loge, np.float32),
                               device=self.device)
        mspec = torch.as_tensor(np.asarray(mspec, np.float32),
                                device=self.device)
        return self._segment(mspec, loge, loge.shape[0], difflen, start_sec)

    def __call__(self, medianame, start_sec=None, stop_sec=None):
        """Segment a media file -> [(label, start_s, stop_s)] tiling the
        analyzed window (reference segmenter.py:279-294)."""
        s0 = 0 if start_sec is None else start_sec
        with self.timers.time("decode"):
            sig = media2sig16kmono(medianame, start_sec, stop_sec,
                                   self.ffmpeg, "auto")
        return self.segment_signal(sig, s0, medianame)

    def segment_signal(self, sig, start_sec=0, medianame="<signal>",
                       return_pcm=False):
        """Segment an already-decoded 16 kHz mono signal (int16 or float)
        -> [(label, start_s, stop_s)], or ``(lseg, pcm_parts | None)`` with
        ``return_pcm=True``: ``[x]``, the uploaded int16 signal on the
        device (one part, no lookahead), for int16 input, None for float
        input — the VFS scorer's VBx features reuse that upload.

        Always the fused path (``FusedPipeline.run``: one features launch,
        then the CNNs on the active frames only), whatever the length.  The
        JAX package streams files of two chunks or more here; the port
        keeps the streaming decomposition (``pipeline.run_streaming``) for
        the online family, whose labels equal these
        (tests/test_torch_streaming.py)."""
        mspec, loge, t, difflen, pcm = self._sig2feats(sig, medianame,
                                                       keep_pcm=True)
        ret = self._segment(mspec, loge, t, difflen, start_sec)
        if return_pcm:
            return ret, (None if pcm is None else [pcm])
        return ret

    # ------------------------------------------------------------------
    def batch_process(self, linput, loutput, verbose=False, skipifexist=False,
                      nbtry=1, trydelay=2., output_format="csv"):
        """Batch segmentation with the reference's accounting
        (segmenter.py:297-335): returns (t_batch_dur, nb_processed,
        avg_per_file, [(dst, 0|1|2, status)]).  ``ISS_PREFETCH`` producer
        threads decode and compute the features of the next files while
        this thread segments and exports the current one
        (``utils/prefetch.py``).  A failing file gets an ``error: ...``
        status instead of aborting the batch."""
        if verbose:
            print("batch_processing %d files" % len(linput))
        if output_format == "csv":
            fexport = seg2csv
        elif output_format == "textgrid":
            fexport = seg2textgrid
        else:
            raise NotImplementedError()

        produce = staged_producer(self._media2feats, skipifexist=skipifexist,
                                  nbtry=nbtry, trydelay=trydelay)

        def consume(feats, item, msg):
            b = time.time()
            fexport(self._segment(*feats, 0), item[1])
            return (msg[0], msg[1], "ok " + str(time.time() - b))

        return run_prefetched(list(zip(linput, loutput)), produce, consume,
                              verbose=verbose)


def patch_counts(t, difflen):
    """(n_frames_patch, n20): the reference's 68-frame short-media pad
    arithmetic (segmenter.py:60-66, 150-152)."""
    if difflen > 0:
        return 68, (68 + 1) // 2 - int(difflen / 2)
    return t, (t + 1) // 2


def short_media_pad(mspec, t, medianame):
    """t<68 handling -> (mspec, difflen): warn like the reference
    (segmenter.py:62-66) and pad the mel rows to 68 with their min value."""
    if t >= 68:
        return mspec, 0
    warnings.warn(
        "media %s duration is short. Robust results require length "
        "of at least 720 milliseconds" % medianame)
    if t < 1:
        # the reference crashes the same way deeper in (np.min over an
        # empty array, segmenter.py:62-66); make the error actionable
        raise ValueError(
            "media too short to analyse: no complete 25 ms analysis "
            "window (need >= 400 samples at 16 kHz)")
    m = mspec[:t]
    out = torch.empty((68, m.shape[1]), dtype=torch.float32,
                      device=mspec.device)
    out[:t] = m
    out[t:] = m.min()
    return out, 68 - t
