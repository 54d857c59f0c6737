"""Public segmentation API — the PyTorch port of ``Segmenter``.

Same surface as ``inaspeechsegmenter_tpu/segmenter.py`` (reference
segmenter.py:111-387): ``DnnSegmenter`` subclasses with the same class
attributes, and ``Segmenter(vad_engine, detect_gender, ffmpeg, batch_size,
energy_ratio)`` with ``__call__``, ``segment_signal``, ``segment_feats``
and ``batch_process`` (skipifexist / nbtry / trydelay / status tuples) —
plus an explicit ``device``.  The default device is ``cuda``; a host with
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
from .dsp.fe_kernel import KernelSidekitFrontend
from .export import seg2csv, seg2textgrid
from .models.registry import load_patch_model
from .pipeline import FusedPipeline, rle
from .utils.device import resolve_device
from .utils.prefetch import run_prefetched, staged_producer


class DnnSegmenter:
    """Patch-CNN segmentation stage (abstract).

    Child classes define `nmel`, `viterbi_arg`, `model_fname`, `inlabel`,
    `outlabels` — same contract as the reference DnnSegmenter
    (segmenter.py:111-125).
    """

    def __init__(self, batch_size=32, device="cuda", model_dir=None,
                 allow_download=True):
        device = resolve_device(device)
        self.model = load_patch_model(self.model_fname, model_dir,
                                      allow_download).to(device)
        self.model.eval()
        self.batch_size = batch_size

    def as_pipeline_stage(self):
        return (self.model, self.nmel, len(self.outlabels), self.viterbi_arg)


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
                 batch_size=32, energy_ratio=0.03, device="cuda",
                 model_dir=None, allow_download=True):
        """Load models and build the pipeline on ``device``.

        Same parameters as the reference ctor (segmenter.py:208-247), plus
        ``device`` (explicit; ``cuda`` needs a CUDA device), ``model_dir``
        (the first model directory searched) and ``allow_download`` (the
        JAX package's).  ``ffmpeg=None`` accepts 16 kHz WAV input only.
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
        self.vad = vad_cls(batch_size, self.device, model_dir, allow_download)

        if detect_gender not in (True, False):
            raise ValueError(f"detect_gender must be a bool, got "
                             f"{detect_gender!r}")
        self.detect_gender = detect_gender
        if detect_gender:
            self.gender = Gender(batch_size, self.device, model_dir,
                                 allow_download)

        self.frontend = KernelSidekitFrontend(self.device)
        self.pipeline = FusedPipeline(
            self.vad.as_pipeline_stage(),
            self.gender.as_pipeline_stage() if detect_gender else None,
            energy_ratio=energy_ratio, device=self.device)
        # label-id -> name table used to decode the pipeline output
        self.labels = ["noEnergy"] + list(self.vad.outlabels)
        if detect_gender:
            self.labels += list(self.gender.outlabels)

    # ------------------------------------------------------------------
    def _media2feats(self, medianame):
        """Decode + features -> (mspec, loge, t, difflen) on the device."""
        return self._sig2feats(media2sig16kmono(
            medianame, ffmpeg=self.ffmpeg, dtype="auto"), medianame)

    def _sig2feats(self, sig, medianame="<signal>"):
        mspec, loge, t = self.frontend.mspec_loge(sig)
        mspec, difflen = short_media_pad(mspec, t, medianame)
        return mspec, loge, t, difflen

    def ids_to_lseg(self, ids, start_sec=0.0):
        """Frame-label ids (20 ms hop) -> [(label, start_s, stop_s)], with
        Python float seconds (the csv writes them by repr)."""
        return [(self.labels[lab], start_sec + start * .02,
                 start_sec + stop * .02)
                for lab, start, stop in rle(ids)]

    def _segment(self, mspec, loge, t, difflen, start_sec):
        n_frames_patch, n20 = patch_counts(t, difflen)
        ids = self.pipeline.run(mspec, loge, t, n_frames_patch, n20)
        return self.ids_to_lseg(ids.cpu().numpy()[:n20], start_sec)

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
        sig = media2sig16kmono(medianame, start_sec, stop_sec, self.ffmpeg,
                               "auto")
        return self.segment_signal(sig, s0, medianame)

    def segment_signal(self, sig, start_sec=0, medianame="<signal>"):
        """Segment an already-decoded 16 kHz mono signal (int16 or float)
        -> [(label, start_s, stop_s)].

        Always the fused path (``FusedPipeline.run``: one features launch,
        then the CNNs on the active frames only), whatever the length.  The
        JAX package streams files of two chunks or more here; the port
        keeps the streaming decomposition (``pipeline.run_streaming``) for
        the online family, whose labels equal these
        (tests/test_torch_streaming.py)."""
        mspec, loge, t, difflen = self._sig2feats(sig, medianame)
        return self._segment(mspec, loge, t, difflen, start_sec)

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
