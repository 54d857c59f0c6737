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
Features come from the frontend :func:`_default_frontend` picks
(``ISS_FRONTEND``): the fused CUDA kernel (``dsp/fe_kernel.py``, whose
int16 uploads take the lossless codec under ``ISS_UPLOAD_CODEC``) or the
host frontend (``dsp/host_fe.py``) on a slow link; the decodes from the
CUDA Viterbi (``decode/viterbi.py``).
"""

from __future__ import annotations

import os
import threading
import time
import warnings

import numpy as np
import torch

from .audio.io import check_ffmpeg, media2sig16kmono
from .decode.transitions import diag_trans_exp
from .decode.viterbi import viterbi_path
from .dsp.fe_kernel import KernelSidekitFrontend
from .dsp.host_fe import HostSidekitFrontend
from .dsp.patches import frame_patches
from .dsp.sidekit import CHUNK, HOP, frame_count
from .export import seg2csv, seg2textgrid
from .models.registry import load_patch_model
from .pipeline import FusedPipeline, rle, stream_gender_enabled
from .utils.device import resolve_device
from .utils.env import require_device
from .utils.prefetch import run_prefetched, staged_producer
from .utils.timing import StageTimers, span


class DnnSegmenter:
    """Patch-CNN segmentation stage (abstract).

    Child classes define `nmel`, `viterbi_arg`, `model_fname`, `inlabel`,
    `outlabels` — same contract as the reference DnnSegmenter
    (segmenter.py:111-125).
    """

    def __init__(self, batch_size=32, allow_download=True, *, device="cuda",
                 model_dir=None):
        require_device(f"{type(self).__name__}()", device)
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

        A CUDA ``device`` is probed first, in a subprocess with a bound
        (``utils.env.require_device``, ``ISS_CTOR_LINK_WAIT``): a stalled
        driver raises ``TimeoutError`` instead of hanging the caller.
        """
        # before anything that initialises CUDA in this process
        require_device("Segmenter()", device)
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

        self.frontend = _default_frontend(self.device)
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
            feats = self.frontend.mspec_loge(sig, keep_pcm=keep_pcm)
        mspec, loge, t = feats[:3]
        mspec, difflen = short_media_pad(mspec, t, medianame)
        if keep_pcm:
            return mspec, loge, t, difflen, feats[3]
        return mspec, loge, t, difflen

    def ids_to_lseg(self, ids, start_sec=0.0):
        """Frame-label ids (20 ms hop) -> [(label, start_s, stop_s)], with
        Python float seconds (the csv writes them by repr)."""
        return [(self.labels[lab], start_sec + start * .02,
                 start_sec + stop * .02)
                for lab, start, stop in rle(ids)]

    def _segment(self, mspec, loge, t, difflen, start_sec):
        return self.ids_to_lseg(self._segment_ids(mspec, loge, t, difflen),
                                start_sec)

    def _segment_ids(self, mspec, loge, t, difflen):
        """The fused pipeline's (n20,) label ids, on the host."""
        n_frames_patch, n20 = patch_counts(t, difflen)
        with self.timers.time("segment"):
            ids = self.pipeline.run(mspec, loge, t, n_frames_patch, n20)
            with span("seg.labels"):
                return ids.cpu().numpy()[:n20]

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
        ``return_pcm=True``: int16 tensors on the device that tile the
        uploaded signal in order, with no overlap and no lookahead, for
        int16 input, None for float input — the VFS scorer's VBx features
        reuse that upload (``dsp.vbx.VbxFrontend.features_from_pcm``).

        Two paths, with the same labels (tests/test_torch_streaming_call.py):

        * fused (``FusedPipeline.run``: one features launch, then the CNNs
          on the active frames only; one PCM part), the port's default;
        * streaming, with ``ISS_STREAMING`` set to anything but ``0`` (the
          JAX package's default): the frontend's upload groups
          (``iter_group_feats``, one features launch a group), each
          chunk's emissions queued as soon as its right halo exists, the
          gender ones too under ``ISS_STREAM_GENDER=1``, then the tail
          (``stream_decode``); one PCM part a group.  Files under 68
          frames or of one chunk take the fused path on the group's rows.

        Fused is the port's default because it runs the VAD CNN on the
        energy-active frames only, where streaming runs it on every frame
        of every chunk; it measured faster on the H100 (PERF.md, section
        5).  The frontend without group launches (the host frontend) is
        always fused.
        """
        if not (streaming_enabled()
                and hasattr(self.frontend, "iter_group_feats")):
            if not return_pcm:
                return self._segment(*self._sig2feats(sig, medianame),
                                     start_sec)
            mspec, loge, t, difflen, pcm = self._sig2feats(sig, medianame,
                                                           keep_pcm=True)
            ret = self._segment(mspec, loge, t, difflen, start_sec)
            return ret, (None if pcm is None else [pcm])
        ret, pcm = self._segment_streaming(sig, start_sec, medianame,
                                           return_pcm)
        return (ret, pcm) if return_pcm else ret

    def _segment_streaming(self, sig, start_sec, medianame, keep_pcm):
        """The interleaved streaming call path (the JAX
        ``segment_signal``'s) -> (lseg, pcm_parts | None)."""
        pipe = self.pipeline
        gender = self.detect_gender and stream_gender_enabled()
        n = len(sig)
        with self.timers.time("features"):
            t = frame_count(n)
            chunks, probs_v, probs_g, pcm = [], [], [], []

            def dispatch_ready():
                # a chunk's emissions need its right neighbour's halo
                while len(probs_v) < len(chunks) - 1:
                    pv, pg = pipe.chunk_emissions(chunks, len(probs_v),
                                                  gender=gender)
                    probs_v.append(pv)
                    probs_g.append(pg)

            for chunks_g, pcm_g in self.frontend.iter_group_feats(
                    sig, keep_pcm=keep_pcm):
                if pcm_g is not None:
                    # drop the group's 2*HOP lookahead (the next group
                    # starts there) and everything past the signal
                    start = len(chunks) * CHUNK * HOP
                    end = min(start + len(chunks_g) * CHUNK * HOP, n)
                    if end > start:
                        pcm.append(pcm_g[:end - start])
                chunks.extend(chunks_g)
                if t >= 68 and len(chunks) >= 2:
                    dispatch_ready()
        pcm = pcm or None
        if t >= 68 and len(chunks) >= 2:
            n20 = (t + 1) // 2
            with self.timers.time("segment"):
                pv, pg = pipe.chunk_emissions(chunks, len(chunks) - 1,
                                              gender=gender)
                probs_v.append(pv)
                probs_g.append(pg)
                ids = pipe.stream_decode(chunks, probs_v, t, t, n20,
                                         probs_g=probs_g if gender else None)
                with span("seg.labels"):
                    ids = ids.cpu().numpy()[:n20]
            return self.ids_to_lseg(ids, start_sec), pcm
        # short or one-chunk media: the fused path on the group's rows
        mspec = torch.cat([m for m, _ in chunks])
        loge = torch.cat([lg for _, lg in chunks])
        mspec, difflen = short_media_pad(mspec, t, medianame)
        return self._segment(mspec, loge, t, difflen, start_sec), pcm

    def refresh_frontend(self):
        """Take the ``ISS_FRONTEND=auto`` choice again against a fresh
        (TTL-cached) link probe; a no-op unless the choice is ``auto`` and
        it flipped.  ``batch_process`` calls it first, so a long-lived
        worker adapts at its next batch (the JAX package's rule)."""
        if os.environ.get("ISS_FRONTEND", "auto") != "auto":
            return self.frontend
        new = _default_frontend(self.device)
        if type(new) is not type(self.frontend):
            self.frontend = new
        return self.frontend

    # ------------------------------------------------------------------
    def batch_process(self, linput, loutput, verbose=False, skipifexist=False,
                      nbtry=1, trydelay=2., output_format="csv"):
        """Batch segmentation with the reference's accounting
        (segmenter.py:297-335): returns (t_batch_dur, nb_processed,
        avg_per_file, [(dst, 0|1|2, status)]).  ``ISS_PREFETCH`` producer
        threads decode and compute the features of the next files while
        this thread segments and exports the current one
        (``utils/prefetch.py``), each file in the span ``seg.file``.  A
        failing file gets an ``error: ...`` status instead of aborting the
        batch."""
        if verbose:
            print("batch_processing %d files" % len(linput))
        if output_format == "csv":
            fexport = seg2csv
        elif output_format == "textgrid":
            fexport = seg2textgrid
        else:
            raise NotImplementedError()
        # a long-lived server's link probe may be stale: choose the
        # frontend again a batch (never mid-batch: one frontend a batch)
        self.refresh_frontend()

        produce = staged_producer(self._media2feats, skipifexist=skipifexist,
                                  nbtry=nbtry, trydelay=trydelay)

        def consume(feats, item, msg):
            b = time.time()
            with span("seg.file"):
                ids = self._segment_ids(*feats)
                with span("seg.export"):
                    fexport(self.ids_to_lseg(ids), item[1])
            return (msg[0], msg[1], "ok " + str(time.time() - b))

        return run_prefetched(list(zip(linput, loutput)), produce, consume,
                              verbose=verbose)


_LINK_LOCK = threading.Lock()
_LINK_MBPS = {}         # device -> (MB/s, time.monotonic() of the probe)


def _link_bandwidth_mbps(device, max_age_s=None):
    """Measured host-to-device bandwidth (MB/s) of ``device``, cached
    for ``ISS_LINK_PROBE_TTL`` seconds (default 600; ``max_age_s``
    overrides, ``float("inf")`` probes once a process).  The JAX
    package's probe: a 4 MB warm-up copy, then 8 MB timed, pageable
    ``torch.from_numpy(...).to(device)`` and a device sync."""
    device = torch.device(device)
    if max_age_s is None:
        max_age_s = float(os.environ.get("ISS_LINK_PROBE_TTL", "600"))
    with _LINK_LOCK:
        now = time.monotonic()
        cached = _LINK_MBPS.get(str(device))
        if cached is None or now - cached[1] > max_age_s:
            def copy(buf):
                torch.from_numpy(buf).to(device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)

            copy(np.zeros(1 << 20, np.float32))       # warm the path
            t0 = time.perf_counter()
            copy(np.ones(2 << 20, np.float32))
            cached = (8.0 / max(time.perf_counter() - t0, 1e-6), now)
            _LINK_MBPS[str(device)] = cached
        return cached[0]


def streaming_enabled():
    """``ISS_STREAMING``: ``Segmenter.segment_signal`` streams when it is
    set to anything but ``0``; unset (or empty) it runs fused, the port's
    default (the JAX package streams when it is unset)."""
    return os.environ.get("ISS_STREAMING", "0") not in ("", "0")


def _default_frontend(device):
    """The frontend for ``device`` (``ISS_FRONTEND``):

    * ``host``: :class:`HostSidekitFrontend`, features on the host CPU,
      only (mspec, loge) uploaded, 3.2x fewer link bytes than int16 PCM;
    * ``auto`` (the default): the host frontend only on a CUDA device
      whose host has at least 4 cores (to hide the FFTs behind the device
      work) and whose link measures under 250 MB/s
      (:func:`_link_bandwidth_mbps`); a CPU device never probes;
    * anything else, the JAX package's ``jnp`` and ``pallas`` included:
      :class:`KernelSidekitFrontend`, the port's one device frontend (the
      JAX package's two are one kernel here).
    """
    device = torch.device(device)
    choice = os.environ.get("ISS_FRONTEND", "auto")
    if choice == "host":
        return HostSidekitFrontend(device)
    if (choice == "auto" and device.type == "cuda"
            and (os.cpu_count() or 1) >= 4
            and _link_bandwidth_mbps(device) < 250):
        return HostSidekitFrontend(device)
    return KernelSidekitFrontend(device)


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
