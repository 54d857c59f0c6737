"""Voice Femininity Scoring — the VBx x-vector pipeline, PyTorch port.

Same contract as ``inaspeechsegmenter_tpu/vfs.py`` (reference
vbx_segmenter.py:92-202): ``VoiceFemininityScoring(gd_model_criteria,
backend)(fpath)`` returns ``(score | None, speech_duration,
n_retained_xvectors)`` with the same VAD-overlap filtering (midpoint in
speech, overlap >= threshold, >= 50% back-fill) and window bookkeeping
(144-frame windows, step 24, tail >= 10 frames, x-vectors scaled x10, NaN
windows dropped), plus the keyword-only ``device`` (``cuda`` by default;
no CUDA device raises) and ``model_dir``.

The VAD is the port's ``Segmenter("smn", detect_gender=False)``, so a VFS
run launches the SIDEKIT feature and Viterbi kernels.  VBx features,
the ResNet101 and the MLP run as plain PyTorch (cuDNN / cuBLAS, the
ResNet at the ``ISS_XVEC_PRECISION`` tier and the MLP at the
``ISS_CNN_PRECISION`` tier, both float32 with TF32 off by default); the
JAX package has no Pallas kernel on this path.  Media decode through
ffmpeg, and the MLP's registry resolution (released ``.hdf5`` or its
converted npz), are the Segmenter's.  Full windows are gathered on the
device from the feature tensor and run through the ResNet in sub-batches
of ``ISS_XVEC_BATCH`` (default 256); the ragged tail window runs through
the masked forward, or unpadded with ``ISS_XVEC_TAIL=exact``.  The last
sub-batch is padded to a power-of-two bucket (``_xvec_layout``), so every
forward runs at one of a few batch sizes.

On a CUDA device the VBx features take the int16 grid
(``dsp.vbx.vbx_i16_enabled``): an int16 signal's features come from the
VAD's own upload (``Segmenter.segment_signal(return_pcm=True)``), with no
host work of their own; under the host frontend, which uploads no
samples, they take their own (``VbxFrontend._features_i16``, through the
upload codec where it is on).  ``batch_score`` prefetches the next files' VAD
and VBx features on producer threads; ``online.OnlineVFS`` scores a
growing recording.  With ``mesh=`` each sub-batch of windows is split
over the mesh's slots, one ResNet replica each (``parallel/mesh.py``).

With ``ISS_VFS_OVERLAP`` set to a value other than ``auto`` (the default)
and ``0``, an eligible int16 signal (``_overlap_eligible``: the standard
VAD, the one-device extractor, the int16 grid, more than one feature
chunk) takes the overlapped speculative scorer, the JAX package's default
VFS path: as each upload group's features land, a provisional speech
mask of each chunk (``_prov_step``) picks windows whose ResNet
sub-batches are queued at once behind the VAD's own work
(``_EmbedSession``); the exact decoded timeline then makes the final
selection, the windows it missed are embedded in one catch-up batch and
the extras are dropped, so the result equals the serial path's.
``ISS_VFS_PROV_DILATE`` (default 12 frames of 20 ms) widens the mask, as
in the JAX package.  Everything runs on one stream, in the order queued.
``auto`` takes the serial schedule: on an H100 the device is busy 94-96%
of a serial VFS run, so the speculation finds no idle time to fill and
its extra windows only add work (PERF.md, section 5).
"""

from __future__ import annotations

import inspect
import logging
import os
import time

import numpy as np
import torch

from .annotations import SpeechTimeline
from .audio.io import check_ffmpeg, media2sig16kmono
from .dsp import vbx
from .dsp.sidekit import CHUNK, frame_count
from .dsp.vbx import VbxFrontend
from .models.registry import load_patch_model, resolve_xvector_weights
from .models.resnet import ResNet101XVector, pooled_freq
from .pipeline import _finite_sums
from .segmenter import Segmenter
from .utils.device import (read_host_copy, resolve_device, start_host_copy,
                           upload)
from .utils.env import require_device
from .utils.prefetch import run_prefetched, staged_producer
from .utils.retry import retry_call
from .utils.timing import count, span

logger = logging.getLogger(__name__)

STEP = 24
WINLEN = 144
FEAT_DIM = 64
EMBED_DIM = 256
SR = 16000


def add_needed_vectors(xvectors, t_mid):
    """Back-fill best-VAD-overlap windows until >= 50% are retained
    (reference vbx_segmenter.py:40-52)."""
    min_pred = round(0.5 * len(t_mid))
    if len(xvectors) < min_pred:
        t_mid = sorted(t_mid, key=lambda e: e[0], reverse=True)
        diff = min_pred - len(xvectors)
        for _, k, seg, x in t_mid[len(xvectors):len(xvectors) + diff]:
            xvectors.append((k, seg, x))
    return xvectors


def get_femininity_score(g_preds):
    """Fraction of retained windows with p >= 0.5
    (reference vbx_segmenter.py:55-61)."""
    return sum(1 for _, _, p in g_preds if p >= 0.5) / len(g_preds)


def score_to_csv(result, dst):
    """Write one (score, speech_duration, nb_vectors) result as the VFS
    csv row."""
    score, speech_dur, n_vec = result
    with open(dst, "w") as fh:
        fh.write("score\tspeech_duration\tnb_vectors\n")
        fh.write("%s\t%s\t%d\n" % (
            "" if score is None else repr(float(score)),
            repr(float(speech_dur)), n_vec))


def _accepts_timeline(extractor):
    """True if the x-vector extractor takes a ``timeline`` kwarg (the
    speech-only path).  Reference-style extractors are called with exactly
    (basename, features, duration) — vbx_segmenter.py:182."""
    try:
        params = inspect.signature(extractor).parameters
    except (TypeError, ValueError):
        return False
    return ("timeline" in params
            or any(p.kind == inspect.Parameter.VAR_KEYWORD
                   for p in params.values()))


class TorchResnetExtractor:
    """Batched x-vector extractor, the counterpart of the JAX package's
    ``JaxResnetExtractor``.

    :param params: a JAX-package parameter pytree (numpy arrays, e.g. from
        ``ResNetXVector.init_params`` or ``_load_resnet_npz``); else the
        weights are read from the model directory
        (``registry.resolve_xvector_weights``).
    :param net: a ``ResNetXVector`` module (default: ResNet101, 64 bands,
        256-d); it is moved to ``device``.
    :param mesh: a 1-D ``parallel.mesh.Mesh``: every sub-batch is split
        evenly over its slots, each running its own replica of the net on
        its own thread and stream, and the embeddings are gathered in
        order; the ragged tail window runs on ``device``.
    """

    def __init__(self, params=None, net=None, device="cuda", model_dir=None,
                 mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.net = net if net is not None else ResNet101XVector(
            feat_dim=FEAT_DIM, embed_dim=EMBED_DIM)
        if params is None:
            path = resolve_xvector_weights(model_dir)
            if path.endswith(".npz"):
                params = _load_resnet_npz(path)
            elif path.endswith(".pth"):
                self.net.load_torch_checkpoint(path)
            else:
                params = _load_resnet_onnx(self.net, path)
        if params is not None:
            self.net.load_jax_params(params)
        self.net = self.net.to(self.device).eval()
        if mesh is not None:
            from .parallel.mesh import replicate, slot_streams

            self.slot_devices = list(mesh.devices.flat)
            self.replicas = replicate(mesh, self.net)
            self.streams = slot_streams(self.slot_devices)

    def _xvec_layout(self):
        """(sub, buckets): the sub-batch size ``ISS_XVEC_BATCH`` (default
        256) and the ladder of batch sizes a forward runs at, the powers of
        two capped at ``sub``, each rounded up to a multiple of the mesh's
        slots (the JAX package's mesh-rounded ladder; no mesh or a 1-slot
        mesh: the plain ladder).  Every bucket maps to itself, so a padded
        group is run as it is."""
        sub = max(1, int(os.environ.get("ISS_XVEC_BATCH", "256")))
        n = 1 if self.mesh is None else self.mesh.devices.size
        sub = -(-sub // n) * n
        buckets = sorted({-(-min(1 << p, sub) // n) * n
                          for p in range((sub - 1).bit_length() + 1)})
        return sub, buckets

    def _forward(self, part):
        """(B, 64, T) windows -> (B, 256) embeddings on ``device``: the net
        on ``device``, or with a mesh B/slots windows on each slot."""
        if self.mesh is None:
            return self.net(part)
        from .parallel.mesh import run_on_slots

        n = len(self.slot_devices)
        items = [p.to(d) for p, d in zip(part.chunk(n), self.slot_devices)]
        outs = run_on_slots(lambda k, x: self.replicas[k](x), items,
                            self.slot_devices, self.streams)
        return torch.cat([o.to(self.device) for o in outs])

    @torch.no_grad()
    def get_embeddings_batch(self, windows):
        """(B, 64, T) stacked windows (array or tensor) -> (B, 256) numpy,
        in sub-batches of ``sub``, the last zero-padded to its bucket.
        BatchNorm uses running statistics and pooling is per window, so
        neither the split nor the padding changes a window's embedding
        (beyond the convolution algorithm cuDNN or oneDNN picks for the
        batch size)."""
        b = len(windows)
        if b == 0:
            return np.zeros((0, self.net.embed_dim), np.float32)
        sub, buckets = self._xvec_layout()
        w = torch.as_tensor(windows, dtype=torch.float32, device=self.device)
        outs = []
        for g in range(0, b, sub):
            k = min(sub, b - g)
            bucket = next(x for x in buckets if x >= k)
            part = w[g:g + k]
            if bucket != k:
                part = torch.cat([part, part.new_zeros(
                    (bucket - k,) + tuple(part.shape[1:]))])
            count("xvec.windows", k)
            with span("xvec.forward"):
                outs.append(self._forward(part)[:k])
        with span("xvec.sync"):
            return torch.cat(outs).cpu().numpy()

    @torch.no_grad()
    def embeddings_from_features(self, fea, starts):
        """Gather the (len(starts), 64, WINLEN) windows from the on-device
        feature tensor and embed them -> (len(starts), 256) numpy.  Windows
        are gathered one sub-batch at a time, which bounds the memory, and
        ``get_embeddings_batch`` pads the last to its bucket."""
        nw = len(starts)
        if nw == 0:
            return np.zeros((0, self.net.embed_dim), np.float32)
        sub, _ = self._xvec_layout()
        st = torch.as_tensor(np.asarray(starts, np.int64), device=fea.device)
        offs = torch.arange(WINLEN, device=fea.device)
        return np.concatenate([self.get_embeddings_batch(
            fea[st[g:g + sub, None] + offs[None, :]].transpose(1, 2))
            for g in range(0, nw, sub)])

    @torch.no_grad()
    def dispatch_windows(self, fea, starts):
        """Gather and embed ONE sub-batch of full windows -> the
        (len(starts), 256) tensor on the device, with no host sync: the
        overlapped scorer's speculative unit.  Callers pass a
        ``_xvec_layout`` size, so every forward runs at a ladder size; a
        window's embedding does not depend on the rest of its batch."""
        st = upload(np.asarray(starts, np.int64), fea.device)
        offs = torch.arange(WINLEN, device=fea.device)
        windows = fea[st[:, None] + offs[None, :]].transpose(1, 2)
        with span("xvec.forward"):
            return self._forward(windows)

    @torch.no_grad()
    def get_embedding(self, fea):
        """Embedding of one (T, 64) window at its own length."""
        count("xvec.windows")
        with span("xvec.forward"):
            out = self.net(fea.T[None])
        with span("xvec.sync"):
            return out[0].cpu().numpy()

    @torch.no_grad()
    def get_embedding_masked(self, fea, start, length):
        """Tail-window embedding: the window zero-padded (by a clamped
        gather) to WINLEN and run through the masked forward at its true
        length."""
        t = fea.shape[0]
        idx = torch.clamp(start + torch.arange(WINLEN, device=fea.device),
                          max=t - 1)
        count("xvec.windows")
        window, lengths = fea[idx].T[None], torch.tensor([length],
                                                          device=fea.device)
        with span("xvec.forward"):
            out = self.net(window, lengths)
        with span("xvec.sync"):
            return out[0].cpu().numpy()

    def __call__(self, basename, fea, duration, timeline=None, embed=None):
        """Reference-compatible VBxExtractor.__call__
        (vbx_segmenter.py:217-246): returns [(key, (seg_start, seg_end),
        xvector*10)].

        ``timeline``: optional ``SpeechTimeline``; windows whose midpoint is
        not in speech are skipped before the ResNet runs (``apply_vad``
        would discard them anyway).
        ``embed(fea, starts) -> (len(starts), 256)``: where the full
        windows' raw embeddings come from (default
        ``embeddings_from_features``; ``OnlineVFS.finalize`` hands its
        cache plus a catch-up batch).

        The window list, the midpoint filter and the NaN filter run in the
        span ``vfs.select``.
        """
        fea = torch.as_tensor(fea, dtype=torch.float32, device=self.device)
        speech_only = timeline is not None
        embed = embed or self.embeddings_from_features

        def midpoint_in_speech(seg):
            # the exact midpoint apply_vad will test (same rounding)
            return timeline.contains_point((seg[0] + seg[1]) / 2)

        n = int(fea.shape[0])
        xvectors = []
        with span("vfs.select"):
            starts = list(range(0, n - WINLEN, STEP))
            segs = [(round(s / 100.0, 3),
                     round(s / 100.0 + WINLEN / 100.0, 3)) for s in starts]
            if speech_only:
                kept = [i for i, seg in enumerate(segs)
                        if midpoint_in_speech(seg)]
            else:
                kept = list(range(len(starts)))
        embs = embed(fea, [starts[i] for i in kept])
        with span("vfs.select"):
            for i, emb in zip(kept, embs):
                key = f"{basename}_{starts[i]:08}-{starts[i] + WINLEN:08}"
                if np.isnan(emb).any():
                    logger.warning(
                        f"NaN found, not processing: {key}{os.linesep}")
                else:
                    xvectors.append((key, segs[i], emb))
            # with no full window the tail starts at frame STEP (reference
            # quirk)
            start = starts[-1] if starts else 0
            tail_seg = (round((start + STEP) / 100.0, 3), round(duration, 3))
            tail = n - start - STEP >= 10 and (
                not speech_only or midpoint_in_speech(tail_seg))
        if tail:
            if os.environ.get("ISS_XVEC_TAIL", "masked") == "exact":
                emb = self.get_embedding(fea[start + STEP:])
            else:
                emb = self.get_embedding_masked(fea, start + STEP,
                                                n - (start + STEP))
            key = f"{basename}_{start + STEP:08}-{n:08}"
            if np.isnan(emb).any():
                logger.warning(f"NaN found, not processing: {key}{os.linesep}")
            else:
                xvectors.append((key, tail_seg, emb))
        return [(key, seg, x * 10) for key, seg, x in xvectors]


def _prov_step(pipe, s, cnt, probs_v, loge_c):
    """One provisional-VAD step of the overlapped scorer (the JAX
    ``_prov_step``) -> ``(s, cnt, mask)``, all on the device, no host sync.

    Chunk c's finite log-energies fold into the running sum ``s`` and
    count ``cnt`` (float32 device scalars); its (CHUNK,) frames then take
    the pipeline's energy decode under the running threshold, and its
    (CHUNK/2,) 20 ms frames the pipeline's masked VAD decode.  ``mask``:
    the chunk's provisional speech frames.  Heuristic only (the chunk's
    edges and the running threshold can disagree with the whole file's
    decode): it picks the windows embedded early, and the exact timeline
    makes the final call.
    """
    chunk_sum, chunk_cnt = _finite_sums(loge_c)
    s, cnt = s + chunk_sum, cnt + chunk_cnt
    energy20 = pipe._energy_decode20(loge_c, s, cnt, pipe.e_init)
    v_states = pipe._masked_viterbi(probs_v, energy20, pipe.v_trans,
                                    pipe.v_init)
    return s, cnt, energy20 & (v_states == 0)


class _EmbedSession:
    """The overlapped scorer's speculative embeddings.

    Windows queue as their provisional verdicts arrive; each full
    ``_xvec_layout`` sub-batch is dispatched at once, and its embeddings'
    copy to the host starts behind it (``start_host_copy``).  ``collect``
    reads them, each after its own event, and embeds the windows the
    speculation missed in one catch-up batch; ``n_speculative``,
    ``n_needed`` and ``n_caught_up`` count the windows.
    """

    def __init__(self, xm):
        self.xm = xm
        self.sub, self.buckets = xm._xvec_layout()
        self.pending = []
        self.batches = []           # (real starts, host copy)
        self.n_needed = self.n_caught_up = 0

    def _dispatch(self, starts, real, fea):
        count("xvec.windows", len(real))
        self.batches.append((real, start_host_copy(
            self.xm.dispatch_windows(fea, starts))))

    def queue(self, start, fea):
        self.pending.append(start)
        if len(self.pending) >= self.sub:
            batch, self.pending = (self.pending[:self.sub],
                                   self.pending[self.sub:])
            self._dispatch(batch, batch, fea)

    def flush(self, fea):
        """Dispatch the ragged remainder, padded with window 0 to its
        layout bucket (the pads are dropped at ``collect``)."""
        if self.pending:
            k = len(self.pending)
            bucket = next(x for x in self.buckets if x >= k)
            self._dispatch(self.pending + [0] * (bucket - k), self.pending,
                           fea)
            self.pending = []

    def collect(self, fea, needed):
        """The extractor's ``embed``: the raw embeddings of ``needed``
        window starts, speculative ones and one catch-up batch."""
        done = {}
        for batch, copy in self.batches:
            done.update(zip(batch, read_host_copy(copy)))
        missing = [s for s in needed if s not in done]
        done.update(zip(missing, self.xm.embeddings_from_features(
            fea, missing)))
        self.n_needed, self.n_caught_up = len(needed), len(missing)
        return [done[s] for s in needed]

    @property
    def n_speculative(self):
        return sum(len(b) for b, _ in self.batches) + len(self.pending)


class VoiceFemininityScoring:
    """Voice femininity scoring with the reference constructor contract
    (vbx_segmenter.py:97-127), on ``device``."""

    def __init__(self, gd_model_criteria="bgc", backend="jax",
                 allow_download=True, xvector_params=None, xvector_net=None,
                 ffmpeg="ffmpeg", mesh=None, *, device="cuda",
                 model_dir=None):
        """The JAX package's parameters in its order, plus the keyword-only
        ``device`` and ``model_dir``.

        :param backend: ``jax``, ``onnx`` or ``pytorch``, checked as the
            JAX package does and otherwise ignored (the port runs PyTorch).
        :param allow_download: fetch a missing MLP from its release URL.
        :param xvector_params: a JAX-package ResNet parameter pytree.
        :param xvector_net: a ``ResNetXVector`` module (default ResNet101).
        :param ffmpeg: the ffmpeg binary decoding any media, or ``None``
            (WAV input only).
        :param mesh: a 1-D ``parallel.mesh.Mesh``: the ResNet's window
            sub-batches are split over its slots (``TorchResnetExtractor``);
            the result is the one-device result.
        :param model_dir: the first model directory searched (see
            ``models.registry``).

        The process's TF32 flags are left alone: the ResNet, the MLP, the
        VAD CNN and the VBx features each run in their own tier's scope,
        which holds a lock, also on ``batch_score``'s producer threads
        (``models.layers.precision_scope``).
        """
        if backend not in ("jax", "onnx", "pytorch"):
            raise ValueError("backend must be 'jax', 'onnx' or 'pytorch' "
                             f"(accepted for API parity), got {backend!r}")
        if gd_model_criteria not in ("bgc", "vfp"):
            raise ValueError("Gender detection model criteria must be 'bgc' "
                             f"or 'vfp', got {gd_model_criteria!r}")
        # a bounded probe before anything initialises CUDA in-process
        # (ISS_CTOR_LINK_WAIT; utils.env.require_device)
        require_device("VoiceFemininityScoring()", device)
        self.device = resolve_device(device)
        self.ffmpeg = check_ffmpeg(ffmpeg)
        self.xvector_model = TorchResnetExtractor(
            xvector_params, xvector_net, self.device, model_dir, mesh)
        if gd_model_criteria == "bgc":
            gd_model = "interspeech2023_all.hdf5"
            self.vad_thresh = 0.7
        else:
            gd_model = "interspeech2023_cvfr.hdf5"
            self.vad_thresh = 0.62
        self.gender_detection_mlp_model = load_patch_model(
            gd_model, model_dir, allow_download).to(self.device).eval()
        self.vad = Segmenter(vad_engine="smn", detect_gender=False,
                             ffmpeg=ffmpeg, allow_download=allow_download,
                             device=self.device, model_dir=model_dir)
        self.features = VbxFrontend(self.device)
        self.overlap_stats = None   # the last overlapped run's window counts

    def apply_vad(self, xvectors, timeline: SpeechTimeline):
        """Keep windows whose midpoint is in speech and whose speech overlap
        >= vad_thresh; back-fill to >= 50% (vbx_segmenter.py:129-145)."""
        midpoint_seg = []
        n_xvectors = []
        for key, (start, stop), x in xvectors:
            if timeline.contains_point((start + stop) / 2):
                dur = stop - start
                overlap = timeline.overlap_duration(start, stop)
                if overlap / dur >= self.vad_thresh:
                    n_xvectors.append((key, (start, stop), x))
                midpoint_seg.append((overlap / dur, key, (start, stop), x))
        return add_needed_vectors(n_xvectors, midpoint_seg)

    def _prepare(self, fpath):
        """Decode + VAD + VBx features (everything before the ResNet):
        -> (basename, fea | None, timeline, duration, speech_duration)."""
        with span("vfs.prepare"):
            return self._prepare_decoded(fpath, media2sig16kmono(
                fpath, ffmpeg=self.ffmpeg, dtype="auto"))

    def _prepare_decoded(self, fpath, sig):
        """``_prepare`` of the file's ``dtype="auto"`` decode ``sig``."""
        basename = os.path.splitext(os.path.basename(fpath))[0]
        # a non-PCM16 source is decoded once more in float64 for the
        # features, as the reference does (vbx_segmenter.py:160-164)
        signal = None if sig.dtype == np.int16 else media2sig16kmono(
            fpath, ffmpeg=self.ffmpeg, dtype="float64")
        if not hasattr(self.vad, "segment_signal"):
            # reference duck-type contract: `vad` is CALLED with the path
            # (vbx_segmenter.py:164), so a plain callable can replace it
            vad_seg = self.vad(fpath)
            return self._finish_prepare(sig, signal, None, basename, vad_seg)
        return self._prepare_signal(sig, basename, signal64=signal,
                                    medianame=fpath)

    def _prepare_signal(self, sig, basename="<signal>", signal64=None,
                        medianame="<signal>"):
        """VAD + VBx features for an already-decoded 16 kHz mono signal.
        An int16 signal's upload for the VAD is kept for the features."""
        if signal64 is None and sig.dtype != np.int16:
            # a float signal IS the feature signal (no int16 scaling)
            signal64 = np.asarray(sig, np.float64)
        pcm = None
        if sig.dtype == np.int16:
            vad_seg, pcm = self.vad.segment_signal(sig, 0, medianame,
                                                   return_pcm=True)
        else:
            vad_seg = self.vad.segment_signal(sig, 0, medianame)
        return self._finish_prepare(sig, signal64, pcm, basename, vad_seg)

    def _finish_prepare(self, sig, signal, pcm, basename, vad_seg):
        n_samples = len(sig)
        duration = n_samples / SR
        timeline = SpeechTimeline.from_vad(vad_seg)
        speech_duration = timeline.total_duration()
        fea = None
        if speech_duration:
            with span("vfs.vbx_features"):
                if (pcm is not None and n_samples >= 400
                        and vbx.vbx_i16_enabled(self.device)):
                    fea = self.features.features_from_pcm(pcm, n_samples)
                else:
                    if signal is None:
                        signal = sig.astype(np.float64) / 32768.0
                    fea = self.features.features(signal)
        return basename, fea, timeline, duration, speech_duration

    def score_signal(self, sig, basename="<signal>"):
        """Score an already-decoded 16 kHz mono signal (int16, or float in
        [-1, 1]) -> (score | None, speech_duration_s, n_retained_xvectors);
        the same result as ``__call__`` on a file that decodes to ``sig``."""
        if not hasattr(self.vad, "segment_signal"):
            raise TypeError(
                "score_signal needs the standard Segmenter VAD (an injected "
                "path-based VAD callable cannot consume a signal)")
        sig = np.asarray(sig)
        if self._overlap_eligible() and self._overlap_eligible_signal(sig):
            return self._score_signal_overlapped(sig, basename)
        return self._score_prepared(self._prepare_signal(sig, basename))

    def _score_prepared(self, prepared):
        """ResNet + gender MLP on prepared features
        -> (score | None, speech_duration_s, n_retained_xvectors)."""
        basename, fea, timeline, duration, speech_duration = prepared
        if not speech_duration:
            return None, speech_duration, 0
        if _accepts_timeline(self.xvector_model):
            x_vectors = self.xvector_model(basename, fea, duration,
                                           timeline=timeline)
        else:
            # reference duck-type contract (vbx_segmenter.py:182)
            x_vectors = self.xvector_model(basename, fea, duration)
        return self._score_xvectors(x_vectors, timeline, speech_duration)

    def _score_xvectors(self, x_vectors, timeline, speech_duration):
        """apply_vad -> gender MLP -> femininity score."""
        with span("vfs.apply_vad"):
            x_vectors = self.apply_vad(x_vectors, timeline)
        if not x_vectors:
            # a speech sliver can leave no window midpoint in speech: the
            # score is undefined, as with no speech.  The reference crashes
            # here (ZeroDivisionError, vbx_segmenter.py:55-61) — a
            # deliberate deviation.
            return None, speech_duration, 0
        with span("vfs.mlp"):
            pred = np.atleast_1d(np.asarray(self.mlp_probabilities(
                np.asarray([x for _, _, x in x_vectors]))).squeeze())
            g_preds = [(seg[0], seg[1], float(p))
                       for (_, seg, _), p in zip(x_vectors, pred)]
            score = get_femininity_score(g_preds)
        return score, speech_duration, len(g_preds)

    @torch.no_grad()
    def mlp_probabilities(self, x):
        """(N, 256) x-vectors (x10) -> the MLP's (N, 1) numpy output."""
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return self.gender_detection_mlp_model(x).cpu().numpy()

    def __call__(self, fpath):
        """-> (score | None, speech_duration_s, n_retained_xvectors)."""
        if not self._overlap_eligible():
            return self._score_prepared(self._prepare(fpath))
        sig = media2sig16kmono(fpath, ffmpeg=self.ffmpeg, dtype="auto")
        if self._overlap_eligible_signal(sig):
            return self._score_signal_overlapped(
                sig, os.path.splitext(os.path.basename(fpath))[0])
        return self._score_prepared(self._prepare_decoded(fpath, sig))

    # -- the overlapped scorer ---------------------------------------------
    #
    # The serial shape is [upload + VAD] then [x-vectors]: the windows to
    # embed are known only once the whole timeline is decoded.  The
    # overlapped scorer speculates instead: as each upload group lands, its
    # PCM feeds the VBx feature blocks (``VbxPcmStream``, equal to the
    # whole-file features bit for bit) and each chunk's provisional mask
    # picks the windows to embed now.  The result does not depend on the
    # mask: an embedding depends only on final feature rows, the final
    # selection re-runs the reference filters on the exact timeline, and
    # misses are caught up (tests/test_torch_vfs_overlap.py).

    def _overlap_eligible(self):
        """The gates that do not depend on the signal: ``ISS_VFS_OVERLAP``
        neither ``auto`` nor ``0`` (the JAX package's ``auto`` takes the
        overlap; here it takes the serial schedule, see the module's
        docstring), ``ISS_STREAMING`` not ``0`` (the streaming kill
        switch, as in the JAX package), the standard Segmenter VAD with a
        frontend of group computations (not the host frontend), the
        one-device x-vector extractor and the int16 VBx grid."""
        return (os.environ.get("ISS_VFS_OVERLAP", "auto") not in ("auto",
                                                                  "0")
                and os.environ.get("ISS_STREAMING") != "0"
                and isinstance(self.vad, Segmenter)
                and hasattr(self.vad.frontend, "iter_group_feats")
                and isinstance(self.xvector_model, TorchResnetExtractor)
                and self.xvector_model.mesh is None
                and isinstance(self.features, VbxFrontend)
                and vbx.vbx_i16_enabled(self.device))

    @staticmethod
    def _overlap_eligible_signal(sig):
        """int16 PCM of more than one feature chunk (which implies the
        JAX gates' 400 samples and 68 frames)."""
        return sig.dtype == np.int16 and frame_count(len(sig)) > CHUNK

    @torch.no_grad()
    def _score_signal_overlapped(self, sig, basename="<signal>"):
        """Score an int16 signal with the ResNet queued behind the VAD;
        the serial ``score_signal``'s result.  The window counts of the
        run are left in ``overlap_stats``."""
        seg = self.vad
        pipe = seg.pipeline
        n = len(sig)
        t = frame_count(n)
        n20 = (t + 1) // 2
        vstream = vbx.VbxPcmStream(self.features, n)
        session = _EmbedSession(self.xvector_model)
        dilate = max(0, int(os.environ.get("ISS_VFS_PROV_DILATE", "12")))
        # every full window's start in VBx frames, and the 20 ms frame
        # holding its midpoint
        all_starts = np.arange(0, (n - 80) // 160 + 1 - WINLEN, STEP)
        queued = np.zeros(len(all_starts), bool)
        mid20 = np.minimum(((all_starts + WINLEN / 2) / 100.0 / 0.02)
                           .astype(np.int64), max(n20 - 1, 0))
        chunks, probs = [], []
        masks = []              # host copies of each chunk's mask
        masks_np = []           # the prefix of them read so far
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        stats = (zero, zero)

        def dispatch_chunk_work():
            """Emissions and the provisional mask of every chunk whose
            right halo has arrived; the mask's copy to the host starts at
            once and is read one group later."""
            nonlocal stats
            while len(probs) < len(chunks) - 1:
                c = len(probs)
                probs.append(pipe.chunk_emissions(chunks, c)[0])
                s, cnt, mask = _prov_step(pipe, *stats, probs[c],
                                          chunks[c][1])
                stats = (s, cnt)
                masks.append(start_host_copy(mask))

        def select_and_embed(ready):
            """Read the masks of the first ``ready`` chunks and queue every
            window whose feature rows are final and whose midpoint is
            provisional speech (within ``dilate`` frames)."""
            while len(masks_np) < min(ready, len(masks)):
                masks_np.append(read_host_copy(masks[len(masks_np)]))
            if not masks_np:
                return
            prov = np.concatenate(masks_np)
            if dilate:
                c = np.zeros(len(prov) + 1, np.int64)
                np.cumsum(prov, out=c[1:])
                lo = np.maximum(np.arange(len(prov)) - dilate, 0)
                hi = np.minimum(np.arange(len(prov)) + dilate + 1, len(prov))
                prov = (c[hi] - c[lo]) > 0
            ok = (~queued & (all_starts + WINLEN <= vstream.frames_ready)
                  & (mid20 < len(prov)))
            ok[ok] = prov[mid20[ok]]
            for i in np.flatnonzero(ok):
                queued[i] = True
                session.queue(int(all_starts[i]), vstream.fea_buffer)

        pending_pcm = None
        for chunks_g, pcm in seg.frontend.iter_group_feats(sig,
                                                           keep_pcm=True):
            # this group's upload and features are queued: queue the
            # dependent work, then read the masks of the groups before
            ready_before = len(masks)
            chunks.extend(chunks_g)
            if pending_pcm is not None:
                # the next group's PCM starts at the lookahead's first
                # sample: strip its 2*HOP samples
                vstream.append(pending_pcm[:pending_pcm.shape[0] - 320])
            pending_pcm = pcm
            dispatch_chunk_work()
            select_and_embed(ready_before)
        vstream.append(pending_pcm)
        # the last chunk has no right halo (run_streaming's frontier)
        probs.append(pipe.chunk_emissions(chunks, len(chunks) - 1)[0])
        select_and_embed(len(masks))
        session.flush(vstream.fea_buffer)

        ids = pipe.stream_decode(chunks, probs, t, t, n20)[:n20]
        timeline = SpeechTimeline.from_vad(seg.ids_to_lseg(ids.cpu().numpy()))
        speech_duration = timeline.total_duration()
        result = (None, speech_duration, 0)
        if speech_duration:
            x_vectors = self.xvector_model(basename, vstream.finish(), n / SR,
                                           timeline=timeline,
                                           embed=session.collect)
            result = self._score_xvectors(x_vectors, timeline,
                                          speech_duration)
        self.overlap_stats = {"dispatched": session.n_speculative,
                              "needed": session.n_needed,
                              "caught_up": session.n_caught_up}
        return result

    # ------------------------------------------------------------------
    def batch_score(self, linput, loutput, verbose=False, skipifexist=False,
                    nbtry=1, trydelay=2.):
        """Score a list of files, one tab-separated csv per input.

        Returns (total_duration_s, n_processed, avg_s_per_file, lmsg) with
        lmsg entries (dst, 0|1|2, 'ok t'|'already exists'|'error: ...').
        ``ISS_PREFETCH`` producer threads run decode + VAD + VBx features of
        the next files (``_prepare``) while this thread runs the current
        file's ResNet and MLP (``utils/prefetch.py``), each file in the
        span ``vfs.score``; both phases get the ``nbtry`` / ``trydelay``
        retry budget.
        """
        if verbose:
            print("batch_processing %d files" % len(linput))
        produce = staged_producer(self._prepare, skipifexist=skipifexist,
                                  nbtry=nbtry, trydelay=trydelay)

        def consume(prepared, item, msg):
            dst = item[1]
            b = time.time()
            with span("vfs.score"):
                result, err = retry_call(
                    lambda: self._score_prepared(prepared), nbtry=nbtry,
                    trydelay=trydelay)
                if result is None:
                    return (dst, 2, "error: " + str(err))
                with span("vfs.export"):
                    score_to_csv(result, dst)
            return (dst, 0, "ok " + str(time.time() - b))

        return run_prefetched(list(zip(linput, loutput)), produce, consume,
                              verbose=verbose)

    def batch_process(self, linput, loutput, verbose=False, skipifexist=False,
                      nbtry=1, trydelay=2., output_format="csv"):
        """Job-farm adapter: VFS jobs reuse batch_score (csv only)."""
        if output_format != "csv":
            raise ValueError("VFS batch output is csv only")
        return self.batch_score(linput, loutput, verbose=verbose,
                                skipifexist=skipifexist, nbtry=nbtry,
                                trydelay=trydelay)


# -- the JAX package's x-vector checkpoint formats -----------------------------

def _load_resnet_npz(path):
    """Load a ResNet parameter pytree saved with ``save_resnet_npz``."""
    with np.load(path, allow_pickle=False) as z:
        flat = dict(z)
    return _unflatten(flat)


def save_resnet_npz(path, params):
    """Save a ResNet parameter pytree as a flat npz (``a.b#i.c`` keys), the
    JAX package's format."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}#{i}")
        else:
            flat[prefix] = np.asarray(node)

    walk(params, "")
    np.savez(path, **flat)


def _unflatten(flat):
    root = {}
    for key, val in flat.items():
        parts = []
        for seg in key.split("."):
            for j, sub in enumerate(seg.split("#")):
                parts.append(sub if j == 0 else int(sub))
        node = root
        for a, b in zip(parts[:-1], parts[1:]):
            if isinstance(a, int):
                while len(node) <= a:
                    node.append(None)
                if node[a] is None:
                    node[a] = [] if isinstance(b, int) else {}
                node = node[a]
            else:
                if a not in node:
                    node[a] = [] if isinstance(b, int) else {}
                node = node[a]
        last = parts[-1]
        if isinstance(last, int):
            while len(node) <= last:
                node.append(None)
        node[last] = val
    return root


def _load_resnet_onnx(net, path):
    """Map ``final.onnx`` weights onto a ResNet parameter pytree (the JAX
    package's layout) by graph topology.

    Initializer names are ignored (torch exports carry opaque names such as
    ``onnx::Conv_123``); the Conv / BatchNormalization / Gemm node stream is
    consumed in graph order, which for this architecture is the forward
    execution order (conv1..conv3, then the shortcut).  Every assignment is
    shape-checked against ``net``.
    """
    from .models.onnx_reader import read_model

    g = read_model(path)
    # exporters deduplicate identical initializers behind Identity nodes
    alias = {n.outputs[0]: n.inputs[0] for n in g.nodes
             if n.op_type == "Identity" and n.inputs and n.outputs}

    def arr(name):
        seen = set()
        while name in alias and name not in g.initializers:
            if name in seen:
                raise ValueError(f"onnx graph: Identity cycle at {name!r}")
            seen.add(name)
            name = alias[name]
        if name not in g.initializers:
            raise ValueError(
                f"onnx graph: expected weight tensor {name!r} to be an "
                "initializer or Constant (dynamic weights unsupported)")
        return np.asarray(g.initializers[name], np.float32)

    events = []
    for node in g.nodes:
        if node.op_type == "Conv":
            w = arr(node.inputs[1])
            b = arr(node.inputs[2]) if len(node.inputs) > 2 else None
            events.append(("conv", w, b))
        elif node.op_type == "BatchNormalization":
            events.append(("bn", [arr(node.inputs[k]) for k in (1, 2, 3, 4)]))
        elif node.op_type == "Gemm":
            w = arr(node.inputs[1])
            b = arr(node.inputs[2]) if len(node.inputs) > 2 else None
            events.append(("gemm", w, b, bool(node.attrs.get("transB", 0))))

    pos = 0

    def take(kind):
        nonlocal pos
        if pos >= len(events):
            raise ValueError("onnx graph ended early — architecture mismatch")
        ev = events[pos]
        if ev[0] != kind:
            raise ValueError(f"expected {kind}, got {ev[0]} at node {pos}")
        pos += 1
        return ev

    def take_conv_bn(shape):
        """A Conv and its BatchNormalization.  A constant-folded export
        fuses BN into the conv (a bias and no BN node): that becomes an
        identity BN whose beta is the bias.  In unfused graphs a conv bias
        folds into the BN running mean (bn(x + b) == bn with mean - b)."""
        _, w, b = take("conv")
        w = np.transpose(w, (2, 3, 1, 0))          # (O, I, kh, kw) -> HWIO
        if w.shape != shape:
            raise ValueError(f"onnx conv shape {w.shape} != expected {shape}")
        cout = shape[-1]
        if pos < len(events) and events[pos][0] == "bn":
            gamma, beta, mean, var = take("bn")[1]
            if b is not None:
                mean = mean - b
        else:
            gamma = np.ones(cout, np.float32)
            beta = b if b is not None else np.zeros(cout, np.float32)
            mean = np.zeros(cout, np.float32)
            # BatchNorm adds eps=1e-5 to var; cancel it for an exact identity
            var = np.full(cout, 1.0 - 1e-5, np.float32)
        return w, dict(gamma=gamma, beta=beta, mean=mean, var=var)

    mc = net.m_channels
    params = {}
    params["conv1"], params["bn1"] = take_conv_bn((3, 3, 1, mc))
    in_planes = mc
    for si, (mult, nb, stride) in enumerate(
            zip([1, 2, 4, 8], net.num_blocks, [1, 2, 2, 2])):
        planes = mc * mult
        blocks = []
        for bi in range(nb):
            s = stride if bi == 0 else 1
            p = {}
            if net.block == "bottleneck":
                p["conv1"], p["bn1"] = take_conv_bn((1, 1, in_planes, planes))
                p["conv2"], p["bn2"] = take_conv_bn((3, 3, planes, planes))
                p["conv3"], p["bn3"] = take_conv_bn(
                    (1, 1, planes, planes * 4))
                out_planes = planes * 4
            else:
                p["conv1"], p["bn1"] = take_conv_bn((3, 3, in_planes, planes))
                p["conv2"], p["bn2"] = take_conv_bn((3, 3, planes, planes))
                out_planes = planes
            if s != 1 or in_planes != out_planes:
                p["sc_conv"], p["sc_bn"] = take_conv_bn(
                    (1, 1, in_planes, out_planes))
            blocks.append(p)
            in_planes = out_planes
        params[f"layer{si + 1}"] = blocks

    _, w, b, trans_b = take("gemm")
    if trans_b:                      # torch Linear: B is (out, in), transB=1
        w = np.transpose(w, (1, 0))
    feat = in_planes * 2 * pooled_freq(net.feat_dim)
    if w.shape != (feat, net.embed_dim):
        raise ValueError(
            f"onnx embedding shape {w.shape} != expected "
            f"{(feat, net.embed_dim)}")
    params["embedding"] = dict(
        w=w, b=b if b is not None else np.zeros(net.embed_dim, np.float32))
    if pos != len(events):
        raise ValueError(
            f"onnx graph has {len(events) - pos} unconsumed weighted nodes "
            "— architecture mismatch")
    return params

