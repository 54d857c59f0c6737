"""Voice Femininity Scoring — the VBx x-vector pipeline, PyTorch port.

Same contract as ``inaspeechsegmenter_tpu/vfs.py`` (reference
vbx_segmenter.py:92-202): ``VoiceFemininityScoring(gd_model_criteria)(fpath)``
returns ``(score | None, speech_duration, n_retained_xvectors)`` with the
same VAD-overlap filtering (midpoint in speech, overlap >= threshold, >= 50%
back-fill) and window bookkeeping (144-frame windows, step 24, tail >= 10
frames, x-vectors scaled x10, NaN windows dropped), plus an explicit
``device`` (``cuda`` by default; no CUDA device raises).

The VAD is the port's ``Segmenter("smn", detect_gender=False)``, so a VFS
run launches the SIDEKIT feature and Viterbi kernels.  VBx features,
the ResNet101 and the MLP run as plain PyTorch (cuDNN / cuBLAS in float32
with TF32 off on CUDA); the JAX package has no Pallas kernel on this path.
Full windows are gathered on the device from the feature tensor and run
through the ResNet in sub-batches of ``ISS_XVEC_BATCH`` (default 256); the
ragged tail window runs through the masked forward.

Not ported: the overlapped speculative scorer, ``mesh=``, ``OnlineVFS``
and the ``ISS_XVEC_PRECISION`` ladder.  ``batch_score`` runs serially.
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
from .dsp.vbx import VbxFrontend
from .models.registry import load_patch_model, resolve_xvector_weights
from .models.resnet import ResNet101XVector, pooled_freq
from .segmenter import Segmenter, resolve_device
from .utils.retry import retry_call

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
    """

    def __init__(self, params=None, net=None, device="cpu", model_dir=None):
        self.device = torch.device(device)
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

    @torch.no_grad()
    def embeddings_from_features(self, fea, starts):
        """Gather the (len(starts), 64, WINLEN) windows from the on-device
        feature tensor and embed them in ``ISS_XVEC_BATCH`` sub-batches
        -> (len(starts), 256) numpy.  BatchNorm uses running statistics and
        pooling is per sample, so sub-batching does not change a window's
        embedding."""
        if len(starts) == 0:
            return np.zeros((0, self.net.embed_dim), np.float32)
        st = torch.as_tensor(np.asarray(starts, np.int64), device=fea.device)
        offs = torch.arange(WINLEN, device=fea.device)
        sub = max(1, int(os.environ.get("ISS_XVEC_BATCH", "256")))
        outs = []
        for g in range(0, len(starts), sub):
            idx = st[g:g + sub, None] + offs[None, :]
            outs.append(self.net(fea[idx].transpose(1, 2)))
        return torch.cat(outs).cpu().numpy()

    @torch.no_grad()
    def get_embedding_masked(self, fea, start, length):
        """Tail-window embedding: the window zero-padded (by a clamped
        gather) to WINLEN and run through the masked forward at its true
        length."""
        t = fea.shape[0]
        idx = torch.clamp(start + torch.arange(WINLEN, device=fea.device),
                          max=t - 1)
        out = self.net(fea[idx].T[None],
                       torch.tensor([length], device=fea.device))
        return out[0].cpu().numpy()

    def __call__(self, basename, fea, duration, timeline=None):
        """Reference-compatible VBxExtractor.__call__
        (vbx_segmenter.py:217-246): returns [(key, (seg_start, seg_end),
        xvector*10)].

        ``timeline``: optional ``SpeechTimeline``; windows whose midpoint is
        not in speech are skipped before the ResNet runs (``apply_vad``
        would discard them anyway; the JAX package's default
        ``ISS_XVEC_SPEECH_ONLY=1``).
        """
        fea = torch.as_tensor(fea, dtype=torch.float32, device=self.device)
        speech_only = timeline is not None

        def midpoint_in_speech(seg):
            # the exact midpoint apply_vad will test (same rounding)
            return timeline.contains_point((seg[0] + seg[1]) / 2)

        n = int(fea.shape[0])
        xvectors = []
        starts = list(range(0, n - WINLEN, STEP))
        segs = [(round(s / 100.0, 3), round(s / 100.0 + WINLEN / 100.0, 3))
                for s in starts]
        if speech_only:
            kept = [i for i, seg in enumerate(segs) if midpoint_in_speech(seg)]
        else:
            kept = list(range(len(starts)))
        embs = self.embeddings_from_features(fea, [starts[i] for i in kept])
        for i, emb in zip(kept, embs):
            key = f"{basename}_{starts[i]:08}-{starts[i] + WINLEN:08}"
            if np.isnan(emb).any():
                logger.warning(f"NaN found, not processing: {key}{os.linesep}")
            else:
                xvectors.append((key, segs[i], emb))
        # with no full window the tail starts at frame STEP (reference quirk)
        start = starts[-1] if starts else 0
        if n - start - STEP >= 10:
            tail_seg = (round((start + STEP) / 100.0, 3), round(duration, 3))
            if not speech_only or midpoint_in_speech(tail_seg):
                emb = self.get_embedding_masked(fea, start + STEP,
                                                n - (start + STEP))
                key = f"{basename}_{start + STEP:08}-{n:08}"
                if np.isnan(emb).any():
                    logger.warning(
                        f"NaN found, not processing: {key}{os.linesep}")
                else:
                    xvectors.append((key, tail_seg, emb))
        return [(key, seg, x * 10) for key, seg, x in xvectors]


class VoiceFemininityScoring:
    """Voice femininity scoring with the reference constructor contract
    (vbx_segmenter.py:97-127), on ``device``."""

    def __init__(self, gd_model_criteria="bgc", ffmpeg=None, device="cuda",
                 model_dir=None, xvector_params=None, xvector_net=None):
        """:param ffmpeg: only ``None`` (16 kHz WAV input) is ported.
        :param model_dir: model directory (else ``$ISS_TPU_MODEL_DIR``).
        :param xvector_params: a JAX-package ResNet parameter pytree.
        :param xvector_net: a ``ResNetXVector`` module (default ResNet101).

        On CUDA, TF32 is turned off process-wide for matmuls and cuDNN
        convolutions: the ResNet runs in exact float32.
        """
        if gd_model_criteria not in ("bgc", "vfp"):
            raise ValueError("Gender detection model criteria must be 'bgc' "
                             f"or 'vfp', got {gd_model_criteria!r}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        check_ffmpeg(ffmpeg)
        self.xvector_model = TorchResnetExtractor(
            xvector_params, xvector_net, self.device, model_dir)
        if gd_model_criteria == "bgc":
            gd_model = "interspeech2023_all.hdf5"
            self.vad_thresh = 0.7
        else:
            gd_model = "interspeech2023_cvfr.hdf5"
            self.vad_thresh = 0.62
        self.gender_detection_mlp_model = load_patch_model(
            gd_model, model_dir).to(self.device).eval()
        self.vad = Segmenter(vad_engine="smn", detect_gender=False,
                             ffmpeg=ffmpeg, device=self.device,
                             model_dir=model_dir)
        self.features = VbxFrontend(self.device)

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
        basename = os.path.splitext(os.path.basename(fpath))[0]
        sig = media2sig16kmono(fpath, dtype="auto")
        # a non-PCM16 source is decoded once more in float64 for the
        # features, as the reference does (vbx_segmenter.py:160-164)
        signal = None if sig.dtype == np.int16 else media2sig16kmono(
            fpath, dtype="float64")
        if not hasattr(self.vad, "segment_signal"):
            # reference duck-type contract: `vad` is CALLED with the path
            # (vbx_segmenter.py:164), so a plain callable can replace it
            vad_seg = self.vad(fpath)
            return self._finish_prepare(sig, signal, basename, vad_seg)
        return self._prepare_signal(sig, basename, signal64=signal,
                                    medianame=fpath)

    def _prepare_signal(self, sig, basename="<signal>", signal64=None,
                        medianame="<signal>"):
        """VAD + VBx features for an already-decoded 16 kHz mono signal."""
        if signal64 is None and sig.dtype != np.int16:
            # a float signal IS the feature signal (no int16 scaling)
            signal64 = np.asarray(sig, np.float64)
        vad_seg = self.vad.segment_signal(sig, 0, medianame)
        return self._finish_prepare(sig, signal64, basename, vad_seg)

    def _finish_prepare(self, sig, signal, basename, vad_seg):
        duration = len(sig) / SR
        timeline = SpeechTimeline.from_vad(vad_seg)
        speech_duration = timeline.total_duration()
        fea = None
        if speech_duration:
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
        return self._score_prepared(self._prepare_signal(np.asarray(sig),
                                                         basename))

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
        x_vectors = self.apply_vad(x_vectors, timeline)
        if not x_vectors:
            # a speech sliver can leave no window midpoint in speech: the
            # score is undefined, as with no speech.  The reference crashes
            # here (ZeroDivisionError, vbx_segmenter.py:55-61) — a
            # deliberate deviation.
            return None, speech_duration, 0
        pred = np.atleast_1d(np.asarray(
            self.mlp_probabilities(np.asarray([x for _, _, x in x_vectors])))
            .squeeze())
        g_preds = [(seg[0], seg[1], float(p))
                   for (_, seg, _), p in zip(x_vectors, pred)]
        return get_femininity_score(g_preds), speech_duration, len(g_preds)

    @torch.no_grad()
    def mlp_probabilities(self, x):
        """(N, 256) x-vectors (x10) -> the MLP's (N, 1) numpy output."""
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return self.gender_detection_mlp_model(x).cpu().numpy()

    def __call__(self, fpath):
        """-> (score | None, speech_duration_s, n_retained_xvectors)."""
        return self._score_prepared(self._prepare(fpath))

    # ------------------------------------------------------------------
    def batch_score(self, linput, loutput, verbose=False, skipifexist=False,
                    nbtry=1, trydelay=2.):
        """Score a list of files serially, one tab-separated csv per input.

        Returns (total_duration_s, n_processed, avg_s_per_file, lmsg) with
        lmsg entries (dst, 0|1|2, 'ok t'|'already exists'|'error: ...').
        Both phases — decode + VAD + features, then ResNet + MLP — get the
        ``nbtry`` / ``trydelay`` retry budget.
        """
        if verbose:
            print("batch_processing %d files" % len(linput))
        t0 = time.time()
        lmsg = []
        items = list(zip(linput, loutput))
        for src, dst in items:
            lmsg.append(self._score_one(src, dst, skipifexist, nbtry,
                                        trydelay))
            if verbose:
                print("%d/%d" % (len(lmsg), len(items)), [lmsg[-1]])
        dur = time.time() - t0
        n_ok = len([e for e in lmsg if e[1] == 0])
        return dur, n_ok, dur / n_ok if n_ok else -1, lmsg

    def _score_one(self, src, dst, skipifexist, nbtry, trydelay):
        if skipifexist and os.path.exists(dst):
            return (dst, 1, "already exists")
        try:
            dname = os.path.dirname(dst)
            if dname and not os.path.isdir(dname):
                os.makedirs(dname, exist_ok=True)
            prepared, err = retry_call(lambda: self._prepare(src),
                                       nbtry=nbtry, trydelay=trydelay)
            if prepared is None:
                return (dst, 2, "error: " + str(err))
            b = time.time()
            result, err = retry_call(lambda: self._score_prepared(prepared),
                                     nbtry=nbtry, trydelay=trydelay)
            if result is None:
                return (dst, 2, "error: " + str(err))
            score_to_csv(result, dst)
            return (dst, 0, "ok " + str(time.time() - b))
        except Exception as exc:   # bad destination, full disk, ...
            return (dst, 2, "error: " + repr(exc))

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

