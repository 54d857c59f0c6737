"""Labeled patch datasets from annotated media.

The port of ``inaspeechsegmenter_tpu/train/data.py``: turn ``(media file,
annotation)`` pairs (the csv format the port exports and its ``eval``
scores) into the ``(B, 68, nmel, 1)`` normalized patch arrays the
patch-CNN family consumes, through the serving frontend (the fused
SIDEKIT features kernel on a CUDA device, its plain version on the CPU)
and the serving patch gather (``dsp.patches.frame_patches``).  That closes
the loop:

    segment / annotate  ->  patch_dataset  ->  Trainer.fit
        ->  Trainer.export_model  ->  the Segmenter serves it

Patch labeling: the annotation is rasterized to the frontend's 10 ms
frame grid; a patch (68 frames = 0.68 s) is kept only when one target
class covers at least ``min_coverage`` of it (default 0.65).  Labels map
onto each engine's class set the same way serving does:
``male``/``female`` count as ``speech`` for the VAD engines, and only
``male``/``female`` frames train the gender engine.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..dsp.patches import LPAD, PATCH_STEP, PATCH_W, frame_patches
from ..utils.device import resolve_device

# engine -> (class tuple in the model's output order, nmel truncation);
# orders match the serving classes (segmenter.py SpeechMusic /
# SpeechMusicNoise / Gender)
ENGINES = {
    "sm": (("speech", "music"), 21),
    "smn": (("speech", "music", "noise"), 21),
    "gender": (("female", "male"), 24),
}

# annotation label -> class label, per engine family
_VAD_ALIASES = {"male": "speech", "female": "speech"}


def _class_codes(lseg, n_frames, classes, engine):
    """Rasterize an annotation onto the 10 ms grid as class indices.

    :return: (n_frames,) int8; -1 where no target class applies (other
        labels, e.g. ``noEnergy``, or uncovered gaps).
    """
    from ..eval import frame_labels, load_segmentation

    lseg = load_segmentation(lseg)
    if engine in ("sm", "smn"):
        lseg = [(_VAD_ALIASES.get(lab, lab), a, b) for lab, a, b in lseg]
    raw = frame_labels(lseg, frame_dur=0.01, n_frames=n_frames)
    codes = np.full(n_frames, -1, np.int8)
    for i, lab in enumerate(classes):
        codes[raw == lab] = i
    return codes


def _decode(media, ffmpeg):
    from ..audio.io import media2sig16kmono

    sig = media2sig16kmono(media, ffmpeg=ffmpeg, dtype="auto")
    if sig.dtype == np.int16:
        sig = sig.astype(np.float32) / 32768.0
    return sig.astype(np.float32, copy=False)


def patch_dataset(pairs, engine="smn", min_coverage=0.65, stride=1,
                  ffmpeg="ffmpeg", frontend=None, return_times=False, *,
                  device="cuda"):
    """Build a labeled patch dataset from annotated media.

    :param pairs: iterable of ``(media, annotation)``; ``media`` is a path
        (or an already-decoded float32 16 kHz signal), ``annotation`` is a
        segmentation csv path or an in-memory ``(label, start, stop)``
        list (`eval.load_segmentation` forms).
    :param engine: ``'sm'`` / ``'smn'`` / ``'gender'``: selects the class
        set, their output order, and the mel truncation of the target
        model family.
    :param min_coverage: minimum fraction of a patch's 68 frames one class
        must cover for the patch to be kept.
    :param stride: keep every ``stride``-th eligible patch.
    :param frontend: feature frontend with the ``mspec_loge`` protocol;
        default ``dsp.fe_kernel.KernelSidekitFrontend(device)``.
    :param return_times: also return ``(file_index, center_sec)`` per
        patch for traceability.
    :param device: where the features and patches are computed, ``cuda``
        by default (raises without a card).
    :return: host numpy ``(x, y)`` with ``x`` float32 ``(B, 68, nmel, 1)``
        and ``y`` int32 ``(B,)`` (indices into ``ENGINES[engine][0]``),
        plus the times array when requested.  Files shorter than one patch
        or with no eligible patch contribute nothing (with a warning).
    """
    if engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; one of {sorted(ENGINES)}")
    classes, nmel = ENGINES[engine]
    device = resolve_device(device)
    if frontend is None:
        from ..dsp.fe_kernel import KernelSidekitFrontend

        frontend = KernelSidekitFrontend(device)

    xs, ys, times = [], [], []
    for fidx, (media, annot) in enumerate(pairs):
        sig = (media if isinstance(media, np.ndarray)
               else _decode(media, ffmpeg))
        mspec, _loge, t = frontend.mspec_loge(sig)
        t = int(t)
        if t < PATCH_W:
            warnings.warn(f"{media if isinstance(media, str) else 'signal'} "
                          f"has {t} frames (<{PATCH_W}); skipped")
            continue
        codes = _class_codes(annot, t, classes, engine)
        # one row per DISTINCT window: j - LPAD in [0, n_rows)
        n_rows = (t - PATCH_W) // PATCH_STEP + 1
        starts = np.arange(n_rows, dtype=np.int64) * PATCH_STEP
        win = codes[starts[:, None] + np.arange(PATCH_W)[None, :]]
        # per-window dominant class + coverage, counting unlabeled frames
        # (code -1) against coverage so half-annotated patches drop out
        counts = np.stack([(win == c).sum(axis=1)
                           for c in range(len(classes))], axis=1)
        dom = counts.argmax(axis=1)
        keep = counts.max(axis=1) >= min_coverage * PATCH_W
        rows = np.nonzero(keep)[0][::stride]
        if not len(rows):
            warnings.warn(f"pair {fidx}: no patch reaches min_coverage="
                          f"{min_coverage}; contributed nothing")
            continue
        j = torch.from_numpy(rows + LPAD).to(mspec.device)
        p, fin = frame_patches(mspec, j, t, nmel)
        fin = fin.cpu().numpy()
        xs.append(p.cpu().numpy()[fin])
        ys.append(dom[rows][fin].astype(np.int32))
        if return_times:
            # patch covers rows [start, start+68) of the 10 ms grid
            times.append(np.stack([np.full(fin.sum(), fidx),
                                   (starts[rows][fin] + PATCH_W / 2) * 0.01],
                                  axis=1))
    if not xs:
        x = np.zeros((0, PATCH_W, nmel, 1), np.float32)
        y = np.zeros((0,), np.int32)
        return (x, y, np.zeros((0, 2))) if return_times else (x, y)
    x = np.concatenate(xs)[..., None].astype(np.float32)
    y = np.concatenate(ys)
    if return_times:
        return x, y, np.concatenate(times)
    return x, y


def class_weights(y, n_classes):
    """Inverse-frequency per-class weights for imbalanced corpora.

    Present classes get weight proportional to ``1/count``, scaled so
    their mean is 1 (loss magnitude comparable to unweighted); absent
    classes get 0."""
    counts = np.bincount(np.asarray(y, np.int64), minlength=n_classes)
    counts = counts.astype(np.float64)
    present = counts > 0
    w = np.zeros(n_classes)
    if present.any():
        w[present] = 1.0 / counts[present]
        w[present] *= present.sum() / w[present].sum()
    return w.astype(np.float32)
