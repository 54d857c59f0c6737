"""Segmentation evaluation: frame accuracy, per-label P/R/F1, VAD rates.

Numpy-only copy of ``inaspeechsegmenter_tpu/eval.py``, the scorer of the
JAX package, for the PyTorch port (which runs where neither jax nor pandas
is installed): the same public functions with the same results.  Only
``load_segmentation`` differs in its means: it reads the tab-separated
``labels/start/stop`` csv with the standard library's ``csv`` module, and
takes every file that the port's ``export.seg2csv`` writes.

Every metric is computed on a uniform frame grid (default 20 ms, the
pipeline's output resolution).  On that grid all metrics are exact
duration-weighted quantities for segmentations whose boundaries are
multiples of the frame duration, and the math is identical whether
inputs are in-memory ``(label, start, stop)`` lists or exported csv files.

Conventions follow the standard speech-evaluation kits:

* an optional **collar** (seconds, NIST-style) excludes frames within
  +-collar of any reference boundary, forgiving annotation jitter;
* **VAD scoring** maps labels onto speech/non-speech with a configurable
  speech-label set and reports miss rate, false-alarm rate and the
  OpenSAT-weighted detection cost ``DCF = 0.75*Pmiss + 0.25*Pfa``;
* **boundary scoring** matches hypothesis boundaries to reference
  boundaries within a tolerance and reports precision/recall/F1.
"""

from __future__ import annotations

import csv

import numpy as np

FRAME_DUR = 0.02         # native output resolution (s)
SPEECH_LABELS = frozenset({"speech", "male", "female"})


def load_segmentation(src):
    """Normalize a segmentation to a list of ``(label, start, stop)``.

    :param src: an in-memory iterable of ``(label, start, stop)`` tuples,
        or a path to a tab-separated csv with a ``labels/start/stop``
        header (the `export.seg2csv` / reference format).
    """
    if isinstance(src, (str, bytes)):
        return _read_segmentation_csv(src)
    out = [(str(lab), float(a), float(b)) for lab, a, b in src]
    return out


def _read_segmentation_csv(path):
    """A tab-separated csv with a ``labels/start/stop`` header (any other
    columns ignored, blank lines skipped) -> ``[(label, start, stop)]``."""
    with open(path, newline="") as fh:
        rows = [r for r in csv.reader(fh, delimiter="\t") if r]
    header = rows[0] if rows else []
    need = ("labels", "start", "stop")
    if not set(need).issubset(header):
        raise ValueError(
            f"{path!r} is not a segmentation csv: columns {header}"
            " (expected labels/start/stop)")
    cols = [header.index(c) for c in need]
    return [(str(r[cols[0]]), float(r[cols[1]]), float(r[cols[2]]))
            for r in rows[1:]]


def frame_labels(lseg, frame_dur=FRAME_DUR, n_frames=None):
    """Segment list -> per-frame label array (numpy, dtype object).

    Frame ``i`` covers ``[i*frame_dur, (i+1)*frame_dur)`` from t=0; segment
    boundaries are rounded to the nearest frame.  Frames not covered by
    any segment hold ``""``.

    :param n_frames: clip/pad to this many frames (default: up to the last
        segment's stop).
    """
    lseg = load_segmentation(lseg)
    stop_fr = max((int(round(s[2] / frame_dur)) for s in lseg), default=0)
    if n_frames is None:
        n_frames = stop_fr
    fr = np.full(n_frames, "", dtype=object)
    for lab, start, stop in lseg:
        a = max(0, int(round(start / frame_dur)))
        b = min(n_frames, int(round(stop / frame_dur)))
        fr[a:b] = lab
    return fr


def _collar_mask(ref, n, frame_dur, collar):
    """True for frames OUTSIDE +-collar of every reference boundary."""
    keep = np.ones(n, bool)
    if collar <= 0:
        return keep
    w = int(round(collar / frame_dur))
    for _, start, stop in ref:
        for t in (start, stop):
            c = int(round(t / frame_dur))
            keep[max(0, c - w):min(n, c + w)] = False
    return keep


def _aligned_frames(ref, hyp, frame_dur, collar):
    """Frame arrays (ref, hyp) over the union extent, collar-excluded.

    The shorter side is padded with ``""`` so a missing/empty hypothesis
    scores as wrong, not as trivially perfect."""
    ref = load_segmentation(ref)
    hyp = load_segmentation(hyp)
    fr = frame_labels(ref, frame_dur)
    fh = frame_labels(hyp, frame_dur)
    n = max(len(fr), len(fh))
    fr = np.concatenate([fr, np.full(n - len(fr), "", dtype=object)])
    fh = np.concatenate([fh, np.full(n - len(fh), "", dtype=object)])
    keep = _collar_mask(ref, n, frame_dur, collar)
    return fr[keep], fh[keep]


def frame_diff(ref, hyp, frame_dur=FRAME_DUR, collar=0.0):
    """Fraction of (collar-surviving) frames whose labels differ.

    This is the project's north-star parity metric (<=0.1% vs the
    TF reference, BASELINE.md) and, for exhaustive label sets, the
    duration-weighted identification error rate.
    """
    fr, fh = _aligned_frames(ref, hyp, frame_dur, collar)
    if len(fr) == 0:
        return 0.0
    return float(np.mean(fr != fh))


def _confusion_from_frames(fr, fh, frame_dur):
    """Vectorized duration confusion from aligned frame arrays: label pairs
    are coded into a flat index and counted with one bincount, not a
    per-frame Python loop (hour-scale files are ~180k frames)."""
    labels, codes = np.unique(np.concatenate([fr, fh]), return_inverse=True)
    L = len(labels)
    cr, ch = codes[:len(fr)], codes[len(fr):]
    counts = np.bincount(cr * L + ch, minlength=L * L)
    return {(labels[i // L], labels[i % L]): round(float(n) * frame_dur, 6)
            for i, n in enumerate(counts) if n}


def confusion(ref, hyp, frame_dur=FRAME_DUR, collar=0.0):
    """Duration confusion matrix: ``{(ref_label, hyp_label): seconds}``."""
    fr, fh = _aligned_frames(ref, hyp, frame_dur, collar)
    return _confusion_from_frames(fr, fh, frame_dur)


def _label_report_from_frames(fr, fh, frame_dur):
    labels = sorted(set(fr) | set(fh))
    rep = {}
    for lab in labels:
        in_r = fr == lab
        in_h = fh == lab
        tp = float(np.sum(in_r & in_h))
        nr, nh = float(np.sum(in_r)), float(np.sum(in_h))
        prec = tp / nh if nh else 0.0
        rec = tp / nr if nr else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        rep[lab] = {"precision": round(prec, 6), "recall": round(rec, 6),
                    "f1": round(f1, 6),
                    "ref_duration": round(nr * frame_dur, 6),
                    "hyp_duration": round(nh * frame_dur, 6)}
    acc = float(np.mean(fr == fh)) if len(fr) else 1.0
    return {"accuracy": round(acc, 6),
            "scored_duration": round(len(fr) * frame_dur, 6),
            "labels": rep}


def label_report(ref, hyp, frame_dur=FRAME_DUR, collar=0.0):
    """Per-label precision/recall/F1 (duration-weighted) + micro accuracy.

    :return: dict with ``accuracy`` (fraction of matching frames),
        ``scored_duration`` (seconds surviving the collar), and
        ``labels``: ``{label: {precision, recall, f1, ref_duration,
        hyp_duration}}``.
    """
    fr, fh = _aligned_frames(ref, hyp, frame_dur, collar)
    return _label_report_from_frames(fr, fh, frame_dur)


def _vad_report_from_frames(fr, fh, speech_labels, frame_dur,
                            miss_weight, fa_weight):
    sp = frozenset(speech_labels)
    r = np.fromiter((x in sp for x in fr), bool, len(fr))
    h = np.fromiter((x in sp for x in fh), bool, len(fh))
    n_sp, n_ns = float(np.sum(r)), float(np.sum(~r))
    miss = float(np.sum(r & ~h)) / n_sp if n_sp else 0.0
    fa = float(np.sum(~r & h)) / n_ns if n_ns else 0.0
    return {"miss_rate": round(miss, 6), "fa_rate": round(fa, 6),
            "dcf": round(miss_weight * miss + fa_weight * fa, 6),
            "speech_ref_duration": round(n_sp * frame_dur, 6),
            "nonspeech_ref_duration": round(n_ns * frame_dur, 6)}


def vad_report(ref, hyp, speech_labels=SPEECH_LABELS, frame_dur=FRAME_DUR,
               collar=0.0, miss_weight=0.75, fa_weight=0.25):
    """Speech-activity scoring after mapping labels onto speech/non-speech.

    :param speech_labels: labels counted as speech on BOTH sides (default:
        ``speech``/``male``/``female`` — the pipeline's speech family).
    :param miss_weight, fa_weight: detection-cost weights; the defaults are
        the OpenSAT/inaGVAD convention ``DCF = 0.75*Pmiss + 0.25*Pfa``.
    :return: dict with ``miss_rate`` (P(non-speech | ref speech)),
        ``fa_rate`` (P(speech | ref non-speech)), ``dcf``, and the scored
        speech/non-speech reference durations.
    """
    fr, fh = _aligned_frames(ref, hyp, frame_dur, collar)
    return _vad_report_from_frames(fr, fh, speech_labels, frame_dur,
                                   miss_weight, fa_weight)


def _boundaries(lseg):
    """Sorted unique internal boundaries (label-change instants)."""
    lseg = load_segmentation(lseg)
    pts = set()
    for i in range(1, len(lseg)):
        # only label CHANGES are boundaries; adjacent same-label segments
        # (possible after csv round-trips) do not create one
        if lseg[i][0] != lseg[i - 1][0]:
            pts.add(lseg[i][1])
    return np.array(sorted(pts))


def boundary_report(ref, hyp, tolerance=0.1):
    """Boundary detection quality: hyp boundaries matched 1:1 to ref
    boundaries within ``tolerance`` seconds (greedy nearest-first).

    :return: dict with ``precision`` (matched / n_hyp), ``recall``
        (matched / n_ref), ``f1``, counts, and ``mean_abs_offset`` over the
        matched pairs (seconds).
    """
    br, bh = _boundaries(ref), _boundaries(hyp)
    if len(br) == 0 or len(bh) == 0:
        matched, offs = 0, []
    else:
        # greedy nearest-first matching: enumerate candidate pairs within
        # tolerance, take them in increasing |offset|, each side used once
        cand = [(abs(r - h), i, j)
                for i, r in enumerate(br) for j, h in enumerate(bh)
                if abs(r - h) <= tolerance]
        cand.sort()
        used_r, used_h, offs = set(), set(), []
        for d, i, j in cand:
            if i in used_r or j in used_h:
                continue
            used_r.add(i)
            used_h.add(j)
            offs.append(d)
        matched = len(offs)
    prec = matched / len(bh) if len(bh) else 1.0
    rec = matched / len(br) if len(br) else 1.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"precision": round(prec, 6), "recall": round(rec, 6),
            "f1": round(f1, 6), "n_ref": int(len(br)), "n_hyp": int(len(bh)),
            "matched": matched,
            "mean_abs_offset": round(float(np.mean(offs)), 6) if offs else 0.0}


def evaluate(ref, hyp, frame_dur=FRAME_DUR, collar=0.0,
             speech_labels=SPEECH_LABELS, boundary_tolerance=0.1,
             include_confusion=False):
    """Full report for one (reference, hypothesis) pair: ``frame_diff`` +
    `label_report` + `vad_report` + `boundary_report` in one dict.

    Each segmentation is loaded and rasterized to the frame grid ONCE and
    every frame metric derives from that single aligned pair (a corpus run
    would otherwise re-parse each csv five times).

    :param include_confusion: add a ``confusion`` key (the `confusion`
        dict) computed from the same frame pass — used by the corpus CLI.
    """
    ref = load_segmentation(ref)
    hyp = load_segmentation(hyp)
    fr, fh = _aligned_frames(ref, hyp, frame_dur, collar)
    lab = _label_report_from_frames(fr, fh, frame_dur)
    rep = {
        "frame_diff": round(1.0 - lab["accuracy"], 6) if len(fr) else 0.0,
        **lab,
        "vad": _vad_report_from_frames(fr, fh, speech_labels, frame_dur,
                                       0.75, 0.25),
        "boundaries": boundary_report(ref, hyp, boundary_tolerance),
    }
    if include_confusion:
        rep["confusion"] = _confusion_from_frames(fr, fh, frame_dur)
    return rep


def merge_confusions(per_file):
    """Aggregate per-file confusion dicts into corpus-level `label_report`
    style metrics (duration-weighted across files)."""
    total = {}
    for c in per_file:
        for k, v in c.items():
            total[k] = total.get(k, 0.0) + v
    labels = sorted({k[0] for k in total} | {k[1] for k in total})
    grand = sum(total.values())
    match = sum(v for (r, h), v in total.items() if r == h)
    rep = {}
    for lab in labels:
        nr = sum(v for (r, _), v in total.items() if r == lab)
        nh = sum(v for (_, h), v in total.items() if h == lab)
        tp = total.get((lab, lab), 0.0)
        prec = tp / nh if nh else 0.0
        rec = tp / nr if nr else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        rep[lab] = {"precision": round(prec, 6), "recall": round(rec, 6),
                    "f1": round(f1, 6), "ref_duration": round(nr, 6),
                    "hyp_duration": round(nh, 6)}
    return {"accuracy": round(match / grand, 6) if grand else 1.0,
            "scored_duration": round(grand, 6), "labels": rep}
