"""Released-weights acceptance kit of the port.

Counterpart of the JAX package's ``tools/verify_weights.py``, with the
same flags, records and exit status, over the port's own readers and
engines (no jax, pandas or h5py).  On a host that has the released
weight files (``$ISS_TPU_MODEL_DIR``, or the registry's
``~/.keras/inaSpeechSegmenter`` and user cache), one command:

* reports each file's topology before any forward pass: every ``.hdf5``'s
  layer graph through ``models/h5.py`` and ``models/keras_h5.py`` (class
  names, weight counts, any layer type outside the port's vocabulary) and
  a forward pass on a plausible input; ``final.onnx`` through
  ``models/onnx_reader.py`` and ``vfs._load_resnet_onnx``; ``raw_81.pth``
  through ``ResNetXVector.load_torch_checkpoint``; an x-vector npz through
  ``vfs._load_resnet_npz``.  A synthetic stand-in is reported as such and
  not verified;
* runs the reference's golden battery (reference run_test.py:62-195) when
  the media fixtures are found: musanmix ``sm+gender`` labels and
  boundaries, musanmix and silence2sec ``smn+gender`` byte-equal csvs and
  TextGrid, ``0021.mp3`` through ffmpeg, the x-vector embedding against
  ``test.h5`` (read by ``models/h5.py``) and the voice femininity score
  0.534884 on ``lamartine.wav``.

The CNN and x-vector precision default to ``highest`` (exact float32),
as in the JAX tool; ``ISS_CNN_PRECISION`` / ``ISS_XVEC_PRECISION`` set
explicitly are honoured.  ``--device`` defaults to ``cuda`` and raises
without a card.

    python -m inaspeechsegmenter_tpu_torch.tools.verify_weights \\
        [--media-dir DIR] [--report-only] [--json PATH] [--device cuda]

Exit status: 0 when everything present PASSed, 1 when anything FAILed;
SKIPs (missing optional files, no ffmpeg) are reported and do not fail.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

HDF5_MODELS = [
    "keras_speech_music_cnn.hdf5",
    "keras_speech_music_noise_cnn.hdf5",
    "keras_male_female_cnn.hdf5",
    "interspeech2023_all.hdf5",
    "interspeech2023_cvfr.hdf5",
]
MEDIA_DIRS = ("./media", "../media")


class Report:
    """The PASS / FAIL / SKIP records of one run."""

    def __init__(self):
        self.results = []

    def record(self, name, status, detail=""):
        self.results.append((name, status, detail))
        pad = {"PASS": "\033[32mPASS\033[0m", "FAIL": "\033[31mFAIL\033[0m",
               "SKIP": "\033[33mSKIP\033[0m"}.get(status, status)
        print(f"  [{pad}] {name}" + (f" — {detail}" if detail else ""))

    def by_status(self, status):
        return [r for r in self.results if r[1] == status]


def find_model(name):
    from ..models.registry import ModelNotFoundError, get_remote

    try:
        return get_remote(name, allow_download=False)
    except (ModelNotFoundError, FileNotFoundError):
        return None


def is_synthetic(path):
    if not path.endswith(".npz"):
        return False
    from ..models.registry import _npz_spec

    spec = _npz_spec(path)
    return bool(spec and spec.get("synthetic"))


# ---------------------------------------------------------------------------
# topology reports
# ---------------------------------------------------------------------------

def report_hdf5(rep, name, path, device):
    import torch

    from ..models import h5
    from ..models.keras_h5 import load_native, read_h5
    from ..models.layers import SUPPORTED

    print(f"\n== {name} ({path})")
    try:
        if path.endswith(".npz"):
            spec, params = load_native(path)
        else:
            with h5.File(path) as f:
                kv = f.attrs.get("keras_version", b"?")
                be = f.attrs.get("backend", b"?")
                kv = kv.decode() if isinstance(kv, bytes) else kv
                be = be.decode() if isinstance(be, bytes) else be
            print(f"   keras_version={kv} backend={be}")
            spec, params = read_h5(path)
    except Exception as exc:
        rep.record(f"{name}: parse", "FAIL", f"{type(exc).__name__}: {exc}")
        traceback.print_exc(limit=2)
        return False
    unsupported = []
    for e in spec["layers"]:
        cname = e["class_name"]
        nw = len(params.get(e["name"], []))
        mark = ""
        if cname not in SUPPORTED:
            unsupported.append(cname)
            mark = "   <-- UNSUPPORTED layer type"
        print(f"   {e['name']:<32} {cname:<24} weights={nw}{mark}")
    if unsupported:
        rep.record(f"{name}: topology", "FAIL",
                   f"unsupported layer types: {sorted(set(unsupported))}")
        return False
    rep.record(f"{name}: topology", "PASS",
               f"{len(spec['layers'])} layers, all types supported")
    # forward smoke test on a plausible input shape
    try:
        from ..models.native import ImportedModel

        model = ImportedModel(spec, params).to(device).eval()
        shape = _guess_input_shape(name, spec)
        with torch.no_grad():
            out = model(torch.zeros(shape, device=device))
        rep.record(f"{name}: forward", "PASS",
                   f"in={shape} out={tuple(out.shape)}")
        return True
    except Exception as exc:
        rep.record(f"{name}: forward", "FAIL", f"{type(exc).__name__}: {exc}")
        traceback.print_exc(limit=2)
        return False


def _guess_input_shape(name, spec):
    """The stored input shape, else a patch CNN's (B, 68, nmel, 1) with
    the nmel its segmentation stage feeds it (24 for an unknown CNN), else
    an MLP's (B, 256)."""
    from ..segmenter import Gender, SpeechMusic, SpeechMusicNoise

    for e in spec["layers"]:
        cfg = e["config"]
        shp = cfg.get("batch_input_shape") or cfg.get("batch_shape")
        if shp:
            return tuple(2 if d is None else int(d) for d in shp)
    if any(e["class_name"] == "Conv2D" for e in spec["layers"]):
        nmel = {c.model_fname: c.nmel for c in (SpeechMusic,
                                                SpeechMusicNoise, Gender)}
        return (2, 68, nmel.get(name, 24), 1)
    return (2, 256)


def _iter_leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _iter_leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _iter_leaves(v)
    else:
        yield node


def report_onnx(rep, path):
    if path.endswith(".npz"):
        return report_xvec_npz(rep, "final.onnx", path)
    print(f"\n== final.onnx ({path})")
    try:
        from ..models.onnx_reader import read_model
        from ..models.resnet import ResNet101XVector
        from ..vfs import _load_resnet_onnx

        g = read_model(path)
        counts = {}
        for n in g.nodes:
            counts[n.op_type] = counts.get(n.op_type, 0) + 1
        print("   nodes:", " ".join(f"{k}x{v}" for k, v in
                                    sorted(counts.items())))
        print(f"   initializers: {len(g.initializers)}")
        params = _load_resnet_onnx(ResNet101XVector(), path)
        n_leaves = sum(1 for _ in _iter_leaves(params))
        rep.record("final.onnx: topology map", "PASS",
                   f"{n_leaves} tensors mapped onto ResNet101")
        return True
    except Exception as exc:
        rep.record("final.onnx: topology map", "FAIL",
                   f"{type(exc).__name__}: {exc}")
        traceback.print_exc(limit=2)
        return False


def report_xvec_npz(rep, name, path):
    """The registry may resolve ``raw_81.pth`` / ``final.onnx`` to a
    converted npz (``vfs.save_resnet_npz``): report it as such instead of
    feeding it to the raw-format loaders, which would false-FAIL a
    supported weight configuration."""
    print(f"\n== {name} ({path})")
    try:
        from ..vfs import _load_resnet_npz

        params = _load_resnet_npz(path)
        n_leaves = sum(1 for _ in _iter_leaves(params))
        rep.record(f"{name}: native npz checkpoint", "PASS",
                   f"{n_leaves} tensors")
        return True
    except Exception as exc:
        rep.record(f"{name}: native npz checkpoint", "FAIL",
                   f"{type(exc).__name__}: {exc}")
        traceback.print_exc(limit=2)
        return False


def report_pth(rep, path):
    if path.endswith(".npz"):
        return report_xvec_npz(rep, "raw_81.pth", path)
    print(f"\n== raw_81.pth ({path})")
    try:
        from ..models.resnet import ResNet101XVector

        net = ResNet101XVector().load_torch_checkpoint(path)
        n = sum(1 for k in net.state_dict()
                if not k.endswith("num_batches_tracked"))
        rep.record("raw_81.pth: state-dict map", "PASS",
                   f"{n} tensors mapped onto ResNet101")
        return True
    except Exception as exc:
        rep.record("raw_81.pth: state-dict map", "FAIL",
                   f"{type(exc).__name__}: {exc}")
        traceback.print_exc(limit=2)
        return False


# ---------------------------------------------------------------------------
# golden battery
# ---------------------------------------------------------------------------

def golden_csv(media_dir, name):
    """A golden csv -> ``[(label, start, stop)]``, read with ``csv``."""
    from ..eval import load_segmentation

    return load_segmentation(os.path.join(media_dir, name))


def seg_diff_detail(gold, got):
    """Quantify a parity miss with the eval metrics so the report separates
    numeric jitter (frame diff within the 0.1% budget, boundaries a frame
    off) from wrong weights (gross diff).  ``gold`` / ``got`` are csv paths
    or (label, start, stop) lists."""
    try:
        from .. import eval as ev

        fd = ev.frame_diff(gold, got)
        b = ev.boundary_report(gold, got, tolerance=0.1)
        verdict = ("within" if fd <= 0.001 else "OVER") + " the 0.1% budget"
        return (f"frame diff {fd:.4%} ({verdict}); boundaries "
                f"{b['matched']}/{b['n_ref']} matched within 0.1s, "
                f"mean |offset| {b['mean_abs_offset']}s")
    except Exception as exc:   # diagnostics must not mask the FAIL itself
        return f"diff metrics unavailable: {type(exc).__name__}: {exc}"


def _golden_segmentation(rep, media_dir, tmp, ffmpeg, device):
    from .. import Segmenter, seg2csv, seg2textgrid

    musan = os.path.join(media_dir, "musanmix.wav")
    silence = os.path.join(media_dir, "silence2sec.wav")
    seg = Segmenter(vad_engine="smn", detect_gender=True, ffmpeg=None,
                    allow_download=False, device=device)
    out = seg(musan)
    p = os.path.join(tmp, "musanmix-smn-gender.csv")
    seg2csv(out, p)
    gold_p = os.path.join(media_dir, "musanmix-smn-gender.csv")
    ok = filecmp.cmp(p, gold_p, shallow=False)
    rep.record("musanmix smn+gender csv byte parity",
               "PASS" if ok else "FAIL",
               "" if ok else seg_diff_detail(gold_p, p))
    tg = os.path.join(tmp, "musanmix-smn-gender.TextGrid")
    seg2textgrid(out, tg)
    ok = filecmp.cmp(tg, os.path.join(media_dir,
                                      "musanmix-smn-gender.TextGrid"),
                     shallow=False)
    rep.record("musanmix smn+gender TextGrid byte parity",
               "PASS" if ok else "FAIL")

    out = seg(silence)
    p = os.path.join(tmp, "silence2sec-smn-gender.csv")
    seg2csv(out, p)
    gold_p = os.path.join(media_dir, "silence2sec-smn-gender.csv")
    ok = filecmp.cmp(p, gold_p, shallow=False)
    rep.record("silence2sec smn+gender csv byte parity",
               "PASS" if ok else "FAIL",
               "" if ok else seg_diff_detail(gold_p, p))

    seg_sm = Segmenter(vad_engine="sm", detect_gender=True, ffmpeg=None,
                       allow_download=False, device=device)
    out = seg_sm(musan)
    gold = golden_csv(media_dir, "musanmix-sm-gender.csv")
    lab_ok = [a for a, _, _ in out] == [a for a, _, _ in gold]
    # boundaries compare only when the label sequences (and so the segment
    # counts) match
    b_ok = lab_ok and (
        np.allclose([s for _, s, _ in out], [s for _, s, _ in gold],
                    atol=5e-4)
        and np.allclose([e for _, _, e in out], [e for _, _, e in gold],
                        atol=5e-4))
    rep.record("musanmix sm+gender labels+boundaries",
               "PASS" if (lab_ok and b_ok) else "FAIL",
               "" if (lab_ok and b_ok) else
               ("label sequences differ; " if not lab_ok else "")
               + seg_diff_detail(gold, out))

    mp3 = os.path.join(media_dir, "0021.mp3")
    if ffmpeg and os.path.exists(mp3):
        seg_f = Segmenter(vad_engine="smn", detect_gender=True,
                          ffmpeg=ffmpeg, allow_download=False, device=device)
        got = seg_f(mp3)
        want = [("male", 0, 0.66)]
        ok = [(a, round(s, 2), round(e, 2)) for a, s, e in got] == want
        rep.record("0021.mp3 via ffmpeg == [('male', 0, 0.66)]",
                   "PASS" if ok else "FAIL", str(got) if not ok else "")
    else:
        rep.record("0021.mp3 via ffmpeg", "SKIP",
                   "ffmpeg or mp3 fixture unavailable")


def _golden_xvector(rep, testh5, device):
    import torch

    from ..models import h5
    from ..vfs import TorchResnetExtractor

    with h5.File(testh5) as f:
        mel = np.array(f["lamartinemelbands"], np.float32)
        expected = np.array(f["lamartineonnx"])
    ext = TorchResnetExtractor(device=device)
    emb = ext.get_embedding(torch.from_numpy(mel).to(ext.device))
    diff = float(np.abs(emb - expected).max())
    ok = diff < 5e-5 * max(1.0, float(np.abs(expected).max())) or diff < 1e-4
    rep.record("x-vector embedding vs test.h5 (decimal=4)",
               "PASS" if ok else "FAIL", f"max |diff| = {diff:.2e}")


def run_golden(rep, media_dir, tmp, have_cnns, have_mlp, have_xvec, ffmpeg,
               device):
    if have_cnns and os.path.exists(os.path.join(media_dir, "musanmix.wav")):
        try:
            _golden_segmentation(rep, media_dir, tmp, ffmpeg, device)
        except Exception as exc:
            rep.record("segmentation golden battery", "FAIL",
                       f"{type(exc).__name__}: {exc}")
            traceback.print_exc(limit=3)
    else:
        rep.record("segmentation golden battery", "SKIP",
                   "CNN weights or musanmix.wav unavailable")

    testh5 = os.path.join(media_dir, "test.h5")
    if have_xvec and os.path.exists(testh5):
        try:
            _golden_xvector(rep, testh5, device)
        except Exception as exc:
            rep.record("x-vector embedding vs test.h5", "FAIL",
                       f"{type(exc).__name__}: {exc}")
            traceback.print_exc(limit=3)
    else:
        rep.record("x-vector embedding vs test.h5", "SKIP",
                   "x-vector weights or test.h5 unavailable")

    lam = os.path.join(media_dir, "lamartine.wav")
    if have_cnns and have_mlp and have_xvec and os.path.exists(lam):
        try:
            from .. import VoiceFemininityScoring

            vfs = VoiceFemininityScoring(gd_model_criteria="vfp", ffmpeg=None,
                                         allow_download=False, device=device)
            score, dur, n = vfs(lam)
            ok = score is not None and abs(score - 0.534884) < 5e-5
            rep.record("VFS score on lamartine.wav == 0.534884",
                       "PASS" if ok else "FAIL",
                       f"score={score} dur={dur:.2f}s n={n}")
        except Exception as exc:
            rep.record("VFS score on lamartine.wav", "FAIL",
                       f"{type(exc).__name__}: {exc}")
            traceback.print_exc(limit=3)
    else:
        rep.record("VFS score on lamartine.wav", "SKIP",
                   "CNN/MLP/x-vector weights or lamartine.wav unavailable")


def write_json(path, rep, have, media_dir, device):
    passes, fails, skips = (rep.by_status(s) for s in ("PASS", "FAIL",
                                                       "SKIP"))
    doc = {
        "ok": not fails,
        "verified": bool(passes),  # False = nothing real was checked
        "summary": {"pass": len(passes), "fail": len(fails),
                    "skip": len(skips)},
        "results": [{"name": n, "status": s, "detail": d}
                    for n, s, d in rep.results],
        "models": {k: (v if v else ("synthetic" if find_model(k) else None))
                   for k, v in have.items()},
        "media_dir": media_dir,
        "precision": {"cnn": os.environ["ISS_CNN_PRECISION"],
                      "xvec": os.environ["ISS_XVEC_PRECISION"]},
        "device": str(device),
        "measured_at": time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime()),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp_json = f"{path}.part{os.getpid()}"
    with open(tmp_json, "w") as fh:
        json.dump(doc, fh, indent=1)
    os.replace(tmp_json, path)
    print(f"json report: {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--media-dir", default=None,
                    help="directory with the reference media fixtures "
                         "(musanmix.wav, golden csvs, test.h5, ...)")
    ap.add_argument("--report-only", action="store_true",
                    help="topology reports only, skip the golden battery")
    ap.add_argument("--ffmpeg", default="ffmpeg")
    ap.add_argument("--json", default=os.environ.get("ISS_VERIFY_JSON"),
                    help="also write a machine-readable report to this path "
                         "(env ISS_VERIFY_JSON)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the forward passes (default cuda)")
    args = ap.parse_args(argv)

    # golden parity is checked at the exact tier unless one is named
    os.environ.setdefault("ISS_CNN_PRECISION", "highest")
    os.environ.setdefault("ISS_XVEC_PRECISION", "highest")
    from ..utils.device import resolve_device

    device = resolve_device(args.device)

    media_dir = args.media_dir
    if media_dir is None:
        for cand in MEDIA_DIRS:
            if os.path.exists(os.path.join(cand, "musanmix.wav")):
                media_dir = cand
                break
    print("media dir:", media_dir or "NOT FOUND")
    print("model search: ISS_TPU_MODEL_DIR=%s"
          % os.environ.get("ISS_TPU_MODEL_DIR", "<unset>"))
    print("precision: ISS_CNN_PRECISION=%s ISS_XVEC_PRECISION=%s"
          % (os.environ["ISS_CNN_PRECISION"],
             os.environ["ISS_XVEC_PRECISION"]))
    print("device:", device)
    ffmpeg = shutil.which(args.ffmpeg)

    rep = Report()
    have = {}
    print("\n--- model files ---")
    for name in HDF5_MODELS + ["final.onnx", "raw_81.pth"]:
        path = find_model(name)
        if path and is_synthetic(path):
            print(f"  {name:<36} SYNTHETIC stand-in ({path}) — not verified")
            have[name] = None
        else:
            print(f"  {name:<36} {path or 'NOT FOUND'}")
            have[name] = path

    print("\n--- topology reports ---")
    for name in HDF5_MODELS:
        if have.get(name):
            report_hdf5(rep, name, have[name], device)
    if have.get("final.onnx"):
        report_onnx(rep, have["final.onnx"])
    if have.get("raw_81.pth"):
        report_pth(rep, have["raw_81.pth"])
    if not any(have.values()):
        print("  (no real weight files found — nothing to report)")

    if not args.report_only and media_dir:
        print("\n--- golden battery ---")
        have_cnns = all(have.get(n) for n in HDF5_MODELS[:3])
        have_mlp = bool(have.get("interspeech2023_cvfr.hdf5"))
        have_xvec = bool(have.get("raw_81.pth") or have.get("final.onnx"))
        with tempfile.TemporaryDirectory() as tmp:
            run_golden(rep, media_dir, tmp, have_cnns, have_mlp, have_xvec,
                       ffmpeg, device)
    elif not args.report_only:
        rep.record("golden battery", "SKIP",
                   f"no media directory (--media-dir, or one of {MEDIA_DIRS} "
                   "with musanmix.wav)")

    fails = rep.by_status("FAIL")
    print(f"\nsummary: {len(rep.by_status('PASS'))} pass, {len(fails)} "
          f"fail, {len(rep.by_status('SKIP'))} skip")
    if args.json:
        write_json(args.json, rep, have, media_dir, device)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
