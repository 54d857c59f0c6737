"""Warm VFS and ResNet101 timings of one tree's PyTorch port, on the card.

    python tools/torch_vfs_ab.py --root DIR [--tag NAME] [--reps 5]

Imports ``inaspeechsegmenter_tpu_torch`` from ``DIR`` (this checkout, or an
unpacked ``git archive`` of another commit), so that two trees can be
compared in one session on one card: run parent, change, change, parent,
each in its own process.  Every run rebuilds the same inputs:
``chip_smoke.py``'s seeded 10 min mix, the full-width synthetic CNNs and
MLP (``install_synthetic_models``, seed 0) and a full-width ResNet101
(seed 0), with TF32 off as ``chip_smoke.py`` sets it.

Prints one JSON line (prefixed ``AB``) with, medians of ``--reps``:

- ``vfs_wall_s``: the warm ``VoiceFemininityScoring`` call on the mix
  (``chip_smoke.py`` phase 3's wall);
- ``speech``: the ResNet stage on the VAD's speech windows (phase 3's
  ``ResNet101 x-vectors`` stage: full windows in sub-batches of 256 and
  the masked tail), its windows and windows/s;
- ``all``: every full window of the mix through ``embeddings_from_features``
  on the same net (phase 5(b)'s drive), and ``all_fresh`` the same on a
  newly built extractor, as phase 5(b) builds one per tier;
- ``batch256_ms``: one 256-window sub-batch, CUDA events (phase 3's),
  and ``ragged`` the last, shorter sub-batch of ``all`` (windows, ms);
- the card's name and power limit, and its SM clock, temperature and power
  draw before and after.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def load_smoke():
    """``chip_smoke.py`` of this checkout, for its seeded mix alone (loaded
    by path, so that this checkout's package stays off ``sys.path``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_inputs", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def median_s(fn, reps, torch):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times)), times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="directory holding inaspeechsegmenter_tpu_torch/")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    smoke = load_smoke()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import inaspeechsegmenter_tpu_torch as pkg
    from inaspeechsegmenter_tpu_torch import VoiceFemininityScoring
    from inaspeechsegmenter_tpu_torch.annotations import SpeechTimeline
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNet101XVector
    from inaspeechsegmenter_tpu_torch.models.synthetic import (
        install_synthetic_models)
    from inaspeechsegmenter_tpu_torch.vfs import (STEP, WINLEN,
                                                  TorchResnetExtractor,
                                                  save_resnet_npz)

    if not torch.cuda.is_available():
        print("torch_vfs_ab: no CUDA device visible", file=sys.stderr)
        return 1
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not the tree {root}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi("name,power.limit")
    state = "clocks.sm,temperature.gpu,power.draw"
    before = smi(state)
    sr = smoke.SR
    sig = smoke.to_int16(smoke.seeded_mix(600, seed=600,
                                          silences=smoke.silences_every(600)))
    with tempfile.TemporaryDirectory() as work:
        models = install_synthetic_models(os.path.join(work, "models"),
                                          size="full")
        params = ResNet101XVector().init_params(seed=0)
        save_resnet_npz(os.path.join(models, "raw_81.npz"), params)
        wav = os.path.join(work, "mix600.wav")
        write_wav(wav, sig, sr)
        vfs = VoiceFemininityScoring("bgc", ffmpeg=None, device=dev,
                                     model_dir=models)
        result = vfs(wav)                                   # warm-up
        _, wall, walls = median_s(lambda: vfs(wav), args.reps, torch)

        timeline = SpeechTimeline.from_vad(vfs.vad.segment_signal(sig))
        fea = vfs.features.features(sig.astype(np.float64) / 32768.0)
        xm = vfs.xvector_model
        xv, t_speech, _ = median_s(lambda: xm("mix600", fea, len(sig) / sr,
                                               timeline=timeline),
                                   args.reps, torch)
        starts = list(range(0, fea.shape[0] - WINLEN, STEP))
        xm.embeddings_from_features(fea, starts[:256])
        _, t_all, _ = median_s(lambda: xm.embeddings_from_features(
            fea, starts), args.reps, torch)
        fresh = TorchResnetExtractor(params, ResNet101XVector(), dev)
        fresh.embeddings_from_features(fea, starts[:256])
        _, t_fresh, _ = median_s(lambda: fresh.embeddings_from_features(
            fea, starts), args.reps, torch)
        batch_ms = smoke.cuda_ms(lambda: xm.embeddings_from_features(
            fea, starts[:256]), args.reps, torch)
        ragged = starts[len(starts) - (len(starts) % 256 or 256):]
        ragged_ms = smoke.cuda_ms(lambda: xm.embeddings_from_features(
            fea, ragged), args.reps, torch)
    out = {
        "tag": args.tag or root, "card": card, "torch": torch.__version__,
        "state_before": before, "state_after": smi(state),
        "result": list(result), "vfs_wall_s": wall, "vfs_walls_s": walls,
        "speech": {"windows": len(xv), "s": t_speech,
                   "windows_per_s": len(xv) / t_speech},
        "all": {"windows": len(starts), "s": t_all,
                "windows_per_s": len(starts) / t_all},
        "all_fresh": {"windows": len(starts), "s": t_fresh,
                      "windows_per_s": len(starts) / t_fresh},
        "batch256_ms": batch_ms,
        "ragged": {"windows": len(ragged), "ms": ragged_ms}}
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
