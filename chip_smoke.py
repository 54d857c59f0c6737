#!/usr/bin/env python3
"""Smoke run of the PyTorch port (inaspeechsegmenter_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one NVIDIA H100 and nvcc.
Phases, each fatal on failure (non-zero exit, no final line):

0. the card (nvidia-smi name and power limit); build the CUDA kernels from
   ``inaspeechsegmenter_tpu_torch/csrc`` and print the build time;
1. each kernel against its plain PyTorch version on the card, at the main
   path's shapes: features on 60 s and 10 min seeded signals with digital
   silence (int16 and float32; finite masks equal, mspec within rtol/atol
   1e-4, loge within 1e-5); Viterbi at K=2 and K=3 on random and
   reset-heavy emissions, T = 180000 (states equal).  Kernel and plain
   times are printed;
2. the main path: full-width synthetic weights (seeded), ``Segmenter("smn",
   detect_gender=True, ffmpeg=None, device="cuda")``, ``batch_process`` of
   three WAVs (2 s of silence, a 60 s and a 10 min seeded mix).  Checks the
   golden silence csv, the csv header, that segments tile each file, that
   both kernels were launched by that run, and that the 60 s labels agree
   with the port on ``device="cpu"`` on >= 99.9% of frames.  Prints per-file
   wall time and real-time factor.

The lines before the last are a JSON object of the kernels and the card's
name and power limit; the last line is the JSON result.  Imports nothing
of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 16000
FEATURE_SECONDS = (60, 600)
VITERBI_T = 180_000


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError("check failed: " + msg)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def seeded_mix(seconds, seed, silences=()):
    """float32 signal: noise under a syllable-rate envelope plus a tone,
    level changing every half second (a quarter of the sections 40-50 dB
    down), with stretches of exact digital silence."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    sig = np.zeros(n)
    sec = SR // 2
    for s0 in range(0, n, sec):
        m = slice(s0, min(n, s0 + sec))
        k = m.stop - m.start
        level = 10 ** (rng.uniform(-2.5, -2.0) if rng.random() < 0.25
                       else rng.uniform(-0.6, 0.0))
        am = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 8) * t[m]
                                + rng.uniform(0, 2 * np.pi))
        tone = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t[m])
        sig[m] = level * (am * rng.standard_normal(k) + tone)
    for a, b in silences:
        sig[int(a * SR):int(b * SR)] = 0.0
    return (0.2 * sig).astype(np.float32)


def to_int16(sig):
    return np.clip(np.rint(sig * 32768.0), -32768, 32767).astype(np.int16)


def silences_every(seconds, period=20.0):
    """A 1 s silence, a 0.3 s island, a 0.7 s silence every ``period``."""
    out = []
    for a in np.arange(5.0, seconds - 3.0, period):
        out += [(a, a + 1.0), (a + 1.3, a + 2.0)]
    return out


def cuda_ms(fn, reps, torch):
    """Mean device time of ``fn`` over ``reps`` launches (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
def phase_features(torch, dev):
    from inaspeechsegmenter_tpu_torch.dsp import fe_kernel, sidekit

    consts = sidekit.frontend_consts(dev)
    worst = 0.0
    times = {}
    for seconds in FEATURE_SECONDS:
        base = seeded_mix(seconds, seed=seconds,
                          silences=silences_every(seconds))
        for name, arr in (("int16", to_int16(base)), ("float32", base)):
            x = torch.from_numpy(arr).to(dev)
            mk, lk = fe_kernel.sidekit_features(x, consts)
            torch.cuda.synchronize()
            mp, lp = fe_kernel.sidekit_features_plain(x, consts)
            torch.cuda.synchronize()
            mk, lk, mp, lp = (a.cpu().numpy() for a in (mk, lk, mp, lp))
            t = sidekit.frame_count(len(arr))
            check(mk.shape == mp.shape == (t, 24) and lk.shape == (t,),
                  f"feature shapes {mk.shape} {mp.shape}")
            fin = np.isfinite(mp)
            check(np.array_equal(np.isfinite(mk), fin),
                  f"mspec finite mask differs ({seconds} s {name})")
            check(np.array_equal(np.isfinite(lk), np.isfinite(lp)),
                  f"loge finite mask differs ({seconds} s {name})")
            check(fin.any() and not fin.all(),
                  "the test signal has silent and non-silent frames")
            check(np.allclose(mk[fin], mp[fin], rtol=1e-4, atol=1e-4),
                  f"mspec differs ({seconds} s {name})")
            finl = np.isfinite(lp)
            check(np.allclose(lk[finl], lp[finl], rtol=1e-5, atol=1e-5),
                  f"loge differs ({seconds} s {name})")
            err = max(float(np.abs(mk[fin] - mp[fin]).max()),
                      float(np.abs(lk[finl] - lp[finl]).max()))
            worst = max(worst, err)
            ms = cuda_ms(lambda: fe_kernel.sidekit_features(x, consts), 20,
                         torch)
            plain_ms = cuda_ms(
                lambda: fe_kernel.sidekit_features_plain(x, consts), 20,
                torch)
            times[(seconds, name)] = (ms, plain_ms)
            log(f"[kernels] sidekit_fe {seconds} s {name}: T={t} "
                f"max_abs_err={err!r} kernel_ms={ms!r} plain_ms={plain_ms!r}")
    ms, plain_ms = times[(600, "int16")]
    return {"name": "sidekit_fe", "route": "cuda",
            "source": "inaspeechsegmenter_tpu_torch/csrc/sidekit_fe.cu",
            "replaces": "inaspeechsegmenter_tpu/dsp/pallas_fe.py:188",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "shape": "600 s int16 signal, 59998 frames"}


def phase_viterbi(torch, dev):
    from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
    from inaspeechsegmenter_tpu_torch.decode.transitions import diag_trans_exp

    timing, worst = None, 0
    for K in (2, 3):
        for kind, p_reset in (("random", 0.001), ("resets", 0.3)):
            rng = np.random.default_rng(100 * K + int(p_reset * 1000))
            em = np.log(rng.dirichlet(np.ones(K), VITERBI_T)).astype(
                np.float32)
            reset = rng.random(VITERBI_T) < p_reset
            reset[0] = True
            args = [torch.from_numpy(a).to(dev) for a in (
                em, diag_trans_exp(0.7, K).astype(np.float32),
                np.full(K, np.log(1.0 / K), np.float32), reset)]
            states_k = tv.viterbi_scan(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states_p = tv.viterbi_scan_plain(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            sk, sp = states_k.cpu().numpy(), states_p.cpu().numpy()
            n_diff = int((sk != sp).sum())
            worst = max(worst, int(np.abs(sk - sp).max()))
            check(n_diff == 0, f"viterbi K={K} {kind}: {n_diff} states "
                               "differ from the plain version")
            check(len(np.unique(sp)) == K, "the decode visits every state")
            ms = cuda_ms(lambda: tv.viterbi_scan(*args), 5, torch)
            log(f"[kernels] viterbi K={K} {kind}: T={VITERBI_T} states "
                f"equal, kernel_ms={ms!r} plain_ms={plain_ms!r}")
            if K == 3 and kind == "random":
                timing = (ms, plain_ms)
    return {"name": "viterbi", "route": "cuda",
            "source": "inaspeechsegmenter_tpu_torch/csrc/viterbi.cu",
            "replaces": "inaspeechsegmenter_tpu/decode/viterbi.py:222",
            "max_abs_err": float(worst), "ms": timing[0],
            "plain_ms": timing[1],
            "shape": f"T={VITERBI_T}, K=3"}


# --------------------------------------------------------------------------
def frame_labels(lseg):
    return np.concatenate([np.full(int(round((b - a) / .02)), lab, object)
                           for lab, a, b in lseg])


def read_csv(path):
    with open(path) as fh:
        text = fh.read()
    lines = text.splitlines()
    rows = [(lab, float(a), float(b))
            for lab, a, b in (ln.split("\t") for ln in lines[1:])]
    return text, lines[0], rows


def phase_main(torch, dev, workdir):
    from inaspeechsegmenter_tpu_torch import Segmenter
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
    from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
    from inaspeechsegmenter_tpu_torch.dsp import fe_kernel
    from inaspeechsegmenter_tpu_torch.dsp.sidekit import frame_count
    from inaspeechsegmenter_tpu_torch.models.synthetic import (
        install_synthetic_models)

    models = install_synthetic_models(os.path.join(workdir, "models"),
                                      seed=0, size="full")
    files = {
        "silence2sec": np.zeros(2 * SR, np.int16),
        "mix60": to_int16(seeded_mix(60, seed=60,
                                     silences=silences_every(60))),
        "mix600": to_int16(seeded_mix(600, seed=600,
                                      silences=silences_every(600))),
    }
    wavs, csvs = [], []
    for name, sig in files.items():
        wavs.append(os.path.join(workdir, name + ".wav"))
        csvs.append(os.path.join(workdir, "out", name + ".csv"))
        write_wav(wavs[-1], sig, SR)

    t0 = time.perf_counter()
    seg = Segmenter("smn", True, ffmpeg=None, device=dev, model_dir=models)
    log(f"[main] Segmenter(device={dev}) built in "
        f"{time.perf_counter() - t0!r} s")

    fe_kernel.sidekit_features.launches = 0
    tv.viterbi_scan.launches = 0
    t0 = time.perf_counter()
    dur, n_ok, avg, lmsg = seg.batch_process(wavs, csvs)
    batch_s = time.perf_counter() - t0
    launches = {"sidekit_fe": fe_kernel.sidekit_features.launches,
                "viterbi": tv.viterbi_scan.launches}
    log(f"[main] batch_process of {len(wavs)} files: {batch_s!r} s, "
        f"statuses {[m[1:] for m in lmsg]}, launches {launches}")
    check(n_ok == len(wavs), f"batch statuses {lmsg}")
    for name, n in launches.items():
        check(n > 0, f"the main path never launched the {name} kernel")

    for (name, sig), csv in zip(files.items(), csvs):
        text, header, rows = read_csv(csv)
        check(header == "labels\tstart\tstop", f"{name}: header {header!r}")
        n20 = (frame_count(len(sig)) + 1) // 2
        check(rows[0][1] == 0.0 and rows[-1][2] == n20 * .02,
              f"{name}: segments do not span the file")
        check(all(r[2] == s[1] for r, s in zip(rows[:-1], rows[1:])),
              f"{name}: segments do not tile the file")
        if name == "silence2sec":
            check(text == "labels\tstart\tstop\nnoEnergy\t0.0\t1.98\n",
                  f"silence csv {text!r}")
        labels = sorted({r[0] for r in rows})
        log(f"[main] {name}: {len(rows)} segments, labels {labels}")

    # warm per-file wall time and real-time factor
    for (name, sig), wav in zip(files.items(), wavs):
        t0 = time.perf_counter()
        seg(wav)
        wall = time.perf_counter() - t0
        log(f"[main] {name}: {len(sig) / SR!r} s audio, wall {wall!r} s, "
            f"rtf {len(sig) / SR / wall!r}")

    # the same 60 s file through the port's plain path on the CPU
    cpu = Segmenter("smn", True, ffmpeg=None, device="cpu", model_dir=models)
    a = frame_labels(seg(wavs[1]))
    b = frame_labels(cpu(wavs[1]))
    check(a.shape == b.shape, "cuda and cpu label counts differ")
    n_diff = int((a != b).sum())
    log(f"[main] mix60 cuda vs cpu: {n_diff} of {len(a)} frames differ")
    check(n_diff <= 0.001 * len(a), "cuda and cpu labels differ on >0.1%")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    card = gpu_line()
    log(f"[card] {card}")
    dev = torch.device("cuda", 0)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from inaspeechsegmenter_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    lib = cuda_build.build(verbose=True)
    cuda_build.library()
    log(f"[build] {os.path.basename(lib)} built and loaded in "
        f"{time.perf_counter() - t0!r} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = [phase_features(torch, dev), phase_viterbi(torch, dev)]
    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_main(torch, dev, workdir)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
