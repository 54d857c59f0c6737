"""The corpora: seeded 16 kHz mono int16 WAV files.

The signal is ``chip_smoke.seeded_mix``'s, made on the device in a few
large calls a file: noise under a syllable-rate envelope (2-8 Hz) plus a
tone (100-3000 Hz), its level changing every half second, a share of the
sections 40-50 dB down, and stretches of exact digital silence.  The file
lengths are fixed quantiles of a log-uniform law and each file's share of
silence is exact, the same for every seed; the seed sets the order of the
files, where the silences fall and the samples.
"""

from __future__ import annotations

import math
import os
import struct

import numpy as np
import torch

SR = 16000
SECTION = SR // 2


def lengths_s(n, lo_s, hi_s):
    """``n`` lengths in seconds: the (i + 1/2) / n quantiles of a
    log-uniform law on [lo_s, hi_s], in increasing order."""
    q = (np.arange(n) + 0.5) / n
    return [float(lo_s * (hi_s / lo_s) ** x) for x in q]


def silences(rng, seconds, share, gap_s):
    """Digital-silence intervals (start_s, stop_s) covering ``share`` of
    ``seconds``: content and silence alternate, content first; each
    silence is drawn uniform on ``gap_s`` and each content run uniform on
    half to three halves of the mean that gives the share, then both are
    scaled so that the silences sum to the share exactly (every seed
    silences the same amount of each file; it sets only where)."""
    if share <= 0:
        return []
    mean_gap = 0.5 * (gap_s[0] + gap_s[1])
    n = max(1, int(round(seconds * share / mean_gap)))
    gaps = rng.uniform(*gap_s, n)
    runs = rng.uniform(0.5, 1.5, n + 1)
    gaps *= seconds * share / gaps.sum()
    runs *= seconds * (1 - share) / runs.sum()
    out, t = [], 0.0
    for r, g in zip(runs, gaps):
        t += r
        out.append((t, t + g))
        t += g
    return out


def render(n, rng_host, gen, device, quiet_share, silence_share, gap_s):
    """One file of ``n`` samples -> (n,) int16 tensor on ``device``."""
    nsec = -(-n // SECTION)
    u = torch.rand((nsec, 5), generator=gen, device=device,
                   dtype=torch.float64)
    quiet = u[:, 0] < quiet_share
    level = torch.pow(10.0, torch.where(quiet, -2.5 + 0.5 * u[:, 1],
                                        -0.6 + 0.6 * u[:, 1]))
    sec = torch.arange(n, device=device) // SECTION
    t = torch.arange(n, device=device, dtype=torch.float64) / SR
    am_ph = torch.frac(t * (2 + 6 * u[sec, 2]) + u[sec, 3])
    tone_ph = torch.frac(t * (100 + 2900 * u[sec, 4]))
    am = 0.6 + 0.4 * torch.sin(2 * math.pi * am_ph)
    tone = 0.5 * torch.sin(2 * math.pi * tone_ph)
    noise = torch.randn(n, generator=gen, device=device,
                        dtype=torch.float32).to(torch.float64)
    sig = 0.2 * level[sec] * (am * noise + tone)
    keep = torch.ones(n, dtype=torch.bool, device=device)
    for a, b in silences(rng_host, n / SR, silence_share, gap_s):
        keep[int(a * SR):int(b * SR)] = False
    sig = torch.where(keep, sig, torch.zeros_like(sig))
    return torch.clamp(torch.round(sig * 32768.0), -32768,
                       32767).to(torch.int16)


def write_wav(path, pcm):
    """16 kHz mono PCM16 WAV."""
    data = np.ascontiguousarray(pcm, "<i2").tobytes()
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
                 + struct.pack("<IHHIIHH", 16, 1, 1, SR, 2 * SR, 2, 16)
                 + b"data" + struct.pack("<I", len(data)))
        fh.write(data)


def corpus(directory, seed, device, n_files, min_s, max_s, quiet_share,
           silence_share, gap_s, prefix="f"):
    """Write the corpus -> [(path, n_samples)] in the seed's order."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng([int(seed), 7])
    lens = lengths_s(n_files, min_s, max_s)
    order = rng.permutation(n_files)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 1)
    out = []
    for k, i in enumerate(order):
        n = int(round(lens[i] * SR))
        pcm = render(n, rng, gen, device, quiet_share, silence_share,
                     gap_s).cpu().numpy()
        path = os.path.join(directory, f"{prefix}{k:04d}.wav")
        write_wav(path, pcm)
        out.append((path, n))
    return out


def read_pcm(path):
    """The int16 samples of a WAV written by :func:`write_wav`."""
    with open(path, "rb") as fh:
        fh.seek(44)
        return np.frombuffer(fh.read(), "<i2")
