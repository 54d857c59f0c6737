"""Seeded inputs shared by the PyTorch-port parity tests (tests/test_torch_*).

Signals are broadband wherever they are not digitally silent (noise under a
syllable-rate envelope, plus a tone, at a level that changes every half
second): two float32 DFT implementations then agree on every mel band to
the 1e-4 tolerance, which a pure tone's far sidelobes would not allow.
"""

from __future__ import annotations

import numpy as np

SR = 16000


def speechlike(seconds, seed, silences=(), quiet=0.25):
    """float32 signal in [-1, 1).

    :param silences: (start_s, stop_s) stretches of exact digital silence.
    :param quiet: fraction of half-second sections 40-50 dB down (frames
        the energy detector calls noEnergy).
    """
    rng = np.random.default_rng(seed)
    n = int(round(seconds * SR))
    t = np.arange(n) / SR
    sig = np.zeros(n)
    sec = SR // 2
    for s0 in range(0, n, sec):
        m = slice(s0, min(n, s0 + sec))
        k = m.stop - m.start
        level = 10 ** (rng.uniform(-2.5, -2.0) if rng.random() < quiet
                       else rng.uniform(-0.6, 0.0))
        am = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 8) * t[m]
                                + rng.uniform(0, 2 * np.pi))
        tone = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t[m])
        sig[m] = level * (am * rng.standard_normal(k) + tone)
    for a, b in silences:
        sig[int(a * SR):int(b * SR)] = 0.0
    return (0.2 * sig).astype(np.float32)


def voiced(seconds, seed, silences=()):
    """float32 signal of one-second tone sections over a -60 dB noise
    floor: 800-1600 Hz tones (which the small synthetic VAD calls speech)
    and 100-300 Hz tones (music, mostly), at levels within 6 dB."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * SR))
    t = np.arange(n) / SR
    sig = np.zeros(n)
    for s0 in range(0, n, SR):
        m = slice(s0, min(n, s0 + SR))
        level = 10 ** rng.uniform(-0.6, 0.0)
        f = rng.uniform(800, 1600) if rng.random() < 0.7 else \
            rng.uniform(100, 300)
        sig[m] = level * (np.sin(2 * np.pi * f * t[m])
                          + 1e-3 * rng.standard_normal(m.stop - m.start))
    for a, b in silences:
        sig[int(a * SR):int(b * SR)] = 0.0
    return (0.2 * sig).astype(np.float32)


def to_int16(sig):
    return np.clip(np.rint(sig * 32768.0), -32768, 32767).astype(np.int16)
