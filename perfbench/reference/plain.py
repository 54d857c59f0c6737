"""Plain building blocks of the benchmark's references.

Written from the published descriptions (inaSpeechSegmenter's
``sidekit_mfcc.py``, ``segmenter.py`` and ``viterbi_utils.py``; VBx's
``features.py``, ``resnet.py`` and the femininity scorer of
``vbx_segmenter.py``), in NumPy (float64) and plain PyTorch (float32 with
the TF32 flags off).  Nothing here imports the code under test or JAX, and
nothing takes a value the code under test made: the weights and the WAV
samples come from the benchmark, everything else is worked out again here.

The Viterbi decode runs on the host in float32 arithmetic: every sum is
rounded to float32 as it is formed (a double holds a float32 sum, product
or difference exactly before that rounding), so its decisions are those of
a float32 frame loop, ties included.
"""

from __future__ import annotations

import bisect
import contextlib
import struct

import numpy as np
import torch
import torch.nn.functional as F

SR = 16000

# -- SIDEKIT log-mel features (sidekit_mfcc.py: mfcc / power_spectrum) -----

FE_WIN, FE_HOP, FE_NFFT, FE_NMEL = 400, 160, 512, 24


def hz2mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel2hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def sidekit_fbank(fs=SR, nfft=FE_NFFT, lowfreq=100.0, maxfreq=8000.0,
                  nfilt=FE_NMEL):
    """SIDEKIT ``trfbank`` with only mel-spaced filters: (nfilt, nfft/2+1),
    triangles of height 2 / (hi - low) laid on the FFT bins by the
    library's floor conventions."""
    mels = hz2mel(lowfreq) + np.arange(nfilt + 2) * (
        (hz2mel(maxfreq) - hz2mel(lowfreq)) / (nfilt + 1))
    freqs = mel2hz(mels)
    heights = 2.0 / (freqs[2:] - freqs[:-2])
    fb = np.zeros((nfilt, nfft // 2 + 1), np.float32)
    fft_freqs = np.arange(nfft) / (1.0 * nfft) * fs
    for i in range(nfilt):
        low, cen, hi = freqs[i], freqs[i + 1], freqs[i + 2]
        lid = np.arange(np.floor(low * nfft / fs) + 1,
                        np.floor(cen * nfft / fs) + 1, dtype=np.int32)
        rid = np.arange(np.floor(cen * nfft / fs) + 1,
                        min(np.floor(hi * nfft / fs) + 1, nfft),
                        dtype=np.int32)
        fb[i, lid] = heights[i] / (cen - low) * (fft_freqs[lid] - low)
        fb[i, rid[:-1]] = heights[i] / (hi - cen) * (hi - fft_freqs[rid[:-1]])
    return fb


def frame_count(n):
    return (n - FE_WIN) // FE_HOP + 1 if n >= FE_WIN else 0


def sidekit_features(pcm, block=1 << 15):
    """int16 samples -> (mspec (T, 24), loge (T,)) float32: 400-sample
    frames every 160, pre-emphasis 0.97 within the frame (its first sample
    against itself), log-energy after it, a symmetric Hann window, the
    512-point power spectrum, 24 mel bands 100-8000 Hz and their log.
    Computed in float64 and rounded once."""
    x = np.asarray(pcm, np.float64) / 32768.0
    t = frame_count(len(x))
    fb = sidekit_fbank().astype(np.float64).T
    win = np.hanning(FE_WIN)
    ms = np.empty((t, FE_NMEL), np.float32)
    le = np.empty(t, np.float32)
    idx = np.arange(FE_WIN)
    with np.errstate(divide="ignore"):
        for f0 in range(0, t, block):
            f1 = min(t, f0 + block)
            fr = x[(np.arange(f0, f1) * FE_HOP)[:, None] + idx]
            fr = fr - 0.97 * np.concatenate([fr[:, :1], fr[:, :-1]], axis=1)
            le[f0:f1] = np.log(np.sum(fr * fr, axis=1))
            spec = np.abs(np.fft.rfft(fr * win, FE_NFFT)) ** 2
            ms[f0:f1] = np.log(spec @ fb)
    return ms, le


# -- float32 Viterbi with segment resets (viterbi_utils.py) ---------------

_F32 = struct.Struct("f")


def _r(x):
    return _F32.unpack(_F32.pack(x))[0]


def log_trans_exp(exp, cost0=0.0, cost1=0.0):
    c = -exp * np.log(10)
    return np.array([[cost0, c], [c, cost1]], np.float64)


def diag_trans_exp(exp, dim):
    ret = np.full((dim, dim), -exp * np.log(10))
    np.fill_diagonal(ret, 0.0)
    return ret


def viterbi(em, trans, init, reset):
    """Log-domain Viterbi over (T, K) float32 emissions; a frame with
    ``reset`` starts a segment decoded on its own (from ``init``, with its
    own final argmax).  Scores are renormalised to a maximum of 0 every
    frame; ties go to the lowest state.  -> (T,) int states."""
    em = np.asarray(em, np.float32).tolist()
    tr = [[_r(float(v)) for v in row] for row in np.asarray(trans,
                                                            np.float32)]
    ini = [_r(float(v)) for v in np.asarray(init, np.float32)]
    rs = np.asarray(reset, bool).tolist()
    T = len(em)
    if T == 0:
        return np.zeros(0, np.int64)
    K = len(ini)
    ks = range(K)
    ptrs = [None] * T
    amax = [0] * T
    v = [0.0] * K
    for t in range(T):
        e = em[t]
        if t == 0 or rs[t]:
            nv = [_r(e[k] + ini[k]) for k in ks]
            ptrs[t] = None
        else:
            best, arg = [], []
            for k2 in ks:
                bv, bk = _r(v[0] + tr[0][k2]), 0
                for k in range(1, K):
                    c = _r(v[k] + tr[k][k2])
                    if c > bv:
                        bv, bk = c, k
                best.append(bv)
                arg.append(bk)
            nv = [_r(e[k] + best[k]) for k in ks]
            ptrs[t] = arg
        m = max(nv)
        v = [_r(a - m) for a in nv]
        amax[t] = v.index(max(v))
    out = np.empty(T, np.int64)
    x = 0
    for t in range(T - 1, -1, -1):
        if t == T - 1 or rs[t + 1]:
            x = amax[t]
        else:
            x = ptrs[t + 1][x] if ptrs[t + 1] is not None else x
        out[t] = x
    return out


def masked_decode(log_probs, mask, trans):
    """The masked decode of one stage: emissions are the log-probabilities
    where ``mask`` holds and 0 elsewhere, and a segment starts wherever the
    mask changes (each region is decoded on its own)."""
    k = log_probs.shape[1]
    em = np.where(mask[:, None], log_probs, np.float32(0.0))
    reset = np.ones(len(mask), bool)
    reset[1:] = mask[1:] != mask[:-1]
    init = np.full(k, np.log(1.0 / k), np.float32)
    return viterbi(em, trans, init, reset)


def energy_activity20(loge, n20, energy_ratio=0.03):
    """The energy gate: 10 ms frames above the mean finite log-energy plus
    log(energy_ratio) as a binary emission (1e-10 on the other state),
    decoded with switches at 10^-150 and a stay-inactive cost of 5 nats,
    then every second frame -> (n20,) bool."""
    fin = np.isfinite(loge)
    thr = (np.float64(loge[fin].astype(np.float64).sum())
           / max(int(fin.sum()), 1)
           + float(np.float32(np.log(np.float32(energy_ratio)))))
    lo, hi = np.log(np.array([1e-10, 1 - 1e-10])).astype(np.float32)
    active = loge > thr
    em = np.where(active[:, None], np.array([lo, hi], np.float32),
                  np.array([hi, lo], np.float32))
    reset = np.zeros(len(loge), bool)
    states = viterbi(em, log_trans_exp(150, cost0=-5), np.log([0.5, 0.5]),
                     reset)
    return (states[::2] == 1)[:n20]


# -- patches and the patch CNN (segmenter.py: _get_patches / predict) ------

PATCH_W, LPAD = 68, 17


@contextlib.contextmanager
def exact_float32():
    """Float32 matmuls and convolutions with TF32 off, restored after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


def frame_patches(mspec, frames, nmel):
    """(T, 24) device log-mel, (B,) 20 ms frame indices -> the normalised
    (B, 68, nmel) patches: frame j reads the stride-2 window at row
    2*clip(j - 17, 0, n_rows - 1) (17 replicated windows in front, the last
    one behind), each patch minus its mean over its population std."""
    t = mspec.shape[0]
    n_rows = max((t - PATCH_W) // 2 + 1, 1)
    r = (frames - LPAD).clamp(0, n_rows - 1)
    rows = 2 * r[:, None] + torch.arange(PATCH_W, device=mspec.device)
    p = mspec[:, :nmel][rows].to(torch.float32)
    flat = p.reshape(len(frames), -1)
    mu = flat.mean(dim=1, keepdim=True)
    sd = ((flat - mu) ** 2).mean(dim=1, keepdim=True).sqrt()
    return ((flat - mu) / sd).reshape(p.shape)


class PatchCNN:
    """Keras patch CNN from its layer list and Keras-layout weights, as
    plain PyTorch ops: Conv2D ('same'), BatchNormalization (moving
    statistics), MaxPooling2D ('valid'), Flatten (in NHWC order), Dense,
    and the relu / softmax activations."""

    def __init__(self, layers, params):
        self.layers = layers
        self.params = params

    def __call__(self, x):
        """(B, 68, nmel) patches, or (B, n) rows for a network of Dense
        layers -> (B, n_out) probabilities."""
        h = x[:, None] if x.dim() == 3 else x          # NCHW
        for e in self.layers:
            kind, cfg = e["class_name"], e["config"]
            w = self.params.get(e["name"], [])
            if kind == "Conv2D":
                k = w[0].permute(3, 2, 0, 1)
                h = F.conv2d(h, k, w[1], padding=k.shape[-1] // 2)
            elif kind == "BatchNormalization":
                g, b, m, v = w
                h = ((h - m[:, None, None]) / torch.sqrt(
                    v[:, None, None] + cfg["epsilon"]) * g[:, None, None]
                    + b[:, None, None])
            elif kind == "MaxPooling2D":
                h = F.max_pool2d(h, cfg["pool_size"], cfg["strides"])
            elif kind == "Flatten":
                h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
            elif kind == "Dense":
                h = h @ w[0] + w[1]
            else:
                raise ValueError(f"layer {kind} is not in the plain CNN")
            act = cfg.get("activation")
            if act == "relu":
                h = torch.relu(h)
            elif act == "softmax":
                h = torch.softmax(h, dim=-1)
            elif act == "sigmoid":
                h = torch.sigmoid(h)
        return h


def cnn_probs(model, mspec, mask, nmel, block=4096):
    """Probabilities of the frames where ``mask`` (n20,) holds, 0.5 for a
    patch that is not finite -> (n20, n_out) float32 on the host (other
    frames 0.5)."""
    idx = np.flatnonzero(mask)
    n_out = model.layers[-1]["config"]["units"]
    out = np.full((len(mask), n_out), 0.5, np.float32)
    with torch.no_grad(), exact_float32():
        for b0 in range(0, len(idx), block):
            fr = torch.as_tensor(idx[b0:b0 + block], device=mspec.device)
            p = model(frame_patches(mspec, fr, nmel))
            p = torch.nan_to_num(p, nan=0.5)
            out[idx[b0:b0 + block]] = p.cpu().numpy()
    return out


# -- VBx features (features.py: povey window, kaldi fbank, cmvn) -----------

VBX_WIN, VBX_HOP, VBX_NFFT, VBX_BANDS = 400, 160, 512, 64


def kaldi_fbank(nfft=VBX_NFFT, fs=SR, bands=VBX_BANDS, lofreq=20.0,
                hifreq=7600.0):
    """Kaldi mel bank (mel = 1127 ln(1 + f/700)) on integer centre bins,
    (nfft/2+1, bands)."""
    mel = lambda f: 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)
    imel = lambda m: (np.exp(np.asarray(m, np.float64) / 1127.0) - 1) * 700
    fbin = mel(np.arange(nfft / 2 + 1) * fs / nfft)
    cbin = np.linspace(mel(lofreq), mel(hifreq), bands + 2)
    cind = np.floor(imel(cbin) / fs * nfft).astype(int) + 1
    mfb = np.zeros((len(fbin), bands))
    for i in range(bands):
        mfb[cind[i]:cind[i + 1], i] = ((cbin[i] - fbin[cind[i]:cind[i + 1]])
                                       / (cbin[i] - cbin[i + 1]))
        mfb[cind[i + 1]:cind[i + 2], i] = (
            (cbin[i + 2] - fbin[cind[i + 1]:cind[i + 2]])
            / (cbin[i + 2] - cbin[i + 1]))
    return mfb


def vbx_features(pcm, block=1 << 15):
    """int16 samples -> (T, 64) float32 VBx features, in float64: the
    samples as integers plus the seed-3 dither of 8 * (2u - 1), mirrored
    by 120 in front and 200 behind, then 400-sample frames every 160 with
    the frame mean removed, pre-emphasis 0.97, a Povey window, the
    512-point power spectrum, log(max(1, mel)) in 64 bands 20-7600 Hz and
    the floating-window mean normalisation (150 left, 149 right, clamped
    at the ends)."""
    x = np.asarray(pcm, np.int64).astype(np.float64)
    x = x + 8 * (np.random.RandomState(3).rand(len(x)) * 2 - 1)
    x = np.r_[x[119::-1], x, x[-1:-201:-1]]
    t = (len(x) - VBX_WIN) // VBX_HOP + 1
    win = np.power(0.5 - 0.5 * np.cos(np.linspace(0, 2 * np.pi, VBX_WIN)),
                   0.85)
    fb = kaldi_fbank()
    fea = np.empty((t, VBX_BANDS))
    idx = np.arange(VBX_WIN)
    for f0 in range(0, t, block):
        f1 = min(t, f0 + block)
        fr = x[(np.arange(f0, f1) * VBX_HOP)[:, None] + idx]
        fr = fr - fr.mean(axis=1, keepdims=True)
        fr = fr - 0.97 * np.concatenate([fr[:, :1], fr[:, :-1]], axis=1)
        spec = np.abs(np.fft.rfft(fr * win, VBX_NFFT)) ** 2
        fea[f0:f1] = np.log(np.maximum(spec @ fb, 1.0))
    wl = min(t, 300)
    ws = np.clip(np.arange(t) - 150, 0, t - wl)
    c = np.concatenate([np.zeros((1, VBX_BANDS)), np.cumsum(fea, axis=0)])
    return (fea - (c[ws + wl] - c[ws]) / wl).astype(np.float32)


# -- ResNet x-vector net (VBx resnet.py) ------------------------------------

def _bn(h, p, eps=1e-5):
    return ((h - p["mean"][:, None, None]) / torch.sqrt(
        p["var"][:, None, None] + eps) * p["gamma"][:, None, None]
        + p["beta"][:, None, None])


def _conv(h, w, stride=1):
    k = w.permute(3, 2, 0, 1)                       # HWIO -> OIHW
    return F.conv2d(h, k, stride=stride, padding=k.shape[-1] // 2)


def resnet_embed(params, fea, strides=(1, 2, 2, 2)):
    """(B, T, 64) features -> (B, 256) embeddings of the bottleneck ResNet:
    a 3x3 stem, stages of bottleneck blocks (1x1, 3x3 with the stage's
    stride on the first block, 1x1 to 4x the planes, projection shortcut
    where the shape changes), each conv followed by BatchNorm and ReLU
    after the sum; mean and standard deviation over time of each channel
    and frequency bin, then the linear embedding."""
    h = fea.transpose(1, 2)[:, None]                # (B, 1, 64, T)
    h = torch.relu(_bn(_conv(h, params["conv1"]), params["bn1"]))
    for si, s in enumerate(strides):
        for bi, p in enumerate(params[f"layer{si + 1}"]):
            st = s if bi == 0 else 1
            o = torch.relu(_bn(_conv(h, p["conv1"]), p["bn1"]))
            o = torch.relu(_bn(_conv(o, p["conv2"], st), p["bn2"]))
            o = _bn(_conv(o, p["conv3"]), p["bn3"])
            sc = (_bn(_conv(h, p["sc_conv"], st), p["sc_bn"])
                  if "sc_conv" in p else h)
            h = torch.relu(o + sc)
    mean = h.mean(dim=3)
    std = torch.sqrt((h * h).mean(dim=3) - mean * mean + 1e-10)
    pooled = torch.cat([mean.flatten(1), std.flatten(1)], dim=1)
    return pooled @ params["embedding"]["w"] + params["embedding"]["b"]


# -- the femininity scorer (vbx_segmenter.py) -------------------------------

WINLEN, STEP = 144, 24


class Timeline:
    """Speech intervals: strictly overlapping ones merged, a point inside
    when strictly between an interval's ends."""

    def __init__(self, intervals):
        merged = []
        for a, b in sorted((float(a), float(b)) for a, b in intervals):
            if merged and a < merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        self.iv = merged
        self.starts = [a for a, _ in merged]

    def total(self):
        return sum(b - a for a, b in self.iv)

    def contains(self, m):
        i = bisect.bisect_right(self.starts, m)
        return i > 0 and self.iv[i - 1][0] < m < self.iv[i - 1][1]

    def overlap(self, a, b):
        tot = 0.0
        for lo, hi in self.iv[max(bisect.bisect_left(self.starts, a) - 1,
                                  0):]:
            if lo >= b:
                break
            tot += max(0.0, min(hi, b) - max(lo, a))
        return tot


def xvector_windows(n_frames, duration, timeline):
    """[(start, stop, (seg_start, seg_end))] of the windows whose midpoint
    is speech: 144-frame windows every 24 frames below n - 144, then the
    tail from the last start + 24 when 10 frames or more remain."""
    out = []
    starts = list(range(0, n_frames - WINLEN, STEP))
    for s in starts:
        seg = (round(s / 100.0, 3), round(s / 100.0 + WINLEN / 100.0, 3))
        if timeline.contains((seg[0] + seg[1]) / 2):
            out.append((s, s + WINLEN, seg))
    last = starts[-1] if starts else 0
    if n_frames - last - STEP >= 10:
        seg = (round((last + STEP) / 100.0, 3), round(duration, 3))
        if timeline.contains((seg[0] + seg[1]) / 2):
            out.append((last + STEP, n_frames, seg))
    return out


def select_xvectors(items, timeline, thresh):
    """``items`` [(seg, x)] in window order -> the retained [(seg, x)]:
    windows with at least ``thresh`` of speech, topped up to half of those
    whose midpoint is speech from the best-covered ones after them."""
    kept, mid = [], []
    for seg, x in items:
        if timeline.contains((seg[0] + seg[1]) / 2):
            r = timeline.overlap(seg[0], seg[1]) / (seg[1] - seg[0])
            if r >= thresh:
                kept.append((seg, x))
            mid.append((r, seg, x))
    need = round(0.5 * len(mid))
    if len(kept) < need:
        mid = sorted(mid, key=lambda e: e[0], reverse=True)
        kept += [(seg, x) for _, seg, x in mid[len(kept):need]]
    return kept


def relative_gap(a, b):
    """Largest relative L2 gap of the rows of ``a`` from those of ``b``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if len(a) == 0:
        return 0.0
    return float(np.max(np.linalg.norm(a - b, axis=1)
                        / np.maximum(np.linalg.norm(b, axis=1), 1e-30)))

