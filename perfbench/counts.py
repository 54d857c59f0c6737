"""The yardstick: the card's peaks and the work each kernel and model
needs, from shapes alone.

Frozen here so that a change to the program cannot move it.  The formulas
for the features and Viterbi kernels are ``chip_smoke.py``'s
(``features_bound``, ``viterbi_bound``); the models' FLOPs count two
operations a multiply-add of every convolution and dense layer, as
``torch.utils.flop_counter.FlopCounterMode`` does
(``test_perfbench_counts.py`` holds them equal on the plain nets).
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores


def bound_s(n_bytes, n_ops):
    """The least time the card could take, in seconds."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS_PER_S)


def _fbank_nonzero():
    from perfbench.reference import plain

    return int(np.count_nonzero(plain.sidekit_fbank()))


_NNZ = []


def features_work(n_samples, sample_bytes=2):
    """(bytes, operations) of the SIDEKIT features of one signal: the
    signal read once, 25 floats a frame written once; a frame's 256-point
    complex FFT (5 N log2 N), the real split (12 a bin), pre-emphasis and
    window (3 a sample), the energy (2 a sample), the power (3 a bin),
    the mel bands (2 a nonzero filter weight) and 25 logs."""
    if not _NNZ:
        _NNZ.append(_fbank_nonzero())
    t = (n_samples - 400) // 160 + 1 if n_samples >= 400 else 0
    per_frame = (5 * 256 * 8 + 12 * 257 + 3 * 400 + 2 * 400 + 3 * 257
                 + 2 * _NNZ[0] + 25)
    return n_samples * sample_bytes + t * 25 * 4, t * per_frame


def viterbi_work(T, K):
    """(bytes, operations) of one decode: emissions and reset flags read
    once, states written once; 2K^2 + 2K adds and compares a frame."""
    return T * K * 4 + T + T * 4 + (K * K + K) * 4, T * (2 * K * K + 2 * K)


def patch_cnn_flops(m):
    """FLOPs of one patch through a patch CNN (``configs``' ``patch_cnn``):
    'same' k x k convolutions at each block's resolution, the pools
    dividing it, then the dense layers."""
    h, w, cin, k = 68, m["nmel"], 1, m["kernel"]
    flops = 0
    for f, (ph, pw) in zip(m["filters"], m["pools"]):
        flops += 2 * k * k * cin * f * h * w
        cin, h, w = f, h // ph, w // pw
    flops += 2 * (h * w * cin * m["dense"] + m["dense"] * m["n_out"])
    return flops


def mlp_flops(m):
    return 2 * (m["in"] * m["hidden"] + m["hidden"])


def resnet_flops(m, frames):
    """FLOPs of one window of ``frames`` feature frames through the
    bottleneck ResNet: every 3x3 and 1x1 convolution at its output size
    (a stride-2 convolution gives ceil(n / 2) rows and columns) and the
    embedding."""
    h, w = m["feat_dim"], frames
    mc = m["m_channels"]
    flops = 2 * 9 * 1 * mc * h * w
    cin = mc
    for si, nb in enumerate(m["num_blocks"]):
        planes = mc * (1, 2, 4, 8)[si]
        for bi in range(nb):
            stride = 1 if si == 0 or bi else 2
            ho, wo = -(-h // stride), -(-w // stride)
            flops += 2 * cin * planes * h * w                   # 1x1
            flops += 2 * 9 * planes * planes * ho * wo          # 3x3
            flops += 2 * planes * planes * 4 * ho * wo          # 1x1
            if stride != 1 or cin != planes * 4:
                flops += 2 * cin * planes * 4 * ho * wo         # shortcut
            cin, h, w = planes * 4, ho, wo
    flops += 2 * (2 * cin * h) * m["embed_dim"]
    return flops


def share(need_s, took_s):
    """A share of a roofline or a peak in %, or None with nothing to
    read."""
    if not took_s or not need_s:
        return None
    return 100.0 * need_s / took_s



# -- the work an answer needs ------------------------------------------------
#
# Counted from the answers the window returned (held against the plain
# reference by ``correct``), never from what the program ran: a program
# that runs a model on more rows than the answers need does not read as
# doing more useful work.

FRAME_S = 0.02           # the segmenter's label frames
VBX_HOP, VBX_LEAD = 160, 80
XV_WINDOW, XV_STEP, XV_TAIL_MIN = 144, 24, 10


def segment_rows(labels, stages):
    """Patches each patch CNN needs for one segmentation answer ((n20,)
    label ids, 0 = noEnergy, the VAD's classes next, the gender's after):
    the VAD CNN one a frame the energy gate passed, the gender CNN one a
    frame labelled female or male."""
    labels = np.asarray(labels)
    rows = {"vad": int(np.count_nonzero(labels != 0))}
    if "gender" in stages:
        rows["gender"] = int(np.count_nonzero(
            labels > stages["vad"]["n_out"]))
    return rows


def cnn_flops(instances, config):
    """FLOPs of the patch CNNs that the answers of ``instances`` need."""
    m = config["models"]
    return sum(n * patch_cnn_flops(m[k])
               for i in instances
               for k, n in segment_rows(i["answer"],
                                        config["stages"]).items())


def cnn_mfu(ctx):
    """The patch CNNs' FLOPs that the traced window's answers need over
    the window at the float32 peak, in %."""
    return share(cnn_flops(ctx["instances"], ctx["config"])
                 / FP32_FLOPS_PER_S, ctx["window_s"])


def vbx_frames(n_samples):
    """VBx feature frames of a signal (mirrored by 120 samples in front
    and 200 behind, 400-sample frames every 160)."""
    return max(0, (n_samples - VBX_LEAD) // VBX_HOP + 1)


def vfs_flops(answer, n_samples, models):
    """FLOPs one VFS answer (score, speech seconds, retained x-vectors)
    needs: the VAD CNN on its speech frames (the answer does not say which
    other frames passed the energy gate, so this part is a lower bound),
    ResNet101 on every retained window and the MLP on every retained
    x-vector.  Windows are 144 frames, but for the file's tail window
    (from the last start + 24, when 10 frames or more remain), which is
    priced at its own length whenever the file has one and any window was
    retained."""
    _, speech_s, nb = answer
    flops = (int(round(speech_s / FRAME_S)) * patch_cnn_flops(models["vad"])
             + nb * mlp_flops(models["mlp"]))
    n = vbx_frames(n_samples)
    starts = range(0, n - XV_WINDOW, XV_STEP)
    last = starts[-1] if len(starts) else 0
    tail = n - last - XV_STEP
    if nb and tail >= XV_TAIL_MIN:
        flops += resnet_flops(models["resnet"], tail)
        nb -= 1
    return flops + nb * resnet_flops(models["resnet"], XV_WINDOW)
