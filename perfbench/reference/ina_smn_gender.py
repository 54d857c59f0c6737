"""Plain reference of ``ina_smn_gender``: inaSpeechSegmenter with the
speech/music/noise VAD and gender detection.

From the WAV samples and the benchmark's weights: SIDEKIT features, the
energy gate, the VAD patch CNN on the energy-active 20 ms frames and its
decode, then the gender patch CNN on the speech frames and its decode.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import plain

LABELS = ("noEnergy", "speech", "music", "noise", "female", "male")


def build(config, weights, device):
    """The plain models of the configuration's stages."""
    return {name: plain.PatchCNN(weights[name]["layers"],
                                 weights[name]["torch"])
            for name in config["models"]}


def vad(models, config, pcm, device, gender=True):
    """-> dict(labels (n20,) int label ids into ``LABELS``, active (n20,)
    bool, speech (n20,) bool, post_vad (n20, 3), post_gender (n20, 2)):
    the posteriors hold 0.5 outside the frames their stage reads."""
    st = config["stages"]
    ms, le = plain.sidekit_features(pcm)
    t = len(le)
    n20 = (t + 1) // 2
    active = plain.energy_activity20(le, n20, st["energy_ratio"])
    mspec = torch.as_tensor(ms, device=device)
    v = st["vad"]
    post_v = plain.cnn_probs(models["vad"], mspec, active, v["nmel"])
    with np.errstate(divide="ignore"):
        lp = torch.log(torch.as_tensor(post_v)).numpy()
    states = plain.masked_decode(
        lp, active, plain.diag_trans_exp(v["viterbi_arg"], v["n_out"]))
    labels = np.where(active, states + 1, 0)
    speech = labels == 1
    out = {"labels": labels, "active": active, "speech": speech,
           "post_vad": post_v, "n_frames": t}
    if gender:
        g = st["gender"]
        post_g = plain.cnn_probs(models["gender"], mspec, speech, g["nmel"])
        with np.errstate(divide="ignore"):
            lpg = torch.log(torch.as_tensor(post_g)).numpy()
        sg = plain.masked_decode(
            lpg, speech, plain.diag_trans_exp(g["viterbi_arg"], g["n_out"]))
        labels = np.where(speech, sg + 1 + v["n_out"], labels)
        out.update(labels=labels, post_gender=post_g)
    return out


def reference(models, config, pcm, device):
    return vad(models, config, pcm, device, gender=True)
