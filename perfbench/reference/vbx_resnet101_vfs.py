"""Plain reference of ``vbx_resnet101_vfs``: voice femininity scoring.

From the WAV samples and the benchmark's weights: the speech/music/noise
VAD of ``ina_smn_gender`` (no gender stage), the VBx features, the
ResNet101 x-vector of every window whose midpoint is speech, the window
selection, and the femininity MLP.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import ina_smn_gender, plain


def build(config, weights, device):
    return {"vad": plain.PatchCNN(weights["vad"]["layers"],
                                  weights["vad"]["torch"]),
            "mlp": plain.PatchCNN(weights["mlp"]["layers"],
                                  weights["mlp"]["torch"]),
            "resnet": weights["resnet"]["torch"]}


def speech_timeline(labels):
    """Speech runs of the 20 ms labels as (start_s, stop_s) intervals."""
    sp = np.concatenate([[False], labels == 1, [False]])
    edges = np.flatnonzero(sp[1:] != sp[:-1])
    return plain.Timeline([(a * .02, b * .02)
                           for a, b in zip(edges[::2], edges[1::2])])


def reference(models, config, pcm, device, block=128):
    """-> dict(speech_duration, score | None, xvectors (N, 256) x10 and
    probs (N,) of the retained windows in the scorer's order, windows
    (embedded), labels)."""
    out = ina_smn_gender.vad(models, config, pcm, device, gender=False)
    tl = speech_timeline(out["labels"])
    sd = tl.total()
    res = {"speech_duration": sd, "score": None, "windows": 0,
           "xvectors": np.zeros((0, 256), np.float32),
           "probs": np.zeros(0, np.float32), "labels": out["labels"],
           "active": out["active"]}
    if not sd:
        return res
    fea = plain.vbx_features(pcm)
    wins = plain.xvector_windows(len(fea), len(pcm) / plain.SR, tl)
    f = torch.as_tensor(fea, device=device)
    embs = []
    with torch.no_grad(), plain.exact_float32():
        full = [w for w in wins if w[1] - w[0] == plain.WINLEN]
        for b0 in range(0, len(full), block):
            st = torch.as_tensor([w[0] for w in full[b0:b0 + block]],
                                 device=device)
            x = f[st[:, None] + torch.arange(plain.WINLEN, device=device)]
            embs.append(plain.resnet_embed(models["resnet"], x).cpu())
        for a, b, _ in wins[len(full):]:
            embs.append(plain.resnet_embed(models["resnet"],
                                           f[a:b][None]).cpu())
    emb = (torch.cat(embs).numpy() if embs
           else np.zeros((0, 256), np.float32))
    items = [(seg, e * 10) for (_, _, seg), e in zip(wins, emb)
             if not np.isnan(e).any()]
    kept = plain.select_xvectors(items, tl, config["stages"]["vad_thresh"])
    res["windows"] = len(wins)
    if not kept:
        return res
    x = np.stack([e for _, e in kept]).astype(np.float32)
    with torch.no_grad(), plain.exact_float32():
        p = models["mlp"](torch.as_tensor(x, device=device)).cpu().numpy()
    p = p.reshape(-1)
    res.update(xvectors=x, probs=p,
               score=float(np.mean(p >= 0.5)))
    return res
