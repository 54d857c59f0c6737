"""Native checkpoints and the patch-CNN module built from them.

Counterpart of the native half of ``inaspeechsegmenter_tpu/models/
keras_h5.py``: the checkpoint format (a JSON spec plus a flat npz of the
Keras-layout weight arrays, ``save_native`` / ``load_native``) is the JAX
package's, so the two packages read each other's files.  ``PatchCNN`` is
the PyTorch counterpart of ``build_forward``: a sequential chain of the
layers in ``layers.py``.  Keras hdf5 import (h5py) is not part of this
slice.
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn as nn

from . import layers as L

SUPPORTED = ("Conv2D", "BatchNormalization", "MaxPooling2D", "Flatten",
             "Dense")


def save_native(path, spec, params):
    """Native checkpoint: spec as JSON + flat npz of weight arrays."""
    flat = {}
    for lname, arrays in params.items():
        for i, a in enumerate(arrays):
            flat[f"{lname}::{i}"] = np.asarray(a)
    np.savez(path, __spec__=np.frombuffer(
        json.dumps(spec).encode(), dtype=np.uint8), **flat)


def load_native(path):
    """-> (spec dict, {layer name: [numpy arrays]}) in Keras layout."""
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(bytes(z["__spec__"].tobytes()).decode())
        params = {}
        for key in z.files:
            if key == "__spec__":
                continue
            lname, idx = key.rsplit("::", 1)
            params.setdefault(lname, []).append((int(idx), z[key]))
    params = {k: [a for _, a in sorted(v)] for k, v in params.items()}
    return spec, params


def _check_supported(spec):
    prev = None
    for e in spec["layers"]:
        if e["class_name"] not in SUPPORTED:
            raise NotImplementedError(
                f"unsupported layer type {e['class_name']} "
                f"(the port builds {', '.join(SUPPORTED)})")
        inbound = e.get("inbound") or []
        if inbound and inbound != [prev]:
            raise NotImplementedError(
                f"layer {e['name']}: only sequential models are supported")
        prev = e["name"]


def params_from_jax(spec, params):
    """The JAX package's (Keras-layout) arrays -> this module's tensors.

    Conv kernels go HWIO -> OIHW; Dense kernels (in, out) are transposed to
    (out, in) for ``F.linear``, rows kept in the NHWC flatten order that
    ``layers.Flatten`` reproduces.  BatchNormalization gets an explicit
    ``[gamma, beta, mean, var]`` with None for a disabled scale/center.
    """
    _check_supported(spec)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {}
    for e in spec["layers"]:
        name, cname, cfg = e["name"], e["class_name"], e["config"]
        w = list(params.get(name, []))
        use_bias = cfg.get("use_bias", True)
        if cname == "Conv2D":
            out[name] = [t(w[0]).permute(3, 2, 0, 1).contiguous(),
                         t(w[1]) if use_bias else None]
        elif cname == "Dense":
            out[name] = [t(w[0]).T.contiguous(),
                         t(w[1]) if use_bias else None]
        elif cname == "BatchNormalization":
            gamma = t(w.pop(0)) if cfg.get("scale", True) else None
            beta = t(w.pop(0)) if cfg.get("center", True) else None
            out[name] = [gamma, beta, t(w[0]), t(w[1])]
        else:
            out[name] = []
    return out


class PatchCNN(nn.Module):
    """Sequential patch CNN: (B, H, W, C) NHWC float32 -> (B, n_out).

    The input layout is the JAX forward's, so both take the same patches;
    inside, activations are NCHW for cuDNN.

    :param tensors: ``params_from_jax(spec, params)``.
    """

    def __init__(self, spec, tensors):
        super().__init__()
        _check_supported(spec)
        self.spec = spec
        mods = []
        for e in spec["layers"]:
            cname, cfg = e["class_name"], e["config"]
            p = tensors.get(e["name"], [])
            if cname == "Conv2D":
                mods.append(L.Conv2D(cfg, *p))
            elif cname == "BatchNormalization":
                mods.append(L.BatchNorm(cfg, *p))
            elif cname == "MaxPooling2D":
                mods.append(L.MaxPool2D(cfg))
            elif cname == "Flatten":
                mods.append(L.Flatten())
            else:
                mods.append(L.Dense(cfg, *p))
        self.layers = nn.ModuleList(mods)

    @classmethod
    def from_native(cls, path):
        spec, params = load_native(path)
        return cls(spec, params_from_jax(spec, params))

    def forward(self, x):
        if x.dim() == 4:
            x = x.permute(0, 3, 1, 2)
        for layer in self.layers:
            x = layer(x)
        return x
