"""The models' weights, made on the device from the seed.

Each model of a configuration (``configs/<config>.json``, ``models``) is
drawn by one ``torch.Generator`` on the run's device in a few large calls
(one normal draw and one uniform draw a model), in the layouts the
released files use: Keras (HWIO kernels, (in, out) dense matrices,
BatchNormalization as gamma, beta, moving mean, moving variance) for the
patch CNNs and the MLP, and the VBx ResNet's own tree for the x-vector net.
What a model's ``kind`` draws, and in what shapes, is the module
``kinds/<kind>.py`` (``kinds/__init__.py``); a new kind is a new file.

The port receives them through its public doors: the Keras models as
native ``.npz`` checkpoints in a model directory (``model_dir=``), the
ResNet as ``xvector_params=``.  The reference reads the same device
tensors.  Convolutions and dense layers are He-initialised; BatchNorm
statistics and biases are small random values, so that every stage's
arithmetic matters.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch


class _Draws:
    """Slices of one normal and one uniform draw, handed out in order."""

    def __init__(self, g, n_normal, n_uniform, device):
        self.n = torch.randn(n_normal, generator=g, device=device)
        self.u = torch.rand(n_uniform, generator=g, device=device)
        self.i = self.j = 0

    def normal(self, shape, std):
        k = math.prod(shape)
        out = self.n[self.i:self.i + k].reshape(shape) * std
        self.i += k
        return out

    def uniform(self, shape, lo, hi):
        k = math.prod(shape)
        out = self.u[self.j:self.j + k].reshape(shape) * (hi - lo) + lo
        self.j += k
        return out


def bn_list(d, c):
    """A BatchNormalization of ``c`` channels: gamma, beta, moving mean,
    moving variance."""
    return [d.uniform((c,), 0.9, 1.1), d.normal((c,), 0.05),
            d.normal((c,), 0.05), d.uniform((c,), 0.9, 1.1)]


def keras_layer(name, cls, **cfg):
    return {"name": name, "class_name": cls,
            "config": dict(name=name, **cfg), "inbound": []}


def keras_params(shapes, d, m):
    """Keras arrays of ``shapes`` ((name, "conv" | "dense" | "bn",
    shape)): He-normal kernels (``fc1`` times ``input_gain``, ``out``
    times ``out_gain``), small normal biases, ``out_bias`` added to the
    output layer's."""
    params = {}
    for name, kind, shape in shapes:
        if kind == "bn":
            params[name] = bn_list(d, shape)
            continue
        gain = {"fc1": m.get("input_gain", 1.0),
                "out": m.get("out_gain", 1.0)}.get(name, 1.0)
        std = math.sqrt(2.0 / math.prod(shape[:-1])) * gain
        params[name] = [d.normal(shape, std), d.normal((shape[-1],), 0.05)]
    bias = m.get("out_bias")
    if bias is not None:
        params["out"][1] = params["out"][1] + torch.as_tensor(
            bias, dtype=torch.float32, device=params["out"][1].device)
    return params


def keras_count(shapes):
    """(normal, uniform) draws ``keras_params`` takes for ``shapes``."""
    n = u = 0
    for _, kind, shape in shapes:
        if kind == "bn":
            n += 2 * shape
            u += 2 * shape
        else:
            n += math.prod(shape) + shape[-1]
    return n, u


def kind(name):
    """The module of model kind ``name``: ``kinds/<name>.py``."""
    from perfbench import spec

    if not os.path.exists(os.path.join(spec.HERE, "kinds", name + ".py")):
        raise ValueError(f"model kind {name!r} has no module: add "
                         f"perfbench/kinds/{name}.py")
    return spec.module("kinds", name)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy().astype(np.float32)


def make(config, seed, device):
    """-> {model name: {"kind", "layers" (Keras models), "torch" (device
    tensors), "numpy"}} for every model of ``config``, drawn in the sorted
    order of their names from one generator seeded with ``seed``: one
    normal and one uniform draw a model, sized and sliced by the module
    of its kind (``kind``)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    out = {}
    for name in sorted(config["models"]):
        m = config["models"][name]
        k = kind(m["kind"])
        d = _Draws(g, *k.draws(m), device)
        out[name] = {"kind": m["kind"], **k.draw(m, d)}
        out[name]["numpy"] = to_numpy(out[name]["torch"])
    return out


def write_model_dir(config, weights, directory, seed):
    """Write every Keras model as the port's native checkpoint
    ``<file>.npz`` (the spec as JSON beside the arrays) into
    ``directory``."""
    os.makedirs(directory, exist_ok=True)
    for name, m in config["models"].items():
        w = weights[name]
        if w["layers"] is None:
            continue
        spec = {"layers": w["layers"], "inputs": None, "outputs": None,
                "benchmark_seed": int(seed)}
        flat = {f"{lname}::{i}": a for lname, arrays in w["numpy"].items()
                for i, a in enumerate(arrays)}
        np.savez(os.path.join(directory, m["file"] + ".npz"),
                 __spec__=np.frombuffer(json.dumps(spec).encode(),
                                        dtype=np.uint8), **flat)
    return directory
