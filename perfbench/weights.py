"""The models' weights, made on the device from the seed.

Each model of a configuration (``configs/<config>.json``, ``models``) is
drawn by one ``torch.Generator`` on the run's device in a few large calls
(one normal draw and one uniform draw a model), in the layouts the
released files use: Keras (HWIO kernels, (in, out) dense matrices,
BatchNormalization as gamma, beta, moving mean, moving variance) for the
patch CNNs and the MLP, and the VBx ResNet's own tree for the x-vector net.

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

STAGE_MULT = (1, 2, 4, 8)


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


def _bn_list(d, c):
    return [d.uniform((c,), 0.9, 1.1), d.normal((c,), 0.05),
            d.normal((c,), 0.05), d.uniform((c,), 0.9, 1.1)]


def _layer(name, cls, **cfg):
    return {"name": name, "class_name": cls,
            "config": dict(name=name, **cfg), "inbound": []}


def patch_cnn_layers(m):
    """Keras layer list of a patch CNN: [Conv2D(relu), BatchNormalization,
    MaxPooling2D] per block, Flatten, Dense(relu), Dense(softmax)."""
    out, shapes = [], []
    cin, h, w = 1, 68, m["nmel"]
    k = m["kernel"]
    for i, (f, pool) in enumerate(zip(m["filters"], m["pools"])):
        out.append(_layer(f"conv{i}", "Conv2D", filters=f,
                          kernel_size=[k, k], strides=[1, 1],
                          padding="same", activation="relu", use_bias=True))
        shapes.append((f"conv{i}", "conv", (k, k, cin, f)))
        out.append(_layer(f"bn{i}", "BatchNormalization", axis=-1,
                          epsilon=m["bn_epsilon"], center=True, scale=True))
        shapes.append((f"bn{i}", "bn", f))
        out.append(_layer(f"pool{i}", "MaxPooling2D", pool_size=list(pool),
                          strides=list(pool), padding="valid"))
        cin, h, w = f, h // pool[0], w // pool[1]
    out.append(_layer("flatten", "Flatten"))
    out += [_layer("fc1", "Dense", units=m["dense"], activation="relu",
                   use_bias=True),
            _layer("out", "Dense", units=m["n_out"], activation="softmax",
                   use_bias=True)]
    shapes += [("fc1", "dense", (h * w * cin, m["dense"])),
               ("out", "dense", (m["dense"], m["n_out"]))]
    return out, shapes


def mlp_layers(m):
    out = [_layer("fc1", "Dense", units=m["hidden"], activation="relu",
                  use_bias=True),
           _layer("out", "Dense", units=1, activation="sigmoid",
                  use_bias=True)]
    return out, [("fc1", "dense", (m["in"], m["hidden"])),
                 ("out", "dense", (m["hidden"], 1))]


def _keras_params(shapes, d, m):
    params = {}
    for name, kind, shape in shapes:
        if kind == "bn":
            params[name] = _bn_list(d, shape)
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


def _count(shapes):
    n = u = 0
    for _, kind, shape in shapes:
        if kind == "bn":
            n += 2 * shape
            u += 2 * shape
        else:
            n += math.prod(shape) + shape[-1]
    return n, u


def resnet_shapes(m):
    """(path, kind, shape) of every array of the VBx ResNet tree."""
    mc = m["m_channels"]
    out = [("conv1", "conv", (3, 3, 1, mc)), ("bn1", "bn", mc)]
    cin = mc
    for si, nb in enumerate(m["num_blocks"]):
        planes = mc * STAGE_MULT[si]
        for bi in range(nb):
            p = f"layer{si + 1}.{bi}"
            out += [(p + ".conv1", "conv", (1, 1, cin, planes)),
                    (p + ".bn1", "bn", planes),
                    (p + ".conv2", "conv", (3, 3, planes, planes)),
                    (p + ".bn2", "bn", planes),
                    (p + ".conv3", "conv", (1, 1, planes, planes * 4)),
                    (p + ".bn3", "bn", planes * 4)]
            stride = 1 if si == 0 or bi else 2
            if stride != 1 or cin != planes * 4:
                out += [(p + ".sc_conv", "conv", (1, 1, cin, planes * 4)),
                        (p + ".sc_bn", "bn", planes * 4)]
            cin = planes * 4
    f = m["feat_dim"]
    for _ in range(3):
        f = -(-f // 2)
    out.append(("embedding", "embed", (2 * cin * f, m["embed_dim"])))
    return out


def _resnet_params(shapes, d, residual_gain):
    tree = {}
    for path, kind, shape in shapes:
        if kind == "bn":
            g, b, mu, v = _bn_list(d, shape)
            if path.endswith(".bn3"):
                # the residual branch's last scale: keeps 33 sums of a
                # branch from growing the activations 2**16-fold
                g = g * residual_gain
            val = {"gamma": g, "beta": b, "mean": mu, "var": v}
        elif kind == "embed":
            val = {"w": d.normal(shape, math.sqrt(1.0 / shape[0])),
                   "b": d.normal((shape[1],), 0.05)}
        else:
            val = d.normal(shape, math.sqrt(2.0 / math.prod(shape[:-1])))
        node, keys = tree, path.split(".")
        for i, key in enumerate(keys[:-1]):
            if key.isdigit():
                continue
            nxt = keys[i + 1]
            if nxt.isdigit():
                lst = node.setdefault(key, [])
                while len(lst) <= int(nxt):
                    lst.append({})
                node = lst[int(nxt)]
            else:
                node = node.setdefault(key, {})
        node[keys[-1]] = val
    return tree


def _resnet_count(shapes):
    n = u = 0
    for _, kind, shape in shapes:
        if kind == "bn":
            n, u = n + 2 * shape, u + 2 * shape
        elif kind == "embed":
            n += math.prod(shape) + shape[1]
        else:
            n += math.prod(shape)
    return n, u


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy().astype(np.float32)


def make(config, seed, device):
    """-> {model name: {"kind", "layers" (Keras models), "torch" (device
    tensors), "numpy"}} for every model of ``config``, drawn in the sorted
    order of their names from one generator seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    out = {}
    for name in sorted(config["models"]):
        m = config["models"][name]
        if m["kind"] == "resnet_xvector":
            shapes = resnet_shapes(m)
            d = _Draws(g, *_resnet_count(shapes), device)
            params = _resnet_params(shapes, d, m.get("residual_gain", 1.0))
            out[name] = {"kind": m["kind"], "layers": None,
                         "torch": params}
        else:
            layers, shapes = (patch_cnn_layers(m) if m["kind"] == "patch_cnn"
                              else mlp_layers(m))
            d = _Draws(g, *_count(shapes), device)
            out[name] = {"kind": m["kind"], "layers": layers,
                         "torch": _keras_params(shapes, d, m)}
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
