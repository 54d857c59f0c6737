"""The module built from an imported Keras spec.

``ImportedModel`` is the PyTorch counterpart of the JAX package's
``build_forward`` / ``ImportedModel`` (``inaspeechsegmenter_tpu/models/
keras_h5.py``): an ``nn.Module`` that walks the spec's graph (inputs,
outputs, inbound lists, merges) over the layers of ``layers.py``.  A
sequential chain is the graph whose every layer reads the one before, so
the patch CNNs, released or synthetic, take the same walk: rank-4 values
stay channels-first for cuDNN from the input to Flatten, and each value
is freed after the last layer that reads it.

Weights come in the Keras layout (``read_h5``, ``load_native``, the JAX
package's arrays); ``params_from_jax`` turns them into this module's
tensors and ``params_to_jax`` back.  An inference model keeps them as
buffers; ``ImportedModel(spec, params, trainable=True)`` makes every
weight, bias and BatchNormalization array an ``nn.Parameter`` for the
trainer.  The native checkpoint helpers live in ``keras_h5.py`` and are
re-exported here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from . import layers as L
from .keras_h5 import KerasImportError, load_native, read_h5, save_native

__all__ = ["ImportedModel", "UnsupportedLayerError", "params_from_jax",
           "params_to_jax", "save_native", "load_native"]


class UnsupportedLayerError(KerasImportError, NotImplementedError):
    """A layer class outside the JAX package's vocabulary."""


def _check_supported(spec):
    for e in spec["layers"]:
        if e["class_name"] not in L.SUPPORTED:
            raise UnsupportedLayerError(
                f"unsupported layer type {e['class_name']}")


def params_from_jax(spec, params):
    """The JAX package's (Keras-layout) arrays -> this module's tensors.

    Conv2D kernels go HWIO -> OIHW, DepthwiseConv2D (kh, kw, cin, m) ->
    the grouped (cin * m, 1, kh, kw), Conv1D (kw, cin, cout) -> (cout, cin,
    kw); Dense kernels (in, out) are transposed to (out, in) for
    ``F.linear``, rows kept in the NHWC flatten order that
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
        bias = t(w[1]) if cfg.get("use_bias", True) and len(w) > 1 else None
        if cname == "Conv2D":
            out[name] = [t(w[0]).permute(3, 2, 0, 1).contiguous(), bias]
        elif cname == "DepthwiseConv2D":
            kh, kw, cin, m = w[0].shape
            out[name] = [t(w[0]).reshape(kh, kw, cin * m).permute(2, 0, 1)
                         [:, None].contiguous(), bias]
        elif cname == "Conv1D":
            out[name] = [t(w[0]).permute(2, 1, 0).contiguous(), bias]
        elif cname == "Dense":
            out[name] = [t(w[0]).T.contiguous(), bias]
        elif cname == "BatchNormalization":
            gamma = t(w.pop(0)) if cfg.get("scale", True) else None
            beta = t(w.pop(0)) if cfg.get("center", True) else None
            out[name] = [gamma, beta, t(w[0]), t(w[1])]
        else:
            out[name] = []
    return out


def params_to_jax(spec, tensors):
    """This module's tensors -> the JAX package's (Keras-layout) numpy
    arrays: the inverse of ``params_from_jax``.

    :param tensors: ``{layer name: [tensor or None, ...]}`` as
        ``params_from_jax`` returns them (or as ``ImportedModel.tensors``).
    :return: ``{layer name: [arrays]}`` for the layers that hold arrays,
        with the JAX package's list lengths: no entry for a disabled bias,
        BatchNormalization scale or center.
    """
    _check_supported(spec)

    def a(x):
        return x.detach().cpu().numpy().astype(np.float32)

    out = {}
    for e in spec["layers"]:
        name, cname, cfg = e["name"], e["class_name"], e["config"]
        ts = tensors.get(name)
        if not ts:
            continue
        if cname == "BatchNormalization":
            out[name] = [a(t) for t in ts if t is not None]
            continue
        w, bias = ts
        if cname == "Conv2D":
            kernel = a(w.permute(2, 3, 1, 0))
        elif cname == "DepthwiseConv2D":
            m = int(cfg.get("depth_multiplier", 1))
            kh, kw = w.shape[2:]
            kernel = a(w[:, 0].permute(1, 2, 0)).reshape(kh, kw, -1, m)
        elif cname == "Conv1D":
            kernel = a(w.permute(2, 1, 0))
        else:                                   # Dense
            kernel = a(w.T)
        out[name] = [kernel] + ([a(bias)] if bias is not None else [])
    return out


class ImportedModel(nn.Module):
    """A Keras model imported to PyTorch: ``spec``, Keras-layout
    ``params`` and the module that runs them.

    Takes and returns Keras-layout tensors, (B, H, W, C) for images, as
    the JAX forward does.  The forward runs at the precision tier that
    ``ISS_CNN_PRECISION`` names at construction (``layers.cnn_precision``),
    inside ``layers.precision_scope``: the TF32 flags are set for the
    forward and restored after it, never changed process-wide.

    :param trainable: hold every weight, bias and BatchNormalization array
        (the moving statistics too) as an ``nn.Parameter``; the bf16 tier
        then casts each weight at call time.  The default keeps them as
        buffers with the bf16 copies made once.
    """

    def __init__(self, spec, params, *, trainable=False):
        super().__init__()
        _check_supported(spec)
        self.spec = spec
        self.params = params
        self.precision = L.cnn_precision()
        tensors = params_from_jax(spec, params)
        self.inputs = list(spec.get("inputs") or [])
        prev = self.inputs[0] if self.inputs else "<input>"
        known = set(self.inputs) | {prev}
        # steps (name, layer index or None for an alias, merge?, sources)
        plan, mods = [], []
        for e in spec["layers"]:
            name, cname, cfg = e["name"], e["class_name"], e["config"]
            if cname == "InputLayer":
                if name not in known:          # an alias of the value before
                    plan.append((name, None, False, [prev]))
                    known.add(name)
                prev = name
                continue
            srcs = list(e.get("inbound") or []) or [prev]
            missing = [s for s in srcs if s not in known]
            if missing:
                raise KerasImportError(
                    f"layer {name!r} reads unknown layers {missing}")
            plan.append((name, len(mods), cname in L.MERGES, srcs))
            mods.append(_build_layer(cname, cfg, tensors[name],
                                     self.precision, trainable))
            known.add(name)
            prev = name
        self.outputs = list(spec.get("outputs") or [prev])
        self.layers = nn.ModuleList(mods)
        self._plan = plan
        # free each value after the last step that reads it
        last = {}
        for i, (_, _, _, srcs) in enumerate(plan):
            for s in srcs:
                last[s] = i
        self._free = [[s for s, j in last.items() if j == i
                       and s not in self.outputs] for i in range(len(plan))]

    @classmethod
    def from_h5(cls, path):
        return cls(*read_h5(path))

    @classmethod
    def from_native(cls, path):
        return cls(*load_native(path))

    def save_native(self, path):
        save_native(path, self.spec, self.params)

    def tensors(self):
        """``{layer name: [weight, bias]}`` for the conv and matmul layers
        and ``[gamma, beta, mean, var]`` for BatchNormalization (None where
        disabled): this model's own tensors, in ``params_from_jax``'s
        form."""
        out = {}
        for name, index, _, _ in self._plan:
            layer = None if index is None else self.layers[index]
            if isinstance(layer, L.BatchNorm):
                out[name] = [layer.gamma, layer.beta, layer.mean, layer.var]
            elif isinstance(layer, tuple(L.WEIGHTED.values())):
                out[name] = [layer.weight, layer.bias]
        return out

    @property
    def output_dim(self):
        """Best-effort final Dense units (softmax class count)."""
        for e in reversed(self.spec["layers"]):
            if e["class_name"] == "Dense":
                return e["config"]["units"]
        return None

    def forward(self, x):
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        values = dict(zip(self.inputs or ["<input>"], map(L.from_keras, xs)))
        with L.precision_scope(self.precision):
            for i, (name, index, merge, srcs) in enumerate(self._plan):
                ins = [values[s] for s in srcs]
                if index is None:
                    values[name] = ins[0]
                else:
                    layer = self.layers[index]
                    values[name] = layer(*ins) if merge else layer(ins[0])
                for s in self._free[i]:
                    del values[s]
        outs = [L.to_keras(values[n]) for n in self.outputs]
        return outs[0] if len(outs) == 1 else outs


def _build_layer(cname, cfg, tensors, tier, trainable):
    if cname in L.WEIGHTED:
        return L.WEIGHTED[cname](cfg, *tensors, tier=tier,
                                 trainable=trainable)
    if cname == "BatchNormalization":
        return L.BatchNorm(cfg, *tensors, trainable=trainable)
    if cname in L.MERGES:
        return L.MERGES[cname](cfg)
    return L.PLAIN[cname](cfg)
