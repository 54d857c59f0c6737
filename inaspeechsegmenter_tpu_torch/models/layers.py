"""PyTorch inference layers for the Keras patch-CNN vocabulary.

Counterparts of ``inaspeechsegmenter_tpu/models/layers.py`` for the layers
the patch CNNs use: Conv2D (Keras SAME/VALID padding, no dilation),
BatchNormalization (moving statistics, epsilon from the config),
MaxPooling2D (VALID), Flatten (in
Keras NHWC order), Dense, and the relu / softmax / sigmoid / linear
activations (sigmoid ends the VFS scoring MLP).
Activations run channels-first (NCHW) inside the model; Flatten restores
the NHWC element order that the Dense weights were trained against.  Any
other layer class or activation raises.

Convolutions and matmuls go to cuDNN / cuBLAS, as XLA ran them outside any
Pallas kernel in the JAX package.  The exact tier is float32 with TF32 off
(the JAX CPU default, ``ISS_CNN_PRECISION=highest``); the Segmenter turns
TF32 off on CUDA.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(e) for e in v)
    return (int(v), int(v))


def _activation(name):
    if name is None or name == "linear":
        return lambda x: x
    if name == "relu":
        return F.relu
    if name == "softmax":
        return lambda x: F.softmax(x, dim=-1)
    if name == "sigmoid":
        return torch.sigmoid
    raise NotImplementedError(f"activation {name!r}")


def _same_pads(size, kernel, stride):
    """TF/Keras SAME padding (before, after) along one axis: the extra row
    goes after, so even kernels pad asymmetrically (layers.py:106-109)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2D(nn.Module):
    """:param kernel: (cout, cin, kh, kw) tensor; ``bias`` (cout,) or None."""

    def __init__(self, cfg, kernel, bias=None):
        super().__init__()
        self.stride = _pair(cfg.get("strides", 1))
        if _pair(cfg.get("dilation_rate", 1)) != (1, 1):
            raise NotImplementedError("dilated Conv2D")
        self.padding = cfg.get("padding", "valid").upper()
        if self.padding not in ("SAME", "VALID"):
            raise NotImplementedError(f"Conv2D padding {self.padding!r}")
        self.act = _activation(cfg.get("activation"))
        self.register_buffer("kernel", kernel)
        self.register_buffer("bias", bias)

    def forward(self, x):
        if self.padding == "SAME":
            kh, kw = self.kernel.shape[2:]
            ph = _same_pads(x.shape[2], kh, self.stride[0])
            pw = _same_pads(x.shape[3], kw, self.stride[1])
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        out = F.conv2d(x, self.kernel, self.bias, stride=self.stride)
        return self.act(out)


class BatchNorm(nn.Module):
    """Inference batch norm over the channel axis (Keras axis -1 / 3)."""

    def __init__(self, cfg, gamma, beta, mean, var):
        super().__init__()
        axis = cfg.get("axis", -1)
        if isinstance(axis, (list, tuple)):
            axis = axis[0]
        if axis not in (-1, 3):
            raise NotImplementedError(f"BatchNormalization axis {axis}")
        self.eps = float(cfg.get("epsilon", 1e-3))
        for name, t in (("gamma", gamma), ("beta", beta), ("mean", mean),
                        ("var", var)):
            self.register_buffer(name, None if t is None
                                 else t.reshape(1, -1, 1, 1))

    def forward(self, x):
        out = (x - self.mean) * torch.rsqrt(self.var + self.eps)
        if self.gamma is not None:
            out = out * self.gamma
        if self.beta is not None:
            out = out + self.beta
        return out


class MaxPool2D(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.pool = _pair(cfg.get("pool_size", 2))
        self.stride = _pair(cfg.get("strides") or cfg.get("pool_size", 2))
        padding = cfg.get("padding", "valid").upper()
        if padding != "VALID":
            raise NotImplementedError(f"MaxPooling2D padding {padding!r}")

    def forward(self, x):
        return F.max_pool2d(x, self.pool, self.stride)


class Flatten(nn.Module):
    def forward(self, x):
        # NCHW activations, Keras (NHWC) element order
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)


class Dense(nn.Module):
    """:param weight: (out, in) tensor (the Keras kernel transposed)."""

    def __init__(self, cfg, weight, bias=None):
        super().__init__()
        self.act = _activation(cfg.get("activation"))
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)

    def forward(self, x):
        return self.act(F.linear(x, self.weight, self.bias))
