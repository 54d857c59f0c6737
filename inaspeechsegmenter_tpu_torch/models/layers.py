"""PyTorch inference layers for the Keras vocabulary, and the CNN ladder.

Counterparts of every entry of ``LAYER_FNS`` / ``MERGE_FNS`` and every
activation of ``inaspeechsegmenter_tpu/models/layers.py``: convolutions
(Conv2D with dilation, DepthwiseConv2D, Conv1D with causal padding),
Dense, BatchNormalization (moving statistics), max and average pooling
(SAME padding: ``-inf`` pads for max, padded cells left out of the average),
the global pools, Flatten, Reshape, Permute, ZeroPadding2D, the Activation,
ReLU, LeakyReLU and Softmax layers, the identity layers (Dropout and kin),
and the Add, Concatenate and Multiply merges.  Inference semantics only,
as ``keras.Model.predict`` (BatchNormalization reads its moving
statistics, the dropout layers are identities), also when the weights are
trainable parameters (``trainable=True``, the trainer's model) rather
than buffers: the JAX package trains through the same inference layers.

Layout: a rank-4 value is held channels-first (NCHW) inside a model, for
cuDNN; every other rank keeps its Keras layout.  Layers that name a Keras
axis (BatchNormalization, Softmax, Concatenate, the softmax activation)
map it through ``keras_dim``; Flatten, Reshape, Permute and a Dense on a
rank-4 value go through the Keras (NHWC) order, so imported weights apply
unchanged.

The CNN ladder (``ISS_CNN_PRECISION``, read once when a model is built;
an empty value means the default):

- ``highest``: float32 with TF32 off, the exact tier and the default on
  every device (the JAX CPU tier);
- ``high``: float32 with TF32 tensor cores (10 mantissa bits in the
  products): the card's nearest tier to the TPU's bf16 3-pass ``HIGH``,
  and less exact than it;
- ``default`` / ``bf16``: bf16 operands with float32 accumulation; each
  conv and matmul returns float32, as JAX's ``DEFAULT`` returns f32.  The
  bf16 weight copies are made when an inference layer is built, and at
  each call in a trainable one.

Convolutions and matmuls go to cuDNN / cuBLAS, as XLA ran them outside any
Pallas kernel in the JAX package.  What an inference model runs between
one convolution and the next (the bias, ReLU, BatchNormalization, a VALID
max pool, the next conv's SAME border) is one hand kernel,
``cnn_epilogue`` (``csrc/cnn_epilogue.cu``), where ``native.ImportedModel``
finds such a chain (``ConvChain``).  It writes channels-last, the layout
cuDNN keeps from a one-channel Keras input (its permuted view has strides
PyTorch reads as channels-last) and Keras order, which Flatten reshapes
without a copy.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import cuda_build

CNN_TIERS = {"highest": "highest", "high": "high", "default": "bf16",
             "bf16": "bf16"}


def resolve_precision(mode, table, env_name):
    """A tier name -> its tier; an unknown name raises ``ValueError``
    naming the variable (never a silent fallback to another tier)."""
    tier = table.get(mode.lower())
    if tier is None:
        raise ValueError(
            f"{env_name}={mode!r} is not a known precision; expected one of "
            f"{sorted(table)}")
    return tier


def cnn_precision():
    """The tier ``ISS_CNN_PRECISION`` asks for (``highest`` if unset)."""
    return resolve_precision(os.environ.get("ISS_CNN_PRECISION") or "highest",
                             CNN_TIERS, "ISS_CNN_PRECISION")


# The TF32 flags are process-wide, and the port reaches cuBLAS and cuDNN
# from more than one thread: ``batch_score``'s prefetch producers run the
# VAD CNN and the VBx features while the consumer runs the ResNet, and the
# multi-GPU engine runs one thread per mesh slot.  A scope holds the tier
# lock from its entry to its exit: threads at the tier that holds it enter
# together, a thread at another tier waits until every holder has left.
class _TierLock:
    """Shared within a tier, exclusive across tiers.

    ``tier`` is the tier whose flags are set while ``count`` scopes hold
    the lock (``holders``: scopes per thread).  A thread that holds the
    lock alone may re-enter at another tier: that nested scope holds the
    lock exclusively until it ends, when the outer tier's flags return.
    A thread at the holding tier that does not hold the lock yet waits
    while a thread at another tier is waiting, so that one is not starved.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self.tier = None
        self.count = 0
        self.holders = {}
        self.waiting = 0
        self.nested = 0
        self._saved = None

    def _may_enter(self, tier, mine, queued):
        if self.count == 0:
            return True
        if tier != self.tier:
            return mine == self.count       # alone: a nested scope
        if mine:
            return True
        return not self.nested and self.waiting == queued

    def acquire(self, tier):
        """Enter at ``tier`` -> what ``release`` restores: the outer tier
        and its flags for a nested scope at another tier, else None."""
        cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        me = threading.get_ident()
        with self._cond:
            mine = self.holders.get(me, 0)
            queued = 0
            while not self._may_enter(tier, mine, queued):
                if not queued:
                    self.waiting += 1
                    queued = 1
                self._cond.wait()
            self.waiting -= queued
            outer = None
            if self.count == 0:
                self._saved = cuda.allow_tf32, cudnn.allow_tf32
            elif tier != self.tier:
                outer = self.tier, (cuda.allow_tf32, cudnn.allow_tf32)
                self.nested += 1
            if self.count == 0 or outer is not None:
                cuda.allow_tf32 = cudnn.allow_tf32 = tier == "high"
            self.tier = tier
            self.count += 1
            self.holders[me] = mine + 1
            return outer

    def release(self, outer):
        cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        me = threading.get_ident()
        with self._cond:
            self.count -= 1
            left = self.holders.pop(me) - 1
            if left:
                self.holders[me] = left
            if self.count == 0:
                cuda.allow_tf32, cudnn.allow_tf32 = self._saved
                self.tier = None
            elif outer is not None:
                self.tier, (cuda.allow_tf32, cudnn.allow_tf32) = outer
            if outer is not None:
                self.nested -= 1
            self._cond.notify_all()

    def _is_owned(self):
        """True when the calling thread is inside a scope."""
        with self._cond:
            return threading.get_ident() in self.holders


_FLAGS_LOCK = _TierLock()


@contextlib.contextmanager
def precision_scope(tier):
    """TF32 for matmuls and cuDNN convolutions on for ``high``, off for
    the other tiers, for the calls made inside the scope; the flags are
    restored when the last scope ends.  Scopes at one tier run at once on
    several threads (the engine's slots); a scope at another tier waits
    until they have ended, so no call runs under another thread's flags
    and interleaved saves and restores cannot leave the flags changed.
    Every cuBLAS and cuDNN call of the port runs in such a scope."""
    outer = _FLAGS_LOCK.acquire(tier)
    try:
        yield
    finally:
        _FLAGS_LOCK.release(outer)


def tiered_product(fn, x, weight, bias, weight_bf16, channel_dim=1):
    """``fn(x, weight, bias)``, a conv or matmul, at its tier: with a bf16
    copy of the weight the operands go bf16 and the product comes back as
    float32, the bias added in float32 along ``channel_dim``."""
    if weight_bf16 is None:
        return fn(x, weight, bias)
    out = fn(x.to(torch.bfloat16), weight_bf16, None).float()
    if bias is None:
        return out
    shape = [1] * out.dim()
    shape[channel_dim] = -1
    return out + bias.reshape(shape)


def keras_dim(axis, ndim):
    """The tensor dim holding Keras axis ``axis`` of a rank-``ndim`` value
    (rank 4 is held NCHW)."""
    a = axis % ndim
    return (0, 2, 3, 1)[a] if ndim == 4 else a


def to_keras(x):
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x


def from_keras(x):
    return x.permute(0, 3, 1, 2) if x.dim() == 4 else x


def _softmax(x, axis=-1):
    return F.softmax(x, dim=keras_dim(axis, x.dim()))


ACTIVATIONS = {
    None: lambda x: x,
    "linear": lambda x: x,
    "relu": F.relu,
    "softmax": _softmax,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": F.elu,
    "selu": F.selu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "softplus": F.softplus,
    "exponential": torch.exp,
    # the JAX package's hard_sigmoid (not Keras 2's 0.2x + 0.5)
    "hard_sigmoid": lambda x: torch.clamp(x / 6.0 + 0.5, 0.0, 1.0),
    "swish": F.silu,
    "silu": F.silu,
}


def _activation(name):
    if name not in ACTIVATIONS:
        raise NotImplementedError(f"activation {name!r}")
    return ACTIVATIONS[name]


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(e) for e in v)
    return (int(v), int(v))


def _single(v):
    return int(v[0]) if isinstance(v, (list, tuple)) else int(v)


def _same_pads(size, kernel, stride):
    """TF/Keras SAME padding (before, after) along one axis: the extra row
    goes after, so even kernels pad asymmetrically."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _same_pad2d(x, kernel, stride, value=0.0):
    ph = _same_pads(x.shape[2], kernel[0], stride[0])
    pw = _same_pads(x.shape[3], kernel[1], stride[1])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def _register(module, name, tensor, trainable):
    """A weight array as a buffer (inference) or, with ``trainable``, as an
    ``nn.Parameter`` (None stays None)."""
    if trainable and tensor is not None:
        module.register_parameter(name, nn.Parameter(tensor))
    else:
        module.register_buffer(name, tensor)


class _Weighted(nn.Module):
    """A conv or matmul layer at its precision tier: ``bf16`` casts the
    weight to bf16 and returns the product as float32; the bias is added in
    float32.  An inference layer keeps its bf16 copy from construction; a
    trainable one casts at each call, so the copy follows the weight that
    the optimizer updates."""

    channel_dim = 1

    def __init__(self, cfg, weight, bias, tier, trainable=False):
        super().__init__()
        self.activation = cfg.get("activation")
        self.act = _activation(self.activation)
        self.tier = tier
        _register(self, "weight", weight, trainable)
        _register(self, "bias", bias, trainable)
        self.register_buffer(
            "weight_bf16", weight.to(torch.bfloat16)
            if tier == "bf16" and not trainable else None)

    def product(self, fn, x, bias=True):
        """``fn(x, weight, bias)`` at the layer's tier; ``bias=False``
        leaves the bias out (an epilogue adds it)."""
        weight_bf16 = self.weight_bf16
        if weight_bf16 is None and self.tier == "bf16":
            weight_bf16 = self.weight.to(torch.bfloat16)
        return tiered_product(fn, x, self.weight,
                              self.bias if bias else None, weight_bf16,
                              self.channel_dim)


class Conv2D(_Weighted):
    """:param weight: (cout, cin, kh, kw) tensor; ``bias`` (cout,) or None."""

    def __init__(self, cfg, weight, bias=None, tier="highest",
                 trainable=False):
        super().__init__(cfg, weight, bias, tier, trainable)
        self.stride = _pair(cfg.get("strides", 1))
        self.dilation = _pair(cfg.get("dilation_rate", 1))
        self.padding = cfg.get("padding", "valid").upper()
        if self.padding not in ("SAME", "VALID"):
            raise NotImplementedError(f"Conv2D padding {self.padding!r}")

    def border(self, h, w):
        """(top, bottom, left, right): the zeros SAME padding puts around
        an (h, w) input; None for VALID."""
        if self.padding != "SAME":
            return None
        kh, kw = self.weight.shape[2:]
        return (*_same_pads(h, (kh - 1) * self.dilation[0] + 1,
                            self.stride[0]),
                *_same_pads(w, (kw - 1) * self.dilation[1] + 1,
                            self.stride[1]))

    def convolve(self, x, bias=True):
        """The convolution of ``x``, padded already, with no activation."""
        return self.product(
            lambda v, w, b: F.conv2d(v, w, b, self.stride, 0, self.dilation),
            x, bias)

    def forward(self, x):
        pads = self.border(*x.shape[2:])
        if pads is not None:
            x = F.pad(x, (pads[2], pads[3], pads[0], pads[1]))
        return self.act(self.convolve(x))


class DepthwiseConv2D(_Weighted):
    """:param weight: (cin * depth_multiplier, 1, kh, kw), the grouped-conv
    form of the Keras (kh, kw, cin, depth_multiplier) kernel."""

    def __init__(self, cfg, weight, bias=None, tier="highest",
                 trainable=False):
        super().__init__(cfg, weight, bias, tier, trainable)
        self.stride = _pair(cfg.get("strides", 1))
        self.padding = cfg.get("padding", "valid").upper()
        if self.padding not in ("SAME", "VALID"):
            raise NotImplementedError(
                f"DepthwiseConv2D padding {self.padding!r}")

    def forward(self, x):
        if self.padding == "SAME":
            x = _same_pad2d(x, self.weight.shape[2:], self.stride)
        return self.act(self.product(
            lambda v, w, b: F.conv2d(v, w, b, self.stride, groups=v.shape[1]),
            x))


class Conv1D(_Weighted):
    """Keras (B, W, C) values.  :param weight: (cout, cin, kw)."""

    def __init__(self, cfg, weight, bias=None, tier="highest",
                 trainable=False):
        super().__init__(cfg, weight, bias, tier, trainable)
        self.stride = _single(cfg.get("strides", 1))
        self.dilation = _single(cfg.get("dilation_rate", 1))
        self.padding = cfg.get("padding", "valid").upper()
        if self.padding not in ("SAME", "VALID", "CAUSAL"):
            raise NotImplementedError(f"Conv1D padding {self.padding!r}")

    def forward(self, x):
        x = x.transpose(1, 2)
        eff = (self.weight.shape[2] - 1) * self.dilation + 1
        if self.padding == "CAUSAL":
            # Keras causal = left-pad by (kw-1)*dilation, then VALID
            x = F.pad(x, (eff - 1, 0))
        elif self.padding == "SAME":
            x = F.pad(x, _same_pads(x.shape[2], eff, self.stride))
        out = self.product(
            lambda v, w, b: F.conv1d(v, w, b, self.stride, 0, self.dilation),
            x)
        return self.act(out.transpose(1, 2))


class Dense(_Weighted):
    """:param weight: (out, in) tensor (the Keras kernel transposed)."""

    channel_dim = -1

    def forward(self, x):
        return self.act(from_keras(self.product(F.linear, to_keras(x))))


class BatchNorm(nn.Module):
    """Inference batch norm along the configured Keras axis.  With
    ``trainable`` all four arrays, the moving statistics included, are
    parameters, as the JAX trainer differentiates every array of a model.

    An inference layer keeps ``inv = rsqrt(var + eps)`` (not saved with
    the state), made again by the same torch call wherever the module
    moves, so the forward and ``cnn_epilogue`` read the value the device's
    own ``rsqrt`` gives; a trainable layer computes it at each call."""

    def __init__(self, cfg, gamma, beta, mean, var, trainable=False):
        super().__init__()
        axis = cfg.get("axis", -1)
        self.axis = int(axis[0] if isinstance(axis, (list, tuple)) else axis)
        self.eps = float(cfg.get("epsilon", 1e-3))
        for name, t in (("gamma", gamma), ("beta", beta), ("mean", mean),
                        ("var", var)):
            _register(self, name, t, trainable)
        self.register_buffer("inv", None if trainable else self._inv(),
                             persistent=False)

    def _inv(self):
        return torch.rsqrt(self.var + self.eps)

    def _apply(self, fn, *args, **kwargs):
        super()._apply(fn, *args, **kwargs)
        if self.inv is not None:
            self.inv = self._inv()
        return self

    def forward(self, x):
        shape = [1] * x.dim()
        d = keras_dim(self.axis, x.dim())
        shape[d] = x.shape[d]
        inv = self._inv() if self.inv is None else self.inv
        out = (x - self.mean.reshape(shape)) * inv.reshape(shape)
        if self.gamma is not None:
            out = out * self.gamma.reshape(shape)
        if self.beta is not None:
            out = out + self.beta.reshape(shape)
        return out


class _Pool2D(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.pool = _pair(cfg.get("pool_size", 2))
        self.stride = _pair(cfg.get("strides") or cfg.get("pool_size", 2))
        self.padding = cfg.get("padding", "valid").upper()
        if self.padding not in ("SAME", "VALID"):
            raise NotImplementedError(f"pooling padding {self.padding!r}")


class MaxPool2D(_Pool2D):
    def forward(self, x):
        if self.padding == "SAME":
            x = _same_pad2d(x, self.pool, self.stride, value=-float("inf"))
        return F.max_pool2d(x, self.pool, self.stride)


class AvgPool2D(_Pool2D):
    def forward(self, x):
        if self.padding == "VALID":
            return F.avg_pool2d(x, self.pool, self.stride)
        # Keras leaves padded cells out of the denominator: window sums
        # over the zero-padded input divided by the valid-cell counts
        summed = F.avg_pool2d(_same_pad2d(x, self.pool, self.stride),
                              self.pool, self.stride, divisor_override=1)
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        count = F.avg_pool2d(_same_pad2d(ones, self.pool, self.stride),
                             self.pool, self.stride, divisor_override=1)
        return summed / count


class _GlobalPool2D(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.keepdims = bool(cfg.get("keepdims", False))


class GlobalAvgPool2D(_GlobalPool2D):
    def forward(self, x):
        return x.mean(dim=(2, 3), keepdim=self.keepdims)


class GlobalMaxPool2D(_GlobalPool2D):
    def forward(self, x):
        return x.amax(dim=(2, 3), keepdim=self.keepdims)


class Flatten(nn.Module):
    def forward(self, x):
        # NCHW activations, Keras (NHWC) element order
        return to_keras(x).reshape(x.shape[0], -1)


class Reshape(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.target = tuple(int(e) for e in cfg["target_shape"])

    def forward(self, x):
        return from_keras(to_keras(x).reshape((x.shape[0],) + self.target))


class Permute(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.dims = (0,) + tuple(int(e) for e in cfg["dims"])

    def forward(self, x):
        return from_keras(to_keras(x).permute(self.dims))


class ZeroPadding2D(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        p = cfg.get("padding", 1)
        (t, b), (l, r) = ((p, p), (p, p)) if isinstance(p, int) else (
            _pair(e) for e in p)
        self.pads = (l, r, t, b)

    def forward(self, x):
        return F.pad(x, self.pads)


class Activation(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.activation = cfg.get("activation")
        self.act = _activation(self.activation)

    def forward(self, x):
        return self.act(x)


class ReLU(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        # `is not None`: max_value=0.0 is a valid (constant-zero) clamp
        self.max_value = cfg.get("max_value")
        self.slope = float(cfg.get("negative_slope", 0.0) or 0.0)
        self.threshold = float(cfg.get("threshold", 0.0) or 0.0)

    def forward(self, x):
        if self.max_value is not None:
            x = torch.clamp(x, max=float(self.max_value))
        return torch.where(x >= self.threshold, x,
                           self.slope * (x - self.threshold))


class LeakyReLU(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.alpha = float(cfg.get("alpha", cfg.get("negative_slope", 0.3)))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class Softmax(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.axis = int(cfg.get("axis", -1))

    def forward(self, x):
        return _softmax(x, self.axis)


class Identity(nn.Module):
    def __init__(self, cfg=None):
        super().__init__()

    def forward(self, x):
        return x


class Add(nn.Module):
    def __init__(self, cfg=None):
        super().__init__()

    def forward(self, *xs):
        out = xs[0]
        for e in xs[1:]:
            out = out + e
        return out


class Multiply(Add):
    def forward(self, *xs):
        out = xs[0]
        for e in xs[1:]:
            out = out * e
        return out


class Concatenate(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.axis = int(cfg.get("axis", -1))

    def forward(self, *xs):
        return torch.cat(xs, dim=keras_dim(self.axis, xs[0].dim()))


# -- the conv block's epilogue ----------------------------------------------

# the max-pool windows csrc/cnn_epilogue.cu is built for: the patch CNNs'
EPILOGUE_POOLS = ((2, 1), (2, 2))


def pooled_size(h, w, pool):
    """(h, w) after a VALID ``pool`` (ph, pw, sph, spw); None leaves
    them."""
    if pool is None:
        return h, w
    ph, pw, sph, spw = pool
    return (h - ph) // sph + 1, (w - pw) // spw + 1


def cnn_epilogue_plain(y, bias=None, relu=(False, False), affine=None,
                       pool=None, pads=None):
    """The plain version of ``cnn_epilogue``: the unfused layers' own
    operations, in their order."""
    chan = (1, -1, 1, 1)
    v = y if bias is None else y + bias.reshape(chan)
    if relu[0]:
        v = F.relu(v)
    if affine is not None:
        mean, inv, gamma, beta = affine
        v = (v - mean.reshape(chan)) * inv.reshape(chan)
        if gamma is not None:
            v = v * gamma.reshape(chan)
        if beta is not None:
            v = v + beta.reshape(chan)
    if relu[1]:
        v = F.relu(v)
    if pool is not None:
        v = F.max_pool2d(v, pool[:2], pool[2:])
    if pads is not None:
        v = F.pad(v, (pads[2], pads[3], pads[0], pads[1]))
    return v.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def cnn_epilogue(y, bias=None, relu=(False, False), affine=None, pool=None,
                 pads=None):
    """Everything between a conv and the next layer's input, in one pass.

    :param y: (B, C, H, W) float32 conv output, without its bias;
        NCHW-contiguous or channels-last.
    :param bias: (C,) or None.
    :param relu: (a ReLU before the affine, one after it).
    :param affine: (mean, inv, gamma, beta), each (C,) (gamma, beta may be
        None): inference BatchNormalization, ``((v - mean) * inv) * gamma
        + beta``; or None.
    :param pool: (ph, pw, sph, spw), a VALID max pool whose window is
        one of ``EPILOGUE_POOLS`` on the card; or None.
    :param pads: (top, bottom, left, right) zeros written around the
        result, the next SAME conv's border; or None.
    :return: (B, C, Hp + top + bottom, Wp + left + right) float32,
        channels-last (the view of a (B, H, W, C) buffer): the layout the
        next conv runs in, and Keras order, which ``Flatten`` reshapes
        without a copy.

    A CPU tensor runs ``cnn_epilogue_plain``; a CUDA tensor launches the
    kernel (``csrc/cnn_epilogue.cu``) or raises.
    """
    if y.device.type == "cpu":
        return cnn_epilogue_plain(y, bias, relu, affine, pool, pads)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if y.dtype != torch.float32 or y.dim() != 4:
        raise ValueError(f"conv output must be a float32 (B, C, H, W) "
                         f"tensor, got {y.dtype} {tuple(y.shape)}")
    if not (y.is_contiguous()
            or y.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"conv output layout not taken: strides "
                         f"{y.stride()} (NCHW or channels-last only)")
    if y.requires_grad:
        raise ValueError("cnn_epilogue has no backward; a model that "
                         "trains runs the unfused layers")
    b, c, h, w = y.shape
    mean, inv, gamma, beta = affine if affine is not None else (None,) * 4
    for t in (bias, mean, inv, gamma, beta):
        if t is not None and (t.device != y.device or t.dtype != y.dtype
                              or tuple(t.shape) != (c,)
                              or not t.is_contiguous()):
            raise ValueError(f"per-channel tensors must be contiguous "
                             f"float32 ({c},) on {y.device}")
    ph, pw, sph, spw = pool if pool is not None else (1, 1, 1, 1)
    if (ph, pw) not in EPILOGUE_POOLS + ((1, 1),):
        raise ValueError(f"a {ph}x{pw} pool: the kernel is built for the "
                         f"windows {EPILOGUE_POOLS} and none")
    if h < ph or w < pw:
        raise ValueError(f"a {ph}x{pw} pool over a {h}x{w} input")
    hp, wp = pooled_size(h, w, pool)
    pt, pb, pl, pr = pads if pads is not None else (0, 0, 0, 0)
    out = torch.empty((b, pt + hp + pb, pl + wp + pr, c), dtype=y.dtype,
                      device=y.device)
    if y.numel():
        lib = cuda_build.library()
        with torch.cuda.device(y.device):
            rc = lib.iss_cnn_epilogue(
                y.data_ptr(), b, c, h, w, *y.stride(),
                *(None if t is None else t.data_ptr()
                  for t in (bias, mean, inv, gamma, beta)),
                int(relu[0]), int(relu[1]), ph, pw, sph, spw,
                out.data_ptr(), pt, pb, pl, pr,
                torch.cuda.current_stream(y.device).cuda_stream)
        cuda_build.check_launch("cnn_epilogue", rc)
        cuda_build.count_launch(cnn_epilogue)
    return out.permute(0, 3, 1, 2)


cnn_epilogue.launches = 0


def _is_relu(layer):
    if isinstance(layer, Activation):
        return layer.activation == "relu"
    return (isinstance(layer, ReLU) and layer.max_value is None
            and layer.slope == 0.0 and layer.threshold == 0.0)


class ConvChain:
    """``Conv2D -> [ReLU] -> [BatchNormalization on the channel axis] ->
    [ReLU] -> [MaxPooling2D VALID]`` of an inference model, run as one
    step: the cuDNN convolution without its bias, then ``cnn_epilogue``.

    Built by ``native.ImportedModel``'s plan, which feeds it the layers
    that follow the conv (``take``) and sets ``next_conv``, the fused SAME
    conv that reads its output alone, whose border it writes (that
    chain's ``padded_input``).  Holds the model's own layers, not copies:
    it reads their tensors at each call, and runs none of their forwards
    (a forward hook on a fused layer is not called).
    """

    def __init__(self, conv):
        self.conv = conv
        self.relu = [conv.activation == "relu", False]
        self.bn = None
        self.pool = None
        self.padded_input = False
        self.next_conv = None

    @staticmethod
    def start(layer):
        """A chain from ``layer``, or None where it is no Conv2D whose
        activation the epilogue runs."""
        if type(layer) is Conv2D and layer.activation in (None, "linear",
                                                          "relu"):
            return ConvChain(layer)
        return None

    def take(self, layer):
        """Add ``layer``, the chain's next step, where the epilogue runs
        it there -> whether it did."""
        if self.pool is not None:
            return False
        if isinstance(layer, MaxPool2D):
            if (layer.padding != "VALID"
                    or tuple(layer.pool) not in EPILOGUE_POOLS):
                return False
            self.pool = (*layer.pool, *layer.stride)
        elif _is_relu(layer):
            slot = int(self.bn is not None)     # before or after the affine
            if self.relu[slot]:
                return False
            self.relu[slot] = True
        elif isinstance(layer, BatchNorm):
            if (self.bn is not None or layer.inv is None
                    or keras_dim(layer.axis, 4) != 1):
                return False
            self.bn = layer
        else:
            return False
        return True

    def fuses(self):
        """Whether the epilogue has more to do than the conv's bias."""
        return any(self.relu) or self.bn is not None or self.pool is not None

    def __call__(self, x):
        conv = self.conv
        pads = None if self.padded_input else conv.border(*x.shape[2:])
        if pads is not None:
            x = F.pad(x, (pads[2], pads[3], pads[0], pads[1]))
        y = conv.convolve(x, bias=False)
        bn = self.bn
        affine = None if bn is None else (bn.mean, bn.inv, bn.gamma, bn.beta)
        border = None
        if self.next_conv is not None:
            border = self.next_conv.border(
                *pooled_size(*y.shape[2:], self.pool))
        return cnn_epilogue(y, conv.bias, tuple(self.relu), affine,
                            self.pool, border)


# layers with a conv or matmul: Keras class -> module(cfg, weight, bias, tier)
WEIGHTED = {"Conv2D": Conv2D, "DepthwiseConv2D": DepthwiseConv2D,
            "Conv1D": Conv1D, "Dense": Dense}

# single-input layers without weights, and the merges: cfg -> module
PLAIN = {
    "MaxPooling2D": MaxPool2D,
    "AveragePooling2D": AvgPool2D,
    "GlobalAveragePooling2D": GlobalAvgPool2D,
    "GlobalMaxPooling2D": GlobalMaxPool2D,
    "Flatten": lambda cfg: Flatten(),
    "Reshape": Reshape,
    "Permute": Permute,
    "ZeroPadding2D": ZeroPadding2D,
    "Activation": Activation,
    "ReLU": ReLU,
    "LeakyReLU": LeakyReLU,
    "Softmax": Softmax,
    "Dropout": Identity,
    "SpatialDropout1D": Identity,
    "SpatialDropout2D": Identity,
    "GaussianNoise": Identity,
    "GaussianDropout": Identity,
    "ActivityRegularization": Identity,
    "InputLayer": Identity,
}
MERGES = {"Add": Add, "Concatenate": Concatenate, "Multiply": Multiply}
SUPPORTED = frozenset(WEIGHTED) | {"BatchNormalization"} | frozenset(PLAIN) \
    | frozenset(MERGES)
