"""ResNet x-vector network (VBx architecture) as a PyTorch module.

Port of ``inaspeechsegmenter_tpu/models/resnet.py`` (reference
resnet.py:78-135): a 3x3 stem (m_channels=32), four stages of bottleneck
blocks (3, 4, 23, 3) with strides 1/2/2/2 for ResNet101, mean + std
statistics pooling over time, and a Linear projection to embed_dim=256.
Basic blocks are supported as in the JAX package.

Activations are NCHW ``(B, 1, feat, T)``, H = frequency and W = time, the
reference PyTorch layout.  Submodules carry the reference checkpoint's
names (``conv1``, ``bn1``, ``layerK.i.conv1..3``, ``bnN``,
``shortcut.0``/``shortcut.1``, ``embedding``), so a VBx ``raw_81.pth``
state_dict loads with ``load_state_dict`` and a state_dict saved here
loads in the JAX package (``params_from_torch_state``).  Inference only:
BatchNorm always uses its running statistics (eps 1e-5).

Convolutions and the projection go to cuDNN / cuBLAS, as XLA ran them in
the JAX package.  They run at the x-vector tier (``ISS_XVEC_PRECISION``,
read when the net is built; an empty value means the default), the
JAX package's ladder with the CNN ladder's meanings (``layers.py``):
``highest`` (float32 with TF32 off, the exact tier and the default),
``high`` (TF32 tensor cores), ``fast`` / ``bf16`` / ``default`` (bf16
operands, float32 accumulation and outputs, from bf16 weight copies made
when weights load).  The forward sets the TF32 flags for itself and
restores them after.
"""

from __future__ import annotations

import math
import os
import pickle

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import precision_scope, resolve_precision, tiered_product

STAGE_MULT = (1, 2, 4, 8)
STAGE_STRIDE = (1, 2, 2, 2)
XVEC_TIERS = {"highest": "highest", "high": "high", "fast": "bf16",
              "bf16": "bf16", "default": "bf16"}


def xvec_precision():
    """The tier ``ISS_XVEC_PRECISION`` asks for (``highest`` if unset)."""
    return resolve_precision(os.environ.get("ISS_XVEC_PRECISION")
                             or "highest", XVEC_TIERS, "ISS_XVEC_PRECISION")


def pooled_freq(feat_dim):
    """Frequency bins surviving the three stride-2 stages: every conv here
    computes ceil(n/2) per stage (3x3 pad-1 and 1x1 alike), so the chain is
    iterated ceiling division; feat_dim // 8 only matches for multiples
    of 8."""
    f = feat_dim
    for _ in range(3):
        f = -(-f // 2)
    return f


def _bn(x, bn):
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


def _tmask(h, valid):
    """Zero time positions >= valid (per sample).

    Applied right before every 3x3 conv in the masked forward: a boundary
    output then reads exactly the zeros that an exact-length input's conv
    padding would give.  Every other op is pointwise in time, so what lies
    past ``valid`` stays confined there.
    """
    if valid is None:
        return h
    m = torch.arange(h.shape[3], device=h.device)[None, :] < valid[:, None]
    return h * m[:, None, None, :].to(h.dtype)


def _next_valid(valid, stride):
    # conv k=3 / pad=1 (and 1x1 / pad=0) length map: floor((t-1)/s) + 1
    if valid is None or stride == 1:
        return valid
    return torch.div(valid - 1, stride, rounding_mode="floor") + 1


def stats_pool(h, valid=None):
    """Statistics pooling over time: (B, C, F', T) -> (B, 2*C*F'), the
    means then the stds, each flattened in (C, F') order.

    The std is sqrt(E[h^2] - E[h]^2 + 1e-10) over the (first ``valid``)
    time steps: the population variance, not torch.var's default
    correction=1.
    """
    if valid is None:
        mean = h.mean(dim=3)
        meansq = (h * h).mean(dim=3)
    else:
        hm = _tmask(h, valid)
        cnt = valid.to(h.dtype)[:, None, None]
        mean = hm.sum(dim=3) / cnt
        meansq = (hm * hm).sum(dim=3) / cnt
    std = torch.sqrt(meansq - mean * mean + 1e-10)
    return torch.cat([mean.flatten(1), std.flatten(1)], dim=1)


def _conv(x, conv):
    return tiered_product(
        lambda v, w, b: F.conv2d(v, w, b, conv.stride, conv.padding), x,
        conv.weight, None, conv.weight_bf16)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.shortcut = _shortcut(in_planes, planes * 4, stride)

    def forward(self, x, valid=None):
        out = F.relu(_bn(_conv(x, self.conv1), self.bn1))
        out = F.relu(_bn(_conv(_tmask(out, valid), self.conv2), self.bn2))
        out = _bn(_conv(out, self.conv3), self.bn3)
        return F.relu(out + _apply_shortcut(self.shortcut, x))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.shortcut = _shortcut(in_planes, planes, stride)

    def forward(self, x, valid=None):
        stride = self.conv1.stride[0]
        out = F.relu(_bn(_conv(_tmask(x, valid), self.conv1), self.bn1))
        out = _bn(_conv(_tmask(out, _next_valid(valid, stride)), self.conv2),
                  self.bn2)
        return F.relu(out + _apply_shortcut(self.shortcut, x))


def _shortcut(in_planes, out_planes, stride):
    if stride == 1 and in_planes == out_planes:
        return nn.Sequential()
    return nn.Sequential(
        nn.Conv2d(in_planes, out_planes, 1, stride, bias=False),
        nn.BatchNorm2d(out_planes))


def _apply_shortcut(sc, x):
    if len(sc) == 0:
        return x
    return _bn(_conv(x, sc[0]), sc[1])


class ResNetXVector(nn.Module):
    """ResNet x-vector extractor: (B, feat_dim, T) -> (B, embed_dim).

    :param block: 'bottleneck' or 'basic'
    :param num_blocks: e.g. (3, 4, 23, 3) for ResNet101
    """

    def __init__(self, block="bottleneck", num_blocks=(3, 4, 23, 3),
                 m_channels=32, feat_dim=64, embed_dim=256):
        super().__init__()
        if block not in ("bottleneck", "basic"):
            raise ValueError(f"block must be 'bottleneck' or 'basic', got "
                             f"{block!r}")
        self.block = block
        self.num_blocks = tuple(num_blocks)
        self.m_channels = m_channels
        self.feat_dim = feat_dim
        self.embed_dim = embed_dim
        cls = Bottleneck if block == "bottleneck" else BasicBlock
        self.conv1 = nn.Conv2d(1, m_channels, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(m_channels)
        in_planes = m_channels
        for si, (mult, nb, stride) in enumerate(
                zip(STAGE_MULT, self.num_blocks, STAGE_STRIDE)):
            blocks = []
            for bi in range(nb):
                blocks.append(cls(in_planes, m_channels * mult,
                                  stride if bi == 0 else 1))
                in_planes = m_channels * mult * cls.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.embedding = nn.Linear(in_planes * 2 * pooled_freq(feat_dim),
                                   embed_dim)
        self.eval()
        self.set_precision(xvec_precision())

    def set_precision(self, tier):
        """Run at ``tier`` (a key of ``XVEC_TIERS``): for bf16, bf16 copies
        of the conv and projection weights, made from the current weights
        (the loaders below refresh them)."""
        self.precision = resolve_precision(tier, XVEC_TIERS, "precision")
        lowp = self.precision == "bf16"
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.register_buffer(
                    "weight_bf16", m.weight.detach().to(torch.bfloat16)
                    if lowp else None, persistent=False)
        return self

    # -- parameters ---------------------------------------------------------
    def init_params(self, seed=0):
        """Random He-initialised parameters as the JAX package's numpy
        pytree (HWIO convs, identity BatchNorm, (in, out) embedding):
        identical arrays to its ``init_params`` for the same seed."""
        rng = np.random.default_rng(seed)

        def he(shape):
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) * math.sqrt(2.0 / fan_in)
                    ).astype(np.float32)

        def bn(c):
            return dict(gamma=np.ones(c, np.float32),
                        beta=np.zeros(c, np.float32),
                        mean=np.zeros(c, np.float32),
                        var=np.ones(c, np.float32))

        mc = self.m_channels
        params = dict(conv1=he((3, 3, 1, mc)), bn1=bn(mc))
        in_planes = mc
        for si, (mult, nb, stride) in enumerate(
                zip(STAGE_MULT, self.num_blocks, STAGE_STRIDE)):
            planes = mc * mult
            blocks = []
            for bi in range(nb):
                s = stride if bi == 0 else 1
                p = {}
                if self.block == "bottleneck":
                    p["conv1"] = he((1, 1, in_planes, planes))
                    p["bn1"] = bn(planes)
                    p["conv2"] = he((3, 3, planes, planes))
                    p["bn2"] = bn(planes)
                    p["conv3"] = he((1, 1, planes, planes * 4))
                    p["bn3"] = bn(planes * 4)
                    out_planes = planes * 4
                else:
                    p["conv1"] = he((3, 3, in_planes, planes))
                    p["bn1"] = bn(planes)
                    p["conv2"] = he((3, 3, planes, planes))
                    p["bn2"] = bn(planes)
                    out_planes = planes
                if s != 1 or in_planes != out_planes:
                    p["sc_conv"] = he((1, 1, in_planes, out_planes))
                    p["sc_bn"] = bn(out_planes)
                blocks.append(p)
                in_planes = out_planes
            params[f"layer{si + 1}"] = blocks
        feat = pooled_freq(self.feat_dim) * in_planes * 2
        params["embedding"] = dict(
            w=(rng.standard_normal((feat, self.embed_dim))
               * math.sqrt(1.0 / feat)).astype(np.float32),
            b=np.zeros(self.embed_dim, np.float32))
        return params

    def load_jax_params(self, params):
        """Copy a JAX-package parameter pytree into this module (in place,
        keeping its device); returns self."""
        self.load_state_dict(params_from_jax(params, self), strict=False)
        return self.set_precision(self.precision)

    # -- forward ------------------------------------------------------------
    def forward(self, x, n_valid=None):
        """x: (B, feat_dim, T) -> (B, embed_dim).

        ``n_valid``: optional (B,) integer tensor of true time lengths — the
        masked mode: time positions >= n_valid[b] are zeroed before every
        3x3 conv and the statistics pooling averages over the true length,
        so a window zero-padded out to T gives its exact-length embedding
        (up to float reassociation).
        """
        valid = None if n_valid is None else torch.as_tensor(
            n_valid, device=x.device).to(torch.int64)
        with precision_scope(self.precision):
            h = x[:, None]                          # NCHW, H=freq, W=time
            h = F.relu(_bn(_conv(_tmask(h, valid), self.conv1), self.bn1))
            for si, stride in enumerate(STAGE_STRIDE):
                for bi, blk in enumerate(getattr(self, f"layer{si + 1}")):
                    h = blk(h, valid)
                    valid = _next_valid(valid, stride if bi == 0 else 1)
            emb = self.embedding
            return tiered_product(F.linear, stats_pool(h, valid), emb.weight,
                                  emb.bias, emb.weight_bf16, -1)

    # -- weight import ------------------------------------------------------
    def load_torch_checkpoint(self, path):
        """Load a VBx PyTorch checkpoint (``raw_81.pth``) in place.

        ``weights_only``: the released checkpoint is a plain state_dict;
        anything that needs arbitrary unpickling is refused."""
        try:
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as exc:
            raise ValueError(
                f"{path} is not a plain tensor checkpoint (weights_only "
                f"load failed: {exc}); refusing unpickling of arbitrary "
                "objects") from exc
        state = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
        state = dict(state)
        if "embedding.bias" not in state:
            state["embedding.bias"] = torch.zeros(self.embed_dim)
        try:
            missing, unexpected = self.load_state_dict(state, strict=False)
        except RuntimeError as exc:          # tensor shape mismatch
            raise ValueError(f"{path}: checkpoint does not match the "
                             f"architecture: {exc}") from exc
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise ValueError(f"{path}: checkpoint does not match the "
                             f"architecture (missing {missing[:5]}, "
                             f"unexpected {list(unexpected)[:5]})")
        return self.set_precision(self.precision)


def params_from_jax(params, net):
    """The JAX package's ResNet pytree -> a state_dict of ``net``.

    Convs go HWIO -> OIHW; BatchNorm gamma/beta/mean/var -> weight/bias/
    running_mean/running_var; the embedding ``w`` (in, out) is transposed
    to the Linear's (out, in), its rows already in the (C, F') order that
    the NCHW pooling flattens to.
    """
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    state = {}

    def conv(name, w):
        state[name + ".weight"] = t(w).permute(3, 2, 0, 1).contiguous()

    def bn(name, p):
        for src, dst in (("gamma", "weight"), ("beta", "bias"),
                         ("mean", "running_mean"), ("var", "running_var")):
            state[f"{name}.{dst}"] = t(p[src])

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"])
    for si in range(4):
        blocks = params[f"layer{si + 1}"]
        if len(blocks) != net.num_blocks[si]:
            raise ValueError(f"layer{si + 1}: {len(blocks)} blocks in the "
                             f"params, {net.num_blocks[si]} in the net")
        for bi, p in enumerate(blocks):
            pre = f"layer{si + 1}.{bi}"
            for k in ("1", "2", "3"):
                if "conv" + k in p:
                    conv(f"{pre}.conv{k}", p["conv" + k])
                    bn(f"{pre}.bn{k}", p["bn" + k])
            if "sc_conv" in p:
                conv(f"{pre}.shortcut.0", p["sc_conv"])
                bn(f"{pre}.shortcut.1", p["sc_bn"])
    state["embedding.weight"] = t(params["embedding"]["w"]).T.contiguous()
    state["embedding.bias"] = t(params["embedding"]["b"])
    want = {k: v.shape for k, v in net.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    got = {k: v.shape for k, v in state.items()}
    if got != want:
        bad = sorted(set(got) ^ set(want)) or sorted(
            k for k in want if got[k] != want[k])
        raise ValueError(f"params do not match the architecture: {bad[:5]}")
    return state


def ResNet101XVector(feat_dim=64, embed_dim=256):
    return ResNetXVector("bottleneck", (3, 4, 23, 3), 32, feat_dim, embed_dim)
