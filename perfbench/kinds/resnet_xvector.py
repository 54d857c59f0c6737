"""``resnet_xvector``: the VBx ResNet x-vector net (``resnet.py``'s
bottleneck ResNet on 2-D features, statistics pooling, one embedding
layer), in VBx's own tree of arrays; the port takes it as
``xvector_params=``, so it has no Keras layers."""

from __future__ import annotations

import math

from perfbench.weights import bn_list

TINY = {"num_blocks": [1, 1, 1, 1], "m_channels": 8}
STAGE_MULT = (1, 2, 4, 8)


def shapes(m):
    """(path, kind, shape) of every array of the VBx ResNet tree.  Only
    bottleneck blocks are drawn: another ``block`` is refused, not drawn
    as bottlenecks."""
    if m.get("block") != "bottleneck":
        raise ValueError(f"resnet_xvector draws bottleneck blocks only, "
                         f"not block={m.get('block')!r}")
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


def draws(m):
    n = u = 0
    for _, kind, shape in shapes(m):
        if kind == "bn":
            n, u = n + 2 * shape, u + 2 * shape
        elif kind == "embed":
            n += math.prod(shape) + shape[1]
        else:
            n += math.prod(shape)
    return n, u


def draw(m, d):
    """He-normal convolutions, an embedding of std 1/sqrt(fan-in), and
    each bottleneck's last BatchNorm scale times ``residual_gain``."""
    residual_gain = m.get("residual_gain", 1.0)
    tree = {}
    for path, kind, shape in shapes(m):
        if kind == "bn":
            g, b, mu, v = bn_list(d, shape)
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
    return {"layers": None, "torch": tree}
