"""The weights ``weights.make`` draws, held bit-equal to those the
benchmark drew before each model kind moved into a module of its own
(``kinds/``): SHA-256 digests of every array and of the Keras layer list
of each model, for both configurations at their full and tiny sizes, on
two seeds, drawn on the CPU.  A kind with no module is refused by name."""

from __future__ import annotations

import hashlib
import json

import pytest

from perfbench import run, spec, tiny, weights
from perfbench.kinds import resnet_xvector

SEEDS = (1, 2 ** 31 + 77)
# "<configuration>/<full | tiny>/<seed>/<model>": sha256 of the layer list
# (JSON, sorted keys), then of each array's path, dtype, shape and bytes
# in the tree's order (dict keys sorted)
DIGESTS = {
    "ina_smn_gender/full/1/gender":
        "cacfc11f72b9245cd38d72ace534ba49ea901d7b04d84ed65fd532ca96e23a43",
    "ina_smn_gender/full/1/vad":
        "4aa88ac17ca0e3d92b23a969a47b1b0cc815bb50f0af6099da5f14edb5167fdf",
    "ina_smn_gender/full/2147483725/gender":
        "25f43a8b850f3073ce186870a9394a7d02c91a694613e47ed1ed7bb1f2df0751",
    "ina_smn_gender/full/2147483725/vad":
        "9a5558e2bc7db54ab04fc2ddd84fd2e8edc0bff89c3a1a8036be32dc1542ff9c",
    "ina_smn_gender/tiny/1/gender":
        "d753dd11fae2f61a36ad6b939aca058f8c01dd98837c19860c0a6512ee2da333",
    "ina_smn_gender/tiny/1/vad":
        "df6bdcd4c07df88f65fb30fcf5eff7b47597bd9e490a49c26c3f1da7cdc5b50e",
    "ina_smn_gender/tiny/2147483725/gender":
        "ebf3a185c94e248c0334fc2877478e95af1c8bdee052b9f769fdb0a00d87fb71",
    "ina_smn_gender/tiny/2147483725/vad":
        "d5e9b48306d95446bc47ba7116bda2b191fd26cff8e8d8b30cedb7c06ee19ef0",
    "vbx_resnet101_vfs/full/1/mlp":
        "d5d0264147903fc8be84b1be54d6af4a4108d7d90ec8e60d359706d73d983833",
    "vbx_resnet101_vfs/full/1/resnet":
        "0a5099244a3b3c67392a148b48c10aff3f45461dcd3d3d7869e9118ab9eff56b",
    "vbx_resnet101_vfs/full/1/vad":
        "cf1b979e89ad38ae0b637a62905d23368223578dceaeb179ea22510aea9088ff",
    "vbx_resnet101_vfs/full/2147483725/mlp":
        "e6bdf336d81685e67037fe40131dc3ee6e02ebb797461d717a52b8754de5fc73",
    "vbx_resnet101_vfs/full/2147483725/resnet":
        "2b1880baf854e1e9049450f611016cbc2696f3bf10a3945eea982ac89f4eb87c",
    "vbx_resnet101_vfs/full/2147483725/vad":
        "056e8fb7992d0aa9b2f8afdd7f6c6a379d51474b8c9ce9961d49590b606c8009",
    "vbx_resnet101_vfs/tiny/1/mlp":
        "d5d0264147903fc8be84b1be54d6af4a4108d7d90ec8e60d359706d73d983833",
    "vbx_resnet101_vfs/tiny/1/resnet":
        "53c6bbbd94e334bd736ed7930ced84d10f960d38e3d8857a17699f40cfcadf32",
    "vbx_resnet101_vfs/tiny/1/vad":
        "dd81e494972dd4cf23507c4e203d9d5d7dbb1a1dc131f7a55b74004299e33ab4",
    "vbx_resnet101_vfs/tiny/2147483725/mlp":
        "e6bdf336d81685e67037fe40131dc3ee6e02ebb797461d717a52b8754de5fc73",
    "vbx_resnet101_vfs/tiny/2147483725/resnet":
        "5771ec5b1a305be66c5e9d1c45b7f5d7ecb8e316a836cfb580ef7cac9e3c4ce7",
    "vbx_resnet101_vfs/tiny/2147483725/vad":
        "854428b7b390e82ae679076716996c8e14309ba672668f4fcaa7f6452925997d",
}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def digest(w):
    """SHA-256 of one model of ``weights.make``'s result."""
    h = hashlib.sha256(json.dumps(w["layers"], sort_keys=True).encode())
    for path, a in _leaves(w["numpy"]):
        h.update(f"{path}:{a.dtype}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("cfg", ["ina_smn_gender", "vbx_resnet101_vfs"])
def test_weights_are_bit_equal_to_the_earlier_draw(cfg, size):
    config = spec.config(cfg)
    if size == "tiny":
        config = run._merge(config, tiny.overrides(cfg)["config"])
    got = {}
    for seed in SEEDS:
        w = weights.make(config, seed, "cpu")
        assert list(w) == sorted(config["models"])
        for name, model in w.items():
            assert model["kind"] == config["models"][name]["kind"]
            got[f"{cfg}/{size}/{seed}/{name}"] = digest(model)
    want = {k: v for k, v in DIGESTS.items()
            if k.startswith(f"{cfg}/{size}/")}
    assert got == want


def test_a_kind_without_a_module_is_refused_by_name():
    m = {"kind": "ecapa_tdnn_nowhere", "channels": 8}
    with pytest.raises(ValueError, match="kinds/ecapa_tdnn_nowhere.py"):
        weights.make({"models": {"x": m}}, 1, "cpu")
    with pytest.raises(ValueError, match="kinds/ecapa_tdnn_nowhere.py"):
        weights.kind("ecapa_tdnn_nowhere")


def test_resnet_draws_bottleneck_blocks_only():
    m = dict(spec.config("vbx_resnet101_vfs")["models"]["resnet"],
             **tiny.SMALL_RESNET)
    assert resnet_xvector.draws(m)[0] > 0
    for block in ("basic", None):
        with pytest.raises(ValueError, match="bottleneck"):
            weights.make({"models": {"resnet": dict(m, block=block)}}, 1,
                         "cpu")


@pytest.mark.parametrize("cfg", ["ina_smn_gender", "vbx_resnet101_vfs"])
def test_tiny_sizes_are_the_kinds(cfg):
    models = spec.config(cfg)["models"]
    small = tiny.overrides(cfg)["config"]["models"]
    assert set(small) == set(models)
    for name, m in models.items():
        assert small[name] == weights.kind(m["kind"]).TINY
