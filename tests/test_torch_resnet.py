"""PyTorch port: the ResNet x-vector network against the JAX package.

Both packages run on the same numpy parameter pytree.  ``init_params``
writes identity BatchNorm, so every BN array is perturbed with a seeded
rng first: a BN mapping bug would otherwise not show.  Embeddings must
agree within rtol/atol 1e-4 (float32 convolutions summed in another order,
the masked tests' bound in tests/test_resnet.py).  Tiny nets only: a full
ResNet101 forward belongs on the card.
"""

import io

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu.models import resnet as jres
from inaspeechsegmenter_tpu.vfs import _load_resnet_npz as jax_load_npz
from inaspeechsegmenter_tpu.vfs import save_resnet_npz as jax_save_npz
from inaspeechsegmenter_tpu_torch import vfs as tvfs
from inaspeechsegmenter_tpu_torch.models import resnet as tres

# (block, num_blocks, m_channels, feat_dim, embed_dim); 20 bands is not a
# multiple of 8, so a feat_dim // 8 pooling size would break the projection
NETS = [("bottleneck", (1, 1, 1, 1), 8, 64, 32),
        ("basic", (2, 2, 2, 2), 8, 64, 32),
        ("bottleneck", (1, 1, 1, 1), 8, 20, 16)]
TOL = dict(rtol=1e-4, atol=1e-4)


def perturbed_params(cfg, seed=3):
    """init_params with every BatchNorm array replaced by seeded values."""
    params = jres.ResNetXVector(*cfg).init_params(seed=seed)
    rng = np.random.default_rng(seed + 100)

    def walk(node):
        if isinstance(node, dict) and "gamma" in node:
            c = node["gamma"].shape[0]
            node.update(gamma=rng.uniform(0.5, 1.5, c).astype(np.float32),
                        beta=rng.normal(0, 0.1, c).astype(np.float32),
                        mean=rng.normal(0, 0.1, c).astype(np.float32),
                        var=rng.uniform(0.5, 2.0, c).astype(np.float32))
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(params)
    return params


def port_net(cfg, params):
    return tres.ResNetXVector(*cfg).load_jax_params(params)


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cfg", NETS + [("bottleneck", (3, 4, 23, 3), 32,
                                         64, 256)])
def test_init_params_identical(cfg):
    assert_trees_equal(tres.ResNetXVector(*cfg).init_params(seed=5),
                       jres.ResNetXVector(*cfg).init_params(seed=5))


def test_resnet101_module_shapes():
    net = tres.ResNet101XVector()
    assert net.num_blocks == (3, 4, 23, 3) and net.m_channels == 32
    assert net.embedding.in_features == 8 * 1024 * 2
    assert net.embedding.out_features == 256
    sd = net.state_dict()
    assert sd["layer3.22.conv2.weight"].shape == (128, 128, 3, 3)
    assert sd["layer4.0.shortcut.0.weight"].shape == (1024, 512, 1, 1)


@pytest.mark.parametrize("t", [144, 101])
@pytest.mark.parametrize("cfg", NETS)
def test_forward_matches_jax(cfg, t):
    params = perturbed_params(cfg)
    x = np.random.default_rng(t).standard_normal(
        (3, cfg[3], t)).astype(np.float32)
    want = np.asarray(jres.ResNetXVector(*cfg)(params, x))
    with torch.no_grad():
        got = port_net(cfg, params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, cfg[4])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cfg", NETS[:2])
def test_masked_forward_matches_jax(cfg):
    params = perturbed_params(cfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, cfg[3], 144)).astype(np.float32)
    n_valid = np.array([144, 100, 37, 10], np.int32)
    want = np.asarray(jres.ResNetXVector(*cfg).forward(params, x, n_valid))
    net = port_net(cfg, params)
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(n_valid)).numpy()
        # and each equals its exact-length window
        exact = [net(torch.from_numpy(x[i:i + 1, :, :n])).numpy()[0]
                 for i, n in enumerate(n_valid)]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.stack(exact), **TOL)


def test_stats_pool_is_population_std_in_c_f_order():
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    got = tres.stats_pool(torch.from_numpy(h)).numpy()
    mean = h.mean(axis=3)
    std = np.sqrt((h * h).mean(axis=3) - mean * mean + 1e-10)
    want = np.concatenate([mean.reshape(2, -1), std.reshape(2, -1)], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # torch.std's default correction=1 would differ by sqrt(7/6)
    assert not np.allclose(std, h.std(axis=3, ddof=1), rtol=1e-3)


@pytest.mark.parametrize("cfg", NETS)
def test_state_dict_loads_in_jax(cfg):
    """The port's state_dict keys are the reference checkpoint's: the JAX
    package's ``params_from_torch_state`` rebuilds the original params."""
    params = perturbed_params(cfg)
    sd = port_net(cfg, params).state_dict()
    assert_trees_equal(jres.ResNetXVector(*cfg).params_from_torch_state(sd),
                       params)


def test_npz_round_trip_across_packages(tmp_path):
    cfg = NETS[0]
    params = perturbed_params(cfg)
    jax_save_npz(str(tmp_path / "j.npz"), params)
    assert_trees_equal(tvfs._load_resnet_npz(str(tmp_path / "j.npz")), params)
    tvfs.save_resnet_npz(str(tmp_path / "t.npz"), params)
    assert_trees_equal(jax_load_npz(str(tmp_path / "t.npz")), params)


def test_pth_checkpoint_loads_weights_only(tmp_path):
    cfg = NETS[1]
    params = perturbed_params(cfg)
    src = port_net(cfg, params)
    path = str(tmp_path / "raw_81.pth")
    torch.save({"state_dict": src.state_dict()}, path)
    net = tres.ResNetXVector(*cfg).load_torch_checkpoint(path)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 64, 50)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(net(x).numpy(), src(x).numpy())
    # a pickle that is not plain tensors is refused
    torch.save({"state_dict": src.state_dict(), "obj": io.BytesIO}, path)
    with pytest.raises(ValueError, match="weights_only"):
        tres.ResNetXVector(*cfg).load_torch_checkpoint(path)
    # so is a checkpoint of another architecture
    torch.save(port_net(NETS[0], perturbed_params(NETS[0])).state_dict(),
               path)
    with pytest.raises(ValueError, match="does not match"):
        tres.ResNetXVector(*cfg).load_torch_checkpoint(path)


def test_params_of_another_architecture_raise():
    with pytest.raises(ValueError, match="blocks"):
        port_net(NETS[0], perturbed_params(NETS[1]))


def _export_onnx(model, x, fold):
    """torch.onnx.export without the `onnx` package: the legacy exporter
    builds the ModelProto bytes itself and imports `onnx` only for an
    onnx-script post-pass, a no-op for plain models (tests/
    test_onnx_loader.py)."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom: \
        model_bytes
    try:
        buf = io.BytesIO()
        torch.onnx.export(model, x, buf, opset_version=12, dynamo=False,
                          do_constant_folding=fold)
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig
    return buf.getvalue()


@pytest.mark.parametrize("fold", [True, False])
def test_onnx_export_of_port_module_loads_back(tmp_path, fold):
    cfg = NETS[0]
    src = port_net(cfg, perturbed_params(cfg))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, cfg[3], 60)).astype(np.float32))
    path = tmp_path / "final.onnx"
    path.write_bytes(_export_onnx(src, x, fold))
    net = tres.ResNetXVector(*cfg)
    net.load_jax_params(tvfs._load_resnet_onnx(net, str(path)))
    with torch.no_grad():
        np.testing.assert_allclose(net(x).numpy(), src(x).numpy(), **TOL)
