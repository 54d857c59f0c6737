"""PyTorch port: synthetic weights and the patch CNN against the JAX model.

The port's numpy weight builder must give arrays identical to the JAX
package's for the same seed and size; the forward pass built through
``ImportedModel`` must match the JAX ``ImportedModel`` within atol 1e-5
(float32 convolutions summed in another order).

The conv chains an inference model runs as one epilogue
(``layers.ConvChain``, ``layers.cnn_epilogue``): which chains the plan
fuses and how each writes its output, what it leaves to the layers, the
plain epilogue against the unfused layers bit for bit at each tier's conv
outputs, and the fused forward within 1e-6 of the unfused one (the conv
adds no bias in the fused one; the epilogue does).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from inaspeechsegmenter_tpu.models import synthetic as jsyn
from inaspeechsegmenter_tpu.models.keras_h5 import ImportedModel
from inaspeechsegmenter_tpu_torch.models import layers as L
from inaspeechsegmenter_tpu_torch.models import native, synthetic as tsyn
from inaspeechsegmenter_tpu_torch.models.registry import (ModelNotFoundError,
                                                          load_patch_model)

CNNS = [(21, 2, 0), (21, 3, 1), (24, 2, 2)]


@pytest.mark.parametrize("size", ["small", "full"])
@pytest.mark.parametrize("nmel,nout,seed", CNNS)
def test_synthetic_arrays_identical(size, nmel, nout, seed):
    spec_j, params_j = jsyn.build_patch_cnn(nmel, nout, seed, size)
    spec_t, params_t = tsyn.build_patch_cnn(nmel, nout, seed, size)
    assert spec_t == spec_j
    assert params_t.keys() == params_j.keys()
    for name in params_j:
        for a, b in zip(params_j[name], params_t[name], strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_installed_sets_identical(tmp_path):
    jsyn.install_synthetic_models(str(tmp_path / "j"), seed=4, size="small")
    tsyn.install_synthetic_models(str(tmp_path / "t"), seed=4, size="small")
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    for name in names:
        if not name.endswith(".npz"):
            continue
        sj, pj = native.load_native(str(tmp_path / "j" / name))
        st, pt = native.load_native(str(tmp_path / "t" / name))
        assert sj == st
        for k in pj:
            for a, b in zip(pj[k], pt[k], strict=True):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nmel,nout,seed", CNNS)
def test_forward_matches_jax(nmel, nout, seed):
    spec, params = jsyn.build_patch_cnn(nmel, nout, seed, "small")
    # non-trivial batch-norm statistics, so every BN term is exercised
    rng = np.random.default_rng(seed)
    for i in range(4):
        c = params[f"bn{i}"][0].shape[0]
        params[f"bn{i}"] = [rng.uniform(0.5, 1.5, c).astype(np.float32),
                            rng.normal(0, 0.1, c).astype(np.float32),
                            rng.normal(0, 0.1, c).astype(np.float32),
                            rng.uniform(0.5, 2.0, c).astype(np.float32)]
    x = rng.standard_normal((16, 68, nmel, 1)).astype(np.float32)
    want = np.asarray(ImportedModel(spec, params)(x))
    model = native.ImportedModel(spec, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (16, nout)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [3, 4])
def test_gender_mlp_matches_jax(seed):
    """The VFS scoring MLP (256 -> 128 relu -> 1 sigmoid) within 1e-6."""
    spec, params = tsyn.build_gender_mlp(seed=seed)
    spec_j, params_j = jsyn.build_gender_mlp(seed=seed)
    assert spec == spec_j
    x = np.random.default_rng(seed).standard_normal(
        (64, 256)).astype(np.float32)
    want = np.asarray(ImportedModel(spec_j, params_j)(x))
    model = native.ImportedModel(spec, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (64, 1)
    assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_flatten_keeps_keras_nhwc_order():
    """A Dense after Flatten sees (h, w, c)-ordered features."""
    spec = dict(layers=[
        dict(name="flatten", class_name="Flatten", config={}, inbound=[]),
        dict(name="d", class_name="Dense",
             config=dict(units=1, activation=None, use_bias=False),
             inbound=[])])
    h, w, c = 2, 3, 4
    kernel = np.zeros((h * w * c, 1), np.float32)
    kernel[(1 * w + 2) * c + 3] = 1.0       # picks element (h=1, w=2, c=3)
    model = native.ImportedModel(spec, {"d": [kernel]})
    x = np.arange(h * w * c, dtype=np.float32).reshape(1, h, w, c)
    assert float(model(torch.from_numpy(x))[0, 0]) == x[0, 1, 2, 3]


def test_unknown_layer_class_raises():
    spec, params = jsyn.build_patch_cnn(21, 3, 0, "small")
    spec["layers"].insert(3, dict(name="lstm", class_name="LSTM", config={},
                                  inbound=[]))
    with pytest.raises(NotImplementedError, match="LSTM"):
        native.params_from_jax(spec, params)
    with pytest.raises(NotImplementedError, match="LSTM"):
        native.ImportedModel(spec, params)


def test_unknown_activation_raises():
    spec, params = jsyn.build_patch_cnn(21, 3, 0, "small")
    spec["layers"][0]["config"]["activation"] = "mish"
    with pytest.raises(NotImplementedError, match="mish"):
        native.ImportedModel(spec, params)


def test_registry_reads_npz_and_raises_when_missing(tmp_path):
    tsyn.install_synthetic_models(str(tmp_path), size="small")
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        model = load_patch_model("keras_male_female_cnn.hdf5",
                                 model_dir=str(tmp_path))
    assert isinstance(model, native.ImportedModel)
    with pytest.raises(ModelNotFoundError):
        load_patch_model("keras_missing_cnn.hdf5", model_dir=str(tmp_path))


# -- the conv chains run as one epilogue (layers.ConvChain) ------------------

def _varied(spec, params, seed):
    """Non-trivial biases and BatchNorm statistics, negative scales among
    them (a max pool does not commute with those)."""
    rng = np.random.default_rng(seed)
    for e in spec["layers"]:
        name, w = e["name"], params.get(e["name"])
        if e["class_name"] == "Conv2D":
            w[1] = rng.normal(0, 0.1, w[1].shape).astype(np.float32)
        elif e["class_name"] == "BatchNormalization":
            c = w[0].shape[0]
            params[name] = [rng.uniform(-1.5, 1.5, c).astype(np.float32),
                            rng.normal(0, 0.1, c).astype(np.float32),
                            rng.normal(0, 0.1, c).astype(np.float32),
                            rng.uniform(0.5, 2.0, c).astype(np.float32)]
    return spec, params


def _unfused(monkeypatch, spec, params):
    with monkeypatch.context() as m:
        m.setattr(native, "_fuse_chains", lambda plan, mods, outputs: plan)
        return native.ImportedModel(spec, params)


def _chains(model):
    return {name: fn for name, fn, _, _ in model._steps
            if isinstance(fn, L.ConvChain)}


def _outputs_close(model, ref, x):
    with torch.no_grad():
        got, want = model(x), ref(x)
    for a, b in zip(*(v if isinstance(v, list) else [v]
                      for v in (got, want)), strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("nmel,nout,seed", CNNS)
def test_plan_fuses_every_block(nmel, nout, seed, monkeypatch):
    """The smn, sm and gender CNNs: four chains, each but the last writing
    the next conv's border; the fused forward within 1e-6 of the unfused
    one."""
    spec, params = _varied(*tsyn.build_patch_cnn(nmel, nout, seed, "small"),
                           seed)
    model = native.ImportedModel(spec, params)
    chains = _chains(model)
    assert model.fused_blocks == 4
    assert list(chains) == ["pool0", "pool1", "pool2", "pool3"]
    assert [c.padded_input for c in chains.values()] == [False, True, True,
                                                         True]
    assert [c.next_conv is not None for c in chains.values()] == [
        True, True, True, False]
    for c in chains.values():
        assert c.relu == [True, False] and c.bn is not None
    assert [c.pool for c in chains.values()] == [
        (2, 1, 2, 1), (2, 2, 2, 2), (2, 2, 2, 2), (2, 1, 2, 1)]
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (8, 68, nmel, 1)).astype(np.float32))
    _outputs_close(model, _unfused(monkeypatch, spec, params), x)


def test_trainable_model_fuses_nothing():
    spec, params = tsyn.build_patch_cnn(21, 3, 1, "small")
    model = native.ImportedModel(spec, params, trainable=True)
    assert model.fused_blocks == 0
    assert [n for n, *_ in model._steps] == [n for n, *_ in model._plan]
    assert all(bn.inv is None for bn in model.layers
               if isinstance(bn, L.BatchNorm))


def _second_reader(spec, params):
    spec["outputs"] = ["out", "conv1"]       # conv1's value read twice
    return "conv1", [True, False], None, None


def _bn_on_rows(spec, params):
    spec["layers"][7]["config"]["axis"] = 1  # bn2 over the 17 rows
    params["bn2"] = [p[:1].repeat(17) for p in params["bn2"]]
    return "conv2", [True, False], None, None


def _same_pool(spec, params):
    spec["layers"][11]["config"]["padding"] = "same"
    return "bn3", [True, False], "bn3", None


def _wide_pool(spec, params):
    cfg = spec["layers"][11]["config"]       # pool3: 8 rows -> 3, not 4
    cfg["pool_size"], cfg["strides"] = [4, 1], [2, 1]
    feat = params["fc1"][0].shape[0] * 3 // 4
    params["fc1"][0] = np.random.default_rng(0).standard_normal(
        (feat, params["fc1"][0].shape[1])).astype(np.float32) / feat ** .5
    return "bn3", [True, False], "bn3", None


@pytest.mark.parametrize("case", [_second_reader, _bn_on_rows, _same_pool,
                                  _wide_pool])
def test_plan_leaves_unfused(case, monkeypatch):
    """A chain stops before a step it may not take: a value with a second
    reader, a BatchNorm off the channel axis, a SAME max pool, a window
    the kernel is not built for.  What it took still fuses, the rest runs
    on the layers, and the forward holds the unfused one's within 1e-6."""
    spec, params = _varied(*tsyn.build_patch_cnn(21, 3, 1, "small"), 1)
    end, relu, bn, pool = case(spec, params)
    model = native.ImportedModel(spec, params)
    chains = _chains(model)
    assert model.fused_blocks == 4 and end in chains
    chain = chains[end]
    assert chain.relu == relu and chain.pool == pool
    assert (chain.bn is None) == (bn is None)
    assert chain.next_conv is None
    names = [n for n, *_ in model._steps]
    assert names[names.index(end) + 1] in ("bn1", "bn2", "pool3")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 68, 21, 1)).astype(np.float32))
    _outputs_close(model, _unfused(monkeypatch, spec, params), x)


def _conv_name(model, conv):
    return next(n for n, i, _, _ in model._plan if model.layers[i] is conv)


@pytest.mark.parametrize("tier", ["highest", "high", "bf16"])
def test_plain_epilogue_equals_unfused_layers_bit_for_bit(tier,
                                                          monkeypatch):
    """At each block's conv output of each tier (with a NaN, ties and
    zeros in it), the plain epilogue equals the Conv2D's activation, the
    BatchNorm and the MaxPool2D layers run one after another, then the
    next conv's F.pad, bit for bit, in channels-last (Keras) order."""
    monkeypatch.setenv("ISS_CNN_PRECISION", tier)
    spec, params = _varied(*tsyn.build_patch_cnn(24, 2, 2, "small"), 2)
    model = native.ImportedModel(spec, params)
    layer = {name: model.layers[i] for name, i, _, _ in model._plan}
    order = [name for name, *_ in model._plan]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (5, 68, 24, 1)).astype(np.float32))
    v = L.from_keras(x)
    with torch.no_grad():
        for name, run, _, _ in model._steps:
            fn = run if isinstance(run, L.ConvChain) else model.layers[run]
            if isinstance(fn, L.ConvChain):
                conv = fn.conv
                pads = conv.border(*v.shape[2:]) if not fn.padded_input \
                    else None
                xin = v if pads is None else F.pad(
                    v, (pads[2], pads[3], pads[0], pads[1]))
                y = conv.convolve(xin, bias=False)
                y[0, 0, 0, :3] = torch.tensor([float("nan"), 0.0, -0.0])
                y[1, 1, :2, 0] = y[1, 1, 2, 0]
                bn = fn.bn
                got = L.cnn_epilogue(y, conv.bias, tuple(fn.relu), (
                    bn.mean, bn.inv, bn.gamma, bn.beta), fn.pool,
                    fn.next_conv.border(*L.pooled_size(
                        *y.shape[2:], fn.pool)) if fn.next_conv else None)
                want = conv.act(y + conv.bias.reshape(1, -1, 1, 1))
                for step in order[order.index(_conv_name(model, conv)) + 1:
                                  order.index(name) + 1]:
                    want = layer[step](want)
                if fn.next_conv is not None:
                    b = fn.next_conv.border(*want.shape[2:])
                    want = F.pad(want, (b[2], b[3], b[0], b[1]))
                assert got.permute(0, 2, 3, 1).is_contiguous()
                assert got.shape == want.shape
                np.testing.assert_array_equal(got.numpy(), want.numpy())
                assert np.isnan(got[0, 0].numpy()).any()
            v = fn(v)


def test_inv_follows_the_module_and_flatten_is_a_view():
    """BatchNorm's ``inv`` is made again where the module moves and is not
    saved with the state; the last chain's channels-last output is Keras
    order, which Flatten reshapes without a copy."""
    spec, params = _varied(*tsyn.build_patch_cnn(21, 3, 1, "small"), 1)
    model = native.ImportedModel(spec, params)
    bn = model.layers[1]
    assert torch.equal(bn.inv, torch.rsqrt(bn.var + bn.eps))
    assert "1.inv" not in model.layers.state_dict()
    model.double()
    assert bn.inv.dtype == torch.float64
    assert torch.equal(bn.inv, torch.rsqrt(bn.var + bn.eps))
    with pytest.raises(ValueError, match="unsupported device"):
        L.cnn_epilogue(torch.empty(1, 1, 2, 2, device="meta"))
    y = torch.randn(2, 8, 8, 5)
    out = L.cnn_epilogue(y, pool=(2, 1, 2, 1))
    assert L.Flatten()(out).data_ptr() == out.data_ptr()


def test_chain_takes_the_kernels_pool_windows():
    """A chain takes a VALID max pool of a window the kernel is built for
    (``EPILOGUE_POOLS``, at any strides) and no other; the plain version
    takes any window."""
    conv = L.Conv2D({"padding": "same", "activation": "relu"},
                    torch.zeros(4, 1, 3, 3), torch.zeros(4), "highest")
    for window, strides, taken in (((2, 1), (2, 1), True),
                                   ((2, 2), (1, 1), True),
                                   ((3, 3), (3, 3), False),
                                   ((1, 2), (1, 2), False)):
        pool = L.MaxPool2D({"pool_size": window, "strides": strides})
        assert L.ConvChain.start(conv).take(pool) is taken
    y = torch.randn(2, 3, 9, 9)
    np.testing.assert_array_equal(
        L.cnn_epilogue(y, pool=(3, 3, 3, 3)).numpy(),
        F.max_pool2d(y, 3).numpy())
