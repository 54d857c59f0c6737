"""PyTorch port: Keras hdf5 import and the layer vocabulary against JAX.

The port's ``read_h5`` (its own HDF5 reader) must return the JAX
``read_h5``'s (h5py) spec and bit-equal arrays on the hand-written legacy
and vintage Keras layouts of ``tests/test_keras_import.py`` and
``tests/test_vintage_formats.py`` (random weights here, no TensorFlow),
and the port's ``ImportedModel`` must match the JAX one within rtol 1e-4 /
atol 1e-5.  Every layer of the JAX ``LAYER_FNS`` / ``MERGE_FNS`` and every
activation runs through both within 1e-5.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu.models import keras_h5 as jk
from inaspeechsegmenter_tpu.models import layers as jl
from inaspeechsegmenter_tpu_torch.models import keras_h5 as tk
from inaspeechsegmenter_tpu_torch.models import layers as tl
from inaspeechsegmenter_tpu_torch.models.native import ImportedModel

h5py = pytest.importorskip("h5py")


def _write_legacy_h5(path, model_config, layer_weights):
    """Keras-2-era hdf5 (tests/test_keras_import.py:152-174)."""
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config).encode()
        f.attrs["keras_version"] = b"2.8.0"
        f.attrs["backend"] = b"tensorflow"
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = [n.encode() for n in layer_weights]
        for lname, wlist in layer_weights.items():
            g = mw.create_group(lname)
            g.attrs["weight_names"] = [wn.encode() for wn, _ in wlist]
            for wn, arr in wlist:
                node = g
                parts = wn.split("/")
                for p in parts[:-1]:
                    node = node.require_group(p)
                node.create_dataset(parts[-1], data=arr)
    return path


def _write_vintage_h5(path, model_config, weights, keras_version="2.1.6"):
    """2018 Keras layout (tests/test_vintage_formats.py:62-84)."""
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = np.bytes_(json.dumps(model_config))
        f.attrs["keras_version"] = np.bytes_(keras_version)
        f.attrs["backend"] = np.bytes_("tensorflow")
        g = f.create_group("model_weights")
        g.attrs["layer_names"] = np.array(
            [np.bytes_(n) for n in weights], dtype="S64")
        for lname, wlist in weights.items():
            lg = g.create_group(lname)
            wnames = [f"{lname}/{wn}:0" for wn, _ in wlist]
            lg.attrs["weight_names"] = np.array(
                [np.bytes_(n) for n in wnames], dtype="S96")
            for (wn, arr), full in zip(wlist, wnames):
                lg.create_dataset(full, data=np.asarray(arr, np.float32))
    return path


def _dense(name, units, activation, **extra):
    return {"class_name": "Dense", "config": dict(
        name=name, units=units, activation=activation, use_bias=True,
        **extra)}


def _conv(name, filters, kernel, activation, padding="valid", **extra):
    return {"class_name": "Conv2D", "config": dict(
        name=name, filters=filters, kernel_size=list(kernel),
        strides=[1, 1], padding=padding, data_format="channels_last",
        dilation_rate=[1, 1], activation=activation, use_bias=True, **extra)}


def _w(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# each fixture writes one file -> (path, forward input)
def fx_legacy_sequential(d, rng):
    cfg = {"class_name": "Sequential", "config": {"name": "seq", "layers": [
        _dense("d0", 4, "relu", batch_input_shape=[None, 5])]}}
    return _write_legacy_h5(d / "seq.hdf5", cfg, {
        "d0": [("d0/kernel:0", _w(rng, 5, 4)), ("d0/bias:0", _w(rng, 4))]
    }), _w(rng, 3, 5)


def _nested_cfg():
    inner = {"class_name": "Sequential", "config": {"name": "feat", "layers": [
        _dense("din", 5, "tanh", batch_input_shape=[None, 6])]}}
    return {"class_name": "Sequential", "config": {"name": "outer", "layers": [
        inner, _dense("dout", 2, "softmax")]}}


def fx_legacy_nested(d, rng):
    return _write_legacy_h5(d / "nested.hdf5", _nested_cfg(), {
        "feat": [("din/kernel:0", _w(rng, 6, 5)), ("din/bias:0", _w(rng, 5))],
        "dout": [("dout/kernel:0", _w(rng, 5, 2)),
                 ("dout/bias:0", _w(rng, 2))]}), _w(rng, 4, 6)


def fx_legacy_nested_prefixed(d, rng):
    return _write_legacy_h5(d / "prefixed.hdf5", _nested_cfg(), {
        "feat": [("feat/din/kernel:0", _w(rng, 6, 5)),
                 ("feat/din/bias:0", _w(rng, 5))],
        "dout": [("dout/kernel:0", _w(rng, 5, 2)),
                 ("dout/bias:0", _w(rng, 2))]}), _w(rng, 4, 6)


def fx_legacy_functional_nested(d, rng):
    inner = {"class_name": "Model", "config": {
        "name": "block",
        "layers": [
            {"class_name": "InputLayer", "name": "bin",
             "config": {"name": "bin", "batch_input_shape": [None, 3]},
             "inbound_nodes": []},
            dict(_dense("bd", 4, "relu"), name="bd",
                 inbound_nodes=[[["bin", 0, 0, {}]]])],
        "input_layers": ["bin", 0, 0], "output_layers": ["bd", 0, 0]}}
    cfg = {"class_name": "Model", "config": {
        "name": "top",
        "layers": [
            {"class_name": "InputLayer", "name": "x",
             "config": {"name": "x", "batch_input_shape": [None, 3]},
             "inbound_nodes": []},
            dict(inner, name="block", inbound_nodes=[[["x", 0, 0, {}]]]),
            dict(_dense("out", 2, "linear"), name="out",
                 inbound_nodes=[[["block", 0, 0, {}]]])],
        "input_layers": ["x", 0, 0], "output_layers": ["out", 0, 0]}}
    return _write_legacy_h5(d / "func_nested.hdf5", cfg, {
        "block": [("bd/kernel:0", _w(rng, 3, 4)), ("bd/bias:0", _w(rng, 4))],
        "out": [("out/kernel:0", _w(rng, 4, 2)), ("out/bias:0", _w(rng, 2))]
    }), _w(rng, 2, 3)


def fx_legacy_doubly_nested(d, rng):
    innermost = {"class_name": "Sequential", "config": {
        "name": "inner", "layers": [
            _dense("din", 5, "tanh", batch_input_shape=[None, 6])]}}
    mid = {"class_name": "Sequential", "config": {"name": "feat",
                                                  "layers": [innermost]}}
    cfg = {"class_name": "Sequential", "config": {"name": "outer", "layers": [
        mid, _dense("dout", 2, "linear")]}}
    return _write_legacy_h5(d / "deep.hdf5", cfg, {
        "feat": [("inner/din/kernel:0", _w(rng, 6, 5)),
                 ("inner/din/bias:0", _w(rng, 5))],
        "dout": [("dout/kernel:0", _w(rng, 5, 2)),
                 ("dout/bias:0", _w(rng, 2))]}), _w(rng, 3, 6)


def fx_keras21_sequential_list(d, rng):
    cfg = {"class_name": "Sequential", "config": [
        _conv("conv2d_1", 6, (5, 3), "relu",
              batch_input_shape=[None, 68, 21, 1], dtype="float32"),
        {"class_name": "MaxPooling2D", "config": {
            "name": "max_pooling2d_1", "pool_size": [2, 1],
            "padding": "valid", "strides": [2, 1]}},
        _conv("conv2d_2", 8, (3, 3), "relu"),
        {"class_name": "Flatten", "config": {"name": "flatten_1"}},
        _dense("dense_1", 16, "relu"), _dense("dense_2", 3, "softmax")]}
    return _write_vintage_h5(d / "keras21.h5", cfg, {
        "conv2d_1": [("kernel", _w(rng, 5, 3, 1, 6)), ("bias", _w(rng, 6))],
        "conv2d_2": [("kernel", _w(rng, 3, 3, 6, 8)), ("bias", _w(rng, 8))],
        "dense_1": [("kernel", _w(rng, 30 * 17 * 8, 16) * 0.05),
                    ("bias", _w(rng, 16))],
        "dense_2": [("kernel", _w(rng, 16, 3)), ("bias", _w(rng, 3))],
    }), _w(rng, 4, 68, 21, 1)


def fx_keras22_model_graph(d, rng):
    def node(name, cfg, inbound):
        return dict(cfg, name=name, inbound_nodes=[[[n, 0, 0, {}]
                                                     for n in inbound]])
    cfg = {"class_name": "Model", "config": {
        "name": "model_1",
        "layers": [
            {"class_name": "InputLayer", "name": "input_1",
             "config": {"batch_input_shape": [None, 12, 8, 1],
                        "dtype": "float32", "sparse": False,
                        "name": "input_1"}, "inbound_nodes": []},
            node("ma", _conv("ma", 4, (3, 3), "relu", "same"), ["input_1"]),
            node("mb", _conv("mb", 4, (1, 1), "linear", "same"), ["input_1"]),
            node("madd", {"class_name": "Add", "config": {"name": "madd"}},
                 ["ma", "mb"]),
            node("mflat", {"class_name": "Flatten",
                           "config": {"name": "mflat"}}, ["madd"]),
            node("mout", _dense("mout", 2, "softmax"), ["mflat"])],
        "input_layers": [["input_1", 0, 0]],
        "output_layers": [["mout", 0, 0]]}}
    return _write_vintage_h5(d / "keras22.h5", cfg, {
        "ma": [("kernel", _w(rng, 3, 3, 1, 4)), ("bias", _w(rng, 4))],
        "mb": [("kernel", _w(rng, 1, 1, 1, 4)), ("bias", _w(rng, 4))],
        "mout": [("kernel", _w(rng, 12 * 8 * 4, 2) * 0.1),
                 ("bias", _w(rng, 2))]}, "2.2.4"), _w(rng, 3, 12, 8, 1)


def fx_keras21_mlp_sigmoid(d, rng):
    cfg = {"class_name": "Sequential", "config": [
        _dense("dense_1", 64, "relu", batch_input_shape=[None, 256]),
        _dense("dense_2", 1, "sigmoid")]}
    return _write_vintage_h5(d / "mlp21.h5", cfg, {
        "dense_1": [("kernel", _w(rng, 256, 64) * 0.1),
                    ("bias", _w(rng, 64))],
        "dense_2": [("kernel", _w(rng, 64, 1) * 0.1), ("bias", _w(rng, 1))]
    }), _w(rng, 5, 256)


def fx_no_weight_names(d, rng):
    """No ``weight_names`` attrs: arrays collected by walking the group
    (name-sorted, then kernel/gamma first)."""
    cfg = {"class_name": "Sequential", "config": {"layers": [
        _conv("c", 3, (3, 3), "relu", "same",
              batch_input_shape=[None, 6, 5, 2]),
        {"class_name": "BatchNormalization", "config": {
            "name": "bn", "axis": -1, "epsilon": 1e-3}},
        {"class_name": "GlobalAveragePooling2D", "config": {"name": "g"}},
        _dense("d", 2, "softmax")]}}
    p = str(d / "noweightnames.h5")
    with h5py.File(p, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg)
        mw = f.create_group("model_weights")
        for lname, ws in {"c": {"kernel:0": _w(rng, 3, 3, 2, 3),
                                "bias:0": _w(rng, 3)},
                          "bn": {"gamma:0": _w(rng, 3), "beta:0": _w(rng, 3),
                                 "moving_mean:0": _w(rng, 3),
                                 "moving_variance:0": 1 + rng.random(3)
                                 .astype(np.float32)},
                          "d": {"kernel:0": _w(rng, 3, 2),
                                "bias:0": _w(rng, 2)}}.items():
            g = mw.create_group(f"{lname}/{lname}")
            for wn, arr in ws.items():
                g.create_dataset(wn, data=arr)
    return p, _w(rng, 2, 6, 5, 2)


def fx_latest_functional_concat(d, rng):
    """h5py ``libver="latest"`` (v2 object headers, link messages) and
    variable-length string attributes, a Concatenate / BatchNormalization
    graph."""
    def node(cfg, inbound):
        return dict(cfg, name=cfg["config"]["name"],
                    inbound_nodes=[[[n, 0, 0, {}] for n in inbound]])
    cfg = {"class_name": "Functional", "config": {
        "name": "f", "layers": [
            {"class_name": "InputLayer", "name": "in",
             "config": {"name": "in"}, "inbound_nodes": []},
            node(_conv("ca", 3, (3, 3), "relu", "same"), ["in"]),
            node(_conv("cb", 2, (1, 1), "linear", "same"), ["in"]),
            node({"class_name": "Concatenate",
                  "config": {"name": "cat", "axis": -1}}, ["ca", "cb"]),
            node({"class_name": "BatchNormalization", "config": {
                "name": "bn", "axis": 3, "epsilon": 1e-3}}, ["cat"]),
            node({"class_name": "GlobalMaxPooling2D",
                  "config": {"name": "gmp"}}, ["bn"]),
            node(_dense("out", 3, "softmax"), ["gmp"])],
        "input_layers": [["in", 0, 0]], "output_layers": [["out", 0, 0]]}}
    weights = {"ca": [("kernel", _w(rng, 3, 3, 2, 3)), ("bias", _w(rng, 3))],
               "cb": [("kernel", _w(rng, 1, 1, 2, 2)), ("bias", _w(rng, 2))],
               "bn": [("gamma", _w(rng, 5)), ("beta", _w(rng, 5)),
                      ("moving_mean", _w(rng, 5)),
                      ("moving_variance", 1 + rng.random(5).astype(
                          np.float32))],
               "out": [("kernel", _w(rng, 5, 3)), ("bias", _w(rng, 3))]}
    p = str(d / "latest.h5")
    with h5py.File(p, "w", libver="latest") as f:
        f.attrs["model_config"] = json.dumps(cfg)
        f.attrs["keras_version"] = "2.13.1"
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = list(weights)
        for lname, wl in weights.items():
            g = mw.create_group(lname)
            g.attrs["weight_names"] = [f"{lname}/{wn}:0" for wn, _ in wl]
            for wn, arr in wl:
                g.create_dataset(f"{lname}/{wn}:0", data=arr)
    return p, _w(rng, 2, 7, 6, 2)


FIXTURES = [fx_legacy_sequential, fx_legacy_nested, fx_legacy_nested_prefixed,
            fx_legacy_functional_nested, fx_legacy_doubly_nested,
            fx_keras21_sequential_list, fx_keras22_model_graph,
            fx_keras21_mlp_sigmoid, fx_no_weight_names,
            fx_latest_functional_concat]


@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda f: f.__name__[3:])
def test_read_h5_matches_jax(tmp_path, fixture):
    path, x = fixture(tmp_path, np.random.default_rng(11))
    spec_j, params_j = jk.read_h5(str(path))
    spec_t, params_t = tk.read_h5(str(path))
    assert spec_t == spec_j
    assert params_t.keys() == params_j.keys()
    for name in params_j:
        for a, b in zip(params_j[name], params_t[name], strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    want = np.asarray(jk.ImportedModel(spec_j, params_j)(x))
    with torch.no_grad():
        got = ImportedModel(spec_t, params_t)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_name_collision_and_shared_layer_raise(tmp_path):
    rng = np.random.default_rng(2)
    w, b = _w(rng, 4, 4), np.zeros(4, np.float32)
    inner = {"class_name": "Sequential", "config": {"name": "feat", "layers": [
        _dense("dense", 4, "relu", batch_input_shape=[None, 4])]}}
    cfg = {"class_name": "Sequential", "config": {"name": "outer", "layers": [
        inner, _dense("dense", 4, "linear")]}}
    p = _write_legacy_h5(tmp_path / "collide.hdf5", cfg, {
        "feat": [("dense/kernel:0", w), ("dense/bias:0", b)],
        "dense": [("dense/kernel:0", w), ("dense/bias:0", b)]})
    for read in (jk.read_h5, tk.read_h5):
        with pytest.raises(jk.KerasImportError if read is jk.read_h5
                           else tk.KerasImportError, match="collision"):
            read(str(p))
    shared = {"class_name": "Model", "config": {"name": "m", "layers": [
        {"class_name": "InputLayer", "name": "i", "config": {"name": "i"},
         "inbound_nodes": []},
        dict(_dense("d", 4, "relu"), name="d",
             inbound_nodes=[[["i", 0, 0, {}]], [["i", 0, 0, {}]]])],
        "input_layers": [["i", 0, 0]], "output_layers": [["d", 0, 0]]}}
    p = _write_legacy_h5(tmp_path / "shared.hdf5", shared, {
        "d": [("d/kernel:0", w), ("d/bias:0", b)]})
    with pytest.raises(tk.KerasImportError, match="shared layers"):
        tk.read_h5(str(p))
    with pytest.raises(jk.KerasImportError, match="shared layers"):
        jk.read_h5(str(p))


def test_native_roundtrip_bit_exact_across_packages(tmp_path):
    path, x = fx_keras22_model_graph(tmp_path, np.random.default_rng(4))
    model = ImportedModel.from_h5(str(path))
    npz = str(tmp_path / "m.npz")
    model.save_native(npz)
    again = ImportedModel.from_native(npz)
    with torch.no_grad():
        a = model(torch.from_numpy(x)).numpy()
        b = again(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(a, b)
    # the JAX package reads the port's checkpoint, and the other way round
    spec_j, params_j = jk.load_native(npz)
    assert spec_j == model.spec
    jnpz = str(tmp_path / "j.npz")
    jk.ImportedModel(spec_j, params_j).save_native(jnpz)
    spec_t, params_t = tk.load_native(jnpz)
    assert spec_t == spec_j
    for name, arrays in params_j.items():
        for u, v in zip(arrays, params_t[name], strict=True):
            np.testing.assert_array_equal(u, v)


def test_strip_final_softmax_matches_jax():
    spec = {"layers": [
        {"name": "d1", "class_name": "Dense", "config": {"activation": "relu"}},
        {"name": "att", "class_name": "Softmax", "config": {}},
        {"name": "out", "class_name": "Dense",
         "config": {"activation": "softmax"}}]}
    assert tk.strip_final_softmax(spec) == jk.strip_final_softmax(spec)
    spec["outputs"] = ["att"]
    assert tk.strip_final_softmax(spec) == jk.strip_final_softmax(spec)


# -- the layer vocabulary -----------------------------------------------------

def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


LAYER_CASES = {
    # id: (class, cfg, weight shapes, input shape)
    "Conv2D-same-dilated": ("Conv2D", dict(padding="same", strides=[1, 1],
                                           dilation_rate=[2, 1],
                                           activation="relu"),
                            [(3, 3, 3, 4), (4,)], (2, 9, 7, 3)),
    "Conv2D-valid-stride2": ("Conv2D", dict(padding="valid", strides=[2, 2]),
                             [(3, 2, 3, 4), (4,)], (2, 9, 8, 3)),
    "Conv2D-cin1": ("Conv2D", dict(padding="same", activation="tanh"),
                    [(3, 3, 1, 4), (4,)], (2, 8, 6, 1)),
    "DepthwiseConv2D": ("DepthwiseConv2D", dict(padding="same",
                                                strides=[2, 1]),
                        [(3, 3, 3, 2), (6,)], (2, 9, 7, 3)),
    "Conv1D-causal-dilated": ("Conv1D", dict(padding="causal",
                                             dilation_rate=2),
                              [(3, 2, 4), (4,)], (2, 11, 2)),
    "Conv1D-same-stride2": ("Conv1D", dict(padding="same", strides=[2],
                                           use_bias=False),
                            [(4, 2, 3)], (2, 11, 2)),
    "Dense": ("Dense", dict(activation="relu"), [(6, 5), (5,)], (3, 6)),
    "Dense-rank4": ("Dense", dict(activation="softmax"), [(3, 4), (4,)],
                    (2, 5, 6, 3)),
    "BatchNormalization": ("BatchNormalization",
                           dict(axis=-1, epsilon=1e-3),
                           "bn:4", (2, 5, 6, 4)),
    "BatchNormalization-noscale-rank2": ("BatchNormalization",
                                         dict(axis=[1], scale=False,
                                              epsilon=1e-2),
                                         "bn-noscale:4", (5, 4)),
    "MaxPooling2D-same": ("MaxPooling2D", dict(pool_size=[3, 3],
                                               strides=[2, 2],
                                               padding="same"),
                          [], (2, 9, 8, 3)),
    "AveragePooling2D-same": ("AveragePooling2D", dict(
        pool_size=[3, 2], strides=[2, 2], padding="same"), [], (2, 9, 7, 3)),
    "AveragePooling2D-valid": ("AveragePooling2D", dict(pool_size=2), [],
                               (2, 9, 7, 3)),
    "GlobalAveragePooling2D-keepdims": ("GlobalAveragePooling2D",
                                        dict(keepdims=True), [],
                                        (2, 5, 6, 3)),
    "GlobalMaxPooling2D": ("GlobalMaxPooling2D", {}, [], (2, 5, 6, 3)),
    "Flatten": ("Flatten", {}, [], (2, 3, 4, 5)),
    "Reshape": ("Reshape", dict(target_shape=[6, 5, 2]), [], (2, 3, 4, 5)),
    "Reshape-rank3": ("Reshape", dict(target_shape=[12, 5]), [],
                      (2, 3, 4, 5)),
    "Permute": ("Permute", dict(dims=[2, 3, 1]), [], (2, 3, 4, 5)),
    "ZeroPadding2D": ("ZeroPadding2D", dict(padding=[[1, 2], [0, 1]]), [],
                      (2, 3, 4, 5)),
    "ZeroPadding2D-int": ("ZeroPadding2D", dict(padding=1), [], (2, 3, 4, 5)),
    "ReLU": ("ReLU", dict(max_value=1.0, negative_slope=0.1, threshold=0.2),
             [], (2, 3, 4, 5)),
    "ReLU-max0": ("ReLU", dict(max_value=0.0), [], (3, 7)),
    "LeakyReLU": ("LeakyReLU", dict(alpha=0.2), [], (2, 3, 4, 5)),
    "Softmax-axis1": ("Softmax", dict(axis=1), [], (2, 3, 4, 5)),
    "Softmax": ("Softmax", {}, [], (2, 3, 4, 5)),
}
IDENTITIES = ["Dropout", "SpatialDropout1D", "SpatialDropout2D",
              "GaussianNoise", "GaussianDropout", "ActivityRegularization",
              "InputLayer"]


def _weights(kind, seed):
    if isinstance(kind, list):
        return _rng_arrays(seed, *kind)
    c = int(kind.split(":")[1])
    g, b, m = _rng_arrays(seed, (c,), (c,), (c,))
    v = 0.5 + np.random.default_rng(seed + 1).random(c).astype(np.float32)
    return [b, m, v] if kind.startswith("bn-noscale") else [g, b, m, v]


def _single_layer(cname, cfg, weights, x):
    spec = {"layers": [dict(name="l", class_name=cname,
                            config=dict(cfg, name="l"), inbound=[])],
            "inputs": None, "outputs": None}
    with torch.no_grad():
        return ImportedModel(spec, {"l": weights})(torch.from_numpy(x)) \
            .numpy()


@pytest.mark.parametrize("case", list(LAYER_CASES) + IDENTITIES)
def test_layer_matches_jax(case):
    cname, cfg, wkind, shape = LAYER_CASES.get(case, (case, {}, [],
                                                      (2, 3, 4, 5)))
    assert cname in jl.LAYER_FNS
    weights = _weights(wkind, seed=len(case))
    x = _rng_arrays(7, shape)[0]
    want = np.asarray(jl.LAYER_FNS[cname](
        cfg, [jnp.asarray(w) for w in weights], jnp.asarray(x)))
    got = _single_layer(cname, cfg, weights, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_every_jax_layer_is_covered():
    # Activation: test_activation_matches_jax
    covered = {c for c, *_ in LAYER_CASES.values()} | set(IDENTITIES) | {
        "Activation"}
    assert covered == set(jl.LAYER_FNS)
    assert set(tl.SUPPORTED) == set(jl.LAYER_FNS) | set(jl.MERGE_FNS)


@pytest.mark.parametrize("name", [n for n in tl.ACTIVATIONS if n])
def test_activation_matches_jax(name):
    x = _rng_arrays(3, (4, 7))[0] * 3
    want = np.asarray(jl._activation(name, jnp.asarray(x)))
    got = _single_layer("Activation", {"activation": name}, [], x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cname,cfg", [("Add", {}), ("Multiply", {}),
                                       ("Concatenate", {"axis": -1}),
                                       ("Concatenate", {"axis": 2})])
def test_merge_matches_jax(cname, cfg):
    xs = _rng_arrays(9, (2, 3, 4, 5), (2, 3, 4, 5), (2, 3, 4, 5))
    want = np.asarray(jl.MERGE_FNS[cname](cfg, [], [jnp.asarray(v)
                                                   for v in xs]))
    names = ["a", "b", "c"]
    spec = {"layers": [dict(name=n, class_name="InputLayer", config={},
                            inbound=[]) for n in names]
            + [dict(name="m", class_name=cname, config=cfg, inbound=names)],
            "inputs": names, "outputs": ["m"]}
    with torch.no_grad():
        got = ImportedModel(spec, {})([torch.from_numpy(v) for v in xs])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
