"""PyTorch port: synthetic weights and the patch CNN against the JAX model.

The port's numpy weight builder must give arrays identical to the JAX
package's for the same seed and size; the forward pass built through
``ImportedModel`` must match the JAX ``ImportedModel`` within atol 1e-5
(float32 convolutions summed in another order).
"""

import os

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu.models import synthetic as jsyn
from inaspeechsegmenter_tpu.models.keras_h5 import ImportedModel
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
