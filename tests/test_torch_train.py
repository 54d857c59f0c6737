"""PyTorch port: ``train.Trainer`` against the JAX package's ``Trainer``
(one-device mesh) on the same seeded batches and weights.

Adam's first update is about ``lr * sign(g)``, so a gradient component at
float noise can take the other sign in the other package and the
parameters part after a few steps; parity is therefore held on what does
not amplify:

- the gradients of one batch against ``jax.grad`` of the JAX loss,
  ``mean(nll * cw[y])``, every array included (the BatchNormalization
  moving statistics too): within 1e-5 of each array's largest magnitude;
- loss trajectories of ``fit`` (and across checkpoints): rtol 2e-4;
- checkpoints: the JAX leaf layout, read and written bit for bit;
- exported models: probabilities within 1e-5 through both registries.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu.models.keras_h5 import (build_forward,
                                                    strip_final_softmax)
from inaspeechsegmenter_tpu.models.synthetic import build_gender_mlp
from inaspeechsegmenter_tpu.parallel.mesh import make_2d_mesh
from inaspeechsegmenter_tpu.train import Trainer as JaxTrainer
from inaspeechsegmenter_tpu_torch.models import layers as L
from inaspeechsegmenter_tpu_torch.models.native import (ImportedModel,
                                                        params_to_jax)
from inaspeechsegmenter_tpu_torch.models.synthetic import build_patch_cnn
from inaspeechsegmenter_tpu_torch.train import Trainer

GRAD_RTOL = 1e-5
LOSS_RTOL = 2e-4
PROBA_ATOL = 1e-5


def batch(n=16, nmel=21, n_classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 68, nmel, 1)).astype(np.float32)
    y = rng.integers(0, n_classes, n).astype(np.int32)
    return x, y


def mesh1():
    return make_2d_mesh(data=1, model=1)


def port_grads(trainer, x, y):
    xt, yt = trainer._batch(x, y)
    trainer.loss(xt, yt).backward()
    return params_to_jax(trainer.model.spec, {
        k: [None if t is None else t.grad for t in ts]
        for k, ts in trainer.model.tensors().items()})


def jax_grads(spec, params, x, y, cw):
    fwd = build_forward(strip_final_softmax(spec))

    def loss_fn(p):
        logp = jax.nn.log_softmax(fwd(p, jnp.asarray(x)), axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                   axis=-1)[:, 0]
        if cw is not None:
            nll = nll * jnp.asarray(cw)[y]
        return jnp.mean(nll)

    return jax.jit(jax.grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params))


@pytest.mark.parametrize("cw", [None, [0.5, 1.0, 2.0]])
def test_gradients_match_jax_grad(cw):
    spec, params = build_patch_cnn(21, 3, seed=0, size="small")
    x, y = batch()
    got = port_grads(Trainer(spec, params, class_weight=cw, device="cpu"),
                     x, y)
    want = jax_grads(spec, params, x, y, cw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        for g, w in zip(got[k], want[k]):
            w = np.asarray(w)
            assert g.shape == w.shape, k
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=GRAD_RTOL * np.abs(w).max())


def test_weighted_loss_is_a_plain_mean():
    """``mean(nll * cw[y])``, not ``F.cross_entropy(weight=cw)``'s
    division by ``sum(cw[y])``."""
    spec, params = build_patch_cnn(21, 3, seed=0, size="small")
    x, y = batch()
    cw = np.array([0.5, 1.0, 3.0], np.float32)
    t = Trainer(spec, params, learning_rate=0.0, class_weight=cw,
                device="cpu")
    xt, yt = t._batch(x, y)
    with torch.no_grad():
        logits = t.model(xt)
        nll = torch.nn.functional.cross_entropy(logits, yt, reduction="none")
        want = float((nll * torch.from_numpy(cw)[yt]).mean())
        plain = float(t.loss(xt, yt))
    assert plain == pytest.approx(want, rel=1e-6)
    assert t.train_step(x, y) == pytest.approx(plain, rel=1e-6)
    jt = JaxTrainer(spec, params, mesh=mesh1(), learning_rate=0.0,
                    class_weight=cw)
    assert jt.train_step(x, y) == pytest.approx(plain, rel=1e-5)


def test_batchnorm_statistics_are_trained():
    """Every BatchNormalization array, the moving mean and variance
    included, gets a nonzero update, as in the JAX trainer."""
    spec, params = build_patch_cnn(21, 3, seed=0, size="small")
    x, y = batch()
    t = Trainer(spec, params, device="cpu")
    jt = JaxTrainer(spec, params, mesh=mesh1())
    n_params = sum(len(v) for v in params.values())
    assert len(list(t.model.parameters())) == n_params == 28
    t.train_step(x, y)
    jt.train_step(x, y)
    for i in range(4):
        for j in range(4):          # gamma, beta, mean, var
            before = params[f"bn{i}"][j]
            moved = np.abs(t.params[f"bn{i}"][j] - before)
            assert moved.max() > 0, (i, j)
            jmoved = np.abs(np.asarray(jt.params[f"bn{i}"][j]) - before)
            assert jmoved.max() > 0, (i, j)
            # Adam's first update: lr per element where the gradient is
            # not noise, in both packages
            assert np.median(moved) == pytest.approx(1e-3, rel=1e-2)


@pytest.mark.parametrize("epochs,batch_size,seed,cw", [
    (3, 8, 1, None), (2, None, 0, None), (2, 6, 3, [1.0, 2.0, 0.5]),
    (1, 100, 2, None)])
def test_fit_loss_trajectory_matches_jax(epochs, batch_size, seed, cw):
    spec, params = build_patch_cnn(21, 3, seed=0, size="small")
    x, y = batch(n=16, seed=seed)
    kw = dict(learning_rate=1e-3, class_weight=cw)
    got = Trainer(spec, params, device="cpu", **kw).fit(
        x, y, epochs=epochs, batch_size=batch_size, shuffle_seed=seed)
    want = JaxTrainer(spec, params, mesh=mesh1(), **kw).fit(
        x, y, epochs=epochs, batch_size=batch_size, shuffle_seed=seed)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert Trainer(spec, params, device="cpu").fit(x[:0], y[:0]) == []


def test_fit_mlp_and_predict_match_jax():
    spec, params = build_gender_mlp(in_dim=16, hidden=32, seed=1)
    spec["layers"][-1]["config"]["units"] = 2
    params["out"] = [np.random.default_rng(0).standard_normal(
        (32, 2)).astype(np.float32) * 0.1, np.zeros(2, np.float32)]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    t = Trainer(spec, params, learning_rate=1e-2, device="cpu")
    jt = JaxTrainer(spec, params, mesh=mesh1(), learning_rate=1e-2)
    got = t.fit(x, y, epochs=5, batch_size=32)
    np.testing.assert_allclose(got, jt.fit(x, y, epochs=5, batch_size=32),
                               rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    np.testing.assert_allclose(t.predict_proba(x), jt.predict_proba(x),
                               atol=1e-4)
    assert t.evaluate(x, y) > 0.8


def _leaves(path):
    with np.load(path) as z:
        return [z[k] for k in sorted(z.files)]


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, first):
    """k steps in one package -> save -> restore in the other -> k steps,
    against 2k steps in the first; the restored state re-saves bit for
    bit."""
    spec, params = build_patch_cnn(21, 3, seed=0, size="small")
    x, y = batch()
    k = 2
    make = {"jax": lambda p: JaxTrainer(spec, p, mesh=mesh1()),
            "port": lambda p: Trainer(spec, p, device="cpu")}
    other = "port" if first == "jax" else "jax"
    a = make[first](params)
    for _ in range(k):
        a.train_step(x, y)
    ckpt = str(tmp_path / "a")                     # extension-less
    a.save_checkpoint(ckpt)
    leaves = _leaves(ckpt + ".npz")
    assert len(leaves) == 85 and leaves[28].shape == ()
    assert int(leaves[28]) == k
    assert [x_.shape for x_ in leaves[:28]] == \
        [x_.shape for x_ in leaves[29:57]] == [x_.shape for x_ in leaves[57:]]
    want = [a.train_step(x, y) for _ in range(k)]

    b = make[other](build_patch_cnn(21, 3, seed=9, size="small")[1])
    b.restore_checkpoint(ckpt)
    b.save_checkpoint(str(tmp_path / "b.npz"))
    for u, v in zip(leaves, _leaves(str(tmp_path / "b.npz"))):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)
    got = [b.train_step(x, y) for _ in range(k)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("wrong", [(24, 2), (21, 2)])
def test_restore_rejects_another_architecture(tmp_path, wrong):
    spec, params = build_patch_cnn(21, 3, seed=0, size="small")
    t = Trainer(spec, params, device="cpu")
    ckpt = str(tmp_path / "c.npz")
    t.save_checkpoint(ckpt)
    c = Trainer(*build_patch_cnn(*wrong, seed=0, size="small"), device="cpu")
    with pytest.raises(ValueError, match="architecture mismatch"):
        c.restore_checkpoint(ckpt)
    mlp = Trainer(*build_gender_mlp(in_dim=8, hidden=4), device="cpu")
    with pytest.raises(ValueError, match="has 85 arrays, model expects 13"):
        mlp.restore_checkpoint(ckpt)


def test_export_model_serves_in_both_registries(tmp_path, monkeypatch):
    from inaspeechsegmenter_tpu.models.registry import (
        load_patch_model as jax_load)
    from inaspeechsegmenter_tpu_torch.models.registry import load_patch_model

    spec, params = build_patch_cnn(21, 3, seed=0, size="small")
    x, y = batch()
    t = Trainer(spec, params, device="cpu")
    t.fit(x, y, epochs=2, batch_size=8)
    name = "keras_speech_music_noise_cnn"
    assert t.export_model(str(tmp_path / (name + ".npz"))).endswith(".npz")
    monkeypatch.setenv("ISS_TPU_MODEL_DIR", str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no SYNTHETIC warning
        port = load_patch_model(name + ".hdf5", str(tmp_path), False)
        ref = jax_load(name + ".hdf5", allow_download=False)
    assert "synthetic" not in port.spec and "trained" in port.spec
    assert port.spec["layers"] == spec["layers"]
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref(jnp.asarray(x))),
                               atol=PROBA_ATOL)
    np.testing.assert_allclose(got, t.predict_proba(x), atol=1e-6)


def test_bf16_step_uses_the_updated_weight(monkeypatch):
    """At the bf16 tier the weight's bf16 cast follows the optimizer:
    after a step the trainer's forward equals an inference model's built
    from the updated parameters."""
    monkeypatch.setenv("ISS_CNN_PRECISION", "bf16")
    spec, params = build_patch_cnn(21, 3, seed=0, size="small")
    x, y = batch()
    t = Trainer(spec, params, learning_rate=1e-2, device="cpu")
    assert t.precision == "bf16"
    t.train_step(x, y)
    fresh = ImportedModel(strip_final_softmax(spec), t.params)
    stale = ImportedModel(strip_final_softmax(spec), params)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got, want, old = t.model(xt), fresh(xt), stale(xt)
    assert torch.equal(got, want)
    assert not torch.equal(got, old)


def test_whole_step_runs_in_the_precision_scope(monkeypatch):
    """Backward and the optimizer run under the tier's TF32 flags (off at
    ``highest``), not the process's, which PyTorch leaves on for cuDNN."""
    spec, params = build_patch_cnn(21, 3, seed=0, size="small")
    t = Trainer(spec, params, device="cpu")
    seen = []

    def flags(*_):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     L._FLAGS_LOCK._is_owned()))

    t.model.layers[0].weight.register_hook(flags)
    step = t.optimizer.step
    monkeypatch.setattr(t.optimizer, "step",
                        lambda *a, **k: (flags(), step(*a, **k))[1])
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    t.train_step(*batch())
    assert seen == [(False, False, True)] * 2
    assert torch.backends.cudnn.allow_tf32


def test_mesh_and_missing_card_raise():
    """``mesh=`` takes a port mesh (tests/test_torch_train_mesh.py holds
    its steps against the JAX mesh trainer); with no card the default
    device and the default mesh raise."""
    from inaspeechsegmenter_tpu_torch.parallel import make_2d_mesh as port_2d

    spec, params = build_patch_cnn(21, 3, seed=0, size="small")
    t = Trainer(spec, params, port_2d(2, 1, devices=["cpu"] * 2))
    assert t.mesh.shape == {"data": 2, "model": 1} and len(t.replicas) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(spec, params)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(spec, params, port_2d())
    with pytest.raises(TypeError):
        Trainer(spec, params, None, 1e-3, None, "cpu")


LAYOUTS = {
    "conv2d": ("Conv2D", {"use_bias": True}, [(3, 2, 4, 5), (5,)]),
    "depthwise": ("DepthwiseConv2D", {"depth_multiplier": 2,
                                      "use_bias": False}, [(3, 3, 4, 2)]),
    "conv1d": ("Conv1D", {}, [(3, 5, 6), (6,)]),
    "dense": ("Dense", {"use_bias": False}, [(6, 4)]),
    "bn_no_scale": ("BatchNormalization", {"scale": False}, [(8,)] * 3),
    "bn_no_center": ("BatchNormalization", {"center": False}, [(8,)] * 3),
    "flatten": ("Flatten", {}, []),
}


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_params_to_jax_inverts_params_from_jax(kind):
    """Keras layout -> the port's tensors -> Keras layout, bit for bit, with
    the JAX list lengths (no entry for a disabled bias, scale or center)."""
    from inaspeechsegmenter_tpu_torch.models.native import params_from_jax

    cname, cfg, shapes = LAYOUTS[kind]
    spec = {"layers": [{"name": "l", "class_name": cname, "config": cfg}]}
    rng = np.random.default_rng(0)
    params = {"l": [rng.standard_normal(s).astype(np.float32)
                    for s in shapes]}
    back = params_to_jax(spec, params_from_jax(spec, params))
    assert sorted(back) == (["l"] if shapes else [])
    for got, want in zip(back.get("l", []), params["l"]):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert len(back.get("l", [])) == len(shapes)
