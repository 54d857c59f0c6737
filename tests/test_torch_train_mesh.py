"""PyTorch port: the ``Trainer`` on a (data, model) mesh of repeated CPU
slots, against the port's one-device trainer and the JAX ``Trainer`` on
the JAX ``make_2d_mesh(data=4, model=2)`` of its 8 virtual CPU devices.

The mesh step is the one-device step reassociated: each data row's loss is
``sum(nll * cw[y]) / B`` of its slice, the rows' gradients are summed, one
Adam update runs, and the split ``fc1`` kernel's column blocks are gathered
before the next layer.  So the 4 x 2 trainer's losses stay within 1e-6
relative of the one-device trainer's and its parameters within 1e-5 of
their largest magnitude after a short ``fit``.  Against the JAX package
the first three losses agree within 1e-5 relative at a learning rate of
1e-4: Adam's first update is about ``lr * sign(g)``, so a gradient
component at float noise that takes the other sign in the other package
moves the next loss by O(lr) (tests/test_torch_train.py, whose
trajectories compare at rtol 2e-4).
"""

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu.models.synthetic import build_gender_mlp
from inaspeechsegmenter_tpu.parallel.mesh import make_2d_mesh as jax_2d
from inaspeechsegmenter_tpu.train import Trainer as JaxTrainer
from inaspeechsegmenter_tpu.train.trainer import (
    param_shardings as jax_param_shardings)
from inaspeechsegmenter_tpu_torch.models.synthetic import build_patch_cnn
from inaspeechsegmenter_tpu_torch.parallel import make_2d_mesh
from inaspeechsegmenter_tpu_torch.train import Trainer
from inaspeechsegmenter_tpu_torch.train.trainer import (ColumnSplitDense,
                                                        param_shardings)


def mesh(data, model):
    return make_2d_mesh(data, model, devices=["cpu"] * (data * model))


def batch(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 68, 21, 1)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int32)
    return x, y


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))


@pytest.fixture(scope="module")
def cnn():
    return build_patch_cnn(21, 3, seed=0, size="small")


def test_param_shardings_pick_the_jax_leaves(cnn):
    spec, params = cnn
    want = jax_param_shardings(jax_2d(4, 2), params)
    got = param_shardings(mesh(4, 2), params)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == [tuple(s.spec) for s in want[k]], k
    rows = params["fc1"][0].shape[0]
    assert rows >= 512 and got["fc1"][0] == (None, "model")
    assert got["out"][0] == ()                  # 256 rows: replicated
    t = Trainer(spec, params, mesh(4, 2))
    assert set(t._split) == {"fc1"}
    for rep, row in zip(t.replicas, t.mesh.devices):
        layer = rep.layers[t._split["fc1"]]
        assert isinstance(layer, ColumnSplitDense)
        assert [tuple(w.shape) for w in layer.shards] == [(128, rows)] * 2
        assert [w.device for w in layer.shards] == list(row)


def test_4x2_losses_match_jax_4x2(cnn):
    spec, params = cnn
    x, y = batch(64, seed=1)
    t = Trainer(spec, params, mesh(4, 2), learning_rate=1e-4)
    jt = JaxTrainer(spec, params, mesh=jax_2d(4, 2), learning_rate=1e-4)
    got = [t.train_step(x, y) for _ in range(3)]
    want = [jt.train_step(x, y) for _ in range(3)]
    assert rel(got, want).max() <= 1e-5, (got, want)
    # an Adam step moves a parameter by about lr: a component whose
    # gradient sign differs between the packages parts by 2 lr a step
    for k, arrays in jt.params.items():
        for a, b in zip(t.params[k], arrays):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(
                b).max() + 2 * 1e-4 * 3)


@pytest.mark.parametrize("shape", [(4, 2), (2, 1), (1, 2), (8, 1)])
def test_mesh_step_is_the_one_device_step(cnn, shape):
    spec, params = cnn
    x, y = batch()
    one = Trainer(spec, params, device="cpu")
    t = Trainer(spec, params, mesh(*shape))
    want = one.fit(x, y, epochs=2, batch_size=16)
    got = t.fit(x, y, epochs=2, batch_size=16)
    assert len(got) == len(want) == 4
    assert rel(got, want).max() <= 1e-6
    pw, pg = one.params, t.params
    for k in pw:
        for a, b in zip(pg[k], pw[k]):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
    # every replica holds row 0's parameters after each step
    owners = [p.detach() for p in t.model.parameters()]
    for rep in t.replicas[1:]:
        for p, q in zip(owners, rep.parameters()):
            assert torch.equal(p, q.detach())


def test_class_weights_on_the_mesh(cnn):
    spec, params = cnn
    x, y = batch(seed=2)
    cw = [0.5, 1.0, 2.0]
    one = Trainer(spec, params, class_weight=cw, device="cpu")
    t = Trainer(spec, params, mesh(4, 2), class_weight=cw)
    got = [t.train_step(x, y) for _ in range(2)]
    want = [one.train_step(x, y) for _ in range(2)]
    assert rel(got, want).max() <= 1e-6


def test_fit_rounding_tiling_and_shard_batch():
    """The JAX test_fit_batch_not_divisible_by_mesh on both packages:
    equal step counts."""
    spec, params = build_gender_mlp(in_dim=8, hidden=16, seed=0)
    spec["layers"][-1]["config"]["units"] = 2
    rngp = np.random.default_rng(0)
    params["out"] = [rngp.standard_normal((16, 2)).astype(np.float32) * 0.1,
                     np.zeros(2, np.float32)]
    t = Trainer(spec, params, mesh(4, 1))
    jt = JaxTrainer(spec, params, mesh=jax_2d(4, 1))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((10, 8)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    for kw in ({"epochs": 2}, {"epochs": 1, "batch_size": 6}):
        got, want = t.fit(x, y, **kw), jt.fit(x, y, **kw)
        assert len(got) == len(want) > 0 and np.isfinite(got).all()
    assert len(t.fit(x, y, epochs=1, batch_size=6)) == 2   # 6 -> 4
    got, want = t.fit(x[:3], y[:3], epochs=1), jt.fit(x[:3], y[:3], epochs=1)
    assert len(got) == len(want) == 1                       # tiled to 4
    with pytest.raises(ValueError, match="not divisible"):
        t.shard_batch(x, y)
    with pytest.raises(ValueError, match="not divisible"):
        jt.shard_batch(x, y)


def test_checkpoint_crosses_meshes_and_packages(cnn, tmp_path):
    """A checkpoint written on 4 x 2 (split kernel gathered, the JAX leaf
    layout) restores on the one-device trainer and in the JAX package, and
    the next step agrees; written on one device, it restores on 4 x 2."""
    spec, params = cnn
    x, y = batch(seed=3)
    t = Trainer(spec, params, mesh(4, 2), learning_rate=1e-4)
    t.train_step(x, y)
    t.train_step(x, y)
    ckpt = str(tmp_path / "mesh")
    t.save_checkpoint(ckpt)
    with np.load(ckpt + ".npz") as z:
        n_leaves = len(z.files)
    assert n_leaves == 3 * 28 + 1
    expected = t.train_step(x, y)

    one = Trainer(spec, build_patch_cnn(21, 3, seed=9, size="small")[1],
                  learning_rate=1e-4, device="cpu")
    one.restore_checkpoint(ckpt)
    assert one.train_step(x, y) == pytest.approx(expected, rel=1e-6)
    jt = JaxTrainer(spec, params, mesh=jax_2d(1, 1), learning_rate=1e-4)
    jt.restore_checkpoint(ckpt)
    assert jt.train_step(x, y) == pytest.approx(expected, rel=1e-5)

    one.save_checkpoint(str(tmp_path / "one.npz"))
    back = Trainer(spec, params, mesh(4, 2), learning_rate=1e-4)
    back.restore_checkpoint(str(tmp_path / "one.npz"))
    for k, arrays in one.params.items():
        for a, b in zip(back.params[k], arrays):
            np.testing.assert_array_equal(a, b)
    assert back.train_step(x, y) == pytest.approx(one.train_step(x, y),
                                                  rel=1e-6)


def test_mesh_trainer_exports_and_predicts(cnn, tmp_path):
    from inaspeechsegmenter_tpu_torch.models.registry import load_patch_model

    spec, params = cnn
    x, y = batch(seed=4)
    t = Trainer(spec, params, mesh(2, 2))
    t.fit(x, y, epochs=1, batch_size=16)
    probs = t.predict_proba(x[:4])
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    assert 0.0 <= t.evaluate(x, y) <= 1.0
    path = str(tmp_path / "keras_speech_music_noise_cnn.npz")
    t.export_model(path)
    served = load_patch_model("keras_speech_music_noise_cnn.hdf5",
                              str(tmp_path))
    with torch.no_grad():
        got = served(torch.from_numpy(x[:4])).numpy()
    np.testing.assert_allclose(got, probs, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (8, 1)])
def test_mesh_gradients_are_the_one_device_gradients(cnn, shape, tmp_path):
    """From one state (the one-device checkpoint restored on the mesh),
    the summed gradients of row 0 (the split kernel's blocks gathered)
    equal the one-device gradients within 1e-5 of each array's largest
    magnitude (1.3e-6 seen: sums over 8 rows added, against one over 32),
    and the losses within 1e-6 relative."""
    spec, params = cnn
    one = Trainer(spec, params, device="cpu")
    t = Trainer(spec, params, mesh(*shape))
    ckpt = str(tmp_path / "one.npz")
    for seed in range(2):
        x, y = batch(seed=10 + seed)
        one.save_checkpoint(ckpt)
        t.restore_checkpoint(ckpt)
        got, want = t.train_step(x, y), one.train_step(x, y)
        assert got == pytest.approx(want, rel=1e-6)
        g_mesh = t._gathered(lambda p: p.grad)
        for k, arrays in one._gathered(lambda p: p.grad).items():
            for g, h in zip(arrays, g_mesh[k]):
                if g is not None:
                    torch.testing.assert_close(
                        h, g, rtol=0,
                        atol=1e-5 * float(g.abs().max()) + 1e-12)
