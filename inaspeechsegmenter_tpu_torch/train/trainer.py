"""Single-card training for the patch-CNN model family.

The PyTorch counterpart of ``inaspeechsegmenter_tpu/train/trainer.py``:
the same ``Trainer`` methods with the same semantics, on one device.  The
model is the logits form of the spec (``strip_final_softmax``), built as
an ``ImportedModel`` whose every array is a parameter: each weight and
bias and all four BatchNormalization arrays, the moving statistics
included, are differentiated and updated by Adam, as the JAX trainer's
``jax.value_and_grad`` over the whole parameter dict does (its layers read
the statistics from the parameters; dropout is the identity).
``torch.optim.Adam`` with its defaults is ``optax.adam``'s update.

Checkpoints are the JAX trainer's: ``leaf_%05d`` arrays in the leaf order
of ``(params, opt_state)``, that is the parameter arrays (layers by sorted
name, each layer's list in order, Keras layout), Adam's step count, then
the first and the second moments in the parameters' order, so a run
can move between the packages in either direction.

The data-parallel and tensor-parallel mesh of the JAX trainer waits for
the port's multi-GPU engine (``ROADMAP.md``); ``mesh`` must be None.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models import layers as L
from ..models.keras_h5 import save_native, strip_final_softmax
from ..models.native import ImportedModel, params_from_jax, params_to_jax
from ..utils.device import resolve_device


class Trainer:
    """Train a patch-CNN (or MLP) spec on labeled patches.

    :param spec: model spec (Keras-imported or synthetic).
    :param params: ``{layer name: [arrays]}`` in the Keras layout.
    :param mesh: must be None: the multi-GPU mesh is not ported yet.
    :param class_weight: optional (n_classes,) per-class loss weights
        (e.g. `train.data.class_weights` for imbalanced annotated
        corpora); None = unweighted.
    :param device: ``cuda`` by default (raises without a card).

    The whole step (forward, backward and the optimizer) runs inside one
    ``layers.precision_scope`` at the ``ISS_CNN_PRECISION`` tier, so the
    backward's convolutions and products take the forward's tier.
    """

    def __init__(self, spec, params, mesh=None, learning_rate=1e-3,
                 class_weight=None, *, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...) waits for the multi-GPU engine "
                "(ROADMAP.md section 1, item 8); the port trains on one "
                "device")
        self.device = resolve_device(device)
        self.spec = spec  # original (softmax kept): export_model ships it
        self.model = ImportedModel(strip_final_softmax(spec), params,
                                   trainable=True).to(self.device)
        self.precision = self.model.precision
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=learning_rate)
        self._cw = (None if class_weight is None else torch.as_tensor(
            np.asarray(class_weight, np.float32), device=self.device))

    @property
    def params(self):
        """The current parameters, ``{layer name: [arrays]}`` in the Keras
        layout (host numpy copies)."""
        return params_to_jax(self.model.spec, self.model.tensors())

    def _batch(self, x, y):
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        y = torch.as_tensor(np.asarray(y, np.int64), device=self.device)
        return x, y

    def loss(self, x, y):
        """The JAX trainer's loss on device tensors: ``mean(nll * cw[y])``
        (a plain mean, not one divided by the sum of the weights)."""
        logp = F.log_softmax(self.model(x), dim=-1)
        nll = -logp.gather(1, y[:, None])[:, 0]
        if self._cw is not None:
            nll = nll * self._cw[y]
        return nll.mean()

    def train_step(self, x, y):
        """One optimization step; returns the loss before it as a float."""
        x, y = self._batch(x, y)
        with L.precision_scope(self.precision):
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.loss(x, y)
            loss.backward()
            self.optimizer.step()
        return float(loss.detach())

    def fit(self, x, y, epochs=1, batch_size=None, shuffle_seed=0):
        """Minimal epoch loop over host arrays, as the JAX trainer's on a
        one-device mesh: the tail partial batch of each epoch is dropped
        (equal-shape steps), a batch_size larger than the dataset is
        clamped to the dataset, and the batch order is
        ``np.random.default_rng(shuffle_seed).permutation``.
        """
        n = len(x)
        if n == 0:
            return []
        x, y = np.asarray(x), np.asarray(y)
        batch_size = max(1, min(batch_size or n, n))
        rng = np.random.default_rng(shuffle_seed)
        losses = []
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = order[i:i + batch_size]
                losses.append(self.train_step(x[idx], y[idx]))
        return losses

    @torch.no_grad()
    def predict_proba(self, x):
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return F.softmax(self.model(x), dim=-1).cpu().numpy()

    def evaluate(self, x, y):
        """Top-1 accuracy on host arrays (held-out evaluation)."""
        return float((self.predict_proba(x).argmax(axis=1)
                      == np.asarray(y)).mean())

    def export_model(self, path):
        """Deploy the trained parameters as a registry-loadable native npz.

        Writes the ORIGINAL spec (softmax head kept: serving wants
        probabilities) with the current parameters in the Keras layout, in
        the native format ``models.registry.load_patch_model`` resolves, so
        a trained model serves when the file sits in the model directory
        under the registry stem.  The ``synthetic`` marker is replaced by
        ``trained``: the stand-in warning must not fire for weights that
        were fit to data.
        """
        from .. import __version__

        spec = dict(self.spec)
        spec.pop("synthetic", None)
        spec["trained"] = {"framework_version": __version__}
        save_native(path, spec, self.params)
        return path

    # -- checkpoint / resume: the JAX trainer's leaf layout -------------------

    @staticmethod
    def _ckpt_path(path):
        # np.savez appends '.npz' to extension-less paths but np.load does
        # not: normalize once so save/restore round-trip with one path
        return path if str(path).endswith(".npz") else str(path) + ".npz"

    def _moments(self):
        """(step count, first moments, second moments) in the
        ``tensors()`` form; zeros before the first step."""
        count, mu, nu = 0, {}, {}
        for name, ts in self.model.tensors().items():
            mu[name], nu[name] = [], []
            for t in ts:
                st = self.optimizer.state.get(t, {}) if t is not None else {}
                if st:
                    count = int(st["step"])
                zero = None if t is None else torch.zeros_like(t)
                mu[name].append(st.get("exp_avg", zero))
                nu[name].append(st.get("exp_avg_sq", zero))
        return count, mu, nu

    def _leaves(self):
        spec = self.model.spec
        count, mu, nu = self._moments()

        def flat(d):
            return [a for k in sorted(d) for a in d[k]]

        return (flat(self.params) + [np.asarray(count, np.int32)]
                + flat(params_to_jax(spec, mu))
                + flat(params_to_jax(spec, nu)))

    def save_checkpoint(self, path):
        np.savez(self._ckpt_path(path),
                 **{f"leaf_{i:05d}": a for i, a in enumerate(self._leaves())})

    def restore_checkpoint(self, path):
        path = self._ckpt_path(path)
        with np.load(path) as z:
            leaves = [z[k] for k in sorted(z.files)]
        own = self._leaves()
        if len(leaves) != len(own):
            raise ValueError(
                f"checkpoint {path} has {len(leaves)} arrays, model expects "
                f"{len(own)} — architecture mismatch")
        for i, (a, b) in enumerate(zip(own, leaves)):
            if np.shape(a) != np.shape(b):
                raise ValueError(
                    f"checkpoint {path} leaf {i} has shape {np.shape(b)}, "
                    f"model expects {np.shape(a)} — architecture mismatch")
        spec = self.model.spec
        layout = self.params
        names = sorted(layout)
        n = sum(len(layout[k]) for k in names)

        def unflat(flat):
            out, i = {}, 0
            for k in names:
                out[k] = flat[i:i + len(layout[k])]
                i += len(layout[k])
            return params_from_jax(spec, out)

        values = unflat(leaves[:n])
        count = int(leaves[n])
        mu, nu = unflat(leaves[n + 1:2 * n + 1]), unflat(leaves[2 * n + 1:])
        self.optimizer.state.clear()
        with torch.no_grad():
            for name, ts in self.model.tensors().items():
                for t, v, m, s in zip(ts, values[name], mu[name], nu[name]):
                    if t is None:
                        continue
                    t.copy_(v)
                    self.optimizer.state[t] = {
                        "step": torch.tensor(float(count)),
                        "exp_avg": m.to(t.device),
                        "exp_avg_sq": s.to(t.device)}
