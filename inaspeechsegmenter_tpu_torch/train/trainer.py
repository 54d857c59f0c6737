"""Training for the patch-CNN model family, on one device or a mesh.

The PyTorch counterpart of ``inaspeechsegmenter_tpu/train/trainer.py``:
the same ``Trainer`` methods with the same semantics.  The model is the
logits form of the spec (``strip_final_softmax``), built as an
``ImportedModel`` whose every array is a parameter: each weight and bias
and all four BatchNormalization arrays, the moving statistics included,
are differentiated and updated by Adam, as the JAX trainer's
``jax.value_and_grad`` over the whole parameter dict does (its layers read
the statistics from the parameters; dropout is the identity).
``torch.optim.Adam`` with its defaults is ``optax.adam``'s update.

On a ``(data, model)`` mesh (``parallel.mesh.make_2d_mesh``) the step is
the JAX trainer's sharded step done slot by slot:

- data row i holds its own replica of the model on its first device and
  runs the forward and the backward on its slice of the batch, with the
  loss ``sum(nll * cw[y]) / B``, B the whole batch, so the rows' losses
  and gradients sum to the one-device ones;
- a Dense kernel that ``param_shardings`` splits (>= 512 input rows, its
  columns a multiple of the model axis) holds column block j on the
  row's slot j; the blocks' outputs are gathered before the next layer;
- the rows' gradients are summed into row 0's parameters, one Adam update
  runs there (the split kernels' blocks and moments on their own slots),
  and every other row copies the result, so all replicas hold the same
  parameters after each step.

Rows run one after the other from the calling thread; their launches are
asynchronous, so rows on separate cards overlap.

Checkpoints are the JAX trainer's, gathered whatever the mesh:
``leaf_%05d`` arrays in the leaf order of ``(params, opt_state)``, that
is the parameter arrays (layers by sorted name, each layer's list in
order, Keras layout), Adam's step count, then the first and the second
moments in the parameters' order, so a run can move between meshes and
between the packages in either direction.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models import layers as L
from ..models.keras_h5 import save_native, strip_final_softmax
from ..models.native import ImportedModel, params_from_jax, params_to_jax
from ..parallel.mesh import make_2d_mesh, make_mesh, replicate, shard_batch


def param_shardings(mesh, params, model_axis="model"):
    """The JAX ``param_shardings`` as partition tuples: ``(None,
    model_axis)`` for a 2-D kernel (Keras layout) with >= 512 rows whose
    column count divides by the model axis, ``()`` (replicated) for every
    other array; ``{layer name: [tuple per array]}``."""
    m = mesh.shape[model_axis]

    def shard_of(a):
        a = np.asarray(a)
        if a.ndim == 2 and a.shape[0] >= 512 and a.shape[1] % m == 0:
            return (None, model_axis)
        return ()

    return {k: [shard_of(a) for a in v] for k, v in params.items()}


class ColumnSplitDense(nn.Module):
    """A Dense layer whose kernel columns (output units) are split into
    one block per model slot, block j on ``devices[j]``.  The bias stays
    whole on ``devices[0]`` (replicated, as in the JAX sharding); block j
    adds its slice of it, and the blocks' outputs are gathered on
    ``devices[0]`` before the activation.

    :param dense: the ``layers.Dense`` (trainable) to split.
    """

    def __init__(self, dense, devices):
        super().__init__()
        self.act, self.tier = dense.act, dense.tier
        self.shards = nn.ParameterList(
            nn.Parameter(w.detach().clone().to(d))
            for w, d in zip(dense.weight.chunk(len(devices)), devices))
        self.bias = dense.bias

    def forward(self, x):
        x = L.to_keras(x)
        outs, col = [], 0
        for w in self.shards:
            b = None
            if self.bias is not None:
                b = self.bias[col:col + w.shape[0]].to(w.device)
            col += w.shape[0]
            w16 = w.to(torch.bfloat16) if self.tier == "bf16" else None
            outs.append(L.tiered_product(F.linear, x.to(w.device), w, b, w16,
                                         -1).to(x.device))
        return self.act(L.from_keras(torch.cat(outs, -1)))


class Trainer:
    """Train a patch-CNN (or MLP) spec on labeled patches.

    :param spec: model spec (Keras-imported or synthetic).
    :param params: ``{layer name: [arrays]}`` in the Keras layout.
    :param mesh: a (data, model) ``Mesh`` (``parallel.mesh.make_2d_mesh``;
        its slots may repeat a device).  None trains on ``device`` alone,
        the 1 x 1 mesh there.  The JAX trainer's default is every device
        on the data axis; the port keeps the one-device trainer, so a
        caller asks for several GPUs explicitly (on one card the two
        agree).
    :param class_weight: optional (n_classes,) per-class loss weights
        (e.g. `train.data.class_weights` for imbalanced annotated
        corpora); None = unweighted.
    :param device: ``cuda`` by default (raises without a card); unused
        with a mesh.

    The whole step (every row's forward and backward, the gradient sum and
    the optimizer) runs inside one ``layers.precision_scope`` at the
    ``ISS_CNN_PRECISION`` tier, so the backward's convolutions and products
    take the forward's tier.
    """

    def __init__(self, spec, params, mesh=None, learning_rate=1e-3,
                 class_weight=None, *, device="cuda"):
        if mesh is None:
            mesh = make_2d_mesh(1, 1, devices=[device])
        self.mesh = mesh
        self.device = mesh.devices[0, 0]
        self.spec = spec  # original (softmax kept): export_model ships it
        self._data_n = int(mesh.shape["data"])
        model = ImportedModel(strip_final_softmax(spec), params,
                              trainable=True)
        self.precision = model.precision
        self._split = {}                 # layer name -> index in .layers
        if mesh.shape["model"] > 1:
            shard = param_shardings(mesh, model.params)
            for name, index, _, _ in model._plan:
                if (index is not None
                        and isinstance(model.layers[index], L.Dense)
                        and shard.get(name, [()])[0]):
                    self._split[name] = index
        self.replicas = replicate(
            make_mesh(devices=mesh.axis_devices("data")), model)
        for rep, row in zip(self.replicas, mesh.devices):
            for index in self._split.values():
                rep.layers[index] = ColumnSplitDense(rep.layers[index], row)
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=learning_rate)
        self._cw = (None if class_weight is None else torch.as_tensor(
            np.asarray(class_weight, np.float32)))

    @property
    def model(self):
        """Data row 0's replica: the one the optimizer updates."""
        return self.replicas[0]

    def _pieces(self, model):
        """``{layer name: [[pieces] per array]}`` of ``model``'s
        ``tensors()``: one piece per array, a split kernel's column
        blocks (dim 0 of the (out, in) weight) in order."""
        out = {k: [[t] for t in ts] for k, ts in model.tensors().items()}
        for name, index in self._split.items():
            layer = model.layers[index]
            out[name] = [list(layer.shards), [layer.bias]]
        return out

    def _gathered(self, pick=lambda t: t):
        """``{layer name: [tensor or None]}`` of row 0, split kernels
        gathered on the mesh's first device; ``pick`` maps each piece
        (e.g. to its Adam moment)."""
        return {k: [None if ps[0] is None else
                    torch.cat([pick(p).detach().to(self.device)
                               for p in ps])
                    for ps in arrays]
                for k, arrays in self._pieces(self.model).items()}

    @property
    def params(self):
        """The current parameters, ``{layer name: [arrays]}`` in the Keras
        layout (host numpy copies, split kernels gathered)."""
        return params_to_jax(self.model.spec, self._gathered())

    def _batch(self, x, y):
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        y = torch.as_tensor(np.asarray(y, np.int64), device=self.device)
        return x, y

    def loss(self, x, y, model=None, total=None):
        """The JAX trainer's loss on device tensors: ``mean(nll * cw[y])``
        (a plain mean, not one divided by the sum of the weights); with
        ``total``, one data row's part of it, ``sum(nll * cw[y]) /
        total``."""
        model = self.model if model is None else model
        logp = F.log_softmax(model(x), dim=-1)
        nll = -logp.gather(1, y[:, None])[:, 0]
        if self._cw is not None:
            nll = nll * self._cw.to(y.device)[y]
        return nll.mean() if total is None else nll.sum() / total

    def shard_batch(self, x, y):
        """(x, y) host arrays -> one (x, y) tensor pair per data row, on
        the row's device."""
        x = np.asarray(x, np.float32)
        if x.shape[0] % self._data_n:
            raise ValueError(
                f"batch size {x.shape[0]} is not divisible by the mesh "
                f"data axis ({self._data_n}); use fit(), which rounds the "
                "batch size to a mesh-divisible value")
        return list(zip(shard_batch(self.mesh, x),
                        shard_batch(self.mesh, np.asarray(y, np.int64))))

    def train_step(self, x, y):
        """One optimization step; returns the loss before it as a float."""
        parts = self.shard_batch(x, y)
        total = None if self._data_n == 1 else len(x)
        with L.precision_scope(self.precision):
            losses = []
            for rep, (xs, ys) in zip(self.replicas, parts):
                rep.zero_grad(set_to_none=True)
                loss = self.loss(xs, ys, rep, total)
                loss.backward()
                losses.append(loss.detach().to(self.device))
            owners = list(self.model.parameters())
            for rep in self.replicas[1:]:
                for p, q in zip(owners, rep.parameters()):
                    p.grad += q.grad.to(p.device)
            self.optimizer.step()
            with torch.no_grad():
                for rep in self.replicas[1:]:
                    for p, q in zip(owners, rep.parameters()):
                        q.copy_(p)
        return float(sum(losses))

    def fit(self, x, y, epochs=1, batch_size=None, shuffle_seed=0):
        """Minimal epoch loop over host arrays, as the JAX trainer's: the
        tail partial batch of each epoch is dropped (equal-shape steps), a
        batch_size larger than the dataset is clamped to the dataset, the
        batch size is rounded down to a multiple of the mesh data axis (a
        dataset smaller than that axis is tiled up to it), and the batch
        order is ``np.random.default_rng(shuffle_seed).permutation``.
        """
        n = len(x)
        if n == 0:
            return []
        x, y = np.asarray(x), np.asarray(y)
        d = self._data_n
        if n < d:
            reps = -(-d // n)
            x = np.concatenate([x] * reps)[:d]
            y = np.concatenate([y] * reps)[:d]
            n = d
        batch_size = min(batch_size or n, n)
        batch_size = max(d, batch_size - batch_size % d)
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
        ``tensors()`` form, split kernels gathered; zeros before the first
        step."""
        state = self.optimizer.state
        count = max([int(st["step"]) for st in state.values() if st],
                    default=0)

        def moment(key):
            return lambda t: state[t][key] if state.get(t) else \
                torch.zeros_like(t)

        return (count, self._gathered(moment("exp_avg")),
                self._gathered(moment("exp_avg_sq")))

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
        pieces = self._pieces(self.model)
        with torch.no_grad():
            for name, arrays in pieces.items():
                for ps, v, m, s in zip(arrays, values[name], mu[name],
                                       nu[name]):
                    if ps[0] is None:
                        continue
                    sizes = [p.shape[0] for p in ps]
                    for p, vp, mp, sp in zip(ps, v.split(sizes),
                                             m.split(sizes), s.split(sizes)):
                        p.copy_(vp)
                        self.optimizer.state[p] = {
                            "step": torch.tensor(float(count)),
                            "exp_avg": mp.to(p.device),
                            "exp_avg_sq": sp.to(p.device)}
            owners = list(self.model.parameters())
            for rep in self.replicas[1:]:
                for p, q in zip(owners, rep.parameters()):
                    q.copy_(p)
