"""Keras hdf5 model import: hdf5 file -> (spec, params), without h5py.

Copy of the pure-Python part of ``inaspeechsegmenter_tpu/models/
keras_h5.py`` (the port imports nothing of the JAX package) over the
port's own HDF5 reader (``h5.py``): the ``model_config`` JSON (Sequential
and Functional graphs, Keras 2 and Keras 3 serialization formats, nested
models flattened) becomes a spec, and ``model_weights`` the Keras-layout
weight arrays.  ``read_h5`` returns what the JAX ``read_h5`` returns, with
bit-equal arrays.

The native checkpoint (``save_native`` / ``load_native``: the spec as JSON
plus a flat npz of the arrays) is the JAX package's format, so the two
packages read each other's converted models.  The module built from a
spec is ``native.ImportedModel``.
"""

from __future__ import annotations

import copy
import json

import numpy as np

from . import h5
from .h5 import KerasImportError

__all__ = ["KerasImportError", "spec_from_config", "read_h5",
           "strip_final_softmax", "save_native", "load_native"]


def _decode(v):
    return v.decode() if isinstance(v, bytes) else v


def _layer_entries(config):
    """Normalize model config -> list of layer dicts with inbound info.

    Returns list of dicts: {name, class_name, config, inbound: [names]}.
    For Sequential models inbound is the previous layer.
    """
    class_name = config["class_name"]
    inner = config["config"]
    entries = []
    if class_name == "Sequential":
        layers = inner["layers"] if isinstance(inner, dict) else inner
        prev = None
        for lay in layers:
            lcfg = lay["config"]
            name = lcfg.get("name") or lay.get("name")
            cname = lay["class_name"]
            if cname == "InputLayer":
                prev = None  # sequential input is implicit
                continue
            entries.append(dict(name=name, class_name=cname, config=lcfg,
                                inbound=[prev] if prev else []))
            prev = name
        return entries, None, None
    if class_name in ("Functional", "Model"):
        layers = inner["layers"]
        for lay in layers:
            lcfg = lay["config"]
            name = lay.get("name") or lcfg.get("name")
            inbound = _parse_inbound(lay.get("inbound_nodes", []))
            entries.append(dict(name=name, class_name=lay["class_name"],
                                config=lcfg, inbound=inbound))
        inputs = _parse_io(inner.get("input_layers"))
        outputs = _parse_io(inner.get("output_layers"))
        return entries, inputs, outputs
    raise KerasImportError(f"unsupported model class {class_name}")


def _parse_io(io_spec):
    if io_spec is None:
        return None
    # single-io models may store a flat [name, node_idx, tensor_idx]
    if (len(io_spec) == 3 and isinstance(io_spec[0], str)
            and all(isinstance(e, int) for e in io_spec[1:])):
        return [io_spec[0]]
    out = []
    for e in io_spec:
        if isinstance(e, dict):  # keras 3 keras_tensor format
            out.append(e["config"]["keras_history"][0])
        elif isinstance(e, str):
            out.append(e)
        else:  # [name, node_index, tensor_index]
            out.append(e[0])
    return out


def _parse_inbound(nodes):
    """Handle both Keras 2 ([[['name', 0, 0, {}]]]) and Keras 3
    ({args: [{__keras_tensor__...}]}) inbound node formats."""
    names = []
    if not nodes:
        return names
    if len(nodes) > 1:
        # a layer invoked more than once (shared layer) has one inbound
        # node per call; wiring only the first call would silently feed
        # every consumer the first application's output
        raise KerasImportError(
            "shared layers (a layer with %d inbound nodes) are not "
            "supported" % len(nodes))
    first = nodes[0]
    if isinstance(first, dict):  # keras 3
        def walk(obj):
            if isinstance(obj, dict):
                if obj.get("class_name") == "__keras_tensor__":
                    names.append(obj["config"]["keras_history"][0])
                else:
                    for v in obj.values():
                        walk(v)
            elif isinstance(obj, (list, tuple)):
                for v in obj:
                    walk(v)
        walk(first.get("args", []))
        walk(first.get("kwargs", {}))
    else:  # keras 2: list of nodes, node = list of [name, node_idx, tensor_idx, kwargs]
        for item in first:
            if isinstance(item, (list, tuple)) and item:
                names.append(item[0])
    return names


def _load_weight_arrays(h5file):
    """Extract {layer_name: [np arrays]} honoring stored weight order."""
    if "model_weights" in h5file:
        g = h5file["model_weights"]
    else:
        g = h5file  # weights-only file
    out = {}
    layer_names = [_decode(n) for n in g.attrs.get("layer_names", [])]
    if not layer_names:
        layer_names = list(g.keys())
    for lname in layer_names:
        if lname not in g:
            continue
        lg = g[lname]
        wnames = [_decode(n) for n in lg.attrs.get("weight_names", [])]
        arrays = []
        for wn in wnames:
            node = lg[wn] if wn in lg else None
            if node is None:
                # weight names are sometimes nested like 'dense/kernel:0'
                node = lg
                for part in wn.split("/"):
                    node = node[part]
            arrays.append(np.array(node))
        if not wnames:
            # fall back to recursive dataset collection; groups iterate
            # alphabetically ('bias:0' before 'kernel:0') while every
            # layer expects params[0] = kernel — order kernel/gamma first
            named = []

            def collect(node, acc):
                if isinstance(node, h5.Dataset):
                    acc.append((node.name, np.array(node)))
                else:
                    for k in node:
                        collect(node[k], acc)
            collect(lg, named)
            rank = {"kernel": 0, "gamma": 0, "depthwise_kernel": 0,
                    "bias": 1, "beta": 1, "moving_mean": 2,
                    "moving_variance": 3}

            def key(item):
                leaf = item[0].rsplit("/", 1)[-1].split(":")[0]
                return (rank.get(leaf, 9), item[0])
            arrays.extend(a for _, a in sorted(named, key=key))
        if arrays:
            out[lname] = arrays
            # nested Model/Sequential layers store one top-level group whose
            # weight_names are sub-layer paths ('inner_dense/kernel:0'); the
            # flattened graph looks sub-layers up by their own name — group
            # arrays by leading path segment so both resolve
            if wnames:
                by_sub = {}
                for wn, a in zip(wnames, arrays):
                    parts = wn.split("/")
                    # the graph layer that owns a weight is the LAST path
                    # component before the weight leaf ('kernel:0'), which
                    # handles relative ('inner_dense/kernel:0'), prefixed
                    # ('nested/inner_dense/kernel:0') and arbitrarily deep
                    # nesting ('nested/inner/dense/kernel:0') uniformly
                    if len(parts) >= 2:
                        by_sub.setdefault(parts[-2], []).append(a)
                for seg, arrs in by_sub.items():
                    if seg != lname:
                        out.setdefault(seg, arrs)
    return out


def _flatten_nested(entries):
    """Inline nested Model/Sequential/Functional layers (TF-2.x era models
    sometimes wrap a feature extractor as a sub-model).

    Supported shape: single-input single-output nested models.  The nested
    model's internal InputLayers become identity pass-throughs wired to the
    parent inbound; later references to the nested model's name are renamed
    to its output layer.

    Keras scopes layer names per model, so an inner layer may legally share
    a name with an outer layer (even one appearing AFTER the nested model in
    the config); flattening collapses the namespaces, so any such collision
    raises KerasImportError instead of silently merging weights/graph edges.
    """
    out = []
    rename = {}
    outer_names = {e["name"] for e in entries}

    def resolve(names):
        return [rename.get(n, n) for n in names]

    for e in entries:
        e = dict(e, inbound=resolve(e["inbound"]))
        if e["class_name"] not in ("Sequential", "Functional", "Model"):
            out.append(e)
            continue
        sub_entries, sub_in, sub_out = _layer_entries(
            {"class_name": e["class_name"], "config": e["config"]})
        sub_entries, sub_rename = _flatten_nested(sub_entries)
        if sub_out is not None and len(sub_out) != 1:
            raise KerasImportError(
                f"nested model {e['name']!r} has {len(sub_out)} outputs; "
                "only single-output nested models are supported")
        if sub_in is not None and len(sub_in) > 1:
            raise KerasImportError(
                f"nested model {e['name']!r} has {len(sub_in)} inputs; "
                "only single-input nested models are supported")
        # collision set: every outer layer name (even ones appearing after
        # this nested model — including the nested model's own name, whose
        # h5 weight group holds ALL sub-layer arrays and would shadow a
        # same-named sub-layer's weights) plus everything already emitted
        seen = outer_names | {x["name"] for x in out}
        parent_in = e["inbound"]
        for j, se in enumerate(sub_entries):
            if se["name"] in seen:
                raise KerasImportError(
                    f"name collision flattening nested model {e['name']!r}:"
                    f" {se['name']!r} already exists in the outer graph")
            se = dict(se)
            if se["class_name"] == "InputLayer":
                # identity pass-through bound to the parent's inbound
                se = dict(name=se["name"], class_name="Activation",
                          config={"activation": "linear"},
                          inbound=list(parent_in))
            elif j == 0 and not se["inbound"]:
                # sequential nested chain head
                se["inbound"] = list(parent_in)
            out.append(se)
        if not sub_entries:
            raise KerasImportError(
                f"nested model {e['name']!r} has no layers to flatten")
        last = sub_out[0] if sub_out else sub_entries[-1]["name"]
        rename[e["name"]] = sub_rename.get(last, last)
    return out, rename


def spec_from_config(config):
    """model_config (JSON string or decoded dict) -> spec dict.

    The config is untrusted input — it rides inside downloaded hdf5 files —
    so any structural surprise raises `KerasImportError` (a ValueError)
    instead of a raw KeyError/TypeError escaping from deep inside the
    walk."""
    try:
        if isinstance(config, (str, bytes)):
            config = json.loads(_decode(config))
        entries, inputs, outputs = _layer_entries(config)
        entries, rename = _flatten_nested(entries)
    except KerasImportError:
        raise
    except (KeyError, TypeError, IndexError, AttributeError, ValueError,
            RecursionError) as e:
        raise KerasImportError(f"malformed model config: {e!r}") from e
    if rename:
        inputs = [rename.get(n, n) for n in inputs] if inputs else inputs
        outputs = [rename.get(n, n) for n in outputs] if outputs else outputs
    return dict(layers=entries, inputs=inputs, outputs=outputs)


def read_h5(path):
    """Parse a Keras hdf5 file -> (spec dict, params dict)."""
    with h5.File(path) as f:
        raw = f.attrs.get("model_config")
        if raw is None:
            raise KerasImportError(f"{path}: no model_config attribute")
        try:
            weights = _load_weight_arrays(f)
        except (KeyError, TypeError, AttributeError) as exc:
            raise KerasImportError(
                f"{path}: malformed Keras weight layout ({exc!r})") from exc
    spec = spec_from_config(raw)
    params = {e["name"]: weights.get(e["name"], []) for e in spec["layers"]}
    return spec, params


def strip_final_softmax(spec):
    """Copy of spec with the model's OUTPUT softmax replaced by linear —
    yields a logits forward for training losses.  Only output layers are
    touched: an internal Softmax (attention/gating branch) is left alone,
    and a model whose output activation is not softmax is returned
    unchanged (a backwards scan would silently linearize the wrong
    layer)."""
    spec = copy.deepcopy(spec)
    layers = spec["layers"]
    by_name = {e["name"]: e for e in layers}
    outs = spec.get("outputs") or ([layers[-1]["name"]] if layers else [])
    for name in outs:
        e = by_name.get(name)
        if e is None:
            continue
        cfg = e["config"]
        if e["class_name"] == "Softmax":
            e["class_name"] = "Activation"
            cfg["activation"] = "linear"
        elif cfg.get("activation") == "softmax":
            cfg["activation"] = "linear"
    return spec


def save_native(path, spec, params):
    """Native checkpoint: spec as JSON + flat npz of weight arrays."""
    flat = {}
    for lname, arrays in params.items():
        for i, a in enumerate(arrays):
            flat[f"{lname}::{i}"] = np.asarray(a)
    np.savez(path, __spec__=np.frombuffer(
        json.dumps(spec).encode(), dtype=np.uint8), **flat)


def load_native(path):
    """-> (spec dict, {layer name: [numpy arrays]}) in Keras layout."""
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(bytes(z["__spec__"].tobytes()).decode())
        params = {}
        for key in z.files:
            if key == "__spec__":
                continue
            lname, idx = key.rsplit("::", 1)
            params.setdefault(lname, []).append((int(idx), z[key]))
    params = {k: [a for _, a in sorted(v)] for k, v in params.items()}
    return spec, params
