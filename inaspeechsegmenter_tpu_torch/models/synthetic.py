"""Synthetic model factory (numpy only).

Copy of the weight generation in ``inaspeechsegmenter_tpu/models/
synthetic.py``: the released CNN weights cannot be fetched offline, so
tests and the chip smoke run on randomly initialized models of the
documented family — patch CNNs over (68, nmel, 1) log-mel patches with
softmax outputs — in the native checkpoint format.  For the same seed and
size the arrays are identical to the JAX package's, so both packages can
be driven on the same weights.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .native import save_native


def _conv(name, filters, kernel, activation="relu", strides=1):
    return dict(name=name, class_name="Conv2D",
                config=dict(name=name, filters=filters,
                            kernel_size=[kernel, kernel], strides=[strides, strides],
                            padding="same", activation=activation, use_bias=True),
                inbound=[])


def _bn(name):
    return dict(name=name, class_name="BatchNormalization",
                config=dict(name=name, axis=-1, epsilon=1e-3, center=True,
                            scale=True),
                inbound=[])


def _pool(name, pool):
    return dict(name=name, class_name="MaxPooling2D",
                config=dict(name=name, pool_size=list(pool), strides=list(pool),
                            padding="valid"),
                inbound=[])


def _dense(name, units, activation=None):
    return dict(name=name, class_name="Dense",
                config=dict(name=name, units=units, activation=activation,
                            use_bias=True),
                inbound=[])


def _flatten(name):
    return dict(name=name, class_name="Flatten",
                config=dict(name=name), inbound=[])


def _he(rng, shape, fan_in):
    return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)


_SIZES = {
    # filters per conv block; 'full' approximates the reference's ~15 MB CNNs,
    # 'small' keeps CPU tests fast
    "full": [32, 64, 128, 128],
    "small": [8, 16, 32, 32],
}


def build_patch_cnn(nmel, n_out, seed=0, size="full"):
    """Random patch CNN: (B, 68, nmel, 1) -> (B, n_out) softmax.

    4 conv+BN+pool blocks then 2 dense layers.
    """
    rng = np.random.default_rng(seed)
    layers = []
    params = {}
    cin = 1
    h, w = 68, nmel
    filters = _SIZES[size]
    for i, (filt, pool) in enumerate(zip(filters, [(2, 1), (2, 2),
                                                   (2, 2), (2, 1)])):
        cname = f"conv{i}"
        layers.append(_conv(cname, filt, 3))
        params[cname] = [_he(rng, (3, 3, cin, filt), 9 * cin),
                         np.zeros(filt, np.float32)]
        bname = f"bn{i}"
        layers.append(_bn(bname))
        params[bname] = [np.ones(filt, np.float32), np.zeros(filt, np.float32),
                         np.zeros(filt, np.float32), np.ones(filt, np.float32)]
        layers.append(_pool(f"pool{i}", pool))
        cin = filt
        h = h // pool[0]
        w = w // pool[1]
    layers.append(_flatten("flatten"))
    feat = h * w * cin
    layers.append(_dense("fc1", 256, "relu"))
    params["fc1"] = [_he(rng, (feat, 256), feat), np.zeros(256, np.float32)]
    layers.append(_dense("out", n_out, "softmax"))
    params["out"] = [_he(rng, (256, n_out), 256), np.zeros(n_out, np.float32)]

    spec = dict(layers=layers, inputs=None, outputs=None, synthetic=True)
    return spec, params


def build_gender_mlp(in_dim=256, hidden=128, seed=0):
    """Random femininity-scoring MLP: (B, 256) x-vectors -> (B, 1) sigmoid."""
    rng = np.random.default_rng(seed)
    layers = [_dense("fc1", hidden, "relu"), _dense("out", 1, "sigmoid")]
    params = {
        "fc1": [_he(rng, (in_dim, hidden), in_dim), np.zeros(hidden, np.float32)],
        "out": [_he(rng, (hidden, 1), hidden), np.zeros(1, np.float32)],
    }
    spec = dict(layers=layers, inputs=None, outputs=None, synthetic=True)
    return spec, params


# the JAX package's generation number: both write interchangeable sets
SYNTH_GENERATION = 2


def install_synthetic_models(directory, seed=0, size="full"):
    """Write the synthetic model set (native .npz) into `directory`: the
    three segmentation CNNs and the two VFS MLPs, as the JAX package does.

    A manifest records (seed, size, generation); any mismatch regenerates
    the whole set.
    """
    os.makedirs(directory, exist_ok=True)
    manifest_path = os.path.join(directory, "manifest.json")
    want = {"seed": seed, "size": size, "generation": SYNTH_GENERATION}
    try:
        with open(manifest_path) as fh:
            fresh = json.load(fh) == want
    except (OSError, ValueError):
        fresh = False
    todo = {
        "keras_speech_music_cnn": lambda: build_patch_cnn(21, 2, seed, size),
        "keras_speech_music_noise_cnn": lambda: build_patch_cnn(21, 3, seed + 1, size),
        "keras_male_female_cnn": lambda: build_patch_cnn(24, 2, seed + 2, size),
        "interspeech2023_all": lambda: build_gender_mlp(seed=seed + 3),
        "interspeech2023_cvfr": lambda: build_gender_mlp(seed=seed + 4),
    }
    for stem, fn in todo.items():
        path = os.path.join(directory, stem + ".npz")
        if not fresh or not os.path.exists(path):
            spec, params = fn()
            save_native(path, spec, params)
    with open(manifest_path, "w") as fh:
        json.dump(want, fh)
    return directory
