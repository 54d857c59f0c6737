"""``mlp``: the femininity scorer's Keras MLP, Dense(relu) of ``hidden``
units on ``in`` inputs, then Dense(sigmoid) of one."""

from __future__ import annotations

from perfbench.weights import keras_count, keras_layer, keras_params

TINY = {}


def layers(m):
    """-> (Keras layer list, [(name, "dense", shape)])."""
    out = [keras_layer("fc1", "Dense", units=m["hidden"], activation="relu",
                       use_bias=True),
           keras_layer("out", "Dense", units=1, activation="sigmoid",
                       use_bias=True)]
    return out, [("fc1", "dense", (m["in"], m["hidden"])),
                 ("out", "dense", (m["hidden"], 1))]


def draws(m):
    return keras_count(layers(m)[1])


def draw(m, d):
    lay, shapes = layers(m)
    return {"layers": lay, "torch": keras_params(shapes, d, m)}
