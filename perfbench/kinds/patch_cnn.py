"""``patch_cnn``: inaSpeechSegmenter's Keras patch CNNs on (68, nmel)
log-mel patches: [Conv2D(relu), BatchNormalization, MaxPooling2D] a
block, Flatten, Dense(relu), Dense(softmax)."""

from __future__ import annotations

from perfbench.weights import keras_count, keras_layer, keras_params

TINY = {"filters": [8, 16, 32, 32], "dense": 32}


def layers(m):
    """-> (Keras layer list, [(name, "conv" | "bn" | "dense", shape)])."""
    out, shapes = [], []
    cin, h, w = 1, 68, m["nmel"]
    k = m["kernel"]
    for i, (f, pool) in enumerate(zip(m["filters"], m["pools"])):
        out.append(keras_layer(f"conv{i}", "Conv2D", filters=f,
                               kernel_size=[k, k], strides=[1, 1],
                               padding="same", activation="relu",
                               use_bias=True))
        shapes.append((f"conv{i}", "conv", (k, k, cin, f)))
        out.append(keras_layer(f"bn{i}", "BatchNormalization", axis=-1,
                               epsilon=m["bn_epsilon"], center=True,
                               scale=True))
        shapes.append((f"bn{i}", "bn", f))
        out.append(keras_layer(f"pool{i}", "MaxPooling2D",
                               pool_size=list(pool), strides=list(pool),
                               padding="valid"))
        cin, h, w = f, h // pool[0], w // pool[1]
    out.append(keras_layer("flatten", "Flatten"))
    out += [keras_layer("fc1", "Dense", units=m["dense"], activation="relu",
                        use_bias=True),
            keras_layer("out", "Dense", units=m["n_out"],
                        activation="softmax", use_bias=True)]
    shapes += [("fc1", "dense", (h * w * cin, m["dense"])),
               ("out", "dense", (m["dense"], m["n_out"]))]
    return out, shapes


def draws(m):
    return keras_count(layers(m)[1])


def draw(m, d):
    lay, shapes = layers(m)
    return {"layers": lay, "torch": keras_params(shapes, d, m)}
