"""Minimal model resolution from one directory.

Counterpart of ``load_patch_model`` / ``get_remote`` in
``inaspeechsegmenter_tpu/models/registry.py`` without their download and
hdf5 paths.  Files are read from ``model_dir`` or ``$ISS_TPU_MODEL_DIR``,
and a missing file raises:

- patch CNNs and the VFS MLPs: the native checkpoint ``<stem>.npz``;
- the x-vector ResNet: the first of ``raw_81.npz`` (the JAX package's
  ``save_resnet_npz`` format), ``raw_81.pth`` and ``final.onnx``.
"""

from __future__ import annotations

import os
import warnings

from .native import PatchCNN


XVECTOR_WEIGHTS = ("raw_81.npz", "raw_81.pth", "final.onnx")


class ModelNotFoundError(FileNotFoundError):
    pass


def _model_dir(what, model_dir):
    d = model_dir or os.environ.get("ISS_TPU_MODEL_DIR")
    if not d:
        raise ModelNotFoundError(
            f"no model directory for {what}: pass model_dir or set "
            "ISS_TPU_MODEL_DIR")
    return d


def resolve_xvector_weights(model_dir=None):
    """Path of the x-vector ResNet weights: the first of
    ``XVECTOR_WEIGHTS`` present in the model directory."""
    d = _model_dir("the x-vector weights", model_dir)
    for name in XVECTOR_WEIGHTS:
        path = os.path.join(d, name)
        if os.path.exists(path):
            return path
    raise ModelNotFoundError(
        f"no x-vector weights in {d} (looked for "
        f"{', '.join(XVECTOR_WEIGHTS)})")


def load_patch_model(model_fname, model_dir=None):
    """Load the patch CNN or MLP registered as ``model_fname`` (for
    instance ``keras_speech_music_noise_cnn.hdf5``) as a CPU
    ``PatchCNN``."""
    d = _model_dir(model_fname, model_dir)
    path = os.path.join(d, os.path.splitext(model_fname)[0] + ".npz")
    if not os.path.exists(path):
        raise ModelNotFoundError(f"model {model_fname} not found: no {path}")
    model = PatchCNN.from_native(path)
    if model.spec.get("synthetic"):
        warnings.warn(
            f"loading SYNTHETIC random-weight stand-in {path} for "
            f"{model_fname}: outputs are not meaningful segmentations",
            stacklevel=2)
    return model
