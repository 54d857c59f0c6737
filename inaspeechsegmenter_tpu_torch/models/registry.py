"""Minimal model resolution: native ``.npz`` checkpoints from one directory.

Counterpart of ``load_patch_model`` in ``inaspeechsegmenter_tpu/models/
registry.py`` without its download and hdf5 paths: the checkpoint
``<stem>.npz`` is read from ``model_dir`` or ``$ISS_TPU_MODEL_DIR``, and a
missing file raises.
"""

from __future__ import annotations

import os
import warnings

from .native import PatchCNN


class ModelNotFoundError(FileNotFoundError):
    pass


def load_patch_model(model_fname, model_dir=None):
    """Load the patch CNN registered as ``model_fname`` (for instance
    ``keras_speech_music_noise_cnn.hdf5``) as a CPU ``PatchCNN``."""
    d = model_dir or os.environ.get("ISS_TPU_MODEL_DIR")
    if not d:
        raise ModelNotFoundError(
            f"no model directory for {model_fname}: pass model_dir or set "
            "ISS_TPU_MODEL_DIR")
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
