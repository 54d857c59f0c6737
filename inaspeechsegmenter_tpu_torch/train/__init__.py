"""Training on the port: labeled patch datasets and a single-card
``Trainer`` (``inaspeechsegmenter_tpu/train`` on PyTorch)."""

from .data import ENGINES, class_weights, patch_dataset
from .trainer import Trainer

__all__ = ["Trainer", "patch_dataset", "class_weights", "ENGINES"]
