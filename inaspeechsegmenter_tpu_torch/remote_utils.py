"""The reference's import path ``inaSpeechSegmenter.remote_utils``
(remote_utils.py:18-27): the model registry's ``get_remote``."""

from .models.registry import get_remote

__all__ = ["get_remote"]
