"""The reference's import path ``inaSpeechSegmenter.io`` (reference
io.py:32-79): media decoding, ``media2sig16kmono``."""

from .audio.io import media2sig16kmono

__all__ = ["media2sig16kmono"]
