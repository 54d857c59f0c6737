"""The reference's import path ``inaSpeechSegmenter.export_funcs``
(export_funcs.py:29-39), which its tutorials import from."""

from .export import seg2csv, seg2textgrid

__all__ = ["seg2csv", "seg2textgrid"]
