"""Seconds of WAV decode (``Segmenter.timers['decode']``, a host span
around the reader in ``audio/io.py``) a hour of audio completed in the
traced window."""


def read(ctx):
    if ctx["decode_s"] is None or not ctx["audio_s"]:
        return None
    return ctx["decode_s"] / (ctx["audio_s"] / 3600.0)
