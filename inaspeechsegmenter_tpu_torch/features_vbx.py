"""The reference's import path ``inaSpeechSegmenter.features_vbx``
(features_vbx.py:12-160): the numpy VBx feature functions under the
reference's names and parameter spellings (``dsp/vbx_host.py``,
``dsp/mel.py``).  The VFS pipeline computes these features on the device
(``dsp/vbx.py``)."""

from __future__ import annotations

from .dsp.mel import kaldi_mel_fbank as _kaldi_mel_fbank
from .dsp.mel import mel_inv_kaldi as mel_inv
from .dsp.mel import mel_kaldi as mel
from .dsp.vbx_host import (add_dither, cmvn_floating_kaldi, fbank_htk,
                           framing, povey_window, preemphasis)

__all__ = ["framing", "mel", "mel_inv", "preemphasis", "mel_fbank_mx",
           "fbank_htk", "povey_window", "add_dither", "cmvn_floating_kaldi"]


def mel_fbank_mx(winlen_nfft, fs, NUMCHANS=20, LOFREQ=0.0, HIFREQ=None,
                 warp_fn=mel, inv_warp_fn=mel_inv, htk_bug=True):
    """The reference signature over ``dsp.mel.kaldi_mel_fbank``; only the
    Kaldi mel warp is taken (the reference never passes another)."""
    if warp_fn is not mel or inv_warp_fn is not mel_inv:
        raise NotImplementedError("custom warp functions are not supported")
    return _kaldi_mel_fbank(winlen_nfft, fs, numchans=NUMCHANS,
                            lofreq=LOFREQ, hifreq=HIFREQ, htk_bug=htk_bug)
