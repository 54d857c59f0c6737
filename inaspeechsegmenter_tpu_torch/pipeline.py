"""Segmentation pipeline after the features, on one device.

Port of the fused path of ``inaspeechsegmenter_tpu/pipeline.py``
(``FusedPipeline._run_impl``):

    loge  -> energy threshold -> 2-state Viterbi (10 ms) -> 20 ms decimation
    mspec -> per-frame normalized 68-row patches -> VAD CNN
          -> VAD Viterbi with a reset at every energy-segment boundary
          -> gender CNN + gender Viterbi on the speech frames
    -> one (n20,) int32 label-id sequence

Per-frame semantics are the reference's: the CNNs only influence frames of
their input label, a non-finite patch gives p=0.5, and no Viterbi crosses a
segment boundary.  Unlike the JAX program, nothing is padded to a length
bucket: the decodes run on exactly the file's frames (the JAX program's
padding frames sit behind a reset and cannot reach real frames).  The CNN
runs only on the frames its Viterbi reads, in batches of ``CNN_CHUNK``
patches, so memory stays bounded on hour-long files.

The streaming path (``chunk_emissions`` / ``stream_decode``) is not ported
yet; its labels equal the fused program's.
"""

from __future__ import annotations

import numpy as np
import torch

from .decode.transitions import diag_trans_exp, log_trans_exp
from .decode.viterbi import viterbi_scan
from .dsp.patches import frame_patches

CNN_CHUNK = 1024  # patches per CNN batch
EPS = 1e-10


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class FusedPipeline:
    """Device constants and the decode for one engine configuration.

    :param vad: (model, nmel, n_out, viterbi_arg) for the VAD CNN.
    :param gender: same tuple for the gender CNN, or None.
    """

    def __init__(self, vad, gender=None, energy_ratio=0.03, device="cpu"):
        self.device = torch.device(device)
        self.vad_model, self.vad_nmel, self.vad_nout, vad_arg = vad
        self.gender = gender
        if gender is not None:
            self.g_model, self.g_nmel, self.g_nout, g_arg = gender
            self.g_trans = _f32(diag_trans_exp(g_arg, self.g_nout),
                                self.device)
            self.g_init = _f32(np.full(self.g_nout, np.log(1.0 / self.g_nout)),
                               self.device)
        self.log_ratio = torch.log(torch.tensor(energy_ratio,
                                                dtype=torch.float32))
        self.e_trans = _f32(log_trans_exp(150, cost0=-5), self.device)
        self.e_init = _f32(np.log([0.5, 0.5]), self.device)
        self.v_trans = _f32(diag_trans_exp(vad_arg, self.vad_nout),
                            self.device)
        self.v_init = _f32(np.full(self.vad_nout, np.log(1.0 / self.vad_nout)),
                           self.device)
        em_log = np.log([EPS, 1 - EPS]).astype(np.float32)
        self.e_em = _f32([[em_log[1], em_log[0]], [em_log[0], em_log[1]]],
                         self.device)   # row 0: inactive, row 1: active

    def _energy_states20(self, loge):
        """(T,) log-energy -> (ceil(T/2),) bool 20 ms energy activity."""
        finite = torch.isfinite(loge)
        cnt = finite.sum().clamp(min=1).to(torch.float32)
        mean = torch.where(finite, loge, torch.zeros_like(loge)).sum() / cnt
        thr = mean + self.log_ratio.to(loge.device)
        act = loge > thr
        em = self.e_em[act.long()]
        reset = torch.zeros(loge.shape[0], dtype=torch.bool,
                            device=loge.device)
        reset[0] = True
        states = viterbi_scan(em.contiguous(), self.e_trans, self.e_init,
                              reset)
        return states[::2] == 1

    @torch.no_grad()
    def _cnn_probs(self, model, mspec, n_frames_patch, nmel, nout, inmask):
        """CNN probabilities of the frames in ``inmask``; 0.5 elsewhere and
        for non-finite patches."""
        probs = torch.full((inmask.shape[0], nout), 0.5, dtype=torch.float32,
                           device=mspec.device)
        frames = torch.nonzero(inmask).flatten()
        for b0 in range(0, frames.shape[0], CNN_CHUNK):
            idx = frames[b0:b0 + CNN_CHUNK]
            patches, fin = frame_patches(mspec, idx, n_frames_patch, nmel)
            p = model(patches[..., None])
            probs[idx] = torch.where(fin[:, None], p, torch.full_like(p, 0.5))
        return probs

    def _masked_viterbi(self, probs, inmask, trans, init):
        em = torch.where(inmask[:, None], torch.log(probs),
                         torch.zeros_like(probs))
        reset = torch.ones_like(inmask)
        reset[1:] = inmask[1:] != inmask[:-1]
        return viterbi_scan(em.contiguous(), trans, init, reset)

    def run(self, mspec, loge, n_frames, n_frames_patch, n20):
        """Label ids (n20,) int32 on the device: 0 = noEnergy, then the VAD
        outlabels, then the gender outlabels.

        :param mspec: (>= n_frames_patch, >= nmel) log-mel rows.
        :param loge: (>= n_frames,) log-energy.
        """
        energy20 = self._energy_states20(loge[:n_frames])[:n20]
        probs_v = self._cnn_probs(self.vad_model, mspec, n_frames_patch,
                                  self.vad_nmel, self.vad_nout, energy20)
        states_v = self._masked_viterbi(probs_v, energy20, self.v_trans,
                                        self.v_init)
        labels = torch.where(energy20, states_v + 1,
                             torch.zeros_like(states_v)).to(torch.int32)
        if self.gender is not None:
            speech20 = labels == 1   # outlabels[0] == 'speech' for sm and smn
            probs_g = self._cnn_probs(self.g_model, mspec, n_frames_patch,
                                      self.g_nmel, self.g_nout, speech20)
            states_g = self._masked_viterbi(probs_g, speech20, self.g_trans,
                                            self.g_init)
            labels = torch.where(speech20, states_g + 1 + self.vad_nout,
                                 labels).to(torch.int32)
        return labels


def rle(labels):
    """Run-length encode an int label array -> [(label, start, stop)]."""
    labels = np.asarray(labels)
    if len(labels) == 0:
        return []
    change = np.flatnonzero(np.diff(labels)) + 1
    bounds = np.concatenate([[0], change, [len(labels)]])
    return [(int(labels[a]), int(a), int(b))
            for a, b in zip(bounds[:-1], bounds[1:])]
