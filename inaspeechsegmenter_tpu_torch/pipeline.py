"""Segmentation pipeline after the features, on one device.

Port of ``inaspeechsegmenter_tpu/pipeline.py`` (``FusedPipeline``).  The
fused path (``run``, ``_run_impl`` there):

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

The streaming path (``chunk_emissions`` / ``stream_decode`` /
``run_streaming``) splits the same computation at feature chunks of
``CHUNK`` frames: the VAD CNN runs per chunk, on all of its frames, from
that chunk and ``STREAM_HALO`` mel rows of each neighbour, and a tail
(energy decode, right-edge repair, VAD decode, gender CNN and decode)
waits for the whole stream.  With ``ISS_STREAM_GENDER=1`` the gender CNN
also runs per chunk, on the same halo'd rows (speculative: every frame,
before the VAD decode says which are speech), and the tail only repairs
its right edge.  ``Segmenter.segment_signal`` (under ``ISS_STREAMING``)
and the online segmenter (``online.py``) are built on it: the online
``ext`` suffix decode re-decodes only the chunks after a committed
prefix.  Labels equal the fused path's (tests/test_torch_streaming.py,
tests/test_torch_streaming_call.py).

``viterbi_mode`` takes the JAX package's values (``ISS_VITERBI_MODE``:
``scan``, ``parallel``, ``blocked``); every mode runs the same exact
decode, whose states equal the JAX ``scan``.  ``bucket_chunks`` /
``bucket_rows`` are the JAX length ladder, which nothing here pads to.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .decode.transitions import diag_trans_exp, log_trans_exp
from .decode.viterbi import viterbi_scan
from .dsp.patches import (LPAD, PATCH_W, frame_patches, n_rows_of,
                          normalize_windows, windows_at)
from .utils.device import resolve_device
from .utils.timing import span

CNN_CHUNK = 1024  # patches per CNN batch
EPS = 1e-10
STREAM_HALO = 40  # mel rows borrowed from each neighbour chunk (>= 2*LPAD + 2)
VITERBI_MODES = ("scan", "parallel", "blocked")


def default_viterbi_mode(device):
    """``ISS_VITERBI_MODE`` when it is one of ``VITERBI_MODES``; else
    ``scan`` on the CPU and ``blocked`` on CUDA, the JAX package's choice
    for its CPU and accelerator backends.  The port's decode is the same
    exact kernel (or plain version) in every mode."""
    mode = os.environ.get("ISS_VITERBI_MODE")
    if mode in VITERBI_MODES:
        return mode
    return "scan" if torch.device(device).type == "cpu" else "blocked"


def stream_gender_enabled():
    """``ISS_STREAM_GENDER=1``: the streaming path computes the gender
    emissions per chunk (default off, as in the JAX package)."""
    return os.environ.get("ISS_STREAM_GENDER", "0") == "1"


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _finite_sums(loge):
    """-> (sum, count) of ``loge``'s finite values, float32 scalars on its
    device."""
    finite = torch.isfinite(loge)
    return (torch.where(finite, loge, torch.zeros_like(loge)).sum(),
            finite.sum().to(torch.float32))


class FusedPipeline:
    """Device constants and the decodes for one engine configuration.

    :param vad: (model, nmel, n_out, viterbi_arg) for the VAD CNN.
    :param gender: same tuple for the gender CNN, or None.
    :param viterbi_mode: one of ``VITERBI_MODES`` (None:
        :func:`default_viterbi_mode`); any other value raises ``KeyError``,
        as ``decode.viterbi.viterbi_path`` does.  Every mode decodes
        exactly; the mode is kept as ``viterbi_mode``.
    :param skip_inactive: run the fused path's CNNs only on the frames
        their decode reads (True, the default); False runs them on every
        frame, as the JAX program does without its skip.  Same labels.
    :param device: ``cuda`` by default; without a CUDA device it raises.
    """

    def __init__(self, vad, gender=None, energy_ratio=0.03, viterbi_mode=None,
                 skip_inactive=True, *, device="cuda"):
        self.device = resolve_device(device)
        mode = viterbi_mode or default_viterbi_mode(self.device)
        if mode not in VITERBI_MODES:
            raise KeyError(mode)
        self.viterbi_mode = mode
        self.skip_inactive = skip_inactive
        self._stages = vad, gender, energy_ratio
        self._slots = {}
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

    def _energy_states20(self, loge, ext=None):
        """(T,) log-energy -> (ceil(T/2),) bool 20 ms energy activity.

        ``ext`` (suffix decodes only): ``(sum, cnt, e_init)``, the finite
        log-energy sum and count of the frames LEFT of ``loge`` (host
        numbers, cast to float32 as the JAX package does, so the threshold
        stays the whole stream's mean) and the energy decode's initial
        log-distribution at ``loge[0]`` (a near-one-hot of the committed
        state at the seam)."""
        total, cnt = _finite_sums(loge)
        if ext is None:
            return self._energy_decode20(loge, total, cnt, self.e_init)
        ext_sum, ext_cnt, init = ext
        return self._energy_decode20(loge, total + np.float32(ext_sum),
                                    cnt + np.float32(ext_cnt),
                                    _f32(init, loge.device))

    def _energy_decode20(self, loge, total, cnt, init):
        """The energy decode of (T,) ``loge`` under the threshold of a
        finite log-energy ``total`` over ``cnt`` frames (float32 scalars
        on the device) -> (ceil(T/2),) bool 20 ms activity.  No host sync:
        the overlapped VFS scorer's provisional step calls it with running
        sums that stay on the device."""
        # the log ratio enters as a host float (a host tensor copied to
        # the device would wait for the device's queue), and the reset by
        # fill_ (an indexed assignment of a host scalar synchronizes)
        thr = total / cnt.clamp(min=1) + float(self.log_ratio)
        em = self.e_em[(loge > thr).long()]
        reset = torch.zeros(loge.shape[0], dtype=torch.bool,
                            device=loge.device)
        reset[:1].fill_(True)
        states = viterbi_scan(em.contiguous(), self.e_trans, init, reset)
        return states[::2] == 1

    @torch.no_grad()
    def _cnn_probs(self, model, mspec, n_frames_patch, nmel, nout, inmask):
        """CNN probabilities of the frames in ``inmask`` (of every frame
        without ``skip_inactive``); 0.5 elsewhere and for non-finite
        patches."""
        probs = torch.full((inmask.shape[0], nout), 0.5, dtype=torch.float32,
                           device=mspec.device)
        if self.skip_inactive:
            with span("cnn.select"):
                frames = torch.nonzero(inmask).flatten()
        else:
            frames = torch.arange(inmask.shape[0], device=mspec.device)
        for b0 in range(0, frames.shape[0], CNN_CHUNK):
            idx = frames[b0:b0 + CNN_CHUNK]
            with span("cnn.patches"):
                patches, fin = frame_patches(mspec, idx, n_frames_patch,
                                             nmel)
            with span("cnn.forward"):
                p = model(patches[..., None])
            probs[idx] = torch.where(fin[:, None], p, torch.full_like(p, 0.5))
        return probs

    def _masked_viterbi(self, probs, inmask, trans, init):
        em = torch.where(inmask[:, None], torch.log(probs),
                         torch.zeros_like(probs))
        reset = torch.ones_like(inmask)
        reset[1:] = inmask[1:] != inmask[:-1]
        return viterbi_scan(em.contiguous(), trans, init, reset)

    def _labels(self, mspec, n_frames_patch, energy20, probs_v, probs_g=None):
        """VAD decode, then the gender CNN and decode on the speech frames
        -> (n20,) int32 label ids.  ``probs_g``: the gender emissions of
        every frame, computed already (``run_sharded``); the decode reads
        only the speech frames' ones."""
        states_v = self._masked_viterbi(probs_v, energy20, self.v_trans,
                                        self.v_init)
        labels = torch.where(energy20, states_v + 1,
                             torch.zeros_like(states_v)).to(torch.int32)
        if self.gender is not None:
            speech20 = labels == 1   # outlabels[0] == 'speech' for sm and smn
            if probs_g is None:
                probs_g = self._cnn_probs(self.g_model, mspec,
                                          n_frames_patch, self.g_nmel,
                                          self.g_nout, speech20)
            states_g = self._masked_viterbi(probs_g, speech20, self.g_trans,
                                            self.g_init)
            labels = torch.where(speech20, states_g + 1 + self.vad_nout,
                                 labels).to(torch.int32)
        return labels

    def run(self, mspec, loge, n_frames, n_frames_patch, n20):
        """Label ids (n20,) int32 on the device: 0 = noEnergy, then the VAD
        outlabels, then the gender outlabels.

        :param mspec: (>= n_frames_patch, >= nmel) log-mel rows.
        :param loge: (>= n_frames,) log-energy.
        """
        energy20 = self._energy_states20(loge[:n_frames])[:n20]
        probs_v = self._cnn_probs(self.vad_model, mspec, n_frames_patch,
                                  self.vad_nmel, self.vad_nout, energy20)
        return self._labels(mspec, n_frames_patch, energy20, probs_v)

    # -- streaming ----------------------------------------------------------
    #
    # Exactness: patch j reads mel rows [2*clip(j - 17, 0, n_rows - 1), +68)
    # (dsp/patches.py).  A chunk starting at 20 ms frame j0 sees rows
    # [2*j0 - STREAM_HALO, 2*(j0 + CHUNK/2) + STREAM_HALO) from its
    # neighbours (zeros past either end of the stream), so an unclipped
    # patch is one stride-2 window of those rows; the left clip only occurs
    # in chunk 0 (the replicated window 0), and the right clip is repaired
    # once, in the tail, by `_fix_right_edge`.

    @torch.no_grad()
    def _chunk_probs(self, model, nmel, prev_tail, own, next_head, is_first):
        """CNN probabilities of the CHUNK/2 20 ms frames of one feature
        chunk (the JAX ``_chunk_probs_impl``): frame l reads window
        l + HALO/2 - LPAD of the halo'd rows; in the first chunk frames
        l < LPAD read window HALO/2, the chunk's own window 0."""
        m = torch.cat([prev_tail, own, next_head])
        c20 = own.shape[0] // 2
        z = STREAM_HALO // 2
        if is_first:
            win = torch.arange(z - LPAD, z - LPAD + c20,
                               device=m.device).clamp(min=z)
        else:
            win = torch.arange(z - LPAD, z - LPAD + c20, device=m.device)
        with span("cnn.patches"):
            norm, fin = normalize_windows(windows_at(m, win, nmel,
                                                     z - LPAD + c20 - 1))
        with span("cnn.forward"):
            p = model(norm.reshape(c20, PATCH_W, nmel)[..., None])
        return torch.where(fin[:, None], p, torch.full_like(p, 0.5))

    @torch.no_grad()
    def _fix_right_edge(self, model, nmel, mspec, probs, n_frames_patch):
        """Overwrite, in place, the replicate-edge frames (j > n_rows + 16)
        of ``probs`` with the prediction of the last valid window: the
        reference's right replicate padding (segmenter.py:83-85)."""
        n_rows = n_rows_of(n_frames_patch)
        last = torch.tensor([n_rows - 1], device=mspec.device)
        with span("cnn.patches"):
            norm, fin = normalize_windows(windows_at(mspec, last, nmel,
                                                     n_rows - 1))
        with span("cnn.forward"):
            p_last = model(norm.reshape(1, PATCH_W, nmel)[..., None])[0]
        probs[n_rows + LPAD:] = torch.where(fin[0], p_last,
                                            torch.full_like(p_last, 0.5))
        return probs

    def chunk_emissions(self, chunks, c, zero_right=False, gender=False):
        """CNN probabilities of chunk ``c`` of a per-chunk feature list
        [(mspec_c, loge_c)] -> ``(probs_v (CHUNK/2, n_out), probs_g or
        None)``: the ONE owner of the halo policy (the neighbours'
        STREAM_HALO rows, zero halos at both ends of the stream, the
        first-chunk replicate), shared by `run_streaming`,
        ``Segmenter.segment_signal`` and the online segmenter, whose
        finalize() equals the offline labels only if all build the same
        halos.

        :param zero_right: treat ``c`` as the stream frontier (no right
            context yet) even if later chunks exist: the online
            provisional decode.
        :param gender: also run the gender CNN on the same halo'd rows
            (the speculative gender emissions; needs a gender stage).
        """
        m_c = chunks[c][0]
        zeros = m_c.new_zeros((STREAM_HALO, m_c.shape[1]))
        prev = chunks[c - 1][0][-STREAM_HALO:] if c else zeros
        nxt = (zeros if zero_right or c + 1 >= len(chunks)
               else chunks[c + 1][0][:STREAM_HALO])
        pv = self._chunk_probs(self.vad_model, self.vad_nmel, prev, m_c, nxt,
                               c == 0)
        pg = None
        if gender:
            pg = self._chunk_probs(self.g_model, self.g_nmel, prev, m_c, nxt,
                                   c == 0)
        return pv, pg

    def stream_decode(self, chunks, probs_v, n_frames, n_frames_patch, n20,
                      ext=None, probs_g=None):
        """The streaming tail over per-chunk features and their VAD
        emissions -> (n20,) int32 label ids.  The ONE owner of the tail's
        argument construction, shared by `run_streaming`,
        ``Segmenter.segment_signal`` and the online segmenter.  ``ext``
        makes it a suffix decode (see `_energy_states20`); ``probs_g``, the
        chunks' gender emissions, replaces the tail's gender CNN."""
        if probs_g is not None:
            probs_g = torch.cat(list(probs_g))
        return self._tail(torch.cat([m for m, _ in chunks]),
                          torch.cat([lg for _, lg in chunks]),
                          torch.cat(list(probs_v)), n_frames, n_frames_patch,
                          n20, ext, probs_g)

    def _tail(self, mspec, loge, probs_v, n_frames, n_frames_patch, n20,
              ext=None, probs_g=None):
        """The part of the streaming path that needs the whole stream
        (the JAX ``_tail_impl``): energy decode, right-edge repair, VAD
        decode, then the gender CNN on the decoded speech frames and its
        decode.  Gender emissions computed already (``probs_g``, every
        frame) take only the right-edge repair instead of the CNN."""
        energy20 = self._energy_states20(loge[:n_frames], ext)[:n20]
        probs_v = self._fix_right_edge(self.vad_model, self.vad_nmel, mspec,
                                       probs_v, n_frames_patch)[:n20]
        if probs_g is not None:
            probs_g = self._fix_right_edge(self.g_model, self.g_nmel, mspec,
                                           probs_g, n_frames_patch)[:n20]
        return self._labels(mspec, n_frames_patch, energy20, probs_v,
                            probs_g)

    def run_streaming(self, chunks, n_frames, n_frames_patch, n20):
        """Streaming execution over per-chunk features
        [(mspec_c (CHUNK, 24), loge_c (CHUNK,))] -> (n20,) int32 label ids,
        equal to `run` on the concatenated features; the gender emissions
        per chunk under ``ISS_STREAM_GENDER=1``."""
        gender = self.gender is not None and stream_gender_enabled()
        probs = [self.chunk_emissions(chunks, c, gender=gender)
                 for c in range(len(chunks))]
        return self.stream_decode(
            chunks, [v for v, _ in probs], n_frames, n_frames_patch, n20,
            probs_g=[g for _, g in probs] if gender else None)

    # -- sequence-parallel single-file path ---------------------------------
    #
    # The multi-file engine (parallel/engine.py) spreads files over the
    # mesh's slots; this spreads ONE file's timeline: the feature rows are
    # split into the streaming path's halo'd chunks, each slot computes the
    # VAD and gender CNN emissions of its run of chunks on its own replica,
    # and the tail (energy, VAD and gender decodes, O(T) with K <= 3
    # states) runs on the mesh's first device with the gathered emissions.
    # The gender emissions are computed for every frame (a patch's
    # normalization does not depend on its segment), so they equal the
    # fused path's on every frame the masked gender Viterbi reads.

    def slots(self, mesh):
        """(pipelines, streams): one copy of this pipeline, its models
        replicated on the slot's device, and one CUDA stream (None on the
        CPU) per slot of ``mesh``; made once per device list and kept."""
        from .parallel.mesh import replicate, slot_streams

        devices = list(mesh.devices.flat)
        key = tuple(str(d) for d in devices)
        if key not in self._slots:
            vad, gender, energy_ratio = self._stages
            vads = replicate(mesh, vad[0])
            gens = (replicate(mesh, gender[0]) if gender is not None
                    else [None] * len(devices))
            pipes = [FusedPipeline(
                (v,) + tuple(vad[1:]),
                None if g is None else (g,) + tuple(gender[1:]),
                energy_ratio, self.viterbi_mode, self.skip_inactive,
                device=d)
                for v, g, d in zip(vads, gens, devices)]
            self._slots[key] = pipes, slot_streams(devices)
        return self._slots[key]

    def run_sharded(self, mspec, loge, n_frames, n_frames_patch, n20, mesh):
        """Sequence-parallel execution of one file over ``mesh`` -> (n20,)
        int32 label ids on the mesh's first device, equal to `run`'s
        (tests/test_torch_sharded_file.py).

        Slot k takes chunks [k*per, (k+1)*per) of the ceil(rows / CHUNK)
        chunks, per = ceil(chunks / slots) (the JAX chunk axis padded to a
        slot multiple; a slot past the last chunk runs nothing).  Each slot
        gets only its rows and STREAM_HALO rows each side, zeros outside
        the file, copied to its device; every chunk runs as a middle
        chunk, and chunk 0's left replicate edge is repaired after the
        gather: frames < LPAD take frame LPAD's emission, window 0's
        prediction, the value the first-chunk rule gives them.

        :param mspec: (rows, >= nmel) log-mel rows, ``loge`` (>= n_frames,)
            log-energy, both on one device.
        """
        from .dsp.sidekit import CHUNK
        from .parallel.mesh import run_on_slots

        pipes, streams = self.slots(mesh)
        devices = list(mesh.devices.flat)
        dev0 = devices[0]
        rows, h = mspec.shape[0], STREAM_HALO
        n_chunks = -(-rows // CHUNK)
        per = -(-n_chunks // len(devices))
        items = []
        for k, dev in enumerate(devices):
            c0, c1 = min(k * per, n_chunks), min((k + 1) * per, n_chunks)
            a, b = max(c0 * CHUNK - h, 0), min(c1 * CHUNK + h, rows)
            items.append((c0, c1, a, mspec[a:b].to(dev) if c1 > c0
                          else None))

        def slot(k, item):
            c0, c1, a, part = item
            if c1 == c0:
                return None
            pipe = pipes[k]
            blk = part.new_zeros(((c1 - c0) * CHUNK + 2 * h, part.shape[1]))
            off = a - (c0 * CHUNK - h)
            blk[off:off + part.shape[0]] = part
            stages = [(pipe.vad_model, pipe.vad_nmel)]
            if pipe.gender is not None:
                stages.append((pipe.g_model, pipe.g_nmel))
            out = []
            for model, nmel in stages:
                out.append(torch.cat([pipe._chunk_probs(
                    model, nmel, blk[j * CHUNK:j * CHUNK + h],
                    blk[j * CHUNK + h:(j + 1) * CHUNK + h],
                    blk[(j + 1) * CHUNK + h:(j + 1) * CHUNK + 2 * h], False)
                    for j in range(c1 - c0)]))
            return out

        parts = [p for p in run_on_slots(slot, items, devices, streams)
                 if p is not None]

        def gather(i):
            p = torch.cat([q[i].to(dev0) for q in parts])
            p[:LPAD] = p[LPAD]
            return p

        probs_g = gather(1) if self.gender is not None else None
        head = pipes[0]
        return head._tail(mspec.to(dev0), loge.to(dev0), gather(0), n_frames,
                          n_frames_patch, n20, probs_g=probs_g)


def bucket_chunks(n):
    """The JAX package's chunk-count ladder (1, 2, 4, 6, 9, 14, ...: x1.5
    past 4), which bounds its jit cache.  The port has no jit cache and
    pads nothing to it; the multi-file engine groups files by it."""
    b = 1
    while b < n:
        b = b * 2 if b < 4 else (b * 3 + 1) // 2
    return b


def bucket_rows(n_frames):
    """The JAX package's padded feature-row count for ``n_frames`` frames:
    ``bucket_chunks`` of the chunk count, times CHUNK (at least one)."""
    from .dsp.sidekit import CHUNK

    return bucket_chunks(max(1, -(-n_frames // CHUNK))) * CHUNK


def rle(labels):
    """Run-length encode an int label array -> [(label, start, stop)]."""
    labels = np.asarray(labels)
    if len(labels) == 0:
        return []
    change = np.flatnonzero(np.diff(labels)) + 1
    bounds = np.concatenate([[0], change, [len(labels)]])
    return [(int(labels[a]), int(a), int(b))
            for a, b in zip(bounds[:-1], bounds[1:])]
