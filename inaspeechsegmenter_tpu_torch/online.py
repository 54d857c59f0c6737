"""Online (incremental) segmentation and VFS of a growing recording.

Port of ``inaspeechsegmenter_tpu/online.py``.  The reference is strictly
file-at-a-time (its ``Segmenter.__call__`` decodes a complete file,
reference segmenter.py:279-294); this wraps the streaming functions of
``pipeline.py`` behind an append-only API, so a caller can follow a
recording while it is being written:

    online = OnlineSegmenter(segmenter)
    while capturing:
        online.feed(next_pcm_block)          # any size, any cadence
        print(online.current())              # provisional labels so far
    lseg = online.finalize()                 # == segmenter.segment_signal(all_pcm)

Guarantees and costs:

* ``finalize()`` gives the offline labels of the whole signal
  (tests/test_torch_online.py): features come from the frontend's own
  ``group_feats`` (one features launch a group of ``ISS_UPLOAD_CHUNKS``
  chunks, each group's upload through the codec where it is on),
  chunk emissions from ``pipeline.chunk_emissions`` (the gender ones too
  under ``ISS_STREAM_GENDER=1``, cached a chunk; chunks cached before the
  switch turned on have none, and the decode then runs the tail's own
  gender pass) and the decode from ``pipeline.stream_decode``.
  ``Segmenter.segment_signal`` runs the fused path by default, whose
  labels equal the streaming path's; on the CUDA device the two run the
  CNN in batches of other sizes, so equality there is counted in frames
  (``chip_smoke.py`` phase 4).
* ``current()`` is PROVISIONAL: the newest chunk's emissions are computed
  without its right halo and the smoothing can revise earlier labels as
  context arrives.  Polls are cached on their exact decode inputs, and
  once a silence boundary commits a prefix only the suffix is re-decoded.
* Memory is bounded: raw PCM is dropped as soon as its feature group is
  computed; the per-chunk device features (~0.4 MB per 41 s chunk) and the
  cached emissions are the state the decode needs anyway.
* Availability granularity is one feature group (``ISS_UPLOAD_CHUNKS``,
  3 chunks, ~123 s by default): a chunk's features are computed when its
  group's samples, plus the 2*HOP lookahead, have been fed, exactly like
  the offline grouping.
* ``ISS_STREAMING=0`` (the streaming kill switch), or a frontend without
  ``group_feats`` (the host frontend, ``dsp/host_fe.py``), makes the
  object a buffering passthrough: every sample is kept and ``current()``
  / ``finalize()`` hand the whole buffer to ``segmenter.segment_signal``,
  as in the JAX package.

``OnlineVFS`` scores the same way.  An int16 stream on the int16 VBx grid
(``dsp.vbx.vbx_i16_enabled``: a CUDA device) feeds a
``VbxPcmStreamOnline``, whose blocks are final as the stream passes them,
and keeps no PCM past the first 400 samples; ``finalize()`` reassembles
``vfs.score_signal``'s result from the embeddings already computed plus
one catch-up batch.  Float streams, and the f32 path (the CPU), keep
the buffered prefix: features are recomputed on the grown prefix once
``ISS_ONLINE_VFS_BATCH`` new windows can be embedded, each window is
embedded once, and ``finalize()`` is ``vfs.score_signal`` of everything
fed.
"""

from __future__ import annotations

import os
import struct
import time

import numpy as np
import torch

from .annotations import SpeechTimeline
from .audio import wav as _wav
from .dsp.fe_kernel import upload_chunks
from .dsp.sidekit import CHUNK, HOP, frame_count
from .dsp import vbx
from .dsp.vbx import LC, RC, VbxFrontend, VbxPcmStreamOnline
from .pipeline import stream_gender_enabled
from .vfs import STEP, WINLEN, TorchResnetExtractor

_LOG_ZERO = float(np.log(1e-200))


def _loge_stats(loge_c):
    """(finite sum, finite count) of one chunk's log-energies, as device
    scalars: the committed prefix's share of the suffix decode's energy
    threshold, read on the host only at commit time."""
    fin = torch.isfinite(loge_c)
    return (torch.where(fin, loge_c, torch.zeros_like(loge_c)).sum(),
            fin.to(torch.float32).sum())


class OnlineSegmenter:
    """Incremental counterpart of `Segmenter.segment_signal`.

    :param segmenter: a constructed `Segmenter` (its frontend, CNNs and
        device are shared).
    :param start_sec: label offset in seconds, like the offline APIs.
    """

    # Committed-prefix decode bounds: a chunk boundary commits when the
    # labels COMMIT_RUN 20 ms frames to each side are all noEnergy — the
    # energy Viterbi's state there is pinned by ~96 consecutive 10 ms
    # frames of agreeing near-certain emissions (each worth ~23 nats vs a
    # 345-nat transition), and the VAD/gender Viterbi levels reset at
    # every energy boundary, so no decoding segment crosses the seam.
    # COMMIT_GUARD chunks stay uncommitted behind the frontier (their
    # emissions/threshold are still moving); if no silence boundary shows
    # up for COMMIT_MAXBACK chunks (~11 min of unbroken audio), the
    # decode force-commits at that horizon — current() is PROVISIONAL by
    # contract, and finalize() always re-decodes the full stream.
    COMMIT_RUN = 48
    COMMIT_GUARD = 1
    COMMIT_MAXBACK = 16

    def __init__(self, segmenter, start_sec=0):
        self.seg = segmenter
        self.start_sec = start_sec
        self._group = upload_chunks()
        # the streaming kill switch, or a frontend without group
        # computations: buffer everything and hand the offline path the
        # whole signal
        self._passthrough = (
            os.environ.get("ISS_STREAMING") == "0"
            or not hasattr(segmenter.frontend, "group_feats"))
        self._dtype = None          # decided by the first feed
        self._pending = None        # materialized samples not yet consumed
        self._tail = []             # fed blocks not yet materialized: feed()
                                    # is O(block); the concatenate happens
                                    # once per feature group, not per feed
        self._consumed = 0          # samples dropped from the buffer front
        self._total = 0             # samples fed overall
        self._mels = []             # [(mspec_c, loge_c)] device tensors
        self._probs = {}            # chunk idx -> final (vad, gender) probs
        self._prov = None           # ((mel_count, gender), provisional probs)
        self._cur = None            # (decode inputs key, lseg) cache
        self._finalized = None
        self._commit = 0            # chunks whose labels are frozen
        self._commit_act = False    # energy activity at the seam
        self._committed_ids = np.zeros(0, np.int32)
        self._stat_handles = []     # per-chunk (sum, cnt) device scalars
        self._ext_stats = (0.0, 0.0)   # accumulated committed loge stats
        self._polled = False        # pace commits only for poll consumers

    @property
    def seconds_fed(self):
        """Seconds of audio fed so far (cheap: no device work)."""
        return self._total / 16000.0

    @property
    def chunks_ready(self):
        """Feature chunks computed so far (cheap: no device work)."""
        return len(self._mels)

    @property
    def _spec_gender(self):
        """Speculative gender emissions a chunk (``ISS_STREAM_GENDER=1``),
        read at each use as the JAX package reads it."""
        return self.seg.detect_gender and stream_gender_enabled()

    # -- feeding -----------------------------------------------------------
    def feed(self, pcm):
        """Append a block of 16 kHz mono samples (int16, or float in
        [-1, 1]).  All blocks must share one kind — the offline result
        this converges to is computed on a single-dtype signal."""
        if self._finalized is not None:
            raise RuntimeError("feed() after finalize()")
        pcm = np.asarray(pcm)
        kind = np.int16 if pcm.dtype == np.int16 else np.float32
        if self._dtype is None:
            self._dtype = kind
            self._pending = np.zeros(0, kind)
        elif kind != self._dtype:
            raise TypeError(
                f"feed dtype changed from {np.dtype(self._dtype).name} to "
                f"{pcm.dtype.name}; an online stream must keep one sample "
                "kind (the offline equivalence is per-signal)")
        # a copy: capture callbacks reuse their buffer
        self._tail.append(np.array(pcm, dtype=self._dtype, copy=True))
        self._total += len(pcm)
        if self._passthrough:
            return self
        self._compute_ready_groups(final_pad_chunks=None)
        # commit pacing: a consumer that polls must never face an
        # unbounded suffix decode because it polled RARELY — once the
        # uncommitted span outruns the force-commit horizon by a group,
        # decode and commit now, so any later poll costs O(horizon)
        if (self._polled and len(self._mels) >= 2
                and (len(self._mels) - self._commit
                     > self.COMMIT_MAXBACK + self._group)):
            self.current()
        return self

    def _materialize(self):
        """Flush fed blocks into the contiguous buffer (one concatenate
        per feature group / fallback read, not one per feed)."""
        if self._tail:
            self._pending = np.concatenate([self._pending, *self._tail])
            self._tail = []
        return self._pending

    @property
    def buffered_samples(self):
        """Raw samples currently held (memory-bound observability)."""
        return (len(self._pending) if self._pending is not None else
                0) + sum(len(p) for p in self._tail)

    def _compute_ready_groups(self, final_pad_chunks):
        """Compute the features of every group whose slice is fully fed,
        through the frontend's own `group_feats` (the offline grouping:
        group g covers samples [g*CHUNK*HOP, ((g+k)*CHUNK + 2)*HOP)); with
        ``final_pad_chunks`` set (finalize), zero-pad and compute through
        that chunk count."""
        while True:
            g = len(self._mels)
            if final_pad_chunks is not None and g >= final_pad_chunks:
                return
            k = self._group
            if final_pad_chunks is not None:
                k = min(k, final_pad_chunks - g)
            end = ((g + k) * CHUNK + 2) * HOP
            have = self._total        # == consumed + pending + tail
            if final_pad_chunks is None and have < end:
                return                # cheap: no materialization needed
            self._materialize()
            start = g * CHUNK * HOP
            raw = np.zeros(end - start, self._dtype)
            avail = self._pending[start - self._consumed:
                                  max(start - self._consumed,
                                      end - self._consumed)]
            raw[:len(avail)] = avail
            chunks_g, _ = self.seg.frontend.group_feats(raw, k)
            self._mels.extend(chunks_g)
            self._stat_handles.extend(_loge_stats(lc) for _, lc in chunks_g)
            for c in range(max(g, 1), g + k):
                self._final_probs(c - 1)      # c-1's right halo now exists
            # drop raw samples the next groups will never read — but only
            # once the streaming decode is committed to (>= 2 chunks):
            # the short-media fallbacks in current()/finalize() hand the
            # WHOLE buffer back to the offline fused path
            keep_from = (g + k) * CHUNK * HOP
            if g + k >= 2 and keep_from > self._consumed:
                cut = min(keep_from, have) - self._consumed
                self._pending = self._pending[cut:]
                self._consumed += cut

    # -- emissions ---------------------------------------------------------
    def _chunk_probs(self, c, zero_right=False):
        """(VAD, gender-or-None) emissions of chunk c, through the halo
        policy's single owner (`pipeline.chunk_emissions`).  Final
        emissions (real right halo) are cached per chunk; the provisional
        zero-right emission is cached per mel count and gender switch, so
        polling current() between chunk arrivals launches nothing new."""
        if not zero_right and c in self._probs:
            return self._probs[c]
        key = (len(self._mels), self._spec_gender)
        if zero_right and self._prov is not None and self._prov[0] == key:
            return self._prov[1]
        probs = self.seg.pipeline.chunk_emissions(
            self._mels, c, zero_right=zero_right, gender=self._spec_gender)
        if zero_right:
            self._prov = (key, probs)
        else:
            self._probs[c] = probs
        return probs

    def _final_probs(self, c):
        if 0 <= c < len(self._mels) - 1 and c not in self._probs:
            self._chunk_probs(c)

    # -- decoding ----------------------------------------------------------
    def _split(self, probs):
        """[(vad, gender)] -> (vad list, gender list or None).  The gender
        list is None unless the switch is on and every chunk has its
        gender part: where ``ISS_STREAM_GENDER`` turned on mid-stream, the
        chunks cached before have none, and the tail's own gender pass
        (the same labels) takes over."""
        pg = [g for _, g in probs]
        if not self._spec_gender or any(g is None for g in pg):
            pg = None
        return [v for v, _ in probs], pg

    def _decode(self, mels, probs, n_frames):
        """The streaming tail over whole chunks -> (n20,) numpy label ids."""
        n20 = (n_frames + 1) // 2
        pv, pg = self._split(probs)
        ids = self.seg.pipeline.stream_decode(mels, pv, n_frames, n_frames,
                                              n20, probs_g=pg)
        return ids.cpu().numpy()

    def current(self):
        """Provisional labels over everything fed so far
        -> [(label, start_s, stop_s)].  May be revised by later feeds;
        `finalize()` gives the offline result.

        The result is cached on its exact decode inputs: the provisional
        decode only sees ``min(frame_count(total), m*CHUNK)`` frames, so
        between feature-group completions nothing it reads has changed
        and the poll launches nothing."""
        if self._finalized is not None:
            return self._finalized
        self._polled = True
        m = len(self._mels)
        if m < 2:
            # less than two chunks of features: the offline path on the
            # (still fully buffered) prefix.  Under a complete 25 ms
            # analysis window there is nothing to label yet.
            if frame_count(self._total) == 0:
                return []
            key = ("short", self._total, self._spec_gender)
            if self._cur is None or self._cur[0] != key:
                self._cur = (key, self.seg.segment_signal(
                    self._materialize(), self.start_sec))
            return list(self._cur[1])
        n = min(frame_count(self._total), m * CHUNK)
        key = (m, n, self._spec_gender, self._commit)
        if self._cur is None or self._cur[0] != key:
            ids = self._decode_provisional(n)
            lseg = self.seg.ids_to_lseg(ids, self.start_sec)
            self._advance_commit(ids, m)
            # re-key on the ADVANCED commit: the labels are unchanged by
            # committing, and a stale key would force the very next poll
            # to re-decode for nothing
            self._cur = ((m, n, self._spec_gender, self._commit), lseg)
        return list(self._cur[1])

    def _decode_provisional(self, n_frames):
        """Labels over everything fed: the frozen committed prefix + a
        decode of ONLY the uncommitted suffix chunks — O(suffix), flat in
        stream length."""
        m = len(self._mels)
        c0 = self._commit
        probs = [self._chunk_probs(c) for c in range(c0, m - 1)]
        probs.append(self._chunk_probs(m - 1, zero_right=True))
        if c0 == 0:
            return self._decode(self._mels, probs, n_frames)
        n_suf = n_frames - c0 * CHUNK
        n20s = (n_suf + 1) // 2
        # seam: a near-one-hot energy init at the committed state; the
        # committed loge stats keep the threshold global
        e_init = np.full(2, _LOG_ZERO, np.float32)
        e_init[1 if self._commit_act else 0] = 0.0
        ext = (self._ext_stats[0], self._ext_stats[1], e_init)
        pv, pg = self._split(probs)
        ids_s = self.seg.pipeline.stream_decode(
            self._mels[c0:], pv, n_suf, n_suf, n20s, ext=ext, probs_g=pg)
        return np.concatenate([self._committed_ids, ids_s.cpu().numpy()])

    def _advance_commit(self, ids, m):
        """Freeze the label prefix up to the newest committable chunk
        boundary (see COMMIT_* above) and fold the frozen chunks' loge
        stats into the suffix threshold."""
        n20 = len(ids)
        c20 = CHUNK // 2
        best = None
        for b in range(m - self.COMMIT_GUARD, self._commit, -1):
            f = b * c20
            if f - self.COMMIT_RUN < 0 or f + self.COMMIT_RUN > n20:
                continue
            if not ids[f - self.COMMIT_RUN: f + self.COMMIT_RUN].any():
                best = (b, False)
                break
        if best is None and m - self._commit > self.COMMIT_MAXBACK:
            b = m - self.COMMIT_MAXBACK
            f = b * c20
            if 0 < f <= n20:
                best = (b, bool(ids[min(f, n20 - 1)] != 0))
        if best is None:
            return
        b, act = best
        s, cnt = self._ext_stats
        for c in range(self._commit, b):
            hs, hc = self._stat_handles[c]
            s += float(hs)
            cnt += float(hc)
        self._ext_stats = (s, cnt)
        self._committed_ids = np.array(ids[: b * c20], np.int32, copy=True)
        self._commit = b
        self._commit_act = act

    def finalize(self):
        """Flush the stream and return the offline labels of everything
        fed (``segmenter.segment_signal``'s).  Idempotent."""
        if self._finalized is not None:
            return self._finalized
        t = frame_count(self._total)
        n_chunks = max(1, -(-t // CHUNK))
        if self._passthrough or t < 68 or n_chunks < 2:
            # the offline path's short-media branch; nothing has been
            # dropped yet (no group completed), so hand it the whole
            # buffer (same errors on too-short input)
            self._finalized = self.seg.segment_signal(
                self._materialize() if self._total else
                np.zeros(0, self._dtype or np.float32), self.start_sec)
            return self._finalized
        self._compute_ready_groups(final_pad_chunks=n_chunks)
        mels = self._mels[:n_chunks]
        probs = [self._chunk_probs(c) for c in range(n_chunks - 1)]
        probs.append(self._chunk_probs(n_chunks - 1, zero_right=True))
        self._finalized = self.seg.ids_to_lseg(
            self._decode(mels, probs, t), self.start_sec)
        return self._finalized


# -- following a growing WAV file ---------------------------------------------

def _wav_data_offset(path):
    """Offset of the data payload in a (possibly still-growing) canonical
    PCM16 mono 16 kHz WAV, or None while the header is incomplete.  The
    data chunk's own size is routinely bogus in files being written
    (writers back-patch it on close), so only the chunk WALK is trusted —
    via `audio.wav._read_chunks` (which also handles pre-data metadata
    chunks of any size and word alignment)."""
    with open(path, "rb") as f:
        if len(f.read(12)) < 12:
            return None                         # header still being written
        f.seek(0)
        fmt = None
        for cid, size, offset in _wav._read_chunks(f):
            if cid == b"fmt ":
                f.seek(offset)
                raw = f.read(size)
                if len(raw) < 16:
                    return None                 # fmt still being written
                code, channels, sr, _, _, bits = struct.unpack(
                    "<HHIIHH", raw[:16])
                if code == _wav._WAVE_FORMAT_EXTENSIBLE and len(raw) >= 26:
                    # real format = first 2 bytes of the SubFormat GUID
                    # (WASAPI/libsndfile recorders write canonical PCM16
                    # audio behind an extensible fmt chunk)
                    code = struct.unpack("<H", raw[24:26])[0]
                fmt = (code, channels, sr, bits)
            elif cid == b"data":
                if fmt is None:
                    return None
                if fmt != (1, 1, 16000, 16):
                    code, channels, sr, bits = fmt
                    raise _wav.WavFormatError(
                        f"{path}: follow mode needs PCM16 mono 16 kHz WAV, "
                        f"got format={code} channels={channels} sr={sr} "
                        f"bits={bits}")
                return offset
    return None


def follow_wav(path, segmenter, idle_timeout=10.0, poll=0.5, start_sec=0,
               on_update=None):
    """Tail a GROWING PCM16 mono 16 kHz WAV file and return the final
    labels once it stops growing.

    Polls the file every ``poll`` seconds, feeds newly appended samples to
    an `OnlineSegmenter` in bounded batches (one feature-group slice per
    read: attaching to an already-hours-long file drains the backlog
    without materializing it whole), and finalizes after ``idle_timeout``
    seconds without file activity — the result is then the labels of
    ``segmenter.segment_signal(<the whole file's samples>)``.  ANY file
    growth (header/metadata chunks included) counts as activity.  If no
    audio ever arrives, raises TimeoutError instead of finalizing an empty
    stream.  ``on_update(online)`` is called after each feed batch."""
    return _follow_stream(path, OnlineSegmenter(segmenter, start_sec),
                          idle_timeout, poll, on_update)


def follow_wav_vfs(path, vfs, idle_timeout=10.0, poll=0.5, on_update=None):
    """Tail a GROWING PCM16 mono 16 kHz WAV and return the final
    femininity scoring once it stops growing — the `OnlineVFS`
    counterpart of `follow_wav`; the result equals
    ``vfs.score_signal(<the whole file's samples>)``."""
    basename = os.path.splitext(os.path.basename(path))[0]
    return _follow_stream(path, OnlineVFS(vfs, basename=basename),
                          idle_timeout, poll, on_update)


def _data_end(path, data_off, size):
    """Feed bound for this poll: the data chunk's CURRENT declared size
    when it looks back-patched (``data_off + declared <= size``), else
    EOF.  Recorders finalize the size on close and taggers then append
    LIST/INFO/id3 chunks AFTER the data payload — those bytes are not
    samples, and the offline reader (`audio.wav.read_wav`) reads exactly
    ``declared`` bytes.  Growing files carry 0/0xFFFFFFFF/stale
    placeholders instead, which keep the EOF bound.  Re-read every poll:
    some writers back-patch periodically, not just on close.

    A recorder may also write a small FIXED nonzero placeholder and only
    back-patch on close; once the payload grows past it, trusting it
    would stall live feeding at that bound until close.  A genuine
    back-patch is followed by nothing or by appended metadata chunks (a
    printable 4CC), while a growing payload puts raw PCM there — then the
    declared size is stale and the EOF bound applies until it changes."""
    try:
        with open(path, "rb") as f:
            f.seek(data_off - 4)
            declared = struct.unpack("<I", f.read(4))[0]
            if declared in (0, 0xFFFFFFFF) or data_off + declared > size:
                return size
            end = data_off + declared + (declared & 1)   # word-aligned
            if size >= end + 8:
                f.seek(end)
                fourcc = f.read(4)
                if not all(0x20 <= b <= 0x7e for b in fourcc):
                    return size          # raw samples, not a chunk id
    except (OSError, struct.error):
        return size
    return data_off + declared


def _follow_stream(path, online, idle_timeout, poll, on_update):
    """Tail loop driving any online consumer (feed/finalize)."""
    data_off = None
    pos = 0
    last_size = -1
    last_activity = time.time()
    # one upload group of int16 bytes a read
    max_read = ((getattr(online, "_group", 3) * CHUNK + 2) * HOP) * 2
    while True:
        size = os.path.getsize(path) if os.path.exists(path) else 0
        if size != last_size:
            last_size = size
            last_activity = time.time()
        if data_off is None and size >= 12:
            data_off = _wav_data_offset(path)
            if data_off is not None:
                pos = data_off
        end = (_data_end(path, data_off, size)
               if data_off is not None else 0)
        if data_off is not None and end - pos >= 2:
            want = min(((end - pos) // 2) * 2, max_read)
            with open(path, "rb") as f:
                f.seek(pos)
                blob = f.read(want)
            pos += len(blob)
            online.feed(np.frombuffer(blob, "<i2"))
            last_activity = time.time()
            if on_update is not None:
                on_update(online)
            if len(blob) == max_read:
                continue                        # backlog catch-up: no sleep
        elif time.time() - last_activity >= idle_timeout:
            if online.seconds_fed == 0:
                raise TimeoutError(
                    f"--follow: no audio arrived in {path!r} within "
                    f"{idle_timeout}s (the file "
                    + ("never appeared" if not os.path.exists(path)
                       else "has no data payload yet") + ")")
            return online.finalize()
        time.sleep(poll)


class OnlineVFS:
    """Live voice-femininity monitoring of a growing recording.

    Feed 16 kHz mono blocks as they arrive; ``current()`` returns a
    PROVISIONAL ``(score | None, speech_dur, n)`` from the provisional
    online VAD and the x-vectors embedded so far; ``finalize()`` runs the
    canonical scoring on the full signal, ``vfs.score_signal(<everything
    fed>)``.  Embeddings are incremental: a window is embedded ONCE, as
    soon as its features are final, and cached for every later
    provisional score, once at least ``ISS_ONLINE_VFS_BATCH`` (default
    32) new windows are embeddable.

    Features: an int16 stream on the int16 VBx grid runs through a
    ``VbxPcmStreamOnline`` (blocks computed as the stream passes their
    halo'd extent, equal to the finished signal's bit for bit), the raw
    PCM dropped once 400 samples have arrived; ``finalize()`` reassembles
    the offline result from the cached embeddings plus one catch-up batch
    (the extractor's ``embed=``).  Other streams keep the buffered
    prefix: features recomputed on it, the raw PCM kept for the finalize.
    """

    TAIL_GUARD = 4     # frontier frames the mirror tail may still change

    def __init__(self, vfs, basename="<live>"):
        self.vfs = vfs
        self.basename = basename
        self.vad_online = OnlineSegmenter(vfs.vad)
        self._parts = []
        self._total = 0
        self._dtype = None
        self._emb = {}          # window start frame -> RAW xvector | None
        self._fea = None        # device features of the buffered prefix
        self._fea_len = -1
        self._cur = None        # (scoring inputs key, result) cache
        self._finalized = None
        self._stream = None     # VbxPcmStreamOnline (the int16 grid)
        self._use_stream = None
        self._min_new = max(1, int(os.environ.get("ISS_ONLINE_VFS_BATCH",
                                                  "32")))

    @property
    def seconds_fed(self):
        return self._total / 16000.0

    def feed(self, pcm):
        """Append a block of 16 kHz mono samples (int16 or float).  The
        block is COPIED: live-capture callbacks reuse their buffer."""
        if self._finalized is not None:
            raise RuntimeError("feed() after finalize()")
        pcm = np.asarray(pcm)
        kind = np.int16 if pcm.dtype == np.int16 else np.float32
        if self._dtype is None:
            self._dtype = kind
            self._use_stream = kind == np.int16 and self._stream_eligible()
            if self._use_stream:
                self._stream = VbxPcmStreamOnline(self.vfs.features)
        elif kind != self._dtype:
            raise TypeError("feed dtype changed mid-stream")
        if self._use_stream:
            self._stream.append(pcm)
            # the PCM is kept only until one analysis window exists (a
            # shorter finalize takes the offline path and its errors);
            # past that the stream owns the samples
            if self._total < 400:
                self._parts.append(np.array(pcm, dtype=self._dtype,
                                            copy=True))
            elif self._parts:
                self._parts = []
        else:
            self._parts.append(np.array(pcm, dtype=self._dtype, copy=True))
        self._total += len(pcm)
        self.vad_online.feed(pcm)
        return self

    def _stream_eligible(self):
        """Whether the int16 VBx grid serves this scorer incrementally."""
        return (vbx.vbx_i16_enabled(self.vfs.device)
                and isinstance(self.vfs.features, VbxFrontend)
                and isinstance(self.vfs.xvector_model, TorchResnetExtractor))

    @property
    def buffered_samples(self):
        """Raw samples currently held."""
        return sum(len(p) for p in self._parts)

    def _signal(self):
        return (np.concatenate(self._parts) if self._parts
                else np.zeros(0, self._dtype or np.float32))

    def _frames_now(self):
        # VBx frame count of the mirror-padded signal (+120 front,
        # +200 back, 400-sample windows at 160-hop)
        n = self._total + 320
        return (n - 400) // 160 + 1 if n >= 400 else 0

    def _final_starts(self, frames):
        """Window starts whose features are FINAL at `frames`: the window
        plus the CMVN right context is behind the frontier (minus the
        mirror-tail guard), and enough frames exist that the stream
        head's CMVN window is saturated."""
        from .vfs import STEP, WINLEN

        if frames < LC + RC + 1 + self.TAIL_GUARD:
            return []
        horizon = frames - RC - self.TAIL_GUARD
        return [s for s in range(0, frames - WINLEN, STEP)
                if s + WINLEN <= horizon]

    def current(self):
        """Provisional (score | None, speech_duration_s, n_xvectors)."""
        if self._finalized is not None:
            return self._finalized
        timeline = SpeechTimeline.from_vad(self.vad_online.current())
        speech_dur = timeline.total_duration()
        if not speech_dur:
            return None, speech_dur, 0

        def seg_of(s):
            return (round(s / 100.0, 3), round(s / 100.0 + WINLEN / 100.0, 3))

        if self._use_stream:
            # every window behind the stream's final-feature frontier (the
            # block grid already holds the CMVN context back)
            fr = self._stream.frames_ready
            starts = list(range(0, max(fr - WINLEN + 1, 0), STEP))
        else:
            starts = self._final_starts(self._frames_now())
        in_speech = [s for s in starts
                     if timeline.contains_point(
                         (seg_of(s)[0] + seg_of(s)[1]) / 2)]
        new = [s for s in in_speech if s not in self._emb]
        # batch the expensive part: embed only when enough NEW windows
        # accumulated (or none were ever embedded)
        if new and (len(new) >= self._min_new or not self._emb):
            if self._use_stream:
                # final rows of the stream's features: no recompute
                fea = self._stream.fea_buffer
            else:
                sig = self._signal()
                if self._fea is None or len(sig) != self._fea_len:
                    signal64 = (sig.astype(np.float64) / 32768.0
                                if self._dtype == np.int16
                                else np.asarray(sig, np.float64))
                    self._fea = self.vfs.features.features(signal64)
                    self._fea_len = len(sig)
                fea = self._fea
            embs = self.vfs.xvector_model.embeddings_from_features(
                fea, np.asarray(new, np.int64))
            for s, e in zip(new, embs):
                # NaN embeddings recorded as None: never retained, never
                # re-embedded (the canonical extractor drops them too)
                self._emb[s] = None if np.isnan(e).any() else e
        # scoring inputs are fully determined by the VAD timeline and the
        # (grow-only) embedding store: between changes the MLP is skipped
        key = (tuple(timeline.intervals), len(self._emb))
        if self._cur is None or self._cur[0] != key:
            xv = [(f"{self.basename}_{s:08}-{s + WINLEN:08}", seg_of(s),
                   self._emb[s] * 10) for s in starts
                  if self._emb.get(s) is not None]
            self._cur = (key, self.vfs._score_xvectors(xv, timeline,
                                                       speech_dur))
        return self._cur[1]

    def finalize(self):
        """Canonical scoring of the full signal, ``vfs.score_signal``'s.
        Idempotent; an empty stream returns (None, 0.0, 0)."""
        if self._finalized is not None:
            return self._finalized
        if self._total == 0:
            self._finalized = (None, 0.0, 0)
        elif self._use_stream and self._total >= 400:
            self._finalized = self._finalize_stream()
        else:
            self._finalized = self.vfs.score_signal(self._signal(),
                                                    self.basename)
        return self._finalized

    def _finalize_stream(self):
        """The offline result from the stream's state: its features equal
        the offline ones bit for bit; cached embeddings are reused and the
        windows missing embed in one catch-up batch."""
        timeline = SpeechTimeline.from_vad(self.vad_online.finalize())
        speech_duration = timeline.total_duration()
        if not speech_duration:
            return None, speech_duration, 0
        fea = self._stream.finalize()
        xm = self.vfs.xvector_model

        def cache_then_catch_up(fea_final, needed):
            # a window cached as NaN is embedded again, as offline
            done = {s: e for s, e in self._emb.items() if e is not None}
            missing = [s for s in needed if s not in done]
            done.update(zip(missing, xm.embeddings_from_features(
                fea_final, np.asarray(missing, np.int64))))
            return [done[s] for s in needed]

        x_vectors = xm(self.basename, fea, self._total / 16000.0,
                       timeline=timeline, embed=cache_then_catch_up)
        return self.vfs._score_xvectors(x_vectors, timeline, speech_duration)
