#!/usr/bin/env python3
"""Smoke run of the PyTorch port (inaspeechsegmenter_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one NVIDIA H100 and nvcc.
Phases, each fatal on failure (non-zero exit, no final line):

0. the card (nvidia-smi name and power limit); build the CUDA kernels from
   ``inaspeechsegmenter_tpu_torch/csrc`` and print the build time;
1. each kernel against its plain PyTorch version on the card, at the main
   path's shapes: features on 60 s and 10 min seeded signals with digital
   silence (int16 and float32; finite masks equal, mspec within rtol/atol
   1e-4, loge within 1e-5), on one group-shaped int16 slice of the 10 min
   signal ((3*4096 + 2)*160 samples, the streaming path's launch) within
   the same tolerance, and every group launch of the 10 min signal
   bit-equal to the same rows of its whole-file launch; Viterbi at K=2 and
   K=3 on random, reset-heavy and never-coalescing (constant) emissions
   (states equal; the constant case is compared at T = 20000, where the
   plain loop is affordable, and timed like the others at T = 180000), and
   with the online suffix decode's near-one-hot initial vector (states
   equal).  Kernel and plain times and the Viterbi's pass counts and walked
   chunks are printed.  The CNN blocks' epilogue (``csrc/cnn_epilogue.cu``)
   at each block of the full-width VAD and gender CNNs at 1,024 patches:
   bit-equal to its plain version, its device ms, bound and plain ms, 4
   launches a forward, and its launches for a 10 min file
   (``python3 chip_smoke.py --cnn-epilogue`` runs the build and this part
   alone).  From here on every counted run of every phase holds the
   epilogue to 4 launches a forward on the card of a CNN with fused
   blocks (``CNN_FORWARDS`` counts those forwards, in the child
   processes too);
2. the main path: full-width synthetic weights (seeded), ``Segmenter("smn",
   detect_gender=True, ffmpeg=None, device="cuda")``, the prefetched
   ``batch_process`` of three WAVs (2 s of silence, a 60 s and a 10 min
   seeded mix).  Checks the golden silence csv, the csv header, that
   segments tile each file, that both kernels were launched by that run,
   and that the 60 s labels agree with the port on ``device="cpu"`` on >=
   99.9% of frames.  Prints the batch wall time and real-time factor at the
   default prefetch depth, the warm batch's wall time at depth 1 and at the
   default depth in turns, per-file wall time and real-time factor; the
   warm 10 min file's stage split (median of 5); its three decodes and its
   features kernel timed alone with CUDA events (T, K, passes and walked
   chunks of each decode); and the kernel launches per file;
3. voice femininity scoring: a full-width ``ResNet101XVector`` (random
   weights from seed 0, saved as ``raw_81.npz``) and the synthetic MLP,
   ``VoiceFemininityScoring("bgc", ffmpeg=None, device="cuda")``, the
   prefetched ``batch_score`` of phase 2's three WAVs (batch wall time and
   real-time factor printed, and the warm batch at depth 1 and at the
   default depth in turns).  Checks the csv header, the silence golden
   row, that each mix's speech_duration equals the VAD's speech total with
   nb_vectors > 0 and 0 <= score <= 1, and that both kernels were launched
   by that run; then cuda against cpu on the first 15 s of the 60 s mix:
   VBx features within ``dsp.vbx.device_atol``, ResNet101 embeddings of the
   same windows within a relative L2 error of 1e-3, MLP probabilities
   within 1e-4, and the end-to-end result equal when the two VAD timelines
   are.  Prints, for the warm 10 min file, wall time, RTF, the stage split,
   windows/s, ms per 256-window sub-batch, the ResNet's TFLOP/s and the
   peak device memory;
4. online and streaming, with phase 2's full-width Segmenter and phase 3's
   scorer: ``pipeline.run_streaming`` against ``pipeline.run`` on the 10
   min mix's features (frames that differ, at most 0.1%; warm times);
   ``OnlineSegmenter`` fed the 10 min int16 mix in 0.5 s blocks with
   ``current()`` polled after each (median and maximum poll time with a
   device sync, commits and forced commits, the longest provisional
   decode, ``finalize()`` against ``segment_signal`` with at most 0.1% of
   frames differing, kernel launches per online file); ``follow_wav`` on
   the 60 s mix written into a growing WAV by a writer thread (at most
   0.1% of frames differing from ``seg(wav)``); ``OnlineVFS`` on the 60 s
   mix (``finalize()`` equal to ``score_signal`` when the online and
   offline VAD timelines are equal); and the force-commit disagreement: a
   15 min mix with no inserted silence, ``COMMIT_MAXBACK = 16``, the frames
   of the committed prefix that differ from ``finalize()`` and the forced
   commits; (b) the streaming switch: ``segment_signal`` on the 60 s and
   10 min mixes fused (``ISS_STREAMING=0``), streamed (``=1``) and
   streamed with the gender emissions a chunk (``ISS_STREAM_GENDER=1``),
   in 3 turns (warm walls; 0 frames may differ from fused; launches
   against the routing: one features launch a file fused, one an upload
   group streamed, 3 K <= 3 decodes), the VFS tuple of the 10 min mix
   with ``ISS_STREAMING=1`` equal to the fused VAD's, and
   ``OnlineSegmenter`` over the 10 min mix under ``ISS_STREAMING=0`` (a
   passthrough) and under ``ISS_STREAM_GENDER=1``: ``finalize()`` equal
   to ``segment_signal``'s labels;
5. real inputs: (a) the full-width synthetic set written as Keras ``.hdf5``
   files (the Keras 2 layout, by ``tests/torch_parity_helpers.write_h5``,
   numpy only) and the Segmenter and VFS scorer built from them: the
   ``.hdf5`` files resolved, the npz conversion cache written and taken by
   a second construction (both construction times printed), weights
   bit-equal to phases 2-3's npz route, the 10 min labels and VFS tuple
   equal; (b) ``ISS_CNN_PRECISION`` ``highest`` / ``high`` / ``bf16`` on
   the warm 10 min file (wall, VAD and gender CNN ms, frames whose label
   differs from ``highest``; CNN probabilities within 2e-2 of ``highest``
   and not bit-equal to them) and ``ISS_XVEC_PRECISION`` on the ResNet
   over the 10 min file's windows (windows/s, TFLOP/s, relative L2 error
   of the embeddings against ``highest``: at most 1e-2 for ``high`` and
   5e-2 for ``bf16``, and not bit-equal), ``batch_score`` of phase 2's
   WAVs with the ResNet at ``high`` (the producer threads' VAD and VBx
   features bit-equal to a serial run's, the TF32 flags as before), then
   ``ISS_XVEC_TAIL=exact`` once; (c) media decode through ffmpeg on the
   card: a stand-in ``ffmpeg`` on ``PATH`` (the port's WAV reader and
   numpy) decodes a
   44.1 kHz stereo copy of the 60 s mix for ``Segmenter(...,
   ffmpeg="ffmpeg")``, whole and windowed by ``start_sec`` / ``stop_sec``:
   segments tile each window and both kernels are launched; an unknown
   binary raises "ffmpeg program not found";
6. the rest of the reference API: (a) the int16 VBx grid on the 10 min
   mix (its features against the f32 path's within the f32 bound, the f32
   path's host half against the grid's host work and its one-time dither
   growth, the blocked features' device ms, the VFS tuple equal on both
   paths, a ``VbxPcmStream`` fed in uneven pieces and the shared-PCM route
   bit-equal to ``_features_i16``, the VFS stage split on the grid); (b)
   the ResNet over all the 10 min mix's windows with the tail bucket
   (windows/s against phase 3's speech-window rate, the padded tail
   sub-batch's ms against the ragged one's and a full one's); (c)
   ``OnlineVFS`` over the 10 min mix in 0.5 s blocks (poll median and max,
   no PCM kept past 400 samples, ``finalize()`` equal to
   ``score_signal``); (d) the general-K Viterbi through
   ``viterbi_decoding`` (``consecutive=10`` on 3 states, K = 30, and K = 8
   with forbidden and mandatory frames and resets, T = 180,000, states
   equal to the plain run), then the kernel alone against its plain
   version on three inputs at T = 180,000 (the K = 30 expansion, which
   never converges; the K = 8 constrained decode's kernel inputs; a random
   dense K = 30 decode): states equal, ms, plain ms, passes, walked
   chunks, the device clock's part times and bound of each; (e) ``DnnSegmenter.__call__`` of the smn
   and gender stages on the 60 s mix, cuda against cpu (at most 0.1% of
   frames differing; whether the lseg are equal is printed); (f) a 44.1
   kHz PCM16 WAV with ``ffmpeg=None`` through the native resampler (built
   with the host C++ compiler), the frames differing from the 16 kHz
   labels printed;
7. train, score, farm: (a) the 10 min mix segmented by phase 2's
   Segmenter and exported as csv; ``train.patch_dataset`` of it on cuda
   (seconds, patches, one features launch) against the cpu dataset
   (patches within 1e-4, labels equal); a ``Trainer`` on the full-width
   smn CNN at ``highest``, batch 256: the first 3 steps' losses against
   the cpu trainer's on the same batches (rtol 1e-3), then 60 steps in
   all (ms a step, patches/s, peak memory; the loss must fall), 5 more
   under ``torch.profiler`` (the device's busy share, the top kernels), a
   held-out accuracy; ``export_model`` into a fresh model directory, a
   cuda ``Segmenter`` built from it without the synthetic warning, serving
   the 60 s mix; (b) that csv against the cpu Segmenter's with
   ``eval.evaluate`` (at most 0.1% of frames differing) and with
   ``cli.evaluate``; (c) a ``JobServer`` over phase 2's WAVs (duplicate
   rows in its csv) drained by ``client_work_loop`` with phase 2's
   Segmenter (csvs byte-equal to phase 2's, wall time), a second run that
   skips every file, and one ``--vfs`` job through ``cli.client`` on the
   60 s mix (its row equal to phase 3's);
8. the multi-GPU engine on every visible card; one card gives the testing
   form of a mesh, two slots on ``cuda:0`` (the trainer's 2 x 2: four
   slots on it); the mesh's slot and distinct-device counts are printed.
   (a) ``ParallelEngine.batch_process`` of phase 2's three WAVs: csvs
   byte-equal to phase 2's, launches as the routing predicts (a corpus
   runs each file on the per-file path: one features launch and three
   decodes a file), warm walls in turns with ``Segmenter.batch_process``;
   (b) ``ParallelEngine.__call__`` of the 10 min mix through
   ``run_sharded``: 0 of 29,999 frames differ from the fused ``run``, one
   features launch and the tail's three decodes, warm walls in turns with
   ``seg(wav)``; (c) ``VoiceFemininityScoring(mesh=)`` on the 10 min mix:
   the result tuple equal to phase 3's scorer's, the embeddings of every
   window within 1e-3 relative L2 of the one-device extractor's, windows/s
   of both in turns; (d) the full-width smn CNN trainer at batch 256 on
   the 10 min mix's dataset, 1 x 1, 2 x 1 and 2 x 2 (the ``fc1`` kernel
   split over the model axis), 10 steps each at ``highest``: ms a step
   and the free-running losses against the 1 x 1 trainer's (printed:
   Adam amplifies float reassociation from step to step); then 10 steps
   each from the 1 x 1 trainer's state (its checkpoint restored on the
   mesh before every step), each step classified by the ReLU and max-pool
   decisions of its two forwards (``mesh_step``): a step without a
   flipped decision passes with its loss within 1e-5 relative and each
   summed gradient within 1e-4 of the array's largest magnitude, a step
   with flips only when every flip is a tie (gap under 1e-6), each
   array's relative L2 error is at most 1e-3 and the loss is within
   1e-5; the count of flipped steps and their worst values are printed
   (``--mesh-step-repeats N`` runs this comparison N times a mesh); (e) the
   features kernel (10 min int16 signal) and the K = 3 Viterbi (T =
   180,000) launched at once from the two slots' threads on their own
   streams, each held against its plain version (phase 1's tolerances;
   states equal), then two launches of each timed on one stream and on two
   streams;
9. the overlapped speculative VFS scorer (``ISS_VFS_OVERLAP=1``; the
   default ``auto`` takes the serial schedule, which phases 3 and 6 time):
   (a) the 60 s and 10 min mixes through ``score_signal`` on the default
   and the overlapped schedule in turns, 3 pairs each: tuples equal, each
   wall, the windows dispatched, needed and caught up, the extras as a
   share of the needed windows; the launches of one run of each against
   the route (overlapped: one features launch a group, 2 Viterbi launches
   for each chunk with a right neighbour and the final decode's 2;
   serial: 1 and 2); the raw x-vectors that the overlapped run's
   ``_EmbedSession.collect`` returns on the 10 min mix against the
   extractor's own on the same starts (relative L2 per window within
   ``XVEC_REL_LIMIT``; each window one step on lies farther off than the
   limit, so a misplaced window fails); (b) one overlapped run with
   ``torch.cuda.set_sync_debug_mode("error")`` from its first upload to
   the exact decode (no host sync); (c) one run of each schedule under
   ``torch.profiler`` (wall, device busy ms and share); (d) ``__call__``
   on the 10 min WAV on both schedules, ``OnlineVFS`` over the 60 s mix
   in 2 s blocks (``finalize()`` equal to ``score_signal``), and one
   overlapped call of ``vbx_segmenter.VoiceFemininityScoring`` on the 60 s
   WAV;
10. the installed package: (a) the checkout's wheel (``pip wheel --no-deps
   --no-build-isolation``, then ``pip install --no-deps --no-index
   --target``; a host without setuptools fails the phase), the wheel and
   the setuptools version printed; the constructor guard's probe
   (``utils.env.probe_device``, 3 walls) and ``nvcc``'s release line as
   the kernel cache's scope reads it; (b) ``tools.prewarm`` run from the
   install (``PYTHONPATH`` the target only, the working directory outside
   the checkout, an empty ``ISS_TORCH_BUILD_DIR``): the package imported
   from the target, the cold kernel build's seconds; (c) the installed
   ``ina_speech_segmenter_torch`` console script (``-b none``, the default
   device) on the 60 s and 10 min WAVs, plain (the first-request wall;
   the 10 min WAV with the constructor guard and without it,
   ``ISS_CTOR_LINK_WAIT=0``, in turns, two of each), then once with
   ``ISS_TRACE_DIR`` set: csvs byte-equal to phase
   2's, the build directory's files and mtimes unchanged (nothing
   rebuilt), both path kernels named in each trace, each wall printed;
   (d-g) one runner process on the install: its start-up split (the
   interpreter, the ``torch`` import, the port's import, the constructor
   guard cold and latched, the CUDA context,
   the Segmenter's construction, the first 10 min file), the 10 min
   WAV's kernel launches (1 features, 3 K <= 3 Viterbi, 0 general), phase
   6(f)'s 44.1 kHz WAV without ffmpeg (labels equal to 6(f)'s, the native
   library built from the package's source into that build directory), 16
   two-second WAVs through one Segmenter (``memory_allocated`` after the
   second 8 within 1 MiB of its value after the first 8,
   ``max_memory_allocated`` printed) and ``tools.verify_weights
   --report-only`` over phase 5's ``.hdf5`` set with the x-vector npz
   (exit 0, every file's forward PASS) and over phase 2's synthetic set
   (each stand-in reported as synthetic);
11. the upload codec and the frontend choice: (a) both decode kernels
   (``csrc/codec.cu``) bit-equal to their plain versions and to the
   source on the 10 min mix's five upload groups, the groups of an
   elide-route signal (full-scale noise with 4 s of digital silence in
   each 3-chunk group), one block at each width 0..16 and order, an
   all-zero group and 20 fuzzed signals, each at its ``pack_best`` route
   and both forced, and on the timed inputs; at three sizes (a 3-chunk
   group of 6,145 blocks, the whole-file VBx slices of the 10 min mix and
   of a seeded 1 h mix, ~30,000 and ~180,000 blocks) each decoder's
   device time (``device_ms``: ``torch.profiler`` kernel durations over
   distinct buffers that exceed the L2 twice over), call time (CUDA
   events over back-to-back wrapper calls), the no-op kernel floor and
   the bound; the plain version's ms at the 3-chunk group;
   (b) with ``ISS_UPLOAD_CODEC=1``: ``batch_process`` of the 60 s, 10 min
   and elide WAVs, csvs byte-equal to the codec-off run; each file once
   more, counted: bytes shipped equal to ``group_shipped_bytes`` (ratio
   printed), decode launches as ``pack_best``'s route, host encode ms a
   group; warm walls codec on and off in turns (the ``auto`` decision);
   ``vfs(mix60)`` tuple, VBx features and x-vectors equal to the codec-off
   run; the ``OnlineSegmenter``'s finalize over the 10 min mix equal to
   its codec-off finalize (and to ``segment_signal`` on >= 99.9% of the
   frames); (c) ``ISS_FRONTEND=host`` on the 60 s and 10 min WAVs (frames
   differing from the kernel frontend's, at most 0.1%), ``vfs(mix60)``
   with the host frontend, the link probe's MB/s and what ``auto`` takes
   on this host;
12. multi-host on one card: two rank processes (each with its own
   timeout) join one ``gloo`` process group on 127.0.0.1 through
   ``parallel.init_multihost`` (NCCL refuses two ranks on one card); an
   ``all_reduce`` of the ranks sums to 1; rank r segments phase 2's 60 s
   (r = 0) or 10 min (r = 1) WAV on the card into a csv byte-equal to
   phase 2's ``batch_process`` csv, with one features launch and three
   decodes.  A failure in any rank fails the run.

Each kernel's row times it twice: ``device_ms``, its own device time
(``torch.profiler``'s kernel durations over distinct inputs that together
exceed the L2 cache twice over, so no call finds its inputs there; where
three profiler windows each miss some of the launches, CUDA events around
each call after a spinning kernel, and ``device_by`` says which) and
``call_ms``, CUDA events around back-to-back wrapper calls on one input
(the host's launch cost shows there when the kernel is short);
``floor_ms`` is a near-empty kernel's device time under the same measure.

The lines before the last are a JSON object of the kernels (launches
summed over the main-path runs of phases 2-12, launches per file for
segmentation, VFS, the online segmenter, the ffmpeg decode, each run
of phase 6, phase 7's train and farm paths, phase 8's engine batch,
sharded file and mesh VFS runs, phase 9's runs of each schedule,
phase 10's installed 10 min file, phase 11's codec runs, phase 4(b)'s
fused and streamed runs and phase 12's ranks,
``bound_ms``: the larger of the bytes over 3.35 TB/s and the operations
over 67 TFLOP/s fp32) and the card's name and power limit; the last line
is the JSON result.  Every time is on the card that line names.  Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 16000
FEATURE_SECONDS = (60, 600)
VITERBI_T = 180_000
VITERBI_T_CONSTANT = 20_000   # the plain loop's length on the worst case
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM, fp32 outside the tensor cores


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError("check failed: " + msg)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def seeded_mix(seconds, seed, silences=()):
    """float32 signal: noise under a syllable-rate envelope plus a tone,
    level changing every half second (a quarter of the sections 40-50 dB
    down), with stretches of exact digital silence."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    sig = np.zeros(n)
    sec = SR // 2
    for s0 in range(0, n, sec):
        m = slice(s0, min(n, s0 + sec))
        k = m.stop - m.start
        level = 10 ** (rng.uniform(-2.5, -2.0) if rng.random() < 0.25
                       else rng.uniform(-0.6, 0.0))
        am = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 8) * t[m]
                                + rng.uniform(0, 2 * np.pi))
        tone = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t[m])
        sig[m] = level * (am * rng.standard_normal(k) + tone)
    for a, b in silences:
        sig[int(a * SR):int(b * SR)] = 0.0
    return (0.2 * sig).astype(np.float32)


def to_int16(sig):
    return np.clip(np.rint(sig * 32768.0), -32768, 32767).astype(np.int16)


def silences_every(seconds, period=20.0):
    """A 1 s silence, a 0.3 s island, a 0.7 s silence every ``period``."""
    out = []
    for a in np.arange(5.0, seconds - 3.0, period):
        out += [(a, a + 1.0), (a + 1.3, a + 2.0)]
    return out


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps, torch):
    """Mean device time of ``fn`` over ``reps`` launches (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


L2_ROTATE_BYTES = 100e6   # twice the H100's 50 MB L2: no call finds its
                          # inputs there after the other calls' traffic


def rotation(n_bytes):
    """Distinct copies of a call's inputs and outputs (``n_bytes`` a copy)
    that together exceed the L2 cache twice over (at least 2)."""
    return max(2, -(-int(L2_ROTATE_BYTES) // max(1, int(n_bytes))))


def profiler_ms(torch, calls, names, rounds):
    """``calls`` run ``rounds`` times in turn under ``torch.profiler`` ->
    the summed device durations of the kernels whose names contain one of
    ``names`` over the number of calls, or None unless the window holds
    each such kernel once a call (in a long process the profiler now and
    then records none, or only some, of a window's kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for fn in calls:
                fn()
        torch.cuda.synchronize()
    hits = [(e.self_device_time_total, e.count, e.key[:50])
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and any(n in e.key for n in names)]
    n_calls = rounds * len(calls)
    if not hits or any(count != n_calls for _, count, _ in hits):
        log(f"[kernels] profiler window: {[h[1:] for h in hits]} for "
            f"{n_calls} calls")
        return None
    return sum(h[0] for h in hits) / 1e3 / n_calls


SPIN_CYCLES = 400_000   # ~0.2 ms of a spinning kernel: the card is busy
                        # while the host enqueues the timed call


def events_ms(torch, calls, rounds):
    """``calls`` run ``rounds`` times in turn, each between two CUDA events
    and after a spinning kernel that keeps the card busy while the host
    enqueues the events and the call, so the pair brackets the call's
    kernels and not the host's launch -> mean ms a call."""
    pairs = []
    for _ in range(rounds):
        for fn in calls:
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in pairs]))


def device_ms(torch, calls, names, rounds=3):
    """A kernel's own device time a call: ``calls`` (closures over distinct
    buffers, ``rotation`` of them) after a warm-up, by ``profiler_ms``
    (kernel durations by name; up to three windows) or, where no window
    holds every launch, by ``events_ms``.  The launch cost on the host and
    the wrapper's work are not in it (``cuda_ms`` is the call time).
    -> (ms, "profiler" | "events")."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        ms = profiler_ms(torch, calls, names, rounds)
        if ms is not None:
            return ms, "profiler"
    log(f"[kernels] device_ms: no complete profiler window of {names} in "
        f"3; timed by events")
    return events_ms(torch, calls, rounds), "events"


_FLOOR = {}


def floor_ms(torch, by):
    """The device time of a kernel that does next to nothing (``zero_`` of
    a one-element tensor: one thread stores 4 bytes) measured ``by`` the
    profiler or by events, as ``device_ms`` measured the row beside it:
    the least that a row can read.  Measured once a run and a measure."""
    if by not in _FLOOR:
        one = torch.empty(1, device="cuda")
        calls = [one.zero_] * 100
        if by == "profiler":
            ms, got = device_ms(torch, calls, ("",))
            _FLOOR[got] = ms
            by = got
        else:
            _FLOOR[by] = events_ms(torch, calls, 3)
        log(f"[kernels] no-op kernel floor by {by}: {_FLOOR[by]!r} ms")
    return _FLOOR[by]


def timing(torch, calls, names, call_fn, reps, rounds=3):
    """``device_ms`` over ``calls`` and ``cuda_ms`` of ``call_fn`` ->
    {"device_ms", "device_by", "call_ms", "floor_ms"}."""
    dev_ms, by = device_ms(torch, calls, names, rounds)
    return {"device_ms": dev_ms, "device_by": by,
            "call_ms": cuda_ms(call_fn, reps, torch),
            "floor_ms": floor_ms(torch, by)}


# --------------------------------------------------------------------------
def phase_features(torch, dev):
    from inaspeechsegmenter_tpu_torch.dsp import fe_kernel, sidekit

    consts = sidekit.frontend_consts(dev)
    worst = 0.0
    times = {}

    def compare(x, label):
        """Kernel against plain on ``x`` -> (max_abs_err, kernel_ms,
        plain_ms, T)."""
        mk, lk = fe_kernel.sidekit_features(x, consts)
        torch.cuda.synchronize()
        mp, lp = fe_kernel.sidekit_features_plain(x, consts)
        torch.cuda.synchronize()
        mk, lk, mp, lp = (a.cpu().numpy() for a in (mk, lk, mp, lp))
        t = sidekit.frame_count(x.shape[0])
        check(mk.shape == mp.shape == (t, 24) and lk.shape == (t,),
              f"feature shapes {mk.shape} {mp.shape}")
        fin = np.isfinite(mp)
        check(np.array_equal(np.isfinite(mk), fin),
              f"mspec finite mask differs ({label})")
        check(np.array_equal(np.isfinite(lk), np.isfinite(lp)),
              f"loge finite mask differs ({label})")
        check(fin.any() and not fin.all(),
              "the test signal has silent and non-silent frames")
        check(np.allclose(mk[fin], mp[fin], rtol=1e-4, atol=1e-4),
              f"mspec differs ({label})")
        finl = np.isfinite(lp)
        check(np.allclose(lk[finl], lp[finl], rtol=1e-5, atol=1e-5),
              f"loge differs ({label})")
        err = max(float(np.abs(mk[fin] - mp[fin]).max()),
                  float(np.abs(lk[finl] - lp[finl]).max()))
        ms = cuda_ms(lambda: fe_kernel.sidekit_features(x, consts), 20,
                     torch)
        plain_ms = cuda_ms(
            lambda: fe_kernel.sidekit_features_plain(x, consts), 20, torch)
        log(f"[kernels] sidekit_fe {label}: T={t} max_abs_err={err!r} "
            f"kernel_ms={ms!r} plain_ms={plain_ms!r}")
        return err, ms, plain_ms

    arrays = {}
    for seconds in FEATURE_SECONDS:
        base = seeded_mix(seconds, seed=seconds,
                          silences=silences_every(seconds))
        for name, arr in (("int16", to_int16(base)), ("float32", base)):
            arrays[(seconds, name)] = arr
            err, ms, plain_ms = compare(torch.from_numpy(arr).to(dev),
                                        f"{seconds} s {name}")
            worst = max(worst, err)
            times[(seconds, name)] = (ms, plain_ms)

    # the streaming and online path's launch: one group of chunks
    arr = arrays[(FEATURE_SECONDS[-1], "int16")]
    fe = fe_kernel.KernelSidekitFrontend(dev)
    group = fe_kernel.upload_chunks()
    raw = arr[:(group * sidekit.CHUNK + 2) * sidekit.HOP]
    err, _, _ = compare(torch.from_numpy(raw).to(dev),
                        f"group of {group} chunks, int16")
    worst = max(worst, err)
    chunks, t = fe.mspec_loge_chunks(arr)
    whole_m, whole_l, _ = fe.mspec_loge(arr)
    m = torch.cat([c[0] for c in chunks])[:t]
    lg = torch.cat([c[1] for c in chunks])[:t]
    n_diff = int((m != whole_m).sum()) + int((lg != whole_l).sum())
    log(f"[kernels] sidekit_fe group launches of the {FEATURE_SECONDS[-1]} s "
        f"int16 signal ({len(chunks)} chunks): {n_diff} values differ from "
        "the whole-file launch's rows")
    check(n_diff == 0, "group rows are not bit-equal to whole-file rows")
    _, plain_ms = times[(FEATURE_SECONDS[-1], "int16")]
    bound_ms, bound_by = features_bound(FEATURE_SECONDS[-1] * SR, 2, consts)
    t = sidekit.frame_count(len(arr))
    copies = [torch.from_numpy(arr).to(dev)
              for _ in range(rotation(arr.nbytes + t * 25 * 4))]
    tm = timing(torch, [lambda x=x: fe_kernel.sidekit_features(x, consts)
                        for x in copies], ("sidekit_fe_kernel",),
                lambda: fe_kernel.sidekit_features(copies[0], consts), 20)
    log(f"[kernels] sidekit_fe {FEATURE_SECONDS[-1]} s int16 (T={t}): "
        f"device_ms={tm['device_ms']!r} ({tm['device_by']}) over "
        f"{len(copies)} distinct signals, call_ms={tm['call_ms']!r}, "
        f"floor_ms={tm['floor_ms']!r}, bound_ms={bound_ms!r} ({bound_by})")
    return {"name": "sidekit_fe", "route": "cuda",
            "source": "inaspeechsegmenter_tpu_torch/csrc/sidekit_fe.cu",
            "replaces": "inaspeechsegmenter_tpu/dsp/pallas_fe.py:188",
            "max_abs_err": worst, "ms": tm["device_ms"], **tm,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library_note": "no single PyTorch call computes the function",
            "size": f"600 s int16 signal, {t} frames"}


def features_bound(n_samples, sample_bytes, consts):
    """Signal read once, 25 floats a frame written once; per frame the
    FFT's operations: a 256-point complex radix-2 FFT (5 N log2 N), the
    split (about 12 per bin), pre-emphasis and window (3 per sample), the
    energy (2 per sample), the power (3 per bin), the mel bands (2 per
    nonzero filter bin) and 25 logs."""
    from inaspeechsegmenter_tpu_torch.dsp.sidekit import frame_count

    t = frame_count(n_samples)
    nnz = int((consts.band_range[:, 1] - consts.band_range[:, 0]).sum())
    per_frame = 5 * 256 * 8 + 12 * 257 + 3 * 400 + 2 * 400 + 3 * 257 \
        + 2 * nnz + 25
    return bound(n_samples * sample_bytes + t * 25 * 4, t * per_frame)


def viterbi_args(torch, dev, K, kind, T):
    """Seeded decode inputs: ``random`` and ``resets`` Dirichlet emissions
    with 0.1% and 30% resets; ``constant`` emissions whose score gaps grow
    by 1e-5 a frame and never reach the transition cost, with no reset:
    no chunk of the kernel forgets its entry (its worst case)."""
    from inaspeechsegmenter_tpu_torch.decode.transitions import diag_trans_exp

    rng = np.random.default_rng(100 * K + {"random": 1, "resets": 300,
                                           "constant": 7}[kind])
    if kind == "constant":
        em = np.tile(np.log(1.0 / K) - 1e-5 * np.arange(K), (T, 1))
        reset = np.zeros(T, bool)
    else:
        em = np.log(rng.dirichlet(np.ones(K), T))
        reset = rng.random(T) < (0.001 if kind == "random" else 0.3)
    reset[0] = True
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        em.astype(np.float32), diag_trans_exp(0.7, K).astype(np.float32),
        np.full(K, np.log(1.0 / K), np.float32), reset)]


def viterbi_bound(T, K):
    """Emissions and reset flags read once, states written once; about
    2K^2 + 2K adds and compares a frame."""
    return bound(T * K * 4 + T + T * 4 + (K * K + K) * 4,
                 T * (2 * K * K + 2 * K))


def phase_viterbi(torch, dev):
    from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
    from inaspeechsegmenter_tpu_torch.decode.transitions import log_trans_exp

    out = {}
    worst = 0
    for K in (2, 3):
        for kind in ("random", "resets", "constant"):
            # the plain loop of a case that never coalesces is compared at
            # a shorter length; every case is timed at VITERBI_T
            t_cmp = VITERBI_T if kind != "constant" else VITERBI_T_CONSTANT
            args = viterbi_args(torch, dev, K, kind, VITERBI_T)
            cmp_args = viterbi_args(torch, dev, K, kind, t_cmp)
            states_k = tv.viterbi_scan(*cmp_args)
            torch.cuda.synchronize()
            cmp_counts = tv.pass_count(), tv.walked_chunks()
            t0 = time.perf_counter()
            states_p = tv.viterbi_scan_plain(*cmp_args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            sk = states_k.cpu().numpy().astype(np.int64)
            sp = states_p.cpu().numpy().astype(np.int64)
            worst = max(worst, int(np.abs(sk - sp).max()))
            n_diff = int((sk != sp).sum())
            check(n_diff == 0, f"viterbi K={K} {kind}: {n_diff} states differ "
                               "from the plain version")
            if kind != "constant":
                check(len(np.unique(sp)) == K, "the decode visits every state")
            ms = cuda_ms(lambda: tv.viterbi_scan(*args), 5, torch)
            passes, walked = tv.pass_count(), tv.walked_chunks()
            log(f"[kernels] viterbi K={K} {kind}: states equal at T={t_cmp} "
                f"(passes, walked chunks: {cmp_counts}), T={VITERBI_T}: "
                f"kernel_ms={ms!r} passes={passes} walked_chunks={walked} "
                f"plain_ms(T={t_cmp})={plain_ms!r}")
            out[(K, kind)] = (ms, plain_ms, passes)
    # the online suffix decode's energy initial vector: log(1e-200) off
    # the committed state, 0 on it; energy transitions, one reset
    em, _, _, _ = viterbi_args(torch, dev, 2, "random", VITERBI_T)
    trans = torch.from_numpy(
        log_trans_exp(150, cost0=-5).astype(np.float32)).to(dev)
    reset = torch.zeros(VITERBI_T, dtype=torch.bool, device=dev)
    reset[0] = True
    for state in (0, 1):
        init = np.full(2, np.log(1e-200), np.float32)
        init[state] = 0.0
        init = torch.from_numpy(init).to(dev)
        sk = tv.viterbi_scan(em, trans, init, reset)
        torch.cuda.synchronize()
        passes_1h = tv.pass_count()
        sk = sk.cpu().numpy().astype(np.int64)
        sp = tv.viterbi_scan_plain(em, trans, init, reset).cpu().numpy()
        n_diff = int((sk != sp).sum())
        worst = max(worst, int(np.abs(sk - sp).max()))
        log(f"[kernels] viterbi K=2 near-one-hot initial state {state}: "
            f"{n_diff} of {VITERBI_T} states differ, passes={passes_1h}")
        check(n_diff == 0 and sk[0] == state,
              "viterbi with a near-one-hot initial vector differs")
    _, plain_ms, passes = out[(3, "random")]
    bound_ms, bound_by = viterbi_bound(VITERBI_T, 3)
    n_bytes = VITERBI_T * (3 * 4 + 1 + 4)
    copies = [viterbi_args(torch, dev, 3, "random", VITERBI_T)
              for _ in range(rotation(n_bytes))]
    tm = timing(torch, [lambda a=a: tv.viterbi_scan(*a) for a in copies],
                ("viterbi_kernel",), lambda: tv.viterbi_scan(*copies[0]), 5)
    log(f"[kernels] viterbi K=3 random T={VITERBI_T}: device_ms="
        f"{tm['device_ms']!r} ({tm['device_by']}) over {len(copies)} "
        f"distinct inputs, call_ms="
        f"{tm['call_ms']!r}, floor_ms={tm['floor_ms']!r}, bound_ms="
        f"{bound_ms!r} ({bound_by})")
    return {"name": "viterbi", "route": "cuda",
            "source": "inaspeechsegmenter_tpu_torch/csrc/viterbi.cu",
            "replaces": "inaspeechsegmenter_tpu/decode/viterbi.py:222",
            "max_abs_err": float(worst), "ms": tm["device_ms"], **tm,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library_note": "no single PyTorch call computes the function",
            "passes": passes, "size": f"T={VITERBI_T}, K=3, random"}


# --------------------------------------------------------------------------
def frame_labels(lseg):
    return np.concatenate([np.full(int(round((b - a) / .02)), lab, object)
                           for lab, a, b in lseg])


def read_csv(path):
    with open(path) as fh:
        text = fh.read()
    lines = text.splitlines()
    rows = [(lab, float(a), float(b))
            for lab, a, b in (ln.split("\t") for ln in lines[1:])]
    return text, lines[0], rows


def warm_batch_walls(batch, wavs, outs, tag):
    """Warm wall times of ``batch(wavs, outs)`` at prefetch depth 1 and at
    the default depth, in turns (1, default, default, 1)."""
    from inaspeechsegmenter_tpu_torch.utils.prefetch import prefetch_depth

    walls = {}
    for depth in ("1", None, None, "1"):
        if depth is None:
            os.environ.pop("ISS_PREFETCH", None)
        else:
            os.environ["ISS_PREFETCH"] = depth
        key = prefetch_depth()
        t0 = time.perf_counter()
        _, n_ok, _, _ = batch(wavs, outs)
        walls.setdefault(key, []).append(time.perf_counter() - t0)
        check(n_ok == len(wavs), f"{tag}: a warm batch failed")
    os.environ.pop("ISS_PREFETCH", None)
    log(f"[{tag}] warm batch of {len(wavs)} files, walls by prefetch depth: "
        f"{walls}")


def epilogue_model(torch, dev, nmel, nout, seed):
    """A full-width synthetic patch CNN with non-trivial biases and
    BatchNorm statistics (negative scales among them), on the card."""
    from inaspeechsegmenter_tpu_torch.models.native import ImportedModel
    from inaspeechsegmenter_tpu_torch.models.synthetic import build_patch_cnn

    spec, params = build_patch_cnn(nmel, nout, seed, "full")
    rng = np.random.default_rng(seed)
    for i in range(4):
        c = params[f"bn{i}"][0].shape[0]
        params[f"conv{i}"][1] = rng.normal(0, 0.1, c).astype(np.float32)
        params[f"bn{i}"] = [rng.uniform(-1.5, 1.5, c).astype(np.float32),
                            rng.normal(0, 0.1, c).astype(np.float32),
                            rng.normal(0, 0.1, c).astype(np.float32),
                            rng.uniform(0.5, 2.0, c).astype(np.float32)]
    return ImportedModel(spec, params).to(dev)


EPILOGUE_BATCH = 1024      # pipeline.CNN_CHUNK: the dense path's batch


def phase_cnn_epilogue(torch, dev, workdir):
    """The CNN blocks' epilogue kernel on the card: at each block of the
    VAD (nmel 21) and gender (nmel 24) CNNs at 1,024 patches, the kernel
    against its plain version (bit-equal), its device ms over distinct
    conv outputs, the bound, the plain version's ms; launches a forward
    and for a 10 min file."""
    from inaspeechsegmenter_tpu_torch import Segmenter
    from inaspeechsegmenter_tpu_torch.models import layers as L
    from inaspeechsegmenter_tpu_torch.models.synthetic import (
        install_synthetic_models)

    rows, per_forward = [], {}
    for label, (nmel, nout, seed) in (("vad", (21, 3, 1)),
                                      ("gender", (24, 2, 2))):
        model = epilogue_model(torch, dev, nmel, nout, seed)
        x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (EPILOGUE_BATCH, 68, nmel, 1)).astype(np.float32)).to(dev)
        with torch.no_grad():
            reset_kernel_counts()
            model(x)
            torch.cuda.synchronize()
            c = kernel_counts()
            per_forward[label] = c["cnn_epilogue"]
            check(c["cnn_forwards"] == 1, f"{label} CNN: one forward "
                  f"counted {c['cnn_forwards']} fused forwards")
            check_cnn_launches(c, f"the {label} CNN's forward")
            v = L.from_keras(x)
            chains = [fn for _, fn, _, _ in model._steps
                      if isinstance(fn, L.ConvChain)]
            for k, fn in enumerate(chains):
                pads = None if fn.padded_input else fn.conv.border(
                    *v.shape[2:])
                xin = v if pads is None else torch.nn.functional.pad(
                    v, (pads[2], pads[3], pads[0], pads[1]))
                y = fn.conv.convolve(xin, bias=False)
                bn = fn.bn
                border = None if fn.next_conv is None else \
                    fn.next_conv.border(*L.pooled_size(*y.shape[2:],
                                                       fn.pool))
                args = (fn.conv.bias, tuple(fn.relu),
                        (bn.mean, bn.inv, bn.gamma, bn.beta), fn.pool,
                        border)
                got = L.cnn_epilogue(y, *args)
                want = L.cnn_epilogue_plain(y, *args)
                torch.cuda.synchronize()
                check(got.stride() == want.stride() and np.array_equal(
                    got.cpu().numpy(), want.cpu().numpy(), equal_nan=True),
                    f"{label} block {k}: kernel differs from plain")
                n_bytes = 4 * (y.numel() + got.numel())
                bound_ms, bound_by = bound(n_bytes, 8 * y.numel())
                copies = [y.clone() for _ in range(rotation(n_bytes))]
                tm = timing(torch, [lambda c=c: L.cnn_epilogue(c, *args)
                                    for c in copies],
                            ("cnn_epilogue_kernel",),
                            lambda: L.cnn_epilogue(y, *args), 20)
                plain_ms = cuda_ms(lambda: L.cnn_epilogue_plain(y, *args),
                                   10, torch)
                row = {"cnn": label, "block": k,
                       "conv_out": list(y.shape), "out": list(got.shape),
                       "border": border, **tm, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bytes": n_bytes}
                log(f"[kernels] cnn_epilogue {label} block {k} "
                    f"{tuple(y.shape)} -> {tuple(got.shape)}: device_ms="
                    f"{tm['device_ms']!r} ({tm['device_by']}), call_ms="
                    f"{tm['call_ms']!r}, plain_ms={plain_ms!r}, bound_ms="
                    f"{bound_ms!r} ({bound_by}), "
                    f"{bound_ms / tm['device_ms']:.3f} of the bound")
                rows.append(row)
                del copies
                v = fn(v)
        del model, x, v
    # the launches of a 10 min file through the Segmenter's CNNs
    models = install_synthetic_models(os.path.join(workdir, "epilogue"),
                                      size="full")
    seg = Segmenter("smn", True, ffmpeg=None, device=dev, model_dir=models,
                    allow_download=False)
    sig = to_int16(seeded_mix(600, seed=600, silences=silences_every(600)))
    seg.segment_signal(sig)
    reset_kernel_counts()
    seg.segment_signal(sig)
    torch.cuda.synchronize()
    c = kernel_counts()
    per_file = c["cnn_epilogue"]
    log(f"[kernels] cnn_epilogue launches for the 10 min file: {per_file} "
        f"in {c['cnn_forwards']} CNN forwards")
    check(per_file > 0, "a 10 min file launched no epilogue")
    check_segmentation_launches(c, "the 10 min file")
    for label in ("vad", "gender"):
        mine = [r for r in rows if r["cnn"] == label]
        log(f"[kernels] cnn_epilogue {label}: four blocks "
            f"{sum(r['device_ms'] for r in mine)!r} device ms, bound "
            f"{sum(r['bound_ms'] for r in mine)!r} ms, plain "
            f"{sum(r['plain_ms'] for r in mine)!r} ms")
    return {"name": "cnn_epilogue", "route": "cuda",
            "source": "inaspeechsegmenter_tpu_torch/csrc/cnn_epilogue.cu",
            "replaces": "none (XLA fused these passes in the JAX package)",
            "rows": rows, "launches_per_forward": per_forward,
            "launches_10_min_file": per_file, "library_ms": None,
            "library_note": "no single PyTorch call computes the function",
            "size": f"{EPILOGUE_BATCH} patches a block"}


SEGMENTATION_KERNELS = ("sidekit_fe", "viterbi")   # K <= 3 decodes only
CODEC_KERNELS = ("unpack_bits", "unpack_zero_elide")  # where the codec is on
CNN_KEYS = ("cnn_epilogue", "cnn_forwards")     # 4 launches a CNN forward
EPILOGUE_PER_FORWARD = 4        # the patch CNNs' four fused blocks


def kernel_wrappers():
    """Every kernel wrapper, by kernel name."""
    from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
    from inaspeechsegmenter_tpu_torch.dsp import codec, fe_kernel
    from inaspeechsegmenter_tpu_torch.models import layers

    return {"sidekit_fe": fe_kernel.sidekit_features,
            "viterbi": tv.viterbi_scan,
            "viterbi_general": tv.viterbi_scan_general,
            "unpack_bits": codec.unpack_bits,
            "unpack_zero_elide": codec.unpack_zero_elide,
            "cnn_epilogue": layers.cnn_epilogue}


# Counts the forwards on the card of the models that run fused conv chains
# (``ImportedModel.fused_blocks``), in ``_cnn["forwards"]``: each launches
# the epilogue once a block.  Run in this process by ``count_cnn_forwards``
# and in the child processes' scripts, which hold it.
CNN_FORWARDS = r"""
import threading
from inaspeechsegmenter_tpu_torch.models.native import ImportedModel as _Model

_cnn = {"forwards": 0, "lock": threading.Lock()}
_model_forward = _Model.forward


def _counted_forward(self, x):
    t = x[0] if isinstance(x, (list, tuple)) else x
    if self.fused_blocks and getattr(t, "is_cuda", False) and len(t):
        with _cnn["lock"]:
            _cnn["forwards"] += 1
    return _model_forward(self, x)


_Model.forward = _counted_forward
"""
_CNN = {"forwards": 0}


def count_cnn_forwards():
    """Count the fused CNN forwards on the card from now on
    (``CNN_FORWARDS``)."""
    global _CNN
    ns = {}
    exec(CNN_FORWARDS, ns)
    _CNN = ns["_cnn"]


def kernel_counts():
    """Every kernel wrapper's launch count, and ``cnn_forwards``: the
    fused CNN forwards on the card."""
    out = {k: w.launches for k, w in kernel_wrappers().items()}
    out["cnn_forwards"] = _CNN["forwards"]
    return out


def reset_kernel_counts():
    for w in kernel_wrappers().values():
        w.launches = 0
    _CNN["forwards"] = 0


def codec_on():
    """Whether the card's int16 uploads take the codec in this process
    (``ISS_UPLOAD_CODEC``)."""
    from inaspeechsegmenter_tpu_torch.dsp.fe_kernel import (
        upload_codec_enabled)

    return upload_codec_enabled()


def without_codec(counts):
    """The counts of the kernels whose launches depend neither on the
    upload codec nor on the CNNs' batches (``check_routed_launches``
    holds those)."""
    return {k: v for k, v in counts.items()
            if k not in CODEC_KERNELS + CNN_KEYS}


def check_cnn_launches(counts, what):
    """The CNN epilogue launched 4 times a fused CNN forward on the card
    (``cnn_forwards``), and not otherwise."""
    n, forwards = counts["cnn_epilogue"], counts["cnn_forwards"]
    check(n == EPILOGUE_PER_FORWARD * forwards,
          f"{what} launched cnn_epilogue {n} times in {forwards} fused CNN "
          f"forwards, not {EPILOGUE_PER_FORWARD} a forward")


def check_routed_launches(counts, what):
    """The kernels whose launches follow the data: with the codec off, no
    decode kernel launches (with it on, the route depends on the data;
    phase 11 checks it against pack_best); the CNN epilogue as
    ``check_cnn_launches`` says."""
    if not codec_on():
        for name in CODEC_KERNELS:
            check(counts[name] == 0,
                  f"{what} launched {name} with the codec off")
    check_cnn_launches(counts, what)


def check_segmentation_launches(counts, what):
    """A segmentation or VFS run launches the features and K <= 3 Viterbi
    kernels, and never the general-K one (its decodes have 2 or 3
    states); the decode kernels and the CNN epilogue as
    ``check_routed_launches`` says."""
    for name, n in without_codec(counts).items():
        if name in SEGMENTATION_KERNELS:
            check(n > 0, f"{what} never launched the {name} kernel")
        else:
            check(n == 0, f"{what} launched the {name} kernel {n} times")
    check_routed_launches(counts, what)


def phase_main(torch, dev, workdir):
    from inaspeechsegmenter_tpu_torch import Segmenter
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
    from inaspeechsegmenter_tpu_torch.dsp.sidekit import frame_count
    from inaspeechsegmenter_tpu_torch.models.synthetic import (
        install_synthetic_models)
    from inaspeechsegmenter_tpu_torch.utils.prefetch import prefetch_depth

    models = install_synthetic_models(os.path.join(workdir, "models"),
                                      seed=0, size="full")
    files = {
        "silence2sec": np.zeros(2 * SR, np.int16),
        "mix60": to_int16(seeded_mix(60, seed=60,
                                     silences=silences_every(60))),
        "mix600": to_int16(seeded_mix(600, seed=600,
                                      silences=silences_every(600))),
    }
    wavs, csvs = [], []
    for name, sig in files.items():
        wavs.append(os.path.join(workdir, name + ".wav"))
        csvs.append(os.path.join(workdir, "out", name + ".csv"))
        write_wav(wavs[-1], sig, SR)

    t0 = time.perf_counter()
    seg = Segmenter("smn", True, ffmpeg=None, device=dev, model_dir=models,
                    allow_download=False)
    log(f"[main] Segmenter(device={dev}) built in "
        f"{time.perf_counter() - t0!r} s")

    reset_kernel_counts()
    t0 = time.perf_counter()
    dur, n_ok, avg, lmsg = seg.batch_process(wavs, csvs)
    batch_s = time.perf_counter() - t0
    launches = kernel_counts()
    audio_s = sum(len(sig) for sig in files.values()) / SR
    log(f"[main] batch_process of {len(wavs)} files ({audio_s!r} s of audio, "
        f"prefetch depth {prefetch_depth()}): {batch_s!r} s, rtf "
        f"{audio_s / batch_s!r}, statuses {[m[1:] for m in lmsg]}, "
        f"launches {launches}")
    check(n_ok == len(wavs), f"batch statuses {lmsg}")
    check_segmentation_launches(launches, "the main path")

    for (name, sig), csv in zip(files.items(), csvs):
        text, header, rows = read_csv(csv)
        check(header == "labels\tstart\tstop", f"{name}: header {header!r}")
        n20 = (frame_count(len(sig)) + 1) // 2
        check(rows[0][1] == 0.0 and rows[-1][2] == n20 * .02,
              f"{name}: segments do not span the file")
        check(all(r[2] == s[1] for r, s in zip(rows[:-1], rows[1:])),
              f"{name}: segments do not tile the file")
        if name == "silence2sec":
            check(text == "labels\tstart\tstop\nnoEnergy\t0.0\t1.98\n",
                  f"silence csv {text!r}")
        labels = sorted({r[0] for r in rows})
        log(f"[main] {name}: {len(rows)} segments, labels {labels}")

    warm_batch_walls(seg.batch_process, wavs, csvs, "main")

    # warm per-file wall time and real-time factor
    for (name, sig), wav in zip(files.items(), wavs):
        t0 = time.perf_counter()
        seg(wav)
        wall = time.perf_counter() - t0
        log(f"[main] {name}: {len(sig) / SR!r} s audio, wall {wall!r} s, "
            f"rtf {len(sig) / SR / wall!r}")

    launches_per_file = segmentation_split(torch, dev, seg,
                                           wavs[list(files).index("mix600")])

    # the same 60 s file through the port's plain path on the CPU
    cpu = Segmenter("smn", True, ffmpeg=None, device="cpu", model_dir=models,
                    allow_download=False)
    a = frame_labels(seg(wavs[1]))
    b = frame_labels(cpu(wavs[1]))
    check(a.shape == b.shape, "cuda and cpu label counts differ")
    n_diff = int((a != b).sum())
    log(f"[main] mix60 cuda vs cpu: {n_diff} of {len(a)} frames differ")
    check(n_diff <= 0.001 * len(a), "cuda and cpu labels differ on >0.1%")
    return seg, launches, files, wavs, models, launches_per_file


def segmentation_split(torch, dev, seg, wav, reps=5):
    """The warm 10 min file stage by stage (a device sync after each stage,
    the median of ``reps`` runs), the pipeline's steps in its own order; then
    each of its decodes (captured from one ``seg(wav)``) and its features
    kernel timed alone with CUDA events.  -> kernel launches per file."""
    from inaspeechsegmenter_tpu_torch import pipeline
    from inaspeechsegmenter_tpu_torch.audio.io import media2sig16kmono
    from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
    from inaspeechsegmenter_tpu_torch.dsp import fe_kernel
    from inaspeechsegmenter_tpu_torch.segmenter import patch_counts

    p = seg.pipeline

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    names = ("read WAV (host)", "upload + features kernel", "energy decode",
             "VAD CNN", "VAD decode", "gender CNN", "gender decode")
    runs = []
    for _ in range(reps):
        sig, t_read = timed(lambda: media2sig16kmono(wav, ffmpeg=None,
                                                     dtype="auto"))
        (mspec, loge, t, difflen), t_fe = timed(
            lambda: seg._sig2feats(sig, wav))
        n_fp, n20 = patch_counts(t, difflen)
        energy20, t_e = timed(lambda: p._energy_states20(loge[:t])[:n20])
        probs_v, t_vc = timed(lambda: p._cnn_probs(
            p.vad_model, mspec, n_fp, p.vad_nmel, p.vad_nout, energy20))
        states_v, t_vd = timed(lambda: p._masked_viterbi(
            probs_v, energy20, p.v_trans, p.v_init))
        labels = torch.where(energy20, states_v + 1,
                             torch.zeros_like(states_v)).to(torch.int32)
        speech20 = labels == 1
        probs_g, t_gc = timed(lambda: p._cnn_probs(
            p.g_model, mspec, n_fp, p.g_nmel, p.g_nout, speech20))
        states_g, t_gd = timed(lambda: p._masked_viterbi(
            probs_g, speech20, p.g_trans, p.g_init))
        labels = torch.where(speech20, states_g + 1 + p.vad_nout, labels)
        runs.append((t_read, t_fe, t_e, t_vc, t_vd, t_gc, t_gd))
    check(np.array_equal(labels.cpu().numpy(),
                         p.run(mspec, loge, t, n_fp, n20).cpu().numpy()),
          "the stage split's labels differ from the pipeline's")
    med = np.median(np.array(runs), axis=0)
    for name, ms in zip(names, med):
        log(f"[main] mix600 stage {name}: {float(ms)!r} ms "
            f"({100 * ms / med.sum():.1f}%)")
    log(f"[main] mix600 stages sum {float(med.sum())!r} ms (median of "
        f"{reps}); {t} frames, {n20} at 20 ms, "
        f"{int(energy20.sum())} VAD patches, {int(speech20.sum())} gender "
        "patches")

    captured = []

    def capture(*args):
        captured.append([a.clone() for a in args])
        return tv.viterbi_scan(*args)

    reset_kernel_counts()
    pipeline.viterbi_scan = capture
    try:
        seg(wav)
    finally:
        pipeline.viterbi_scan = tv.viterbi_scan
    torch.cuda.synchronize()
    per_file = kernel_counts()
    check_segmentation_launches(per_file, "the counted mix600 run")
    for name, args in zip(("energy", "VAD", "gender"), captured):
        ms = cuda_ms(lambda: tv.viterbi_scan(*args), 10, torch)
        T, K = args[0].shape
        log(f"[main] mix600 {name} decode: T={T} K={K} kernel_ms={ms!r} "
            f"passes={tv.pass_count()} walked_chunks={tv.walked_chunks()} "
            f"resets={int(args[3].sum())}")
    sig = torch.from_numpy(media2sig16kmono(wav, ffmpeg=None,
                                            dtype="auto")).to(dev)
    ms = cuda_ms(lambda: fe_kernel.sidekit_features(
        sig, seg.frontend.consts), 20, torch)
    log(f"[main] mix600 features kernel: {ms!r} ms for "
        f"{t} frames ({sig.dtype}); launches per "
        f"file {per_file}")
    return per_file


# --------------------------------------------------------------------------
VFS_PART_SECONDS = 15     # cuda-vs-cpu part of mix60: the CPU runs the
                          # full ResNet101 on its windows


def rel_l2(a, b):
    return float((np.linalg.norm(a - b, axis=1)
                  / np.linalg.norm(b, axis=1)).max())


@contextlib.contextmanager
def vbx_grid(on):
    """Every VBx frontend on the int16 grid (``on``) or on the f32 path,
    whatever its device (the card's own is the grid, the CPU's the f32
    path): to hold the two paths against each other, and the card's grid
    against the CPU's."""
    from inaspeechsegmenter_tpu_torch.dsp import vbx

    by_device = vbx.vbx_i16_enabled
    vbx.vbx_i16_enabled = lambda device: on
    try:
        yield
    finally:
        vbx.vbx_i16_enabled = by_device


def phase_vfs(torch, dev, workdir, files, wavs, models):
    """VFS on the card: full-width ResNet101 (seeded random weights) and the
    synthetic MLP, batch-scored over phase 2's three WAVs."""
    from inaspeechsegmenter_tpu_torch import Segmenter, VoiceFemininityScoring
    from inaspeechsegmenter_tpu_torch.annotations import SpeechTimeline
    from inaspeechsegmenter_tpu_torch.dsp.vbx import (
        VbxFrontend, device_atol, host_segment)
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNet101XVector
    from inaspeechsegmenter_tpu_torch.utils.prefetch import prefetch_depth
    from inaspeechsegmenter_tpu_torch.vfs import WINLEN, save_resnet_npz
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    params = ResNet101XVector().init_params(seed=0)
    save_resnet_npz(os.path.join(models, "raw_81.npz"), params)
    vfs = VoiceFemininityScoring("bgc", ffmpeg=None, device=dev,
                                 model_dir=models, allow_download=False)
    log(f"[vfs] ResNet101 weights saved and VoiceFemininityScoring(device="
        f"{dev}) built in {time.perf_counter() - t0!r} s")

    csvs = [os.path.join(workdir, "vfs", os.path.basename(w)[:-4] + ".csv")
            for w in wavs]
    reset_kernel_counts()
    t0 = time.perf_counter()
    dur, n_ok, avg, lmsg = vfs.batch_score(wavs, csvs)
    batch_s = time.perf_counter() - t0
    launches = kernel_counts()
    audio_s = sum(len(sig) for sig in files.values()) / SR
    log(f"[vfs] batch_score of {len(wavs)} files ({audio_s!r} s of audio, "
        f"prefetch depth {prefetch_depth()}): {batch_s!r} s, rtf "
        f"{audio_s / batch_s!r}, statuses {[m[1:] for m in lmsg]}, "
        f"launches {launches}")
    check(n_ok == len(wavs), f"vfs batch statuses {lmsg}")
    check_segmentation_launches(launches, "the VFS run")
    warm_batch_walls(vfs.batch_score, wavs, csvs, "vfs")

    vad = Segmenter("smn", False, ffmpeg=None, device=dev, model_dir=models,
                    allow_download=False)
    for (name, sig), csv in zip(files.items(), csvs):
        with open(csv) as fh:
            lines = fh.read().splitlines()
        check(lines[0] == "score\tspeech_duration\tnb_vectors",
              f"{name}: vfs header {lines[0]!r}")
        score, sdur, n_vec = lines[1].split("\t")
        log(f"[vfs] {name}: score={score or 'None'} speech_duration={sdur} "
            f"nb_vectors={n_vec}")
        if name == "silence2sec":
            check(lines[1] == "\t0.0\t0", f"silence vfs row {lines[1]!r}")
            continue
        want = SpeechTimeline.from_vad(vad.segment_signal(sig)) \
            .total_duration()
        check(float(sdur) == want,
              f"{name}: speech_duration {sdur} != the VAD's {want!r}")
        check(int(n_vec) > 0 and 0.0 <= float(score) <= 1.0,
              f"{name}: vfs row {lines[1]!r}")

    # cuda against cpu, stage by stage, on the first VFS_PART_SECONDS of
    # mix60; like with like: the card's default is the int16 grid, so the
    # CPU takes it too
    part = files["mix60"][:VFS_PART_SECONDS * SR]
    signal = part.astype(np.float64) / 32768.0
    with vbx_grid(True):
        fea_c = vfs.features.features(signal)
        fea_p = VbxFrontend("cpu").features(signal)
    n_fr = fea_p.shape[0]
    atol = device_atol(n_fr, blocked=True)
    fea_err = float((fea_c.cpu() - fea_p).abs().max())
    log(f"[vfs] {VFS_PART_SECONDS} s part: VBx features (int16 grid) cuda vs "
        f"cpu max_abs_err={fea_err!r} (T={n_fr}, atol {atol!r})")
    check(fea_err <= atol, "VBx features differ")
    vfs_cpu = VoiceFemininityScoring("bgc", ffmpeg=None, device="cpu",
                                     model_dir=models, xvector_params=params,
                                     allow_download=False)
    starts = list(range(0, n_fr - WINLEN, 24))
    t0 = time.perf_counter()
    emb_p = vfs_cpu.xvector_model.embeddings_from_features(fea_p, starts)
    cpu_s = time.perf_counter() - t0
    emb_c = vfs.xvector_model.embeddings_from_features(fea_p.to(dev), starts)
    emb_err = rel_l2(emb_c, emb_p)
    log(f"[vfs] ResNet101 embeddings of {len(starts)} windows cuda vs cpu: "
        f"max_rel_l2={emb_err!r} (cpu forward {cpu_s!r} s)")
    check(emb_err <= 1e-3, "embeddings differ")
    p_c = vfs.mlp_probabilities(emb_p * 10)
    p_p = vfs_cpu.mlp_probabilities(emb_p * 10)
    p_err = float(np.abs(p_c - p_p).max())
    log(f"[vfs] MLP probabilities cuda vs cpu: max_abs_err={p_err!r}")
    check(p_err <= 1e-4, "MLP probabilities differ")
    same_vad = (vfs.vad.segment_signal(part)
                == vfs_cpu.vad.segment_signal(part))
    with vbx_grid(True):
        got, want = vfs.score_signal(part), vfs_cpu.score_signal(part)
    log(f"[vfs] {VFS_PART_SECONDS} s part end to end: cuda {got} cpu {want} "
        f"(VAD timelines {'equal' if same_vad else 'differ'})")
    if same_vad:
        check(got == want, "cuda and cpu VFS results differ")

    # the warm 10 min file: wall time and the stage split (of the f32
    # path; phase 6(a) splits the int16 grid's)
    sig = files["mix600"]
    wav = wavs[list(files).index("mix600")]
    reset_kernel_counts()
    vfs(wav)
    torch.cuda.synchronize()
    per_file = kernel_counts()
    check_segmentation_launches(per_file, "the counted VFS mix600 run")
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        vfs(wav)
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    log(f"[vfs] mix600 warm: {len(sig) / SR!r} s audio, wall {wall!r} s "
        f"(median of {walls}), rtf {len(sig) / SR / wall!r}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()!r} B")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    splits = []
    for _ in range(3):
        lseg, t_vad = timed(lambda: vfs.vad.segment_signal(sig))
        timeline = SpeechTimeline.from_vad(lseg)
        signal = sig.astype(np.float64) / 32768.0
        seg, t_host = timed(lambda: host_segment(signal))
        fea, t_dev = timed(lambda: vfs.features.device_features(
            torch.from_numpy(seg).to(dev)))
        xv, t_res = timed(lambda: vfs.xvector_model(
            "mix600", fea, len(sig) / SR, timeline=timeline))
        res, t_mlp = timed(lambda: vfs._score_xvectors(
            xv, timeline, timeline.total_duration()))
        splits.append((t_vad, t_host, t_dev, t_res, t_mlp))
    t_vad, t_host, t_dev, t_res, t_mlp = sorted(splits, key=sum)[1]
    total = t_vad + t_host + t_dev + t_res + t_mlp
    n_win = len(xv)
    xm = vfs.xvector_model
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        xm.net(fea[:WINLEN].T[None])
    flops = counter.get_total_flops()       # convs + projection, one window
    for name, t in (("VAD (Segmenter smn, no gender)", t_vad),
                    ("VBx f32 path, host dither + pad", t_host),
                    ("VBx f32 path, upload + device", t_dev),
                    ("ResNet101 x-vectors", t_res),
                    ("MLP + scoring", t_mlp)):
        log(f"[vfs] stage {name}: {t * 1e3!r} ms ({100 * t / total:.1f}%)")
    log(f"[vfs] stages sum {total!r} s; result {res}; windows embedded "
        f"{n_win}, windows/s {n_win / t_res!r}, ResNet TFLOP/s "
        f"{n_win * flops / t_res / 1e12!r} ({flops!r} FLOP per window)")
    starts = list(range(0, 256 * 24, 24))
    ms = cuda_ms(lambda: xm.embeddings_from_features(fea, starts), 5, torch)
    log(f"[vfs] one 256-window sub-batch: {ms!r} ms, "
        f"{256 * flops / ms / 1e9!r} TFLOP/s")
    seg_dev = torch.from_numpy(seg).to(dev)
    fe_ms = cuda_ms(lambda: vfs.features.device_features(seg_dev), 10, torch)
    log(f"[vfs] VBx device features (plain PyTorch, f32 path), 10 min: "
        f"{fe_ms!r} ms for {fea.shape[0]} frames; kernel launches per file "
        f"{per_file}")
    return vfs, params, launches, per_file, n_win / t_res


# --------------------------------------------------------------------------
ONLINE_BLOCK_SECONDS = 0.5
FORCE_COMMIT_SECONDS = 900     # a 15 min mix with no inserted silence


def frames_differ(a, b):
    """Frames (20 ms) whose labels differ between two tilings of one file."""
    a, b = frame_labels(a), frame_labels(b)
    check(a.shape == b.shape, f"label counts differ: {a.shape} {b.shape}")
    return int((a != b).sum()), len(a)


def drive_online(torch, seg, sig):
    """Feed ``sig`` to an ``OnlineSegmenter`` in 0.5 s blocks, polling
    ``current()`` after each with a device sync, then finalize.  -> the
    object, its final labels and the poll statistics."""
    from inaspeechsegmenter_tpu_torch import OnlineSegmenter
    from inaspeechsegmenter_tpu_torch.dsp.sidekit import CHUNK

    online = OnlineSegmenter(seg)
    decodes = []                    # frames of each provisional decode
    pipe = seg.pipeline
    real = pipe.stream_decode

    def recording(chunks, probs, n_frames, *args, **kwargs):
        decodes.append(n_frames)
        return real(chunks, probs, n_frames, *args, **kwargs)

    pipe.stream_decode = recording
    polls, feeds = [], []
    commits = forced = short_polls = 0
    run = online.COMMIT_RUN
    step = int(ONLINE_BLOCK_SECONDS * SR)
    try:
        for pos in range(0, len(sig), step):
            before = online._commit
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            online.feed(sig[pos:pos + step])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lseg = online.current()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            feeds.append((t1 - t0) * 1e3)
            polls.append((t2 - t1) * 1e3)
            # under two chunks a poll segments the whole buffered prefix
            short_polls += online.chunks_ready < 2
            if online._commit != before:
                # a commit at a chunk boundary whose COMMIT_RUN frames on
                # each side are not all noEnergy was forced
                commits += 1
                f = online._commit * (CHUNK // 2)
                names = frame_labels(lseg)
                forced += bool((names[f - run:f + run] != "noEnergy").any())
        n_provisional = len(decodes)
        final = online.finalize()
        torch.cuda.synchronize()
    finally:
        del pipe.stream_decode
    return online, final, {
        "polls": len(polls), "poll_ms_median": float(np.median(polls)),
        "poll_ms_max": float(np.max(polls)),
        "short_prefix_polls": short_polls,
        "feed_ms_max": float(np.max(feeds)),
        "provisional_decodes": n_provisional,
        "longest_decode_frames": max(decodes[:n_provisional], default=0),
        "commits": commits, "forced_commits": forced}


def growing_wav_writer(path, sig, piece, delay):
    """A thread writing a WAV as a recorder does: a header with bogus
    sizes, then ``piece`` samples every ``delay`` seconds."""
    import struct
    import threading

    fmt = struct.pack("<HHIIHH", 1, 1, SR, 2 * SR, 2, 16)
    header = (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE" + b"fmt "
              + struct.pack("<I", len(fmt)) + fmt + b"data"
              + struct.pack("<I", 0xFFFFFFFF))

    def run():
        with open(path, "wb") as f:
            f.write(header)
            f.flush()
            for pos in range(0, len(sig), piece):
                time.sleep(delay)
                f.write(sig[pos:pos + piece].astype("<i2").tobytes())
                f.flush()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def phase_online(torch, dev, workdir, seg, vfs, files, wavs):
    """Streaming against fused, the online segmenter, follow mode and the
    online VFS at full width.  -> the kernel launches of the main path's
    run, one online 10 min file."""
    from inaspeechsegmenter_tpu_torch import OnlineVFS
    from inaspeechsegmenter_tpu_torch.annotations import SpeechTimeline
    from inaspeechsegmenter_tpu_torch.online import follow_wav

    sig = files["mix600"]
    p = seg.pipeline
    chunks, t = seg.frontend.mspec_loge_chunks(sig)
    mspec, loge, _ = seg.frontend.mspec_loge(sig)
    n20 = (t + 1) // 2

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for _ in range(2):                      # the second run is warm
        ids_s, ms_s = timed(lambda: p.run_streaming(chunks, t, t, n20))
        ids_f, ms_f = timed(lambda: p.run(mspec, loge, t, t, n20))
    n_diff = int((ids_s != ids_f).sum())
    log(f"[online] mix600 run_streaming vs run: {n_diff} of {n20} frames "
        f"differ; warm run_streaming {ms_s!r} ms ({len(chunks)} chunks), "
        f"run {ms_f!r} ms")
    check(n_diff <= 0.001 * n20, "streaming and fused labels differ on >0.1%")

    # the main path of this phase: one online file, counted
    reset_kernel_counts()
    t0 = time.perf_counter()
    online, final, stats = drive_online(torch, seg, sig)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    per_file = kernel_counts()
    n_diff, n_fr = frames_differ(final, seg.segment_signal(sig))
    log(f"[online] mix600 OnlineSegmenter, {ONLINE_BLOCK_SECONDS} s blocks: "
        f"{stats}, wall {wall!r} s; finalize vs segment_signal: {n_diff} of "
        f"{n_fr} frames differ; kernel launches {per_file}")
    check(n_diff <= 0.001 * n_fr, "online finalize differs on >0.1%")
    check_segmentation_launches(per_file, "the online path")

    # follow mode on the 60 s mix, written by a recorder thread
    path = os.path.join(workdir, "follow60.wav")
    sig60 = files["mix60"]
    writer = growing_wav_writer(path, sig60, piece=SR // 2, delay=0.02)
    t0 = time.perf_counter()
    got = follow_wav(path, seg, idle_timeout=1.0, poll=0.05)
    wall = time.perf_counter() - t0
    writer.join(timeout=60)
    check(not writer.is_alive(), "the WAV writer thread did not finish")
    n_diff, n_fr = frames_differ(got, seg(wavs[list(files).index("mix60")]))
    log(f"[online] follow_wav mix60: {len(got)} segments in {wall!r} s "
        f"(idle timeout 1.0 s); vs seg(wav): {n_diff} of {n_fr} frames "
        "differ")
    check(n_diff <= 0.001 * n_fr, "follow_wav differs from seg(wav) on >0.1%")

    # the online VFS on the 60 s mix
    ov = OnlineVFS(vfs, "mix60")
    prov = []
    for pos in range(0, len(sig60), 5 * SR):
        ov.feed(sig60[pos:pos + 5 * SR])
        prov.append(ov.current())
    got = ov.finalize()
    want = vfs.score_signal(sig60, "mix60")
    same_vad = (SpeechTimeline.from_vad(ov.vad_online.finalize()).intervals
                == SpeechTimeline.from_vad(
                    vfs.vad.segment_signal(sig60)).intervals)
    log(f"[online] OnlineVFS mix60: provisional {prov[-3:]}, finalize {got}, "
        f"score_signal {want} (online and offline VAD timelines "
        f"{'equal' if same_vad else 'differ'})")
    if same_vad:
        check(got == want, "OnlineVFS.finalize differs from score_signal")

    # the force-commit disagreement on unbroken audio
    sig900 = to_int16(seeded_mix(FORCE_COMMIT_SECONDS,
                                 seed=FORCE_COMMIT_SECONDS))
    online, final, stats = drive_online(torch, seg, sig900)
    committed = np.array(seg.labels, object)[online._committed_ids]
    final_names = frame_labels(final)
    n_diff = int((committed != final_names[:len(committed)]).sum())
    first = (np.flatnonzero(committed != final_names[:len(committed)])[:5]
             .tolist())
    log(f"[online] force-commit, {FORCE_COMMIT_SECONDS} s without inserted "
        f"silence, COMMIT_MAXBACK={online.COMMIT_MAXBACK}: {stats}; "
        f"{n_diff} of {len(committed)} committed frames differ from "
        f"finalize() (first at frames {first})")
    n_diff, n_fr = frames_differ(final, seg.segment_signal(sig900))
    check(n_diff <= 0.001 * n_fr, "online finalize differs on >0.1% (15 min)")
    return per_file, phase_streaming_switch(torch, seg, vfs, files)


STREAM_MODES = (
    ("fused", {"ISS_STREAMING": "0", "ISS_STREAM_GENDER": "0"}),
    ("streamed", {"ISS_STREAMING": "1", "ISS_STREAM_GENDER": "0"}),
    ("streamed+gender", {"ISS_STREAMING": "1", "ISS_STREAM_GENDER": "1"}))
STREAM_TURNS = 3
STREAM_ONLINE_BLOCK_SECONDS = 10


def upload_group_count(sig):
    """Features launches of the streaming path on ``sig``: one an upload
    group of ``ISS_UPLOAD_CHUNKS`` chunks."""
    from inaspeechsegmenter_tpu_torch.dsp.fe_kernel import upload_chunks
    from inaspeechsegmenter_tpu_torch.dsp.sidekit import CHUNK, frame_count

    n_chunks = max(1, -(-frame_count(len(sig)) // CHUNK))
    return -(-n_chunks // upload_chunks())


def phase_streaming_switch(torch, seg, vfs, files):
    """Phase 4(b): ``segment_signal`` on the 60 s and 10 min mixes fused,
    streamed and streamed with the gender emissions a chunk
    (``ISS_STREAMING`` / ``ISS_STREAM_GENDER``), in turns; the VFS tuple
    streamed; ``OnlineSegmenter`` under ``ISS_STREAMING=0`` and under
    ``ISS_STREAM_GENDER=1``.  -> the launches of each counted run."""
    from inaspeechsegmenter_tpu_torch import OnlineSegmenter

    t_phase = time.perf_counter()
    per, lsegs = {}, {}
    names = ("mix60", "mix600")
    for name in names:
        sig = files[name]
        for mode, env in STREAM_MODES:
            with env_set(**env):
                reset_kernel_counts()
                lsegs[mode, name] = seg.segment_signal(sig)
                torch.cuda.synchronize()
                c = kernel_counts()
            want_fe = 1 if mode == "fused" else upload_group_count(sig)
            check(without_codec(c) == {"sidekit_fe": want_fe, "viterbi": 3,
                                       "viterbi_general": 0},
                  f"{mode} {name}: launches {c}, routing predicts "
                  f"{want_fe} features launches and 3 decodes")
            check_routed_launches(c, f"the {mode} {name} run")
            per[f"{mode}_{name}"] = c
    walls = {(mode, name): [] for mode, _ in STREAM_MODES for name in names}
    for turn in range(STREAM_TURNS):
        order = STREAM_MODES if turn % 2 == 0 else STREAM_MODES[::-1]
        for mode, env in order:
            with env_set(**env):
                for name in names:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = seg.segment_signal(files[name])
                    torch.cuda.synchronize()
                    walls[mode, name].append(time.perf_counter() - t0)
                    check(got == lsegs[mode, name],
                          f"{mode} {name}: labels changed between runs")
    for name in names:
        for mode, _ in STREAM_MODES[1:]:
            n_diff, n_fr = frames_differ(lsegs[mode, name],
                                         lsegs["fused", name])
            log(f"[streaming] {name} {mode} vs fused: {n_diff} of {n_fr} "
                f"frames differ")
            check(n_diff == 0, f"{name}: {mode} labels differ from fused")
        log(f"[streaming] {name} warm segment_signal walls in {STREAM_TURNS} "
            "turns, s: " + "; ".join(
                f"{mode} {walls[mode, name]!r} (median "
                f"{float(np.median(walls[mode, name]))!r})"
                for mode, _ in STREAM_MODES)
            + f"; launches {[(m, per[f'{m}_{name}']) for m, _ in STREAM_MODES]}")

    # the VFS tuple with the VAD streamed (its PCM parts feed the VBx grid)
    sig = files["mix600"]
    want = vfs.score_signal(sig, "mix600")
    with env_set(ISS_STREAMING="1"):
        reset_kernel_counts()
        got = vfs.score_signal(sig, "mix600")
        torch.cuda.synchronize()
        c = kernel_counts()
    check(got == want, f"VFS streamed {got} != fused {want}")
    check(without_codec(c) == {"sidekit_fe": upload_group_count(sig),
                               "viterbi": 2, "viterbi_general": 0},
          f"VFS streamed launches {c}")
    check_routed_launches(c, "the VFS streamed run")
    per["vfs_streamed_mix600"] = c
    log(f"[streaming] VFS mix600 with ISS_STREAMING=1: {got} == the fused "
        f"VAD's; launches {c}")

    # the online segmenter under the streaming switches
    block = STREAM_ONLINE_BLOCK_SECONDS * SR
    for label, env in (("ISS_STREAMING=0", {"ISS_STREAMING": "0"}),
                       ("ISS_STREAM_GENDER=1", {"ISS_STREAM_GENDER": "1"})):
        with env_set(**env):
            reset_kernel_counts()
            online = OnlineSegmenter(seg)
            polls = 0
            for pos in range(0, len(sig), block):
                online.feed(sig[pos:pos + block])
                if online.chunks_ready >= 2 or pos % (60 * SR) == 0:
                    online.current()
                    polls += 1
            final = online.finalize()
            torch.cuda.synchronize()
            c = kernel_counts()
            offline = seg.segment_signal(sig)
        n_diff, n_fr = frames_differ(final, offline)
        log(f"[streaming] OnlineSegmenter mix600 under {label}, "
            f"{STREAM_ONLINE_BLOCK_SECONDS} s blocks, {polls} polls "
            f"(passthrough {online._passthrough}): finalize vs the offline "
            f"labels: {n_diff} of {n_fr} frames differ; launches {c}")
        check(final == offline, f"online finalize under {label} differs "
              "from the offline labels")
        check(online._passthrough == (label == "ISS_STREAMING=0"),
              f"online passthrough under {label}")
        check_segmentation_launches(c, f"the online run under {label}")
        per[f"online_{label}"] = c
    log(f"[phase 4b] streaming switch: {time.perf_counter() - t_phase!r} s")
    return per

# --------------------------------------------------------------------------
CNN_TIER_ATOL = 2e-2            # the JAX package's own tier tolerance
XVEC_TIER_RTOL = {"high": 1e-2, "bf16": 5e-2}
TIERS = ("highest", "high", "bf16")
FFMPEG_WINDOW = (10.0, 40.0)


def write_hdf5_models(directory):
    """The full-width synthetic set (the seeds of ``install_synthetic_models
    (seed=0)``) as Keras 2 ``.hdf5`` files, written with numpy alone."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_parity_helpers import write_spec_h5

    from inaspeechsegmenter_tpu_torch.models.synthetic import (
        build_gender_mlp, build_patch_cnn)

    os.makedirs(directory)
    for stem, (spec, params) in {
            "keras_speech_music_cnn": build_patch_cnn(21, 2, 0, "full"),
            "keras_speech_music_noise_cnn": build_patch_cnn(21, 3, 1, "full"),
            "keras_male_female_cnn": build_patch_cnn(24, 2, 2, "full"),
            "interspeech2023_all": build_gender_mlp(seed=3),
            "interspeech2023_cvfr": build_gender_mlp(seed=4)}.items():
        write_spec_h5(os.path.join(directory, stem + ".hdf5"), spec, params)


def same_weights(torch, a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


def phase_hdf5(torch, dev, workdir, seg, vfs, files, wavs, models):
    """(a): the Segmenter and the VFS scorer built from ``.hdf5`` files."""
    import shutil

    from inaspeechsegmenter_tpu_torch import (Segmenter,
                                              VoiceFemininityScoring)

    h5dir = os.path.join(workdir, "hdf5_models")
    write_hdf5_models(h5dir)
    shutil.copy(os.path.join(models, "raw_81.npz"), h5dir)
    stems = sorted(n[:-5] for n in os.listdir(h5dir) if n.endswith(".hdf5"))
    size = sum(os.path.getsize(os.path.join(h5dir, n + ".hdf5"))
               for n in stems)
    log(f"[real] wrote {stems} as .hdf5 ({size!r} B)")
    built = []
    for attempt in ("first (parse + convert)", "second (cache)"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = Segmenter("smn", True, ffmpeg=None, device=dev, model_dir=h5dir,
                      allow_download=False)
        t_seg = time.perf_counter() - t0
        t0 = time.perf_counter()
        v = VoiceFemininityScoring("bgc", ffmpeg=None, device=dev,
                                   model_dir=h5dir, allow_download=False)
        t_vfs = time.perf_counter() - t0
        paths = [os.path.basename(m.path) for m in (
            s.vad.model, s.gender.model, v.gender_detection_mlp_model)]
        log(f"[real] {attempt} construction from {h5dir}: Segmenter "
            f"{t_seg!r} s, VoiceFemininityScoring {t_vfs!r} s; models read "
            f"from {paths}")
        built.append((s, v, paths))
    (seg_h5, vfs_h5, first), (_, _, second) = built
    check(all(p.endswith(".hdf5") for p in first),
          f"the first construction did not read the hdf5 files: {first}")
    check(all(p.endswith(".npz") for p in second),
          f"the second construction did not take the npz cache: {second}")
    cached = [n for n in stems
              if os.path.exists(os.path.join(h5dir, n + ".npz"))]
    check(cached == ["interspeech2023_all", "keras_male_female_cnn",
                     "keras_speech_music_noise_cnn"],
          f"conversion cache written for {cached}, not for the three "
          "models loaded")
    for a, b, name in ((seg_h5.vad.model, seg.vad.model, "VAD CNN"),
                       (seg_h5.gender.model, seg.gender.model, "gender CNN"),
                       (vfs_h5.gender_detection_mlp_model,
                        vfs.gender_detection_mlp_model, "VFS MLP")):
        check(same_weights(torch, a, b),
              f"{name}: hdf5-route weights differ from the npz route's")
    wav = wavs[list(files).index("mix600")]
    n_diff, n_fr = frames_differ(seg_h5(wav), seg(wav))
    got, want = vfs_h5(wav), vfs(wav)
    log(f"[real] hdf5 route vs npz route: weights bit-equal; mix600 labels "
        f"{n_diff} of {n_fr} frames differ; VFS {got} vs {want}")
    check(n_diff == 0, "hdf5-route labels differ from the npz route's")
    check(got == want, "hdf5-route VFS result differs from the npz route's")


def cnn_tier_run(torch, seg, sig, speech20=None, reps=3):
    """The two CNNs of the warm 10 min file, each timed alone (median of
    ``reps``, device synced): -> (VAD probs on energy frames, gender probs
    on ``speech20`` (this tier's speech when None), VAD ms, gender ms,
    speech20)."""
    from inaspeechsegmenter_tpu_torch.segmenter import patch_counts

    p = seg.pipeline
    mspec, loge, t, difflen = seg._sig2feats(sig)
    n_fp, n20 = patch_counts(t, difflen)
    energy20 = p._energy_states20(loge[:t])[:n20]

    def timed(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(times))

    probs_v, ms_v = timed(lambda: p._cnn_probs(
        p.vad_model, mspec, n_fp, p.vad_nmel, p.vad_nout, energy20))
    if speech20 is None:
        states = p._masked_viterbi(probs_v, energy20, p.v_trans, p.v_init)
        speech20 = energy20 & (states == 0)
    probs_g, ms_g = timed(lambda: p._cnn_probs(
        p.g_model, mspec, n_fp, p.g_nmel, p.g_nout, speech20))
    return (probs_v[energy20].cpu().numpy(), probs_g[speech20].cpu().numpy(),
            ms_v, ms_g, speech20)


def batch_at_tier(torch, dev, workdir, params, wavs, models):
    """``batch_score`` of phase 2's WAVs with the ResNet at ``high`` on the
    consumer thread while the producer threads run the VAD CNN and the VBx
    features at ``highest``: what they prepared is bit-equal to a serial
    run's, and the process's TF32 flags end as they began."""
    from inaspeechsegmenter_tpu_torch import VoiceFemininityScoring
    from inaspeechsegmenter_tpu_torch.utils.prefetch import prefetch_depth

    os.environ["ISS_XVEC_PRECISION"] = "high"
    try:
        v = VoiceFemininityScoring("bgc", ffmpeg=None, device=dev,
                                   model_dir=models, xvector_params=params,
                                   allow_download=False)
    finally:
        os.environ.pop("ISS_XVEC_PRECISION", None)
    check(v.xvector_model.net.precision == "high",
          "the batch's ResNet was not built at tier high")
    serial, prepared = v._prepare, {}

    def recording(path):
        prepared[path] = serial(path)
        return prepared[path]

    v._prepare = recording
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    csvs = [os.path.join(workdir, "vfs_high", os.path.basename(w)[:-4]
                         + ".csv") for w in wavs]
    _, n_ok, _, lmsg = v.batch_score(wavs, csvs)
    check(n_ok == len(wavs), f"vfs batch at tier high: statuses {lmsg}")
    after = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    check(after == flags, f"the batch left the TF32 flags at {after}, not "
                          f"{flags}")
    for wav in wavs:
        got, want = prepared[wav], serial(wav)
        check(got[0] == want[0] and got[3:] == want[3:]
              and got[2].intervals == want[2].intervals,
              f"{wav}: the batch's VAD differs from a serial run's")
        check((got[1] is None and want[1] is None)
              or torch.equal(got[1], want[1]),
              f"{wav}: the batch's VBx features differ from a serial run's")
    log(f"[tiers] batch_score with ISS_XVEC_PRECISION=high (prefetch depth "
        f"{prefetch_depth()}): {len(wavs)} files; VAD and VBx features of "
        f"the producer threads bit-equal to a serial run; TF32 flags "
        f"{after} as before")


def phase_tiers(torch, dev, workdir, vfs, params, files, wavs, models):
    """(b): the CNN and x-vector precision tiers at full width."""
    from torch.utils.flop_counter import FlopCounterMode

    from inaspeechsegmenter_tpu_torch import Segmenter
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNet101XVector
    from inaspeechsegmenter_tpu_torch.vfs import (STEP, WINLEN,
                                                  TorchResnetExtractor)

    sig = files["mix600"]
    wav = wavs[list(files).index("mix600")]
    ref = {}
    try:
        for tier in TIERS:
            os.environ["ISS_CNN_PRECISION"] = tier
            s = Segmenter("smn", True, ffmpeg=None, device=dev,
                          model_dir=models, allow_download=False)
            check(s.vad.model.precision == s.gender.model.precision == tier,
                  f"the CNNs were not built at tier {tier}")
            lseg = s(wav)
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                s(wav)
                walls.append(time.perf_counter() - t0)
            probs_v, probs_g, ms_v, ms_g, speech20 = cnn_tier_run(
                torch, s, sig, ref.get("speech20"))
            if tier == "highest":
                ref = dict(lseg=lseg, probs_v=probs_v, probs_g=probs_g,
                           speech20=speech20)
            n_diff, n_fr = frames_differ(lseg, ref["lseg"])
            err_v = float(np.abs(probs_v - ref["probs_v"]).max())
            err_g = float(np.abs(probs_g - ref["probs_g"]).max())
            log(f"[tiers] ISS_CNN_PRECISION={tier}: mix600 warm wall "
                f"{float(np.median(walls)) * 1e3!r} ms (median of {walls}), "
                f"VAD CNN {ms_v!r} ms ({len(probs_v)} patches), gender CNN "
                f"{ms_g!r} ms ({len(probs_g)} patches); {n_diff} of {n_fr} "
                f"frames ({100 * n_diff / n_fr!r}%) differ from highest; "
                f"max |p - p_highest| VAD {err_v!r} gender {err_g!r}")
            if tier != "highest":
                check(max(err_v, err_g) <= CNN_TIER_ATOL,
                      f"CNN tier {tier} beyond {CNN_TIER_ATOL} of highest")
                check(err_v > 0 and err_g > 0,
                      f"CNN tier {tier} is bit-equal to highest")
    finally:
        os.environ.pop("ISS_CNN_PRECISION", None)

    fea = vfs.features.features(sig.astype(np.float64) / 32768.0)
    starts = list(range(0, fea.shape[0] - WINLEN, STEP))
    embs = {}
    try:
        for tier in TIERS:
            os.environ["ISS_XVEC_PRECISION"] = tier
            xm = TorchResnetExtractor(params, ResNet101XVector(), dev)
            check(xm.net.precision == tier,
                  f"the ResNet was not built at tier {tier}")
            xm.embeddings_from_features(fea, starts[:256])      # warm-up
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                embs[tier] = xm.embeddings_from_features(fea, starts)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            t_res = float(np.median(times))
            with FlopCounterMode(display=False) as counter, torch.no_grad():
                xm.net(fea[:WINLEN].T[None])
            flops = counter.get_total_flops()
            err = rel_l2(embs[tier], embs["highest"])
            log(f"[tiers] ISS_XVEC_PRECISION={tier}: {len(starts)} windows "
                f"in {t_res!r} s (median of {times}), windows/s "
                f"{len(starts) / t_res!r}, ResNet TFLOP/s "
                f"{len(starts) * flops / t_res / 1e12!r}; embeddings max "
                f"relative L2 vs highest {err!r}")
            if tier != "highest":
                check(err <= XVEC_TIER_RTOL[tier],
                      f"x-vector tier {tier} beyond {XVEC_TIER_RTOL[tier]}")
                check(err > 0, f"x-vector tier {tier} is bit-equal to "
                               "highest")
    finally:
        os.environ.pop("ISS_XVEC_PRECISION", None)

    batch_at_tier(torch, dev, workdir, params, wavs, models)

    tails = {}
    try:
        for mode in ("masked", "exact"):
            os.environ["ISS_XVEC_TAIL"] = mode
            out = vfs.xvector_model("mix600", fea, len(sig) / SR)
            tails[mode] = out[-1]
    finally:
        os.environ.pop("ISS_XVEC_TAIL", None)
    (key_m, _, emb_m), (key_e, _, emb_e) = tails["masked"], tails["exact"]
    check(key_m == key_e and key_e.endswith(f"-{fea.shape[0]:08}")
          and np.isfinite(emb_e).all(),
          "the exact tail window differs in key, is no tail or not finite")
    log(f"[tiers] ISS_XVEC_TAIL=exact: tail window {key_e}, relative L2 "
        f"from the masked tail {rel_l2(emb_e[None], emb_m[None])!r}")


STAND_IN_FFMPEG = """#!{python}
import struct, sys
import numpy as np
sys.path.insert(0, {audio!r})
from wav import read_wav
args = sys.argv[1:]
def val(flag):
    return args[args.index(flag) + 1] if flag in args else None
assert val('-f') == 'wav' and val('-acodec') == 'pcm_s16le'
assert val('-ar') == '16000' and val('-ac') == '1' and args[-1] == 'pipe:1'
sig, sr = read_wav(val('-i'), dtype='float64')
if sig.ndim > 1:
    sig = sig.mean(axis=1)
if sr != 16000:
    n = round(len(sig) * 16000 / sr)
    sig = np.fft.irfft(np.fft.rfft(sig)[:n // 2 + 1], n) * (n / len(sig))
a = int(float(val('-ss') or 0) * 16000)
b = int(float(val('-to')) * 16000) if val('-to') else len(sig)
pcm = np.clip(np.rint(sig[a:b] * 32768.0), -32768, 32767).astype('<i2')
fmt = struct.pack('<HHIIHH', 1, 1, 16000, 32000, 2, 16)
sys.stdout.buffer.write(b'RIFF' + b'\\xff' * 4 + b'WAVE' + b'fmt '
                        + struct.pack('<I', 16) + fmt + b'data'
                        + b'\\xff' * 4 + pcm.tobytes())
"""


def phase_ffmpeg(torch, dev, workdir, seg, files, wavs, models):
    """(c): media decode through a stand-in ffmpeg on ``PATH``.  -> the
    kernel launches of the decode runs and of the whole-file one."""
    import stat

    from inaspeechsegmenter_tpu_torch import Segmenter
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav

    bindir = os.path.join(workdir, "bin")
    os.makedirs(bindir)
    script = os.path.join(bindir, "ffmpeg")
    audio = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "inaspeechsegmenter_tpu_torch", "audio")
    with open(script, "w") as fh:
        fh.write(STAND_IN_FFMPEG.format(python=sys.executable, audio=audio))
    os.chmod(script, os.stat(script).st_mode | stat.S_IEXEC)
    os.environ["PATH"] = bindir + os.pathsep + os.environ.get("PATH", "")

    mono = files["mix60"].astype(np.float64) / 32768.0
    n = round(len(mono) * 44100 / SR)
    up = np.fft.irfft(np.fft.rfft(mono), n) * (n / len(mono))
    wav44 = os.path.join(workdir, "mix60_44k_stereo.wav")
    write_wav(wav44, np.clip(np.stack([up, 0.8 * up], axis=1), -1, 1)
              .astype(np.float32), 44100, subtype="FLOAT")

    seg_ff = Segmenter("smn", True, ffmpeg="ffmpeg", device=dev,
                       model_dir=models, allow_download=False)
    reset_kernel_counts()
    whole = seg_ff(wav44)
    per_file = kernel_counts()
    start, stop = FFMPEG_WINDOW
    window = seg_ff(wav44, start_sec=start, stop_sec=stop)
    launches = kernel_counts()
    for lseg, (a, b) in ((whole, (0.0, len(mono) / SR)), (window, (start,
                                                                   stop))):
        check(lseg[0][1] == a and abs(lseg[-1][2] - b) <= 0.04,
              f"ffmpeg decode: segments span {lseg[0][1]}-{lseg[-1][2]}, "
              f"not {a}-{b}")
        check(all(x[2] == y[1] for x, y in zip(lseg[:-1], lseg[1:])),
              "ffmpeg decode: segments do not tile the window")
    check_segmentation_launches(per_file, "the ffmpeg path")
    for name in SEGMENTATION_KERNELS:
        check(launches[name] > per_file[name],
              f"the ffmpeg window did not launch the {name} kernel")
    n_diff, n_fr = frames_differ(whole, seg(wavs[list(files).index("mix60")]))
    log(f"[real] ffmpeg stand-in, 44.1 kHz stereo mix60: {len(whole)} "
        f"segments, window {FFMPEG_WINDOW} {len(window)} segments; "
        f"launches {launches} (whole file {per_file}); {n_diff} of {n_fr} "
        "frames differ from the 16 kHz WAV's labels (resampled twice)")
    try:
        Segmenter("smn", True, ffmpeg="no-such-binary", device=dev,
                  model_dir=models, allow_download=False)
    except Exception as exc:            # the reference's bare Exception
        check(str(exc) == "ffmpeg program not found",
              f"unknown ffmpeg binary raised {exc!r}")
    else:
        raise RuntimeError("check failed: an unknown ffmpeg binary was "
                           "accepted")
    return launches, per_file


def phase_real_inputs(torch, dev, workdir, seg, vfs, params, files, wavs,
                      models):
    """hdf5 weights, precision tiers, ffmpeg decode.  -> the kernel
    launches of the ffmpeg path's run and of its whole-file decode."""
    phase_hdf5(torch, dev, workdir, seg, vfs, files, wavs, models)
    phase_tiers(torch, dev, workdir, vfs, params, files, wavs, models)
    return phase_ffmpeg(torch, dev, workdir, seg, files, wavs, models)


# --------------------------------------------------------------------------
GENERAL_K_CONSECUTIVE = 10      # 3 states of 10 frames at least: K = 30
GENERAL_K_CONSTRAINED = 8       # states of the constrained decode


def host_ms(fn, reps=5):
    """Median host wall of ``fn`` (no device sync inside the timing; one
    before each run)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return out, float(np.median(times))


def synced_ms(torch, fn, reps=3):
    """Median wall of ``fn`` with a device sync before and after."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


def phase_vbx_grid(torch, dev, vfs, files):
    """6(a): the int16 VBx grid on the 10 min mix.  -> (features, launches
    of one VFS file on the grid)."""
    from inaspeechsegmenter_tpu_torch.annotations import SpeechTimeline
    from inaspeechsegmenter_tpu_torch.dsp import vbx_host
    from inaspeechsegmenter_tpu_torch.dsp.vbx import (
        VBX_BLK, VbxFrontend, VbxPcmStream, device_atol, host_segment)

    sig = files["mix600"]
    n = len(sig)
    signal = sig.astype(np.float64) / 32768.0
    fe = vfs.features
    with vbx_grid(False):
        fea32 = fe.features(signal)
        want_f32 = vfs.score_signal(sig, "mix600")
    fea16 = fe._features_i16(sig, n)
    n_fr = fea16.shape[0]
    # each path's CMVN cumsum rounds on its own: the f32 path's over the
    # whole file, the grid's over one block at most
    bound_f32, bound_i16 = device_atol(n_fr), device_atol(n_fr, blocked=True)
    err = float((fea16 - fea32).abs().max())
    # the reference's float64 host features (dither from the same seed)
    ref = torch.from_numpy(vbx_host.get_features(signal)).to(dev)
    err16 = float((fea16 - ref).abs().max())
    err32 = float((fea32 - ref).abs().max())
    log(f"[grid] mix600 (T={n_fr}, {-(-n_fr // VBX_BLK)} blocks of "
        f"{VBX_BLK}): int16 grid vs f32 path max_abs={err!r} (bound "
        f"{bound_f32 + bound_i16!r}); against the float64 host reference "
        f"(dsp.vbx_host) int16 grid {err16!r} (bound {bound_i16!r}), f32 "
        f"path {err32!r}")
    check(err <= bound_f32 + bound_i16, "int16 and f32 VBx features differ")
    check(err16 <= bound_i16, "the int16 grid differs from the reference")

    # host work: the f32 path's host half against the grid's
    fresh = VbxFrontend(dev)
    _, grow_ms = synced_ms(torch, lambda: fresh._dither_buffer(n + 2 * SR),
                           reps=1)
    _, f32_host = host_ms(lambda: host_segment(signal))
    x = torch.from_numpy(sig).to(dev)
    _, i16_host = host_ms(lambda: fe.features_from_pcm([x], n))
    dev_ms = cuda_ms(lambda: fe.features_from_pcm([x], n), 5, torch)
    log(f"[grid] mix600 host work: f32 path host half (scale, dither, "
        f"mirror pad in numpy) {f32_host!r} ms; int16 grid from the VAD's "
        f"upload {i16_host!r} ms (enqueue, no sync); one-time dither growth "
        f"{grow_ms!r} ms; blocked features on the device {dev_ms!r} ms "
        "(CUDA events)")

    # the VFS tuple on both paths, and the shared-PCM route
    got = vfs.score_signal(sig, "mix600")
    log(f"[grid] mix600 VFS on the int16 grid {got}, on the f32 path "
        f"{want_f32}")
    check(got == want_f32, "VFS differs between the int16 and f32 paths")
    stream = VbxPcmStream(fe, n)
    rng = np.random.default_rng(6)
    pos = 0
    while pos < n:
        k = int(rng.integers(1, 3 * SR))
        stream.append(sig[pos:pos + k])
        pos += k
    check(torch.equal(stream.finish(), fea16),
          "VbxPcmStream in pieces differs from the whole-file features")
    lseg, pcm = vfs.vad.segment_signal(sig, 0, "mix600", return_pcm=True)
    check(pcm is not None and len(pcm) == 1 and pcm[0].dtype == torch.int16,
          "segment_signal(return_pcm=True) handed back no int16 upload")
    check(torch.equal(fe.features_from_pcm(pcm, n), fea16),
          "the shared-PCM route differs from _features_i16")
    log("[grid] VbxPcmStream in uneven pieces (1 sample to 3 s) bit-equal "
        "to the whole-file call; shared-PCM route bit-equal to _features_i16")

    # the VFS path's stage split on the grid (median of 3 by total)
    splits = []
    for _ in range(3):
        (lseg, pcm), t_vad = synced_ms(torch, lambda: vfs.vad.segment_signal(
            sig, 0, "mix600", return_pcm=True), reps=1)
        timeline = SpeechTimeline.from_vad(lseg)
        fea, t_fea = synced_ms(torch, lambda: fe.features_from_pcm(pcm, n),
                               reps=1)
        xv, t_res = synced_ms(torch, lambda: vfs.xvector_model(
            "mix600", fea, n / SR, timeline=timeline), reps=1)
        res, t_mlp = synced_ms(torch, lambda: vfs._score_xvectors(
            xv, timeline, timeline.total_duration()), reps=1)
        splits.append((t_vad, t_fea, t_res, t_mlp))
    t_vad, t_fea, t_res, t_mlp = sorted(splits, key=sum)[1]
    total = t_vad + t_fea + t_res + t_mlp
    for name, t in (("VAD + int16 upload", t_vad),
                    ("VBx int16 grid from the upload", t_fea),
                    ("ResNet101 x-vectors", t_res), ("MLP + scoring", t_mlp)):
        log(f"[grid] mix600 VFS stage {name}: {t!r} ms "
            f"({100 * t / total:.1f}%)")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        vfs.score_signal(sig, "mix600")
        walls.append(time.perf_counter() - t0)
    reset_kernel_counts()
    vfs.score_signal(sig, "mix600")
    torch.cuda.synchronize()
    per_file = kernel_counts()
    rtf = n / SR / float(np.median(walls))
    log(f"[grid] mix600 VFS stages sum {total!r} ms; result {res}; warm "
        f"score_signal walls {walls} s, rtf {rtf!r}; kernel launches per "
        f"file {per_file}")
    check_segmentation_launches(per_file, "the VFS on the int16 grid")
    return fea16, per_file


def phase_bucket(torch, vfs, fea, speech_rate):
    """6(b): the ResNet over all windows of the 10 min mix with the tail
    bucket, and the padded tail sub-batch against the ragged one."""
    from inaspeechsegmenter_tpu_torch.vfs import STEP, WINLEN

    xm = vfs.xvector_model
    starts = list(range(0, fea.shape[0] - WINLEN, STEP))
    sub, buckets = xm._xvec_layout()
    xm.embeddings_from_features(fea, starts)                     # warm-up
    _, ms = synced_ms(torch, lambda: xm.embeddings_from_features(fea, starts))
    rate = len(starts) / ms * 1e3
    tail = len(starts) % sub
    bucket = next(b for b in buckets if b >= tail) if tail else 0
    log(f"[bucket] ResNet over all {len(starts)} windows of mix600 with the "
        f"tail bucket ({len(starts) // sub} x {sub} + {tail} padded to "
        f"{bucket}): {ms!r} ms, windows/s {rate!r}; phase 3's speech "
        f"windows/s {speech_rate!r} (ratio {rate / speech_rate!r})")
    if tail:
        st = torch.tensor(starts[-tail:], device=fea.device)
        wins = fea[st[:, None] + torch.arange(WINLEN, device=fea.device)[
            None, :]].transpose(1, 2).contiguous()
        with torch.no_grad():
            ragged_ms = cuda_ms(lambda: xm.net(wins), 5, torch)
            padded_ms = cuda_ms(lambda: xm.get_embeddings_batch(wins), 5,
                                torch)
            full = fea[torch.tensor(starts[:sub], device=fea.device)[:, None]
                       + torch.arange(WINLEN, device=fea.device)[None, :]
                       ].transpose(1, 2).contiguous()
            full_ms = cuda_ms(lambda: xm.net(full), 5, torch)
        log(f"[bucket] tail sub-batch of {tail} windows: ragged forward "
            f"{ragged_ms!r} ms, padded to {bucket} {padded_ms!r} ms; a full "
            f"sub-batch of {sub} {full_ms!r} ms (CUDA events, mean of 5)")


def phase_online_vfs(torch, vfs, files):
    """6(c): ``OnlineVFS`` over the 10 min mix in 0.5 s blocks on the int16
    grid.  -> the kernel launches of that online file."""
    from inaspeechsegmenter_tpu_torch import OnlineVFS

    sig = files["mix600"]
    step = int(ONLINE_BLOCK_SECONDS * SR)
    reset_kernel_counts()
    ov = OnlineVFS(vfs, "mix600")
    polls, retained = [], []
    t0 = time.perf_counter()
    for pos in range(0, len(sig), step):
        ov.feed(sig[pos:pos + step])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ov.current()
        torch.cuda.synchronize()
        polls.append((time.perf_counter() - t1) * 1e3)
        if pos >= 400:      # the stream held 400 samples before this feed
            retained.append(ov.buffered_samples)
    got = ov.finalize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_file = kernel_counts()
    check(ov._use_stream, "OnlineVFS did not take the int16 stream path")
    want = vfs.score_signal(sig, "mix600")
    log(f"[online-vfs] mix600 in {ONLINE_BLOCK_SECONDS} s blocks: "
        f"{len(polls)} polls, poll median {float(np.median(polls))!r} ms, "
        f"max {float(np.max(polls))!r} ms; PCM retained after 400 samples: "
        f"max {max(retained)} samples; {len(ov._emb)} windows embedded "
        f"online; wall {wall!r} s; finalize {got}, score_signal {want}; "
        f"kernel launches {per_file}")
    check(max(retained) == 0, "OnlineVFS kept PCM past 400 samples")
    check(got == want, "OnlineVFS.finalize differs from score_signal")
    check_segmentation_launches(per_file, "the online VFS")
    return per_file


def viterbi_general_bound(T, K):
    return bound(T * K * 4 + T + T * 4 + (K * K + K) * 4,
                 T * (2 * K * K + 2 * K))


def general_viterbi_inputs(T):
    """6(d)'s seeded decodes -> (the ``viterbi_decoding`` calls: name ->
    (emission, transition, keywords); the kernel's own inputs: name ->
    (emission, transition, initial, reset) as numpy arrays).  The kernel's
    inputs are the K = 30 expansion of the first call (it never converges:
    the serial walk), the K = 8 constrained call's emissions after its
    constraints (it converges) and a random dense K = 30 decode."""
    from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
    from inaspeechsegmenter_tpu_torch.decode.transitions import diag_trans_exp

    rng = np.random.default_rng(66)
    em3 = np.log(rng.dirichlet(np.ones(3), T))
    tr3 = diag_trans_exp(0.7, 3)
    K8 = GENERAL_K_CONSTRAINED
    em8 = np.log(rng.dirichlet(np.ones(K8), T))
    tr8 = np.log(rng.dirichlet(np.ones(K8) * 3, K8))
    con = np.zeros((T, K8), int)
    con[rng.random((T, K8)) < 0.05] = tv.VITERBI_CONSTRAINT_FORBIDDEN
    con[rng.choice(T, 500, replace=False), rng.integers(0, K8, 500)] = \
        tv.VITERBI_CONSTRAINT_MANDATORY
    reset8 = rng.random(T) < 0.001
    calls = {f"consecutive={GENERAL_K_CONSECUTIVE} on 3 states (K="
             f"{3 * GENERAL_K_CONSECUTIVE})":
             (em3, tr3, dict(consecutive=GENERAL_K_CONSECUTIVE)),
             f"K={K8}, forbidden and mandatory frames, resets":
             (em8, tr8, dict(constraint=con, reset=reset8))}
    em, tr, ini, _, _ = tv._expand_consecutive(
        em3.astype(np.float32), tr3, np.log(np.ones(3) / 3),
        np.zeros((T, 3)), np.full(3, GENERAL_K_CONSECUTIVE))
    reset = np.zeros(T, bool)
    reset[0] = True
    em_c = em8.astype(np.float32)
    em_c[con == tv.VITERBI_CONSTRAINT_FORBIDDEN] = tv.LOG_ZERO
    for t, k in zip(*np.where(con == tv.VITERBI_CONSTRAINT_MANDATORY)):
        keep = em_c[t, k]
        em_c[t] = tv.LOG_ZERO
        em_c[t, k] = keep
    reset_c = reset8.copy()
    reset_c[0] = True
    K_dense = 3 * GENERAL_K_CONSECUTIVE
    rng = np.random.default_rng(67)
    reset_d = rng.random(T) < 0.001
    reset_d[0] = True
    kernel = {
        f"consecutive={GENERAL_K_CONSECUTIVE} (K={em.shape[1]})":
            (em, tr, ini, reset),
        f"K={K8} constrained": (em_c, tr8, np.full(K8, np.log(1.0 / K8)),
                                reset_c),
        f"K={K_dense} random dense": (
            np.log(rng.dirichlet(np.ones(K_dense), T)),
            np.log(rng.dirichlet(np.ones(K_dense) * 3, K_dense)),
            np.full(K_dense, np.log(1.0 / K_dense)), reset_d)}
    kernel = {name: tuple(np.ascontiguousarray(
        a, bool if a.dtype == bool else np.float32) for a in arrays)
        for name, arrays in kernel.items()}
    return calls, kernel


def general_parts_ms(ctl):
    """The general-K launch's part times from its ctl words (ms from the
    launch's start to the end of: the passes, the walk, the maps, the
    summaries, the chain of summaries)."""
    return [int(x) / 1e6 for x in ctl[8:13].tolist()]


def phase_general_viterbi(torch, dev):
    """6(d): the general-K kernel through ``viterbi_decoding``, against the
    plain loop.  -> the kernel's JSON entry and the API run's launches."""
    from inaspeechsegmenter_tpu_torch.decode import viterbi as tv

    T = VITERBI_T
    cases, inputs = general_viterbi_inputs(T)
    reset_kernel_counts()
    got = {name: tv.viterbi_decoding(em, tr, device=dev, **kw)
           for name, (em, tr, kw) in cases.items()}
    torch.cuda.synchronize()
    launches = kernel_counts()
    check(launches["viterbi_general"] == len(cases),
          f"viterbi_decoding launched the general-K kernel "
          f"{launches['viterbi_general']} times")
    check_cnn_launches(launches, "viterbi_decoding")
    for name, (em, tr, kw) in cases.items():
        t0 = time.perf_counter()
        want = tv.viterbi_decoding(em, tr, device="cpu", **kw)
        plain_api_ms = (time.perf_counter() - t0) * 1e3
        n_diff = int((got[name] != want).sum())
        log(f"[viterbi-k] viterbi_decoding {name}, T={T}: {n_diff} states "
            f"differ from the plain run on the CPU ({plain_api_ms!r} ms)")
        check(n_diff == 0, f"viterbi_decoding {name}: states differ")
    # the kernel alone, against its plain version on the same card tensors
    per_case = {}
    for name, arrays in inputs.items():
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        K = args[0].shape[1]
        sk = tv.viterbi_scan_general(*args)
        torch.cuda.synchronize()
        passes, walked = tv.pass_count(), tv.walked_chunks()
        chunks = int(tv.viterbi_scan_general.last_ctl[5])
        t0 = time.perf_counter()
        sp = tv.viterbi_scan_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        n_diff = int((sk != sp).sum())
        check(n_diff == 0, f"general-K kernel {name}: {n_diff} states differ")
        parts = general_parts_ms(tv.viterbi_scan_general.last_ctl)
        copies = [[torch.from_numpy(a).to(dev) for a in arrays]
                  for _ in range(rotation(sum(a.nbytes for a in arrays)
                                          + 4 * T))]
        tm = timing(torch, [lambda a=a: tv.viterbi_scan_general(*a)
                            for a in copies], ("gk_kernel",),
                    lambda: tv.viterbi_scan_general(*args), 3, rounds=1)
        bound_ms, bound_by = viterbi_general_bound(T, K)
        per_case[name] = {"ms": tm["device_ms"], **tm, "plain_ms": plain_ms,
                          "passes": passes, "walked_chunks": walked,
                          "chunks": chunks, "parts_ms": parts,
                          "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"[viterbi-k] kernel {name}, T={T}: states equal to the plain "
            f"loop; device_ms={tm['device_ms']!r} ({tm['device_by']}) over "
            f"{len(copies)} "
            f"distinct inputs, call_ms={tm['call_ms']!r}, floor_ms="
            f"{tm['floor_ms']!r}, passes={passes} walked_chunks={walked} "
            f"of {chunks} parts_ms(passes, walk, maps, summaries, chain, "
            f"cumulative)={parts} plain_ms={plain_ms!r} bound_ms={bound_ms!r} "
            f"({bound_by})")
    main = per_case[next(iter(per_case))]
    entry = {"name": "viterbi_general", "route": "cuda",
             "source": "inaspeechsegmenter_tpu_torch/csrc/viterbi.cu",
             "replaces": "inaspeechsegmenter_tpu/decode/viterbi.py:222",
             "max_abs_err": 0.0, "ms": main["ms"],
             "device_ms": main["device_ms"], "device_by": main["device_by"],
             "call_ms": main["call_ms"], "floor_ms": main["floor_ms"],
             "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
             "bound_by": main["bound_by"], "library_ms": None,
             "library_note": "no single PyTorch call computes the function",
             "size": f"T={T}, K={3 * GENERAL_K_CONSECUTIVE} (3 states, "
                      f"consecutive={GENERAL_K_CONSECUTIVE})",
             "cases": per_case}
    return entry, launches


def phase_dnn_stage(torch, dev, seg, files, models):
    """6(e): ``DnnSegmenter.__call__`` of the smn and gender stages on the
    60 s mix, cuda against cpu.  -> the kernel launches of the cuda run."""
    from inaspeechsegmenter_tpu_torch import segmenter as tseg
    from inaspeechsegmenter_tpu_torch.pipeline import rle

    sig = files["mix60"]
    mspec, loge, t, difflen = seg._sig2feats(sig)
    n20 = (t + 1) // 2
    energy = seg.pipeline._energy_states20(loge[:t])[:n20].cpu().numpy()
    lseg = [("energy" if lab else "noEnergy", a, b)
            for lab, a, b in rle(energy.astype(np.int32))]
    m = mspec.cpu().numpy()
    out = {}
    for device in (dev, "cpu"):
        vad = tseg.SpeechMusicNoise(32, False, device=device,
                                    model_dir=models)
        gender = tseg.Gender(32, False, device=device, model_dir=models)
        if device == dev:
            reset_kernel_counts()
        t0 = time.perf_counter()
        lv = vad(m, lseg)
        lg = gender(m, lv)
        wall = time.perf_counter() - t0
        if device == dev:
            torch.cuda.synchronize()
            launches = kernel_counts()
        out[str(device)] = (lv, lg, wall)
    (lv_c, lg_c, w_c), (lv_p, lg_p, w_p) = out[str(dev)], out["cpu"]

    def frames(ls):
        return np.concatenate([np.full(b - a, lab, object)
                               for lab, a, b in ls])

    n_diff = int((frames(lg_c) != frames(lg_p)).sum())
    log(f"[dnn-stage] mix60 DnnSegmenter.__call__ smn then gender: "
        f"{len(lg_c)} segments; cuda vs cpu: lseg equal {lg_c == lg_p} "
        f"(smn {lv_c == lv_p}), {n_diff} of {n20} frames differ; walls cuda "
        f"{w_c!r} s, cpu {w_p!r} s; kernel launches {launches}")
    check(n_diff <= 0.001 * n20, "DnnSegmenter cuda and cpu differ on >0.1%")
    check({k: v for k, v in launches.items() if k not in CNN_KEYS} == {
        "sidekit_fe": 0, "viterbi": 2, "viterbi_general": 0,
        "unpack_bits": 0, "unpack_zero_elide": 0},
        "the two stages did not launch one K <= 3 Viterbi each")
    check(launches["cnn_forwards"] > 0, "the two stages ran no fused CNN")
    check_cnn_launches(launches, "the two stages")
    return launches


def phase_resampled(torch, dev, workdir, seg, files, wavs):
    """6(f): a 44.1 kHz WAV with ``ffmpeg=None`` through the native
    resampler.  -> the kernel launches of that file, its labels."""
    from inaspeechsegmenter_tpu_torch.audio import native
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav

    t0 = time.perf_counter()
    check(native.available(), "the native resampler did not build")
    build_s = time.perf_counter() - t0
    mono = files["mix60"].astype(np.float64) / 32768.0
    n = round(len(mono) * 44100 / SR)
    up = np.fft.irfft(np.fft.rfft(mono), n) * (n / len(mono))
    wav44 = os.path.join(workdir, "mix60_44k.wav")
    write_wav(wav44, to_int16(np.clip(up, -1, 1)), 44100)
    reset_kernel_counts()
    got = seg(wav44)
    torch.cuda.synchronize()
    launches = kernel_counts()
    n_diff, n_fr = frames_differ(got, seg(wavs[list(files).index("mix60")]))
    log(f"[resample] 44.1 kHz PCM16 mix60 with ffmpeg=None: native build and "
        f"load {build_s!r} s ({os.path.basename(native.library_path())}); "
        f"{len(got)} segments; {n_diff} of {n_fr} frames "
        f"({100 * n_diff / n_fr!r}%) differ from the 16 kHz WAV's labels; "
        f"kernel launches {launches}")
    check(got[0][1] == 0.0 and all(x[2] == y[1] for x, y in zip(got[:-1],
                                                               got[1:])),
          "resampled segments do not tile the file")
    check_segmentation_launches(launches, "the resampled file")
    check(launches["sidekit_fe"] == 1, "the resampled file skipped features")
    return launches, got


def phase_reference(torch, dev, workdir, seg, vfs, files, wavs, models,
                    speech_rate):
    """Phase 6: the int16 grid, the tail bucket, the online VFS stream, the
    general-K Viterbi, the per-stage API and the resampler.  -> the general
    kernel's entry, the launches of each run, the resampled labels."""
    fea16, per_vfs = phase_vbx_grid(torch, dev, vfs, files)
    phase_bucket(torch, vfs, fea16, speech_rate)
    per_online = phase_online_vfs(torch, vfs, files)
    entry, per_api = phase_general_viterbi(torch, dev)
    per_stage = phase_dnn_stage(torch, dev, seg, files, models)
    per_resampled, resampled = phase_resampled(torch, dev, workdir, seg,
                                               files, wavs)
    return entry, {"vfs_int16_grid": per_vfs, "online_vfs": per_online,
                   "viterbi_decoding": per_api, "dnn_stage": per_stage,
                   "resampled_wav": per_resampled}, resampled


# --------------------------------------------------------------------------
TRAIN_BATCH = 256
TRAIN_STEPS = 60               # steps of the card's run (the 10 min mix)
TRAIN_CPU_STEPS = 3            # steps held against the CPU
TRAIN_LOSS_RTOL = 1e-3         # cuda vs cpu losses of the first steps
PATCH_ATOL = 1e-4              # cuda vs cpu patches: the features tolerance


def phase_train(torch, dev, workdir, seg, files, wavs, models):
    """7(a): annotate -> patch_dataset -> Trainer -> export -> serve on the
    card.  -> kernel launches of the path (dataset and serving)."""
    from inaspeechsegmenter_tpu_torch import Segmenter, seg2csv
    from inaspeechsegmenter_tpu_torch.models.registry import load_patch_model
    from inaspeechsegmenter_tpu_torch.train import (ENGINES, Trainer,
                                                    patch_dataset)

    wav = wavs[list(files).index("mix600")]
    annot = os.path.join(workdir, "annot", "mix600.csv")
    os.makedirs(os.path.dirname(annot))
    seg2csv(seg(wav), annot)

    reset_kernel_counts()
    t0 = time.perf_counter()
    x, y = patch_dataset([(wav, annot)], "smn", ffmpeg=None, device=dev)
    ds_s = time.perf_counter() - t0
    launches = kernel_counts()
    t0 = time.perf_counter()
    xc, yc = patch_dataset([(wav, annot)], "smn", ffmpeg=None, device="cpu")
    ds_cpu_s = time.perf_counter() - t0
    check(x.shape == xc.shape and (y == yc).all(),
          f"cuda and cpu datasets differ in shape {x.shape} {xc.shape} or "
          "labels")
    x_err = float(np.abs(x - xc).max())
    counts = dict(zip(ENGINES["smn"][0],
                      np.bincount(y, minlength=3).tolist()))
    log(f"[train] patch_dataset of the 10 min mix (smn): {len(x)} patches "
        f"{x.shape[1:]}, classes {counts}, "
        f"cuda {ds_s!r} s (cpu {ds_cpu_s!r} s), launches {launches}; "
        f"cuda vs cpu max_abs_err={x_err!r} (atol {PATCH_ATOL}), labels equal")
    check(x_err <= PATCH_ATOL, "cuda and cpu patches differ")
    check(launches["sidekit_fe"] == 1, "the dataset skipped the kernel")
    check_cnn_launches(launches, "patch_dataset")
    del xc, yc

    model = load_patch_model("keras_speech_music_noise_cnn.hdf5", models)
    trainer = Trainer(model.spec, model.params, device=dev)
    check(trainer.precision == "highest", f"tier {trainer.precision}")
    order = np.random.default_rng(0).permutation(len(x))
    n = min(len(x), TRAIN_STEPS * TRAIN_BATCH)
    xs, ys = x[order[:n]], y[order[:n]]
    first = trainer.fit(xs[:TRAIN_CPU_STEPS * TRAIN_BATCH],
                        ys[:TRAIN_CPU_STEPS * TRAIN_BATCH],
                        batch_size=TRAIN_BATCH, shuffle_seed=1)
    cpu = Trainer(model.spec, model.params, device="cpu")
    t0 = time.perf_counter()
    want = cpu.fit(xs[:TRAIN_CPU_STEPS * TRAIN_BATCH],
                   ys[:TRAIN_CPU_STEPS * TRAIN_BATCH],
                   batch_size=TRAIN_BATCH, shuffle_seed=1)
    cpu_ms = (time.perf_counter() - t0) / TRAIN_CPU_STEPS * 1e3
    rel = float(np.max(np.abs(np.subtract(first, want)) / np.abs(want)))
    log(f"[train] first {TRAIN_CPU_STEPS} steps' losses cuda {first} cpu "
        f"{want}: max rel diff {rel!r} (rtol {TRAIN_LOSS_RTOL}); cpu "
        f"{cpu_ms!r} ms a step")
    check(rel <= TRAIN_LOSS_RTOL, "cuda and cpu losses differ")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rest = []
    t0 = time.perf_counter()
    for i in range(TRAIN_CPU_STEPS * TRAIN_BATCH, n - TRAIN_BATCH + 1,
                   TRAIN_BATCH):
        rest.append(trainer.train_step(xs[i:i + TRAIN_BATCH],
                                       ys[i:i + TRAIN_BATCH]))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / len(rest) * 1e3
    losses = first + rest
    head = float(np.mean(losses[:5]))
    tail = float(np.mean(losses[-5:]))
    log(f"[train] {len(losses)} steps at batch {TRAIN_BATCH} (size=full "
        f"smn CNN, {trainer.precision}): {step_ms!r} ms a step (host clock "
        f"over {len(rest)} steps, each ending in a sync), "
        f"{TRAIN_BATCH / step_ms * 1e3!r} patches/s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()!r} B; loss mean of the first 5 "
        f"{head!r}, of the last 5 {tail!r}; losses {losses}")
    check(np.isfinite(losses).all() and tail < head,
          "the training loss did not decrease")
    profile_steps(torch, trainer, xs, ys)
    acc = trainer.evaluate(x[order[n:n + 4096]], y[order[n:n + 4096]])
    log(f"[train] held-out accuracy on {min(4096, len(x) - n)} patches "
        f"{acc!r}")

    trained = os.path.join(workdir, "trained_models")
    os.makedirs(trained)
    trainer.export_model(os.path.join(trained,
                                      "keras_speech_music_noise_cnn.npz"))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")         # the synthetic warning
        served = Segmenter("smn", False, ffmpeg=None, device=dev,
                           model_dir=trained, allow_download=False)
        served_cpu = Segmenter("smn", False, ffmpeg=None, device="cpu",
                               model_dir=trained, allow_download=False)
    mix60 = wavs[list(files).index("mix60")]
    reset_kernel_counts()
    lseg = served(mix60)
    serve_launches = kernel_counts()
    check_segmentation_launches(serve_launches, "serving the trained model")
    lseg_cpu = served_cpu(mix60)
    labels = sorted({r[0] for r in lseg})
    log(f"[train] the trained model serves mix60: {len(lseg)} segments, "
        f"labels {labels}, launches {serve_launches}")
    return ({k: launches[k] + serve_launches[k] for k in launches},
            lseg, lseg_cpu)


def profile_steps(torch, trainer, xs, ys, steps=5):
    """``steps`` more training steps under ``torch.profiler``: the device's
    busy share of the wall time and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [(xs[i:i + TRAIN_BATCH], ys[i:i + TRAIN_BATCH])
               for i in range(0, steps * TRAIN_BATCH, TRAIN_BATCH)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for xb, yb in batches:
            trainer.train_step(xb, yb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # user annotations (the optimizer's step range) span kernels already
    # counted: only kernels and copies count towards the busy time
    kernels = sorted(
        ((e.self_device_time_total, e.count, e.key)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA
         and not e.is_user_annotation), reverse=True)
    busy = sum(k[0] for k in kernels) / 1e3
    if not busy:
        log("[train] the profiler saw no device time")
        return
    top = [(f"{t / 1e3 / steps:.3f} ms", n // steps, name[:70])
           for t, n, name in kernels[:6]]
    launches = sum(k[1] for k in kernels) / steps
    log(f"[train] profile of {steps} steps: wall {wall * 1e3 / steps!r} ms a "
        f"step (profiler on), device busy {busy / steps!r} ms a step "
        f"({100 * busy / (wall * 1e3):.1f}%), {launches!r} kernel launches "
        f"a step under {len(kernels)} names; "
        f"top kernels (ms a step, launches a step, name): {top}")


def phase_score(lseg, lseg_cpu, workdir):
    """7(b): the trained model's cuda csv against its cpu csv, with the
    port's scorer and its CLI."""
    from inaspeechsegmenter_tpu_torch import eval as ev
    from inaspeechsegmenter_tpu_torch import seg2csv
    from inaspeechsegmenter_tpu_torch.cli import evaluate

    dirs = [os.path.join(workdir, "score", d) for d in ("cuda", "cpu")]
    for d, ls in zip(dirs, (lseg, lseg_cpu)):
        os.makedirs(d)
        seg2csv(ls, os.path.join(d, "mix60.csv"))
    rep = ev.evaluate(*(os.path.join(d, "mix60.csv") for d in dirs))
    n_fr = int(round(rep["scored_duration"] / ev.FRAME_DUR))
    n_diff = int(round(rep["frame_diff"] * n_fr))
    log(f"[score] trained model mix60 cuda vs cpu: {n_diff} of {n_fr} "
        f"frames differ (frame_diff {rep['frame_diff']!r}), accuracy "
        f"{rep['accuracy']!r}, boundaries {rep['boundaries']}")
    check(rep["frame_diff"] <= 0.001, "cuda and cpu labels differ on >0.1%")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(evaluate.main(["-r", dirs[1], "-y", dirs[0], "--json"]) == 0,
              "cli.evaluate failed")
    corpus = json.loads(buf.getvalue())["corpus"]
    log(f"[score] cli.evaluate cpu -> cuda: corpus frame_diff "
        f"{corpus['frame_diff']!r}, vad {corpus['vad']}")
    check(corpus["frame_diff"] == rep["frame_diff"],
          "cli.evaluate and eval.evaluate disagree")


def phase_farm(torch, dev, workdir, seg, files, wavs, models):
    """7(c): the job farm on the card: a JobServer over phase 2's WAVs
    (with duplicate rows), the port's worker loop with phase 2's
    Segmenter, a second run that skips every file, and one ``--vfs`` job
    through ``cli.client``.  -> kernel launches of the farm's runs."""
    from inaspeechsegmenter_tpu_torch.cli import client
    from inaspeechsegmenter_tpu_torch.parallel import (JobServer,
                                                       client_work_loop)

    farm = os.path.join(workdir, "farm")
    os.makedirs(farm)
    jobs = os.path.join(workdir, "farm_jobs.csv")
    with open(jobs, "w") as fh:
        fh.write("source_path,dest_path\n")
        for w in wavs + wavs[:2]:                  # two duplicate rows
            fh.write(f" {w} , {os.path.join(farm, os.path.basename(w)[:-4])}"
                     ".csv\n")
    server = JobServer(jobs)
    check(len(server.lsource) == len(wavs), "the jobs were not de-duplicated")
    tcp, uri = server.serve(host="127.0.0.1", port=0)
    try:
        reset_kernel_counts()
        t0 = time.perf_counter()
        _, n_ok, _, lmsg = client_work_loop(uri, seg, hostname="card")
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        check(n_ok == len(wavs), f"farm statuses {lmsg}")
        check_segmentation_launches(launches, "the farm")
        for w in wavs:
            name = os.path.basename(w)[:-4] + ".csv"
            with open(os.path.join(farm, name), "rb") as a, \
                    open(os.path.join(workdir, "out", name), "rb") as b:
                check(a.read() == b.read(), f"farm csv {name} differs from "
                      "phase 2's")
        log(f"[farm] {len(wavs)} files through JobServer + client_work_loop "
            f"on one worker: wall {wall!r} s, csvs byte-equal to phase 2's, "
            f"launches {launches}")
        server.set_jobs(jobs)
        t0 = time.perf_counter()
        _, n_ok, _, lmsg = client_work_loop(uri, seg, hostname="card")
        log(f"[farm] second run: {n_ok} processed, statuses "
            f"{[m[1] for m in lmsg]}, wall {time.perf_counter() - t0!r} s")
        check(n_ok == 0 and all(m[1] == 1 for m in lmsg),
              "the second run did not skip every file")

        mix60 = wavs[list(files).index("mix60")]
        dst = os.path.join(farm, "vfs", "mix60.csv")
        os.makedirs(os.path.dirname(dst))
        with open(jobs, "w") as fh:
            fh.write(f"source_path,dest_path\n{mix60},{dst}\n")
        server.set_jobs(jobs)
        os.environ["ISS_TPU_MODEL_DIR"] = models
        try:
            reset_kernel_counts()
            t0 = time.perf_counter()
            client.main([uri, "--vfs", "--ffmpeg_binary", "none",
                         "--device", str(dev)])
            vfs_wall = time.perf_counter() - t0
        finally:
            os.environ.pop("ISS_TPU_MODEL_DIR")
        vfs_launches = kernel_counts()
        check_segmentation_launches(vfs_launches, "the farm's VFS job")
        with open(dst) as fh:
            got = fh.read()
        with open(os.path.join(workdir, "vfs", "mix60.csv")) as fh:
            want = fh.read()
        log(f"[farm] one --vfs job through cli.client (scorer built in the "
            f"call): wall {vfs_wall!r} s, row {got.splitlines()[1]!r}, "
            f"launches {vfs_launches}")
        check(got == want, f"the --vfs job's row differs from phase 3's "
              f"{want.splitlines()[1]!r}")
    finally:
        tcp.shutdown()
        tcp.server_close()
    return {k: launches[k] + vfs_launches[k] for k in launches}


def phase_train_score_farm(torch, dev, workdir, seg, files, wavs, models):
    """Phase 7: train, score, farm."""
    t0 = time.perf_counter()
    per_train, lseg, lseg_cpu = phase_train(torch, dev, workdir, seg, files,
                                            wavs, models)
    phase_score(lseg, lseg_cpu, workdir)
    per_farm = phase_farm(torch, dev, workdir, seg, files, wavs, models)
    log(f"[phase 7] train, score, farm: {time.perf_counter() - t0!r} s")
    return {"train": per_train, "farm": per_farm}


# --------------------------------------------------------------------------
ENGINE_TRAIN_STEPS = 10         # steps of each mesh trainer
ENGINE_LOSS_RTOL = 1e-5         # mesh losses against the one-slot trainer's
ENGINE_GRAD_ATOL = 1e-4         # summed gradients, of each array's largest
                                # magnitude: the card's gradient bound of
                                # phase 7 and tests/test_torch_cuda.py


def engine_devices(torch):
    """Every visible CUDA device; one card gives the testing form, two
    slots on ``cuda:0``."""
    n = torch.cuda.device_count()
    devs = [torch.device("cuda", i) for i in range(n)]
    return devs if n > 1 else devs * 2


def in_turns(fns, reps=2):
    """Wall times of each ``fn`` run in turns (a, b, b, a, ...)."""
    walls = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(reps):
        for name in order:
            t0 = time.perf_counter()
            fns[name]()
            walls[name].append(time.perf_counter() - t0)
    return walls


def slot_kernels(torch, devices):
    """8(e): the features kernel (10 min int16 signal) and the K = 3
    Viterbi (T = 180,000) launched at once on two slot streams, from the
    slots' threads, each held against its plain version; then both kernels
    timed on one stream twice in a row and on two streams at once."""
    from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
    from inaspeechsegmenter_tpu_torch.dsp import fe_kernel, sidekit
    from inaspeechsegmenter_tpu_torch.parallel.mesh import (run_on_slots,
                                                            slot_streams)

    devs = devices[:2]
    streams = slot_streams(devs)
    sig = to_int16(seeded_mix(600, seed=81, silences=silences_every(600)))
    inputs = []
    for d in devs:
        args = viterbi_args(torch, d, 3, "random", VITERBI_T)
        inputs.append((torch.from_numpy(sig).to(d),
                       sidekit.frontend_consts(d), args))
    torch.cuda.synchronize()

    def slot(k, item):
        x, consts, args = item
        return fe_kernel.sidekit_features(x, consts), tv.viterbi_scan(*args)

    reset_kernel_counts()
    out = run_on_slots(slot, inputs, devs, streams)
    counts = kernel_counts()
    check(counts["sidekit_fe"] == 2 and counts["viterbi"] == 2,
          f"slot kernels launched {counts}")
    check_cnn_launches(counts, "the slots")
    for k, ((mspec, loge), states) in enumerate(out):
        x, consts, args = inputs[k]
        mp, lp = fe_kernel.sidekit_features_plain(x, consts)
        mk, lk, mp, lp = (a.cpu().numpy() for a in (mspec, loge, mp, lp))
        fin, finl = np.isfinite(mp), np.isfinite(lp)
        check(np.array_equal(np.isfinite(mk), fin)
              and np.array_equal(np.isfinite(lk), finl),
              f"slot {k}: finite masks differ")
        check(np.allclose(mk[fin], mp[fin], rtol=1e-4, atol=1e-4)
              and np.allclose(lk[finl], lp[finl], rtol=1e-5, atol=1e-5),
              f"slot {k}: features differ from the plain version")
        err = max(float(np.abs(mk[fin] - mp[fin]).max()),
                  float(np.abs(lk[finl] - lp[finl]).max()))
        n_diff = int((states != tv.viterbi_scan_plain(*args)).sum())
        log(f"[engine] (e) slot {k}'s stream: features max_abs_err {err!r}; "
            f"Viterbi K=3 T={VITERBI_T}: {n_diff} states differ from the "
            "plain loop")
        check(n_diff == 0, f"slot {k}: Viterbi states differ")

    # one stream twice in a row against two streams at once (one thread)
    def viterbi_on(stream_list):
        for st, (_, _, args) in zip(stream_list, inputs):
            with torch.cuda.stream(st):
                tv.viterbi_scan(*args)

    def features_on(stream_list):
        for st, (x, consts, _) in zip(stream_list, inputs):
            with torch.cuda.stream(st):
                fe_kernel.sidekit_features(x, consts)

    for name, fn in (("viterbi", viterbi_on), ("sidekit_fe", features_on)):
        fn(streams)
        _, same = synced_ms(torch, lambda: fn([streams[0], streams[0]]), 21)
        _, apart = synced_ms(torch, lambda: fn(streams), 21)
        log(f"[engine] (e) two {name} launches, host wall with a sync "
            f"(median of 21): one stream {same!r} ms, two streams "
            f"{apart!r} ms")


def phase_engine(torch, dev, workdir, seg, vfs, params, files, wavs, models,
                 speech_rate):
    """Phase 8: the multi-GPU engine on every visible card (one card: two
    slots on it). -> kernel launches by path."""
    from inaspeechsegmenter_tpu_torch import VoiceFemininityScoring
    from inaspeechsegmenter_tpu_torch.models.registry import load_patch_model
    from inaspeechsegmenter_tpu_torch.parallel import (ParallelEngine,
                                                       make_2d_mesh,
                                                       make_mesh)
    from inaspeechsegmenter_tpu_torch.train import Trainer, patch_dataset

    t_phase = time.perf_counter()
    devices = engine_devices(torch)
    mesh = make_mesh(devices=devices)
    log(f"[engine] mesh of {mesh.devices.size} slots on "
        f"{len(set(devices))} distinct devices: {[str(d) for d in devices]}")
    per = {}

    # (a) batch_process of phase 2's three WAVs
    engine = ParallelEngine(seg, mesh)
    outs = [os.path.join(workdir, "engine", os.path.basename(w)[:-4]
                         + ".csv") for w in wavs]
    reset_kernel_counts()
    _, n_ok, _, lmsg = engine.batch_process(wavs, outs)
    per["engine_batch"] = kernel_counts()
    check(n_ok == len(wavs), f"engine statuses {lmsg}")
    # the routing: a corpus runs every file per-file (a file alone in its
    # bucket too): one features launch and three decodes a file
    check(without_codec(per["engine_batch"]) == {
        "sidekit_fe": 3, "viterbi": 9, "viterbi_general": 0},
          f"engine batch launches {per['engine_batch']}")
    check_routed_launches(per["engine_batch"], "the engine batch")
    for w, o in zip(wavs, outs):
        ref = os.path.join(workdir, "out", os.path.basename(w)[:-4] + ".csv")
        with open(o, "rb") as a, open(ref, "rb") as b:
            check(a.read() == b.read(), f"{o}: csv differs from phase 2's")
    ref_outs = [o + ".seg" for o in outs]
    walls = in_turns({"Segmenter": lambda: seg.batch_process(wavs, ref_outs),
                      "ParallelEngine": lambda: engine.batch_process(
                          wavs, outs)})
    log(f"[engine] (a) batch_process of {len(wavs)} files, csvs byte-equal "
        f"to phase 2's, launches {per['engine_batch']}; warm walls in turns "
        f"(s): {walls}")

    # (b) the 10 min mix's timeline over the slots
    wav = wavs[list(files).index("mix600")]
    reset_kernel_counts()
    got = engine(wav)
    per["sharded"] = kernel_counts()
    check(without_codec(per["sharded"]) == {"sidekit_fe": 1, "viterbi": 3,
                                            "viterbi_general": 0},
          f"sharded launches {per['sharded']}")
    check_routed_launches(per["sharded"], "the sharded file")
    a, b = frame_labels(got), frame_labels(seg(wav))
    check(a.shape == b.shape, "sharded and fused label counts differ")
    n_diff = int((a != b).sum())
    walls = in_turns({"run": lambda: seg(wav),
                      "run_sharded": lambda: engine(wav)}, reps=3)
    log(f"[engine] (b) engine(mix600) through run_sharded: {n_diff} of "
        f"{len(a)} frames differ from the fused run; launches "
        f"{per['sharded']}; warm walls in turns (s): {walls}")
    check(n_diff == 0, "run_sharded labels differ from run's")

    # (c) VFS with the window sub-batches split over the slots
    t0 = time.perf_counter()
    vfs_m = VoiceFemininityScoring("bgc", ffmpeg=None, mesh=mesh,
                                   device=dev, model_dir=models,
                                   xvector_params=params,
                                   allow_download=False)
    build_s = time.perf_counter() - t0
    reset_kernel_counts()
    res_m = vfs_m(wav)
    per["vfs_mesh"] = kernel_counts()
    check_segmentation_launches(per["vfs_mesh"], "the mesh VFS run")
    res_1 = vfs(wav)
    check(res_m == res_1, f"mesh VFS {res_m} != phase 3's {res_1}")
    basename, fea, timeline, duration, _ = vfs._prepare(wav)
    starts = list(range(0, fea.shape[0] - 144, 24))
    emb_m = vfs_m.xvector_model.embeddings_from_features(fea, starts)
    emb_1 = vfs.xvector_model.embeddings_from_features(fea, starts)
    err = rel_l2(emb_m, emb_1)
    check(err <= 1e-3, f"mesh embeddings differ ({err!r})")
    rates = {}
    for name, xm in (("one slot", vfs.xvector_model),
                     ("mesh", vfs_m.xvector_model)):
        xm("mix600", fea, duration, timeline=timeline)      # warm
    walls = in_turns({
        name: (lambda xm=xm: (xm("mix600", fea, duration, timeline=timeline),
                              torch.cuda.synchronize()))
        for name, xm in (("one slot", vfs.xvector_model),
                         ("mesh", vfs_m.xvector_model))})
    n_win = len(vfs.xvector_model("mix600", fea, duration,
                                  timeline=timeline))
    for name, w in walls.items():
        rates[name] = n_win / min(w)
    log(f"[engine] (c) VoiceFemininityScoring(mesh=) built in {build_s!r} "
        f"s; mix600 result {res_m} equal to phase 3's; embeddings of "
        f"{len(starts)} windows max_rel_l2 {err!r}; {n_win} speech windows, "
        f"windows/s {rates} (phase 3's {speech_rate!r}); walls {walls}; "
        f"launches {per['vfs_mesh']}")

    # (d) the full-width smn CNN trainer on meshes
    annot = os.path.join(workdir, "annot", "mix600.csv")
    x, y = patch_dataset([(wav, annot)], "smn", ffmpeg=None, device=dev)
    n = ENGINE_TRAIN_STEPS * TRAIN_BATCH
    order = np.random.default_rng(8).permutation(len(x))[:n]
    batches = [(x[order[i:i + TRAIN_BATCH]], y[order[i:i + TRAIN_BATCH]])
               for i in range(0, n, TRAIN_BATCH)]
    model = load_patch_model("keras_speech_music_noise_cnn.hdf5", models)
    four = (devices * 4)[:4]
    meshes = {"1x1": None,
              "2x1": make_2d_mesh(2, 1, devices=devices[:2]),
              "2x2": make_2d_mesh(2, 2, devices=four)}
    trainers, losses, step_ms = {}, {}, {}
    for name, m in meshes.items():
        tr = Trainer(model.spec, model.params, m, device=dev)
        check(tr.precision == "highest", f"tier {tr.precision}")
        tr.train_step(*batches[0])                          # warm
        tr = trainers[name] = Trainer(model.spec, model.params, m,
                                      device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses[name] = [tr.train_step(xb, yb) for xb, yb in batches]
        torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - t0) / len(batches) * 1e3
    check(bool(trainers["2x2"]._split), "the 2x2 trainer split no kernel")
    want = np.asarray(losses["1x1"])
    drift = {name: (np.abs(np.asarray(v) - want) / np.abs(want)).tolist()
             for name, v in losses.items() if name != "1x1"}
    log(f"[engine] (d) full-width smn CNN, batch {TRAIN_BATCH}, "
        f"{ENGINE_TRAIN_STEPS} steps at highest, free-running: ms a step "
        f"{step_ms}; losses {losses}; rel diff against 1x1 by step {drift}")
    # the same step: before each step the mesh trainer restores the 1x1
    # trainer's checkpoint (gathered leaves, split again on restore), so
    # each of the steps starts from one state; loss and summed gradient
    # of every step against the 1x1 trainer's, each step classified by
    # the ReLU / max-pool decisions its two forwards took (mesh_step)
    ckpt = os.path.join(workdir, "engine_ckpt.npz")
    for name in ("2x1", "2x2"):
        ref = Trainer(model.spec, model.params, device=dev)
        tr = trainers[name]
        steps = [mesh_step(torch, ref, tr, xb, yb, ckpt)
                 for xb, yb in batches]
        summary = mesh_step_summary(name, steps)
        log(f"[engine] (d) {name} from the 1x1 state at each of "
            f"{len(batches)} steps: {json.dumps(summary)} (steps without "
            f"a flipped decision: loss rtol {ENGINE_LOSS_RTOL}, gradient "
            f"atol {ENGINE_GRAD_ATOL} of each array's largest magnitude; "
            f"with flips: every flip a tie under {FLIP_TIE_GAP}, each "
            f"array's relative L2 under {ENGINE_GRAD_REL_L2}, loss rtol "
            f"{ENGINE_LOSS_RTOL})")
        bad = [s for s in steps if not s["ok"]]
        check(not bad, f"the {name} step differs from the one-slot step: "
              f"{json.dumps(bad)}")

    # (e) the kernels on the slots' streams
    slot_kernels(torch, devices)
    log(f"[phase 8] multi-GPU engine: {time.perf_counter() - t_phase!r} s")
    return per


OVERLAP_ORDER = ("serial", "overlapped", "overlapped", "serial", "serial",
                 "overlapped")      # 3 pairs in turns


MESH_STEP_FLAG = "--mesh-step-repeats"
EPILOGUE_FLAG = "--cnn-epilogue"   # the build and phase 1's epilogue alone


def decision_hooks(torch, model, store):
    """Forward hooks on ``model``'s layers that append each call's
    decisions to ``store`` (layer name -> list): a ReLU layer's output, a
    VALID max-pool's input with the flat index of each window's winner.
    -> the hook handles."""
    import torch.nn.functional as F
    from inaspeechsegmenter_tpu_torch.models import layers as L

    def relu(name):
        return lambda mod, args, out: store.setdefault(name, []).append(
            out.detach())

    def pool(name):
        def hook(mod, args, out):
            x = args[0].detach()
            _, idx = F.max_pool2d(x, mod.pool, mod.stride,
                                  return_indices=True)
            store.setdefault(name, []).append((x, idx))
        return hook

    handles = []
    for name, index, _, _ in model._plan:
        layer = None if index is None else model.layers[index]
        if getattr(layer, "act", None) is F.relu:
            handles.append(layer.register_forward_hook(relu(name)))
        elif isinstance(layer, L.MaxPool2D) and layer.padding == "VALID":
            handles.append(layer.register_forward_hook(pool(name)))
    return handles


def decision_flips(torch, ref, mesh):
    """Decisions of the one-slot forward (``ref``) against the mesh rows'
    (``mesh``, rows in batch order) -> {layer: (flips, widest gap)}: ReLU
    outputs zero on one side only, the gap the larger such output; max-pool
    windows with another winner, the gap between the two candidates'
    values in the one-slot input."""
    out = {}
    for name, (got,) in ref.items():
        rows = mesh[name]
        if isinstance(got, tuple):
            x, idx = got
            other = torch.cat([i.to(idx.device) for _, i in rows])
            flat = x.flatten(2)
            flip = idx != other
            gap = (flat.gather(2, idx.flatten(2))
                   - flat.gather(2, other.flatten(2))).abs()[flip.flatten(2)]
        else:
            other = torch.cat([r.to(got.device) for r in rows])
            flip = (got > 0) != (other > 0)
            gap = torch.maximum(got, other)[flip]
        out[name] = (int(flip.sum()),
                     float(gap.max()) if gap.numel() else 0.0)
    return out


FLIP_TIE_GAP = 1e-6          # a flipped decision this close is a tie
ENGINE_GRAD_REL_L2 = 1e-3    # each array's relative L2 error, a step with
                             # flips (measured: 7.6e-5 at a tie's flip,
                             # 2.2e-6 at most without one)


def mesh_step(torch, ref, tr, xb, yb, ckpt):
    """One step of the mesh trainer ``tr`` and of the one-slot ``ref``
    from ``ref``'s state, under ``decision_hooks`` -> a dict: the loss's
    relative error, each gradient array's worst max-abs error over its
    largest magnitude and worst relative L2 error (and where), the flipped
    decisions, and ``ok``: a step without a flipped decision passes on the
    loss and max-abs limits; a step with flips passes only when every flip
    is a tie (gap under ``FLIP_TIE_GAP``), every array's relative L2 error
    is at most ``ENGINE_GRAD_REL_L2`` and the loss is within its limit."""
    store_ref, store_mesh = {}, {}
    ref.save_checkpoint(ckpt)
    tr.restore_checkpoint(ckpt)
    handles = decision_hooks(torch, ref.model, store_ref)
    for rep in tr.replicas:
        handles += decision_hooks(torch, rep, store_mesh)
    try:
        lr_, lm = ref.train_step(xb, yb), tr.train_step(xb, yb)
    finally:
        for h in handles:
            h.remove()
    flips = {k: v for k, v in decision_flips(torch, store_ref,
                                             store_mesh).items() if v[0]}
    g_ref = ref._gathered(lambda p: p.grad)
    g_m = tr._gathered(lambda p: p.grad)
    worst = {"max": (0.0, None), "l2": (0.0, None)}
    for layer, arrays in g_ref.items():
        for i, (g, h) in enumerate(zip(arrays, g_m[layer])):
            if g is None:
                continue
            d = g - h
            err = {"max": float(d.abs().max()) / (float(g.abs().max())
                                                  or 1.0),
                   "l2": float(d.norm()) / (float(g.norm()) or 1.0)}
            for key, v in err.items():
                if v > worst[key][0]:
                    worst[key] = (v, f"{layer}[{i}]")
    loss_rel = abs(lm - lr_) / (abs(lr_) or 1.0)
    if flips:
        ok = (all(gap < FLIP_TIE_GAP for _, gap in flips.values())
              and worst["l2"][0] <= ENGINE_GRAD_REL_L2)
    else:
        ok = worst["max"][0] <= ENGINE_GRAD_ATOL
    return {"loss_rel": loss_rel, "grad_max": worst["max"][0],
            "grad_max_at": worst["max"][1], "grad_rel_l2": worst["l2"][0],
            "grad_rel_l2_at": worst["l2"][1], "flips": flips,
            "ok": ok and loss_rel <= ENGINE_LOSS_RTOL}


def mesh_step_summary(name, steps):
    """Counts and worst values of ``mesh_step`` results, with and without
    flipped decisions."""
    flipped = [s for s in steps if s["flips"]]
    clean = [s for s in steps if not s["flips"]]

    def top(ss, key):
        return max((s[key] for s in ss), default=None)

    return {
        "mesh": name, "steps": len(steps),
        "steps_failed": sum(not s["ok"] for s in steps),
        "steps_past_max_abs_limit": sum(s["grad_max"] > ENGINE_GRAD_ATOL
                                        for s in steps),
        "steps_with_flips": len(flipped),
        "flips": sum(n for s in flipped for n, _ in s["flips"].values()),
        "flip_gap_max": max((g for s in flipped
                             for _, g in s["flips"].values()), default=None),
        "grad_max_with_flips": top(flipped, "grad_max"),
        "grad_max_without_flips": top(clean, "grad_max"),
        "grad_rel_l2_with_flips": top(flipped, "grad_rel_l2"),
        "grad_rel_l2_without_flips": top(clean, "grad_rel_l2"),
        "loss_rel": top(steps, "loss_rel")}


def mesh_step_diagnosis(torch, dev, workdir, repeats):
    """``--mesh-step-repeats N``: phase 8(d)'s same-state comparison of the
    2x1 and 2x2 trainers with the 1x1 trainer, ``N`` times each from a
    fresh 1x1 trainer, at cuDNN's default algorithms, on phase 8's seeded
    batches, each step classified as phase 8(d) classifies it
    (``mesh_step``).  Prints one ``STEP`` JSON line for each step past
    the max-abs gradient limit or with a flipped decision, and one
    ``SUMMARY`` line a mesh; fails if a step fails phase 8(d)'s check."""
    from inaspeechsegmenter_tpu_torch import Segmenter, seg2csv
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
    from inaspeechsegmenter_tpu_torch.models.registry import load_patch_model
    from inaspeechsegmenter_tpu_torch.models.synthetic import (
        install_synthetic_models)
    from inaspeechsegmenter_tpu_torch.parallel import make_2d_mesh
    from inaspeechsegmenter_tpu_torch.train import Trainer, patch_dataset

    models = install_synthetic_models(os.path.join(workdir, "models"),
                                      seed=0, size="full")
    wav = os.path.join(workdir, "mix600.wav")
    write_wav(wav, to_int16(seeded_mix(600, seed=600,
                                       silences=silences_every(600))), SR)
    seg = Segmenter("smn", True, ffmpeg=None, device=dev, model_dir=models,
                    allow_download=False)
    annot = os.path.join(workdir, "mix600.csv")
    seg2csv(seg(wav), annot)
    x, y = patch_dataset([(wav, annot)], "smn", ffmpeg=None, device=dev)
    n = ENGINE_TRAIN_STEPS * TRAIN_BATCH
    order = np.random.default_rng(8).permutation(len(x))[:n]
    batches = [(x[order[i:i + TRAIN_BATCH]], y[order[i:i + TRAIN_BATCH]])
               for i in range(0, n, TRAIN_BATCH)]
    model = load_patch_model("keras_speech_music_noise_cnn.hdf5", models)
    devices = engine_devices(torch)
    meshes = {"2x1": make_2d_mesh(2, 1, devices=devices[:2]),
              "2x2": make_2d_mesh(2, 2, devices=(devices * 4)[:4])}
    ckpt = os.path.join(workdir, "ckpt.npz")
    log(f"[mesh-step] {repeats} repeats of {len(batches)} steps a mesh, "
        f"cudnn.deterministic={torch.backends.cudnn.deterministic}, "
        f"benchmark={torch.backends.cudnn.benchmark}")
    failed = []
    for name, m in meshes.items():
        tr = Trainer(model.spec, model.params, m, device=dev)
        steps = []
        for r in range(repeats):
            ref = Trainer(model.spec, model.params, device=dev)
            for k, (xb, yb) in enumerate(batches):
                step = {"mesh": name, "repeat": r, "step": k,
                        **mesh_step(torch, ref, tr, xb, yb, ckpt)}
                steps.append(step)
                if step["grad_max"] > ENGINE_GRAD_ATOL or step["flips"]:
                    print("STEP " + json.dumps(step), flush=True)
        summary = mesh_step_summary(name, steps)
        summary["repeats"] = repeats
        summary["repeats_past_max_abs_limit"] = len(
            {s["repeat"] for s in steps if s["grad_max"] > ENGINE_GRAD_ATOL})
        print("SUMMARY " + json.dumps(summary), flush=True)
        failed += [s for s in steps if not s["ok"]]
    check(not failed, f"{len(failed)} steps fail phase 8(d)'s check")


def overlap_route(n):
    """(groups, chunks) the overlapped scorer uploads for ``n`` int16
    samples: the frontend's chunks, one more where the signal's last
    samples fall past them (the shared PCM must cover the signal)."""
    from inaspeechsegmenter_tpu_torch.dsp.fe_kernel import upload_chunks
    from inaspeechsegmenter_tpu_torch.dsp.sidekit import (CHUNK, HOP,
                                                          frame_count)

    chunks = max(1, -(-frame_count(n) // CHUNK))
    if n > (chunks * CHUNK + 2) * HOP:
        chunks += 1
    return -(-chunks // upload_chunks()), chunks


def busy_share(torch, fn):
    """``fn()`` once under ``torch.profiler`` -> (wall ms, device busy ms):
    the kernels' and copies' device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3
    return wall, busy


XVEC_REL_LIMIT = 1e-3   # relative L2 of one window's x-vector (section 2)


def collected_xvectors(vfs, sig, name, overlapped):
    """One overlapped run of ``sig``, the raw x-vectors its
    ``_EmbedSession.collect`` returned held against the extractor's own on
    the same starts -> (per-window relative L2, that of each window one
    STEP on against the window, number of windows speculated on)."""
    from inaspeechsegmenter_tpu_torch import vfs as vfs_mod
    from inaspeechsegmenter_tpu_torch.vfs import STEP, WINLEN

    real = vfs_mod._EmbedSession.collect
    seen = {}

    def collect(self, fea, needed):
        seen["speculated"] = {s for b, _ in self.batches for s in b}
        got = real(self, fea, needed)
        seen.update(fea=fea, needed=list(needed), got=np.stack(got))
        return got

    vfs_mod._EmbedSession.collect = collect
    try:
        overlapped(sig, name)
    finally:
        vfs_mod._EmbedSession.collect = real
    xm, fea, needed = vfs.xvector_model, seen["fea"], seen["needed"]
    want = xm.embeddings_from_features(fea, needed)
    rel = (np.linalg.norm(seen["got"] - want, axis=1)
           / np.linalg.norm(want, axis=1))
    rows = [i for i, s in enumerate(needed)
            if s + STEP + WINLEN <= fea.shape[0]]
    moved = xm.embeddings_from_features(fea, [needed[i] + STEP
                                              for i in rows])
    rel_moved = (np.linalg.norm(moved - want[rows], axis=1)
                 / np.linalg.norm(want[rows], axis=1))
    return rel, rel_moved, len(seen["speculated"] & set(needed))


def phase_overlap(torch, dev, vfs, files, wavs, models):
    """Phase 9: the overlapped speculative VFS scorer
    (``ISS_VFS_OVERLAP=1``) against the default serial schedule of an
    int16 signal.  -> kernel launches by run."""
    from inaspeechsegmenter_tpu_torch import OnlineVFS, vbx_segmenter
    from inaspeechsegmenter_tpu_torch.vfs import TorchResnetExtractor

    t_phase = time.perf_counter()
    per = {}
    check("ISS_VFS_OVERLAP" not in os.environ, "ISS_VFS_OVERLAP is set")

    def serial(sig, name, scorer=None):
        scorer = scorer or vfs.score_signal
        vfs.overlap_stats = None
        got = scorer(sig, name)
        check(vfs.overlap_stats is None,
              f"{name}: the default schedule was not the serial one")
        return got

    def overlapped(sig, name, scorer=None):
        scorer = scorer or vfs.score_signal
        os.environ["ISS_VFS_OVERLAP"] = "1"
        try:
            vfs.overlap_stats = None
            got = scorer(sig, name)
        finally:
            os.environ.pop("ISS_VFS_OVERLAP")
        check(vfs.overlap_stats is not None,
              f"{name}: ISS_VFS_OVERLAP=1 did not take the overlapped scorer")
        return got

    # (a) both schedules in turns, and the launches against the route
    runs = {"serial": serial, "overlapped": overlapped}
    for name in ("mix60", "mix600"):
        sig = files[name]
        for sched in runs:                                  # warm
            runs[sched](sig, name)
        walls = {sched: [] for sched in runs}
        results = set()
        for sched in OVERLAP_ORDER:
            t0 = time.perf_counter()
            results.add(runs[sched](sig, name))
            walls[sched].append(time.perf_counter() - t0)
        check(len(results) == 1,
              f"{name}: overlapped and serial tuples differ: {results}")
        st = vfs.overlap_stats          # OVERLAP_ORDER ends overlapped
        hit = st["needed"] - st["caught_up"]
        extra = st["dispatched"] - hit
        groups, chunks = overlap_route(len(sig))
        reset_kernel_counts()
        overlapped(sig, name)
        torch.cuda.synchronize()
        per[f"vfs_overlapped_{name}"] = got = kernel_counts()
        want = {"sidekit_fe": groups, "viterbi": 2 * (chunks - 1) + 2,
                "viterbi_general": 0}
        check(without_codec(got) == want, f"{name}: overlapped launches "
              f"{got}, the route gives {want}")
        check_routed_launches(got, f"{name}: overlapped")
        reset_kernel_counts()
        serial(sig, name)
        torch.cuda.synchronize()
        per[f"vfs_serial_{name}"] = got_s = kernel_counts()
        check(without_codec(got_s) == {"sidekit_fe": 1, "viterbi": 2,
                                       "viterbi_general": 0},
              f"{name}: serial launches {got_s}")
        check_routed_launches(got_s, f"{name}: serial")
        log(f"[overlap] {name} ({len(sig) / SR!r} s, {chunks} chunks in "
            f"{groups} groups): result {results.pop()} equal on both "
            f"schedules; warm walls in turns (s) {walls}; medians serial "
            f"{float(np.median(walls['serial']))!r} overlapped "
            f"{float(np.median(walls['overlapped']))!r}; windows dispatched "
            f"{st['dispatched']}, needed {st['needed']}, caught up "
            f"{st['caught_up']} ({st['caught_up'] / st['needed']!r} of "
            f"needed), extras {extra} ({extra / st['needed']!r} of needed), "
            f"dispatched/needed {st['dispatched'] / st['needed']!r}; "
            f"launches overlapped {got} (route: {groups} groups, 2 decodes "
            f"for each of {chunks - 1} chunks with a right neighbour, 2 "
            f"final), serial {got_s}")

    # the x-vectors behind the equal tuples: the synthetic MLP scores 1.0
    # whatever they are, so compare them before the MLP
    sig = files["mix600"]
    rel, rel_moved, n_spec = collected_xvectors(vfs, sig, "mix600",
                                                overlapped)
    check(n_spec > 0, "mix600: no window was speculated on")
    check(float(rel.max()) <= XVEC_REL_LIMIT,
          f"mix600: collected x-vectors off the extractor's by {rel.max()!r}"
          f" relative L2 (limit {XVEC_REL_LIMIT})")
    check(float(rel_moved.min()) > XVEC_REL_LIMIT,
          f"mix600: a window one step on lies within the limit "
          f"({rel_moved.min()!r}): the check cannot see a misplaced window")
    log(f"[overlap] mix600 x-vectors from _EmbedSession.collect ({len(rel)} "
        f"windows, {n_spec} speculated) vs embeddings_from_features on the "
        f"same starts: relative L2 max {float(rel.max())!r}, median "
        f"{float(np.median(rel))!r} (limit {XVEC_REL_LIMIT}); each window "
        f"one step on: min {float(rel_moved.min())!r}, median "
        f"{float(np.median(rel_moved))!r}")

    # (b) no host sync between the first upload and the exact decode: the
    # device runs everything queued in order, and one sync would make the
    # host wait for every speculative sub-batch
    pipe = vfs.vad.pipeline
    real_decode = pipe.stream_decode

    def decode_unchecked(*args, **kwargs):
        torch.cuda.set_sync_debug_mode(0)
        return real_decode(*args, **kwargs)

    pipe.stream_decode = decode_unchecked
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = overlapped(sig, "mix600")
    finally:
        torch.cuda.set_sync_debug_mode(0)
        del pipe.stream_decode
    check(got == serial(sig, "mix600"), "the sync-checked run differs")
    log("[overlap] mix600: no synchronizing CUDA call from the first upload "
        "to the exact decode (torch.cuda.set_sync_debug_mode('error'))")

    # (c) the device's busy share of one run of each schedule
    shares = {}
    for sched in runs:
        wall, busy = busy_share(torch, lambda: runs[sched](sig, "mix600"))
        shares[sched] = (wall, busy, busy / wall if wall else 0.0)
    log(f"[overlap] mix600 under torch.profiler (wall ms, device busy ms, "
        f"busy share): {shares}")

    # (d) __call__ on the WAV, OnlineVFS, the reference import path
    wav600 = wavs[list(files).index("mix600")]
    want = serial(sig, "mix600")

    def call(path, name):
        return vfs(path)

    check(serial(wav600, "mix600.wav", call) == want
          and overlapped(wav600, "mix600.wav", call) == want,
          "__call__ on the WAV differs from score_signal")
    sig60 = files["mix60"]
    reset_kernel_counts()
    ov = OnlineVFS(vfs, "mix60")
    for pos in range(0, len(sig60), 2 * SR):
        ov.feed(sig60[pos:pos + 2 * SR])
        ov.current()
    got = ov.finalize()
    torch.cuda.synchronize()
    per["online_vfs_mix60"] = kernel_counts()
    check_segmentation_launches(per["online_vfs_mix60"], "the online VFS")
    want60 = serial(sig60, "mix60")
    check(got == want60, f"OnlineVFS.finalize {got} != score_signal "
          f"{want60}")
    ref = vbx_segmenter.VoiceFemininityScoring(
        "bgc", ffmpeg=None, device=dev, model_dir=models,
        allow_download=False)
    check(vbx_segmenter.VBxExtractor is TorchResnetExtractor,
          "vbx_segmenter.VBxExtractor")
    wav60 = wavs[list(files).index("mix60")]
    os.environ["ISS_VFS_OVERLAP"] = "1"
    try:
        ref.overlap_stats = None
        got_ref = ref(wav60)
    finally:
        os.environ.pop("ISS_VFS_OVERLAP")
    check(got_ref == want60 and ref.overlap_stats is not None,
          f"vbx_segmenter's scorer {got_ref} != {want60}")
    log(f"[overlap] __call__(mix600.wav) {want} on both schedules; "
        f"OnlineVFS over mix60 in 2 s blocks finalize {got} == "
        f"score_signal; vbx_segmenter.VoiceFemininityScoring(mix60.wav) "
        f"{got_ref} overlapped; launches {per['online_vfs_mix60']} (online)")
    log(f"[phase 9] overlapped VFS scorer: {time.perf_counter() - t_phase!r} "
        "s")
    return per


# --------------------------------------------------------------------------
ROOT = os.path.dirname(os.path.abspath(__file__))
PORT = "inaspeechsegmenter_tpu_torch"
ENDURANCE_FILES = 16            # two-second WAVs: 8 to warm, then 8 more
ENDURANCE_MEMORY_SLACK = 1 << 20    # bytes allocated may differ by 1 MiB
PATH_KERNELS = ("sidekit_fe_kernel", "viterbi_kernel")   # trace names
GUARD_TURNS_FILE = "mix600"     # console script with and without the guard

INSTALLED_RUNNER = r"""
import time
marks = [("interpreter", time.time())]
import gc, json, os, runpy, sys
import numpy as np
import torch
marks.append(("torch import", time.time()))
import inaspeechsegmenter_tpu_torch as port
from inaspeechsegmenter_tpu_torch import Segmenter
from inaspeechsegmenter_tpu_torch.audio import native
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
from inaspeechsegmenter_tpu_torch.dsp import codec, fe_kernel
from inaspeechsegmenter_tpu_torch.models import layers
from inaspeechsegmenter_tpu_torch.utils import env as port_env
marks.append(("port import", time.time()))
port_env.require_device("runner", "cuda")   # cold: the probe's subprocess
marks.append(("constructor guard", time.time()))
t_latched = time.perf_counter()
port_env.require_device("runner", "cuda")   # latched
guard_latched_s = time.perf_counter() - t_latched

cfg = json.loads(sys.argv[1])
wrappers = {"sidekit_fe": fe_kernel.sidekit_features,
            "viterbi": tv.viterbi_scan,
            "viterbi_general": tv.viterbi_scan_general,
            "unpack_bits": codec.unpack_bits,
            "unpack_zero_elide": codec.unpack_zero_elide,
            "cnn_epilogue": layers.cnn_epilogue}
""" + CNN_FORWARDS + r"""

def counts():
    torch.cuda.synchronize()
    return {**{k: w.launches for k, w in wrappers.items()},
            "cnn_forwards": _cnn["forwards"]}


def reset():
    for w in wrappers.values():
        w.launches = 0
    _cnn["forwards"] = 0


out = {"package": port.__file__, "native_source": native.SOURCE,
       "guard_latched_s": guard_latched_s}
torch.cuda.init()
torch.empty(1, device="cuda")
torch.cuda.synchronize()
marks.append(("CUDA context", time.time()))
seg = Segmenter("smn", True, ffmpeg=None, model_dir=cfg["models"],
                allow_download=False)
torch.cuda.synchronize()
marks.append(("Segmenter", time.time()))
reset()                                  # (d) the 10 min WAV, counted
seg(cfg["mix600"])
out["launches"] = counts()
marks.append(("first 10 min file", time.time()))
t = cfg["launched_at"]
out["start_up"] = {}
for name, at in marks:
    out["start_up"][name], t = at - t, at
reset()                                  # (e) 44.1 kHz, no ffmpeg
out["resampled"] = seg(cfg["wav44"])
out["resampled_launches"] = counts()
out["native_library"] = native.load_library()._name
rng = np.random.default_rng(0)           # (f) endurance
wavs, csvs = [], []
for i in range(cfg["n_files"]):
    t = np.arange(2 * 16000) / 16000
    sig = [rng.standard_normal(len(t)) * 0.1,
           np.sin(2 * np.pi * 220.0 * (i + 1) * t) * 0.2,
           np.zeros(len(t))][i % 3]
    wavs.append(os.path.join(cfg["endurance"], f"f{i:02d}.wav"))
    csvs.append(os.path.join(cfg["endurance"], f"f{i:02d}.csv"))
    write_wav(wavs[-1], np.clip(np.rint(sig * 32768), -32768, 32767)
              .astype(np.int16), 16000)
half = cfg["n_files"] // 2
memory = []
for part in (slice(0, half), slice(half, None)):
    n_ok = seg.batch_process(wavs[part], csvs[part])[1]
    if n_ok != half:
        raise RuntimeError(f"endurance: {n_ok} of {half} files segmented")
    gc.collect()
    torch.cuda.synchronize()
    memory.append(torch.cuda.memory_allocated())
out["memory_allocated"] = memory
out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
out["verify"] = {}                       # (g) the acceptance kit
for name, d in cfg["verify"].items():
    os.environ["ISS_TPU_MODEL_DIR"] = d
    report = os.path.join(cfg["endurance"], f"verify_{name}.json")
    sys.argv = ["verify_weights", "--report-only", "--json", report]
    try:
        runpy.run_module("inaspeechsegmenter_tpu_torch.tools.verify_weights",
                         run_name="__main__")
        rc = 0
    except SystemExit as exc:
        rc = exc.code
    with open(report) as fh:
        out["verify"][name] = {"rc": rc, "report": json.load(fh)}
print("INSTALLED " + json.dumps(out), flush=True)
"""


def install_port(target, wheels):
    """Install the checkout into ``target``: build the wheel and install it
    with ``--target``.  -> the wheel's name and the setuptools version."""
    try:
        import setuptools
    except ImportError:
        raise RuntimeError("check failed: no setuptools on this host, so "
                           "the wheel cannot be built") from None
    subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps",
                    "--no-build-isolation", "-q", "-w", wheels, ROOT],
                   check=True, timeout=300)
    (wheel,) = [os.path.join(wheels, n) for n in os.listdir(wheels)
                if n.endswith(".whl")]
    subprocess.run([sys.executable, "-m", "pip", "install", "-q",
                    "--no-deps", "--no-index", "--target", target, wheel],
                   check=True, timeout=300)
    return (f"wheel ({os.path.basename(wheel)}, setuptools "
            f"{setuptools.__version__})")


def run_installed(cmd, env, cwd, what):
    """Run ``cmd`` against the install -> (stdout, wall s); a non-zero exit
    fails the smoke."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, cwd=cwd, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        log(r.stdout[-4000:])
        log(r.stderr[-4000:])
    check(r.returncode == 0, f"{what} exited {r.returncode}")
    return r.stdout, wall


def build_state(build):
    """The build directory's files and their mtimes."""
    return {n: os.stat(os.path.join(build, n)).st_mtime_ns
            for n in sorted(os.listdir(build))}


def trace_kernels(trace_dir):
    """Names of the device kernels in a ``torch_trace`` file."""
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "kernel"}


def phase_installed(torch, dev, workdir, files, wavs, models, resampled):
    """Phase 10: the port installed from the checkout and driven from the
    install, on the card.  -> the kernel launches of its 10 min file."""
    t_phase = time.perf_counter()
    base = os.path.join(workdir, "installed")
    target, build, cwd, wheels, endurance = (
        os.path.join(base, d) for d in ("site", "build", "cwd", "wheels",
                                        "endurance"))
    for d in (cwd, wheels, endurance):
        os.makedirs(d)
    # (a) install
    t0 = time.perf_counter()
    route = install_port(target, wheels)
    log(f"[installed] route {route}: {time.perf_counter() - t0!r} s into "
        f"{target}")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "ISS_AUDIO_LIB", "ISS_TRACE_DIR")}
    env.update(PYTHONPATH=target, ISS_TORCH_BUILD_DIR=build,
               ISS_TPU_MODEL_DIR=models)

    # (b) prewarm from the install into an empty build directory
    out, wall = run_installed(
        [sys.executable, "-m", f"{PORT}.tools.prewarm"], env, cwd,
        "prewarm")
    for line in out.splitlines():
        log(f"[installed] {line}")
    package = out.split("[prewarm] package ", 1)[1].split("\n", 1)[0]
    check(package.startswith(target + os.sep),
          f"prewarm imported {package}, not the install")
    cold = float(out.split("CUDA kernels built and loaded in ", 1)[1]
                 .split(" s", 1)[0])
    log(f"[installed] prewarm: cold kernel build {cold!r} s, wall {wall!r} "
        f"s")
    built = build_state(build)
    check(any(n.startswith("libiss_torch_kernels_") for n in built)
          and any(n.startswith("libissaudio_") for n in built),
          f"prewarm left {sorted(built)}")

    # the constructor guard's probe on the card, and the toolkit's release
    # line in the kernel cache's scope
    from inaspeechsegmenter_tpu_torch.utils import cuda_build
    from inaspeechsegmenter_tpu_torch.utils import env as port_env

    probes = []
    for _ in range(3):
        t0 = time.perf_counter()
        answer = port_env.probe_device(dev)
        probes.append(time.perf_counter() - t0)
        check(answer is True, f"the guard's probe answered {answer}")
    log(f"[installed] constructor guard: probe_device({dev}) walls "
        f"{probes!r} s (a subprocess: libcuda, cuInit, a primary context); "
        f"nvcc release line in the kernel cache's scope "
        f"{cuda_build.nvcc_release()!r}")

    # (c) the console script on the 60 s and 10 min WAVs, plain (the
    # first-request wall, the guard's probe included), then traced
    script = os.path.join(target, "bin", "ina_speech_segmenter_torch")
    names = list(files)
    for name in ("mix60", "mix600"):
        wav = wavs[names.index(name)]
        trace = os.path.join(base, "trace_" + name)
        walls, statuses = {}, {}
        # the 10 min file plain with the constructor guard and without it
        # (ISS_CTOR_LINK_WAIT=0) in turns; each file once traced
        no_guard = {**env, "ISS_CTOR_LINK_WAIT": "0"}
        runs = [("plain", env)]
        if name == GUARD_TURNS_FILE:
            runs += [("no_guard", no_guard), ("no_guard", no_guard),
                     ("plain", env)]
        runs.append(("traced", {**env, "ISS_TRACE_DIR": trace}))
        for i, (run, run_env) in enumerate(runs):
            odir = os.path.join(base, f"out_{run}{i}_{name}")
            os.makedirs(odir)
            out, wall = run_installed(
                [sys.executable, script, "-i", wav, "-o", odir, "-b",
                 "none"], run_env, cwd, "ina_speech_segmenter_torch")
            walls.setdefault(run, []).append(wall)
            # "1/1 [(dst, 0, 'ok <s>')]"
            statuses[run] = out.strip().splitlines()[-1]
            with open(os.path.join(odir, name + ".csv"), "rb") as a, \
                    open(os.path.join(workdir, "out", name + ".csv"),
                         "rb") as b:
                check(a.read() == b.read(), f"{name}: the installed console "
                      f"script's csv ({run}) differs from phase 2's")
        kernels = trace_kernels(trace)
        found = {k: sorted(n for n in kernels if k in n)
                 for k in PATH_KERNELS}
        check(all(found.values()),
              f"{name}: the trace lacks a path kernel: {found}")
        check(build_state(build) == built,
              f"{name}: the console script rebuilt: {build_state(build)}")
        size = os.path.getsize(os.path.join(trace, "trace.json"))
        log(f"[installed] ina_speech_segmenter_torch {name} "
            f"({len(files[name]) / SR!r} s of audio): walls {walls['plain']!r}"
            f" s plain with the constructor guard, "
            f"{walls.get('no_guard', [])!r} s without it "
            f"(ISS_CTOR_LINK_WAIT=0), in turns; "
            f"{walls['traced']!r} s with ISS_TRACE_DIR set (batch "
            f"statuses {statuses}), csvs byte-equal to phase 2's, no "
            f"rebuild, trace.json {size} B with kernels {found}")

    # (d-g) one runner on the install: launches, resampler, endurance,
    # the acceptance kit
    cfg = {"models": models, "mix600": wavs[names.index("mix600")],
           "wav44": os.path.join(workdir, "mix60_44k.wav"),
           "n_files": ENDURANCE_FILES, "endurance": endurance,
           "verify": {"hdf5": os.path.join(workdir, "hdf5_models"),
                      "synthetic": models}}
    cfg["launched_at"] = time.time()
    out, wall = run_installed(
        [sys.executable, "-c", INSTALLED_RUNNER, json.dumps(cfg)], env, cwd,
        "the installed runner")
    res = json.loads(out.split("INSTALLED ", 1)[1])
    check(res["package"].startswith(target + os.sep),
          f"the runner imported {res['package']}")
    check(build_state(build) == built,
          f"the runner rebuilt: {build_state(build)}")
    launches = res["launches"]
    log(f"[installed] runner wall {wall!r} s; its start-up, seconds from "
        f"the mark before: {res['start_up']} (the constructor guard: its "
        f"cold probe; latched {res['guard_latched_s']!r} s); mix600 kernel "
        f"launches {launches}")
    check(without_codec(launches) == {"sidekit_fe": 1, "viterbi": 3,
                                      "viterbi_general": 0},
          f"installed mix600 launches {launches}")
    check_routed_launches(launches, "the installed mix600 run")
    got = [tuple(x) for x in res["resampled"]]
    check(res["native_source"] == os.path.join(target, PORT, "native",
                                               "issaudio.cc")
          and os.path.dirname(res["native_library"]) == build,
          f"native library {res['native_library']} from "
          f"{res['native_source']}")
    check(got == resampled, "the installed resampled labels differ from "
          "phase 6(f)'s")
    check_segmentation_launches(res["resampled_launches"],
                                "the installed resampled file")
    log(f"[installed] 44.1 kHz WAV without ffmpeg: {len(got)} segments equal "
        f"to phase 6(f)'s; native library "
        f"{os.path.basename(res['native_library'])} from the package's "
        f"source; launches {res['resampled_launches']}")
    m1, m2 = res["memory_allocated"]
    log(f"[installed] endurance, {ENDURANCE_FILES} two-second WAVs through "
        f"one Segmenter: memory_allocated after the first "
        f"{ENDURANCE_FILES // 2} {m1} B, after the next {m2} B (diff "
        f"{m2 - m1} B); max_memory_allocated {res['max_memory_allocated']} B")
    check(abs(m2 - m1) <= ENDURANCE_MEMORY_SLACK,
          f"device memory grew {m2 - m1} B over the steady files")
    for name, v in res["verify"].items():
        rep = v["report"]
        log(f"[installed] verify_weights --report-only over the {name} set: "
            f"exit {v['rc']}, summary {rep['summary']}, models "
            f"{rep['models']}")
        check(v["rc"] == 0 and rep["ok"], f"verify_weights ({name}) failed")
    hdf5 = res["verify"]["hdf5"]["report"]
    passed = {r["name"] for r in hdf5["results"] if r["status"] == "PASS"}
    check(all(any(n.startswith(m + ": forward") for n in passed)
              for m in ("keras_speech_music_cnn.hdf5",
                        "keras_speech_music_noise_cnn.hdf5",
                        "keras_male_female_cnn.hdf5",
                        "interspeech2023_all.hdf5",
                        "interspeech2023_cvfr.hdf5"))
          and "raw_81.pth: native npz checkpoint" in passed,
          f"verify_weights did not pass every file: {sorted(passed)}")
    synthetic = res["verify"]["synthetic"]["report"]["models"]
    check(sorted(k for k, v in synthetic.items() if v == "synthetic") == sorted(
        k for k in synthetic if k.endswith(".hdf5")),
        f"synthetic stand-ins not reported as such: {synthetic}")
    log(f"[phase 10] installed: {time.perf_counter() - t_phase!r} s")
    return launches


# --------------------------------------------------------------------------
CODEC_TURNS = ("off", "on", "on", "off", "off", "on")   # 3 pairs in turns
CODEC_WALL_MARGIN = 0.02     # the codec's wall worse than this: raw in auto
ELIDE_GROUPS = 2             # 3-chunk groups of the elide-route signal
ELIDE_SILENCE_BLOCKS = 200   # 4 s of digital silence in each group


@contextlib.contextmanager
def env_set(**values):
    """Environment variables set for the block, restored after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def upload_groups(sig):
    """The whole-file upload's group slices of an int16 signal: zero-padded
    to whole chunks plus the 2*HOP lookahead, ``ISS_UPLOAD_CHUNKS`` chunks
    a group, consecutive slices overlapping by 2*HOP (the JAX package's
    grouping, which ``group_shipped_bytes`` counts)."""
    from inaspeechsegmenter_tpu_torch.dsp.fe_kernel import upload_chunks
    from inaspeechsegmenter_tpu_torch.dsp.sidekit import (CHUNK, HOP,
                                                          frame_count)

    n_chunks = max(1, -(-max(frame_count(len(sig)), 1) // CHUNK))
    need = (n_chunks * CHUNK + 2) * HOP
    padded = np.pad(sig[:need], (0, max(0, need - len(sig))))
    group = upload_chunks()
    return [padded[g * CHUNK * HOP:(min(g + group, n_chunks) * CHUNK + 2)
                   * HOP] for g in range(0, n_chunks, group)]


def codec_route(sig):
    """Decode launches the codec's upload of ``sig`` takes, from
    ``pack_best`` on each group: {"unpack_bits": n, "unpack_zero_elide":
    n}."""
    from inaspeechsegmenter_tpu_torch.dsp import codec

    kinds = [(codec.pack_best(g) or (None,))[0] for g in upload_groups(sig)]
    return {"unpack_bits": kinds.count("bits"),
            "unpack_zero_elide": kinds.count("elide")}


def elide_mix(seed=1212):
    """Full-scale seeded int16 noise of ``ELIDE_GROUPS`` groups of 3 chunks
    with ``ELIDE_SILENCE_BLOCKS`` blocks of digital silence in each:
    bit-packing saves under 5% and declines, elision saves a page."""
    from inaspeechsegmenter_tpu_torch.dsp.sidekit import CHUNK, HOP

    rng = np.random.default_rng(seed)
    n = (ELIDE_GROUPS * 3 * CHUNK + 2) * HOP
    sig = rng.integers(-32768, 32768, n).astype(np.int16)
    for g in range(ELIDE_GROUPS):
        a = g * 3 * CHUNK * HOP + 30 * SR
        sig[a:a + ELIDE_SILENCE_BLOCKS * 320] = 0
    return sig


def codec_every_width(seed=12):
    """One block at each width 0..16 under each predictor order, four
    times over (past one pool page)."""
    rng = np.random.default_rng(seed)
    blocks = []
    for order in range(3):
        for w in range(17):
            hi = (1 << w) // 2 if w else 0
            r = rng.integers(-hi, hi, 318) if w else np.zeros(318, np.int64)
            if order == 0:
                x = np.r_[0, 0, r]
            else:
                x = np.zeros(320, np.int64)
                x[0], x[1] = 3, 5
                for n in range(2, 320):
                    pred = x[n - 1] if order == 1 else 2 * x[n - 1] - x[n - 2]
                    x[n] = pred + r[n - 2]
            blocks.append(np.clip(x, -32768, 32767).astype(np.int16))
    return np.concatenate(blocks * 4)


def codec_fuzz(seed, nb=200):
    """Random per-block content classes: silence, DC, tones, noise at
    random scales, full-scale noise, ramps."""
    rng = np.random.default_rng(seed)
    blocks = np.zeros((nb, 320), np.int16)
    for i, k in enumerate(rng.integers(0, 6, nb)):
        if k == 1:
            blocks[i] = rng.integers(-32768, 32768)
        elif k == 2:
            blocks[i] = (np.sin(2 * np.pi * rng.uniform(10, 8000) / SR
                                * np.arange(320))
                         * int(rng.integers(1, 32767))).astype(np.int16)
        elif k == 3:
            blocks[i] = np.clip(rng.standard_normal(320)
                                * float(rng.uniform(0.5, 20000)),
                                -32768, 32767).astype(np.int16)
        elif k == 4:
            blocks[i] = rng.integers(-32768, 32768, 320)
        elif k == 5:
            blocks[i] = (np.arange(320) * int(rng.integers(-200, 201))
                         + int(rng.integers(-30000, 30001))).astype(np.int16)
    return blocks.reshape(-1)


def bits_bound(buf, nb):
    """The bytes the data needs (heads, meta, each block's 40*w packed
    bytes, the samples written) and about 14 integer operations a sample
    (extract, un-zigzag, the scans)."""
    w = (buf[len(buf) - nb:] & 0x1F).astype(np.int64)   # 40*w overflows
    need = 5 * nb + int((40 * np.where(w > 16, 0, w)).sum())   # uint8
    return bound(need + nb * 640, nb * 320 * 14)


def elide_bound(buf, nb):
    """The mask, the surviving pool rows and the samples written; one
    multiply a sample."""
    n_nz = int(np.count_nonzero(buf[len(buf) - nb:]))
    return bound(2 * nb + 640 * n_nz + 640 * nb, nb * 320)


CODEC_DEVICE_NAMES = {"bits": ("unpack_bits_kernel",),
                      "elide": ("unpack_zero_elide_kernel",)}


def vbx_slice(sig):
    """The whole-file VBx upload of an int16 signal with the codec on
    (``dsp/vbx.py::VbxFrontend._features_i16``): zero-padded to a
    1,024-frame bucket plus two codec blocks of mirror-tail headroom."""
    from inaspeechsegmenter_tpu_torch.dsp.codec import BLOCK
    from inaspeechsegmenter_tpu_torch.dsp.sidekit import HOP

    n_frames = (len(sig) - 80) // HOP + 1
    t_bucket = -(-n_frames // 1024) * 1024
    padded = np.zeros((t_bucket + 2) * HOP + 2 * BLOCK, np.int16)
    padded[:len(sig)] = sig
    return padded


def codec_timing_cases(mix600, mix3600):
    """The decoders' timed inputs at three sizes -> [(size, kind, sig,
    packed buffer)]: a 3-chunk upload group (6,145 blocks: the 10 min mix's
    first group for ``bits``, the elide-route signal's for ``elide``, each
    its ``pack_best`` route), and the whole-file VBx slices of the 10 min
    and of a 1 h seeded mix (~30,000 and ~180,000 blocks), each packed both
    ways."""
    from inaspeechsegmenter_tpu_torch.dsp import codec

    group = upload_groups(mix600)[0]
    egroup = upload_groups(elide_mix())[0]
    check(codec.pack_best(group)[0] == "bits"
          and codec.pack_best(egroup)[0] == "elide",
          "the 3-chunk groups take their expected routes")
    cases = [("3-chunk group", "bits", group, codec.pack_best(group)[1]),
             ("3-chunk group", "elide", egroup, codec.pack_best(egroup)[1])]
    for size, sig in (("10 min VBx slice", vbx_slice(mix600)),
                      ("1 h VBx slice", vbx_slice(mix3600))):
        cases += [(size, "bits", sig, codec.pack_bits(sig, min_save=-1.0)),
                  (size, "elide", sig, codec.pack_zero_elide(sig))]
    check(all(c[3] is not None for c in cases), "a timed input did not pack")
    return cases


def time_codec_case(torch, dev, kind, buf, nb, names, reps=None):
    """One decoder on one packed buffer: ``device_ms`` over distinct copies
    of the buffer decoding into distinct outputs, ``cuda_ms`` of the
    wrapper as a caller calls it, and the bound -> dict."""
    from inaspeechsegmenter_tpu_torch.dsp import codec

    fn = codec.unpack_bits if kind == "bits" else codec.unpack_zero_elide
    n_bytes = buf.nbytes + 640 * nb
    copies = [(torch.from_numpy(buf).to(dev),
               torch.empty(320 * nb, dtype=torch.int16, device=dev))
              for _ in range(rotation(n_bytes))]
    x = copies[0][0]
    tm = timing(torch, [lambda b=b, o=o: fn(b, nb, out=o)
                        for b, o in copies], names,
                lambda: fn(x, nb), reps or (50 if nb < 10_000 else 10))
    bound_ms, bound_by = (bits_bound if kind == "bits"
                          else elide_bound)(buf, nb)
    return {"blocks": nb, "packed_bytes": int(buf.nbytes), **tm,
            "copies": len(copies), "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": bound_ms / tm["device_ms"]}


def phase_codec_kernels(torch, dev, files):
    """11(a): both decode kernels against their plain versions on the card,
    bit-exact, on the 10 min mix's upload groups, the elide-route signal's,
    one block at each width and order, an all-zero group, a seeded fuzz of
    20 signals and the timed inputs of ``codec_timing_cases``; device and
    call times at each timed size."""
    from inaspeechsegmenter_tpu_torch.dsp import codec

    plain = {"bits": codec.unpack_bits_plain,
             "elide": codec.unpack_zero_elide_plain}
    kernel = {"bits": codec.unpack_bits, "elide": codec.unpack_zero_elide}
    cases = [(f"mix600 group {i}", g)
             for i, g in enumerate(upload_groups(files["mix600"]))]
    cases += [(f"elide group {i}", g)
              for i, g in enumerate(upload_groups(elide_mix()))]
    cases += [("every width and order", codec_every_width()),
              ("all-zero group", upload_groups(np.zeros(SR, np.int16))[0])]
    cases += [(f"fuzz {i}", codec_fuzz(500 + i)) for i in range(20)]
    checked = {"bits": 0, "elide": 0}

    def check_decode(label, kind, sig, buf):
        nb = len(sig) // 320
        x = torch.from_numpy(buf).to(dev)
        got = kernel[kind](x, nb)
        want = plain[kind](x, nb)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{label}: the {kind} kernel "
              "differs from its plain version")
        check(np.array_equal(got.cpu().numpy(), sig),
              f"{label}: the {kind} kernel's samples are not the source")
        checked[kind] += 1

    for label, sig in cases:
        packed = codec.pack_best(sig)
        forced = [("bits", codec.pack_bits(sig, min_save=-1.0)),
                  ("elide", codec.pack_zero_elide(sig))]
        for kind, buf in ([packed] if packed else []) + forced:
            if buf is not None:
                check_decode(label, kind, sig, buf)
    t0 = time.perf_counter()
    mix3600 = to_int16(seeded_mix(3600, seed=3600,
                                  silences=silences_every(3600)))
    timed = codec_timing_cases(files["mix600"], mix3600)
    del mix3600
    log(f"[codec] the timed inputs built and packed in "
        f"{time.perf_counter() - t0!r} s")
    rows = {"bits": [], "elide": []}
    for size, kind, sig, buf in timed:
        nb = len(sig) // 320
        check_decode(f"{size} ({kind})", kind, sig, buf)
        row = {"size": size, **time_codec_case(
            torch, dev, kind, buf, nb, CODEC_DEVICE_NAMES[kind])}
        if not rows[kind]:
            x = torch.from_numpy(buf).to(dev)
            row["plain_ms"] = cuda_ms(lambda: plain[kind](x, nb), 10, torch)
        rows[kind].append(row)
        log(f"[codec] unpack_{kind} on the {size} ({nb} blocks, "
            f"{buf.nbytes} bytes packed): device_ms={row['device_ms']!r} "
            f"({row['device_by']}) over {row['copies']} distinct buffers, "
            f"call_ms="
            f"{row['call_ms']!r}, floor_ms={row['floor_ms']!r}, bound_ms="
            f"{row['bound_ms']!r} ({row['bound_by']}), share of the bound "
            f"{row['share_of_bound']!r}"
            + (f", plain_ms={row['plain_ms']!r}" if "plain_ms" in row
               else ""))
    log(f"[codec] kernels bit-equal to their plain versions and to the "
        f"source on {len(cases)} inputs and the {len(timed)} timed buffers "
        f"({checked['bits']} bits and {checked['elide']} elide buffers, "
        f"the pack_best route and both forced)")
    out = []
    for kind, replaces in (("bits", ":227"), ("elide", ":115")):
        group = rows[kind][0]
        name = "unpack_bits" if kind == "bits" else "unpack_zero_elide"
        out.append({
            "name": name, "route": "cuda",
            "source": "inaspeechsegmenter_tpu_torch/csrc/codec.cu",
            "replaces": "inaspeechsegmenter_tpu/dsp/codec.py" + replaces,
            "max_abs_err": 0.0, "ms": group["device_ms"],
            "device_ms": group["device_ms"], "device_by": group["device_by"],
            "call_ms": group["call_ms"],
            "floor_ms": group["floor_ms"], "plain_ms": group["plain_ms"],
            "bound_ms": group["bound_ms"], "bound_by": group["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call decodes this format",
            "size": f"{group['size']}: {group['blocks']} blocks of 320 "
                    f"int16 samples", "sizes": rows[kind]})
    return out


def walls_in_turns(torch, fn, turns):
    """Warm walls of ``fn()`` with ``ISS_UPLOAD_CODEC`` as ``turns`` says
    -> {"on": [s, ...], "off": [...]}."""
    walls = {"on": [], "off": []}
    for mode in turns:
        with env_set(ISS_UPLOAD_CODEC="1" if mode == "on" else "0"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
    return walls


def phase_codec(torch, dev, workdir, seg, vfs, files, wavs, models):
    """11: the upload codec and the frontend choice on the card.  -> (the
    two kernels' JSON entries, launches of its main-path runs)."""
    from inaspeechsegmenter_tpu_torch import OnlineSegmenter, Segmenter
    from inaspeechsegmenter_tpu_torch import segmenter as tseg
    from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
    from inaspeechsegmenter_tpu_torch.dsp import codec
    from inaspeechsegmenter_tpu_torch.dsp.fe_kernel import (
        group_shipped_bytes)
    from inaspeechsegmenter_tpu_torch.dsp.host_fe import HostSidekitFrontend
    from inaspeechsegmenter_tpu_torch.vfs import STEP, WINLEN

    t_phase = time.perf_counter()
    entries = phase_codec_kernels(torch, dev, files)
    per = {}

    # (b) the main path with ISS_UPLOAD_CODEC=1
    names = ["mix60", "mix600", "elide"]
    sigs = {"mix60": files["mix60"], "mix600": files["mix600"],
            "elide": elide_mix()}
    paths = {"mix60": wavs[list(files).index("mix60")],
             "mix600": wavs[list(files).index("mix600")],
             "elide": os.path.join(workdir, "elide.wav")}
    write_wav(paths["elide"], sigs["elide"], SR)
    out = {m: [os.path.join(workdir, "codec_" + m, n + ".csv")
               for n in names] for m in ("off", "on")}
    for m in ("off", "on"):
        with env_set(ISS_UPLOAD_CODEC="1" if m == "on" else "0"):
            res = seg.batch_process([paths[n] for n in names], out[m])
            check(res[1] == len(names), f"codec {m}: statuses {res[3]}")
    for a, b in zip(out["off"], out["on"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            check(fa.read() == fb.read(), f"{b}: csv differs with the codec")
    real_pack_best = codec.pack_best
    for n in names:
        shipped = []

        def spy(raw):
            p = real_pack_best(raw)
            shipped.append(2 * len(raw) if p is None else p[1].nbytes)
            return p

        want = codec_route(sigs[n])
        with env_set(ISS_UPLOAD_CODEC="1"):
            expect, raw_b = group_shipped_bytes(sigs[n])
            codec.pack_best = spy
            reset_kernel_counts()
            try:
                seg(paths[n])
                torch.cuda.synchronize()
            finally:
                codec.pack_best = real_pack_best
        per[f"codec_{n}"] = got = kernel_counts()
        check(sum(shipped) == expect, f"{n}: shipped {sum(shipped)} bytes, "
              f"group_shipped_bytes {expect}")
        check({k: got[k] for k in CODEC_KERNELS} == want,
              f"{n}: decode launches {got}, the route gives {want}")
        with env_set(ISS_UPLOAD_CODEC="1"):
            check_segmentation_launches(got, n)
        groups = upload_groups(sigs[n])
        enc = [host_ms(lambda: real_pack_best(g), reps=3)[1]
               for g in groups]
        log(f"[codec] {n}: {len(groups)} groups, route {want}, shipped "
            f"{sum(shipped)} of {raw_b} raw bytes (ratio "
            f"{sum(shipped) / raw_b!r}, equal to group_shipped_bytes); host "
            f"encode ms a group {enc}; csv byte-equal to the codec-off "
            f"run; launches {got}")
    check(per["codec_elide"]["unpack_zero_elide"] > 0,
          "the elide file did not launch unpack_zero_elide")
    walls = {n: walls_in_turns(torch, lambda: seg(paths[n]), CODEC_TURNS)
             for n in ("mix60", "mix600")}
    for n, w in walls.items():
        on, off = float(np.median(w["on"])), float(np.median(w["off"]))
        log(f"[codec] {n} warm Segmenter walls in turns {CODEC_TURNS} (s): "
            f"{w}; median on {on!r}, off {off!r}, on/off {on / off!r} "
            f"(worse by more than {CODEC_WALL_MARGIN}: "
            f"{on > off * (1 + CODEC_WALL_MARGIN)})")

    # VFS and the online segmenter with the codec on
    res, feas = {}, {}
    for m in ("off", "on"):
        with env_set(ISS_UPLOAD_CODEC="1" if m == "on" else "0"):
            if m == "on":
                reset_kernel_counts()
            res[m] = vfs(paths["mix60"])
            if m == "on":
                torch.cuda.synchronize()
                per["codec_vfs_mix60"] = kernel_counts()
            feas[m] = vfs._prepare(paths["mix60"])[1]
    check(res["on"] == res["off"], f"VFS tuples differ: {res}")
    check(torch.equal(feas["on"], feas["off"]),
          "VBx features differ with the codec")
    starts = np.arange(0, len(feas["on"]) - WINLEN, STEP)[:256]
    xm = vfs.xvector_model
    err = rel_l2(xm.embeddings_from_features(feas["on"], starts),
                 xm.embeddings_from_features(feas["off"], starts))
    check(err <= XVEC_REL_LIMIT, f"x-vectors differ by {err}")
    check({k: per["codec_vfs_mix60"][k] for k in CODEC_KERNELS}
          == codec_route(sigs["mix60"]), "the VFS upload's decodes")
    check_cnn_launches(per["codec_vfs_mix60"], "the VFS with the codec")
    finals = {}
    for m in ("off", "on"):
        with env_set(ISS_UPLOAD_CODEC="1" if m == "on" else "0"):
            sig = sigs["mix600"]
            online = OnlineSegmenter(seg)
            if m == "on":
                reset_kernel_counts()
            for pos in range(0, len(sig), 10 * SR):
                online.feed(sig[pos:pos + 10 * SR])
            finals[m] = online.finalize()
            if m == "on":
                torch.cuda.synchronize()
                per["codec_online_mix600"] = kernel_counts()
                n_diff, n_fr = frames_differ(finals[m],
                                             seg.segment_signal(sig))
    check(finals["on"] == finals["off"], "the online finalize differs with "
          "the codec")
    check(n_diff <= 0.001 * n_fr, "online finalize vs segment_signal with "
          "the codec differ on >0.1%")
    check({k: per["codec_online_mix600"][k] for k in CODEC_KERNELS}
          == codec_route(sigs["mix600"]), "the online groups' decodes")
    check_cnn_launches(per["codec_online_mix600"],
                       "the online segmenter with the codec")
    log(f"[codec] vfs(mix60) with the codec on {res['on']} equal to off; VBx "
        f"features bit-equal; {len(starts)} x-vectors rel L2 {err!r} "
        f"(limit {XVEC_REL_LIMIT}); launches {per['codec_vfs_mix60']}. "
        f"OnlineSegmenter over mix600 in 10 s blocks with the codec: "
        f"finalize equal to the codec-off finalize, {n_diff} of {n_fr} "
        f"frames differ from segment_signal; launches "
        f"{per['codec_online_mix600']}")

    # (c) the host frontend and the frontend choice
    with env_set(ISS_FRONTEND="host"):
        host = Segmenter("smn", True, ffmpeg=None, device=dev,
                         model_dir=models, allow_download=False)
    check(isinstance(host.frontend, HostSidekitFrontend),
          f"ISS_FRONTEND=host gave {type(host.frontend).__name__}")
    for n in ("mix60", "mix600"):
        t0 = time.perf_counter()
        got = host(paths[n])
        wall = time.perf_counter() - t0
        n_diff, n_fr = frames_differ(got, seg(paths[n]))
        log(f"[frontend] {n} with the host frontend: wall {wall!r} s, "
            f"{n_diff} of {n_fr} frames differ from the kernel frontend's")
        check(n_diff <= 0.001 * n_fr, f"{n}: host frontend labels differ on "
              ">0.1%")
    kernel_fe = vfs.vad.frontend
    vfs.vad.frontend = HostSidekitFrontend(dev)
    try:
        with env_set(ISS_UPLOAD_CODEC="1"):
            host_res = vfs(paths["mix60"])
    finally:
        vfs.vad.frontend = kernel_fe
    mbps = tseg._link_bandwidth_mbps(dev, max_age_s=0.0)
    with env_set(ISS_FRONTEND="auto"):
        choice = type(tseg._default_frontend(dev)).__name__
    log(f"[frontend] vfs(mix60) with the host frontend (its own packed VBx "
        f"upload): {host_res} (kernel frontend {res['off']}); link probe "
        f"{mbps!r} MB/s; ISS_FRONTEND=auto takes {choice} on this host "
        f"({os.cpu_count()} cores)")
    check(host_res[2] >= 0 and host_res[1] >= 0, f"VFS {host_res}")
    log(f"[phase 11] upload codec and frontend choice: "
        f"{time.perf_counter() - t_phase!r} s")
    return entries, per


# --------------------------------------------------------------------------
MULTIHOST_TIMEOUT = 300         # seconds a rank process may take
MULTIHOST_FILES = ("mix60", "mix600")   # rank r segments file r

MULTIHOST_RANK = r"""
import json, sys, time
t0 = time.time()
import torch
import torch.distributed as dist
from inaspeechsegmenter_tpu_torch import Segmenter
from inaspeechsegmenter_tpu_torch.decode import viterbi as tv
from inaspeechsegmenter_tpu_torch.dsp import codec, fe_kernel
from inaspeechsegmenter_tpu_torch.export import seg2csv
from inaspeechsegmenter_tpu_torch.models import layers
from inaspeechsegmenter_tpu_torch.parallel import global_mesh, init_multihost
""" + CNN_FORWARDS + r"""

cfg = json.loads(sys.argv[1])
rank = cfg["rank"]
ok = init_multihost(cfg["address"], cfg["world"], rank, device="cuda")
x = torch.tensor([float(rank)])
dist.all_reduce(x)
mesh = global_mesh()
wrappers = {"sidekit_fe": fe_kernel.sidekit_features,
            "viterbi": tv.viterbi_scan,
            "viterbi_general": tv.viterbi_scan_general,
            "unpack_bits": codec.unpack_bits,
            "unpack_zero_elide": codec.unpack_zero_elide,
            "cnn_epilogue": layers.cnn_epilogue}
seg = Segmenter("smn", True, ffmpeg=None, model_dir=cfg["models"],
                allow_download=False)
for w in wrappers.values():
    w.launches = 0
seg2csv(seg(cfg["wav"]), cfg["csv"])
torch.cuda.synchronize()
launches = {k: w.launches for k, w in wrappers.items()}
launches["cnn_forwards"] = _cnn["forwards"]
dist.barrier()
out = {"rank": rank, "init": ok, "sum": float(x[0]),
       "backend": dist.get_backend(), "world": dist.get_world_size(),
       "device": str(seg.device), "current_device": torch.cuda.current_device(),
       "mesh": [str(d) for d in mesh.devices.flat], "launches": launches,
       "wall": time.time() - t0}
dist.destroy_process_group()
print("RANK " + json.dumps(out), flush=True)
"""


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_multihost(workdir, files, wavs, models):
    """Phase 12: ``init_multihost`` on one card: two rank processes join
    one ``gloo`` group on 127.0.0.1 (NCCL refuses two ranks on one card),
    an ``all_reduce`` of the ranks sums to 1, and each rank segments one
    WAV on the card into a csv byte-equal to phase 2's
    ``Segmenter.batch_process`` csv.  A rank that fails or outlives
    ``MULTIHOST_TIMEOUT`` fails the phase.  -> the ranks' summed launches."""
    t_phase = time.perf_counter()
    odir = os.path.join(workdir, "multihost")
    os.makedirs(odir)
    names = list(files)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    address = f"127.0.0.1:{free_port()}"
    procs = []
    for rank, name in enumerate(MULTIHOST_FILES):
        cfg = {"rank": rank, "world": len(MULTIHOST_FILES),
               "address": address, "models": models,
               "wav": wavs[names.index(name)],
               "csv": os.path.join(odir, name + ".csv")}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MULTIHOST_RANK, json.dumps(cfg)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MULTIHOST_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "RANK " not in out:
            log(out[-4000:])
        check(p.returncode == 0, f"multihost rank {rank} exited "
              f"{p.returncode}")
        results.append(json.loads(out.split("RANK ", 1)[1]))
    total = {}
    for r, name in zip(results, MULTIHOST_FILES):
        check(r["init"] is True and r["world"] == 2 and r["sum"] == 1.0
              and r["backend"] == "gloo",
              f"rank {r['rank']}: init {r['init']}, world {r['world']}, "
              f"all_reduce {r['sum']}, backend {r['backend']}")
        with open(os.path.join(odir, name + ".csv"), "rb") as a, \
                open(os.path.join(workdir, "out", name + ".csv"), "rb") as b:
            check(a.read() == b.read(), f"rank {r['rank']}: {name}.csv "
                  "differs from phase 2's batch_process csv")
        check(without_codec(r["launches"]) == {
            "sidekit_fe": 1, "viterbi": 3, "viterbi_general": 0},
            f"rank {r['rank']} launches {r['launches']}")
        check_routed_launches(r["launches"], f"rank {r['rank']}")
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
        log(f"[multihost] rank {r['rank']} of {r['world']} ({r['backend']} "
            f"on {address}, device {r['device']}, current device "
            f"{r['current_device']}, mesh {r['mesh']}): all_reduce of the "
            f"ranks {r['sum']!r}; {name}.csv byte-equal to phase 2's; "
            f"launches {r['launches']}; process wall {r['wall']!r} s")
    log(f"[phase 12] multihost: {time.perf_counter() - t_phase!r} s")
    return total


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    card = gpu_line()
    log(f"[card] {card}")
    dev = torch.device("cuda", 0)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from inaspeechsegmenter_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    lib = cuda_build.build(verbose=True)
    cuda_build.library()
    log(f"[build] {os.path.basename(lib)} built and loaded in "
        f"{time.perf_counter() - t0!r} s")
    count_cnn_forwards()

    # the plain versions of the kernels compare on the card with TF32 off;
    # the port's own calls set their flags in scopes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if EPILOGUE_FLAG in sys.argv:
        with tempfile.TemporaryDirectory() as workdir:
            entry = phase_cnn_epilogue(torch, dev, workdir)
        print(json.dumps({"kernels": [entry]}), flush=True)
        print(gpu_line(), flush=True)
        return 0
    if MESH_STEP_FLAG in sys.argv:
        with tempfile.TemporaryDirectory() as workdir:
            mesh_step_diagnosis(torch, dev, workdir, int(
                sys.argv[sys.argv.index(MESH_STEP_FLAG) + 1]))
        return 0
    kernels = [phase_features(torch, dev), phase_viterbi(torch, dev)]
    with tempfile.TemporaryDirectory() as workdir:
        epilogue = phase_cnn_epilogue(torch, dev, workdir)
        seg, launches, files, wavs, models, per_file = phase_main(
            torch, dev, workdir)
        vfs, params, launches_vfs, per_vfs_file, speech_rate = phase_vfs(
            torch, dev, workdir, files, wavs, models)
        per_online_file, per_streaming = phase_online(
            torch, dev, workdir, seg, vfs, files, wavs)
        launches_real, per_ffmpeg_file = phase_real_inputs(
            torch, dev, workdir, seg, vfs, params, files, wavs, models)
        general, per_ref, resampled = phase_reference(
            torch, dev, workdir, seg, vfs, files, wavs, models, speech_rate)
        per_ref.update(per_streaming)
        per_ref.update(phase_train_score_farm(torch, dev, workdir, seg,
                                              files, wavs, models))
        per_ref.update(phase_engine(torch, dev, workdir, seg, vfs, params,
                                    files, wavs, models, speech_rate))
        per_ref.update(phase_overlap(torch, dev, vfs, files, wavs, models))
        per_ref["installed"] = phase_installed(torch, dev, workdir, files,
                                               wavs, models, resampled)
        codec_entries, per_codec = phase_codec(torch, dev, workdir, seg, vfs,
                                               files, wavs, models)
        per_ref.update(per_codec)
        per_ref["multihost"] = phase_multihost(workdir, files, wavs, models)
    kernels.append(general)
    kernels += codec_entries
    kernels.append(epilogue)
    for k in kernels:
        name = k["name"]
        earlier = {"segmentation": per_file, "vfs": per_vfs_file,
                   "online": per_online_file, "ffmpeg": per_ffmpeg_file}
        k["launches_per_file"] = {
            path: counts[name]
            for path, counts in {**earlier, **per_ref}.items()}
        # the main-path runs of phases 2-12 (the kernels' comparisons with
        # their plain versions excluded)
        k["launches"] = sum(c[name] for c in (
            launches, launches_vfs, per_online_file, launches_real,
            *per_ref.values()))
        check(k["launches"] > 0, f"no main-path run launched {name}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
