"""Multi-file data-parallel segmentation engine, the counterpart of
``inaspeechsegmenter_tpu/parallel/engine.py``.

Files are grouped by length bucket (the JAX feature-row ladder,
``bucket_rows``) and a group's files run at once, file k on mesh slot k:
on that slot's replica of the models (``FusedPipeline.slots``), on its own
thread and its own CUDA stream.  Host decode and features of the next
group are staged on a worker thread while the current group runs.

A single file, where file-level parallelism has nothing to share out,
has its TIMELINE spread over the mesh instead: `__call__` /
`segment_feats_sharded` call `FusedPipeline.run_sharded`, and
`segment_many` routes a file that is alone in its length bucket through
it (the ragged tail of a multi-group bucket stays on the per-file path,
as in the JAX engine).  A 1-slot mesh keeps the plain fused path.

The JAX engine pads a short group with copies of its first file, because
its vmapped program has one batch shape; the port runs no copies (a
group of two files on eight slots runs two).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

from ..dsp.sidekit import CHUNK
from ..export import seg2csv, seg2textgrid
from ..segmenter import patch_counts
from ..utils.retry import retry_call
from .mesh import make_mesh, run_on_slots


def bucket_rows(rows):
    """The JAX package's padded feature-row count for ``rows`` rows: the
    1.5x chunk-count ladder (1, 2, 4, 6, 9, ...) times CHUNK.  The port
    pads nothing; the engine groups files by it, as the JAX engine groups
    its padded arrays by shape."""
    n, b = max(1, -(-rows // CHUNK)), 1
    while b < n:
        b = b * 2 if b < 4 else (b * 3 + 1) // 2
    return b * CHUNK


class ParallelEngine:
    """Data-parallel wrapper around a Segmenter.

    :param segmenter: a constructed `Segmenter` (models + pipeline).
    :param mesh: a 1-D `Mesh`; by default every visible CUDA device (none
        visible raises).
    """

    def __init__(self, segmenter, mesh=None):
        self.seg = segmenter
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_dev = self.mesh.devices.size
        self.devices = list(self.mesh.devices.flat)

    def __call__(self, medianame, start_sec=None, stop_sec=None):
        """Single-file segmentation with the file's timeline spread over
        the mesh -> [(label, start_s, stop_s)], equal to
        `Segmenter.__call__` (tests/test_torch_sharded_file.py)."""
        feats = self.seg._media2feats(medianame, start_sec, stop_sec)
        return self.segment_feats_sharded(
            *feats, 0 if start_sec is None else start_sec)

    def segment_feats_sharded(self, mspec, loge, t, difflen, start_sec=0):
        """Sharded-timeline decode of prepared features -> lseg."""
        n_frames_patch, n20 = patch_counts(t, difflen)
        with self.seg.timers.time("segment"):
            if self.n_dev == 1:
                # nothing to spread: the fused path on the one slot
                ids = self._run_group([(mspec, loge, t, difflen)])[0]
            else:
                ids = self.seg.pipeline.run_sharded(
                    mspec, loge, t, n_frames_patch, n20,
                    self.mesh).cpu().numpy()[:n20]
        return self.seg.ids_to_lseg(ids, start_sec)

    def _run_group(self, group):
        """Files k = 0.. of ``group`` [(mspec, loge, t, difflen)] through
        the fused `run`, file k on slot k -> numpy label ids per file."""
        pipes, streams = self.seg.pipeline.slots(self.mesh)
        n = len(group)
        items = [(mspec.to(d), loge.to(d), t, difflen)
                 for (mspec, loge, t, difflen), d in zip(group,
                                                         self.devices)]

        def slot(k, item):
            mspec, loge, t, difflen = item
            n_frames_patch, n20 = patch_counts(t, difflen)
            ids = pipes[k].run(mspec, loge, t, n_frames_patch, n20)
            return ids.cpu().numpy()[:n20]

        return run_on_slots(slot, items, self.devices[:n], streams[:n])

    def segment_many(self, feats_list, shard_single_file=True):
        """Segment a list of (mspec, loge, t, difflen), a mesh-sized group
        of one length bucket at a time -> numpy label ids per file.

        ``shard_single_file=False`` keeps a file that is alone in its
        bucket on the per-file path (``batch_process`` passes it for a
        corpus, whose ragged tail groups stay per-file, as in the JAX
        engine)."""
        out = [None] * len(feats_list)
        groups = defaultdict(list)
        for i, (mspec, _, _, _) in enumerate(feats_list):
            groups[bucket_rows(mspec.shape[0])].append(i)
        for idxs in groups.values():
            for j0 in range(0, len(idxs), self.n_dev):
                chunk = idxs[j0:j0 + self.n_dev]
                if len(idxs) == 1 and self.n_dev > 1 and shard_single_file:
                    # a bucket whose only file is this one: spread its
                    # timeline over the mesh
                    i = chunk[0]
                    mspec, loge, t, difflen = feats_list[i]
                    nfp, n20 = patch_counts(t, difflen)
                    out[i] = self.seg.pipeline.run_sharded(
                        mspec, loge, t, nfp, n20,
                        self.mesh).cpu().numpy()[:n20]
                    continue
                ids = self._run_group([feats_list[i] for i in chunk])
                for i, got in zip(chunk, ids):
                    out[i] = got
        return out

    def batch_process(self, linput, loutput, verbose=False, skipifexist=False,
                      nbtry=1, trydelay=2., output_format="csv"):
        """Batch segmentation with the reference's status tuples, in input
        order (a skipped file keeps its slot): (t_batch_dur, nb_processed,
        avg_per_file, [(dst, 0|1|2, status)]).  The next group's decode
        and features are staged on a worker thread while the current group
        runs; each file gets the ``nbtry`` / ``trydelay`` retry budget, and
        a failing export is that file's ``error: ...`` status."""
        if output_format not in ("csv", "textgrid"):
            raise NotImplementedError()
        fexport = {"csv": seg2csv, "textgrid": seg2textgrid}[output_format]
        t0 = time.time()
        lmsg = [None] * len(linput)
        todo = []
        for pos, (src, dst) in enumerate(zip(linput, loutput)):
            if skipifexist and os.path.exists(dst):
                lmsg[pos] = (dst, 1, "already exists")
                continue
            dname = os.path.dirname(dst)
            if dname and not os.path.isdir(dname):
                os.makedirs(dname, exist_ok=True)
            todo.append((pos, src, dst))

        def stage(item):
            _, src, dst = item
            feats, err = retry_call(lambda: self.seg._media2feats(src),
                                    nbtry=nbtry, trydelay=trydelay)
            if feats is None:
                return None, (dst, 2, "error: " + str(err))
            return feats, (dst, 0, "ok")

        def stage_all(batch):
            return [stage(x) for x in batch]

        # a single-file workload spreads its timeline over the mesh; the
        # ragged tail of a corpus stays per-file
        shard_single = len(todo) == 1
        batches = [todo[i:i + self.n_dev]
                   for i in range(0, len(todo), self.n_dev)]
        done = 0
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(stage_all, batches[0]) if batches else None
            for bi, batch in enumerate(batches):
                staged = fut.result()
                fut = (pool.submit(stage_all, batches[bi + 1])
                       if bi + 1 < len(batches) else None)
                ok = [(i, f) for i, (f, _) in enumerate(staged)
                      if f is not None]
                results = self.segment_many(
                    [f for _, f in ok],
                    shard_single_file=shard_single) if ok else []
                res_by_idx = {i: r for (i, _), r in zip(ok, results)}
                for i, (feats, msg) in enumerate(staged):
                    pos = batch[i][0]
                    lmsg[pos] = msg
                    done += 1
                    if feats is not None:
                        b = time.time()
                        try:
                            fexport(self.seg.ids_to_lseg(res_by_idx[i]),
                                    batch[i][2])
                            lmsg[pos] = (msg[0], msg[1],
                                         "ok " + str(time.time() - b))
                        except Exception as e:  # noqa: BLE001
                            lmsg[pos] = (msg[0], 2, "error: " + repr(e))
                    if verbose:
                        print("%d/%d" % (done, len(todo)), [lmsg[pos]])

        dur = time.time() - t0
        n_ok = len([e for e in lmsg if e is not None and e[1] == 0])
        return dur, n_ok, dur / n_ok if n_ok else -1, lmsg
