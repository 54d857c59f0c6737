"""Depth-N producer/consumer batch driver.

Copy of ``inaspeechsegmenter_tpu/utils/prefetch.py`` (that package imports
jax).  The reference overlaps the NEXT file's decode and features with the
CURRENT file's inference (reference segmenter.py:377-387).  This does it
once for both corpus surfaces (``Segmenter.batch_process``,
``VoiceFemininityScoring.batch_score``): ``ISS_PREFETCH`` producer threads
run ``produce`` ahead while the consumer drains serially, and any exception
escaping ``produce``/``consume`` becomes that file's ``(dst, 2, 'error:
...')`` status tuple instead of aborting the batch.

Spans (``utils.timing``): ``prefetch.produce`` around each ``produce``
on its producer thread, and ``prefetch.wait`` around the consumer's wait
for each file's producer.

Producers launch CUDA kernels from their own threads, on the default
stream like the consumer: what overlaps is host work (the WAV read, the
VBx dither and mirror pad), not device work.  ``torch.no_grad()`` is
thread-local, so every model forward that a producer reaches carries its
own; the TF32 flags are process-wide, so every cuBLAS or cuDNN call runs
in a ``models.layers.precision_scope``, which holds a lock while it sets
them.
"""

from __future__ import annotations

import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

from .retry import retry_call
from .timing import span


def prefetch_depth():
    """Producer-thread depth: ``ISS_PREFETCH`` when it parses, else 2 on
    hosts with >= 4 cores and 1 below (on low-core hosts concurrent
    producers contend with the device driver).  A malformed value warns and
    falls back instead of aborting the whole corpus job at batch start."""
    default = 2 if (os.cpu_count() or 1) >= 4 else 1
    raw = os.environ.get("ISS_PREFETCH", "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            warnings.warn(f"ignoring malformed ISS_PREFETCH={raw!r}; "
                          f"using the default depth {default}")
    return default


def staged_producer(stage, skipifexist=False, nbtry=1, trydelay=2.):
    """The standard corpus ``produce`` callback: skipifexist check,
    output-dir mkdir, retried ``stage(src)``, reference status tuples
    (reference segmenter.py:360-372)."""

    def produce(item):
        src, dst = item
        if skipifexist and os.path.exists(dst):
            return None, (dst, 1, "already exists")
        dname = os.path.dirname(dst)
        if dname and not os.path.isdir(dname):
            os.makedirs(dname, exist_ok=True)
        payload, err = retry_call(lambda: stage(src),
                                  nbtry=nbtry, trydelay=trydelay)
        if payload is None:
            return None, (dst, 2, "error: " + str(err))
        return payload, (dst, 0, "ok")

    return produce


def run_prefetched(items, produce, consume, verbose=False):
    """Drive ``items`` (src, dst) through produce (threaded) + consume.

    ``produce(item) -> (payload | None, msg)`` with ``msg`` a reference
    status tuple ``(dst, 0|1|2, text)``; payload None means skip/error.
    ``consume(payload, item, msg) -> msg`` runs serially in call order.

    :return: the reference batch accounting ``(total_s, n_ok,
        avg_s_per_ok, lmsg)`` with ``lmsg`` in input order.
    """
    t0 = time.time()
    lmsg = []
    items = list(items)
    depth = prefetch_depth()

    def produce_in_span(item):
        with span("prefetch.produce"):
            return produce(item)

    with ThreadPoolExecutor(max_workers=depth) as pool:
        futs = {i: pool.submit(produce_in_span, items[i])
                for i in range(min(depth, len(items)))}
        for i, item in enumerate(items):
            try:
                with span("prefetch.wait"):
                    payload, msg = futs.pop(i).result()
            except Exception as exc:   # produce escaping its own retry
                payload, msg = None, (item[1], 2, "error: " + repr(exc))
            j = i + depth
            if j < len(items):
                futs[j] = pool.submit(produce_in_span, items[j])
            lmsg.append(msg)
            if payload is not None:
                try:
                    lmsg[-1] = consume(payload, item, msg)
                except Exception as exc:  # bad dst, full disk, ...
                    lmsg[-1] = (item[1], 2, "error: " + repr(exc))
            if verbose:
                print("%d/%d" % (len(lmsg), len(items)), [lmsg[-1]])
    dur = time.time() - t0
    n_ok = len([e for e in lmsg if e[1] == 0])
    return dur, n_ok, dur / n_ok if n_ok else -1, lmsg
