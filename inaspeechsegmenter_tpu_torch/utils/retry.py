"""Per-file retry with randomized backoff — the reference's batch retry
policy (segmenter.py:360-368).  Copy of
``inaspeechsegmenter_tpu/utils/retry.py`` (that package imports jax)."""

from __future__ import annotations

import random
import sys
import time


def retry_call(fn, nbtry=1, trydelay=2.):
    """Call ``fn()`` up to ``nbtry`` times, sleeping a random fraction of
    ``trydelay`` between attempts.  Returns ``(result, None)`` on success
    or ``(None, exc_type)`` after the budget is exhausted (the reference
    reports the exception CLASS in status tuples)."""
    err = None
    for itry in range(nbtry):
        try:
            return fn(), None
        except Exception:
            err = sys.exc_info()[0]
            if itry != nbtry - 1:
                time.sleep(random.random() * trydelay)
    return None, err
