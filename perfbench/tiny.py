"""Tiny sizes for the CPU tests: a few short files and narrow models, so
that a whole run of any cell takes seconds on the host.  A model's small
sizes are its kind's ``TINY`` (``kinds/``)."""

from __future__ import annotations

from perfbench.kinds import patch_cnn, resnet_xvector

SMALL_CNN = patch_cnn.TINY
SMALL_RESNET = resnet_xvector.TINY


def overrides(config, sample_s=100.0):
    """``run.run_cell`` overrides for a cell of configuration ``config``."""
    from perfbench import spec, weights

    models = spec.config(config)["models"]
    small = {k: weights.kind(m["kind"]).TINY for k, m in models.items()}
    return {"workload": {"params": {"files": 2, "min_s": 6, "max_s": 12,
                                    "batch_files": 2, "clips": 3,
                                    "rate": 4.0, "drain_s": 20},
                         "check": {"sample_s": sample_s}},
            "config": {"models": small}}
