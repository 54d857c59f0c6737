"""Tiny sizes for the CPU tests: a few short files and narrow models, so
that a whole run of any cell takes seconds on the host."""

from __future__ import annotations

SMALL_CNN = {"filters": [8, 16, 32, 32], "dense": 32}
SMALL_RESNET = {"num_blocks": [1, 1, 1, 1], "m_channels": 8}


def overrides(config, sample_s=100.0):
    """``run.run_cell`` overrides for a cell of configuration ``config``."""
    from perfbench import spec

    models = spec.config(config)["models"]
    small = {k: (SMALL_RESNET if m["kind"] == "resnet_xvector" else
                 SMALL_CNN if m["kind"] == "patch_cnn" else {})
             for k, m in models.items()}
    return {"workload": {"params": {"files": 2, "min_s": 6, "max_s": 12,
                                    "batch_files": 2, "clips": 3,
                                    "rate": 4.0, "drain_s": 20},
                         "check": {"sample_s": sample_s}},
            "config": {"models": small}}
