"""Traffic generators, one module per ``generator`` of ``workloads/``:
each writes its corpus in ``prepare``, warms the cell's shapes in ``warm``,
drives the window in ``run`` and stops what it started in ``close``."""
