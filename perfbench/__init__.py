"""Benchmark of the PyTorch/CUDA port ``inaspeechsegmenter_tpu_torch``.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
its result as the last line of standard output.  Everything that belongs to
one configuration, traffic mix or per-layer metric is a file of its own,
found by name (``configs/``, ``kinds/``, ``workloads/``, ``traffic/``,
``systems/``, ``reference/``, ``metrics/``).
"""
