"""Model kinds, one module a ``kind`` of ``configs/``' ``models``, found
by name (``weights.kind``).  Each holds:

- ``draws(m) -> (n_normal, n_uniform)``: the sizes of the model's one
  normal and one uniform draw (``weights.make``);
- ``draw(m, d) -> {"layers", "torch"}``: the model's arrays, sliced in
  order from ``d`` (``weights._Draws``), as a tree of device tensors
  (``torch``), with the Keras layer list where the port reads the model
  from a model directory (``layers``; None where it takes the arrays
  through another door);
- ``TINY``: the model's small sizes for the CPU tests (``tiny``), merged
  over its entry; never a size of a benchmark run.

It may also hold the model's FLOP or byte counts.  A new kind is a new
file here; no other file names a kind.
"""
