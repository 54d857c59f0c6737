"""Deployment tools of the port, run as modules:

- ``python -m inaspeechsegmenter_tpu_torch.tools.prewarm``: build the
  kernels and the native audio library, and warm each engine, before the
  first request;
- ``python -m inaspeechsegmenter_tpu_torch.tools.verify_weights``: the
  released-weights acceptance kit (topology reports and the reference's
  golden battery).
"""
