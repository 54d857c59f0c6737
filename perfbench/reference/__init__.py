"""Plain references, one module per configuration (``<config>.py``)."""
