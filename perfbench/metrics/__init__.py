"""Per-layer metric readers, one file a metric (``<metric>.py``), each with
``read(ctx) -> float | None``: None when the traced window holds nothing
to read, and the run then leaves the metric out.  ``ctx`` holds the
reduced trace (``trace``, with the port's spans and counters of the
traced attempt, read through ``spans.host_s``, ``device_s`` and
``counter``), the window's length (``window_s``), its
completed answers (``instances``, each with its samples ``n`` and its
parsed ``answer``), the audio seconds, the decode timer's delta, the clip service times, the configuration and the frozen
``counts``."""
