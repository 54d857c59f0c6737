"""Share of the traced window in which no kernel, copy or memset ran on
the device (the profiler's device timeline)."""


def read(ctx):
    t = ctx["trace"]
    if not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
