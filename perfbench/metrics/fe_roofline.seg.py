"""The features kernel's share of its roofline: the frozen
``features_work`` bound of every file of the traced window (one int16
launch a file) over the device time of ``sidekit_fe_kernel``."""


def read(ctx):
    c = ctx["counts"]
    from perfbench.trace import kernel_seconds

    _, took = kernel_seconds(ctx["trace"], "sidekit_fe_kernel")
    need = sum(c.bound_s(*c.features_work(i["n"])) for i in ctx["instances"])
    return c.share(need, took)
