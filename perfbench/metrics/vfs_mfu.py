"""The whole VFS step's share of the card's float32 peak: the FLOPs that
the traced window's answers need (the frozen ``counts.vfs_flops``: the VAD
CNN on the speech frames, ResNet101 on every retained window, the MLP on
every retained x-vector) over the window at 67 TFLOP/s."""


def read(ctx):
    c = ctx["counts"]
    m = ctx["config"]["models"]
    flops = sum(c.vfs_flops(i["answer"], i["n"], m)
                for i in ctx["instances"])
    return c.share(flops / c.FP32_FLOPS_PER_S, ctx["window_s"])
