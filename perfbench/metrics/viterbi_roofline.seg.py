"""The K <= 3 Viterbi kernel's share of its roofline: the frozen
``viterbi_work`` bound of every decode of the traced window's files (the
energy decode on the 10 ms frames, the VAD decode and, with gender, the
gender decode on the 20 ms frames) over the device time of
``viterbi_kernel``."""


def read(ctx):
    c = ctx["counts"]
    from perfbench.trace import kernel_seconds

    _, took = kernel_seconds(ctx["trace"], "viterbi_kernel")
    st = ctx["config"]["stages"]
    need = 0.0
    for i in ctx["instances"]:
        t = (i["n"] - 400) // 160 + 1
        n20 = (t + 1) // 2
        need += c.bound_s(*c.viterbi_work(t, 2))
        need += c.bound_s(*c.viterbi_work(n20, st["vad"]["n_out"]))
        if "gender" in st:
            need += c.bound_s(*c.viterbi_work(n20, st["gender"]["n_out"]))
    return c.share(need, took)
