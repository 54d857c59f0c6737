"""The whole segmentation step's share of the card's float32 peak: the
FLOPs of the patches that the traced window's answers need (the VAD CNN
on every frame that is not labelled noEnergy, the gender CNN on every
frame labelled female or male; ``counts.cnn_flops``, priced by the frozen
``patch_cnn_flops``) over the window at 67 TFLOP/s."""


def read(ctx):
    return ctx["counts"].cnn_mfu(ctx)
