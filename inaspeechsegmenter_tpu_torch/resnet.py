"""The reference's import path ``inaSpeechSegmenter.resnet``
(resnet.py:78-135): the x-vector network's constructor name."""

from .models.resnet import ResNet101XVector, ResNetXVector

__all__ = ["ResNet101", "ResNetXVector"]


def ResNet101(feat_dim=64, embed_dim=256, squeeze_excitation=False):
    """The VBx ResNet101 x-vector network (bottleneck blocks (3, 4, 23,
    3), m_channels 32, mean and std statistics pooling), a PyTorch
    module."""
    if squeeze_excitation:
        raise NotImplementedError(
            "squeeze_excitation is not part of the released VBx model")
    return ResNet101XVector(feat_dim, embed_dim)
