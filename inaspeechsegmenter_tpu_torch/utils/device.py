"""The port's one device policy: an explicit device, ``cuda`` by default."""

from __future__ import annotations

import torch


def resolve_device(device):
    """A torch.device; ``cuda`` without a visible CUDA device raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is visible; pass "
            "device='cpu' explicitly to run the plain PyTorch path")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
