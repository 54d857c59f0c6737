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


def upload(arr, device):
    """A host numpy array as a tensor on ``device``.  On CUDA the copy goes
    through pinned memory and does not wait for the device's queue: a
    pageable copy synchronizes the stream, which would make the host wait
    for every kernel queued before it."""
    x = torch.from_numpy(arr)
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def start_host_copy(t):
    """Start copying ``t`` to the host -> ``(host tensor, event | None)``.
    On CUDA the copy lands in pinned memory behind the work queued on the
    current stream, with an event recorded after it; read it with
    :func:`read_host_copy`.  On the CPU: ``(t, None)``."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host, event


def read_host_copy(copy):
    """The numpy value of a :func:`start_host_copy`, once its event has
    passed (a wait on that copy alone, not on the device)."""
    host, event = copy
    if event is not None:
        event.synchronize()
    return host.numpy()
