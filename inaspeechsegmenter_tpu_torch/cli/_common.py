"""Shared CLI helpers for the segmentation and VFS commands."""

from __future__ import annotations


def resolve_ffmpeg(name):
    """The reference's 'none' convention: returns None (WAV-only mode) with
    the reference's notice printed, else the binary name unchanged."""
    if name.lower() == 'none' or name == '':
        print('Disabling ffmpeg. Make sure your audio files are already '
              'sampled at 16kHz.')
        return None
    return name


def parallel_mesh(device):
    """The ``--parallel`` mesh: every visible CUDA device for a CUDA
    ``--device`` (none visible raises), the one CPU slot for ``cpu``."""
    import torch

    from ..parallel.mesh import make_mesh

    if torch.device(device).type == 'cpu':
        return make_mesh(devices=[device])
    return make_mesh()
