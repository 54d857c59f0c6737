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


def exit_status(result):
    """A batch's ``(total_s, n_ok, avg_s, lmsg)`` -> the process exit
    status: 1 when a file's status is an error (2), else 0 (a skipped
    file, 1, is no failure).  The console scripts ``sys.exit`` what
    ``main`` returns."""
    return 1 if any(m[1] == 2 for m in result[3]) else 0


def parallel_mesh(device):
    """The ``--parallel`` mesh: every visible CUDA device for a CUDA
    ``--device`` (none visible raises), the one CPU slot for ``cpu``."""
    import torch

    from ..parallel.mesh import make_mesh

    if torch.device(device).type == 'cpu':
        return make_mesh(devices=[device])
    return make_mesh()
