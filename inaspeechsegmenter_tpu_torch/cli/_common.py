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
