"""Shared CLI helpers and bootstrap for the port's commands: the
counterpart of ``inaspeechsegmenter_tpu/cli/_common.py``.

``expand_inputs`` and ``check_outdir`` raise ``ValueError`` with the JAX
helpers' messages where those assert (an assert is stripped under
``python -O``); the CLIs turn it into ``parser.error``, exit status 2.
"""

from __future__ import annotations

import glob
import os


def resolve_ffmpeg(name):
    """The reference's 'none' convention: returns None (WAV-only mode) with
    the reference's notice printed, else the binary name unchanged."""
    if name.lower() == 'none' or name == '':
        print('Disabling ffmpeg. Make sure your audio files are already '
              'sampled at 16kHz.')
        return None
    return name


def expand_inputs(patterns, allow_urls=False):
    """Glob expansion keeping http urls verbatim when allowed (reference
    scripts/ina_speech_segmenter.py:62-68) -> the files; none raises
    ``ValueError``."""
    files = []
    for e in patterns:
        if allow_urls and e.startswith('http'):
            files.append(e)
        else:
            files += glob.glob(e)
    if not files:
        raise ValueError('No existing media selected for analysis! Bad '
                         'values provided to -i (%s)' % patterns)
    return files


def check_outdir(output_directory):
    """The output directory stripped of blanks and a trailing '/'; one
    that is not writable raises ``ValueError``."""
    odir = output_directory.strip(' \t\n\r').rstrip('/')
    if not os.access(odir, os.W_OK):
        raise ValueError('Directory %s is not writable!' % odir)
    return odir


def output_paths(input_files, odir, ext):
    return [os.path.join(odir,
                         os.path.splitext(os.path.basename(e))[0] + '.' + ext)
            for e in input_files]


def bootstrap_runtime():
    """Make the kernel cache's directory (``utils.cache``) before any
    model is built -> its path.  The JAX function also pins the JAX
    platform; the port's device is each CLI's ``--device``."""
    from ..utils.cache import enable_kernel_cache

    return enable_kernel_cache()


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
