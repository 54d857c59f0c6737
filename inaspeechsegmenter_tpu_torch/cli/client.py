"""CLI: job-lease worker of the port's job farm (the JAX package's
``cli/client.py``): it pulls leases from a server and segments (or, with
``--vfs``, scores) each leased file on ``--device`` (default cuda; the run
fails rather than falling back to the CPU).  One worker per GPU is the
farm's multi-GPU scheme; with ``--parallel`` one worker takes every visible
GPU: a ``ParallelEngine`` over them, or with ``--vfs`` the x-vector
batches split over them.

    python -m inaspeechsegmenter_tpu_torch.cli.client tcp://host:4040 \\
        --ffmpeg_binary none --device cuda
"""

from __future__ import annotations

import argparse
import sys

from ._common import bootstrap_runtime, parallel_mesh, resolve_ffmpeg


def main(argv=None):
    """Work leases until the server's queue is empty -> exit status 0."""
    parser = argparse.ArgumentParser(
        description='Start a segmentation worker that pulls job leases.')
    parser.add_argument('uri', type=str,
                        help='Server uri, e.g. tcp://host:4040')
    parser.add_argument('--batch_size', type=int, default=1024)
    parser.add_argument('--ffmpeg_binary', default='ffmpeg', type=str)
    parser.add_argument('--parallel', action='store_true',
                        help='Shard leased files across local GPUs.')
    parser.add_argument('--vfs', action='store_true',
                        help='Run voice-femininity-scoring jobs instead of '
                             'segmentation (one score csv per input).')
    parser.add_argument('--gd_model_criteria', default='bgc',
                        choices=['bgc', 'vfp'],
                        help='VFS gender-detection model criteria.')
    parser.add_argument('--lease_timeout', type=float, default=30.0,
                        help='Seconds per job-server socket op before the '
                             'worker retries and then exits cleanly.')
    parser.add_argument('--lease_reconnect', type=int, default=2,
                        help='Fresh-connection retries per lease call.')
    parser.add_argument('--device', default='cuda',
                        help="Torch device, 'cuda' (default) or 'cpu'.")
    args = parser.parse_args(argv)
    ffmpeg = resolve_ffmpeg(args.ffmpeg_binary)
    # a restarted worker finds the kernels it built before
    bootstrap_runtime()

    from inaspeechsegmenter_tpu_torch.parallel import client_work_loop

    if args.vfs:
        from inaspeechsegmenter_tpu_torch import VoiceFemininityScoring

        worker = VoiceFemininityScoring(
            gd_model_criteria=args.gd_model_criteria, ffmpeg=ffmpeg,
            mesh=parallel_mesh(args.device) if args.parallel else None,
            device=args.device)
    else:
        from inaspeechsegmenter_tpu_torch import Segmenter

        worker = Segmenter(batch_size=args.batch_size, ffmpeg=ffmpeg,
                           device=args.device)
        if args.parallel:
            from inaspeechsegmenter_tpu_torch.parallel import ParallelEngine

            worker = ParallelEngine(worker, parallel_mesh(args.device))
    client_work_loop(args.uri, worker, timeout=args.lease_timeout,
                     reconnect=args.lease_reconnect)
    return 0


if __name__ == '__main__':
    sys.exit(main())
