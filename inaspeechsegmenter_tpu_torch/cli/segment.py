"""CLI: speech/music(/noise) + gender segmentation to csv/TextGrid.

Flag-compatible with the JAX package's ``cli/segment.py`` (reference
scripts/ina_speech_segmenter.py:45-84) — -i input globs, -o output dir,
-s batch size, -d vad engine, -g detect gender, -b ffmpeg binary, -e
export format, -r energy ratio, --follow / --follow_idle — plus
``--device`` (default cuda; the run fails rather than falling back to the
CPU).  ``-b`` defaults to ``ffmpeg``; ``-b none`` takes 16 kHz WAV input
only.  ``--parallel`` runs ``parallel.ParallelEngine(seg).batch_process``
over every visible CUDA device (with ``--device cpu``, one CPU slot).
With ``$ISS_TRACE_DIR`` set, the run is profiled (``utils.timing.
torch_trace``: host activity and the CUDA device's) into
``$ISS_TRACE_DIR/trace.json``, as the JAX CLI traces into it.

    python -m inaspeechsegmenter_tpu_torch.cli.segment -i in.mp3 -o outdir \\
        --device cuda
    python -m inaspeechsegmenter_tpu_torch.cli.segment -i growing.wav \\
        -o outdir --follow --follow_idle 10
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import warnings

from ._common import (bootstrap_runtime, check_outdir, exit_status,
                      expand_inputs, output_paths, parallel_mesh,
                      resolve_ffmpeg)

description = (
    "Segment media files into speech/music(/noise) regions, optionally "
    "splitting speech by speaker gender, and write one CSV (or TextGrid) "
    "timeline per input. PyTorch/CUDA engine with the inaSpeechSegmenter "
    "command-line surface."
)


def build_parser():
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('-i', '--input', nargs='+', required=True,
                        help='Input media to analyse: full path(s), glob '
                             'pattern(s), or http urls.')
    parser.add_argument('-o', '--output_directory', required=True,
                        help='Directory used to store segmentations (same '
                             'base name as input, csv/TextGrid extension).')
    parser.add_argument('-s', '--batch_size', type=int, default=32,
                        help='API-parity batch size hint.')
    parser.add_argument('-d', '--vad_engine', choices=['sm', 'smn'],
                        default='smn')
    parser.add_argument('-g', '--detect_gender', choices=['true', 'false'],
                        default='true')
    parser.add_argument('-b', '--ffmpeg_binary', default='ffmpeg',
                        help="Your custom binary of ffmpeg. Set it to 'none' "
                             "to read 16 kHz WAV files without ffmpeg.")
    parser.add_argument('-e', '--export_format', choices=['csv', 'textgrid'],
                        default='csv')
    parser.add_argument('-r', '--energy_ratio', default=0.03, type=float)
    parser.add_argument('--device', default='cuda',
                        help="Torch device, 'cuda' (default) or 'cpu'.")
    parser.add_argument('--parallel', action='store_true',
                        help='Spread files over all local GPUs (a lone '
                             "file: its timeline).")
    parser.add_argument('--follow', action='store_true',
                        help='Tail ONE growing PCM16 mono 16 kHz WAV file '
                             '(a recording in progress): segment appended '
                             'audio incrementally, finalize + export when '
                             'the file stops growing.')
    parser.add_argument('--follow_idle', type=float, default=10.0,
                        help='Seconds without file growth before --follow '
                             'finalizes.')
    return parser


def main(argv=None):
    """Run the command line ``argv`` (default ``sys.argv[1:]``) -> the
    exit status: 0, or 1 when a file failed."""
    parser = build_parser()
    args = parser.parse_args(argv)
    ffmpeg = resolve_ffmpeg(args.ffmpeg_binary)
    if args.follow:
        if len(args.input) != 1:
            parser.error('--follow takes exactly one input file')
        # the followed recording may not exist YET (a recorder about to
        # start writing): no glob expansion
        input_files = list(args.input)
    try:
        if not args.follow:
            input_files = expand_inputs(args.input, allow_urls=True)
        odir = check_outdir(args.output_directory)
    except ValueError as e:
        parser.error(str(e))
    bootstrap_runtime()

    from inaspeechsegmenter_tpu_torch import Segmenter

    seg = Segmenter(vad_engine=args.vad_engine,
                    detect_gender=args.detect_gender.lower() == 'true',
                    ffmpeg=ffmpeg, energy_ratio=args.energy_ratio,
                    batch_size=args.batch_size, device=args.device)
    output_files = output_paths(input_files, odir, args.export_format)
    trace_dir = os.environ.get('ISS_TRACE_DIR')
    if trace_dir:
        from inaspeechsegmenter_tpu_torch.utils.timing import torch_trace

        trace_cm = torch_trace(trace_dir)
    else:
        trace_cm = contextlib.nullcontext()
    with warnings.catch_warnings(), trace_cm:
        warnings.simplefilter('ignore')
        if args.follow:
            _follow(seg, input_files[0], output_files[0], args)
            return 0
        if args.parallel:
            from inaspeechsegmenter_tpu_torch.parallel import ParallelEngine

            seg = ParallelEngine(seg, parallel_mesh(args.device))
        return exit_status(seg.batch_process(
            input_files, output_files, verbose=True,
            output_format=args.export_format))


def _follow(seg, path, dst, args):
    """Tail ``path`` and export its final labels to ``dst`` -> lseg."""
    from inaspeechsegmenter_tpu_torch.export import seg2csv, seg2textgrid
    from inaspeechsegmenter_tpu_torch.online import follow_wav

    def report(o):
        if o.chunks_ready >= 2:
            # the provisional decode reuses cached emissions; before two
            # chunks exist current() would re-segment the whole buffered
            # prefix on every tick, so print cheap progress instead
            print(f'[follow] {o.seconds_fed:.0f}s fed, '
                  f'{len(o.current())} provisional segments', flush=True)
        else:
            print(f'[follow] {o.seconds_fed:.0f}s fed '
                  '(buffering first chunks)', flush=True)

    lseg = follow_wav(path, seg, idle_timeout=args.follow_idle,
                      on_update=report)
    {'csv': seg2csv, 'textgrid': seg2textgrid}[args.export_format](lseg, dst)
    print(f'[follow] finalized {len(lseg)} segments -> {dst}', flush=True)
    return lseg


if __name__ == '__main__':
    sys.exit(main())
