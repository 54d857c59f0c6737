"""CLI: speech/music(/noise) + gender segmentation to csv/TextGrid.

Flag-compatible with the JAX package's ``cli/segment.py`` (reference
scripts/ina_speech_segmenter.py:45-84) — -i input globs, -o output dir,
-s batch size, -d vad engine, -g detect gender, -b ffmpeg binary, -e
export format, -r energy ratio — plus ``--device`` (default cuda; the run
fails rather than falling back to the CPU).  Only ``-b none`` (16 kHz WAV
input, the default here) is ported; ``--parallel`` and ``--follow`` are
not offered yet.

    python -m inaspeechsegmenter_tpu_torch.cli.segment -i in.wav -o outdir \\
        -b none --device cuda
"""

from __future__ import annotations

import argparse
import glob
import os
import warnings

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
    parser.add_argument('-b', '--ffmpeg_binary', default='none',
                        help="ffmpeg binary; only 'none' (16 kHz WAV input) "
                             "is ported.")
    parser.add_argument('-e', '--export_format', choices=['csv', 'textgrid'],
                        default='csv')
    parser.add_argument('-r', '--energy_ratio', default=0.03, type=float)
    parser.add_argument('--device', default='cuda',
                        help="Torch device, 'cuda' (default) or 'cpu'.")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    ffmpeg = args.ffmpeg_binary
    if ffmpeg.lower() == 'none' or ffmpeg == '':
        print('Disabling ffmpeg. Make sure your audio files are already '
              'sampled at 16kHz.')
        ffmpeg = None
    input_files = []
    for e in args.input:
        input_files += [e] if e.startswith('http') else glob.glob(e)
    if not input_files:
        parser.error('No existing media selected for analysis! Bad values '
                     'provided to -i (%s)' % args.input)
    odir = args.output_directory.strip(' \t\n\r').rstrip('/')
    if not os.access(odir, os.W_OK):
        parser.error('Directory %s is not writable!' % odir)

    from inaspeechsegmenter_tpu_torch import Segmenter

    seg = Segmenter(vad_engine=args.vad_engine,
                    detect_gender=args.detect_gender.lower() == 'true',
                    ffmpeg=ffmpeg, energy_ratio=args.energy_ratio,
                    batch_size=args.batch_size, device=args.device)
    output_files = [
        os.path.join(odir, os.path.splitext(os.path.basename(e))[0] + '.'
                     + args.export_format) for e in input_files]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return seg.batch_process(input_files, output_files, verbose=True,
                                 output_format=args.export_format)


if __name__ == '__main__':
    main()
