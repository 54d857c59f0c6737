"""CLI: voice femininity scoring to csv, on the PyTorch port.

Flag-compatible with the JAX package's ``cli/vfs.py`` for the flags this
port supports — -i input globs, -o output dir, -c model criteria, -b ffmpeg
binary, --skipifexist, --nbtry — plus ``--device`` (default cuda; the run
fails rather than falling back to the CPU).  ``-b`` accepts only ``none``
(16 kHz WAV input, the default here); ``--parallel`` and ``--follow`` are not
offered yet.  Writes one tab-separated csv per input with columns
``score / speech_duration / nb_vectors``; model weights come from
``$ISS_TPU_MODEL_DIR``.

    python -m inaspeechsegmenter_tpu_torch.cli.vfs -i in.wav -o outdir \\
        -c bgc -b none --device cuda
"""

from __future__ import annotations

import argparse
import glob
import os
import warnings

description = (
    "Score voice femininity of media files: x-vector speaker embeddings "
    "(ResNet101) over detected speech, scored by the interspeech2023 MLP. "
    "Writes one tab-separated csv per input (score, speech_duration, "
    "nb_vectors; score is empty when no speech is detected). PyTorch/CUDA "
    "engine with the inaSpeechSegmenter command-line conventions."
)


def build_parser():
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('-i', '--input', nargs='+', required=True,
                        help='Input media to analyse: full path(s) or glob '
                             'pattern(s).')
    parser.add_argument('-o', '--output_directory', required=True,
                        help='Directory used to store score csvs (same base '
                             'name as input, csv extension).')
    parser.add_argument('-c', '--gd_model_criteria', default='bgc',
                        choices=['bgc', 'vfp'],
                        help='Gender-detection model criteria: bgc = '
                             'interspeech2023_all (VAD overlap 0.7), vfp = '
                             'interspeech2023_cvfr (0.62).')
    parser.add_argument('-b', '--ffmpeg_binary', default='none',
                        help="ffmpeg binary; only 'none' (16 kHz WAV input) "
                             "is ported.")
    parser.add_argument('--skipifexist', action='store_true',
                        help='Skip inputs whose output csv already exists.')
    parser.add_argument('--nbtry', type=int, default=1,
                        help='Attempts per file before reporting an error.')
    parser.add_argument('--device', default='cuda',
                        help="Torch device, 'cuda' (default) or 'cpu'.")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.ffmpeg_binary.lower() not in ('none', ''):
        parser.error("only -b none (16 kHz WAV input) is ported")
    input_files = []
    for e in args.input:
        input_files += glob.glob(e)
    if not input_files:
        parser.error('No existing media selected for analysis! Bad values '
                     'provided to -i (%s)' % args.input)
    odir = args.output_directory.strip(' \t\n\r').rstrip('/')
    if not os.access(odir, os.W_OK):
        parser.error('Directory %s is not writable!' % odir)

    from inaspeechsegmenter_tpu_torch import vfs

    scorer = vfs.VoiceFemininityScoring(
        gd_model_criteria=args.gd_model_criteria, ffmpeg=None,
        device=args.device)
    output_files = [
        os.path.join(odir, os.path.splitext(os.path.basename(e))[0] + '.csv')
        for e in input_files]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return scorer.batch_score(input_files, output_files, verbose=True,
                                  skipifexist=args.skipifexist,
                                  nbtry=args.nbtry)


if __name__ == '__main__':
    main()
