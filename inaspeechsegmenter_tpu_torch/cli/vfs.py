"""CLI: voice femininity scoring to csv, on the PyTorch port.

Flag-compatible with the JAX package's ``cli/vfs.py`` for the flags this
port supports — -i input globs, -o output dir, -c model criteria, -b ffmpeg
binary, --skipifexist, --nbtry, --follow / --follow_idle — plus
``--device`` (default cuda; the run fails rather than falling back to the
CPU).  ``-b`` defaults to ``ffmpeg``; ``-b none`` takes 16 kHz WAV input
only.  ``--parallel`` splits each file's x-vector window batches over every
visible CUDA device (one visible: the one-device path, with a notice).
Writes one
tab-separated csv per input with columns ``score / speech_duration /
nb_vectors``; model weights are resolved by ``models.registry``.

    python -m inaspeechsegmenter_tpu_torch.cli.vfs -i in.mp3 -o outdir \\
        -c bgc --device cuda
    python -m inaspeechsegmenter_tpu_torch.cli.vfs -i growing.wav -o outdir \\
        --follow --follow_idle 10
"""

from __future__ import annotations

import argparse
import glob
import os
import warnings

from ._common import parallel_mesh, resolve_ffmpeg

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
    parser.add_argument('-b', '--ffmpeg_binary', default='ffmpeg',
                        help="Your custom binary of ffmpeg. Set it to 'none' "
                             "to read 16 kHz WAV files without ffmpeg.")
    parser.add_argument('--skipifexist', action='store_true',
                        help='Skip inputs whose output csv already exists.')
    parser.add_argument('--nbtry', type=int, default=1,
                        help='Attempts per file before reporting an error.')
    parser.add_argument('--device', default='cuda',
                        help="Torch device, 'cuda' (default) or 'cpu'.")
    parser.add_argument('--parallel', action='store_true',
                        help="Shard each file's x-vector window batches "
                             'across all local GPUs; scores are those of '
                             'the one-device path.')
    parser.add_argument('--follow', action='store_true',
                        help='Tail ONE growing PCM16 mono 16 kHz WAV file '
                             '(a recording in progress): print provisional '
                             'scores, write the csv when it stops growing.')
    parser.add_argument('--follow_idle', type=float, default=10.0,
                        help='Seconds without file growth before --follow '
                             'finalizes.')
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    ffmpeg = resolve_ffmpeg(args.ffmpeg_binary)
    if args.follow:
        if len(args.input) != 1:
            parser.error('--follow takes exactly one input file')
        if args.skipifexist:
            parser.error('--skipifexist does not combine with --follow '
                         '(a live tail always writes its csv at finalize)')
        # the followed recording may not exist YET: no glob expansion
        input_files = list(args.input)
    else:
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

    mesh = None
    if args.parallel:
        mesh = parallel_mesh(args.device)
        if mesh.devices.size == 1:
            print('[vfs] --parallel: one local device, '
                  'running single-device', flush=True)
            mesh = None
    scorer = vfs.VoiceFemininityScoring(
        gd_model_criteria=args.gd_model_criteria, ffmpeg=ffmpeg, mesh=mesh,
        device=args.device)
    output_files = [
        os.path.join(odir, os.path.splitext(os.path.basename(e))[0] + '.csv')
        for e in input_files]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        if args.follow:
            return _follow(scorer, input_files[0], output_files[0], args)
        return scorer.batch_score(input_files, output_files, verbose=True,
                                  skipifexist=args.skipifexist,
                                  nbtry=args.nbtry)


def _follow(scorer, path, dst, args):
    """Tail ``path`` and write its final score csv to ``dst`` -> result."""
    from inaspeechsegmenter_tpu_torch.online import follow_wav_vfs
    from inaspeechsegmenter_tpu_torch.vfs import score_to_csv

    def report(o):
        fed = o.seconds_fed
        if o.vad_online.chunks_ready < 2:
            # current() on a sub-group prefix would re-run the offline VAD
            # over the whole buffer on every tick
            print(f'[follow] {fed:.0f}s fed (buffering first chunks)',
                  flush=True)
            return
        score, dur, n = o.current()
        print(f'[follow] {fed:.0f}s fed, provisional score='
              f'{"-" if score is None else f"{score:.3f}"} '
              f'(speech {dur:.1f}s, {n} windows)', flush=True)

    result = follow_wav_vfs(path, scorer, idle_timeout=args.follow_idle,
                            on_update=report)
    score_to_csv(result, dst)
    print(f'[follow] finalized -> {dst}', flush=True)
    return result


if __name__ == '__main__':
    main()
