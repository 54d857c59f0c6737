"""CLI: score segmentation outputs against reference annotations.

The JAX package's ``cli/evaluate.py`` on the port's numpy-only scorer
(``inaspeechsegmenter_tpu_torch.eval``), with the same flags, table and
JSON output.  It compares hypothesis csvs (as written by
``cli.segment`` / `Segmenter.batch_process`) to reference csvs of the
same basename and prints per-file and duration-weighted corpus metrics:
frame accuracy / frame diff, per-label precision/recall/F1, VAD
miss/false-alarm/DCF, and boundary precision/recall.  It runs on the host
alone and takes no device.

    python -m inaspeechsegmenter_tpu_torch.cli.evaluate -r refdir -y hypdir
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

description = (
    "Evaluate segmentation csvs against reference csvs: frame accuracy, "
    "per-label precision/recall/F1, speech-activity miss/false-alarm/DCF, "
    "and boundary detection quality. Files are matched by basename; "
    "metrics are duration-weighted across the corpus.")


def build_parser():
    p = argparse.ArgumentParser(description=description)
    p.add_argument('-r', '--reference', nargs='+', required=True,
                   help='Reference csv(s): paths, glob patterns, or a '
                        'directory (all *.csv inside).')
    p.add_argument('-y', '--hypothesis', nargs='+', required=True,
                   help='Hypothesis csv(s): same forms; matched to '
                        'references by basename.')
    p.add_argument('--collar', type=float, default=0.0,
                   help='Seconds around each reference boundary excluded '
                        'from frame scoring (NIST-style; default 0).')
    p.add_argument('--frame-dur', type=float, default=0.02,
                   help='Scoring frame duration in seconds (default 0.02, '
                        'the pipeline output resolution).')
    p.add_argument('--boundary-tolerance', type=float, default=0.1,
                   help='Max |offset| in seconds for a hypothesis boundary '
                        'to match a reference boundary (default 0.1).')
    p.add_argument('--speech-labels', default='speech,male,female',
                   help='Comma-separated labels counted as speech for VAD '
                        'scoring (default: speech,male,female).')
    p.add_argument('--json', action='store_true',
                   help='Print one JSON document instead of tables.')
    return p


def _expand(patterns, side, parser):
    """Expand paths/globs/directories; a pattern matching nothing is a
    user error diagnosed up front (not a traceback later)."""
    files = []
    for e in patterns:
        if os.path.isdir(e):
            hits = sorted(glob.glob(os.path.join(e, '*.csv')))
            if not hits:
                parser.error(f'{side} directory {e!r} contains no *.csv')
        elif os.path.exists(e):
            hits = [e]
        else:
            hits = sorted(glob.glob(e))
            if not hits:
                parser.error(f'{side} pattern {e!r} matched no files')
        files += hits
    return files


def _pair(refs, hyps, parser):
    """Match hypothesis files to reference files by basename.

    Duplicate basenames on either side are an error: the per-file report
    is keyed by basename (silent last-wins) while corpus totals would
    accumulate every duplicate — the two views would disagree."""
    for side, files in (('reference', refs), ('hypothesis', hyps)):
        seen = {}
        for f in files:
            b = os.path.basename(f)
            if b in seen and seen[b] != f:
                parser.error(f'duplicate {side} basename {b!r}: '
                             f'{seen[b]!r} and {f!r} — matching is by '
                             'basename, rename or narrow the patterns')
            seen[b] = f
    by_base = {os.path.basename(h): h for h in hyps}
    pairs, missing = [], []
    for r in refs:
        b = os.path.basename(r)
        if b in by_base:
            pairs.append((b, r, by_base[b]))
        else:
            missing.append(b)
    if not pairs:
        parser.error('no reference/hypothesis basenames in common '
                     f'(references: {[os.path.basename(r) for r in refs]}, '
                     f'hypotheses: {sorted(by_base)})')
    return pairs, missing


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    from inaspeechsegmenter_tpu_torch import eval as ev

    refs = _expand(args.reference, 'reference', parser)
    hyps = _expand(args.hypothesis, 'hypothesis', parser)
    pairs, missing = _pair(refs, hyps, parser)
    speech = frozenset(x.strip() for x in args.speech_labels.split(',')
                       if x.strip())

    per_file, confusions, vad_acc, bnd_acc = {}, [], [0.0] * 4, [0, 0, 0]
    for base, r, h in pairs:
        rep = ev.evaluate(r, h, frame_dur=args.frame_dur, collar=args.collar,
                          speech_labels=speech,
                          boundary_tolerance=args.boundary_tolerance,
                          include_confusion=True)
        confusions.append(rep.pop('confusion'))
        per_file[base] = rep
        v = rep['vad']
        vad_acc[0] += v['miss_rate'] * v['speech_ref_duration']
        vad_acc[1] += v['speech_ref_duration']
        vad_acc[2] += v['fa_rate'] * v['nonspeech_ref_duration']
        vad_acc[3] += v['nonspeech_ref_duration']
        b = rep['boundaries']
        bnd_acc[0] += b['matched']
        bnd_acc[1] += b['n_ref']
        bnd_acc[2] += b['n_hyp']

    corpus = ev.merge_confusions(confusions)
    miss = vad_acc[0] / vad_acc[1] if vad_acc[1] else 0.0
    fa = vad_acc[2] / vad_acc[3] if vad_acc[3] else 0.0
    b_rec = bnd_acc[0] / bnd_acc[1] if bnd_acc[1] else 1.0
    b_prec = bnd_acc[0] / bnd_acc[2] if bnd_acc[2] else 1.0
    corpus['frame_diff'] = round(1.0 - corpus['accuracy'], 6)
    corpus['vad'] = {'miss_rate': round(miss, 6), 'fa_rate': round(fa, 6),
                     'dcf': round(0.75 * miss + 0.25 * fa, 6)}
    corpus['boundaries'] = {
        'precision': round(b_prec, 6), 'recall': round(b_rec, 6),
        'f1': round(2 * b_prec * b_rec / (b_prec + b_rec), 6)
        if b_prec + b_rec else 0.0,
        'matched': bnd_acc[0], 'n_ref': bnd_acc[1], 'n_hyp': bnd_acc[2]}
    doc = {'files': per_file, 'corpus': corpus,
           'unmatched_references': missing}

    try:
        _render(args, doc, per_file, pairs, corpus, missing)
        # force the pipe write INSIDE the handler: small outputs fit the
        # stdio buffer, so without this the BrokenPipeError would fire at
        # interpreter-shutdown flush instead ("Exception ignored" noise +
        # exit 120 instead of the clean 0 this handler promises)
        sys.stdout.flush()
    except BrokenPipeError:      # e.g. `... --json | head`, any entry point
        try:
            sys.stdout.close()
        except OSError:
            pass
    return 0


def _render(args, doc, per_file, pairs, corpus, missing):
    if args.json:
        print(json.dumps(doc, indent=1))
    else:
        for base, rep in per_file.items():
            v, b = rep['vad'], rep['boundaries']
            print(f"{base}: acc {rep['accuracy']:.4f} "
                  f"(frame diff {rep['frame_diff']:.4%}) | VAD miss "
                  f"{v['miss_rate']:.4f} fa {v['fa_rate']:.4f} "
                  f"dcf {v['dcf']:.4f} | boundaries P {b['precision']:.3f} "
                  f"R {b['recall']:.3f}")
        print(f"\ncorpus ({len(pairs)} file(s), "
              f"{corpus['scored_duration']:.1f} s scored"
              + (f", collar {args.collar}s" if args.collar else "") + ")")
        print(f"  frame accuracy {corpus['accuracy']:.4f} "
              f"(diff {corpus['frame_diff']:.4%})")
        print("  label         precision  recall     f1         ref_s")
        for lab, m in corpus['labels'].items():
            print(f"  {lab or '(none)':<13} {m['precision']:<10.4f} "
                  f"{m['recall']:<10.4f} {m['f1']:<10.4f} "
                  f"{m['ref_duration']:.1f}")
        cv, cb = corpus['vad'], corpus['boundaries']
        print(f"  VAD miss {cv['miss_rate']:.4f}  fa {cv['fa_rate']:.4f}  "
              f"dcf {cv['dcf']:.4f}")
        print(f"  boundaries P {cb['precision']:.3f} R {cb['recall']:.3f} "
              f"F1 {cb['f1']:.3f} ({cb['matched']}/{cb['n_ref']} matched, "
              f"tolerance {args.boundary_tolerance}s)")
        if missing:
            print(f"  WARNING: {len(missing)} reference file(s) had no "
                  f"hypothesis: {missing}", file=sys.stderr)


if __name__ == '__main__':
    sys.exit(main())
