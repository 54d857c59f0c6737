"""Card timings of the general-K Viterbi kernel on ``chip_smoke.py`` phase
6(d)'s decodes, part by part.

    python tools/torch_viterbi_parts.py [--reps 5]

The inputs are ``chip_smoke.general_viterbi_inputs`` at T = 180,000: the
K = 30 ``consecutive=10`` expansion (never converges), the K = 8
constrained decode and a random dense K = 30 decode.

Prints one JSON line (prefixed ``PARTS``): per decode, the kernel's mean ms
over ``--reps`` launches (CUDA events, after a warm-up; below about 0.2 ms
they include the host's launch gaps), its passes, walked chunks and chunks,
and the device clock's ms from the launch's start to the end of each part
(the passes, the walk, the maps, the summaries, their chain); the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as smoke
    from inaspeechsegmenter_tpu_torch.decode import viterbi as tv

    if not torch.cuda.is_available():
        print("torch_viterbi_parts: no CUDA device visible", file=sys.stderr)
        return 1
    _, inputs = smoke.general_viterbi_inputs(smoke.VITERBI_T)
    dev = torch.device("cuda", 0)
    out = {}
    for name, arrays in inputs.items():
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        ms = smoke.cuda_ms(lambda: tv.viterbi_scan_general(*t), args.reps,
                           torch)
        ctl = tv.viterbi_scan_general.last_ctl
        out[name] = {"ms": ms, "passes": int(ctl[3]),
                     "walked_chunks": int(ctl[4]), "chunks": int(ctl[5]),
                     "parts_ms": smoke.general_parts_ms(ctl)}
    print("PARTS " + json.dumps({"card": smoke.gpu_line(), "decodes": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
