"""Device and call times of one tree's upload-codec decoders, on the card.

    python tools/torch_codec_ab.py --root DIR [--tag NAME]

Imports ``inaspeechsegmenter_tpu_torch`` from ``DIR`` (this checkout, or an
unpacked ``git archive`` of another commit) and builds its kernels there,
so that two trees' decoders can be compared on one card: run parent,
change, change, parent, each in its own process.  The timing helpers and
the inputs are this checkout's ``chip_smoke.py`` (``codec_timing_cases``,
``time_codec_case``): the 3-chunk upload group (6,145 blocks) and the
whole-file VBx slices of the seeded 10 min and 1 h mixes, each decoder on
each.  A decoder's device time sums the kernels of either design that
``DESIGN_NAMES`` lists (the one-launch kernels, and the earlier design's
rank or scan kernel plus its decode or copy kernel).

Prints one JSON line (prefixed ``AB``): the tree, the card's name and power
limit, the no-op kernel floor, and for each size and decoder the blocks,
the packed bytes, ``device_ms`` (``chip_smoke.device_ms`` over distinct
buffers that together exceed the L2 twice over), ``call_ms`` (CUDA events
over back-to-back wrapper calls on one buffer), the bound and the share of
it.  Where the tree's ``csrc/codec.cu`` has the ``ISS_CODEC_SWEEP_ONLY``
switch, the bit decoder's rows add ``sweep_only_ms``, the device time of
a copy built with it (every CTA stops after its width sweep and offsets),
what the redundant sweep costs a launch (the sweep is the launch's
prologue: nothing overlaps it).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DESIGN_NAMES = {
    "bits": ("unpack_bits_kernel", "bits_rank_kernel",
             "bits_decode_kernel"),
    "elide": ("unpack_zero_elide_kernel", "elide_scan_kernel",
              "elide_copy_kernel"),
}


def load_smoke():
    """``chip_smoke.py`` of this checkout, loaded by path, so that this
    checkout's package stays off ``sys.path``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_codec", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep_only(root):
    """The tree's ``csrc/codec.cu`` built with ``ISS_CODEC_SWEEP_ONLY``
    (every CTA stops after its width sweep and its offsets: no tile is
    ranked or decoded) into a library of its own -> its
    ``iss_unpack_bits``, or None where the source has no such switch."""
    import ctypes
    import subprocess

    from inaspeechsegmenter_tpu_torch.utils import cuda_build

    src = os.path.join(root, "inaspeechsegmenter_tpu_torch", "csrc",
                       "codec.cu")
    with open(src) as fh:
        if "ISS_CODEC_SWEEP_ONLY" not in fh.read():
            return None
    os.makedirs(cuda_build.build_dir(), exist_ok=True)
    lib = os.path.join(cuda_build.build_dir(), "libcodec_sweep_only.so")
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                    "-DISS_CODEC_SWEEP_ONLY", "-shared", "-o", lib, src],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).iss_unpack_bits
    fn.argtypes = cuda_build._SIGNATURES["iss_unpack_bits"]
    fn.restype = ctypes.c_int
    return fn


def time_sweep_only(torch, smoke, fn, buf, nb, dev):
    """``device_ms`` of the bit decoder's sweep alone, over distinct copies
    as ``time_codec_case`` takes them."""
    hp = len(buf) - 5 * nb
    stream = torch.cuda.current_stream(dev).cuda_stream
    copies = [(torch.from_numpy(buf).to(dev),
               torch.empty(320 * nb, dtype=torch.int16, device=dev))
              for _ in range(smoke.rotation(buf.nbytes + 640 * nb))]

    def call(x, o):
        rc = fn(x.data_ptr(), hp, nb, o.data_ptr(), 0, stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    return smoke.device_ms(torch, [lambda x=x, o=o: call(x, o)
                                   for x, o in copies],
                           DESIGN_NAMES["bits"])[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="directory holding inaspeechsegmenter_tpu_torch/")
    ap.add_argument("--tag", default=None)
    args = ap.parse_args(argv)
    smoke = load_smoke()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import inaspeechsegmenter_tpu_torch as pkg
    from inaspeechsegmenter_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        print("torch_codec_ab: no CUDA device visible", file=sys.stderr)
        return 1
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not the tree {root}")
    dev = torch.device("cuda", 0)
    cuda_build.library()
    card = smoke.gpu_line()
    mix600 = smoke.to_int16(smoke.seeded_mix(
        600, seed=600, silences=smoke.silences_every(600)))
    mix3600 = smoke.to_int16(smoke.seeded_mix(
        3600, seed=3600, silences=smoke.silences_every(3600)))
    cases = smoke.codec_timing_cases(mix600, mix3600)
    del mix3600
    sweep = sweep_only(root)
    rows = []
    for size, kind, sig, buf in cases:
        nb = len(sig) // 320
        row = {"size": size, "kind": kind, **smoke.time_codec_case(
            torch, dev, kind, buf, nb, DESIGN_NAMES[kind])}
        if kind == "bits" and sweep is not None:
            row["sweep_only_ms"] = time_sweep_only(torch, smoke, sweep, buf,
                                                   nb, dev)
        rows.append(row)
    print("AB " + json.dumps({
        "tag": args.tag or root, "card": card, "torch": torch.__version__,
        "floor_ms": smoke.floor_ms(torch, "profiler"), "rows": rows}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
