"""PyTorch port: the scorer (``eval.py``, ``cli/evaluate.py``) against the
JAX package's, on the same seeded segmentations.

Every metric is compared for equality (the port's module is a copy that
reads its csv files without pandas); the csv reader is held against the
JAX package's pandas reader on files written by both packages' ``seg2csv``
(floats by ``repr``, such as ``22.480000000000002``, read back exactly,
where pandas' default converter may be one ulp off), and both CLIs must
print the same table and the same JSON for the same directories.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from inaspeechsegmenter_tpu import eval as jev
from inaspeechsegmenter_tpu.cli import evaluate as jcli
from inaspeechsegmenter_tpu.export import seg2csv as jax_seg2csv
from inaspeechsegmenter_tpu_torch import eval as tev
from inaspeechsegmenter_tpu_torch.cli import evaluate as tcli
from inaspeechsegmenter_tpu_torch.export import seg2csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = ("speech", "music", "noise", "male", "female", "noEnergy")


def seeded_lseg(seed, n=40, jitter=False):
    """A tiling of random 20 ms-grid segments as the pipeline writes them
    (``start + k * .02`` in float, so repr-long values occur); ``jitter``
    moves the boundaries off the grid."""
    rng = np.random.default_rng(seed)
    out, k = [], 0
    for _ in range(n):
        lab = LABELS[rng.integers(len(LABELS))]
        d = int(rng.integers(1, 120))
        a, b = k * .02, (k + d) * .02
        if jitter:
            a, b = a + rng.uniform(-.009, .009) * (k > 0), b + rng.uniform(
                -.009, .009)
        out.append((lab, a, b))
        k += d
    return out


def perturbed(lseg, seed):
    """A hypothesis: some labels swapped, some boundaries moved."""
    rng = np.random.default_rng(seed)
    out = []
    for lab, a, b in lseg:
        if rng.random() < 0.3:
            lab = LABELS[rng.integers(len(LABELS))]
        out.append((lab, a, b))
    for i in range(1, len(out)):
        if rng.random() < 0.3:
            shift = .02 * int(rng.integers(-3, 4))
            t = min(max(out[i][1] + shift, out[i - 1][1]), out[i][2])
            out[i - 1] = (out[i - 1][0], out[i - 1][1], t)
            out[i] = (out[i][0], t, out[i][2])
    return out[:-int(rng.integers(0, 3))] or out


PAIRS = [(seeded_lseg(s, jitter=s % 2 == 1), None) for s in range(4)]
PAIRS = [(r, perturbed(r, 100 + i)) for i, (r, _) in enumerate(PAIRS)]

CALLS = {
    "frame_labels": lambda ev, r, h: ev.frame_labels(r),
    "frame_labels_n": lambda ev, r, h: ev.frame_labels(h, 0.01, 500),
    "frame_diff": lambda ev, r, h: ev.frame_diff(r, h),
    "frame_diff_collar": lambda ev, r, h: ev.frame_diff(r, h, collar=0.1),
    "confusion": lambda ev, r, h: ev.confusion(r, h, collar=0.04),
    "label_report": lambda ev, r, h: ev.label_report(r, h),
    "vad_report": lambda ev, r, h: ev.vad_report(
        r, h, speech_labels={"speech", "music"}, collar=0.02),
    "boundary_report": lambda ev, r, h: ev.boundary_report(r, h, 0.05),
    "evaluate": lambda ev, r, h: ev.evaluate(r, h, include_confusion=True),
    "merge_confusions": lambda ev, r, h: ev.merge_confusions(
        [ev.confusion(r, h), ev.confusion(h, r, frame_dur=0.01)]),
}


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert (a == b).all()
    else:
        assert a == b


@pytest.mark.parametrize("pair", range(len(PAIRS)))
@pytest.mark.parametrize("fn", sorted(CALLS))
def test_public_functions_equal_jax(fn, pair):
    ref, hyp = PAIRS[pair]
    _same(CALLS[fn](tev, ref, hyp), CALLS[fn](jev, ref, hyp))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("pair", range(len(PAIRS)))
def test_csv_round_trip_equals_pandas_reader(tmp_path, writer, pair):
    ref, hyp = PAIRS[pair]
    write = seg2csv if writer == "port" else jax_seg2csv
    paths = []
    for name, lseg in (("r", ref), ("h", hyp)):
        paths.append(str(tmp_path / f"{name}.csv"))
        write(lseg, paths[-1])
        got = tev.load_segmentation(paths[-1])
        # the port reads back the written floats exactly; pandas' default
        # float converter may land one ulp away (2.2800000000000002 ->
        # 2.28), which moves no frame and no rounded metric
        assert got == [(lab, float(a), float(b)) for lab, a, b in lseg]
        want = jev.load_segmentation(paths[-1])
        assert [r[0] for r in got] == [r[0] for r in want]
        t_got = np.array([r[1:] for r in got])
        t_want = np.array([r[1:] for r in want])
        assert (np.abs(t_got - t_want) <= np.spacing(t_want)).all()
    assert tev.evaluate(*paths) == jev.evaluate(*paths) == \
        jev.evaluate(ref, hyp)


def test_loader_edge_files(tmp_path):
    """Other columns, another column order, blank lines, a quoted label and
    integer times read as the pandas reader reads them; a file without the
    three columns raises the same ValueError in both packages."""
    p = tmp_path / "x.csv"
    p.write_text('stop\textra\tlabels\tstart\n'
                 '1\tq\t"a\tb"\t0\n\n2.5\tq\tmusic\t1\n')
    assert tev.load_segmentation(str(p)) == jev.load_segmentation(str(p)) \
        == [("a\tb", 0.0, 1.0), ("music", 1.0, 2.5)]
    empty = tmp_path / "e.csv"
    seg2csv([], str(empty))
    assert tev.load_segmentation(str(empty)) == \
        jev.load_segmentation(str(empty)) == []
    bad = tmp_path / "bad.csv"
    bad.write_text("x\ty\n1\t2\n")
    for ev in (tev, jev):
        with pytest.raises(ValueError, match="not a segmentation csv"):
            ev.load_segmentation(str(bad))


def _dirs(tmp_path):
    rdir, hdir = tmp_path / "ref", tmp_path / "hyp"
    rdir.mkdir(), hdir.mkdir()
    for i, (ref, hyp) in enumerate(PAIRS):
        seg2csv(ref, str(rdir / f"f{i}.csv"))
        seg2csv(hyp, str(hdir / f"f{i}.csv"))
    seg2csv(PAIRS[0][0], str(rdir / "unmatched.csv"))
    return str(rdir), str(hdir)


@pytest.mark.parametrize("flags", [
    [], ["--json"],
    ["--collar", "0.04", "--frame-dur", "0.01", "--boundary-tolerance",
     "0.05", "--speech-labels", "speech, music"],
    ["--json", "--collar", "0.1", "--speech-labels", "male,female"]])
def test_cli_output_equals_jax(tmp_path, capsys, flags):
    rdir, hdir = _dirs(tmp_path)
    outs = []
    for main in (tcli.main, jcli.main):
        assert main(["-r", rdir, "-y", hdir] + flags) == 0
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out and outs[0].err == outs[1].err
    if "--json" in flags:
        doc = json.loads(outs[0].out)
        assert doc["unmatched_references"] == ["unmatched.csv"]
    else:
        assert "corpus (4 file(s)" in outs[0].out
        assert "WARNING: 1 reference file(s) had no hypothesis" in outs[0].err


@pytest.mark.parametrize("case", ["no_common", "duplicate", "no_match",
                                  "empty_dir"])
def test_cli_errors_equal_jax(tmp_path, capsys, case):
    rdir, hdir = _dirs(tmp_path)
    other = tmp_path / "other"
    other.mkdir()
    argv = {"no_common": ["-r", rdir, "-y", str(other)],
            "duplicate": ["-r", rdir, rdir + "/../ref/", "-y", hdir],
            "no_match": ["-r", str(tmp_path / "nope" / "*.cvs"), "-y", hdir],
            "empty_dir": ["-r", str(other), "-y", hdir]}[case]
    errs = []
    for main in (tcli.main, jcli.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.replace("evaluate.py", ""))
    assert errs[0] == errs[1]


def test_cli_small_output_into_closed_pipe(tmp_path):
    """``... --json | true``: the BrokenPipeError at the final flush is
    handled inside the CLI (exit 0, no 'Exception ignored')."""
    rdir, hdir = _dirs(tmp_path)
    cmd = (f"env -u PYTHONUNBUFFERED {sys.executable} "
           f"-m inaspeechsegmenter_tpu_torch.cli.evaluate "
           f"-r {rdir} -y {hdir} --json | true; echo rc=${{PIPESTATUS[0]}}")
    r = subprocess.run(["bash", "-c", cmd], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert "rc=0" in r.stdout, (r.stdout, r.stderr)
    assert "Exception ignored" not in r.stderr, r.stderr
