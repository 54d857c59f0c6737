"""Segmentation export: tab-separated csv and Praat TextGrid, without pandas.

``seg2csv`` writes the bytes that the JAX package's
``pd.DataFrame.from_records(lseg, columns=[...]).to_csv(sep="\\t",
index=False)`` writes: a ``labels\\tstart\\tstop`` header, one row per
segment, floats by ``repr`` (so ``22.480000000000002`` survives verbatim),
``\\n`` line ends, and csv's minimal quoting.  ``seg2textgrid`` is a copy
of the JAX package's writer (the pytextgrid ``PraatTextGrid`` layout).
"""

from __future__ import annotations

import csv
import io
import numbers

COLUMNS = ("labels", "start", "stop")


def _column_cells(values):
    """pandas' column typing: all-int columns stay int, int/float columns
    become float64 (so an int 0 prints as 0.0), anything else as is."""
    if values and all(isinstance(v, numbers.Integral)
                      and not isinstance(v, bool) for v in values):
        return [int(v) for v in values]
    if values and all(isinstance(v, numbers.Real)
                      and not isinstance(v, bool) for v in values):
        return [float(v) for v in values]
    return list(values)


def seg2csv(lseg, fout=None):
    """Write ``[(label, start, stop)]`` as tab-separated csv to the path or
    text file ``fout``; with ``fout=None`` return the text."""
    cols = [_column_cells([row[i] for row in lseg]) for i in range(3)]
    buf = io.StringIO()
    writer = csv.writer(buf, delimiter="\t", lineterminator="\n",
                        quoting=csv.QUOTE_MINIMAL)
    writer.writerow(COLUMNS)
    writer.writerows(zip(*cols))
    payload = buf.getvalue()
    if fout is None:
        return payload
    if hasattr(fout, "write"):
        fout.write(payload)
    else:
        with open(fout, "w", newline="") as f:
            f.write(payload)
    return None


def seg2textgrid(lseg, fout=None):
    # an empty segmentation exports an empty tier (0-duration grid) rather
    # than crashing
    xmin = lseg[0][1] if lseg else 0.0
    xmax = lseg[-1][2] if lseg else 0.0
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        "xmin = %f" % xmin,
        "xmax = %f" % xmax,
        "tiers? <exists> ",
        "size = 1",
        "item []:",
        "\titem [1]:",
        '\t\tclass = "IntervalTier"',
        '\t\tname = "inaSpeechSegmenter"',
        "\t\txmin = %f" % xmin,
        "\t\txmax = %f" % xmax,
        "\t\tintervals: size = %d" % len(lseg),
    ]
    for i, (label, start, stop) in enumerate(lseg, start=1):
        lines.append("\t\tintervals[%d]:" % i)
        lines.append("\t\t\t xmin = %f" % start)
        lines.append("\t\t\t xmax = %f" % stop)
        lines.append('\t\t\t text = "%s"' % label)
    payload = "\n".join(lines) + "\n"
    if fout is None:
        return payload
    if hasattr(fout, "write"):
        fout.write(payload)
    else:
        with open(fout, "w") as f:
            f.write(payload)
