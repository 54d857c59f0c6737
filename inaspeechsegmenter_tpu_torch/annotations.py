"""Minimal interval/timeline arithmetic for the VFS pipeline.

Stdlib-only copy of ``SpeechTimeline`` from
``inaspeechsegmenter_tpu/annotations.py`` (that package imports jax):
the VAD output is a sorted list of non-overlapping speech intervals, so
midpoint tests, overlap durations and totals are simple sweeps (reference
vbx_segmenter.py:28-69,129-145).
"""

from __future__ import annotations

import bisect


class SpeechTimeline:
    """Sorted non-overlapping speech intervals with overlap queries."""

    def __init__(self, intervals):
        ivs = sorted((float(a), float(b)) for a, b in intervals)
        # merge STRICTLY overlapping intervals only: the reference tests a
        # segment's strict interior (seg.start < m < seg.end), so a point
        # shared by two touching intervals is not speech, and merging
        # across it would change contains_point there
        merged = []
        for a, b in ivs:
            if merged and a < merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        self.intervals = merged
        self._starts = [a for a, _ in self.intervals]

    @classmethod
    def from_vad(cls, vad_tuples, label="speech"):
        """Build from (label, start, stop) tuples, keeping `label` segments
        (reference get_annot_VAD, vbx_segmenter.py:64-69)."""
        return cls([(s, e) for lab, s, e in vad_tuples if lab == label])

    def total_duration(self):
        return sum(b - a for a, b in self.intervals)

    def contains_point(self, m):
        """True if m lies strictly inside a speech interval
        (seg.start < m < seg.end, reference is_mid_speech)."""
        i = bisect.bisect_right(self._starts, m)
        if i == 0:
            return False
        a, b = self.intervals[i - 1]
        return a < m < b

    def overlap_duration(self, start, stop):
        """Total length of [start, stop] ∩ speech (reference
        Timeline.crop().duration())."""
        total = 0.0
        i = bisect.bisect_left(self._starts, start)
        if i > 0:
            i -= 1
        for a, b in self.intervals[i:]:
            if a >= stop:
                break
            lo, hi = max(a, start), min(b, stop)
            if hi > lo:
                total += hi - lo
        return total

    def __len__(self):
        return len(self.intervals)
