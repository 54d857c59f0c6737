"""The program's spans in a traced window (``spans.py``): the reduction of
a recorded CPU profile, the attribution of kernels to the spans above
their ops, the snapshot's change, the accessors a reader uses, and the
existing readers unmoved by the keys the readings would add to the
reduced trace."""

from __future__ import annotations

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import counts, spans, spec


def test_reduce_spans_on_a_cpu_profile():
    from inaspeechsegmenter_tpu_torch.utils import timing

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timing.span("seg.file"):
                with timing.span("cnn.forward"):
                    torch.ones(64).mul(2).sum()
        with record_function("not_a_span"):
            torch.ones(4).sum()
    got = spans.reduce_spans(prof)
    assert set(got) == {"seg.file", "cnn.forward"}
    assert got["seg.file"]["calls"] == got["cnn.forward"]["calls"] == 3
    assert got["seg.file"]["host_s"] >= got["cnn.forward"]["host_s"] > 0
    # no device on the CPU: no kernel under any span
    assert got["seg.file"]["device_s"] == got["cnn.forward"]["device_s"] \
        == 0.0


class _Rec:
    """A stand-in for one of the profiler's records (times in ns)."""

    def __init__(self, name, start, dur, corr=0, linked=0, device=False,
                 annotation=False):
        self._v = (name, start, dur, corr, linked, annotation,
                   DeviceType.CUDA if device else DeviceType.CPU)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def linked_correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def device_type(self):
        return self._v[6]


def test_work_counts_for_every_span_open_at_its_launch():
    def span(name, a, b):
        return _Rec(name, a, b - a, annotation=True)

    def launch(t, corr, linked, ns, at=10_000_000):
        """A launch at ``t`` and its device record."""
        return [_Rec("cudaLaunchKernel", t, 5, corr, linked),
                _Rec("kernel", at, ns, corr, linked, device=True)]

    recs = [span("seg.file", 0, 1000), span("seg.labels", 0, 50),
            span("seg.segment", 100, 900), span("cnn.forward", 200, 500),
            span("seg.segment", 300, 400),          # the same name inside
            span("prefetch.wait", 950, 990),
            span("not_a_span", 0, 1000),
            _Rec("cnn.forward", 10_000, 900, annotation=True, device=True),
            # an operator numbered 19 and a launch numbered 19: no match
            _Rec("aten::conv2d", 210, 100, corr=19, linked=0)]
    recs += launch(10, 3, 1, 5_000)
    recs += launch(250, 19, 6, 40_000)
    recs += launch(350, 28, 9, 2_000)
    recs += launch(600, 30, 10, 3_000)
    recs += launch(320, 40, 0, 7_000)           # a ctypes kernel
    recs += launch(960, 41, 0, 9_000)           # another thread's
    recs.append(_Rec("kernel", 10_000_000, 11_000, 50, 12, device=True))
    got = spans.span_times(recs)
    assert set(got) == {"seg.file", "seg.labels", "seg.segment",
                        "cnn.forward", "prefetch.wait"}
    dev = {k: round(v["device_s"] * 1e9) for k, v in got.items()}
    assert dev == {"cnn.forward": 42_000, "seg.segment": 45_000,
                   "seg.labels": 5_000, "seg.file": 50_000,
                   "prefetch.wait": 0}
    assert got["seg.segment"]["calls"] == 2
    assert got["seg.file"]["host_s"] == pytest.approx(1e-6)
    assert spans.span_times(recs[-3:]) == {}


def test_delta_of_two_snapshots():
    before = {"spans": {"a": [1.0, 2], "b": [0.5, 1]}, "counters": {"w": 3}}
    after = {"spans": {"a": [1.5, 4], "b": [0.5, 1], "c": [0.25, 1]},
             "counters": {"w": 10, "launches.k": 2}}
    assert spans.delta(before, after) == {
        "spans": {"a": [0.5, 2], "c": [0.25, 1]},
        "counters": {"w": 7, "launches.k": 2}}
    assert set(spans.snapshot()) == {"spans", "counters"}


def _ctx(vfs=False, **trace):
    """A hand-built reader context: a segmentation answer (label ids) or
    a VFS one (score, speech seconds, x-vectors) of a 60 s file."""
    import numpy as np

    base = {"complete": True, "kernels": {
        "sidekit_fe_kernel_x": [2, 0.004], "viterbi_kernel_y": [6, 0.001]},
        "busy_s": 9.0, "window_s": 10.0, "device_ops": [], "idle_gaps": [],
        "decode_s": 0.05}
    base.update(trace)
    cfg = spec.config("vbx_resnet101_vfs" if vfs else "ina_smn_gender")
    answer = ((0.5, 50.0, 200) if vfs
              else np.array([0, 1, 1, 4, 5, 2] * 500))
    return {"trace": base, "window_s": 10.0, "audio_s": 1800.0,
            "decode_s": 0.05, "service_ms": None, "config": cfg,
            "counts": counts,
            "instances": [{"n": 60 * 16000, "answer": answer}]}


READINGS = {"spans": {"cnn.forward": {"device_s": 2.0, "host_s": 3.0,
                                      "calls": 40}},
            "program": {"spans": {"prefetch.wait": [0.25, 16]},
                        "counters": {"xvec.windows": 250}}}


def test_accessors_read_the_readings():
    ctx = _ctx(**READINGS)
    assert spans.host_s(ctx, "prefetch.wait") == 0.25
    assert spans.host_s(ctx, "seg.export") == 0.0
    assert spans.device_s(ctx, "cnn.forward") == 2.0
    assert spans.device_s(ctx, "cnn.patches") is None
    assert spans.counter(ctx, "xvec.windows") == 250
    bare = _ctx()
    assert spans.host_s(bare, "prefetch.wait") is None
    assert spans.device_s(bare, "cnn.forward") is None
    assert spans.counter(bare, "xvec.windows") is None


@pytest.mark.parametrize("m", spec.benchmark()["per_layer"],
                         ids=lambda m: m["name"])
def test_existing_readers_ignore_the_readings(m):
    read = spec.metric_reader(m["name"])
    vfs = m["moves"] == "vfs_audio_s_per_s"
    value = read(_ctx(vfs))
    assert value is not None
    assert read(_ctx(vfs, **READINGS)) == value
