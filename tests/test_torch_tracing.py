"""PyTorch port: the spans and counters of ``utils.timing``.

After ``Segmenter.batch_process`` and ``VoiceFemininityScoring.batch_score``
on two short files every span of both batch paths has calls in
``snapshot()``: ``prefetch.wait`` one a file, and the counter
``xvec.windows`` the windows the extractor embedded.  Under a profiler of
the calling thread its spans are user annotations nested as the code nests
them; with no profiler no span enters ``record_function``, and under a
profiler of one thread no other thread's span does; ``torch_trace``
records every thread's spans, the producers' too.  The registry loses no
update under contention and ``StageTimers`` feeds it; ``count_launch``
keeps its one counter, the wrapper's ``launches``.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from inaspeechsegmenter_tpu.models.resnet import ResNetXVector as JaxRes
from inaspeechsegmenter_tpu_torch import Segmenter, VoiceFemininityScoring
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.dsp.sidekit import CHUNK, HOP
from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
from inaspeechsegmenter_tpu_torch.utils import cuda_build, timing
from torch_parity_helpers import speechlike, to_int16, voiced

TINY = ("bottleneck", (1, 1, 1, 1), 8, 64, 256)
SEG_SPANS = {"prefetch.produce", "prefetch.wait", "seg.file", "seg.decode",
             "seg.features", "seg.segment", "cnn.select", "cnn.patches",
             "cnn.forward", "seg.labels", "seg.export"}
VFS_SPANS = {"prefetch.produce", "prefetch.wait", "vfs.prepare",
             "vfs.vbx_features", "vfs.score", "vfs.select", "xvec.forward",
             "xvec.sync", "vfs.apply_vad", "vfs.mlp", "vfs.export",
             # the VAD, on the producers
             "seg.features", "seg.segment", "cnn.select", "cnn.patches",
             "cnn.forward", "seg.labels"}


def _gained(before):
    """(span calls, counters) added since the snapshot ``before``."""
    after = timing.snapshot()
    calls = {k: c - before["spans"].get(k, (0.0, 0))[1]
             for k, (_, c) in after["spans"].items()}
    counters = {k: n - before["counters"].get(k, 0)
                for k, n in after["counters"].items()}
    return ({k: c for k, c in calls.items() if c},
            {k: n for k, n in counters.items() if n})


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing")
    sigs = {"voiced12": voiced(12.0, seed=2, silences=[(4.0, 4.7)]),
            "mix7": speechlike(7.0, seed=71)}
    paths = []
    for name, sig in sigs.items():
        paths.append(str(d / f"{name}.wav"))
        write_wav(paths[-1], to_int16(sig), 16000)
    return paths


@pytest.fixture(scope="module")
def seg(synthetic_model_dir):
    return Segmenter("smn", True, None, device="cpu",
                     model_dir=synthetic_model_dir)


@pytest.fixture(scope="module")
def scorer(synthetic_model_dir):
    return VoiceFemininityScoring(
        "vfp", ffmpeg=None, device="cpu", model_dir=synthetic_model_dir,
        xvector_net=ResNetXVector(*TINY),
        xvector_params=JaxRes(*TINY).init_params(seed=7))


@pytest.fixture(autouse=True)
def serial_vfs(monkeypatch):
    monkeypatch.setenv("ISS_VFS_OVERLAP", "auto")
    monkeypatch.setenv("ISS_PREFETCH", "2")
    monkeypatch.delenv("ISS_STREAMING", raising=False)


def _outs(tmp_path, wavs, tag):
    return [str(tmp_path / tag / (w.rsplit("/", 1)[1][:-4] + ".csv"))
            for w in wavs]


def test_segmentation_batch_opens_every_span(seg, wavs, tmp_path):
    before = timing.snapshot()
    _, n_ok, _, _ = seg.batch_process(wavs, _outs(tmp_path, wavs, "s"))
    calls, _ = _gained(before)
    assert n_ok == 2
    assert SEG_SPANS <= set(calls), SEG_SPANS - set(calls)
    for name in ("prefetch.wait", "prefetch.produce", "seg.file",
                 "seg.decode", "seg.features", "seg.segment", "seg.labels",
                 "seg.export"):
        assert calls[name] == 2, name
    # a select for each CNN of each file; a patch build and a forward for
    # each batch of selected frames (a file with no speech has no gender
    # batch)
    assert calls["cnn.select"] == 4
    assert 2 <= calls["cnn.patches"] == calls["cnn.forward"] <= 4


def test_vfs_batch_opens_every_span_and_counts_windows(scorer, wavs,
                                                       tmp_path, monkeypatch):
    xm = scorer.xvector_model
    embedded = []
    full, masked = xm.embeddings_from_features, xm.get_embedding_masked

    def count_full(fea, starts):
        embedded.append(len(starts))
        return full(fea, starts)

    def count_tail(*args):
        embedded.append(1)
        return masked(*args)

    monkeypatch.setattr(xm, "embeddings_from_features", count_full)
    monkeypatch.setattr(xm, "get_embedding_masked", count_tail)
    outs = _outs(tmp_path, wavs, "v")
    before = timing.snapshot()
    _, n_ok, _, _ = scorer.batch_score(wavs, outs)
    calls, counters = _gained(before)
    assert n_ok == 2
    assert VFS_SPANS <= set(calls), VFS_SPANS - set(calls)
    for name in ("prefetch.wait", "prefetch.produce", "vfs.prepare",
                 "vfs.score", "vfs.export"):
        assert calls[name] == 2, name
    assert sum(embedded) > 0
    assert counters["xvec.windows"] == sum(embedded)
    retained = sum(int(open(o).read().splitlines()[1].split("\t")[2])
                   for o in outs)
    assert 0 < retained <= counters["xvec.windows"]


def test_streaming_sites_open_the_cnn_spans(seg, monkeypatch):
    """The streamed call's chunk emissions and right-edge repair build
    patches and run the CNN in the same spans as the fused path."""
    monkeypatch.setenv("ISS_STREAMING", "1")
    sig = to_int16(voiced(1.05 * CHUNK * HOP / 16000, seed=61))
    before = timing.snapshot()
    seg.segment_signal(sig)
    calls, _ = _gained(before)
    # two chunks' VAD emissions and the right edge, with no frame
    # selection; then the gender CNN's selection and batches
    assert calls["cnn.select"] == 1
    assert calls["cnn.patches"] == calls["cnn.forward"] >= 4
    assert calls["seg.labels"] == calls["seg.segment"] == 1


def _annotations(prof):
    return [e for e in prof.events()
            if e.device_type == DeviceType.CPU and e.is_user_annotation]


def test_consumer_spans_nest_under_the_profiler(seg, wavs, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        seg.batch_process(wavs[:1], _outs(tmp_path, wavs[:1], "p"))
    ann = _annotations(prof)
    files = [e for e in ann if e.name == "seg.file"]
    assert len(files) == 1
    mine = [e for e in ann if e.thread == files[0].thread]

    def chain(e):
        out = []
        while e.cpu_parent is not None:
            e = e.cpu_parent
            if e.is_user_annotation:
                out.append(e.name)
        return out

    forwards = [chain(e) for e in mine if e.name == "cnn.forward"]
    assert forwards and all(c == ["seg.segment", "seg.file"]
                            for c in forwards)
    parents = {e.name: chain(e) for e in mine}
    assert parents["seg.labels"] == ["seg.segment", "seg.file"]
    assert parents["seg.export"] == ["seg.file"]
    assert parents["prefetch.wait"] == []


def test_no_record_function_without_a_profiler(seg, wavs, tmp_path,
                                               monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(*args):
        entered.append(args[0])
        return real(*args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    seg.batch_process(wavs[:1], _outs(tmp_path, wavs[:1], "a"))
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        seg.batch_process(wavs[:1], _outs(tmp_path, wavs[:1], "b"))
    assert {"seg.file", "prefetch.wait", "cnn.forward"} <= set(entered)


def test_unrecorded_threads_enter_no_record_function(seg, wavs, tmp_path,
                                                     monkeypatch):
    """Under a profiler of its own thread, the producers' spans stay off
    ``record_function``: that profiler would not record them."""
    entered = []
    real = torch.profiler.record_function

    def counting(*args):
        entered.append((args[0], threading.get_ident()))
        return real(*args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profile(activities=[ProfilerActivity.CPU]):
        seg.batch_process(wavs, _outs(tmp_path, wavs, "u"))
    assert {name for name, _ in entered} >= {"seg.file", "prefetch.wait"}
    assert {tid for _, tid in entered} == {threading.get_ident()}
    assert not {"prefetch.produce", "seg.decode"} & {n for n, _ in entered}


def test_torch_trace_records_the_producers(seg, wavs, tmp_path):
    d = tmp_path / "trace"
    with timing.torch_trace(str(d)):
        seg.batch_process(wavs, _outs(tmp_path, wavs, "t"))
    events = json.load(open(d / "trace.json"))["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    tid = {e["name"]: e["tid"] for e in ann}
    assert {"prefetch.produce", "seg.decode", "seg.file",
            "prefetch.wait"} <= set(tid)
    assert tid["prefetch.produce"] != tid["seg.file"]
    assert sum(e["name"] == "prefetch.produce" for e in ann) == 2


def test_stage_timers_feed_their_span():
    t = timing.StageTimers("tracing_probe")
    before = timing.snapshot()
    for _ in range(3):
        with t.time("tracing_probe"):
            sum(range(1000))
    after = timing.snapshot()["spans"]["seg.tracing_probe"]
    s0, c0 = before["spans"].get("seg.tracing_probe", (0.0, 0))
    assert after[1] - c0 == 3 == t.counts["tracing_probe"]
    assert after[0] - s0 == pytest.approx(t.totals["tracing_probe"],
                                          abs=1e-12)


def test_count_launch_feeds_the_registry():
    """The launch counters stay on the wrappers alone: ``count_launch``
    adds nothing to the registry."""
    def probe_kernel():
        pass

    probe_kernel.launches = 0
    before = timing.snapshot()
    for _ in range(5):
        cuda_build.count_launch(probe_kernel)
    assert probe_kernel.launches == 5
    assert _gained(before)[1] == {}


def test_registry_loses_no_update_under_contention():
    """More threads than cores, a short switch interval: every span call
    and every count lands."""
    n_threads, n_each = 32, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = timing.snapshot()

        def work():
            for _ in range(n_each):
                with timing.span("tracing.stress"):
                    timing.count("tracing.stress", 2)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    calls, counters = _gained(before)
    assert calls["tracing.stress"] == n_threads * n_each
    assert counters["tracing.stress"] == 2 * n_threads * n_each
    assert np.isfinite(timing.snapshot()["spans"]["tracing.stress"][0])
