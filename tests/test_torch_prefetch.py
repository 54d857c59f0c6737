"""PyTorch port: the prefetch batch driver and the prefetched batch surfaces.

``run_prefetched`` against the JAX package's on the same items, produce and
consume callbacks: the same results in input order (under random produce
delays and several depths), the same status tuples when produce or consume
raises, and the same fallback on a malformed ``ISS_PREFETCH``.  The
prefetched ``Segmenter.batch_process`` and
``VoiceFemininityScoring.batch_score`` write csvs byte-equal to the JAX
package's (same ``size="small"`` synthetic weights, the tiny x-vector net
of tests/test_torch_vfs.py) and give the same statuses.
"""

import random
import time

import numpy as np
import pytest

from inaspeechsegmenter_tpu.utils import prefetch as jpre
from inaspeechsegmenter_tpu_torch import Segmenter, VoiceFemininityScoring
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector
from inaspeechsegmenter_tpu_torch.utils import prefetch as tpre
from torch_parity_helpers import speechlike, to_int16, voiced

TINY = ("bottleneck", (1, 1, 1, 1), 8, 64, 256)


def _drive(module, items, fail=()):
    """run_prefetched with a produce that sleeps a random few ms (so that
    producers finish out of order) and raises for sources in ``fail``."""
    rng = random.Random(0)
    delays = {src: rng.uniform(0, 0.02) for src, _ in items}
    consumed = []

    def produce(item):
        src, dst = item
        time.sleep(delays[src])
        if src in fail and fail[src] == "produce":
            raise OSError("disk gone")
        return src.upper(), (dst, 0, "ok")

    def consume(payload, item, msg):
        if fail.get(item[0]) == "consume":
            raise PermissionError("read-only destination")
        consumed.append(payload)
        return (msg[0], msg[1], "ok " + payload)

    dur, n_ok, avg, lmsg = module.run_prefetched(items, produce, consume)
    return n_ok, lmsg, consumed


@pytest.mark.parametrize("depth", ["1", "2", "5"])
def test_order_and_errors_match_jax(monkeypatch, depth):
    monkeypatch.setenv("ISS_PREFETCH", depth)
    items = [(f"f{i}", f"out/f{i}.csv") for i in range(9)]
    fail = {"f2": "produce", "f5": "consume"}
    got = _drive(tpre, items, fail)
    assert got == _drive(jpre, items, fail)
    n_ok, lmsg, consumed = got
    assert n_ok == 7 and consumed == [s.upper() for s, _ in items
                                      if s not in fail]
    assert [m[0] for m in lmsg] == [d for _, d in items]
    assert lmsg[2] == ("out/f2.csv", 2, "error: OSError('disk gone')")
    assert lmsg[5][1] == 2 and "PermissionError" in lmsg[5][2]


@pytest.mark.parametrize("raw,want", [("3", 3), ("0", 1), (" 2 ", 2),
                                      ("", None), ("deep", None)])
def test_prefetch_depth_matches_jax(monkeypatch, raw, want):
    monkeypatch.setenv("ISS_PREFETCH", raw)
    if raw.strip() and want is None:
        with pytest.warns(UserWarning, match="malformed ISS_PREFETCH"):
            got = tpre.prefetch_depth()
        with pytest.warns(UserWarning, match="malformed ISS_PREFETCH"):
            assert got == jpre.prefetch_depth()
    else:
        got = tpre.prefetch_depth()
        assert got == jpre.prefetch_depth()
    if want is not None:
        assert got == want


def test_staged_producer_matches_jax(tmp_path):
    calls = []

    def stage(src):
        calls.append(src)
        if src == "bad":
            raise ValueError("undecodable")
        return src * 2

    exists = tmp_path / "done.csv"
    exists.write_text("x")
    items = [("a", str(tmp_path / "new" / "a.csv")), ("bad", str(
        tmp_path / "b.csv")), ("c", str(exists))]
    for mod in (tpre, jpre):
        produce = mod.staged_producer(stage, skipifexist=True, nbtry=2,
                                      trydelay=0.0)
        got = [produce(it) for it in items]
        assert got == [("aa", (items[0][1], 0, "ok")),
                       (None, (items[1][1], 2,
                               "error: <class 'ValueError'>")),
                       (None, (str(exists), 1, "already exists"))]
    assert calls == ["a", "bad", "bad"] * 2      # nbtry=2 retries the bad one
    assert (tmp_path / "new").is_dir()


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("prefetch")
    sigs = {"silence2sec": np.zeros(32000, np.int16),
            "mix20": to_int16(speechlike(20.0, seed=23,
                                         silences=[(4.0, 4.7)])),
            "voiced20": to_int16(voiced(20.0, seed=2,
                                        silences=[(4.0, 4.7), (13.2, 13.5)])),
            "mix7": to_int16(speechlike(7.0, seed=71))}
    paths = []
    for name, sig in sigs.items():
        paths.append(str(d / f"{name}.wav"))
        write_wav(paths[-1], sig, 16000)
    return paths + [str(d / "missing.wav")]


@pytest.mark.parametrize("depth", ["1", "3"])
def test_batch_process_csvs_byte_equal_to_jax(synthetic_model_dir, wavs,
                                              tmp_path, monkeypatch, depth):
    from inaspeechsegmenter_tpu import Segmenter as JaxSegmenter

    monkeypatch.setenv("ISS_PREFETCH", depth)
    port = Segmenter("smn", True, ffmpeg=None, device="cpu",
                     model_dir=synthetic_model_dir)
    jax = JaxSegmenter(vad_engine="smn", detect_gender=True, ffmpeg=None,
                       allow_download=False)
    names = [p.rsplit("/", 1)[1][:-4] for p in wavs]
    t_out = [str(tmp_path / "t" / f"{n}.csv") for n in names]
    j_out = [str(tmp_path / "j" / f"{n}.csv") for n in names]
    _, n_ok, _, lmsg = port.batch_process(wavs, t_out)
    _, j_ok, _, jmsg = jax.batch_process(wavs, j_out)
    assert n_ok == j_ok == len(wavs) - 1
    assert [m[1] for m in lmsg] == [m[1] for m in jmsg] == [0, 0, 0, 0, 2]
    assert lmsg[-1][2] == jmsg[-1][2] and lmsg[-1][2].startswith("error: ")
    for a, b in zip(t_out[:-1], j_out[:-1]):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_batch_score_csvs_byte_equal_to_jax(synthetic_model_dir, wavs,
                                            tmp_path, monkeypatch):
    from inaspeechsegmenter_tpu import vfs as jvfs
    from inaspeechsegmenter_tpu.models.resnet import ResNetXVector as JaxRes

    monkeypatch.setenv("ISS_VFS_OVERLAP", "0")
    monkeypatch.setenv("ISS_VBX_UPLOAD", "f32")
    monkeypatch.setenv("ISS_PREFETCH", "3")
    params = JaxRes(*TINY).init_params(seed=7)
    port = VoiceFemininityScoring(
        "vfp", ffmpeg=None, device="cpu", model_dir=synthetic_model_dir,
        xvector_net=ResNetXVector(*TINY), xvector_params=params)
    jax = jvfs.VoiceFemininityScoring(
        "vfp", allow_download=False, ffmpeg=None, xvector_net=JaxRes(*TINY),
        xvector_params=params)
    srcs = [w for w in wavs if "mix20" not in w]
    names = [p.rsplit("/", 1)[1][:-4] for p in srcs]
    t_out = [str(tmp_path / "t" / f"{n}.csv") for n in names]
    j_out = [str(tmp_path / "j" / f"{n}.csv") for n in names]
    _, n_ok, _, lmsg = port.batch_score(srcs, t_out, nbtry=2, trydelay=0.01)
    _, j_ok, _, jmsg = jax.batch_score(srcs, j_out, nbtry=2, trydelay=0.01)
    assert n_ok == j_ok == len(srcs) - 1
    assert [m[1] for m in lmsg] == [m[1] for m in jmsg] == [0, 0, 0, 2]
    assert lmsg[-1][2] == jmsg[-1][2]
    for a, b in zip(t_out[:-1], j_out[:-1]):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert open(t_out[1]).read().splitlines()[1].split("\t")[2] != "0"
