"""PyTorch port: the mesh helpers and the data-parallel engine
(``parallel/mesh.py``, ``parallel/engine.py``) on meshes of repeated CPU
slots, against ``Segmenter`` and the JAX package's ``ParallelEngine`` on
its 8 virtual CPU devices, and ``--parallel`` in the three CLIs.

Labels are equal and csvs byte-equal on the same ``size="small"``
weights.  The routing is pinned as the JAX engine's: a file alone in its
length bucket goes through ``run_sharded``, the ragged tail of a
multi-group bucket and every file of a corpus stay on the per-file path,
and a 1-slot mesh never shards.
"""

import functools
import os
import threading

import numpy as np
import pytest
import torch

from inaspeechsegmenter_tpu_torch import Segmenter
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.dsp.sidekit import CHUNK
from inaspeechsegmenter_tpu_torch.parallel import (ParallelEngine,
                                                   make_2d_mesh, make_mesh,
                                                   replicate, shard_batch)
from inaspeechsegmenter_tpu_torch.parallel.engine import bucket_rows
from inaspeechsegmenter_tpu_torch.parallel.mesh import (run_on_slots,
                                                        slot_streams)
from inaspeechsegmenter_tpu_torch.segmenter import patch_counts
from torch_parity_helpers import to_int16, voiced

SILENCE_CSV = "labels\tstart\tstop\nnoEnergy\t0.0\t1.98\n"


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def seg(synthetic_model_dir):
    return Segmenter("smn", True, ffmpeg=None, device="cpu",
                     model_dir=synthetic_model_dir)


@pytest.fixture(scope="module")
def engine(seg):
    return ParallelEngine(seg, cpu_mesh(4))


@pytest.fixture(scope="module")
def jax_seg(synthetic_model_dir):
    from inaspeechsegmenter_tpu import Segmenter as JaxSegmenter

    return JaxSegmenter(vad_engine="smn", detect_gender=True, ffmpeg=None,
                        allow_download=False)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """silence2sec, two voiced mixes in one bucket and a longer one."""
    d = tmp_path_factory.mktemp("media")
    out = {}
    sigs = {"silence2sec": np.zeros(32000, np.int16),
            "mix20": to_int16(voiced(20.0, 21, silences=[(4.0, 4.7)])),
            "mix25": to_int16(voiced(25.0, 22, silences=[(9.0, 9.5)])),
            "mix70": to_int16(voiced(70.0, 23, silences=[(30.0, 31.0)]))}
    for name, sig in sigs.items():
        out[name] = str(d / f"{name}.wav")
        write_wav(out[name], sig, 16000)
    return out


def random_feats(rng, rows, t):
    mspec = torch.from_numpy(rng.standard_normal((rows, 24))
                             .astype(np.float32))
    loge = torch.from_numpy(rng.standard_normal(rows).astype(np.float32))
    return mspec, loge, t, 0


def check_ids(seg, feats, ids):
    for (mspec, loge, t, difflen), got in zip(feats, ids):
        nfp, n20 = patch_counts(t, difflen)
        want = seg.pipeline.run(mspec, loge, t, nfp, n20).numpy()
        np.testing.assert_array_equal(got, want)


def forbid_sharded(seg, monkeypatch):
    monkeypatch.setattr(
        seg.pipeline, "run_sharded",
        lambda *a, **k: (_ for _ in ()).throw(AssertionError("sharded")))


def count_sharded(seg, monkeypatch):
    calls, real = [], seg.pipeline.run_sharded
    monkeypatch.setattr(seg.pipeline, "run_sharded",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    return calls


# -- the mesh ----------------------------------------------------------------

def test_mesh_shapes_and_defaults():
    m = cpu_mesh(8)
    assert m.shape == {"data": 8} and m.axis_names == ("data",)
    assert m.devices.size == 8 and all(d.type == "cpu"
                                       for d in m.devices.flat)
    assert make_mesh(5, devices=["cpu"] * 8).devices.size == 5
    m2 = make_2d_mesh(data=4, model=2, devices=["cpu"] * 8)
    assert m2.shape == {"data": 4, "model": 2}
    assert m2.axis_names == ("data", "model")
    assert len(m2.axis_devices("data")) == 4
    assert make_2d_mesh(model=2, devices=["cpu"] * 8).shape["data"] == 4
    with pytest.raises(ValueError):
        make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_2d_mesh(4, 3, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        # no devices given: every visible CUDA device, never the CPU
        for fn in (make_mesh, make_2d_mesh):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ParallelEngine(object())
    else:
        assert all(d.type == "cuda" for d in make_mesh().devices.flat)


def test_shard_batch_and_replicate():
    m = make_2d_mesh(4, 2, devices=["cpu"] * 8)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    parts = shard_batch(m, x)
    assert len(parts) == 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(m, x[:6])
    lin = torch.nn.Linear(3, 2)
    reps = replicate(cpu_mesh(3), lin)
    assert len(reps) == 3 and len({id(r) for r in reps}) == 3
    assert all(torch.equal(r.weight, lin.weight) for r in reps)
    assert reps[0].weight.data_ptr() != reps[1].weight.data_ptr()
    t = torch.ones(3)
    shared = replicate(cpu_mesh(3), {"a": [t]})
    assert all(s["a"][0] is t for s in shared)      # one device: one tensor


def test_run_on_slots_threads_order_and_errors():
    devs = [torch.device("cpu")] * 3
    streams = slot_streams(devs)
    assert streams == [None] * 3
    barrier = threading.Barrier(3, timeout=10)

    def fn(k, item):
        barrier.wait()          # every slot is inside at once
        return k, item, threading.get_ident()

    out = run_on_slots(fn, ["a", "b", "c"], devs, streams)
    assert [o[:2] for o in out] == [(0, "a"), (1, "b"), (2, "c")]
    assert len({o[2] for o in out}) == 3

    def boom(k, item):
        if k == 1:
            raise KeyError("slot 1")
        return k

    with pytest.raises(KeyError, match="slot 1"):
        run_on_slots(boom, [0, 1, 2], devs, streams)


def test_bucket_rows_is_the_jax_ladder():
    from inaspeechsegmenter_tpu.pipeline import bucket_rows as jax_bucket

    for rows in (1, 68, 2048, CHUNK, CHUNK + 1, 3 * CHUNK, 40000, 60000,
                 250000):
        assert bucket_rows(rows) == jax_bucket(rows), rows


# -- the engine ----------------------------------------------------------

def test_segment_many_matches_segmenter_and_jax(seg, engine, jax_seg,
                                                wavs):
    """Port features through the port engine and, padded to the JAX row
    buckets, through the JAX engine: equal label ids, equal to the
    Segmenter's per-file segmentation."""
    import jax.numpy as jnp

    from inaspeechsegmenter_tpu.parallel import ParallelEngine as JaxEngine
    from inaspeechsegmenter_tpu.pipeline import bucket_rows as jax_bucket

    names = ["mix20", "mix25", "silence2sec", "mix70"]
    feats = [seg._media2feats(wavs[n]) for n in names]
    got = engine.segment_many(feats)
    jfeats = []
    for mspec, loge, t, difflen in feats:
        rows = jax_bucket(mspec.shape[0])
        mp = np.zeros((rows, 24), np.float32)
        mp[:mspec.shape[0]] = mspec.numpy()
        lp = np.full(rows, -np.inf, np.float32)
        lp[:loge.shape[0]] = loge.numpy()
        jfeats.append((jnp.asarray(mp), jnp.asarray(lp), t, difflen))
    want = JaxEngine(jax_seg).segment_many(jfeats)
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert seg.ids_to_lseg(g) == seg(wavs[name]), name
    assert {4, 5} & set(np.concatenate(got).tolist())   # gender ran


def test_group_runs_file_k_on_slot_k(seg, engine, monkeypatch):
    pipes, _ = seg.pipeline.slots(engine.mesh)
    seen = {}
    for k, pipe in enumerate(pipes):
        real = pipe.run
        monkeypatch.setattr(
            pipe, "run", functools.partial(
                lambda k, real, m, *a: (seen.setdefault(k, []).append(
                    (m.shape[0], threading.get_ident())), real(m, *a))[1],
                k, real))
    rng = np.random.default_rng(3)
    feats = [random_feats(rng, 2048, 2000 - 10 * i) for i in range(3)]
    ids = engine.segment_many(feats)
    check_ids(seg, feats, ids)
    assert sorted(seen) == [0, 1, 2]            # no copies of file 0
    assert len({v[0][1] for v in seen.values()}) == 3   # one thread each


def test_ragged_tail_stays_per_file(seg, engine, monkeypatch):
    """n_dev + 1 files of one bucket: the 1-file tail group stays on the
    per-file path; labels equal the fused run."""
    rng = np.random.default_rng(4)
    feats = [random_feats(rng, 2048, 2048 - 40 - i)
             for i in range(engine.n_dev + 1)]
    forbid_sharded(seg, monkeypatch)
    check_ids(seg, feats, engine.segment_many(feats))


def test_lone_bucket_file_uses_timeline_shard(seg, engine, monkeypatch):
    rng = np.random.default_rng(5)
    feats = [random_feats(rng, 2048, 2048 - 40 - i)
             for i in range(engine.n_dev)]
    feats.append(random_feats(rng, 3 * CHUNK, 3 * CHUNK - 40))  # lone bucket
    assert bucket_rows(3 * CHUNK) != bucket_rows(2048)
    calls = count_sharded(seg, monkeypatch)
    ids = engine.segment_many(feats)
    assert len(calls) == 1
    check_ids(seg, feats, ids)


def test_one_slot_mesh_keeps_fused_path(seg, monkeypatch, wavs):
    one = ParallelEngine(seg, cpu_mesh(1))
    assert one.n_dev == 1
    forbid_sharded(seg, monkeypatch)
    rng = np.random.default_rng(6)
    feats = [random_feats(rng, 2048, 2000)]
    check_ids(seg, feats, one.segment_many(feats))
    assert one(wavs["mix20"]) == seg(wavs["mix20"])


def test_batch_process_matches_segmenter_and_jax(seg, engine, jax_seg,
                                                 wavs, tmp_path):
    """Five files (two groups on four slots, a missing file among them):
    the csvs byte-equal the Segmenter's and the JAX engine's."""
    from inaspeechsegmenter_tpu.parallel import ParallelEngine as JaxEngine

    names = ["silence2sec", "mix20", "mix25", "mix70", "mix20"]
    ins = [wavs[n] for n in names] + ["/nope.wav"]
    outs = [str(tmp_path / "port" / f"o{i}.csv") for i in range(len(ins))]
    _, n_ok, _, lmsg = engine.batch_process(ins, outs)
    assert n_ok == 5 and [m[1] for m in lmsg] == [0, 0, 0, 0, 0, 2]
    assert [m[0] for m in lmsg] == outs
    ref = [str(tmp_path / "seg" / f"o{i}.csv") for i in range(len(ins))]
    seg.batch_process(ins, ref)
    jx = [str(tmp_path / "jax" / f"o{i}.csv") for i in range(len(ins))]
    JaxEngine(jax_seg).batch_process(ins, jx)
    for a, b, c in zip(outs[:-1], ref[:-1], jx[:-1]):
        assert open(a, "rb").read() == open(b, "rb").read() == \
            open(c, "rb").read()
    assert open(outs[0]).read() == SILENCE_CSV


def test_corpus_tail_batch_process_stays_per_file(seg, engine, wavs,
                                                  tmp_path, monkeypatch):
    forbid_sharded(seg, monkeypatch)
    n = engine.n_dev + 1
    ins = [wavs["silence2sec"]] * n
    outs = [str(tmp_path / f"o{i}.csv") for i in range(n)]
    _, n_ok, _, _ = engine.batch_process(ins, outs)
    assert n_ok == n
    assert all(open(o).read() == SILENCE_CSV for o in outs)


def test_single_file_batch_process_shards(seg, engine, wavs, tmp_path,
                                          monkeypatch):
    """One todo file goes through the timeline shard; a skipped file keeps
    its slot; a lone missing file is status 2; an unwritable dst is that
    file's status 2 while the rest of the batch lands."""
    calls = count_sharded(seg, monkeypatch)
    ins = [wavs["mix70"], wavs["silence2sec"]]
    outs = [str(tmp_path / "m.csv"), str(tmp_path / "skip.csv")]
    (tmp_path / "skip.csv").write_text("preexisting\n")
    _, n_ok, _, lmsg = engine.batch_process(ins, outs, skipifexist=True)
    assert n_ok == 1 and [m[1] for m in lmsg] == [0, 1] and len(calls) == 1
    seg.batch_process([ins[0]], [str(tmp_path / "m_single.csv")])
    assert (tmp_path / "m.csv").read_text() == \
        (tmp_path / "m_single.csv").read_text()
    assert (tmp_path / "skip.csv").read_text() == "preexisting\n"
    _, n_ok, _, lmsg = engine.batch_process(["/nope.wav"],
                                            [str(tmp_path / "n.csv")])
    assert n_ok == 0 and lmsg[0][1] == 2
    assert not (tmp_path / "n.csv").exists()
    bad = tmp_path / "isdir.csv"
    bad.mkdir()
    _, n_ok, _, lmsg = engine.batch_process(
        [wavs["silence2sec"], wavs["silence2sec"]],
        [str(bad), str(tmp_path / "good.csv")])
    assert [m[1] for m in lmsg] == [2, 0] and n_ok == 1
    assert lmsg[0][2].startswith("error:")
    assert (tmp_path / "good.csv").read_text() == SILENCE_CSV


def test_status_order_with_skips(engine, wavs, tmp_path):
    ins = [wavs["silence2sec"], wavs["silence2sec"], "/nope.wav",
           wavs["silence2sec"]]
    outs = [str(tmp_path / f"o{i}.csv") for i in range(4)]
    (tmp_path / "o1.csv").write_text("preexisting\n")
    _, n_ok, _, lmsg = engine.batch_process(ins, outs, skipifexist=True)
    assert n_ok == 2
    assert [m[1] for m in lmsg] == [0, 1, 2, 0]
    assert [m[0] for m in lmsg] == outs
    assert (tmp_path / "o1.csv").read_text() == "preexisting\n"
    with pytest.raises(NotImplementedError):
        engine.batch_process(ins, outs, output_format="json")


# -- --parallel in the CLIs ---------------------------------------------

def test_cli_segment_parallel_matches_jax_cli(synthetic_model_dir, wavs,
                                              tmp_path, monkeypatch):
    """The JAX CLI's --parallel on its 8 devices and the port's, on one
    CPU slot (``--device cpu``) and on a 4-slot CPU mesh: byte-equal
    csvs."""
    from inaspeechsegmenter_tpu.cli.segment import main as jax_main
    from inaspeechsegmenter_tpu_torch.cli import _common, segment

    ins = [wavs["silence2sec"], wavs["mix20"]]
    for d in ("jax", "port1", "port4"):
        (tmp_path / d).mkdir()
    jax_main(["-i", *ins, "-o", str(tmp_path / "jax"), "-b", "none",
              "--parallel"])
    import inaspeechsegmenter_tpu_torch.parallel as par

    engines, real = [], par.ParallelEngine
    monkeypatch.setattr(par, "ParallelEngine", lambda *a, **k: (
        engines.append(real(*a, **k)), engines[-1])[1])
    argv = ["-i", *ins, "-b", "none", "--device", "cpu", "--parallel"]
    segment.main(argv + ["-o", str(tmp_path / "port1")])
    monkeypatch.setattr(segment, "parallel_mesh", lambda dev: cpu_mesh(4))
    segment.main(argv + ["-o", str(tmp_path / "port4")])
    assert [e.n_dev for e in engines] == [1, 4]
    assert _common.parallel_mesh("cpu").devices.size == 1
    for name in ("silence2sec.csv", "mix20.csv"):
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port1" / name).read_bytes() == want
        assert (tmp_path / "port4" / name).read_bytes() == want


def test_cli_vfs_parallel(synthetic_model_dir, wavs, tmp_path, monkeypatch,
                          capsys):
    """--parallel: one slot prints the JAX one-device notice and runs
    without a mesh; a 4-slot mesh gives the same csv rows."""
    import inaspeechsegmenter_tpu_torch.vfs as vfs_mod
    from inaspeechsegmenter_tpu_torch.cli import vfs as cli_vfs
    from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector

    net = ResNetXVector("bottleneck", (1, 1, 1, 1), 8, 64, 256)
    meshes, real = [], vfs_mod.VoiceFemininityScoring

    def scorer(*a, **k):
        meshes.append(k.get("mesh"))
        return real(*a, allow_download=False, xvector_net=net,
                    xvector_params=net.init_params(seed=7),
                    model_dir=synthetic_model_dir, **k)

    monkeypatch.setattr(vfs_mod, "VoiceFemininityScoring", scorer)
    ins = [wavs["silence2sec"], wavs["mix25"]]
    rows = {}
    for tag, extra in (("plain", []), ("one", ["--parallel"]),
                       ("four", ["--parallel"])):
        if tag == "four":
            monkeypatch.setattr(cli_vfs, "parallel_mesh",
                                lambda dev: cpu_mesh(4))
        out = tmp_path / tag
        out.mkdir()
        cli_vfs.main(["-i", *ins, "-o", str(out), "-b", "none", "-c", "vfp",
                      "--device", "cpu", *extra])
        rows[tag] = [(out / f"{n}.csv").read_text()
                     for n in ("silence2sec", "mix25")]
        if tag == "one":
            assert "[vfs] --parallel: one local device, running " \
                "single-device" in capsys.readouterr().out
    assert meshes[0] is None and meshes[1] is None
    assert meshes[2].devices.size == 4
    assert rows["plain"] == rows["one"] == rows["four"]
    assert rows["plain"][0].splitlines()[1] == "\t0.0\t0"
    assert int(rows["plain"][1].splitlines()[1].split("\t")[2]) > 0


def test_cli_client_parallel_builds_engine_and_mesh(synthetic_model_dir,
                                                    monkeypatch):
    import inaspeechsegmenter_tpu_torch as port
    import inaspeechsegmenter_tpu_torch.parallel as par
    from inaspeechsegmenter_tpu_torch.cli import client

    captured = {}
    monkeypatch.setattr(par, "client_work_loop",
                        lambda uri, worker, **kw: captured.update(
                            worker=worker))
    monkeypatch.setattr(client, "parallel_mesh", lambda dev: cpu_mesh(3))
    monkeypatch.setenv("ISS_TPU_MODEL_DIR", synthetic_model_dir)
    client.main(["tcp://127.0.0.1:1", "--parallel", "--ffmpeg_binary",
                 "none", "--device", "cpu"])
    assert isinstance(captured["worker"], ParallelEngine)
    assert captured["worker"].n_dev == 3
    client.main(["tcp://127.0.0.1:1", "--ffmpeg_binary", "none",
                 "--device", "cpu"])
    assert isinstance(captured["worker"], Segmenter)

    class FakeVFS:
        def __init__(self, **kw):
            captured.update(kw)

    monkeypatch.setattr(port, "VoiceFemininityScoring", FakeVFS)
    client.main(["tcp://127.0.0.1:1", "--vfs", "--parallel",
                 "--ffmpeg_binary", "none", "--device", "cpu"])
    assert captured["mesh"].devices.size == 3
    client.main(["tcp://127.0.0.1:1", "--vfs", "--ffmpeg_binary", "none",
                 "--device", "cpu"])
    assert captured["mesh"] is None
    assert os.environ["ISS_TPU_MODEL_DIR"] == synthetic_model_dir
