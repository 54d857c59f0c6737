"""PyTorch port: the job farm (``parallel/jobs.py`` and the server,
setjobs and client CLIs) against the JAX package's.

The cases of ``tests/test_jobs.py`` on the port's server and client, the
JSON-lines protocol across the packages (a port client against a JAX
server and the reverse), the pandas-free jobs csv reader against the JAX
server's (the same de-duplicated jobs, and the same order under the same
numpy seed), and ``client_work_loop`` with a CPU ``Segmenter`` whose csvs
are byte-equal to the JAX worker's.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from inaspeechsegmenter_tpu.parallel import jobs as jax_jobs
from inaspeechsegmenter_tpu_torch.audio.wav import write_wav
from inaspeechsegmenter_tpu_torch.parallel import jobs
from inaspeechsegmenter_tpu_torch.parallel.jobs import (JobClient, JobServer,
                                                        client_work_loop)
from torch_parity_helpers import speechlike, to_int16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": jobs, "jax": jax_jobs}


@pytest.fixture()
def jobs_csv(tmp_path):
    """Whitespace and a duplicate row that must be stripped and dropped."""
    p = tmp_path / "jobs.csv"
    rows = ["source_path,dest_path",
            " /data/a.mp3 , /out/a.csv",
            "/data/b.mp3,/out/b.csv ",
            "/data/a.mp3,/out/a.csv",       # duplicate after strip
            "/data/c.mp3,  /out/c.csv"]
    p.write_text("\n".join(rows) + "\n")
    return str(p)


@pytest.fixture()
def serving():
    """serving(server_object, **serve_kw) -> uri; shut down after."""
    started = []

    def start(srv, **kw):
        tcp, uri = srv.serve(host="127.0.0.1", port=0, **kw)
        started.append(tcp)
        return uri

    yield start
    for tcp in started:
        tcp.shutdown()
        tcp.server_close()


def test_inprocess_dedup_and_lease_equal_jax(jobs_csv, capsys):
    np.random.seed(0)
    srv = JobServer(jobs_csv)
    np.random.seed(0)
    ref = jax_jobs.JobServer(jobs_csv)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]                   # the same log line
    assert (srv.lsource, srv.ldest) == (ref.lsource, ref.ldest)
    assert srv.has_more_jobs()
    lsrc, ldst = srv.get_njobs("host ok", nbjobs=20)
    assert sorted(zip(lsrc, ldst)) == [("/data/a.mp3", "/out/a.csv"),
                                        ("/data/b.mp3", "/out/b.csv"),
                                        ("/data/c.mp3", "/out/c.csv")]
    assert not srv.has_more_jobs()
    assert srv.get_njobs("host again") == ([], [])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_jobs_reader_equals_pandas(tmp_path, seed):
    """Many rows with duplicates, spaces and quoting: the same job set as
    the JAX server, in the same order under the same numpy seed."""
    rng = np.random.default_rng(seed)
    lines = ["dest_path,source_path"]
    for _ in range(60):
        i = int(rng.integers(25))
        pad = " " * int(rng.integers(3))
        lines.append(f'{pad}/d/{i}.csv,"{pad}/s/{i}, x.wav"{pad}')
    p = tmp_path / "many.csv"
    p.write_text("\n".join(lines) + "\n\n")
    np.random.seed(seed)
    got = JobServer(str(p))
    np.random.seed(seed)
    want = jax_jobs.JobServer(str(p))
    assert (got.lsource, got.ldest) == (want.lsource, want.ldest)
    assert len(got.lsource) == len(set(got.lsource))
    seen = []
    while got.has_more_jobs():
        lsrc, _ = got.get_njobs("c", nbjobs=20)
        assert 0 < len(lsrc) <= 20
        seen += lsrc
    assert sorted(seen) == sorted(want.lsource)


def test_empty_jobs_csv(tmp_path):
    p = tmp_path / "empty.csv"
    p.write_text("source_path,dest_path\n")
    srv = JobServer(str(p))
    assert not srv.has_more_jobs()
    assert srv.get_njobs("x") == ([], [])
    with pytest.raises(IndexError, match="no jobs left"):
        srv.get_job("w")


@pytest.mark.parametrize("server,client", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
def test_tcp_roundtrip_across_packages(jobs_csv, serving, server, client):
    uri = serving(PACKAGES[server].JobServer(jobs_csv))
    c = PACKAGES[client].JobClient(uri)
    lsrc, ldst = c.get_njobs("clienthost -1", nbjobs=2)
    assert len(lsrc) == len(ldst) == 2
    src, dst = c.get_job("one more")
    assert src.startswith("/data/") and dst.startswith("/out/")
    assert sorted(lsrc + [src]) == ["/data/a.mp3", "/data/b.mp3",
                                    "/data/c.mp3"]
    assert not c.has_more_jobs()
    with pytest.raises(RuntimeError, match="IndexError: no jobs left"):
        c.get_job("late")
    assert c.set_jobs(jobs_csv) == f"3 jobs from {jobs_csv} queued"
    assert c.has_more_jobs()
    c.close()


def test_stop_after_dispatch(jobs_csv):
    srv = JobServer(jobs_csv)
    tcp, uri = srv.serve(host="127.0.0.1", port=0, stop_after_dispatch=True)
    client = JobClient(uri)
    client.get_njobs("drain", nbjobs=50)
    tcp._thread.join(timeout=5)
    try:
        assert not tcp._thread.is_alive()
    finally:
        client.close()
        tcp.server_close()


def _send(addr, *requests):
    with socket.create_connection(addr) as s:
        f = s.makefile("rw")
        out = []
        for r in requests:
            f.write(json.dumps(r) + "\n")
            f.flush()
            out.append(json.loads(f.readline()))
        return out


def _addr(uri):
    host, port = uri.split("//")[1].split(":")
    return host, int(port)


def test_tcp_rejects_unknown_method(jobs_csv, serving):
    addr = _addr(serving(JobServer(jobs_csv)))
    bad, ok = _send(addr, {"method": "serve"}, {"method": "has_more_jobs"})
    assert "error" in bad and "unknown method" in bad["error"]
    assert ok == {"result": True}


def test_client_times_out_on_unresponsive_server():
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(4)
    uri = "tcp://127.0.0.1:%d" % lst.getsockname()[1]
    try:
        cli = JobClient(uri, timeout=0.5, reconnect=1)
        t0 = time.time()
        with pytest.raises(ConnectionError, match="unreachable"):
            cli.get_njobs("w", nbjobs=1)
        assert time.time() - t0 < 8.0
        cli.close()
    finally:
        lst.close()


def test_client_fails_fast_when_server_gone():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with pytest.raises((ConnectionError, OSError)):
        JobClient("tcp://127.0.0.1:%d" % port, timeout=0.5, reconnect=1)


def test_work_loop_exits_when_server_killed(jobs_csv):
    """SIGKILL the server process mid-lease: the worker's loop ends within
    its timeout instead of hanging."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from inaspeechsegmenter_tpu_torch.parallel.jobs import "
            "JobServer\n"
            "tcp, uri = JobServer(%r).serve(host='127.0.0.1', port=0)\n"
            "print(uri, flush=True)\n"
            "import time; time.sleep(600)\n" % (REPO, jobs_csv))
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    try:
        uri = ""
        for _ in range(10):
            line = proc.stdout.readline().strip()
            if line.startswith("tcp://"):
                uri = line
                break
        assert uri.startswith("tcp://")

        class KillerSegmenter:
            calls = 0

            def batch_process(self, lsrc, ldst, **kw):
                self.calls += 1
                proc.kill()
                proc.wait()
                return (0.0, len(lsrc), 0.0, [])

        seg = KillerSegmenter()
        t0 = time.time()
        client_work_loop(uri, seg, hostname="w", timeout=1.0, reconnect=1)
        assert seg.calls == 1
        assert time.time() - t0 < 15.0
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
        proc.stdout.close()


def test_duplicate_request_replayed_not_reexecuted(jobs_csv, serving):
    addr = _addr(serving(JobServer(jobs_csv)))
    req = {"method": "get_njobs", "args": ["w"], "kwargs": {"nbjobs": 1},
           "client": "c1", "id": 7}
    first, = _send(addr, req)
    second, third = _send(addr, req, dict(req, id=8))
    assert second == first                   # replayed, not re-leased
    assert third["result"] != first["result"]


def test_client_keys_distinct_across_instances(jobs_csv, serving):
    uri = serving(JobServer(jobs_csv))
    keys = []
    for _ in range(3):
        c = JobClient(uri)
        keys.append(c._client)
        c.close()
    assert len(set(keys)) == 3, keys


def _slow_leases(srv, delay):
    calls, orig = [], srv.get_njobs

    def slow_get_njobs(msg, nbjobs=20):
        calls.append(msg)
        time.sleep(delay)
        return orig(msg, nbjobs=nbjobs)

    srv.get_njobs = slow_get_njobs
    return calls


def test_inflight_duplicate_not_reexecuted(jobs_csv, serving):
    srv = JobServer(jobs_csv)
    calls = _slow_leases(srv, 0.5)
    addr = _addr(serving(srv))
    req = {"method": "get_njobs", "args": ["w"], "kwargs": {"nbjobs": 1},
           "client": "dup", "id": 1}
    results = []
    threads = [threading.Thread(target=lambda: results.extend(
        _send(addr, req))) for _ in range(2)]
    threads[0].start()
    time.sleep(0.15)                 # the original is mid-execution
    threads[1].start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert len(calls) == 1 and results[0] == results[1]


def test_active_client_lock_survives_cache_eviction(jobs_csv, serving):
    srv = JobServer(jobs_csv)
    calls = _slow_leases(srv, 1.0)
    addr = _addr(serving(srv, cap=1))
    req = {"method": "get_njobs", "args": ["A"], "kwargs": {"nbjobs": 1},
           "client": "A", "id": 1}
    replies = {}

    def call(tag, r):
        replies[tag] = _send(addr, r)[0]

    t_orig = threading.Thread(target=call, args=("orig", req))
    t_orig.start()
    time.sleep(0.3)
    call("b", {"method": "has_more_jobs", "client": "B", "id": 1})
    t_retry = threading.Thread(target=call, args=("retry", req))
    t_retry.start()
    for t in (t_orig, t_retry):
        t.join(10)
        assert not t.is_alive()
    assert replies["retry"] == replies["orig"]
    assert calls == ["A"], calls


def test_lease_counter_counts_actual_jobs(jobs_csv):
    srv = JobServer(jobs_csv)
    ls, _ = srv.get_njobs("w", nbjobs=20)
    assert len(ls) == 3 and srv.i == 3
    ls, _ = srv.get_njobs("w", nbjobs=20)
    assert ls == [] and srv.i == 3
    srv.set_jobs(jobs_csv)
    srv.get_job("w1")
    i_before = srv.i
    srv.get_njobs("w2")
    with pytest.raises(IndexError, match="no jobs left"):
        srv.get_job("w3")
    assert srv.i == i_before + 2


# -- workers ---------------------------------------------------------------

@pytest.fixture(scope="module")
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp("media")
    wavs = []
    for name, sig in (("silence2sec", np.zeros(32000, np.int16)),
                      ("mix8", to_int16(speechlike(8.0, seed=31,
                                                   silences=[(3.0, 3.6)])))):
        wavs.append(str(d / (name + ".wav")))
        write_wav(wavs[-1], sig, 16000)
    return wavs


def _jobs_for(tmp_path, wavs, outdir):
    os.makedirs(outdir, exist_ok=True)
    p = tmp_path / f"jobs_{os.path.basename(outdir)}.csv"
    rows = ["source_path,dest_path"]
    for w in wavs + wavs[:1]:                    # one duplicate row
        base = os.path.splitext(os.path.basename(w))[0]
        rows.append(f"{w},{os.path.join(outdir, base + '.csv')}")
    p.write_text("\n".join(rows) + "\n")
    return str(p)


def test_work_loop_csvs_byte_equal_to_jax_worker(synthetic_model_dir, media,
                                                 tmp_path, serving):
    from inaspeechsegmenter_tpu import Segmenter as JaxSegmenter
    from inaspeechsegmenter_tpu_torch import Segmenter

    port = Segmenter("smn", True, ffmpeg=None, device="cpu",
                     model_dir=synthetic_model_dir)
    ref = JaxSegmenter(vad_engine="smn", detect_gender=True, ffmpeg=None,
                       allow_download=False)
    outs = {}
    for tag, worker, pkg in (("port", port, jobs), ("jax", ref, jax_jobs)):
        out = str(tmp_path / tag)
        uri = serving(pkg.JobServer(_jobs_for(tmp_path, media, out)))
        ret = pkg.client_work_loop(uri, worker, hostname=tag)
        assert ret[1] == len(media)
        outs[tag] = out
    for w in media:
        name = os.path.splitext(os.path.basename(w))[0] + ".csv"
        with open(os.path.join(outs["port"], name), "rb") as a, \
                open(os.path.join(outs["jax"], name), "rb") as b:
            assert a.read() == b.read(), name
    # a second run skips every file (skipifexist)
    uri = serving(JobServer(_jobs_for(tmp_path, media, outs["port"])))
    ret = client_work_loop(uri, port, hostname="again")
    assert ret[1] == 0 and all(m[1] == 1 for m in ret[3])


def test_clis_drive_a_farm(synthetic_model_dir, media, tmp_path, capsys,
                           monkeypatch):
    """cli.server (in a process, stop_after_dispatch), cli.setjobs re-feeds
    it, cli.client drains it on the CPU; the client without a card and
    without --device raises."""
    from inaspeechsegmenter_tpu_torch.cli import client, setjobs

    monkeypatch.setenv("ISS_TPU_MODEL_DIR", synthetic_model_dir)
    empty = tmp_path / "empty.csv"
    empty.write_text("source_path,dest_path\n")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", "inaspeechsegmenter_tpu_torch.cli.server",
         "127.0.0.1", str(empty), "--port", str(port),
         "--stop_after_dispatch"], cwd=REPO, stdout=subprocess.PIPE,
        text=True)
    try:
        line = ""
        for _ in range(5):
            line = proc.stdout.readline()
            if "listening on" in line:
                break
        uri = "tcp://127.0.0.1:%d" % port
        assert uri in line
        out = str(tmp_path / "cli")
        csv = _jobs_for(tmp_path, media, out)
        setjobs.main([uri, csv])
        assert f"2 jobs from {csv} queued" in capsys.readouterr().out
        if not __import__("torch").cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                client.main([uri, "--ffmpeg_binary", "none"])
        assert client.main([uri, "--ffmpeg_binary", "none", "--device",
                            "cpu", "--lease_timeout", "10"]) == 0
        assert proc.wait(timeout=30) == 0
        assert sorted(os.listdir(out)) == ["mix8.csv", "silence2sec.csv"]
        with open(os.path.join(out, "silence2sec.csv")) as fh:
            assert fh.read() == "labels\tstart\tstop\nnoEnergy\t0.0\t1.98\n"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
