"""PyTorch port: the job-farm soak, counterpart of
``tests/test_farm_soak.py`` against the port's ``parallel/jobs.py`` and
its ``read_jobs_csv`` (the csv written with ``csv``, no pandas).

Job-farm soak at realistic scale: 8 workers x 200 jobs with staggered
SIGKILLs, a full server restart mid-run (re-fed via set_jobs, like the
reference's setjobs client, pyro_client_setjobs.py:30-37), and slow
"NFS-style" destinations — asserting full completion, correct contents,
untouched mtimes on skipifexist reruns, and lease accounting that
reconciles with the outputs."""

import csv
import os
import random
import signal
import subprocess
import sys
import time

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, sys, time, random
sys.path.insert(0, %(repo)r)
from inaspeechsegmenter_tpu_torch.parallel.jobs import client_work_loop

class CopyWorker:
    def __init__(self, delay):
        self.delay = delay

    def batch_process(self, lsrc, ldst, skipifexist=False, nbtry=1,
                      trydelay=2., **kw):
        n = 0
        for src, dst in zip(lsrc, ldst):
            if skipifexist and os.path.exists(dst):
                continue
            # NFS-style slow destination: the write takes a while and the
            # rename lands late
            time.sleep(self.delay * random.random())
            tmp = dst + ".part" + str(os.getpid())
            with open(src) as f, open(tmp, "w") as g:
                g.write(f.read())
            os.replace(tmp, dst)
            n += 1
        return (0.0, n, 0.0, [])

client_work_loop(sys.argv[1], CopyWorker(float(sys.argv[2])),
                 timeout=10.0, reconnect=1)
print("WORKER-DONE", flush=True)
"""


def _spawn(uri, delay):
    env = dict(os.environ)
    return subprocess.Popen(
        [sys.executable, "-c", WORKER % {"repo": REPO}, uri, str(delay)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _count(dsts):
    return sum(os.path.exists(d) for d in dsts)


def test_torch_farm_soak_8workers_200jobs(tmp_path):
    from inaspeechsegmenter_tpu_torch.parallel.jobs import JobServer

    rng = random.Random(7)
    n_jobs = 200
    srcs, dsts = [], []
    for i in range(n_jobs):
        src = tmp_path / f"in_{i}.txt"
        src.write_text(f"payload {i}")
        srcs.append(str(src))
        dsts.append(str(tmp_path / f"out_{i}.txt"))
    jobs = tmp_path / "jobs.csv"
    with open(jobs, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["source_path", "dest_path"])
        w.writerows(zip(srcs, dsts))

    # instrument lease accounting (get_njobs is the only dispatch path)
    leases = []

    class CountingServer(JobServer):
        def get_njobs(self, msg, nbjobs=20):
            ret = JobServer.get_njobs(self, msg, nbjobs)
            leases.append(len(ret[0]))
            return ret

    srv = CountingServer(str(jobs))
    tcp, uri = srv.serve(host="127.0.0.1", port=0)
    port = int(uri.rsplit(":", 1)[1])
    workers = []
    try:
        # phase 1: 8 workers, mixed speeds; kill 3 mid-run at staggered
        # points
        workers = [_spawn(uri, delay=0.02 if i % 2 else 0.15)
                   for i in range(8)]
        victims = rng.sample(workers, 3)
        for v in victims:
            while _count(dsts) < rng.randint(10, 60) and v.poll() is None:
                time.sleep(0.02)
            v.send_signal(signal.SIGKILL)
            v.wait(timeout=30)

        # phase 2: the SERVER dies mid-run and restarts on the same port
        tcp.shutdown()
        tcp.server_close()
        done_mid = _count(dsts)
        for w in workers:           # orphaned workers exit on their own
            if w.poll() is None:    # (bounded reconnect), but don't wait:
                w.send_signal(signal.SIGKILL)   # the soak kills them too
                w.wait(timeout=30)
        leased_phase1 = sum(leases)
        assert 0 < done_mid < n_jobs
        # every output came from a dispatched lease
        assert leased_phase1 >= done_mid

        srv2 = CountingServer()
        tcp2, uri2 = srv2.serve(host="127.0.0.1", port=port)
        try:
            srv2.set_jobs(str(jobs))     # the setjobs re-feed
            mtimes = {d: os.path.getmtime(d)
                      for d in dsts if os.path.exists(d)}
            del leases[:]
            workers2 = [_spawn(uri2, delay=0.0) for _ in range(8)]
            for w in workers2:
                out, _ = w.communicate(timeout=180)
                assert "WORKER-DONE" in out, out

            # full completion, correct contents
            assert _count(dsts) == n_jobs
            for s, d in zip(srcs, dsts):
                with open(s) as f, open(d) as g:
                    assert f.read() == g.read()
            # skipifexist left finished outputs untouched
            for d, old in mtimes.items():
                assert os.path.getmtime(d) == old, f"{d} re-processed"
            # lease accounting reconciles: the re-fed manifest dispatched
            # every job exactly once across the recovery fleet
            assert sum(leases) == n_jobs
            assert not srv2.has_more_jobs()

            # idempotent third pass: nothing re-processed, no new leases
            # beyond the (empty) queue drain
            mtimes_all = {d: os.path.getmtime(d) for d in dsts}
            srv2.set_jobs(str(jobs))
            del leases[:]
            final = _spawn(uri2, delay=0.0)
            out, _ = final.communicate(timeout=120)
            assert "WORKER-DONE" in out, out
            assert sum(leases) == n_jobs        # leased, then skipped
            for d, old in mtimes_all.items():
                assert os.path.getmtime(d) == old, f"{d} re-processed"
        finally:
            tcp2.shutdown()
            tcp2.server_close()
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
        try:
            tcp.server_close()
        except OSError:
            pass
