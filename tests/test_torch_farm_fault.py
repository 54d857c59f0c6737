"""PyTorch port: the multi-process job-farm fault model.

Counterpart of ``tests/test_farm_fault.py`` against the port's
``parallel/jobs.py``, whose ``JobServer`` reads the jobs csv with its own
``read_jobs_csv`` (no pandas; the csv is written here with ``csv``).
The reference farm's fault story (pyro_client.py:64-74): clients pull
20-job leases with no acks; a crashed client's leased jobs are lost for that
run; recovery is a re-run with skipifexist=True, which is idempotent.  This
test exercises that story across REAL process boundaries: a TCP JobServer,
two worker clients as subprocesses, one SIGKILLed mid-lease, then a recovery
pass that completes the corpus without re-processing finished outputs.

Workers use a trivial copy `batch_process` so the test measures the farm
(leases, TCP, crash, recovery), not CNN throughput.
"""

import os
import signal
import subprocess
import sys
import time

import csv

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, sys, time
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
            time.sleep(self.delay)
            # write-to-temp + rename: a SIGKILL between open and write
            # must not leave a truncated dst that skipifexist recovery
            # would treat as done
            tmp = dst + ".part" + str(os.getpid())
            with open(src) as f, open(tmp, "w") as g:
                g.write(f.read())
            os.replace(tmp, dst)
            n += 1
        return (0.0, n, 0.0, [])

client_work_loop(sys.argv[1], CopyWorker(float(sys.argv[2])))
print("WORKER-DONE", flush=True)
"""


def write_jobs(path, srcs, dsts):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["source_path", "dest_path"])
        w.writerows(zip(srcs, dsts))


def _spawn_worker(uri, delay):
    env = dict(os.environ)
    return subprocess.Popen(
        [sys.executable, "-c", WORKER % {"repo": REPO}, uri, str(delay)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait_outputs(dsts, minimum, timeout=120):
    t0 = time.time()
    while time.time() - t0 < timeout:
        done = sum(os.path.exists(d) for d in dsts)
        if done >= minimum:
            return done
        time.sleep(0.05)
    raise TimeoutError(f"only {sum(os.path.exists(d) for d in dsts)}"
                       f"/{minimum} outputs after {timeout}s")


def test_torch_farm_crash_recovery(tmp_path):
    from inaspeechsegmenter_tpu_torch.parallel.jobs import JobServer

    n_jobs = 30
    srcs, dsts = [], []
    for i in range(n_jobs):
        src = tmp_path / f"in_{i}.txt"
        src.write_text(f"payload {i}")
        srcs.append(str(src))
        dsts.append(str(tmp_path / f"out_{i}.txt"))
    jobs = tmp_path / "jobs.csv"
    write_jobs(jobs, srcs, dsts)

    srv = JobServer(str(jobs))
    tcp, uri = srv.serve(host="127.0.0.1", port=0)
    try:
        # victim worker: slow enough to be killed mid-lease (leases 20 jobs)
        victim = _spawn_worker(uri, delay=0.5)
        _wait_outputs(dsts, minimum=2)
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=30)
        done_after_crash = sum(os.path.exists(d) for d in dsts)
        assert 2 <= done_after_crash < 20, done_after_crash

        # surviving worker drains the remaining queue (the 10 jobs the
        # victim never leased); the victim's undone leased jobs are LOST
        survivor = _spawn_worker(uri, delay=0.0)
        out, _ = survivor.communicate(timeout=120)
        assert "WORKER-DONE" in out, out
        done_first_run = sum(os.path.exists(d) for d in dsts)
        assert done_first_run < n_jobs, "crash lost no jobs?"
        assert done_first_run >= done_after_crash + 10

        # recovery: re-feed the same manifest, skipifexist re-run completes
        # the corpus without touching finished outputs
        mtimes = {d: os.path.getmtime(d) for d in dsts if os.path.exists(d)}
        srv.set_jobs(str(jobs))
        recovery = _spawn_worker(uri, delay=0.0)
        out, _ = recovery.communicate(timeout=120)
        assert "WORKER-DONE" in out, out
        assert all(os.path.exists(d) for d in dsts)
        for d, old_mtime in mtimes.items():
            assert os.path.getmtime(d) == old_mtime, f"{d} was re-processed"
        for s, d in zip(srcs, dsts):
            with open(s) as f, open(d) as g:
                assert f.read() == g.read()
    finally:
        tcp.shutdown()
        tcp.server_close()
