"""PyTorch port: multi-host initialisation over ``torch.distributed``
(``parallel/multihost.py``), the counterpart of tests/test_multihost.py.

Two processes on 127.0.0.1 join one ``gloo`` group with ``device="cpu"``:
rank 0 by an explicit ``process_id=0`` that the environment's ``RANK=1``
must not override, rank 1 from ``$RANK``; an ``all_reduce`` of the ranks
sums to 1, and ``global_mesh`` is the process's own one-slot CPU mesh.
Without a coordinator ``init_multihost`` does nothing and returns False.
"""

import os
import socket
import subprocess
import sys

import pytest

from inaspeechsegmenter_tpu_torch.parallel import global_mesh, init_multihost
from inaspeechsegmenter_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
import torch
import torch.distributed as dist
from inaspeechsegmenter_tpu_torch.parallel import global_mesh, init_multihost
ok = init_multihost(%(addr)r, 2, %(pid)s, device="cpu")
assert ok, "init_multihost returned False with a coordinator"
assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
rank = dist.get_rank()
x = torch.tensor([float(rank)])
dist.all_reduce(x)
mesh = global_mesh()
assert [str(d) for d in mesh.devices.flat] == ["cpu"], mesh.devices
assert mesh.axis_names == ("data",)
dist.barrier()
dist.destroy_process_group()
print("MULTIHOST_OK", rank, float(x[0]), flush=True)
"""


def test_two_process_gloo_loopback():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                 "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(name, None)
    env["RANK"] = "1"            # read by rank 1, never by the explicit 0
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER % dict(addr=f"127.0.0.1:{port}",
                                             pid=pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for pid in ("0", "None")]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=90)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"MULTIHOST_OK {rank} 1.0" in out, out


def test_init_multihost_noop_without_coordinator(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert init_multihost() is False
    assert init_multihost(num_processes=2, process_id=0) is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")   # no port: no address
    assert init_multihost(device="cpu") is False
    assert multihost._RANK_DEVICES is None


def test_init_multihost_needs_world_and_rank(monkeypatch):
    for name in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        init_multihost("127.0.0.1:1", device="cpu")
    with pytest.raises(ValueError, match="RANK"):
        init_multihost("127.0.0.1:1", 2, device="cpu")


def test_global_mesh_without_init_takes_every_card(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    monkeypatch.setattr(multihost, "_RANK_DEVICES", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        global_mesh()
    monkeypatch.setattr(multihost, "_RANK_DEVICES", [torch.device("cpu")])
    assert list(global_mesh("slots").devices.flat) == [torch.device("cpu")]
