"""Multi-host initialisation over ``torch.distributed``: the counterpart
of ``inaspeechsegmenter_tpu/parallel/multihost.py``.

A job of several processes (one per host, or one per GPU) joins one
process group with :func:`init_multihost`.  Segmentation is parallel by
file, so the segmentation workload needs no collective: each process runs
its own engine on its own devices (``global_mesh``), fed by the TCP
job-lease service (``parallel/jobs.py``), which keeps the reference farm's
pull, lease and idempotent-rerun semantics across hosts.  The process
group is there for collective work (``torch.distributed.all_reduce`` and
its kind) and for a barrier at the job's ends.

Departures from the JAX package: the environment names are torchrun's
(``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``); the JAX names
(``JAX_COORDINATOR_ADDRESS`` ...) are JAX's own and are not read.
``global_mesh`` is this process's local mesh, because a torch process
cannot drive another host's device.
"""

from __future__ import annotations

import os

import torch

# this process's devices when init_multihost gave it one card of several
# ranks on its host; None: every visible card is the process's
_RANK_DEVICES = None


def _env_address():
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def _env_int(value, name):
    if value is None:
        value = os.environ.get(name)
    if value is None:
        raise ValueError(f"init_multihost: no {name.lower()} given and "
                         f"${name} is unset (torch.distributed needs it)")
    return int(value)


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, *, device="cuda"):
    """Join the job's process group -> True, or False (nothing done) when
    neither the arguments nor the environment name a coordinator (a
    single-host run).

    :param coordinator_address: ``host:port`` of rank 0's rendezvous
        (default ``$MASTER_ADDR:$MASTER_PORT``).
    :param num_processes: the world size (default ``$WORLD_SIZE``).
    :param process_id: this process's rank (default ``$RANK``); an
        explicit 0, the coordinator, is never overridden by the
        environment.
    :param device: the rank's device type.  ``cuda``: the rank takes
        ``cuda:<local rank>`` (``$LOCAL_RANK``, else the rank modulo the
        visible cards) and the group runs ``nccl`` when every local rank
        has a card of its own (``$LOCAL_WORLD_SIZE``, else the world
        size, at most the visible cards), else ``gloo`` (NCCL refuses two
        ranks on one card).  A process alone on its host owns every
        visible card (``global_mesh``).  ``cpu``: ``gloo``.
    """
    global _RANK_DEVICES
    coordinator_address = coordinator_address or _env_address()
    if coordinator_address is None:
        return False
    # `is None`, not falsy-or: process_id=0 is a real rank
    world = _env_int(num_processes, "WORLD_SIZE")
    rank = _env_int(process_id, "RANK")
    device = torch.device(device)
    backend, mine = "gloo", [device]
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards < 1:
            raise RuntimeError("init_multihost(device='cuda'): no CUDA "
                               "device is visible; pass device='cpu'")
        local_rank = int(os.environ.get("LOCAL_RANK", rank % n_cards))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local_world <= n_cards:
            backend = "nccl"
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
        mine = None if local_world == 1 else [device]
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank)
    _RANK_DEVICES = mine
    return True


def global_mesh(axis="data"):
    """1-D mesh of this process's devices (``mesh.make_mesh``, the one
    owner of the mesh policy): its rank's device after
    :func:`init_multihost` with several ranks on its host, else every
    visible CUDA device.  Work across hosts goes through the process
    group or the job farm."""
    from .mesh import make_mesh

    return make_mesh(axis=axis, devices=_RANK_DEVICES)
