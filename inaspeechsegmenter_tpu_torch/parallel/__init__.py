"""Multi-GPU engine, device meshes, the job farm and multi-host
initialisation on the port (``parallel/engine.py``, ``parallel/mesh.py``,
``parallel/jobs.py``, ``parallel/multihost.py``: ``torch.distributed``)."""

from .engine import ParallelEngine
from .jobs import JobClient, JobServer, client_work_loop
from .mesh import make_2d_mesh, make_mesh, replicate, shard_batch
from .multihost import global_mesh, init_multihost

__all__ = ["make_mesh", "make_2d_mesh", "shard_batch", "replicate",
           "ParallelEngine", "JobServer", "JobClient", "client_work_loop",
           "init_multihost", "global_mesh"]
