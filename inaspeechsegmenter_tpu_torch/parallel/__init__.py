"""Multi-GPU engine, device meshes and the job farm on the port
(``parallel/engine.py``, ``parallel/mesh.py``, ``parallel/jobs.py``).
The JAX package's multi-host helpers are not ported (``ROADMAP.md``)."""

from .engine import ParallelEngine
from .jobs import JobClient, JobServer, client_work_loop
from .mesh import make_2d_mesh, make_mesh, replicate, shard_batch

__all__ = ["make_mesh", "make_2d_mesh", "shard_batch", "replicate",
           "ParallelEngine", "JobServer", "JobClient", "client_work_loop"]
