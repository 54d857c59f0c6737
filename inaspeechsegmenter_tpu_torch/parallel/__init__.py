"""The job farm on the port (``parallel/jobs.py``).  The multi-GPU engine
and the mesh helpers of the JAX package's ``parallel`` wait for their own
slice (``ROADMAP.md``)."""

from .jobs import JobClient, JobServer, client_work_loop

__all__ = ["JobServer", "JobClient", "client_work_loop"]
