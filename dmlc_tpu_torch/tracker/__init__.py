"""Distributed job launcher + rank-rendezvous tracker (the port of
``dmlc_tpu/tracker``).

Rebuild of the reference control plane (tracker/dmlc_tracker/): the
tracker assigns ranks, computes the binomial-tree + shared-ring overlay,
and brokers peer connections over a TCP protocol (magic 0xff99); launch
backends start worker/server processes on local, ssh, mpi, sge, slurm,
mesos and tpu-vm clusters; the worker-side client (``tracker.client``)
carries the host collectives (tree, chunked ring, hierarchical shm+ring).
The wire protocol, env contract and fold order are the JAX package's, so
JAX workers, port workers and C-ABI workers join one job.

    python -m dmlc_tpu_torch.tracker.submit --cluster local \\
        --num-workers 4 -- python -m dmlc_tpu_torch.examples.train_libsvm f 2
"""

from .protocol import MAGIC, FrameSocket, link_maps  # noqa: F401
from .rendezvous import PSTracker, RabitTracker, submit_job  # noqa: F401
from .client import TrackerClient, WorldResized  # noqa: F401
