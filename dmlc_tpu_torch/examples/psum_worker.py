"""Distributed worker: tracker rendezvous, then a cross-process all-reduce
over ``torch.distributed`` (the port of ``examples/jax_psum_worker.py``).

Each process launched by the launcher

  1. rendezvouses with the tracker (the host control plane),
  2. calls ``initialize_distributed()``: ``torch.distributed`` over the
     tracker-allocated ``DMLC_JAX_COORD_URI``/``PORT`` (never the
     tracker's own socket), with the backend picked from the host's
     topology,
  3. builds the mesh and all-reduces ``rank + 1`` over it on its device,
  4. checks the sum against the closed form ``world·(world+1)/2`` and
     reports through the tracker's print relay.

    python -m dmlc_tpu_torch.tracker.submit --cluster local \
        --num-workers 2 -- python -m dmlc_tpu_torch.examples.psum_worker \
        [--device cpu]
"""

import argparse

import torch

from ..parallel import build_mesh, initialize_distributed
from ..parallel.collectives import all_reduce
from ..tracker.client import TrackerClient


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the tensors' device (default: the card)")
    args = ap.parse_args(argv)
    client = TrackerClient()
    client.start()
    backend = initialize_distributed()
    mesh = build_mesh(dp=client.world_size, device=args.device)
    x = torch.full((4,), float(mesh.rank + 1), dtype=torch.float32,
                   device=mesh.device)
    got = float(all_reduce(x, "dp", mesh=mesh)[0])
    want = mesh.world * (mesh.world + 1) / 2
    if got != want:
        raise AssertionError(f"all-reduce {got} != {want}")
    client.log(f"rank {mesh.rank}/{mesh.world}: torch psum OK -> {got} "
               f"(backend {backend}, device {mesh.device})")
    client.shutdown()


if __name__ == "__main__":
    main()
