"""SPMD pipeline parallelism over the ``pp`` mesh axis (port of
``dmlc_tpu/parallel/pipeline.py``): the GPipe schedule, M + P - 1 steps
for M microbatches over P stages, every stage's activations moving one
stage on per step with ``ppermute_ring``.

Every pp rank runs the same program: the stage function on every step,
the bubble steps included, with the stage's input and the last stage's
outputs chosen by ``torch.where`` on the rank's pp index, as the
reference's ``jnp.where`` does.  So every rank builds the same autograd
graph and issues its pp shifts, forward and backward, in one order
against the stage's own tp and sp collectives.  The transposes are the
reference's, written out: the replicated input enters with ``copy_to``
(its cotangent summed over pp: only stage 0 consumes it), and the
closing sum over pp of the last stage's outputs is ``reduce_from`` (a
pp-invariant result, identity backward).

Telemetry as the reference's: the ``pipeline`` gauges ``stages``,
``microbatches``, ``bubble_steps_per_stage`` and ``bubble_fraction`` =
(P-1)/(M+P-1), the ``microbatches_per_run`` histogram and the
``runs_traced`` counter, which here counts calls (the reference counts
traces; the two agree after one call)."""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from .. import telemetry
from ..base import DMLCError
from .collectives import copy_to, ppermute_ring, reduce_from
from .mesh import Mesh

__all__ = ["pipeline_spmd", "make_pipeline"]


def pipeline_spmd(stage_fn: Callable, stage_params, x_microbatches,
                  *, mesh: Mesh, axis_name: str = "pp") -> torch.Tensor:
    """Run this rank's stage of a P-stage pipeline.

    ``stage_fn(params, x) -> y`` keeps the activation's shape;
    ``stage_params`` are this rank's stage's parameters;
    ``x_microbatches`` ``[M, mb, ...]`` is the whole input, the same on
    every pp rank (only stage 0 consumes it).  Returns the ``[M, mb,
    ...]`` outputs on every pp rank: the sum over pp of the last stage's
    outputs and zeros elsewhere."""
    n = mesh.axis_size(axis_name)
    my = mesh.axis_rank(axis_name)
    m = x_microbatches.shape[0]
    total = m + n - 1
    telemetry.inc("pipeline", "runs_traced")
    telemetry.set_gauge("pipeline", "stages", n)
    telemetry.set_gauge("pipeline", "microbatches", m)
    telemetry.set_gauge("pipeline", "bubble_steps_per_stage", n - 1)
    telemetry.set_gauge("pipeline", "bubble_fraction",
                        (n - 1) / total if total else 0.0)
    telemetry.observe("pipeline", "microbatches_per_run", float(m))
    x_microbatches = copy_to(x_microbatches, axis_name, mesh=mesh)
    # the masks are filled on the device (a copy from the host would wait
    # for the card)
    first, last = (torch.full((), flag, dtype=torch.bool,
                              device=x_microbatches.device)
                   for flag in (my == 0, my == n - 1))
    state = torch.zeros_like(x_microbatches[0])
    outputs = []
    for t in range(total):
        # stage 0 takes microbatch t (clamped: the steps past M recompute
        # the last one and their results are never written)
        feed = x_microbatches[min(t, m - 1)]
        y = stage_fn(stage_params, torch.where(first, feed, state))
        if t >= n - 1:   # the microbatch t-(P-1) leaves the last stage
            outputs.append(torch.where(last, y, torch.zeros_like(y)))
        if t < total - 1:   # the last step's shift would carry nothing
            state = ppermute_ring(y, axis_name, 1, mesh=mesh)
    return reduce_from(torch.stack(outputs), axis_name, mesh=mesh)


def make_pipeline(mesh: Mesh, stage_fn: Callable, *,
                  axis_name: str = "pp") -> Callable:
    """``run(params_stacked, x_mb) -> outputs``: :func:`pipeline_spmd`
    over ``mesh`` with the stage parameters stacked on a leading stage
    axis (a pytree of tensors ``[P, ...]``; this rank takes its stage's
    at its pp index), wrapped in the ``pipeline.run`` span tagged with
    ``stages``, ``microbatches`` and ``tokens`` (M·mb·T of ``x_mb [M,
    mb, T, ...]``)."""
    n_stages = mesh.axis_size(axis_name)
    my = mesh.axis_rank(axis_name)

    def local(p: torch.Tensor) -> torch.Tensor:
        if p.shape[0] != n_stages:
            raise DMLCError(f"stage parameters of leading dim {p.shape[0]} "
                            f"on {n_stages} stages")
        return p[my]

    def run(params_stacked, x_mb: torch.Tensor) -> torch.Tensor:
        tokens = 1
        for d in x_mb.shape[:3]:
            tokens *= int(d)
        with telemetry.span("pipeline.run", stage="pipeline",
                            args={"stages": n_stages,
                                  "microbatches": int(x_mb.shape[0]),
                                  "tokens": tokens}):
            return pipeline_spmd(stage_fn, pytree.tree_map(local,
                                                           params_stacked),
                                 x_mb, mesh=mesh, axis_name=axis_name)

    return run
