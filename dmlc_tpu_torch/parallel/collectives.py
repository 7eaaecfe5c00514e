"""Named collectives over a :class:`~.mesh.Mesh` (port of
``dmlc_tpu/parallel/collectives.py``), and the bridge from the tracker's
environment to ``torch.distributed``.

Each op is keyed by an axis name of the mesh (or a tuple of names) and
runs over that axis's process group; on an axis of one rank it is the
identity.  ``all_reduce``, ``all_gather``, ``reduce_scatter``,
``broadcast``, ``broadcast_object`` and ``barrier_sum`` are not
differentiable.  The ops on
the model's path are, each through an explicit ``autograd.Function``
(JAX derives the same transposes from shard_map's varying-axes types):

* ``ppermute_ring``: a shift's transpose is the opposite shift (the
  ring attention's K/V rotation over sp, the pipeline's stage shift
  over pp);
* ``all_to_all``: its transpose is the inverse all-to-all;
* ``copy_to`` (identity forward, all-reduce backward) and
  ``reduce_from`` (all-reduce forward, identity backward): the pair
  placed where a replicated value meets sharded compute and where
  partial sums are combined — over tp, over the (ep, tp) plane for the
  MoE (a tuple of axes, an axis of size 1 dropping out, as the
  reference's ``reduce_axes`` filter), and over pp around the pipeline;
* ``mean_from``: the loss mean over the data axes, whose transpose
  hands each rank ``g / n`` (the parameters' gradients are then summed
  over the same axes, as the reference's pmean transpose does);
* ``pmax_const`` (``ops/core.py``) is a max with a zero gradient.

Telemetry as the reference's ``_note``: ``collective`` counters
``<op>_calls`` / ``<op>_bytes`` and the ``<op>_bytes_per_call``
histogram, under the same names; here they count calls, not traces.

Ranks that share one card use gloo with CUDA tensors.  gloo's
point-to-point does not take a CUDA tensor (its TCP transport reads the
device pointer as host memory: "writev: Bad address", torch 2.11 on an
H100, recorded by ``chip_smoke.py``'s ``mesh`` phase), so on gloo a
shift (the ring's and the pipeline's) copies through pinned host memory
explicitly and counts the bytes (``collective/ppermute_staged_bytes``);
the other ops hand
CUDA tensors to gloo as they are.  ``broadcast_object`` (a sharded
serving engine's plan) pickles into host memory and stays there on gloo;
on nccl it goes through the card.  No op switches backends."""

from __future__ import annotations

import datetime
import pickle
import sys
from typing import Optional, Tuple

import torch

from .. import telemetry
from ..base import DMLCError, get_env
from .mesh import Mesh

__all__ = ["axis_size", "axis_rank", "all_reduce", "all_gather",
           "reduce_scatter", "broadcast", "broadcast_object",
           "ppermute_ring", "all_to_all",
           "barrier_sum", "copy_to", "reduce_from", "mean_from",
           "process_rank_world", "initialize_distributed", "pick_backend"]

# payload-size buckets for collective byte histograms: 64 B .. 8 GB
BYTE_BOUNDS = tuple(64.0 * 2.0 ** i for i in range(28))


def _note(op: str, x: torch.Tensor, axis) -> None:
    nbytes = float(x.numel() * x.element_size())
    telemetry.inc("collective", f"{op}_calls")
    telemetry.inc("collective", f"{op}_bytes", nbytes)
    telemetry.observe("collective", f"{op}_bytes_per_call", nbytes,
                      bounds=BYTE_BOUNDS)


def axis_size(axis, mesh: Mesh) -> int:
    """World size along ``axis``."""
    return mesh.axis_size(axis)


def axis_rank(axis, mesh: Mesh) -> int:
    """This rank's index along ``axis``."""
    return mesh.axis_rank(axis)


_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "mean": "SUM"}


def _all_reduce_(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of a contiguous ``x`` over ``group``."""
    import torch.distributed as dist

    red = getattr(dist.ReduceOp, _REDUCE_OPS[op])
    dist.all_reduce(x, red, group=group)
    if op == "mean":
        x.div_(dist.get_world_size(group))
    return x


def all_reduce(x: torch.Tensor, axis, op: str = "sum", *,
               mesh: Mesh) -> torch.Tensor:
    """All-reduce over a mesh axis, op in {sum, max, min, mean}; a new
    tensor (not differentiable)."""
    _note("all_reduce", x, axis)
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduce op: {op!r}")
    out = x.detach().clone(memory_format=torch.contiguous_format)
    group = mesh.group(axis)
    return out if group is None else _all_reduce_(out, group, op)


def all_gather(x: torch.Tensor, axis, *, mesh: Mesh, tiled: bool = True,
               gather_axis: int = 0) -> torch.Tensor:
    """Gather the shards along ``axis`` in rank order: concatenated on
    ``gather_axis`` (``tiled``) or stacked on a new one there."""
    import torch.distributed as dist

    _note("all_gather", x, axis)
    group = mesh.group(axis)
    x = x.detach()
    if group is None:
        return x.clone() if tiled else x.unsqueeze(gather_axis).clone()
    n = dist.get_world_size(group)
    src = x.contiguous().reshape((1,) + tuple(x.shape))
    out = src.new_empty((n,) + tuple(x.shape))
    dist.all_gather_into_tensor(out, src, group=group)
    parts = list(out.unbind(0))
    return (torch.cat(parts, dim=gather_axis) if tiled
            else torch.stack(parts, dim=gather_axis))


def reduce_scatter(x: torch.Tensor, axis, *, mesh: Mesh,
                   scatter_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Sum over ``axis``, keeping this rank's shard of ``scatter_axis``
    (``tiled``: a block of size/n; else the axis has size n and the
    rank's entry is taken)."""
    import torch.distributed as dist

    _note("reduce_scatter", x, axis)
    group = mesh.group(axis)
    x = x.detach()
    if group is None:
        return x.clone() if tiled else x.select(scatter_axis, 0).clone()
    n = dist.get_world_size(group)
    if x.shape[scatter_axis] % n:
        raise DMLCError(f"reduce_scatter: dim {scatter_axis} of "
                        f"{tuple(x.shape)} does not split {n} ways")
    src = torch.stack(x.chunk(n, dim=scatter_axis)).contiguous()
    out = src.new_empty((1,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    out = out[0]
    return out if tiled else out.squeeze(scatter_axis)


def broadcast(x: torch.Tensor, axis, root: int = 0, *,
              mesh: Mesh) -> torch.Tensor:
    """``root``'s value (an index along ``axis``) on every rank."""
    import torch.distributed as dist

    _note("broadcast", x, axis)
    group = mesh.group(axis)
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if group is None:
        return out
    dist.broadcast(out, dist.get_global_rank(group, root), group=group)
    return out


def broadcast_object(obj=None, root: int = 0, *, mesh: Mesh):
    """``root``'s picklable ``obj`` on every rank of ``mesh`` (the whole
    process group; ``root`` a global rank; other ranks pass nothing).
    Two broadcasts, the pickle's length and then its bytes, each counted
    as a ``broadcast`` call; the bytes live in host memory, and go
    through the card only where the group's backend is nccl.  The ranks
    are one job, so the pickle is the job's own."""
    import torch.distributed as dist

    if mesh.world == 1:
        return obj
    dev = mesh.device if dist.get_backend() == "nccl" else torch.device("cpu")
    me = dist.get_rank()
    size = torch.zeros(1, dtype=torch.int64)
    if me == root:
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                   dtype=torch.uint8)
        size[0] = payload.numel()
    size = size.to(dev)
    _note("broadcast", size, None)
    dist.broadcast(size, root)
    if me != root:
        payload = torch.empty(int(size.item()), dtype=torch.uint8)
    payload = payload.to(dev)
    _note("broadcast", payload, None)
    dist.broadcast(payload, root)
    if me == root:
        return obj
    return pickle.loads(payload.cpu().numpy().tobytes())


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` places on along the group's ring
    and return what arrives from ``shift`` places back; on gloo a CUDA
    ``x`` goes through pinned host memory, counted."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    src = x.contiguous()
    staged = src.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        src = torch.empty(src.shape, dtype=src.dtype,
                          pin_memory=True).copy_(src)
        telemetry.inc("collective", "ppermute_staged_bytes",
                      float(src.numel() * src.element_size()))
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src,
                      dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device) if staged else out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def ppermute_ring(x: torch.Tensor, axis, shift: int = 1, *,
                  mesh: Mesh) -> torch.Tensor:
    """Rotate shards around the ring of ``axis``: rank i's ``x`` lands
    on rank (i + shift) mod n.  Differentiable (the opposite shift)."""
    _note("ppermute", x, axis)
    group = mesh.group(axis)
    if group is None or shift % mesh.axis_size(axis) == 0:
        return x
    return _PPermute.apply(x, group, shift)


def _a2a(x: torch.Tensor, group, split_axis: int,
         concat_axis: int) -> torch.Tensor:
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise DMLCError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                        f"does not split {n} ways")
    src = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return torch.cat(list(out.unbind(0)), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _a2a(g, group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, axis, *, split_axis: int, concat_axis: int,
               mesh: Mesh, tiled: bool = True) -> torch.Tensor:
    """Re-shard from ``split_axis`` to ``concat_axis`` across ``axis``:
    block j of ``split_axis`` goes to rank j, and the blocks received are
    concatenated on ``concat_axis`` in rank order (``lax.all_to_all``
    with ``tiled=True``, the only form the port has).  Differentiable
    (the inverse all-to-all)."""
    if not tiled:
        raise DMLCError("all_to_all: only tiled=True is ported")
    _note("all_to_all", x, axis)
    group = mesh.group(axis)
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def barrier_sum(axis, *, mesh: Mesh) -> int:
    """A synchronisation point: the sum of 1 over ``axis`` (its size)."""
    telemetry.inc("collective", "barrier_sum_calls")
    group = mesh.group(axis)
    if group is None:
        return 1
    one = torch.ones((), dtype=torch.int32, device=mesh.device)
    return int(_all_reduce_(one, group).item())


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.n = dist.get_world_size(group)
        return _all_reduce_(x.contiguous().clone(), group, "mean")

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def copy_to(x: torch.Tensor, axis, *, mesh: Mesh) -> torch.Tensor:
    """Identity forward, all-reduce (sum) backward over ``axis``: a value
    replicated over the axis entering sharded compute."""
    group = mesh.group(axis)
    if group is None:
        return x
    _note("all_reduce", x, axis)
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, axis, *, mesh: Mesh) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward over ``axis``: partial
    sums of the axis's shards combined into a replicated value."""
    group = mesh.group(axis)
    if group is None:
        return x
    _note("all_reduce", x, axis)
    return _ReduceFrom.apply(x, group)


def mean_from(x: torch.Tensor, axis, *, mesh: Mesh) -> torch.Tensor:
    """All-reduce (mean) forward over ``axis``; backward ``g / n`` to each
    rank."""
    group = mesh.group(axis)
    if group is None:
        return x
    _note("all_reduce", x, axis)
    return _MeanFrom.apply(x, group)


# ---------------------------------------------------------------------------
# Host-level (multi-process) surface
# ---------------------------------------------------------------------------

def process_rank_world() -> Tuple[int, int]:
    """(rank, world) of this process: the DMLC env contract first
    (DMLC_TASK_ID / DMLC_NUM_WORKER), then the process group's."""
    task_id = get_env("DMLC_TASK_ID", None, str)
    nworker = get_env("DMLC_NUM_WORKER", None, str)
    if task_id is not None and nworker is not None:
        return int(task_id), int(nworker)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def pick_backend(world: int) -> Tuple[str, str]:
    """``(backend, why)`` from the host's topology, before any group
    exists: "nccl" when each of the host's ranks has a card of its own,
    else "gloo" (ranks that share a card, or no card).  The host's ranks
    are ``LOCAL_WORLD_SIZE`` where set, else every rank of the job (the
    local launcher puts them all on one host)."""
    local = get_env("LOCAL_WORLD_SIZE", world, int)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards and cards >= local:
        return "nccl", f"{local} ranks on {cards} cards"
    if cards:
        return "gloo", f"{local} ranks share {cards} card(s)"
    return "gloo", "no card"


def initialize_distributed(coordinator: Optional[str] = None,
                           backend: Optional[str] = None,
                           timeout_s: Optional[float] = None
                           ) -> Optional[str]:
    """Bring up ``torch.distributed`` from the DMLC env contract and
    return the backend (None when single-process or already up).

    The coordinator is ``DMLC_JAX_COORD_URI:DMLC_JAX_COORD_PORT``, the
    port the tracker allocates beside its own socket, never the
    tracker's port; it becomes ``init_process_group(init_method=
    "tcp://uri:port")`` with rank and world from
    :func:`process_rank_world`.  ``backend=None`` picks it with
    :func:`pick_backend` and prints the choice."""
    import torch.distributed as dist

    rank, world = process_rank_world()
    if world <= 1 or dist.is_initialized():
        return None
    if coordinator is None:
        uri = (get_env("DMLC_JAX_COORD_URI", "")
               or get_env("DMLC_TRACKER_URI", "127.0.0.1"))
        port = get_env("DMLC_JAX_COORD_PORT", None, str)
        if port is None:
            raise RuntimeError(
                "DMLC_JAX_COORD_PORT is not set — this process was not "
                "launched by a tracker that allocates the distributed "
                "coordinator (dmlc-submit does); pass "
                "coordinator='host:port' explicitly")
        coordinator = f"{uri}:{port}"
    why = "given"
    if backend is None:
        backend, why = pick_backend(world)
    print(f"initialize_distributed: rank {rank}/{world} backend {backend} "
          f"({why}) at tcp://{coordinator}", file=sys.stderr, flush=True)
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            rank=rank, world_size=world, **kw)
    return backend
