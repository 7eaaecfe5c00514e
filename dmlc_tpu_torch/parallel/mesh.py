"""The device mesh over ``torch.distributed`` (port of
``dmlc_tpu/parallel/mesh.py``).

The reference names five mesh axes over a ``jax.sharding.Mesh``:

  dp — data parallelism       (batch dimension; gradient all-reduce)
  pp — pipeline parallelism   (layer stages)
  sp — sequence parallelism   (ring attention; KV rotation)
  tp — tensor parallelism     (heads / FFN hidden / vocab shards)
  ep — expert parallelism     (MoE experts)

Here a rank of the process group holds one coordinate on each axis,
laid out as the reference lays out its device array (``MESH_AXES``
order, ``pp`` outermost, ``tp`` innermost), and each axis of size > 1
gets one process group per line of ranks along it, plus one for the
(dp, sp) plane that gradients are reduced over and one for the (ep,
tp) plane that the MoE's expert outputs are summed over.  ``torch.distributed``
``new_group`` is used rather than ``DeviceMesh``, which binds one card
to each rank: ranks that share a card (gloo) form a mesh too.

The InputSplit contract maps onto the mesh as in the reference:
``part_index`` = flattened (dp, sp) coordinate, ``num_parts`` =
dp·sp: pp, ep and tp carry no data."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..base import DMLCError, resolve_device

__all__ = ["AXIS_DP", "AXIS_PP", "AXIS_SP", "AXIS_TP", "AXIS_EP",
           "MESH_AXES", "DATA_AXES", "MOE_AXES", "factorize_devices",
           "MeshConfig", "Mesh", "build_mesh", "mesh_config"]

AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_SP = "sp"
AXIS_TP = "tp"
AXIS_EP = "ep"

#: Canonical axis order: pp outermost, tp innermost (the reference's).
MESH_AXES: Tuple[str, ...] = (AXIS_PP, AXIS_DP, AXIS_SP, AXIS_EP, AXIS_TP)
#: The data-bearing axes: the batch is sharded over them and the
#: gradients reduced over them.
DATA_AXES: Tuple[str, ...] = (AXIS_DP, AXIS_SP)
#: The axes the experts are sharded over: the MoE sums its outputs over
#: both in one reduction.
MOE_AXES: Tuple[str, ...] = (AXIS_EP, AXIS_TP)


def _largest_pow2_divisor(n: int, cap: int) -> int:
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d


def factorize_devices(
    n_devices: int,
    *,
    pp: Optional[int] = None,
    dp: Optional[int] = None,
    sp: Optional[int] = None,
    ep: Optional[int] = None,
    tp: Optional[int] = None,
) -> Dict[str, int]:
    """Pick mesh-axis sizes whose product is ``n_devices`` (the
    reference's rule): fixed axes are honoured exactly; free axes are
    assigned greedily in the order tp, sp, pp (factors of 2, capped at
    2 each), ep defaults to 1 and dp takes the remainder."""
    fixed = {AXIS_PP: pp, AXIS_DP: dp, AXIS_SP: sp, AXIS_EP: ep, AXIS_TP: tp}
    rem = n_devices
    for name, size in fixed.items():
        if size is not None:
            if rem % size != 0:
                raise ValueError(
                    f"axis {name}={size} does not divide remaining {rem} devices"
                )
            rem //= size
    for name, cap in ((AXIS_TP, 2), (AXIS_SP, 2), (AXIS_PP, 2)):
        if fixed[name] is None:
            d = _largest_pow2_divisor(rem, cap)
            fixed[name] = d
            rem //= d
    if fixed[AXIS_EP] is None:
        fixed[AXIS_EP] = 1
    if fixed[AXIS_DP] is None:
        fixed[AXIS_DP] = rem
        rem = 1
    if rem != 1:
        raise ValueError(
            f"mesh {fixed} does not use all {n_devices} devices (left={rem})"
        )
    return {name: int(fixed[name]) for name in MESH_AXES}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape (the reference's)."""

    shape: Dict[str, int]

    @property
    def n_devices(self) -> int:
        return int(math.prod(self.shape.values()))

    def axis_size(self, name: str) -> int:
        return self.shape[name]

    @property
    def data_parts(self) -> int:
        """num_parts for the InputSplit contract (data-bearing axes)."""
        return self.shape[AXIS_DP] * self.shape[AXIS_SP]

    def part_index(self, coords: Dict[str, int]) -> int:
        """Flattened (dp, sp) coordinate → InputSplit part_index."""
        return coords[AXIS_DP] * self.shape[AXIS_SP] + coords[AXIS_SP]


AxisName = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a pp × dp × sp × ep × tp mesh: its
    coordinate on each axis, the process group of each axis it shares
    with other ranks (None for an axis of size 1), the (dp, sp) and (ep,
    tp) groups, and the device its tensors live on."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    rank: int
    device: torch.device
    groups: Dict[AxisName, object]

    @property
    def world(self) -> int:
        return int(math.prod(self.shape.values()))

    @property
    def config(self) -> MeshConfig:
        return MeshConfig(shape=dict(self.shape))

    def _axes(self, axis: AxisName) -> Tuple[str, ...]:
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in self.shape:
                raise DMLCError(f"unknown mesh axis {a!r}")
        return tuple(a for a in MESH_AXES if a in names)

    def axis_size(self, axis: AxisName) -> int:
        return int(math.prod(self.shape[a] for a in self._axes(axis)))

    def axis_rank(self, axis: AxisName) -> int:
        """This rank's index along ``axis`` (row-major over several)."""
        idx = 0
        for a in self._axes(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axis: AxisName):
        """The process group along ``axis``; None where it has one rank.
        A tuple of axes names the group over all of them; the mesh builds
        each single axis and the (dp, sp) and (ep, tp) planes.  An axis of
        size 1 in the tuple drops out."""
        live = tuple(a for a in self._axes(axis) if self.shape[a] > 1)
        if not live:
            return None
        key = live[0] if len(live) == 1 else live
        if key not in self.groups:
            raise DMLCError(f"the mesh has no process group over {key}")
        return self.groups[key]


def _rank_grid(shape: Dict[str, int]) -> np.ndarray:
    return np.arange(int(math.prod(shape.values()))).reshape(
        [shape[a] for a in MESH_AXES])


def _lines(grid: np.ndarray, axes: Tuple[str, ...]):
    """Every set of ranks that differ only along ``axes``, each in
    row-major order over those axes."""
    dims = [MESH_AXES.index(a) for a in axes]
    rest = [i for i in range(grid.ndim) if i not in dims]
    moved = np.transpose(grid, rest + dims)
    return moved.reshape(-1, int(math.prod(grid.shape[d] for d in dims)))


def build_mesh(world: Optional[int] = None, *, dp: Optional[int] = None,
               sp: Optional[int] = None, tp: Optional[int] = None,
               pp: Optional[int] = None, ep: Optional[int] = None,
               device=None) -> Mesh:
    """This rank's mesh over the default process group.

    ``world`` defaults to the process group's size (1 when there is
    none).  Axis sizes may be pinned; the rest are factorized by
    :func:`factorize_devices` as the reference's ``build_mesh`` does
    (free axes take tp, then sp, then pp, ep stays 1 unless given, dp
    the rest: world 8 unpinned is pp2 x sp2 x tp2).  Every rank calls
    this with the same arguments: it creates the axis groups
    collectively.  A mesh of world 1 makes no group, and every
    collective on it is the identity.  ``device`` defaults to the card
    (``rank % device_count`` where the host has several)."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    pg_world = dist.get_world_size() if initialized else 1
    if world is None:
        world = pg_world
    if world != pg_world:
        raise DMLCError(f"a mesh of {world} ranks over a process group of "
                        f"{pg_world} (initialize_distributed first)")
    shape = factorize_devices(world, dp=dp, sp=sp, tp=tp, pp=pp, ep=ep)
    rank = dist.get_rank() if initialized else 0
    grid = _rank_grid(shape)
    coords = {a: int(c) for a, c in zip(
        MESH_AXES, np.unravel_index(rank, grid.shape))}
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", rank % torch.cuda.device_count())
    groups: Dict[AxisName, object] = {}
    # every rank creates every group, in one order (new_group is
    # collective over the default group)
    plans = [(a,) for a in MESH_AXES] + [DATA_AXES, MOE_AXES]
    for axes in plans:
        live = tuple(a for a in axes if shape[a] > 1)
        if len(live) != len(axes) or world == 1:
            continue
        for line in _lines(grid, axes):
            pg = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axes[0] if len(axes) == 1 else axes] = pg
    return Mesh(shape=shape, coords=coords, rank=rank,
                device=resolve_device(device), groups=groups)


def mesh_config(mesh: Mesh) -> MeshConfig:
    return mesh.config
