"""Weights and train state to and from the JAX package's pytrees.

``params_from_jax`` takes the tree ``dmlc_tpu.models.transformer.
init_params`` builds (after ``jax.tree.map(np.asarray, ...)``): blocks
stacked ``[S, L/S, ...]``, every leaf a numpy array.  ``params_to_jax``
is its inverse.  ``shard_params_from_jax`` slices the same global tree
to one rank's shards on a mesh (its pp stage's layers, then
``PARAM_SPECS``; ``params_from_jax`` is its world-1 case), and
``gather_params`` rebuilds a mesh model's global parameters (or
gradients) in that tree's layout, blocks stacked ``[P, L/P, ...]``.
Neither needs jax nor the JAX package.  bfloat16
leaves are ``ml_dtypes``' bfloat16 on the numpy side, which
``torch.from_numpy`` refuses; they go through their uint16 bits instead,
so both directions are bit-exact.

``train_state_to_jax`` / ``train_state_from_jax`` carry the whole train
state in the tree the JAX example checkpoints, ``{"params": ..., "opt":
optax.adamw's state}``, with torch tensors as leaves (bfloat16 stays
torch's, no numpy on the way): the AdamW moments are optax's
``ScaleByAdamState.mu``/``.nu`` and torch's per-parameter ``step`` its
``count``.  On a mesh model they carry this rank's shards, the moments
shaped as the shards are, and ``state_specs`` gives each leaf's
``PartitionSpec`` as the reference's manifest writes it, so that
``checkpoint.sharded.save_pytree(..., mesh=, specs=)`` writes the
reference's sharded layout.
"""

from __future__ import annotations

import re
from collections import namedtuple
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..base import DMLCError
from ..checkpoint.sharded import flatten_with_path
from ..parallel.collectives import all_gather
from ..parallel.mesh import AXIS_PP, Mesh
from .transformer import (PARAM_SPEC_TREE, PARAM_SPECS, Transformer,
                          TransformerConfig)

__all__ = ["params_from_jax", "params_to_jax", "shard_params_from_jax",
           "gather_params", "tensor_from_numpy", "state_specs",
           "ScaleByAdamState", "train_state_to_jax", "train_state_from_jax"]

#: optax's ``ScaleByAdamState`` as a named tuple: its fields are the
#: tree's leaves (``['opt'][0].count``, ``.mu[...]``, ``.nu[...]``)
ScaleByAdamState = namedtuple("ScaleByAdamState", "count mu nu")

_BLOCK_LEAVES = ("ln1", "ln2", "wq", "wk", "wv", "wo", "gate", "w_in",
                 "w_gate", "w_out")


def tensor_from_numpy(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU numpy copy; bfloat16 becomes ``ml_dtypes.bfloat16`` with the
    same bits (imported here: only a bfloat16 tensor needs it)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _shard(t: torch.Tensor, name: str, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's block of the global leaf ``t`` by ``PARAM_SPECS``."""
    for dim, axis in PARAM_SPECS[name] if mesh is not None else ():
        t = t.chunk(mesh.axis_size(axis), dim=dim)[mesh.axis_rank(axis)]
    return t


@torch.no_grad()
def shard_params_from_jax(tree: Mapping, cfg: TransformerConfig,
                          mesh: Optional[Mesh], device=None) -> Transformer:
    """A :class:`Transformer` on ``mesh`` holding this rank's shards of
    the JAX tree's global weights (numpy or torch leaves; blocks stacked
    ``[S, L/S, ...]`` for any S, as ``init_params(key, cfg, n_stages=S)``
    builds them), in the config's dtype, on ``device`` (default: the
    mesh's device, else the CUDA card; no card raises): its pp stage's
    layers, and of each its experts and tp shards.  ``mesh=None`` loads
    every weight whole."""
    model = Transformer(cfg, device=device, mesh=mesh)

    def as_tensor(x) -> torch.Tensor:
        return x if isinstance(x, torch.Tensor) else tensor_from_numpy(x)

    def put(dst: torch.Tensor, src, name: str) -> None:
        t = _shard(as_tensor(src), name, mesh)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(t.to(dst.dtype))

    for name in ("embed", "unembed", "ln_f"):
        put(getattr(model, name), tree[name], name)
    blocks = tree["blocks"]
    first = 0 if mesh is None else \
        mesh.axis_rank(AXIS_PP) * len(model.layers)
    for name in _BLOCK_LEAVES:
        stacked = blocks[name]
        flat = stacked.reshape((cfg.n_layers,) + tuple(stacked.shape[2:]))
        for li, layer in enumerate(model.layers):
            put(getattr(layer, name), flat[first + li], name)
    return model


def params_from_jax(tree: Mapping, cfg: TransformerConfig,
                    device=None) -> Transformer:
    """A :class:`Transformer` holding the JAX tree's weights, in the
    config's dtype, on ``device`` (default: the CUDA card; no card
    raises): :func:`shard_params_from_jax` at world 1."""
    return shard_params_from_jax(tree, cfg, None, device)


@torch.no_grad()
def gather_params(model: Transformer, mesh: Optional[Mesh] = None,
                  grads: bool = False) -> Dict:
    """The global parameters (``grads``: their gradients) of a mesh
    model, in the JAX tree's layout with blocks stacked ``[P, L/P,
    ...]`` (``[1, L, ...]`` off a pp mesh), every leaf a tensor on the
    model's device; the ep and tp shards are gathered over their axes
    and the stages over pp.  Every rank of the mesh calls it (the
    gathers are collective)."""
    mesh = mesh if mesh is not None else model.mesh

    def whole(p: torch.Tensor, name: str) -> torch.Tensor:
        t = p.grad if grads else p
        if t is None:
            raise DMLCError(f"{name} has no gradient")
        for dim, axis in PARAM_SPECS[name] if mesh is not None else ():
            t = all_gather(t, axis, mesh=mesh, gather_axis=dim)
        return t.detach()

    out = {name: whole(getattr(model, name), name)
           for name in ("embed", "unembed", "ln_f")}
    out["blocks"] = {}
    for name in _BLOCK_LEAVES:
        stage = torch.stack([whole(getattr(layer, name), name)
                             for layer in model.layers])
        out["blocks"][name] = (stage[None] if mesh is None else all_gather(
            stage, AXIS_PP, mesh=mesh, tiled=False))
    return out


def params_to_jax(model: Transformer, n_stages: int = 1) -> Dict:
    """The inverse of :func:`params_from_jax`: the JAX pytree layout with
    blocks stacked ``[S, L/S, ...]`` (``init_params`` :128-155), every
    leaf a numpy array in the parameter's dtype."""
    n_layers = model.cfg.n_layers
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} "
                         "stages")
    blocks = {}
    for name in _BLOCK_LEAVES:
        flat = np.stack([_to_numpy(getattr(layer, name))
                         for layer in model.layers])
        blocks[name] = flat.reshape((n_stages, n_layers // n_stages)
                                    + flat.shape[1:])
    return {"embed": _to_numpy(model.embed),
            "unembed": _to_numpy(model.unembed),
            "ln_f": _to_numpy(model.ln_f), "blocks": blocks}


def state_specs(tree) -> Dict[str, Optional[list]]:
    """``{leaf path: spec}`` of a params or train-state tree in the JAX
    layout (``train_state_to_jax``'s): each parameter leaf, and each of
    its AdamW moments, the reference's ``param_specs()`` spec as its
    checkpoint manifest writes it (``PARAM_SPEC_TREE``), any other leaf
    (the step count) replicated, ``[]``."""
    out = {}
    for path, _ in flatten_with_path(tree):
        name = re.search(r"\['(\w+)'\]$", path)
        table = PARAM_SPEC_TREE["blocks"] if "['blocks']" in path \
            else PARAM_SPEC_TREE
        spec = table.get(name.group(1)) if name else None
        out[path] = list(spec) if isinstance(spec, list) else []
    return out


def _param_leaves(model: Transformer):
    """``(tree path, [tensor per layer] or tensor)`` of every parameter,
    in the JAX tree's layout."""
    out = [(("embed",), model.embed), (("unembed",), model.unembed),
           (("ln_f",), model.ln_f)]
    for name in _BLOCK_LEAVES:
        out.append((("blocks", name),
                    [getattr(layer, name) for layer in model.layers]))
    return out


def _tree_set(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _stacked(tensors, device) -> torch.Tensor:
    """Per-layer tensors stacked ``[1, L, ...]`` (one pipeline stage) on
    ``device``, copied one layer at a time (no stack on the card)."""
    out = torch.empty((1, len(tensors)) + tuple(tensors[0].shape),
                      dtype=tensors[0].dtype, device=device)
    if out.device.type != "meta":
        for i, t in enumerate(tensors):
            out[0, i].copy_(t.detach())
    return out


def _leaf(t: torch.Tensor, device) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    if out.device.type != "meta":
        out.copy_(t.detach())
    return out


@torch.no_grad()
def train_state_to_jax(model: Transformer, optimizer: torch.optim.AdamW,
                       device="cpu") -> Dict:
    """``{"params", "opt"}`` as the JAX example's train state: params in
    ``params_to_jax``'s layout (one stage: on a mesh model, this rank's
    shards with its stage's layers ``[1, L/P, ...]``, the block of the
    global ``[P, L/P, ...]`` that ``state_specs`` names) and ``opt =
    (ScaleByAdamState(count, mu, nu),)`` (optax.adamw's state, the
    moments shaped as the shards; its other two entries hold no leaves),
    every leaf a tensor on ``device``.  A
    parameter without optimizer state (no step taken) has zero moments,
    as ``optax.adamw(...).init``.  ``device="meta"`` gives the structure
    alone, a restore template."""
    params, mu, nu = {}, {}, {}
    steps = set()

    def moment(p: torch.Tensor, key: str) -> torch.Tensor:
        st = optimizer.state.get(p, {})
        if "step" in st:
            steps.add(int(st["step"]))
        return st[key] if key in st else torch.zeros_like(p)

    for path, ref in _param_leaves(model):
        for tree, get in ((params, lambda p: p),
                          (mu, lambda p: moment(p, "exp_avg")),
                          (nu, lambda p: moment(p, "exp_avg_sq"))):
            if isinstance(ref, list):
                leaf = _stacked([get(p) for p in ref], device)
            else:
                leaf = _leaf(get(ref), device)
            _tree_set(tree, path, leaf)
    if len(steps) > 1:
        raise DMLCError(f"optimizer parameters are at different steps "
                        f"{sorted(steps)}; optax keeps one count")
    count = torch.full((), steps.pop() if steps else 0, dtype=torch.int32,
                       device=device)
    return {"params": params, "opt": (ScaleByAdamState(count, mu, nu),)}


@torch.no_grad()
def train_state_from_jax(tree: Mapping, model: Transformer,
                         optimizer: torch.optim.AdamW) -> None:
    """Load a JAX-layout train state (``train_state_to_jax``'s tree, a
    restored checkpoint, or the JAX package's own with numpy leaves) into
    ``model`` and ``optimizer`` in place."""
    def as_tensor(x) -> torch.Tensor:
        return x if isinstance(x, torch.Tensor) else tensor_from_numpy(x)

    adam = tree["opt"][0]
    count = int(as_tensor(adam.count))
    for path, ref in _param_leaves(model):
        leaves = [as_tensor(_tree_get(t, path))
                  for t in (tree["params"], adam.mu, adam.nu)]
        params = ref if isinstance(ref, list) else [ref]
        if isinstance(ref, list):
            leaves = [x.reshape((len(ref),) + tuple(x.shape[2:]))
                      for x in leaves]
        for i, p in enumerate(params):
            src = [x[i] if isinstance(ref, list) else x for x in leaves]
            if tuple(src[0].shape) != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)}: shape "
                                 f"{tuple(src[0].shape)} != {tuple(p.shape)}")
            p.copy_(src[0])
            if count == 0:
                optimizer.state.pop(p, None)
                continue
            optimizer.state[p] = {
                # torch keeps a non-capturable AdamW's step as a float32
                # CPU scalar; optax's count is that number as int32
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": src[1].to(p.device, p.dtype, copy=True),
                "exp_avg_sq": src[2].to(p.device, p.dtype, copy=True)}
