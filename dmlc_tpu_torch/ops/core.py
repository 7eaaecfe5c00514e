"""Shard-aware core ops (port of ``dmlc_tpu/ops/core.py``).

Every op that touches a sharded dimension takes a ``ShardAxes`` naming
the mesh axes (None = unsharded) and the :class:`~..parallel.Mesh` they
live on; with ``ShardAxes()`` each computes exactly what the one-card
model computes.  The tensor-parallel branches (vocab-sharded embedding
and cross entropy, the row-parallel FFN's reduction) combine partial
results with ``reduce_from`` (all-reduce forward, identity backward) and
take replicated inputs into sharded compute with ``copy_to`` (identity
forward, all-reduce backward), the transposes the reference gets from
shard_map's varying-axes types.  Precision follows the JAX ops exactly:
statistics in float32, results cast back to the input's dtype at the
same points.

SwiGLU's hidden activation ``h = a * silu(b)`` is the custom op
``dmlc_tpu_torch::mlp_act``, so that a selective-checkpoint policy can
name it (the ``save_flash_mlp`` remat policy of ``models/transformer.py``)
as the reference's ``checkpoint_name(h, "mlp_act")`` does; a bare
``aten.mul`` could not be told apart from the block's other products.
Its forward and backward run the same aten calls autograd ran before,
so the numbers are those of the plain expression.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce, copy_to, reduce_from
from ..telemetry import compute

__all__ = ["ShardAxes", "pmax_const", "rms_norm", "rope", "embed_lookup",
           "softmax_xent", "swiglu_ffn", "mlp_act"]


@dataclasses.dataclass(frozen=True)
class ShardAxes:
    """Mesh axis names for each parallelism flavour (None = unsharded)."""

    tp: Optional[str] = None  # tensor: heads / ffn hidden / vocab
    sp: Optional[str] = None  # sequence: ring attention blocks
    ep: Optional[str] = None  # expert: MoE expert shards
    pp: Optional[str] = None  # pipeline: layer stages
    dp: Optional[str] = None  # data: batch shards (grad reduction)


def pmax_const(x: torch.Tensor, axis, *, mesh) -> torch.Tensor:
    """The max over ``axis`` with a zero gradient (the reference's
    ``_pmax_const``: it only stabilises a softmax, whose gradient does
    not depend on it)."""
    return all_reduce(x.detach(), axis, "max", mesh=mesh)


def _in_shard(ids: torch.Tensor, n_local: int, axis, mesh):
    """``(safe local index, in-shard mask)`` of global ``ids`` against
    this rank's block of ``n_local`` along ``axis``."""
    local = ids - mesh.axis_rank(axis) * n_local
    inside = (local >= 0) & (local < n_local)
    return local.clamp(0, n_local - 1), inside


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm; casts back to x's dtype BEFORE multiplying by ``scale``
    (in bf16 the order changes the result, and the reference does it
    this way)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_angles(positions: torch.Tensor, half: int,
                theta: float = 10000.0) -> torch.Tensor:
    """``positions[..., None] * freqs`` in float32, freqs =
    theta ** (-arange(half) / half)."""
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    return positions.float()[..., None] * freqs


def rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the halves ``[x1, x2]`` of the last dim (not interleaved
    pairs) by ``angles`` broadcast against x; the product is float32 and
    is cast back to x's dtype."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding.  x: [B, T, H, D], positions: [T]."""
    ang = rope_angles(positions, x.shape[-1] // 2, theta)      # [T, half]
    return rotate(x, ang[None, :, None, :])


def embed_lookup(embed: torch.Tensor, ids: torch.Tensor,
                 axes: ShardAxes = ShardAxes(), mesh=None) -> torch.Tensor:
    """Embedding rows for ``ids`` (any shape) → [..., E].  With
    ``axes.tp`` the table is this rank's vocab shard ``[V/tp, E]``: rows
    of other shards are zeros, then summed over tp."""
    if axes.tp is None:
        return F.embedding(ids, embed)
    safe, inside = _in_shard(ids, embed.shape[0], axes.tp, mesh)
    emb = F.embedding(safe, embed)
    emb = torch.where(inside[..., None], emb, torch.zeros_like(emb))
    return reduce_from(emb, axes.tp, mesh=mesh)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 axes: ShardAxes = ShardAxes(), mesh=None) -> torch.Tensor:
    """Per-token cross entropy in float32.  logits: [..., V] (with
    ``axes.tp`` this rank's vocab shard [..., V/tp]); labels: [...]
    global ids; the result is replicated over tp.  The max only
    stabilises the exp and is detached, as the reference's
    ``lax.stop_gradient`` does: the gradient is the softmax either way,
    and no ``amax`` backward (which splits ties) runs."""
    logits = logits.float()
    m = logits.amax(dim=-1).detach()
    if axes.tp is not None:
        m = pmax_const(m, axes.tp, mesh=mesh)
    se = torch.exp(logits - m[..., None]).sum(dim=-1)
    if axes.tp is not None:
        se = reduce_from(se, axes.tp, mesh=mesh)
    lse = torch.log(se) + m
    if axes.tp is None:
        correct = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        safe, inside = _in_shard(labels.long(), logits.shape[-1], axes.tp,
                                 mesh)
        c = torch.gather(logits, -1, safe[..., None])[..., 0]
        correct = reduce_from(torch.where(inside, c, torch.zeros_like(c)),
                              axes.tp, mesh=mesh)
    return lse - correct


@torch.library.custom_op("dmlc_tpu_torch::mlp_act", mutates_args=())
def mlp_act(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SwiGLU's hidden activation ``a * silu(b)`` (the reference's
    ``mlp_act``)."""
    return a * F.silu(b)


@mlp_act.register_fake
def _mlp_act_fake(a, b):
    return torch.empty_like(a)


def _mlp_act_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _mlp_act_backward(ctx, g):
    # MulBackward's and SiluBackward's own products, in their order
    a, b = ctx.saved_tensors
    return g * F.silu(b), torch.ops.aten.silu_backward(g * a, b)


mlp_act.register_autograd(_mlp_act_backward, setup_context=_mlp_act_setup)
# elementwise work: no FLOPs in the cost pass, as for aten's elementwise
# ops (the peak rates the roofline divides by are the tensor cores')
compute.register_flops("dmlc_tpu_torch::mlp_act",
                       lambda args, kwargs, out: 0.0)


def swiglu_ffn(x: torch.Tensor, w_in: torch.Tensor, w_gate: torch.Tensor,
               w_out: torch.Tensor, axes: ShardAxes = ShardAxes(), *,
               reduce: bool = True, mesh=None) -> torch.Tensor:
    """SwiGLU FFN.  w_in/w_gate: [E, F]; w_out: [F, E] (or a leading
    expert dim on all four: ``[X, C, E]`` against ``[X, E, F]``).

    With ``axes.tp`` the weights are megatron shards (columns of
    w_in/w_gate, rows of w_out) and the output a partial sum over tp:
    ``reduce`` (default) takes the replicated ``x`` in with ``copy_to``
    and sums the output with ``reduce_from``; ``reduce=False`` leaves
    both to the caller, which combines several partial sums in one
    reduction (the MoE)."""
    reduce = reduce and axes.tp is not None
    if reduce:
        x = copy_to(x, axes.tp, mesh=mesh)
    y = mlp_act(x @ w_in, x @ w_gate) @ w_out
    return reduce_from(y, axes.tp, mesh=mesh) if reduce else y
