"""Flagship decoder-only transformer LM: training, on one card or a
pp × dp × sp × ep × tp mesh, and serving.

Port of ``dmlc_tpu/models/transformer.py``: ``TransformerConfig``/
``flagship_config``/``count_params``/FLOP counts (:49-126, :420-428),
``init_params`` (:128-155) and ``param_specs`` (:158-177, as the tables
``PARAM_SPEC_TREE`` and ``PARAM_SPECS``), attention with its sp branch
(ring attention) and tp reduction (:180-202), the dense soft-gated MoE
FFN (:205-227) and the routed top-k one (:230-310), each with its ep
slice and its (ep, tp) reduction, the block and its per-block remat
under the three policies (:313-353), ``forward_local`` (:356-404:
positions from the sp rank, the pp stages through the SPMD pipeline,
the loss meaned over (dp, sp)) and ``unsharded_loss`` (:407,
``forward_local`` with ``ShardAxes()``), a train step with AdamW as
``make_train_step`` builds it with ``optax.adamw``, on one card or on a
mesh, with the fused or the bucketed (``overlap="device"``) gradient
reduction, with or without the global gradient norm (:761-850), and the
serving forwards ``forward_prefill`` / ``forward_prefill_last``
(:504-558), the gather decode path's ``forward_decode`` and
``forward_decode_spec`` (:561-687, attending a dense gathered cache
with plain products) and ``forward_decode_paged`` (:690-758), with
``decode_phase_flops`` (:431) for the compute ledger's phase split.
The serving forwards also run sharded (``axes=serving_axes(mesh)``, a
model built on any mesh, as the reference's engine runs its programs on
any mesh): heads over tp, a gathered batch's rows over dp (a routed FFN
still routes the whole batch), experts over ep, and over pp each stage
its own layers on the previous stage's output; replicated over sp.  See
:func:`forward_decode_spec`.  The train step is the
compute ledger's site ``train.step`` and drives the step ledger as the
reference's does (:852-887).

On a mesh (``Transformer(cfg, device, mesh)``) each rank holds the
shards ``PARAM_SPECS`` gives its coordinate: its pp stage's layers
(``L/P`` of them), heads over tp in ``wq``/``wk``/``wv``/``wo``, experts
over ep and ``d_ff`` over tp in ``w_in``/``w_gate``/``w_out``, vocab over
tp in ``embed``/``unembed``, norms and ``gate`` replicated.  The
collectives are explicit (``parallel.collectives``): ``copy_to`` where
a replicated activation meets a shard (the qkv projection, the FFN
input and its combine weights over (ep, tp), the unembedding, the
pipeline's input over pp), ``reduce_from`` where partial sums meet
(attention out, the FFN out over (ep, tp), the embedding, the cross
entropy's sums, the pipeline's outputs over pp), the ring's and the
pipeline's ``ppermute``, and ``mean_from`` over (dp, sp) for the loss;
the train step then sums every gradient over (dp, sp).

Each layer module keeps the JAX weight layouts (``wq [E, H, D]``,
``wo [H, D, E]``, ``w_in [X, E, F]``, ...) so weights convert one to one
(``models/convert.py``); the JAX pytree stacks blocks ``[S, L/S, ...]``
and this module lists them as ``L`` layers in the same order (on a pp
mesh, stage s's ``L/P``), which is also the layer index of the KV pool
``[L, n_blocks, block_size, H, D]``.

Attention goes through ``ops.flash_attention`` (training and prefill,
differentiable) and ``ops.paged_attention`` (decode), which launch the
CUDA kernels on a CUDA tensor and their plain versions on a CPU tensor;
``impl`` forces one of the two for comparisons and is never passed on
the training or serving path.  Parameters are trainable; the serving
forwards run under ``torch.inference_mode()`` (the engine's), so they
build no autograd graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import telemetry
from ..base import DMLCError, get_env, resolve_device
from ..ops.core import ShardAxes, embed_lookup, rms_norm, rope, \
    rope_angles, rotate, softmax_xent, swiglu_ffn
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_attention
from ..parallel.collectives import all_gather, all_reduce, broadcast, \
    copy_to, mean_from, ppermute_pair, reduce_from
from ..parallel.mesh import (AXIS_DP, AXIS_EP, AXIS_PP, AXIS_SP, AXIS_TP,
                             DATA_AXES, MESH_AXES, Mesh)
from ..parallel.overlap import DeviceBucketer
from ..parallel.pipeline import pipeline_spmd
from ..parallel.ring_attention import ring_attention

__all__ = ["TransformerConfig", "flagship_config", "count_params",
           "train_flops_per_token", "train_step_flops",
           "decode_flops_per_token", "decode_phase_flops",
           "PARAM_SPEC_TREE", "PARAM_SPECS",
           "SHARDED_AXES", "SERVING_AXES", "serving_axes",
           "check_serving_mesh",
           "Block", "Transformer", "init_params", "forward_local",
           "unsharded_loss", "adamw", "sync_gradients", "sharded_grad_norm",
           "make_train_step", "forward_prefill",
           "forward_prefill_last", "forward_decode", "forward_decode_spec",
           "forward_decode_paged"]

SHARDED_AXES = ShardAxes(tp=AXIS_TP, sp=AXIS_SP, ep=AXIS_EP, pp=AXIS_PP,
                         dp=AXIS_DP)
#: the axes the serving forwards shard over: heads, ``d_ff`` and vocab
#: over tp, a gathered decode batch's rows over dp, experts over ep,
#: layers over pp (an axis of one rank drops out); never sp, over which
#: serving is replicated (:func:`serving_axes`)
SERVING_AXES = ShardAxes(tp=AXIS_TP, dp=AXIS_DP, ep=AXIS_EP, pp=AXIS_PP)

#: ``param_specs()`` (:158-177) of the JAX tree's leaves (blocks stacked
#: ``[S, L/S, ...]``), each spec as the reference's checkpoint manifest
#: writes it (``_spec_to_json``): an axis or None per leading dim
PARAM_SPEC_TREE = {
    "embed": [AXIS_TP, None], "unembed": [None, AXIS_TP], "ln_f": [],
    "blocks": {
        "ln1": [AXIS_PP], "ln2": [AXIS_PP], "gate": [AXIS_PP],
        "wq": [AXIS_PP, None, None, AXIS_TP, None],
        "wk": [AXIS_PP, None, None, AXIS_TP, None],
        "wv": [AXIS_PP, None, None, AXIS_TP, None],
        "wo": [AXIS_PP, None, AXIS_TP, None, None],
        "w_in": [AXIS_PP, None, AXIS_EP, None, AXIS_TP],
        "w_gate": [AXIS_PP, None, AXIS_EP, None, AXIS_TP],
        "w_out": [AXIS_PP, None, AXIS_EP, AXIS_TP, None],
    },
}


def _per_layer(spec, lead: int):
    return tuple((i - lead, a) for i, a in enumerate(spec)
                 if a is not None and i >= lead)


#: the same per leaf of the port's per-layer layout (a block leaf
#: without its ``[S, L/S]`` stage dims, which pp shards by holding the
#: stage's layers): the ``(dimension, axis)`` pairs each leaf is sharded
#: by; replicated leaves have none
PARAM_SPECS = {
    **{k: _per_layer(v, 0) for k, v in PARAM_SPEC_TREE.items()
       if k != "blocks"},
    **{k: _per_layer(v, 2) for k, v in PARAM_SPEC_TREE["blocks"].items()},
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_REMAT_POLICIES = ("full", "save_flash", "save_flash_mlp")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    head_dim: int = 16
    d_ff: int = 128
    n_layers: int = 4          # in all; a pp mesh holds L/P a stage
    n_experts: int = 2         # 1 = dense FFN (the gate is then exactly 1.0)
    microbatches: int = 2      # the pipeline schedule's M
    dtype: str = "float32"     # bfloat16 for real runs; float32 for CPU tests
    remat: bool = False        # checkpoint each block in the train step
    # "full" recomputes the whole block in the backward; "save_flash"
    # keeps the flash forward's (o, lse), so the backward recomputes the
    # projections but never re-runs the attention kernel; "save_flash_mlp"
    # also keeps SwiGLU's hidden activation (the op ``mlp_act``)
    remat_policy: str = "save_flash"
    moe_topk: int = 0          # 0 = dense soft gating; k > 0 = routed top-k
    moe_capacity_factor: float = 1.25  # slots per expert vs perfect balance
    # count the dropped-choice fraction in the ``moe`` telemetry stage:
    # one device-to-host read per routed layer call, so off by default
    moe_debug_overflow: bool = False

    def __post_init__(self):
        if self.remat_policy not in _REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; "
                             f"expected one of {_REMAT_POLICIES}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def routed(self) -> bool:
        """Routed top-k MoE (``_moe_ffn`` :307-310)."""
        return self.moe_topk > 0 and self.n_experts > 1


def flagship_config() -> TransformerConfig:
    """The ~1.0B-parameter dense decoder LM the repo trains and serves
    (the JAX package's ``flagship_config``): bf16, per-block remat."""
    return TransformerConfig(vocab=32768, d_model=2048, n_heads=16,
                             head_dim=128, d_ff=6144, n_layers=16,
                             n_experts=1, microbatches=1, dtype="bfloat16",
                             remat=True)


def count_params(cfg: TransformerConfig) -> int:
    e, hd, f, x = (cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff,
                   cfg.n_experts)
    per_layer = 2 * e + 4 * e * hd + e * x + 3 * x * e * f
    return cfg.n_layers * per_layer + 2 * cfg.vocab * e + e


def train_flops_per_token(cfg: TransformerConfig, t: int,
                          causal: bool = True) -> float:
    """Matmul FLOPs per token of one train step (fwd + bwd ≈ 3× fwd),
    attention halved under ``causal``.  The FFN term counts every expert,
    routed or not, as the reference's formula does, so the ledger's MFU
    reads the same in both packages."""
    e, hd, f, x = (cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff,
                   cfg.n_experts)
    attn = (2 if causal else 4) * t * hd
    per_layer = 2 * 4 * e * hd + attn + 2 * 3 * e * f * x
    fwd = cfg.n_layers * per_layer + 2 * e * cfg.vocab
    return 3.0 * fwd


def train_step_flops(cfg: TransformerConfig, batch: int, t: int,
                     causal: bool = True) -> float:
    """Executed FLOPs of ONE train step of a ``[batch, t]`` input
    (:120)."""
    return train_flops_per_token(cfg, t, causal) * batch * t


def decode_flops_per_token(cfg: TransformerConfig, ctx: int) -> float:
    """Forward FLOPs of one generated token attending ``ctx`` tokens."""
    return train_flops_per_token(cfg, ctx, causal=False) / 3.0


def decode_phase_flops(cfg: TransformerConfig, ctx: int) -> dict:
    """:func:`decode_flops_per_token` split by phase (:431-446), the
    shares the compute ledger apportions a decode step's device time
    by; the three values sum exactly to it (the qkvo projections count
    as attention)."""
    e, hd, f, x = (cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff,
                   cfg.n_experts)
    return {
        "attention": float(cfg.n_layers * (2 * 4 * e * hd + 4 * ctx * hd)),
        "mlp": float(cfg.n_layers * (2 * 3 * e * f * x)),
        "unembed": float(2 * e * cfg.vocab),
    }


def _local(n: int, axis: str, mesh: Optional[Mesh], what: str) -> int:
    """This rank's share of ``n`` along ``axis`` (all of it without a
    mesh)."""
    parts = 1 if mesh is None else mesh.axis_size(axis)
    if n % parts:
        raise DMLCError(f"{what}={n} does not split over {axis}={parts}")
    return n // parts


class Block(nn.Module):
    """One decoder layer's weights, in the JAX layouts; on a mesh, this
    rank's shards of them (``PARAM_SPECS``)."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        e, d = cfg.d_model, cfg.head_dim
        h = _local(cfg.n_heads, AXIS_TP, mesh, "n_heads")
        f = _local(cfg.d_ff, AXIS_TP, mesh, "d_ff")
        x = _local(cfg.n_experts, AXIS_EP, mesh, "n_experts")

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.torch_dtype,
                                            device=device))

        self.ln1, self.ln2 = p(e), p(e)
        self.wq, self.wk, self.wv = p(e, h, d), p(e, h, d), p(e, h, d)
        self.wo = p(h, d, e)
        self.gate = p(e, cfg.n_experts)
        self.w_in, self.w_gate = p(x, e, f), p(x, e, f)
        self.w_out = p(x, f, e)

    def qkv(self, xn: torch.Tensor):
        return (torch.einsum("bte,ehd->bthd", xn, self.wq),
                torch.einsum("bte,ehd->bthd", xn, self.wk),
                torch.einsum("bte,ehd->bthd", xn, self.wv))

    def attn_out(self, o: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bthd,hde->bte", o, self.wo)

    def attention(self, xn: torch.Tensor, positions: torch.Tensor,
                  impl: Optional[str] = None,
                  axes: ShardAxes = ShardAxes(),
                  mesh: Optional[Mesh] = None):
        """Causal self-attention of the normed input over positions
        ``[T]`` (``_attention`` :180-202): ``(y, k, v)`` with the
        post-rope keys and values.  Under ``axes.sp`` the sequence is
        this rank's block and attention is the ring; under ``axes.tp``
        the heads are this rank's and ``y`` is summed over tp."""
        if axes.tp is not None:
            xn = copy_to(xn, axes.tp, mesh=mesh)
        q, k, v = self.qkv(xn)
        q = rope(q, positions)
        k = rope(k, positions)
        if axes.sp is not None:
            o = ring_attention(q, k, v, mesh=mesh, axis_name=axes.sp,
                               causal=True, impl=impl)
        else:
            o = flash_attention(q, k, v, causal=True, impl=impl)
        y = self.attn_out(o)
        if axes.tp is not None:
            y = reduce_from(y, axes.tp, mesh=mesh)
        return y, k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cfg: TransformerConfig, impl: Optional[str] = None,
                axes: ShardAxes = ShardAxes(),
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        """One decoder layer on the residual stream (``_block`` :313)."""
        x = x + self.attention(rms_norm(x, self.ln1), positions, impl,
                               axes, mesh)[0]
        return x + self.moe_ffn(rms_norm(x, self.ln2), cfg, axes=axes,
                                mesh=mesh)

    def moe_ffn(self, x: torch.Tensor, cfg: TransformerConfig,
                route_tokens: Optional[int] = None,
                axes: ShardAxes = ShardAxes(),
                mesh: Optional[Mesh] = None,
                route_axis: Optional[str] = None) -> torch.Tensor:
        """The FFN under ``cfg`` (``_moe_ffn`` :307): routed top-k when
        ``cfg.routed``, else dense soft gating.  ``route_tokens`` is the
        token count the routed capacity is computed from where the
        reference's call holds more tokens than ``x``: the dead rows it
        pads a decode batch with, which come after the live ones.  (The
        overflow counter then counts the live tokens' choices only; the
        reference's counts the dead rows' too.)  ``route_axis`` names the
        axis ``x``'s rows are this rank's share of (see
        :meth:`topk_ffn`); the dense FFN is row by row and ignores it."""
        if cfg.routed:
            return self.topk_ffn(x, cfg, route_tokens, axes, mesh,
                                 route_axis)
        return self.dense_ffn(x, axes, mesh)

    def _expert_offset(self, axes: ShardAxes, mesh: Optional[Mesh]) -> int:
        """The global index of this rank's first expert."""
        if axes.ep is None:
            return 0
        return mesh.axis_rank(axes.ep) * self.w_in.shape[0]

    def dense_ffn(self, x: torch.Tensor, axes: ShardAxes = ShardAxes(),
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
        """Dense soft-gated MoE (``_moe_dense_ffn``): every expert sees
        every token; the gate softmax is float32 and the combine casts
        the probabilities to the activations' dtype.  With one expert
        the gate is exactly 1.0 and is kept for parity.  Under
        ``axes.ep`` this rank's experts take their slice of the gate's
        probabilities; under ``axes.tp`` each expert's output is this
        rank's partial sum; one ``reduce_from`` over (ep, tp) combines
        them all."""
        gate_logits = torch.einsum("bte,ex->btx", x, self.gate)
        probs = torch.softmax(gate_logits.float(), dim=-1)
        red = _moe_axes(axes)
        if red:
            x = copy_to(x, red, mesh=mesh)
        ys = torch.stack([swiglu_ffn(x, self.w_in[i], self.w_gate[i],
                                     self.w_out[i], reduce=False)
                          for i in range(self.w_in.shape[0])])
        probs = probs.to(ys.dtype)
        if not red:
            return torch.einsum("xbte,btx->bte", ys, probs)
        probs = copy_to(probs, red, mesh=mesh)
        off = self._expert_offset(axes, mesh)
        probs = probs[..., off:off + ys.shape[0]]
        return reduce_from(torch.einsum("xbte,btx->bte", ys, probs), red,
                           mesh=mesh)

    def topk_ffn(self, x: torch.Tensor, cfg: TransformerConfig,
                 route_tokens: Optional[int] = None,
                 axes: ShardAxes = ShardAxes(),
                 mesh: Optional[Mesh] = None,
                 route_axis: Optional[str] = None) -> torch.Tensor:
        """Routed top-k MoE with capacity dispatch (``_moe_topk_ffn``
        :230-298).  Each token's ``k`` choices, renormalised, take slots
        token-major in ``[X_local, C, E]``, ``C = ceil(k·n·
        capacity_factor / X)`` over all ``n`` tokens and all ``X``
        experts; a choice past its expert's capacity is dropped and adds
        nothing.  Routing is local: under ``axes.ep`` this rank takes
        only the choices of its own experts, and the choices of other
        ranks' experts add on those ranks through the one
        ``reduce_from`` over (ep, tp) that also sums the tp shards' partial
        outputs.  The experts' SwiGLUs run on their slots as batched
        products, and the combine gathers and weights each kept choice's
        output.

        Under ``route_axis`` (a gathered decode view split over dp) ``x``
        holds this rank's rows of a batch whose other rows are on the
        axis's other ranks.  The slots are token-major over the whole
        batch, so the rank gathers every row's choices over the axis (in
        rank order, the batch's row order), routes them as one program
        does, and keeps its own rows' slots; capacity counts the whole
        batch unless ``route_tokens`` is given."""
        b, t, e = x.shape
        n = b * t
        k = cfg.moe_topk
        xf = x.reshape(n, e)
        probs = torch.softmax((xf @ self.gate).float(), dim=-1)
        n_expert = probs.shape[-1]
        topv, topi = torch.topk(probs, k, dim=-1)            # [n, k]
        topv = topv / topv.sum(dim=-1, keepdim=True)
        flat_e = topi.reshape(-1)                            # token-major
        parts = 1 if route_axis is None else mesh.axis_size(route_axis)
        if parts > 1:
            flat_e = all_gather(flat_e, route_axis, mesh=mesh)
        # in Python floats, exactly as the reference (:255-256)
        n_cap = n * parts if route_tokens is None else int(route_tokens)
        capacity = -(-(k * n_cap * cfg.moe_capacity_factor) // n_expert)
        capacity = max(int(capacity), 1)
        x_l = self.w_in.shape[0]
        off = self._expert_offset(axes, mesh)
        local = (flat_e >= off) & (flat_e < off + x_l)
        le = (flat_e - off).clamp(0, x_l - 1)
        # each local choice's slot in its expert: the count of earlier
        # local choices of that expert, scanned along [X_l, n·k]'s inner
        # dim (down the rows of [n·k, X], the card's scan takes ~3 ms a
        # call)
        oh = (F.one_hot(le, x_l) * local[:, None]).t().contiguous()
        pos = oh.cumsum(dim=1).gather(0, le[None])[0] - 1
        keep = local & (pos < capacity)
        pos_c = pos.clamp(0, capacity - 1)
        if cfg.moe_debug_overflow:
            _record_moe_overflow(keep, local)
        if parts > 1:   # this rank's rows' choices
            r = mesh.axis_rank(route_axis)
            mine = slice(r * n * k, (r + 1) * n * k)
            le, pos_c, keep = le[mine], pos_c[mine], keep[mine]
        red = _moe_axes(axes)
        if red:
            xf = copy_to(xf, red, mesh=mesh)
            topv = copy_to(topv, red, mesh=mesh)
        xk = xf.repeat_interleave(k, dim=0) * keep[:, None].to(xf.dtype)
        buf = xf.new_zeros((x_l, capacity, e)).index_put_(
            (le, pos_c), xk, accumulate=True)
        out = swiglu_ffn(buf, self.w_in, self.w_gate, self.w_out)
        picked = out[le, pos_c]                              # [n·k, E]
        w = (topv.reshape(-1) * keep.float()).to(picked.dtype)
        y = (picked * w[:, None]).reshape(n, k, e).sum(dim=1)
        y = y.reshape(b, t, e)
        if red:
            y = reduce_from(y, red, mesh=mesh)
        return y.to(x.dtype)


def _moe_axes(axes: ShardAxes) -> Tuple[str, ...]:
    """The axes the experts' outputs are summed over (``reduce_axes``
    :224, :294)."""
    return tuple(a for a in (axes.ep, axes.tp) if a is not None)


def _record_moe_overflow(keep: torch.Tensor, local: torch.Tensor) -> None:
    """The dropped-choice fraction of this rank's own choices in one
    routed call into the ``moe`` stage (``_record_moe_overflow``
    :267-276, :300-304).  One count a call: a rematerialised block counts
    again in its backward, as the reference's ``debug.callback`` does."""
    n_local = local.float().sum()
    frac = (n_local - keep.float().sum()) / n_local.clamp_min(1.0)
    telemetry.inc("moe", "overflow_checks")
    telemetry.inc("moe", "overflow_fraction_sum", float(frac))


class Transformer(nn.Module):
    """Embedding, ``n_layers`` :class:`Block` s, final norm, unembedding,
    on ``device`` (default: the mesh's device, else the CUDA card; no
    card raises).  On a ``mesh`` the parameters are this rank's shards
    (``PARAM_SPECS``), and on a pp mesh its stage's ``n_layers / P``
    layers (layers ``[s·L/P, (s+1)·L/P)`` on pp rank s, the reference's
    ``P(pp, ...)`` on the stacked blocks);
    ``models.convert.shard_params_from_jax`` fills them."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.device
        device = resolve_device(device)
        v = _local(cfg.vocab, AXIS_TP, mesh, "vocab")

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.torch_dtype,
                                            device=device))

        self.embed = p(v, cfg.d_model)
        self.unembed = p(cfg.d_model, v)
        self.ln_f = p(cfg.d_model)
        n_local = _local(cfg.n_layers, AXIS_PP, mesh, "n_layers")
        self.layers = nn.ModuleList(Block(cfg, device, mesh)
                                    for _ in range(n_local))

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """Random weights with the reference's shapes and scale: norms at 1,
    every matrix ``N(0, 0.02)`` drawn in float32 and cast to the config's
    dtype, on ``device`` (default: the CUDA card; no card raises).  The
    numbers come from ``generator`` (a ``torch.Generator`` on that
    device), not JAX's; tests share weights through
    ``convert.params_from_jax`` instead."""
    model = Transformer(cfg, device=device)

    def fill(t: torch.Tensor) -> None:
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                            dtype=torch.float32) * 0.02)

    for name, t in model.named_parameters():
        if name.endswith(("ln1", "ln2", "ln_f")):
            t.fill_(1.0)
        else:
            fill(t)
    return model


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _save_ops(*ops) -> Callable:
    """A selective-checkpoint policy that keeps the outputs of ``ops`` and
    recomputes everything else, as ``save_only_these_names`` (:333-340):
    ``save_flash`` keeps the flash forward's ``(o, lse)``,
    ``save_flash_mlp`` SwiGLU's ``mlp_act`` as well."""
    def policy(ctx, op, *args, **kwargs):
        if op in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _remat_policy(name: str) -> Optional[Callable]:
    ops = torch.ops.dmlc_tpu_torch
    return {"full": None,
            "save_flash": _save_ops(ops.flash_attn_fwd.default),
            "save_flash_mlp": _save_ops(ops.flash_attn_fwd.default,
                                        ops.mlp_act.default)}[name]


def _block_runner(cfg: TransformerConfig) -> Callable:
    """``(layer, x, positions, cfg, impl) -> x``: the layer as it is, or
    checkpointed under the config's remat policy (``_stage_fn``
    :324-347).  ``use_reentrant=False`` is what ``context_fn`` needs; the
    model has no dropout, so no RNG state is kept."""
    if not cfg.remat:
        return lambda layer, *a: layer(*a)
    kw = {}
    policy = _remat_policy(cfg.remat_policy)
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return lambda layer, *a: checkpoint(layer, *a, use_reentrant=False,
                                        preserve_rng_state=False, **kw)


def forward_local(model: Transformer, ids: torch.Tensor,
                  labels: torch.Tensor, cfg: Optional[TransformerConfig] = None,
                  axes: ShardAxes = ShardAxes(), mesh: Optional[Mesh] = None,
                  reduce_loss: bool = True,
                  impl: Optional[str] = None) -> torch.Tensor:
    """This rank's loss (``forward_local`` :356-404).  ids/labels
    ``[B_local, T_local]``: its (dp, sp) block of the batch, at global
    positions ``sp_rank·T_local + arange(T_local)``.  Under ``axes.pp``
    the batch runs as ``cfg.microbatches`` microbatches through the SPMD
    pipeline (``parallel.pipeline``; a batch that does not divide
    raises), each stage its own layers; the outputs are the same on
    every pp rank.  The mean float32 cross entropy, meaned over (dp, sp)
    unless ``reduce_loss=False`` (then this rank's mean).  With
    ``ShardAxes()`` (the default) it is the one-card loss.  ``mesh``
    defaults to the model's."""
    cfg = cfg or model.cfg
    mesh = mesh if mesh is not None else model.mesh
    b, t_local = ids.shape
    sp_rank = mesh.axis_rank(axes.sp) if axes.sp is not None else 0
    positions = sp_rank * t_local + torch.arange(t_local, device=ids.device)
    x = embed_lookup(model.embed, ids, axes, mesh).to(cfg.torch_dtype)
    run = _block_runner(cfg)

    def stage(layers, h: torch.Tensor) -> torch.Tensor:
        for layer in layers:
            h = run(layer, h, positions, cfg, impl, axes, mesh)
        return h

    if axes.pp is not None:
        m = cfg.microbatches
        if b % m:
            raise DMLCError(f"batch {b} does not split into {m} "
                            "microbatches")
        xmb = x.reshape(m, b // m, t_local, cfg.d_model)
        x = pipeline_spmd(stage, model.layers, xmb, mesh=mesh,
                          axis_name=axes.pp).reshape(b, t_local, cfg.d_model)
    else:
        x = stage(model.layers, x)
    x = rms_norm(x, model.ln_f)
    if axes.tp is not None:
        x = copy_to(x, axes.tp, mesh=mesh)
    loss = softmax_xent(x @ model.unembed, labels, axes, mesh).mean()
    data = tuple(a for a in (axes.dp, axes.sp) if a is not None)
    if data and reduce_loss:
        loss = mean_from(loss, data, mesh=mesh)
    return loss


def unsharded_loss(model: Transformer, ids: torch.Tensor,
                   labels: torch.Tensor,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Mean float32 cross entropy over ``ids``/``labels [B, T]`` at
    positions ``arange(T)`` (``unsharded_loss`` :407, i.e.
    ``forward_local`` with ``ShardAxes()``)."""
    return forward_local(model, ids, labels, model.cfg, ShardAxes(), None,
                         impl=impl)


def adamw(params, lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` with optax's defaults: betas (0.9, 0.999), eps
    1e-8 and weight decay 1e-4 on every parameter (torch's default decay
    is 1e-2).  The moments take each parameter's dtype, as optax's do."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together, in float32 (the gradient
    norm ``optax.global_norm`` gives the reference's step, :848-849)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]))


def _local_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's ``P(dp, sp)`` block of a global ``[B, T]`` array."""
    dp, sp = mesh.axis_size(AXIS_DP), mesh.axis_size(AXIS_SP)
    if x.shape[0] % dp or x.shape[1] % sp:
        raise DMLCError(f"batch {tuple(x.shape)} does not split over "
                        f"dp={dp} x sp={sp}")
    return (x.chunk(dp, dim=0)[mesh.axis_rank(AXIS_DP)]
            .chunk(sp, dim=1)[mesh.axis_rank(AXIS_SP)])


def sharded_axes(name: str) -> Tuple[str, ...]:
    """The mesh axes a parameter (by its ``named_parameters`` name) is
    sharded over, in ``MESH_AXES`` order: pp for every block leaf (its
    stage's layers), then ``PARAM_SPECS``' ep and tp."""
    leaf = name.rsplit(".", 1)[-1]
    axes = {a for _, a in PARAM_SPECS[leaf]}
    if leaf in PARAM_SPEC_TREE["blocks"]:
        axes.add(AXIS_PP)
    return tuple(a for a in MESH_AXES if a in axes)


def sync_gradients(model: Transformer, mesh: Mesh) -> None:
    """Sum every gradient over the (dp, sp) group (the line of ranks at
    this rank's (pp, ep, tp) coordinate) in one fused all-reduce: the
    transpose of the loss's mean over the data axes (each rank's
    backward carries ``1/n`` of its loss).  The host's wait is the
    ``collective.allreduce`` span."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if mesh.group(DATA_AXES) is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    with telemetry.span("collective.allreduce", stage="collective",
                        args={"bytes": flat.numel() * flat.element_size()}):
        flat = all_reduce(flat, DATA_AXES, mesh=mesh)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def sharded_grad_norm(model: Transformer, mesh: Mesh) -> torch.Tensor:
    """The global L2 norm of a mesh model's (dp, sp)-reduced gradients, in
    float32, equal to the one-card model's (``optax.global_norm`` of the
    reference's global gradients): each leaf's squares are summed over
    every axis it is sharded on (:func:`sharded_axes`), one all-reduce
    an axis, and replicated leaves are counted once."""
    classes = {}
    for name, p in model.named_parameters():
        if p.grad is not None:
            classes.setdefault(sharded_axes(name), []).append(
                p.grad.float().square().sum())
    keys = sorted(classes)
    sums = torch.stack([torch.stack(classes[k]).sum() for k in keys])
    for axis in MESH_AXES:
        if mesh.axis_size(axis) > 1 and any(axis in k for k in keys):
            red = all_reduce(sums, axis, mesh=mesh)
            sums = torch.stack([red[i] if axis in k else sums[i]
                                for i, k in enumerate(keys)])
    return torch.sqrt(sums.sum())


def _reverse_topological(model: Transformer) -> List[nn.Parameter]:
    """The parameters in the order the backward finishes them: the
    unembedding and final norm first, then each layer's leaves from the
    last layer back (a :class:`Block`'s in reverse registration order:
    the FFN's, then the attention's), the embedding last."""
    blocks = [p for layer in model.layers for p in layer.parameters()]
    return [model.embed, *blocks, model.ln_f, model.unembed][::-1]


def make_train_step(model: Transformer, optimizer=None, ledger: bool = True,
                    grad_norm: bool = False, mesh: Optional[Mesh] = None,
                    overlap: Optional[str] = None):
    """``train_step(ids, labels) -> loss``: one AdamW update of ``model``
    in place (the ``train_step`` body of ``make_train_step`` :844-850).
    The step's gradients stay in ``p.grad`` until the next step.  The
    default optimizer is ``adamw(model.parameters(), 1e-3)``, as the
    reference's ``optax.adamw(1e-3)``.

    On a ``mesh`` (default: the model's; None runs on one card) ids and
    labels are the global ``[B, T]`` batch, as the reference's are
    (:764-766): each rank slices its ``P(dp, sp)`` block, runs
    ``forward_local``'s backward, sums every gradient over (dp, sp)
    (:func:`sync_gradients`) and updates its own shards; the loss is the
    (dp, sp) mean, the same on every rank.  ``overlap="device"``
    differentiates each rank's own mean loss instead and sums the
    gradients over (dp, sp) in buckets issued during the backward,
    each divided by the group's size
    (``parallel.overlap.DeviceBucketer``, the reference's
    ``bucketed_psum_mean``); the step waits on every bucket before the
    update, and the loss is the (dp, sp) mean, not differentiated.
    ``"auto"`` reads ``DMLC_COLL_OVERLAP``.

    With ``grad_norm`` the step is ``train_step(ids, labels, accept=None)
    -> (loss, gnorm)``, ``gnorm`` the global L2 norm of the gradients
    (:790-794; on a mesh :func:`sharded_grad_norm`).  It runs in two
    halves: the gradients and their norm, then ``optimizer.step()``.
    ``accept(loss, gnorm) -> bool``, when given, is asked between the
    two, and False declines the update: the parameters and the
    optimizer's state stay as they were, untouched and uncopied.  This
    is the reference caller's skip (it keeps its old immutable
    references) for a step that updates in place.

    The step is the compute ledger's site ``train.step``
    (``telemetry.compute.profiled_site``, :852-855): the first step of a
    batch shape runs under the cost pass, forward, backward and update.
    With ``ledger`` (default) every call drives the process step ledger
    (``telemetry.steps``) as the reference's does (:865-887): the first
    call declares the model's train FLOPs per token at the batch's
    sequence length and its dtype, and each step is ``step_begin`` →
    step → ``step_end(tokens=B·T, bytes_accessed=...)`` of the global
    batch, the bytes the site's cost, then a memory sample
    (``compute.sample_hbm``); a declined step is left open, and the
    next ``step_begin`` abandons it.  On a card ``step_end`` waits on an
    event recorded after the optimizer's kernels, so the record's
    ``wall_s`` is the step and ``host_issue_s`` its enqueue.
    ``ledger=False`` returns the bare step (for a caller that brackets
    the step itself, e.g. around its feed's wait)."""
    if overlap == "auto":
        overlap = "device" if get_env("DMLC_COLL_OVERLAP", False) else None
    if overlap not in (None, "device"):
        raise ValueError(f"unknown overlap mode {overlap!r} "
                         "(expected None, 'device' or 'auto')")
    if mesh is None:
        mesh = model.mesh
    elif mesh is not model.mesh:
        raise DMLCError("the model's parameters were not built for this "
                        "mesh (shard_params_from_jax builds them)")
    if optimizer is None:
        optimizer = adamw(model.parameters(), 1e-3)
    buckets = None
    if overlap == "device" and mesh is not None:
        buckets = DeviceBucketer(_reverse_topological(model), DATA_AXES,
                                 mesh)

    def gradients(ids: torch.Tensor, labels: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            loss = unsharded_loss(model, ids, labels)
            loss.backward()
        elif buckets is not None:
            with buckets:
                loss = forward_local(model, _local_batch(ids, mesh),
                                     _local_batch(labels, mesh), model.cfg,
                                     SHARDED_AXES, mesh, reduce_loss=False)
                loss.backward()
            loss = all_reduce(loss.detach(), DATA_AXES, "mean", mesh=mesh)
        else:
            loss = forward_local(model, _local_batch(ids, mesh),
                                 _local_batch(labels, mesh), model.cfg,
                                 SHARDED_AXES, mesh)
            loss.backward()
            sync_gradients(model, mesh)
        if not grad_norm:
            return loss.detach(), None
        if mesh is not None:
            return loss.detach(), sharded_grad_norm(model, mesh)
        return loss.detach(), _global_norm(
            p.grad for p in model.parameters() if p.grad is not None)

    def train_step(ids: torch.Tensor, labels: torch.Tensor, accept=None):
        loss, gnorm = gradients(ids, labels)
        applied = accept is None or bool(accept(loss, gnorm))
        if applied:
            optimizer.step()
        return (loss if gnorm is None else (loss, gnorm)), applied

    compute = telemetry.compute
    # the compute ledger's site (the function itself under
    # DMLC_COMPUTE_PROFILE=0): a batch shape's first step is its trace,
    # counted forward, backward and update
    site = compute.profiled_site(train_step, site="train.step")
    if not ledger:
        return lambda ids, labels, accept=None: site(ids, labels,
                                                     accept=accept)[0]
    cfg = model.cfg
    declared = []

    def stepped(ids: torch.Tensor, labels: torch.Tensor, accept=None):
        if not declared:
            telemetry.declare_flops_per_token(
                train_flops_per_token(cfg, int(ids.shape[-1])))
            telemetry.declare_dtype(cfg.dtype)
            declared.append(True)
        telemetry.step_begin()
        # a raising or declined step leaves the ledger's step open; the
        # next step_begin abandons it instead of recording a garbage wall
        out, applied = site(ids, labels, accept=accept)
        if applied:
            stats = getattr(site, "stats", None)   # absent when disabled
            cost = stats()["last_cost"] if stats else None
            telemetry.step_end(
                tokens=float(ids.numel()),
                bytes_accessed=cost["bytes_accessed"] if cost else None)
        if compute.enabled():
            compute.sample_hbm()
        return out

    return stepped


# ---------------------------------------------------------------------------
# serving forwards
# ---------------------------------------------------------------------------

def serving_axes(mesh: Optional[Mesh]) -> ShardAxes:
    """The axes the serving forwards shard over on ``mesh``: each of tp,
    dp, ep and pp that is wider than one rank.  Never sp: serving is
    replicated over sp, as the reference's is (its ``kv_partition_spec``
    places the gathered view over dp and tp only)."""
    def wide(axis: str) -> Optional[str]:
        return axis if mesh is not None and mesh.axis_size(axis) > 1 \
            else None

    return ShardAxes(tp=wide(AXIS_TP), dp=wide(AXIS_DP), ep=wide(AXIS_EP),
                     pp=wide(AXIS_PP))


def check_serving_mesh(cfg: TransformerConfig, mesh: Optional[Mesh]) -> None:
    """Raise where ``cfg`` does not split over ``mesh``: heads, ``d_ff``
    or vocab over tp, experts over ep, layers over pp.  Any mesh that
    the model splits over serves, as any mesh serves the reference's
    engine (:202-214)."""
    if mesh is None:
        return
    for n, axis, what in ((cfg.n_heads, AXIS_TP, "n_heads"),
                          (cfg.d_ff, AXIS_TP, "d_ff"),
                          (cfg.vocab, AXIS_TP, "vocab"),
                          (cfg.n_experts, AXIS_EP, "n_experts"),
                          (cfg.n_layers, AXIS_PP, "n_layers")):
        _local(n, axis, mesh, what)


def _serving_mesh(model: Transformer, axes: ShardAxes,
                  mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh a serving forward runs on (default: the model's), after
    :func:`check_serving_mesh`; ``axes`` may not name sp (see
    :func:`serving_axes`)."""
    if axes.sp is not None:
        raise DMLCError("the serving forwards are replicated over sp, as "
                        "the reference's are; pass serving_axes(mesh)")
    mesh = mesh if mesh is not None else model.mesh
    if any(a is not None for a in (axes.tp, axes.dp, axes.ep, axes.pp)):
        if mesh is None:
            raise DMLCError("sharded serving axes without a mesh")
        check_serving_mesh(model.cfg, mesh)
    return mesh


def _tp_sum(y: torch.Tensor, axes: ShardAxes,
            mesh: Optional[Mesh]) -> torch.Tensor:
    """Partial sums of this rank's heads combined over tp."""
    return y if axes.tp is None else reduce_from(y, axes.tp, mesh=mesh)


def _unembed(model: Transformer, x: torch.Tensor, axes: ShardAxes,
             mesh: Optional[Mesh]) -> torch.Tensor:
    """Logits of the normed ``x``; under tp this rank's vocab shard, its
    rows gathered so every rank holds the same full rows."""
    logits = x @ model.unembed
    if axes.tp is None:
        return logits
    return all_gather(logits, axes.tp, mesh=mesh, gather_axis=-1)


def _pp_stage(axes: ShardAxes, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """``(this rank's pp stage, the stage count)``; ``(0, 1)`` off a pp
    mesh."""
    if axes.pp is None or mesh is None or mesh.axis_size(axes.pp) == 1:
        return 0, 1
    return mesh.axis_rank(axes.pp), mesh.axis_size(axes.pp)


def _stage_in(model: Transformer, ids: torch.Tensor, axes: ShardAxes,
              mesh: Optional[Mesh]) -> torch.Tensor:
    """The residual stream ``[*ids.shape, E]`` this rank's layers start
    from: the embedding on pp stage 0 (and off a pp mesh), else what
    stage s-1 hands on once its layers have run (``ppermute_pair``).  A
    stage runs its layers once, on its real input: unlike the training
    pipeline's every-stage-every-step schedule, no stage runs on a
    bubble, whose K/V would land in its pools."""
    cfg = model.cfg
    s, _ = _pp_stage(axes, mesh)
    if s == 0:
        return embed_lookup(model.embed, ids, axes, mesh).to(cfg.torch_dtype)
    x = torch.empty((*ids.shape, cfg.d_model), dtype=cfg.torch_dtype,
                    device=ids.device)
    return ppermute_pair(x, axes.pp, s - 1, mesh=mesh)


def _stage_out(model: Transformer, x: torch.Tensor, axes: ShardAxes,
               mesh: Optional[Mesh]) -> Optional[torch.Tensor]:
    """After this rank's layers: the final-normed stream on the last pp
    stage (and off a pp mesh); an earlier stage hands ``x`` to the next
    and returns None."""
    s, n = _pp_stage(axes, mesh)
    if s < n - 1:
        ppermute_pair(x, axes.pp, s, mesh=mesh)
        return None
    return rms_norm(x, model.ln_f)


def _head(model: Transformer, x: Optional[torch.Tensor], lead: tuple,
          axes: ShardAxes, mesh: Optional[Mesh]) -> torch.Tensor:
    """Logits ``[*lead, V]`` of :func:`_stage_out`'s ``x`` on every rank:
    the last pp stage unembeds (gathered over tp), then broadcasts them
    over pp, so rank 0, the controller, samples from them."""
    s, n = _pp_stage(axes, mesh)
    if s == n - 1:
        logits = _unembed(model, x, axes, mesh)
        if n == 1:
            return logits
    else:
        logits = torch.empty((*lead, model.cfg.vocab),
                             dtype=model.cfg.torch_dtype,
                             device=model.device)
    return broadcast(logits, axes.pp, root=n - 1, mesh=mesh)


def _prefill_trunk(model: Transformer, ids: torch.Tensor,
                   impl: Optional[str] = None,
                   axes: ShardAxes = ShardAxes(),
                   mesh: Optional[Mesh] = None):
    """All prefill layers through the final norm: ``(x [B, T, E], k, v
    [L, B, T, H, D])``.  Right-padding is safe: attention is causal, so
    real positions never attend a pad token.  Under ``axes.tp`` (on
    ``mesh``, which :func:`_serving_mesh` gave) the heads are this
    rank's and so are ``k``/``v``'s; under ``axes.pp`` the layers are
    this stage's (``L`` its ``L/P``) and ``x`` is None but on the last
    stage; under ``axes.ep`` the FFN's experts are this rank's.  The
    batch is never split over dp."""
    cfg = model.cfg
    t = ids.shape[1]
    positions = torch.arange(t, device=ids.device)
    x = _stage_in(model, ids, axes, mesh)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for layer in model.layers:
        y, k, v = layer.attention(rms_norm(x, layer.ln1), positions, impl,
                                  axes, mesh)
        x = x + y
        x = x + layer.moe_ffn(rms_norm(x, layer.ln2), cfg, axes=axes,
                              mesh=mesh)
        ks.append(k)
        vs.append(v)
    return _stage_out(model, x, axes, mesh), torch.stack(ks), torch.stack(vs)


def forward_prefill(model: Transformer, ids: torch.Tensor,
                    impl: Optional[str] = None,
                    axes: ShardAxes = ShardAxes(),
                    mesh: Optional[Mesh] = None):
    """``ids [B, T]`` → ``(logits [B, T, V], k, v [L, B, T, H, D])`` with
    the post-rope per-layer keys and values (``H`` this rank's heads
    under tp, ``L`` its stage's layers under pp)."""
    mesh = _serving_mesh(model, axes, mesh)
    x, k, v = _prefill_trunk(model, ids, impl, axes, mesh)
    return _head(model, x, tuple(ids.shape), axes, mesh), k, v


def forward_prefill_last(model: Transformer, ids: torch.Tensor,
                         last_index: torch.Tensor,
                         impl: Optional[str] = None,
                         axes: ShardAxes = ShardAxes(),
                         mesh: Optional[Mesh] = None):
    """Prefill with logits at ONE position per sequence: ``(logits
    [B, V], k, v)`` for ``last_index [B]``; the unembedding runs on those
    rows only."""
    mesh = _serving_mesh(model, axes, mesh)
    x, k, v = _prefill_trunk(model, ids, impl, axes, mesh)
    if x is not None:
        x = x[torch.arange(ids.shape[0], device=ids.device),
              last_index.long()]
    return _head(model, x, (ids.shape[0],), axes, mesh), k, v


def _rope_window(x: torch.Tensor, positions: torch.Tensor,
                 theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding for a decode window: x [B, S, H, D] with
    per-token positions [B, S]."""
    ang = rope_angles(positions, x.shape[-1] // 2, theta)   # [B, S, half]
    return rotate(x, ang[:, :, None, :])


def _phase_scope() -> Callable:
    """``scope(name)``: a ``torch.profiler.record_function`` region for
    the decode forwards' attention / mlp / unembed phases under
    ``DMLC_COMPUTE_TRACE_PHASES=1`` (the reference's named scopes), else
    a no-op."""
    if telemetry.compute.phases_enabled():
        return record_function
    return lambda name: contextlib.nullcontext()


def _cached_window_attention(q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """S window tokens per row (q/k_new/v_new ``[B, S, H, D]``) attend a
    dense cache ``[B, Tc, H, D]`` plus a causal prefix of the window
    (:622-645): window position s sees cache slots ``j < lengths[b]``
    and window slots ``<= s``.  Scores and the probability-value
    product are float32 (``preferred_element_type=f32``), masked
    entries -1e30, the probabilities rounded to the values' dtype
    first; the output is in q's dtype.  S=1 is the single-token mask of
    ``_cached_attention`` (:475-497)."""
    d = q.shape[-1]
    tc, s_w = k_cache.shape[1], q.shape[1]
    k_all = torch.cat([k_cache, k_new], dim=1)             # [B, Tc+S, H, D]
    v_all = torch.cat([v_cache, v_new], dim=1)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k_all.float()) * (1.0 / d ** 0.5)
    idx = torch.arange(tc + s_w, device=q.device)
    in_cache = idx[None, None, :] < lengths.long()[:, None, None]
    in_window = ((idx[None, None, :] >= tc)
                 & (idx[None, None, :] - tc
                    <= torch.arange(s_w, device=q.device)[None, :, None]))
    s = s.masked_fill(~(in_cache | in_window)[:, None], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v_all.dtype).float(),
                       v_all.float())
    return out.to(q.dtype)


def _dp_rows(axes: ShardAxes, mesh: Optional[Mesh], batch: int,
             rows: int) -> Optional[int]:
    """The dp rank whose rows of a ``batch``-row window a gathered view
    of ``rows`` rows holds, or None where the view is the whole batch
    (no dp axis, or the reference's fallback for a batch that does not
    divide dp, ``kv_cache.py`` :587-589)."""
    if axes.dp is None or mesh is None or rows == batch:
        return None
    n = mesh.axis_size(axes.dp)
    if rows * n != batch:
        raise DMLCError(f"a gathered view of {rows} rows is neither the "
                        f"batch of {batch} nor its share over dp={n}")
    return mesh.axis_rank(axes.dp)


def forward_decode_spec(model: Transformer, ids: torch.Tensor,
                        positions: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, lengths: torch.Tensor,
                        route_tokens: Optional[int] = None,
                        axes: ShardAxes = ShardAxes(),
                        mesh: Optional[Mesh] = None):
    """Decode window step against a dense gathered cache (:648-687), the
    gather path's speculative verify: ids / positions ``[B, S]`` are
    each row's window (position 0 the token consumed, 1..S-1 drafts),
    k_cache / v_cache ``[L, B, Tc, H, D]`` with row b's slots valid
    below ``lengths[b]`` (garbage past it).  Returns ``(logits [B, S,
    V], k_new, v_new [L, B, S, H, D])``; the caller writes the prefix
    it commits into the cache.  The attention is plain products
    (the reference's einsum, no kernel).  ``route_tokens`` as in
    :func:`forward_decode_paged`.

    Sharded (``axes=serving_axes(mesh)`` on the model's mesh), the cache
    and ``k_new``/``v_new`` hold this rank's heads and, on a pp mesh,
    its stage's layers (each stage runs its layers on the previous
    stage's output, see :func:`_stage_in`); the logits are every vocab
    shard's, gathered over tp and broadcast over pp.  A cache of
    ``B / dp`` rows (``PagedKVCache.shard_gathered``) is this rank's dp
    share of the batch: the rank runs those rows, a routed FFN routes
    the whole batch (:meth:`Block.topk_ffn`'s ``route_axis``), and the
    logits, ``k_new`` and ``v_new`` are gathered over dp, so every rank
    ends with every row's (and writes every row into its pools).  A
    cache of ``B`` rows runs the batch whole on every dp rank."""
    cfg = model.cfg
    mesh = _serving_mesh(model, axes, mesh)
    scope = _phase_scope()
    r = _dp_rows(axes, mesh, ids.shape[0], k_cache.shape[1])
    if r is not None:
        n = mesh.axis_size(axes.dp)
        ids, positions, lengths = (t.chunk(n, dim=0)[r]
                                   for t in (ids, positions, lengths))
    route_axis = None if r is None else axes.dp
    x = _stage_in(model, ids, axes, mesh)
    k_news: List[torch.Tensor] = []
    v_news: List[torch.Tensor] = []
    for li, layer in enumerate(model.layers):
        with scope("attention"):
            q, k, v = layer.qkv(rms_norm(x, layer.ln1))
            q = _rope_window(q, positions)
            k = _rope_window(k, positions)
            o = _cached_window_attention(q, k, v, k_cache[li], v_cache[li],
                                         lengths)
            x = x + _tp_sum(layer.attn_out(o), axes, mesh)
        with scope("mlp"):
            x = x + layer.moe_ffn(rms_norm(x, layer.ln2), cfg, route_tokens,
                                  axes=axes, mesh=mesh,
                                  route_axis=route_axis)
        k_news.append(k)
        v_news.append(v)
    with scope("unembed"):
        logits = _head(model, _stage_out(model, x, axes, mesh),
                       tuple(ids.shape), axes, mesh)
    k_new, v_new = torch.stack(k_news), torch.stack(v_news)
    if r is not None:
        logits = all_gather(logits, axes.dp, mesh=mesh, gather_axis=0)
        k_new = all_gather(k_new, axes.dp, mesh=mesh, gather_axis=1)
        v_new = all_gather(v_new, axes.dp, mesh=mesh, gather_axis=1)
    return logits, k_new, v_new


def forward_decode(model: Transformer, ids: torch.Tensor,
                   positions: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, lengths: torch.Tensor,
                   route_tokens: Optional[int] = None,
                   axes: ShardAxes = ShardAxes(),
                   mesh: Optional[Mesh] = None):
    """Single-token decode step against a dense gathered cache
    (:561-604): ids / positions / lengths ``[B]``.  Returns ``(logits
    [B, V], k_new, v_new [L, B, H, D])``.  It is
    :func:`forward_decode_spec` at S=1 (``_rope_at`` is ``_rope_window``
    at one position, ``_cached_attention`` the S=1 mask), so the two
    agree exactly, as the reference's docstring requires of its pair,
    sharded as that one is.  Batch rows are independent: a dead row
    (length 0) changes no other row."""
    logits, k, v = forward_decode_spec(model, ids[:, None],
                                       positions[:, None], k_cache, v_cache,
                                       lengths, route_tokens, axes, mesh)
    return logits[:, 0], k[:, :, 0], v[:, :, 0]


def _window_addresses(lengths: torch.Tensor, block_tables: torch.Tensor,
                      s_w: int, block_size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pool addresses of the window's tokens, live rows only: ``(live
    [N] indices into the flattened [B*S] window, blocks [N], slots
    [N])``.  Dead rows (length 0) are left out, which is what the
    reference's out-of-bounds ``mode="drop"`` scatter does — indexed
    assignment has no drop mode, and a dead row's zero table would
    otherwise overwrite block 0 of a live sequence.  The one ``nonzero``
    here is the step's only device-to-host sync; the layers then select
    with the index tensor."""
    pos = lengths.long()[:, None] + torch.arange(s_w, device=lengths.device)
    lb = (pos // block_size).clamp(0, block_tables.shape[1] - 1)
    blocks = torch.gather(block_tables.long(), 1, lb).reshape(-1)
    live = torch.nonzero((lengths > 0).repeat_interleave(s_w)).squeeze(1)
    return live, blocks[live], (pos % block_size).reshape(-1)[live]


def forward_decode_paged(model: Transformer, ids: torch.Tensor,
                         positions: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_tables: torch.Tensor,
                         lengths: torch.Tensor,
                         impl: Optional[str] = None,
                         route_tokens: Optional[int] = None,
                         axes: ShardAxes = ShardAxes(),
                         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Decode window step attending the paged KV pool in place.

    ids / positions ``[B, S]`` (S=1 plain decode, S=k+1 speculative
    verify); pools ``[L, n_blocks, block_size, H, D]``; block_tables
    ``[B, W]`` int32; lengths ``[B]`` int32 committed tokens per row.
    Each layer scatters the window's K/V into the pools at positions
    ``lengths[b] + s`` and then attends positions ``<= lengths[b] + s``.

    Unlike the reference, which returns new pools, this writes the pools
    IN PLACE (they live only on the device; window slots past what the
    caller commits hold garbage the mask hides until overwritten) and
    returns only ``logits [B, S, V]``.

    ``route_tokens`` is the token count a routed config's expert capacity
    is computed from (``Block.moe_ffn``): the reference's engine pads
    the window to ``max_active`` rows after the live ones, so its
    capacity counts ``max_active · S`` tokens.  None counts ``B · S``.

    Sharded (``axes=serving_axes(mesh)`` on the model's mesh) the pools
    hold this rank's heads of its pp stage's layers, the kernel attends
    those, and the logits are gathered over tp and broadcast over pp;
    the batch runs whole on every dp rank, as the reference's paged
    program places nothing over dp."""
    cfg = model.cfg
    mesh = _serving_mesh(model, axes, mesh)
    scope = _phase_scope()
    s_w = ids.shape[1]
    live, wb, ws = _window_addresses(lengths, block_tables, s_w,
                                     k_pool.shape[2])
    x = _stage_in(model, ids, axes, mesh)
    for li, layer in enumerate(model.layers):
        with scope("attention"):
            q, k, v = layer.qkv(rms_norm(x, layer.ln1))
            q = _rope_window(q, positions)
            k = _rope_window(k, positions)
            k_pool[li, wb, ws] = k.flatten(0, 1)[live].to(k_pool.dtype)
            v_pool[li, wb, ws] = v.flatten(0, 1)[live].to(v_pool.dtype)
            o = paged_attention(q, k_pool[li], v_pool[li], block_tables,
                                lengths, impl=impl)
            x = x + _tp_sum(layer.attn_out(o), axes, mesh)
        with scope("mlp"):
            x = x + layer.moe_ffn(rms_norm(x, layer.ln2), cfg, route_tokens,
                                  axes=axes, mesh=mesh)
    with scope("unembed"):
        return _head(model, _stage_out(model, x, axes, mesh),
                     tuple(ids.shape), axes, mesh)
