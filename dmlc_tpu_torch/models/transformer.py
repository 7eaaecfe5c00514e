"""Flagship decoder-only transformer LM on one card: training and serving.

Port of the single-device half of ``dmlc_tpu/models/transformer.py``:
``TransformerConfig``/``flagship_config``/``count_params``/FLOP counts
(:49-126, :420-428), ``init_params`` (:128-155), the dense soft-gated
MoE FFN (:205-227), the block and its per-block remat (:313-353), the
loss ``unsharded_loss`` (``forward_local`` with ``ShardAxes()``,
:356-409), a train step with AdamW as ``make_train_step`` builds it with
``optax.adamw`` (:761-850), and the serving forwards
``forward_prefill`` / ``forward_prefill_last`` (:504-558) and
``forward_decode_paged`` (:690-758).  The sharded paths, the train
step's mesh, overlap and step ledger, routed top-k MoE and the gather
decode path come in later slices.

Each layer module keeps the JAX weight layouts (``wq [E, H, D]``,
``wo [H, D, E]``, ``w_in [X, E, F]``, ...) so weights convert one to one
(``models/convert.py``); the JAX pytree stacks blocks ``[S, L/S, ...]``
and this module lists them as ``L`` layers in the same order, which is
also the layer index of the KV pool ``[L, n_blocks, block_size, H, D]``.

Attention goes through ``ops.flash_attention`` (training and prefill,
differentiable) and ``ops.paged_attention`` (decode), which launch the
CUDA kernels on a CUDA tensor and their plain versions on a CPU tensor;
``impl`` forces one of the two for comparisons and is never passed on
the training or serving path.  Parameters are trainable; the serving
forwards run under ``torch.inference_mode()`` (the engine's), so they
build no autograd graph.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..base import resolve_device
from ..ops.core import embed_lookup, rms_norm, rope, rope_angles, rotate, \
    softmax_xent, swiglu_ffn
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_attention

__all__ = ["TransformerConfig", "flagship_config", "count_params",
           "train_flops_per_token", "decode_flops_per_token", "Block",
           "Transformer", "init_params", "unsharded_loss", "adamw",
           "make_train_step", "forward_prefill", "forward_prefill_last",
           "forward_decode_paged"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_REMAT_POLICIES = ("full", "save_flash")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    head_dim: int = 16
    d_ff: int = 128
    n_layers: int = 4
    n_experts: int = 2         # 1 = dense FFN (the gate is then exactly 1.0)
    dtype: str = "float32"     # bfloat16 for real runs; float32 for CPU tests
    remat: bool = False        # checkpoint each block in the train step
    # "full" recomputes the whole block in the backward; "save_flash"
    # keeps the flash forward's (o, lse), so the backward recomputes the
    # projections but never re-runs the attention kernel
    remat_policy: str = "save_flash"

    def __post_init__(self):
        if self.remat_policy == "save_flash_mlp":
            raise ValueError(
                "remat_policy 'save_flash_mlp' is not ported yet (ROADMAP.md "
                "Queue 3: the save_flash_mlp remat policy)")
        if self.remat_policy not in _REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; "
                             f"expected one of {_REMAT_POLICIES}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def flagship_config() -> TransformerConfig:
    """The ~1.0B-parameter dense decoder LM the repo trains and serves
    (the JAX package's ``flagship_config``): bf16, per-block remat."""
    return TransformerConfig(vocab=32768, d_model=2048, n_heads=16,
                             head_dim=128, d_ff=6144, n_layers=16,
                             n_experts=1, dtype="bfloat16", remat=True)


def count_params(cfg: TransformerConfig) -> int:
    e, hd, f, x = (cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff,
                   cfg.n_experts)
    per_layer = 2 * e + 4 * e * hd + e * x + 3 * x * e * f
    return cfg.n_layers * per_layer + 2 * cfg.vocab * e + e


def train_flops_per_token(cfg: TransformerConfig, t: int,
                          causal: bool = True) -> float:
    """Matmul FLOPs per token of one train step (fwd + bwd ≈ 3× fwd),
    attention halved under ``causal``."""
    e, hd, f, x = (cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff,
                   cfg.n_experts)
    attn = (2 if causal else 4) * t * hd
    per_layer = 2 * 4 * e * hd + attn + 2 * 3 * e * f * x
    fwd = cfg.n_layers * per_layer + 2 * e * cfg.vocab
    return 3.0 * fwd


def decode_flops_per_token(cfg: TransformerConfig, ctx: int) -> float:
    """Forward FLOPs of one generated token attending ``ctx`` tokens."""
    return train_flops_per_token(cfg, ctx, causal=False) / 3.0


class Block(nn.Module):
    """One decoder layer's weights, in the JAX layouts."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        e, h, d, f, x = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                         cfg.n_experts)

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.torch_dtype,
                                            device=device))

        self.ln1, self.ln2 = p(e), p(e)
        self.wq, self.wk, self.wv = p(e, h, d), p(e, h, d), p(e, h, d)
        self.wo = p(h, d, e)
        self.gate = p(e, x)
        self.w_in, self.w_gate = p(x, e, f), p(x, e, f)
        self.w_out = p(x, f, e)

    def qkv(self, xn: torch.Tensor):
        return (torch.einsum("bte,ehd->bthd", xn, self.wq),
                torch.einsum("bte,ehd->bthd", xn, self.wk),
                torch.einsum("bte,ehd->bthd", xn, self.wv))

    def attn_out(self, o: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bthd,hde->bte", o, self.wo)

    def attention(self, xn: torch.Tensor, positions: torch.Tensor,
                  impl: Optional[str] = None):
        """Causal self-attention of the normed input over positions
        ``[T]`` (``_attention`` :180-202, single device): ``(y, k, v)``
        with the post-rope keys and values."""
        q, k, v = self.qkv(xn)
        q = rope(q, positions)
        k = rope(k, positions)
        o = flash_attention(q, k, v, causal=True, impl=impl)
        return self.attn_out(o), k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                impl: Optional[str] = None) -> torch.Tensor:
        """One decoder layer on the residual stream (``_block`` :313)."""
        x = x + self.attention(rms_norm(x, self.ln1), positions, impl)[0]
        return x + self.moe_ffn(rms_norm(x, self.ln2))

    def moe_ffn(self, x: torch.Tensor) -> torch.Tensor:
        """Dense soft-gated MoE (``_moe_dense_ffn``): every expert sees
        every token; the gate softmax is float32 and the combine casts
        the probabilities to the activations' dtype.  With one expert
        the gate is exactly 1.0 and is kept for parity."""
        gate_logits = torch.einsum("bte,ex->btx", x, self.gate)
        probs = torch.softmax(gate_logits.float(), dim=-1)
        ys = torch.stack([swiglu_ffn(x, self.w_in[i], self.w_gate[i],
                                     self.w_out[i])
                          for i in range(self.w_in.shape[0])])
        return torch.einsum("xbte,btx->bte", ys, probs.to(ys.dtype))


class Transformer(nn.Module):
    """Embedding, ``n_layers`` :class:`Block` s, final norm, unembedding,
    on ``device`` (default: the CUDA card; no card raises)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.torch_dtype,
                                            device=device))

        self.embed = p(cfg.vocab, cfg.d_model)
        self.unembed = p(cfg.d_model, cfg.vocab)
        self.ln_f = p(cfg.d_model)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))

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

def _save_flash(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy ``save_flash``: keep the flash
    forward's ``(o, lse)`` and recompute everything else, as
    ``save_only_these_names("flash_o", "flash_lse")`` (:333-335)."""
    if op == torch.ops.dmlc_tpu_torch.flash_attn_fwd.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _block_runner(cfg: TransformerConfig) -> Callable:
    """``(layer, x, positions, impl) -> x``: the layer as it is, or
    checkpointed under the config's remat policy (``_stage_fn``
    :324-347).  ``use_reentrant=False`` is what ``context_fn`` needs; the
    model has no dropout, so no RNG state is kept."""
    if not cfg.remat:
        return lambda layer, *a: layer(*a)
    kw = {}
    if cfg.remat_policy == "save_flash":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_flash)
    return lambda layer, *a: checkpoint(layer, *a, use_reentrant=False,
                                        preserve_rng_state=False, **kw)


def unsharded_loss(model: Transformer, ids: torch.Tensor,
                   labels: torch.Tensor,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Mean float32 cross entropy over ``ids``/``labels [B, T]`` at
    positions ``arange(T)`` (``unsharded_loss`` :407, i.e.
    ``forward_local`` :356 with ``ShardAxes()``)."""
    cfg = model.cfg
    positions = torch.arange(ids.shape[1], device=ids.device)
    x = embed_lookup(model.embed, ids).to(cfg.torch_dtype)
    run = _block_runner(cfg)
    for layer in model.layers:
        x = run(layer, x, positions, impl)
    logits = rms_norm(x, model.ln_f) @ model.unembed
    return softmax_xent(logits, labels).mean()


def adamw(params, lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` with optax's defaults: betas (0.9, 0.999), eps
    1e-8 and weight decay 1e-4 on every parameter (torch's default decay
    is 1e-2).  The moments take each parameter's dtype, as optax's do."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_train_step(model: Transformer, optimizer=None):
    """``train_step(ids, labels) -> loss``: one AdamW update of ``model``
    in place (the ``train_step`` body of ``make_train_step`` :844-850 on
    one card).  The step's gradients stay in ``p.grad`` until the next
    step.  The default optimizer is ``adamw(model.parameters(), 1e-3)``,
    as the reference's ``optax.adamw(1e-3)``."""
    if optimizer is None:
        optimizer = adamw(model.parameters(), 1e-3)

    def train_step(ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = unsharded_loss(model, ids, labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


# ---------------------------------------------------------------------------
# serving forwards
# ---------------------------------------------------------------------------

def _prefill_trunk(model: Transformer, ids: torch.Tensor,
                   impl: Optional[str] = None):
    """All prefill layers through the final norm: ``(x [B, T, E], k, v
    [L, B, T, H, D])``.  Right-padding is safe: attention is causal, so
    real positions never attend a pad token."""
    cfg = model.cfg
    t = ids.shape[1]
    positions = torch.arange(t, device=ids.device)
    x = embed_lookup(model.embed, ids).to(cfg.torch_dtype)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for layer in model.layers:
        y, k, v = layer.attention(rms_norm(x, layer.ln1), positions, impl)
        x = x + y
        x = x + layer.moe_ffn(rms_norm(x, layer.ln2))
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, model.ln_f)
    return x, torch.stack(ks), torch.stack(vs)


def forward_prefill(model: Transformer, ids: torch.Tensor,
                    impl: Optional[str] = None):
    """``ids [B, T]`` → ``(logits [B, T, V], k, v [L, B, T, H, D])`` with
    the post-rope per-layer keys and values."""
    x, k, v = _prefill_trunk(model, ids, impl)
    return x @ model.unembed, k, v


def forward_prefill_last(model: Transformer, ids: torch.Tensor,
                         last_index: torch.Tensor,
                         impl: Optional[str] = None):
    """Prefill with logits at ONE position per sequence: ``(logits
    [B, V], k, v)`` for ``last_index [B]``; the unembedding runs on those
    rows only."""
    x, k, v = _prefill_trunk(model, ids, impl)
    rows = torch.arange(ids.shape[0], device=ids.device)
    return x[rows, last_index.long()] @ model.unembed, k, v


def _rope_window(x: torch.Tensor, positions: torch.Tensor,
                 theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding for a decode window: x [B, S, H, D] with
    per-token positions [B, S]."""
    ang = rope_angles(positions, x.shape[-1] // 2, theta)   # [B, S, half]
    return rotate(x, ang[:, :, None, :])


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
                         impl: Optional[str] = None) -> torch.Tensor:
    """Decode window step attending the paged KV pool in place.

    ids / positions ``[B, S]`` (S=1 plain decode, S=k+1 speculative
    verify); pools ``[L, n_blocks, block_size, H, D]``; block_tables
    ``[B, W]`` int32; lengths ``[B]`` int32 committed tokens per row.
    Each layer scatters the window's K/V into the pools at positions
    ``lengths[b] + s`` and then attends positions ``<= lengths[b] + s``.

    Unlike the reference, which returns new pools, this writes the pools
    IN PLACE (they live only on the device; window slots past what the
    caller commits hold garbage the mask hides until overwritten) and
    returns only ``logits [B, S, V]``."""
    cfg = model.cfg
    s_w = ids.shape[1]
    live, wb, ws = _window_addresses(lengths, block_tables, s_w,
                                     k_pool.shape[2])
    x = embed_lookup(model.embed, ids).to(cfg.torch_dtype)
    for li, layer in enumerate(model.layers):
        q, k, v = layer.qkv(rms_norm(x, layer.ln1))
        q = _rope_window(q, positions)
        k = _rope_window(k, positions)
        k_pool[li, wb, ws] = k.flatten(0, 1)[live].to(k_pool.dtype)
        v_pool[li, wb, ws] = v.flatten(0, 1)[live].to(v_pool.dtype)
        o = paged_attention(q, k_pool[li], v_pool[li], block_tables, lengths,
                            impl=impl)
        x = x + layer.attn_out(o)
        x = x + layer.moe_ffn(rms_norm(x, layer.ln2))
    x = rms_norm(x, model.ln_f)
    return x @ model.unembed
