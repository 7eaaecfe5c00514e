"""Flagship decoder-only transformer LM, serving forwards (single card).

Port of the serving half of ``dmlc_tpu/models/transformer.py``:
``TransformerConfig``/``flagship_config``/``count_params``/FLOP counts
(:49-126, :420-428), ``init_params`` (:128-155), the dense soft-gated
MoE FFN (:205-227), and the serving forwards ``forward_prefill`` /
``forward_prefill_last`` (:504-558) and ``forward_decode_paged``
(:690-758).  Training, the sharded paths, routed top-k MoE and the
gather decode path come in later slices.

Each layer module keeps the JAX weight layouts (``wq [E, H, D]``,
``wo [H, D, E]``, ``w_in [X, E, F]``, ...) so weights convert one to one
(``models/convert.py``); the JAX pytree stacks blocks ``[S, L/S, ...]``
and this module lists them as ``L`` layers in the same order, which is
also the layer index of the KV pool ``[L, n_blocks, block_size, H, D]``.

Attention goes through ``ops.flash_attention`` (prefill) and
``ops.paged_attention`` (decode), which launch the CUDA kernels on a CUDA
tensor and their plain versions on a CPU tensor; ``impl`` forces one of
the two for comparisons and is never passed on the serving path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..ops.core import embed_lookup, rms_norm, rope, rope_angles, rotate, \
    swiglu_ffn
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_attention

__all__ = ["TransformerConfig", "flagship_config", "count_params",
           "train_flops_per_token", "decode_flops_per_token", "Block",
           "Transformer", "init_params", "forward_prefill",
           "forward_prefill_last", "forward_decode_paged"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def flagship_config() -> TransformerConfig:
    """The ~1.0B-parameter dense decoder LM the repo serves (the JAX
    package's ``flagship_config``)."""
    return TransformerConfig(vocab=32768, d_model=2048, n_heads=16,
                             head_dim=128, d_ff=6144, n_layers=16,
                             n_experts=1, dtype="bfloat16")


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
                                            device=device),
                                requires_grad=False)

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
    """Embedding, ``n_layers`` :class:`Block` s, final norm, unembedding."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.torch_dtype,
                                            device=device),
                                requires_grad=False)

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
    dtype.  The numbers come from ``generator`` (a ``torch.Generator`` on
    ``device``), not JAX's; tests share weights through
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
        q, k, v = layer.qkv(rms_norm(x, layer.ln1))
        q = rope(q, positions)
        k = rope(k, positions)
        o = flash_attention(q, k, v, causal=True, impl=impl)
        x = x + layer.attn_out(o)
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
