"""Ulysses-style sequence parallelism: all-to-all head↔sequence re-shard
(port of ``dmlc_tpu/parallel/ulysses.py``).

The complement to ring attention: one all-to-all turns sequence-sharded
``[B, T/sp, H, D]`` into head-sharded ``[B, T, H/sp, D]``, ordinary full
attention runs locally, and a second all-to-all turns the result back.
Both all-to-alls are differentiable (their transposes are the inverse
re-shards)."""

from __future__ import annotations

from typing import Callable, Optional

from .collectives import all_to_all
from .mesh import AXIS_SP, Mesh
from .ring_attention import ring_attention_reference

__all__ = ["ulysses_attention"]


def ulysses_attention(q, k, v, *, mesh: Mesh, axis_name: str = AXIS_SP,
                      causal: bool = True,
                      attn_fn: Optional[Callable] = None):
    """Attention over sequence shards via two all-to-alls.

    q/k/v: ``[B, T_local, H, D]`` with H divisible by the axis's size.
    ``attn_fn(q, k, v, causal=...)`` runs on the re-sharded ``[B,
    T_global, H_local, D]`` blocks (default: the exact plain attention,
    as the reference's; ``flash_attention`` runs K1-K3)."""
    if attn_fn is None:
        def attn_fn(q, k, v, causal):
            return ring_attention_reference(q, k, v, causal=causal)

    def seq_to_heads(x):
        return all_to_all(x, axis_name, split_axis=2, concat_axis=1,
                          mesh=mesh)

    def heads_to_seq(x):
        return all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                          mesh=mesh)

    out = attn_fn(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                  causal=causal)
    return heads_to_seq(out)
