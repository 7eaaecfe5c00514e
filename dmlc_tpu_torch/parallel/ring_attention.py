"""Ring attention: exact attention over sequence shards by neighbour
exchange (port of ``dmlc_tpu/parallel/ring_attention.py``).

Each rank of the ``sp`` axis holds Q, K and V for its block of the
sequence.  It attends its Q to the K/V block it holds with
``block_attend`` at the blocks' global offsets (kernel K1 on a CUDA
tensor, its plain version on a CPU tensor), folds the block's
``(pv, m, l)`` into a running flash-style softmax, and passes K and V on
around the ring with the differentiable ``ppermute_ring``; after
``n = axis_size(sp)`` steps every Q block has seen every K/V block and
the result is exact.  The backward of each step is ``block_attend``'s
plain recompute and the ring's opposite shift.  A ring of one rank calls
``flash_attention`` (K1 forward, K2/K3 backward), as the reference does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import telemetry
from ..ops.flash_attention import (attention_reference, block_attend,
                                   flash_attention)
from .collectives import ppermute_ring
from .mesh import AXIS_SP, AXIS_TP, Mesh

__all__ = ["ring_attention", "ring_attention_reference",
           "make_sharded_ring_attention"]

_NEG_BIG = -1e30

#: the unsharded oracle (the port's ``attention_reference``)
ring_attention_reference = attention_reference


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Mesh, axis_name: str = AXIS_SP, causal: bool = True,
                   scale: Optional[float] = None,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Exact multi-head attention over the ring of ``axis_name``.

    q/k/v: this rank's ``[B, T_local, H, D]`` sequence block (heads may
    be a tensor-parallel shard too); the global sequence is ``T_local ·
    axis_size``, block i on the axis's rank i.  Returns q's dtype.
    ``impl`` (None, "cuda" or "torch") is passed to the attention ops.
    """
    n = mesh.axis_size(axis_name)
    my = mesh.axis_rank(axis_name)
    b, t_local, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    # each step after the first rotates the whole local K+V block
    kv_bytes = float(2 * k.numel() * k.element_size())
    telemetry.inc("ring_attention", "calls")
    telemetry.inc("ring_attention", "bytes_rotated", kv_bytes * max(0, n - 1))
    telemetry.observe("ring_attention", "kv_block_bytes", kv_bytes,
                      bounds=tuple(64.0 * 2.0 ** i for i in range(28)))
    if n == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale, impl=impl)

    acc = q.new_zeros((b, t_local, h, d), dtype=torch.float32)
    m = q.new_full((b, h, t_local), _NEG_BIG, dtype=torch.float32)
    l = q.new_zeros((b, h, t_local), dtype=torch.float32)
    k_blk, v_blk = k, v
    for i in range(n):
        src = (my - i) % n   # the ring position the held K/V came from
        pv, bm, bl = block_attend(q, k_blk, v_blk, scale=scale,
                                  causal=causal, q_offset=my * t_local,
                                  kv_offset=src * t_local, impl=impl)
        m_new = torch.maximum(m, bm)
        corr = torch.exp(m - m_new)        # rescale the old accumulator
        bcor = torch.exp(bm - m_new)       # rescale this block
        l = l * corr + bl * bcor
        acc = (acc * corr.transpose(1, 2)[..., None]
               + pv * bcor.transpose(1, 2)[..., None])
        m = m_new
        if i + 1 < n:   # the reference's last rotation returns K/V home
            k_blk = ppermute_ring(k_blk, axis_name, 1, mesh=mesh)
            v_blk = ppermute_ring(v_blk, axis_name, 1, mesh=mesh)
    denom = l.clamp_min(1e-20).transpose(1, 2)[..., None]
    return (acc / denom).to(q.dtype)


def make_sharded_ring_attention(mesh: Mesh, *, causal: bool = True,
                                impl: Optional[str] = None):
    """``run(q, k, v)`` on global ``[B, T, H, D]`` inputs: slices this
    rank's (sp sequence, tp heads) shard and runs :func:`ring_attention`
    on it, returning the local output ``[B, T/sp, H/tp, D]`` (the
    reference's ``shard_map`` with spec ``P(None, sp, tp, None)``).  The
    call is a ``ring_attention.run`` span."""
    sp, tp = mesh.axis_size(AXIS_SP), mesh.axis_size(AXIS_TP)
    s_idx, t_idx = mesh.axis_rank(AXIS_SP), mesh.axis_rank(AXIS_TP)

    def local(x: torch.Tensor) -> torch.Tensor:
        return x.chunk(sp, dim=1)[s_idx].chunk(tp, dim=2)[t_idx]

    def run(q, k, v):
        with telemetry.span("ring_attention.run", stage="ring",
                            args={"sp": sp, "t": int(q.shape[1])}):
            return ring_attention(local(q), local(k), local(v), mesh=mesh,
                                  axis_name=AXIS_SP, causal=causal,
                                  impl=impl)

    return run
