"""Core ops, unsharded (port of ``dmlc_tpu/ops/core.py:50-136``).

The JAX module threads a ``ShardAxes`` through every op and adds a
``psum`` where a dimension is sharded; this slice runs on one card, so
only the unsharded branches exist here.  Precision follows the JAX ops
exactly: statistics in float32, results cast back to the input's dtype
at the same points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "embed_lookup", "softmax_xent", "swiglu_ffn"]


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


def embed_lookup(embed: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows for ``ids`` (any shape) → [..., E]."""
    return F.embedding(ids, embed)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy in float32.  logits: [..., V]; labels: [...].
    The max only stabilises the exp and is detached, as the reference's
    ``lax.stop_gradient`` does: the gradient is the softmax either way,
    and no ``amax`` backward (which splits ties) runs."""
    logits = logits.float()
    m = logits.amax(dim=-1).detach()
    lse = torch.log(torch.exp(logits - m[..., None]).sum(dim=-1)) + m
    correct = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - correct


def swiglu_ffn(x: torch.Tensor, w_in: torch.Tensor, w_gate: torch.Tensor,
               w_out: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN.  w_in/w_gate: [E, F]; w_out: [F, E]."""
    h = (x @ w_in) * F.silu(x @ w_gate)
    return h @ w_out
