"""Flash-attention forward: CUDA kernel K1 and its plain PyTorch version.

Port of the forward half of ``dmlc_tpu/ops/flash_attention.py``
(``lax_block_attend`` :132, ``_flash_forward`` :212, ``_flash_attn_impl``
:532, ``flash_attention`` :560) plus the oracle
``ring_attention_reference`` (``dmlc_tpu/parallel/ring_attention.py:151``).

Layout is the reference's: q/k/v ``[B, T, H, D]``; the partial-attention
contract is ``(pv [B, Tq, H, D] f32, m [B, H, Tq] f32, l [B, H, Tq] f32)``
with causal masks on global positions ``q_offset + i >= kv_offset + j``.

Dispatch is on the tensors' device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel in ``csrc/flash_fwd.cu`` (or a
raise, for a shape the kernel does not take).  ``impl="cuda"|"torch"``
forces one of the two, for comparisons.  This slice is forward-only:
inputs that require grad raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..base import DMLCError
from ._build import Kernel

__all__ = ["flash_attention", "block_attend", "attention_reference",
           "block_attend_reference", "FLASH_FWD"]

_NEG_BIG = -1e30

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
FLASH_FWD = Kernel("flash_fwd.cu", "dmlc_flash_fwd",
                   [_P, _P, _P, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                    _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                    _I, _P])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions (f32 scores and products, as preferred_element_type=f32)
# ---------------------------------------------------------------------------

def _offset_mask(tq: int, tk: int, q_offset: int, kv_offset: int,
                 device) -> torch.Tensor:
    gq = q_offset + torch.arange(tq, device=device)
    gk = kv_offset + torch.arange(tk, device=device)
    return gq[:, None] >= gk[None, :]


def block_attend_reference(q, k, v, *, scale: float, causal: bool,
                           q_offset: int = 0, kv_offset: int = 0):
    """Partial attention of q against one KV range, returning
    ``(pv, m, l)`` (twin of ``lax_block_attend`` with the mask built from
    global offsets, as ``_lax_block_attend`` does)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        mask = _offset_mask(q.shape[1], k.shape[1], q_offset, kv_offset,
                            q.device)
        s = torch.where(mask, s, torch.full_like(s, _NEG_BIG))
    m = s.amax(dim=-1)                                   # [B, H, Tq]
    p = torch.exp(s - m[..., None])
    if mask is not None:
        p = p * mask.to(p.dtype)
    l = p.sum(dim=-1)                                    # [B, H, Tq]
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return pv, m, l


def attention_reference(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Exact full attention (twin of ``ring_attention_reference``), in
    float32 throughout; returns q's dtype."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones(t, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_BIG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _check(q, k, v) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise DMLCError("flash_fwd kernel needs CUDA tensors")
    if not (q.device == k.device == v.device):
        raise DMLCError("q, k, v on different devices")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise DMLCError(f"flash_fwd takes one dtype of float32/bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise DMLCError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                        f"v {tuple(v.shape)}: expected [B, T, H, D]")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise DMLCError("q and k/v disagree on B, H or D")
    if d not in (64, 128):
        raise DMLCError(f"flash_fwd takes head dim 64 or 128, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise DMLCError(f"{name} must be contiguous in its last dim")


def _launch(q, k, v, *, scale: float, causal: bool, q_offset: int,
            kv_offset: int, normalize: bool):
    _check(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    out = torch.empty((b, tq, h, d), device=q.device,
                      dtype=q.dtype if normalize else torch.float32)
    m = torch.empty((b, h, tq), device=q.device, dtype=torch.float32)
    l = torch.empty((b, h, tq), device=q.device, dtype=torch.float32)
    sq, sk, sv = q.stride(), k.stride(), v.stride()
    FLASH_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], sv[0], sv[1], sv[2],
        out.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, h, tq, tk, d, _DTYPES[q.dtype], int(causal), int(q_offset),
        int(kv_offset), float(scale), int(normalize), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    return out, m, l


def _route(impl: Optional[str], *tensors) -> str:
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "flash attention is forward-only in this slice; the backward "
            "kernels (dK/dV and dQ) come with the training slice")
    if impl is None:
        return "cuda" if tensors[0].is_cuda else "torch"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown flash-attention impl {impl!r}")
    return impl


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Exact attention ``[B, T, H, D]`` → o in q's dtype: kernel K1 with
    the normalisation ``pv / max(l, 1e-20)`` fused into its epilogue on a
    CUDA tensor, :func:`attention_reference` on a CPU tensor."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if _route(impl, q, k, v) == "torch":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    o, _, _ = _launch(q, k, v, scale=scale, causal=causal, q_offset=0,
                      kv_offset=0, normalize=True)
    return o


def block_attend(q, k, v, *, scale: float, causal: bool, q_offset: int = 0,
                 kv_offset: int = 0, impl: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial attention of q against one KV range at global offsets:
    ``(pv, m, l)``, the contract the ring step folds across ranks."""
    if _route(impl, q, k, v) == "torch":
        return block_attend_reference(q, k, v, scale=scale, causal=causal,
                                      q_offset=q_offset, kv_offset=kv_offset)
    return _launch(q, k, v, scale=scale, causal=causal, q_offset=q_offset,
                   kv_offset=kv_offset, normalize=False)
