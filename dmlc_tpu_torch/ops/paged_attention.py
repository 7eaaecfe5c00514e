"""Paged decode attention: CUDA kernel K4 and its plain PyTorch version.

Port of ``dmlc_tpu/ops/paged_attention.py`` (``_lax_paged_attention``
:58, ``_pallas_paged_attention`` :126, ``paged_attention`` :175).  Window
queries attend one layer's KV pool in place through per-sequence block
tables:

    q               : [B, S, H, D]   (post-rope window queries, S <= 8)
    k_pool / v_pool : [n_blocks, block_size, H, D]
    block_tables    : [B, W] int32   (row b's physical block ids)
    lengths         : [B]    int32   (committed tokens before the window)

Window row ``s`` of sequence ``b`` attends pool positions
``p <= lengths[b] + s`` within the table's ``W * block_size`` span; the
caller scatters the window's own K/V into the pool first.  Returns
``[B, S, H, D]`` in q's dtype.

Dispatch is on the tensors' device: a CPU tensor goes to the plain
version, a CUDA tensor to ``csrc/paged_attention.cu`` (or a raise).  The
kernel cuts each row's KV walk into splits of whole pages (about
``_SPLIT_TOKENS`` tokens), one thread block each, and merges the splits'
partial ``(pv, m, l)`` from an f32 workspace this wrapper allocates.
``impl="cuda"|"torch"`` forces one of the two, for comparisons.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..base import DMLCError
from ..telemetry import compute
from ._build import Kernel, rows_aligned

__all__ = ["paged_attention", "paged_attention_reference", "kernel_cost",
           "PAGED_ATTENTION"]

_NEG_BIG = -1e30
_MAX_WINDOW = 8
_SPLIT_TOKENS = 128   # KV tokens a block of the kernel reads, at most

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
PAGED_ATTENTION = Kernel("paged_attention.cu", "dmlc_paged_attention",
                         [_P, _L, _L, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _I, _I, _I, _F, _I, _P])

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_reference(q, k_pool, v_pool, block_tables, lengths,
                              scale: float) -> torch.Tensor:
    """Gather-composed twin of ``_lax_paged_attention``, in float32
    (scores and the probability-value product, as the kernel)."""
    b, s_w, h, d = q.shape
    w = block_tables.shape[1]
    bs = k_pool.shape[1]
    tables = block_tables.long()
    k_ctx = k_pool[tables].reshape(b, w * bs, h, d).float()
    v_ctx = v_pool[tables].reshape(b, w * bs, h, d).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_ctx) * scale
    pos = torch.arange(w * bs, device=q.device)
    limit = lengths.long()[:, None] + torch.arange(s_w, device=q.device)
    keep = pos[None, None, :] <= limit[:, :, None]               # [B, S, K]
    s = torch.where(keep[:, None], s, torch.full_like(s, _NEG_BIG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v_ctx).to(q.dtype)


def _check(q, k_pool, v_pool, block_tables, lengths) -> None:
    ts = (q, k_pool, v_pool, block_tables, lengths)
    if not all(t.is_cuda for t in ts):
        raise DMLCError("paged_attention kernel needs CUDA tensors")
    if len({t.device for t in ts}) != 1:
        raise DMLCError("paged_attention inputs on different devices")
    if q.dtype not in _DTYPES or not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise DMLCError(f"paged_attention takes one dtype of float32/bfloat16"
                        f", got q {q.dtype}, pools {k_pool.dtype}/"
                        f"{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise DMLCError("block_tables and lengths must be int32")
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise DMLCError(f"shapes q {tuple(q.shape)} pool "
                        f"{tuple(k_pool.shape)}: expected [B, S, H, D] and "
                        f"[n_blocks, block_size, H, D]")
    b, s_w, h, d = q.shape
    _, bs, hp, dp = k_pool.shape
    if (hp, dp) != (h, d):
        raise DMLCError("q and the pools disagree on H or D")
    if d not in (64, 128):
        raise DMLCError(f"paged_attention takes head dim 64 or 128, got {d}")
    if not 1 <= s_w <= _MAX_WINDOW:
        raise DMLCError(f"window of {s_w} rows; the kernel takes 1..8")
    if bs % 8 or bs > 128:
        raise DMLCError(f"block_size {bs}: the kernel takes multiples of 8 "
                        f"up to 128")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise DMLCError("block_tables must be [B, W] and lengths [B]")
    if q.stride(-1) != 1:
        raise DMLCError("q must be contiguous in its last dim")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise DMLCError(f"{name} must be contiguous")


def kv_splits(width: int, block_size: int) -> int:
    """Splits of the kernel's KV walk over a table ``width`` pages wide.
    The kernel gives each split ``ceil(width / kv_splits)`` whole pages,
    at most ``_SPLIT_TOKENS`` tokens (one page where a page is larger)."""
    return max(1, -(-width // max(1, _SPLIT_TOKENS // block_size)))


def kernel_cost(q, k_pool, block_tables, lengths):
    """``(FLOPs, bytes)`` of one K4 call on these inputs, as its roofline
    bound counts them: 4·D FLOPs a head for each visible (window row,
    key) pair, and each visible K/V row, q, the output, the tables and
    the lengths moved once.  Reads ``lengths`` on the host."""
    b, s_w, h, d = q.shape
    span = block_tables.shape[1] * k_pool.shape[1]
    lens = lengths.tolist()
    pairs = sum(min(n + s + 1, span) for n in lens for s in range(s_w))
    visible = sum(min(n + s_w, span) for n in lens)
    el = q.element_size()
    nbytes = (2 * visible * h * d * el + 2 * q.numel() * el
              + 4 * (block_tables.numel() + lengths.numel()))
    return 4.0 * h * d * pairs, float(nbytes)


def _launch(q, k_pool, v_pool, block_tables, lengths, scale: float):
    _check(q, k_pool, v_pool, block_tables, lengths)
    if compute.counting():   # a cost pass cannot see a ctypes launch
        compute.add_kernel_cost(*kernel_cost(q, k_pool, block_tables,
                                             lengths))
    if not rows_aligned(q):  # the kernel reads q in 16-byte vectors
        q = q.clone(memory_format=torch.contiguous_format)
    b, s_w, h, d = q.shape
    w, bs = block_tables.shape[1], k_pool.shape[1]
    n_split = kv_splits(w, bs)
    # per split and window row: pv [D], then m and l
    ws = torch.empty(b * h * n_split * s_w * (d + 2), device=q.device,
                     dtype=torch.float32)
    out = torch.empty((b, s_w, h, d), device=q.device, dtype=q.dtype)
    sq = q.stride()
    PAGED_ATTENTION.launch(
        q.data_ptr(), sq[0], sq[1], sq[2], k_pool.data_ptr(),
        v_pool.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), ws.data_ptr(), b, h, s_w, w, bs, n_split, d,
        _DTYPES[q.dtype], float(scale), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    return out


def paged_attention(q, k_pool, v_pool, block_tables, lengths, *,
                    scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Window attention against one layer's paged KV pool (see the module
    docstring for shapes and the mask)."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if impl is None:
        impl = "cuda" if q.is_cuda else "torch"
    if impl == "torch":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         lengths, float(scale))
    if impl != "cuda":
        raise ValueError(f"unknown paged-attention impl {impl!r}")
    return _launch(q, k_pool, v_pool, block_tables, lengths, float(scale))
