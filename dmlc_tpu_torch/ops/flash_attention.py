"""Flash attention: CUDA kernels K1 (forward), K2 (dK/dV) and K3 (dQ), and
their plain PyTorch versions.

Port of ``dmlc_tpu/ops/flash_attention.py`` (``lax_block_attend`` :132,
``_flash_forward`` :212, ``_flash_backward`` :430, the ``_flash_attn``
custom VJP :526-557, ``flash_attention`` :560) plus the oracle
``ring_attention_reference`` (``dmlc_tpu/parallel/ring_attention.py:151``).

Layout is the reference's: q/k/v ``[B, T, H, D]``; the partial-attention
contract is ``(pv [B, Tq, H, D] f32, m [B, H, Tq] f32, l [B, H, Tq] f32)``
with causal masks on global positions ``q_offset + i >= kv_offset + j``.

``flash_attention`` is differentiable.  Its forward and backward are the
custom ops ``dmlc_tpu_torch::flash_attn_fwd`` (returning ``(o, lse)``,
the residuals the backward needs besides q, k, v) and
``dmlc_tpu_torch::flash_attn_bwd``, tied by ``register_autograd``.  They
are ops, not a Python ``autograd.Function``, so that a selective
checkpoint policy can see the forward and keep its outputs (the
``save_flash`` remat policy of ``models/transformer.py``), as the
reference's ``checkpoint_name("flash_o" / "flash_lse")`` tags do.

Dispatch is on the tensors' device: each op has a ``"cpu"``
implementation that runs the plain versions and a ``"cuda"`` one that
launches the kernels in ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``
(or raises, for a shape they do not take).  ``impl="cuda"|"torch"``
forces one of the two, for comparisons.

``block_attend``, the ring step's ``(pv, m, l)`` contract at global
offsets, is differentiable as the reference's ``block_attend_flash``
is (``_flash_core`` :162-183): its forward is K1 at the offsets
(unnormalised) on a CUDA tensor, and its backward recomputes the plain
``block_attend_reference`` under autograd, as the reference's VJP
rematerialises through its lax twin ``_lax_block_attend`` (:150-160)
rather than the Pallas backward kernels.  The recompute holds a
``[B, H, Tq, Tk]`` float32 score matrix.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from ..base import DMLCError
from ..telemetry import compute
from ._build import Kernel, rows_aligned

__all__ = ["flash_attention", "flash_backward", "flash_backward_reference",
           "block_attend", "attention_reference", "block_attend_reference",
           "FLASH_FWD", "FLASH_BWD_DKV", "FLASH_BWD_DQ"]

_NEG_BIG = -1e30

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
FLASH_FWD = Kernel("flash_fwd.cu", "dmlc_flash_fwd",
                   [_P, _P, _P, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                    _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                    _I, _P])
_BWD_ARGS = [_P, _P, _P, _P, _STRIDES, _P, _P]
_BWD_TAIL = [_I, _I, _I, _I, _I, _I, _I, _F, _I, _P]
FLASH_BWD_DKV = Kernel("flash_bwd.cu", "dmlc_flash_bwd_dkv",
                       _BWD_ARGS + [_P, _P] + _BWD_TAIL)
FLASH_BWD_DQ = Kernel("flash_bwd.cu", "dmlc_flash_bwd_dq",
                      _BWD_ARGS + [_P] + _BWD_TAIL)

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


def _forward_reference(q, k, v, scale: float, causal: bool):
    """Plain ``(o, lse)``: o from :func:`attention_reference`, lse the
    log-sum-exp of the same masked f32 scores ``[B, H, Tq]``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = _offset_mask(q.shape[1], k.shape[1], 0, 0, q.device)
        s = torch.where(mask, s, torch.full_like(s, _NEG_BIG))
    return (attention_reference(q, k, v, causal=causal, scale=scale),
            torch.logsumexp(s, dim=-1))


def _delta(o: Tensor, do: Tensor) -> Tensor:
    """``rowsum(dO * O)`` in f32 from o as stored (q's dtype, rounded as
    the reference's :444), laid out ``[B, H, Tq]`` like lse."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_backward_reference(q, k, v, o, lse, do, *, scale: float,
                             causal: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain backward over the saved ``(o, lse)`` (the math of
    ``_flash_backward`` :283-291): recompute ``P = exp(S*scale - lse)``
    under the mask, then ``dV = Pᵀ dO``, ``dS = P ∘ (dO Vᵀ - delta)``,
    ``dQ = scale·dS K``, ``dK = scale·dSᵀ Q``, all in f32, cast to the
    inputs' dtypes."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        mask = _offset_mask(q.shape[1], k.shape[1], 0, 0, q.device)
        p = torch.where(mask, p, torch.zeros_like(p))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - _delta(o, do)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check(name: str, *tensors) -> None:
    q, k, v = tensors[:3]
    if not all(t.is_cuda for t in tensors):
        raise DMLCError(f"{name} kernel needs CUDA tensors")
    if any(t.device != q.device for t in tensors):
        raise DMLCError(f"{name}: tensors on different devices")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise DMLCError(f"{name} takes one dtype of float32/bfloat16, got "
                        f"{[t.dtype for t in tensors]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise DMLCError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                        f"v {tuple(v.shape)}: expected [B, T, H, D]")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise DMLCError("q and k/v disagree on B, H or D")
    if any(t.shape != q.shape for t in tensors[3:]):
        raise DMLCError(f"{name}: o/dO must have q's shape")
    if d not in (64, 128):
        raise DMLCError(f"{name} takes head dim 64 or 128, got {d}")
    for i, x in enumerate(tensors):
        if x.stride(-1) != 1:
            raise DMLCError(f"{name}: input {i} must be contiguous in its "
                            "last dim")


def _launch(q, k, v, *, scale: float, causal: bool, q_offset: int,
            kv_offset: int, normalize: bool):
    _check("flash_fwd", q, k, v)
    q, k, v = _aligned_bf16(q, k, v)
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


def _aligned_bf16(*xs: Tensor):
    """bf16 inputs with every row on 16 bytes: the tensor-core kernels
    copy rows in 16-byte chunks, so a tensor whose rows do not start on
    one is copied; f32 inputs pass as they are."""
    if xs[0].dtype != torch.bfloat16:
        return xs
    return tuple(x if rows_aligned(x) else
                 x.clone(memory_format=torch.contiguous_format) for x in xs)


class _Backward:
    """One backward's checked inputs, ``delta`` and fresh ``dq, dk, dv``,
    with a launcher for each kernel: :meth:`launch_dkv` (K2) and
    :meth:`launch_dq` (K3).  The object holds every tensor behind the
    C arguments, so it must outlive the launches."""

    def __init__(self, q, k, v, o, lse, do, *, scale: float, causal: bool):
        if do.stride(-1) != 1:  # autograd may hand in a strided cotangent
            do = do.contiguous()
        _check("flash_bwd", q, k, v, o, do)
        b, tq, h, d = q.shape
        if lse.shape != (b, h, tq) or lse.dtype != torch.float32:
            raise DMLCError(f"lse must be float32 [B, H, Tq], got "
                            f"{lse.dtype} {tuple(lse.shape)}")
        self.delta = _delta(o, do)
        q, k, v, do = _aligned_bf16(q, k, v, do)
        self.inputs, self.lse = (q, k, v, do), lse.contiguous()
        self.dq, self.dk, self.dv = (
            torch.empty_like(x, memory_format=torch.contiguous_format)
            for x in (q, k, v))
        strides = (ctypes.c_longlong * 12)(*(
            s for x in (q, k, v, do) for s in x.stride()[:3]))
        self._head = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      do.data_ptr(), strides, self.lse.data_ptr(),
                      self.delta.data_ptr())
        self._tail = (b, h, tq, k.shape[1], d, _DTYPES[q.dtype],
                      int(causal), float(scale), q.device.index or 0,
                      torch.cuda.current_stream(q.device).cuda_stream)

    def launch_dkv(self) -> None:
        FLASH_BWD_DKV.launch(*self._head, self.dk.data_ptr(),
                             self.dv.data_ptr(), *self._tail)

    def launch_dq(self) -> None:
        FLASH_BWD_DQ.launch(*self._head, self.dq.data_ptr(), *self._tail)


def flash_backward(q, k, v, o, lse, do, *, scale: float,
                   causal: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """Kernels K2 (dK, dV) and K3 (dQ) over the saved ``(o, lse)``; the
    twin of :func:`flash_backward_reference`.  ``delta`` is a plain
    torch expression, as the reference computes it in XLA."""
    bwd = _Backward(q, k, v, o, lse, do, scale=scale, causal=causal)
    bwd.launch_dkv()
    bwd.launch_dq()
    return bwd.dq, bwd.dk, bwd.dv


# ---------------------------------------------------------------------------
# the differentiable op: forward (o, lse) and backward, by device
# ---------------------------------------------------------------------------

def _use_kernel(device_type: str, impl: Optional[str]) -> bool:
    return impl == "cuda" if impl is not None else device_type == "cuda"


def _fwd(q: Tensor, k: Tensor, v: Tensor, scale: float, causal: bool,
         impl: Optional[str]) -> Tuple[Tensor, Tensor]:
    if not _use_kernel(q.device.type, impl):
        return _forward_reference(q, k, v, scale, causal)
    o, m, l = _launch(q, k, v, scale=scale, causal=causal, q_offset=0,
                      kv_offset=0, normalize=True)
    return o, m + torch.log(l.clamp_min(1e-20))


def _bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
         do: Tensor, scale: float, causal: bool,
         impl: Optional[str]) -> Tuple[Tensor, Tensor, Tensor]:
    fn = (flash_backward if _use_kernel(q.device.type, impl)
          else flash_backward_reference)
    return fn(q, k, v, o, lse, do, scale=scale, causal=causal)


flash_attn_fwd_op = torch.library.custom_op(
    "dmlc_tpu_torch::flash_attn_fwd", mutates_args=(),
    device_types=("cpu", "cuda"))(_fwd)
_flash_attn_bwd_op = torch.library.custom_op(
    "dmlc_tpu_torch::flash_attn_bwd", mutates_args=(),
    device_types=("cpu", "cuda"))(_bwd)


def _setup_context(ctx, inputs, output):
    q, k, v, ctx.scale, ctx.causal, ctx.impl = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)


def _backward(ctx, do, _dlse):
    # nothing downstream reads lse, so its cotangent is ignored (as the
    # reference's custom VJP has no lse output at all)
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = _flash_attn_bwd_op(q, k, v, o, lse, do, ctx.scale,
                                    ctx.causal, ctx.impl)
    return dq, dk, dv, None, None, None


flash_attn_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def _pairs(tq: int, tk: int, causal: bool) -> int:
    """The (query, key) pairs a head attends: row i of a causal call sees
    keys 0..i."""
    if not causal:
        return tq * tk
    n = min(tq, tk)
    return n * (n + 1) // 2 + (tq - n) * tk


def _fwd_flops(args, kwargs, out) -> float:
    """K1: 4·D FLOPs a visible pair (the scores and the value product)."""
    q, k, causal = args[0], args[1], args[4]
    b, tq, h, d = q.shape
    return 4.0 * b * h * d * _pairs(tq, k.shape[1], causal)


def _bwd_flops(args, kwargs, out) -> float:
    """K2 + K3: 8·D and 6·D FLOPs a visible pair."""
    q, k, causal = args[0], args[1], args[7]
    b, tq, h, d = q.shape
    return 14.0 * b * h * d * _pairs(tq, k.shape[1], causal)


# the cost pass sees each op whole, whichever device runs it; the same
# counts as the kernels' roofline bounds
compute.register_flops("dmlc_tpu_torch::flash_attn_fwd", _fwd_flops)
compute.register_flops("dmlc_tpu_torch::flash_attn_bwd", _bwd_flops)


def _route(impl: Optional[str]) -> None:
    if impl not in (None, "cuda", "torch"):
        raise ValueError(f"unknown flash-attention impl {impl!r}")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Exact attention ``[B, T, H, D]`` → o in q's dtype, differentiable:
    on a CUDA tensor kernel K1 forward (normalisation fused into its
    epilogue) and K2 + K3 backward, on a CPU tensor the plain versions."""
    _route(impl)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o, _ = flash_attn_fwd_op(q, k, v, float(scale), bool(causal), impl)
    return o


class _BlockAttend(torch.autograd.Function):
    """K1 (or its plain version) forward; the plain recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q_offset, kv_offset, kernel):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(scale=scale, causal=causal, q_offset=q_offset,
                        kv_offset=kv_offset)
        if kernel:
            return _launch(q, k, v, normalize=False, **ctx.args)
        return block_attend_reference(q, k, v, **ctx.args)

    @staticmethod
    def backward(ctx, dpv, dm, dl):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(t.requires_grad)
                      for t in (q, k, v)]
            outs = block_attend_reference(*leaves, **ctx.args)
            want = [t for t in leaves if t.requires_grad]
            cts = [torch.zeros_like(o) if g is None else g
                   for o, g in zip(outs, (dpv, dm, dl))]
            got = iter(torch.autograd.grad(outs, want, cts,
                                           allow_unused=True))
        grads = [next(got) if t.requires_grad else None for t in leaves]
        return (*grads, None, None, None, None, None)


def block_attend(q, k, v, *, scale: float, causal: bool, q_offset: int = 0,
                 kv_offset: int = 0, impl: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial attention of q against one KV range at global offsets:
    ``(pv, m, l)``, the contract the ring step folds across ranks.
    Differentiable: K1 forward on a CUDA tensor (the plain version on a
    CPU tensor), the plain recompute backward on either."""
    _route(impl)
    return _BlockAttend.apply(q, k, v, float(scale), bool(causal),
                              int(q_offset), int(kv_offset),
                              _use_kernel(q.device.type, impl))
