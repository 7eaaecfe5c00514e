"""Port parity: flash attention's plain versions (K1's forward, K2/K3's
backward) against dmlc_tpu's Pallas kernels in interpret mode and its
oracles.

The shapes are those of tests/test_flash_attention.py: aligned (T=64,
blocks 32) and unaligned tails (T=200, 77 with blocks 64).  Float32 on
the CPU.  Forward: 2e-5, the JAX suite's own kernel-vs-oracle bound.
Backward: 1e-4 (abs and rel): the gradients sum T products of O(1)
terms in another order than the reference.  The CUDA kernels
themselves are checked in tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmlc_tpu.ops.flash_attention import _flash_attn_impl, _flash_backward
from dmlc_tpu.ops.flash_attention import flash_attention as jflash
from dmlc_tpu.ops.flash_attention import lax_block_attend
from dmlc_tpu.parallel.ring_attention import ring_attention_reference
from dmlc_tpu_torch.base import DMLCError
from dmlc_tpu_torch.ops import flash_attention as tflash

TOL = 2e-5
GRAD_TOL = 1e-4


def _qkv(seed, b, tq, tk, h, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, h, d)).astype(np.float32),
            rng.standard_normal((b, tk, h, d)).astype(np.float32),
            rng.standard_normal((b, tk, h, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,block", [(64, 32), (200, 64), (77, 64)])
def test_flash_attention_matches_pallas_interpret(causal, t, block):
    q, k, v = _qkv(0, 1 if t != 64 else 2, t, t, 2, 128)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, block_q=block, block_k=block,
                  interpret=True)
    got = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_reference_matches_ring_oracle(causal):
    q, k, v = _qkv(1, 2, 48, 48, 3, 64)
    want = ring_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    got = tflash.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("q_off,kv_off,tk", [(32, 32, 32), (0, 0, 40),
                                             (8, 40, 24)])
def test_block_attend_reference_matches_lax_with_offsets(q_off, kv_off, tk):
    """The ring-step (pv, m, l) contract with global offsets; the last
    case leaves early rows with no visible key (m = -1e30, l = 0)."""
    q, k, v = _qkv(2, 1, 32, tk, 2, 128)
    scale = 1.0 / 128 ** 0.5
    gq = q_off + np.arange(32)
    gk = kv_off + np.arange(tk)
    mask = jnp.asarray(gq[:, None] >= gk[None, :])
    want = lax_block_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            scale=scale, mask=mask)
    got = tflash.block_attend(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=scale, causal=True,
                              q_offset=q_off, kv_offset=kv_off)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    assert all(torch.isfinite(g).all() for g in got)


def _torch_grads(q, k, v, w, causal):
    """d/dq,k,v of sum(flash_attention(q, k, v) * w) through the op."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = tflash.flash_attention(*ts, causal=causal)
    (o * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,block", [(64, 32), (200, 64), (77, 64)])
def test_flash_gradients_match_jax_grad(causal, t, block):
    """The port's backward (custom op, plain versions on the CPU) against
    jax.grad through the reference's custom VJP, whose backward runs the
    dK/dV and dQ Pallas kernels in interpret mode, and against jax.grad
    of the dense oracle."""
    q, k, v = _qkv(5, 1, t, t, 2, 128)
    w = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    got = _torch_grads(q, k, v, w, causal)

    def f_flash(q, k, v):
        o = jflash(q, k, v, causal=causal, block_q=block, block_k=block,
                   interpret=True)
        return jnp.sum(o * w)

    def f_ref(q, k, v):
        return jnp.sum(ring_attention_reference(q, k, v, causal=causal) * w)

    args = tuple(jnp.asarray(a) for a in (q, k, v))
    for f in (f_flash, f_ref):
        want = jax.grad(f, argnums=(0, 1, 2))(*args)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w_), rtol=GRAD_TOL,
                                       atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [64, 77])
def test_flash_backward_reference_matches_pallas_backward(causal, t):
    """``flash_backward_reference`` on the reference forward's own
    ``(o, lse)`` against ``_flash_backward`` (both Pallas passes,
    interpret mode, blocks of 32; T=77 pads Q rows and masks KV rows)."""
    q, k, v = _qkv(7, 2, t, t, 2, 128)
    do = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    scale = 128 ** -0.5
    static = (scale, causal, 32, 32, True)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = _flash_attn_impl(static, jq, jk, jv)
    want = _flash_backward(static, jq, jk, jv, o, lse, jdo)
    got = tflash.flash_backward_reference(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)),
        scale=scale, causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def _backward_bf16_operands(q, k, v, o, lse, do, *, scale, causal):
    """The plain backward with P and dS rounded to bf16 before the
    products that take them (dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K), as the
    tensor-core kernels feed them to the bf16 tensor cores; everything
    else as ``flash_backward_reference`` (f32, dS from the f32 P)."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(torch.ones_like(p, dtype=torch.bool).tril(), p,
                        torch.zeros_like(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None])
    p16, ds16 = (x.to(torch.bfloat16).float() for x in (p, ds))
    dv = torch.einsum("bhqk,bqhd->bkhd", p16, dof)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [77, 200])
def test_bf16_operand_rounding_within_backward_tolerance(causal, t):
    """The rounding budget of the bf16 backward kernels: their one added
    rounding (P and dS to bf16 as tensor-core operands) keeps every
    gradient within the 1e-2 relative norm they are held to on the card
    (tests/test_torch_kernels.py), here at D=128 on bf16 inputs.  The
    emulation lives in this test, not in the package."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(12, 2, t, t, 2, 128))
    do = torch.from_numpy(np.random.default_rng(13).standard_normal(
        q.shape).astype(np.float32)).to(torch.bfloat16)
    scale = 128 ** -0.5
    o, lse = torch.ops.dmlc_tpu_torch.flash_attn_fwd(q, k, v, scale, causal,
                                                     None)
    kw = dict(scale=scale, causal=causal)
    want = tflash.flash_backward_reference(q, k, v, o, lse, do, **kw)
    got = _backward_bf16_operands(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        err = ((g.float() - w.float()).norm() / w.float().norm()).item()
        assert 0 < err <= 1e-2


def _forward_bf16_p(q, k, v, *, scale, causal, block=64):
    """The bf16 forward kernel's tile loop: f32 scores and online
    softmax over 64-key tiles, P rounded to bf16 before ``O += P V``
    (f32 sums), l summed from the f32 P; o = pv / max(l, 1e-20) in q's
    dtype."""
    qf, kf, vf = q.float(), k.float(), v.float()
    b, t, h, _ = q.shape
    m = torch.full((b, h, t), -1e30)
    l = torch.zeros((b, h, t))
    acc = torch.zeros((b, h, t, q.shape[-1]))
    for k0 in range(0, k.shape[1], block):
        kt, vt = kf[:, k0:k0 + block], vf[:, k0:k0 + block]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt) * scale
        if causal:
            keep = (torch.arange(t)[:, None]
                    >= k0 + torch.arange(kt.shape[1])[None, :])
            s = torch.where(keep, s, torch.full_like(s, -torch.inf))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    return (acc / l.clamp_min(1e-20)[..., None]).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [77, 200])
def test_bf16_p_rounding_within_forward_tolerance(causal, t):
    """The rounding budget of the bf16 forward kernel: its one added
    rounding (P to bf16 as the tensor-core operand of P V, where the
    reference multiplies in f32) keeps o within the bf16 tolerance it is
    held to on the card, 2e-2 max and 2e-3 mean abs (``BF16_TOL`` of
    chip_smoke.py), here at D=128 on bf16 inputs: it reads max 3.9e-3 to
    7.8e-3 (one or two bf16 ulps of o), mean 1.3e-4 to 2.5e-4.  The
    emulation lives in this test, not in the package."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(14, 2, t, t, 2, 128))
    scale = 128 ** -0.5
    want = tflash.attention_reference(q, k, v, causal=causal, scale=scale)
    got = _forward_bf16_p(q, k, v, scale=scale, causal=causal)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert 0 < err.max().item() <= 2e-2
    assert err.mean().item() <= 2e-3


@pytest.mark.parametrize("causal", [True, False])
def test_flash_op_gradients_equal_autograd_of_reference(causal):
    """Through the custom op against torch autograd through the dense
    ``attention_reference``; q and k/v of different lengths."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 40, 3, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 3, 64)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal(q.shape).astype(np.float32)
    got = _torch_grads(q, k, v, w, causal)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (tflash.attention_reference(*ts, causal=causal)
     * torch.from_numpy(w)).sum().backward()
    for g, t_ in zip(got, ts):
        np.testing.assert_allclose(g, t_.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_flash_attention_is_differentiable():
    """Inputs that require grad go through; lse's cotangent is unused."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(3, 1, 8, 8, 1, 64))
    tflash.flash_attention(q, k, v).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


def test_block_attend_is_forward_only():
    """The ring-step contract has no backward in this port yet; under
    no_grad it runs."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 8, 8, 1, 64))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="sharded slice"):
        tflash.block_attend(q, k, v, scale=0.125, causal=True)
    with torch.no_grad():
        assert tflash.block_attend(q, k, v, scale=0.125, causal=True)[0] \
            .shape == (1, 8, 1, 64)


def test_flash_kernel_refuses_cpu_tensors():
    """impl="cuda" on CPU tensors raises; it never falls back."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 8, 8, 1, 64))
    with pytest.raises(DMLCError, match="CUDA"):
        tflash.flash_attention(q, k, v, impl="cuda")
