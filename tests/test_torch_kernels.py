"""The port's CUDA kernels against their plain PyTorch versions, on a card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a card.  The module imports no jax, so it also runs where
jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances: f32 1e-4 (summation order); bf16 2e-2 (one bf16 ulp of an
output of magnitude up to ~4, both sides rounding the same f32 result).
The backward kernels (K2 dK/dV, K3 dQ) are held to the plain backward by
the relative norm ``|g - g_ref| / |g_ref|``: 1e-4 in f32 (the FMA tiles:
summation order only), 1e-2 in bf16.  In bf16 the kernels run their
products on the tensor cores, which take bf16 operands: besides the one
rounding of each gradient at the store (a bf16 ulp is 2^-8 ~ 3.9e-3
relative), P and dS are rounded to bf16 before the products dV = Pᵀ dO,
dK = dSᵀ Q and dQ = dS K.  Those roundings are independent and
relative 2^-9 each, so they add ~1e-3 to the relative norm, not more:
tests/test_torch_flash_attention.py holds an emulation of exactly that
rounding to the same 1e-2 on the CPU.
"""

import numpy as np
import pytest
import torch

from dmlc_tpu_torch.ops import flash_attention as tflash
from dmlc_tpu_torch.ops import paged_attention as tpaged

CASES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CASES)
@pytest.mark.parametrize("t", [64, 200, 77])
def test_flash_kernel_matches_plain(card, dtype, tol, t):
    rng = np.random.default_rng(t)
    q, k, v = (_randn(rng, 2, t, 4, 128).to(card, dtype) for _ in range(3))
    for causal in (True, False):
        got = tflash.flash_attention(q, k, v, causal=causal)
        want = tflash.flash_attention(q, k, v, causal=causal, impl="torch")
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("q_off,kv_off,tk", [(32, 32, 32), (0, 0, 40),
                                             (8, 40, 24)])
def test_flash_kernel_block_attend_offsets(card, q_off, kv_off, tk):
    rng = np.random.default_rng(1)
    q = _randn(rng, 1, 32, 2, 64).to(card)
    k, v = (_randn(rng, 1, tk, 2, 64).to(card) for _ in range(2))
    kw = dict(scale=64 ** -0.5, causal=True, q_offset=q_off,
              kv_offset=kv_off)
    for g, w in zip(tflash.block_attend(q, k, v, **kw),
                    tflash.block_attend(q, k, v, impl="torch", **kw)):
        assert torch.isfinite(g).all()
        assert ((g - w).abs() / w.abs().clamp_min(1.0)).max().item() <= 1e-4


def _bwd_inputs(card, dtype, t, d, layout, seed):
    """q, k, v, dO ``[2, t, 4, d]``; with ``layout="qkv"`` q, k and v
    are slices of one ``[2, t, 3, 4, d]`` tensor (row stride 3·H·D);
    with ``"unaligned"`` slices ``[..., 1:d + 1]`` of a wider tensor,
    whose rows start 2 or 4 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    if layout == "qkv":
        qkv = _randn(rng, 2, t, 3, 4, d).to(card, dtype)
        q, k, v = qkv.unbind(2)
    elif layout == "unaligned":
        q, k, v = (_randn(rng, 2, t, 4, d + 1).to(card, dtype)[..., 1:]
                   for _ in range(3))
    else:
        q, k, v = (_randn(rng, 2, t, 4, d).to(card, dtype)
                   for _ in range(3))
    return q, k, v, _randn(rng, 2, t, 4, d).to(card, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("t", [64, 77, 200])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", ["contiguous", "qkv", "unaligned"])
def test_flash_backward_kernels_match_plain(card, dtype, tol, t, d, layout):
    q, k, v, do = _bwd_inputs(card, dtype, t, d, layout, t + 1)
    launches = (tflash.FLASH_BWD_DKV.launches, tflash.FLASH_BWD_DQ.launches)
    for causal in (True, False):
        kw = dict(scale=d ** -0.5, causal=causal)
        o, lse = torch.ops.dmlc_tpu_torch.flash_attn_fwd(
            q, k, v, kw["scale"], causal, "torch")
        got = tflash.flash_backward(q, k, v, o, lse, do, **kw)
        want = tflash.flash_backward_reference(q, k, v, o, lse, do, **kw)
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.isfinite(g).all()
            err = ((g.float() - w.float()).norm() / w.float().norm()).item()
            assert err <= tol, (causal, err)
    assert (tflash.FLASH_BWD_DKV.launches, tflash.FLASH_BWD_DQ.launches) == \
        (launches[0] + 2, launches[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_kernels_are_deterministic(card, dtype, d):
    """Two launches of K2 and K3 on the same inputs give bit-identical
    dq, dk and dv: every sum is taken in one fixed order, no atomics."""
    q, k, v, do = _bwd_inputs(card, dtype, 200, d, "contiguous", 11)
    kw = dict(scale=d ** -0.5, causal=True)
    o, lse = torch.ops.dmlc_tpu_torch.flash_attn_fwd(
        q, k, v, kw["scale"], True, None)
    first = tflash.flash_backward(q, k, v, o, lse, do, **kw)
    second = tflash.flash_backward(q, k, v, o, lse, do, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_backward_launches_kernels(card):
    """Autograd through flash_attention on the card runs K1 forward and
    K2 + K3 backward, and agrees with autograd of the dense reference."""
    rng = np.random.default_rng(5)
    ts = [_randn(rng, 1, 77, 2, 64).to(card).requires_grad_(True)
          for _ in range(3)]
    refs = [t.detach().clone().requires_grad_(True) for t in ts]
    w = _randn(rng, 1, 77, 2, 64).to(card)
    before = [kern.launches for kern in (tflash.FLASH_FWD,
                                         tflash.FLASH_BWD_DKV,
                                         tflash.FLASH_BWD_DQ)]
    (tflash.flash_attention(*ts) * w).sum().backward()
    (tflash.attention_reference(*refs) * w).sum().backward()
    after = [kern.launches for kern in (tflash.FLASH_FWD,
                                        tflash.FLASH_BWD_DKV,
                                        tflash.FLASH_BWD_DQ)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    for t, r in zip(ts, refs):
        assert ((t.grad - r.grad).norm() / r.grad.norm()).item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CASES)
@pytest.mark.parametrize("s_w", [1, 4])
def test_paged_kernel_matches_plain(card, dtype, tol, s_w):
    rng = np.random.default_rng(3)
    bs, w, n_blocks, lengths = 16, 8, 40, [1, 15, 16, 17, 8 * 16 - s_w]
    b = len(lengths)
    tables = torch.from_numpy(rng.permutation(n_blocks)[:b * w].reshape(
        b, w).astype(np.int32)).to(card)
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    q = _randn(rng, b, s_w, 4, 128).to(card, dtype)
    kp, vp = (_randn(rng, n_blocks, bs, 4, 128).to(card, dtype)
              for _ in range(2))
    got = tpaged.paged_attention(q, kp, vp, tables, lens)
    want = tpaged.paged_attention(q, kp, vp, tables, lens, impl="torch")
    assert (got.float() - want.float()).abs().max().item() <= tol
