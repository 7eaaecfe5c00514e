"""Port parity: paged decode attention (K4's plain version) against
dmlc_tpu's ``paged_attention`` with ``impl="lax"`` and with the Pallas
kernel in interpret mode, on the length matrix of
tests/test_decode_fast_path.py (single block, block-boundary straddles,
max length).  Float32 on the CPU, 1e-5 as in the JAX suite.  The
CUDA kernel itself is checked in tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmlc_tpu.ops.paged_attention import paged_attention as jpaged
from dmlc_tpu_torch.base import DMLCError
from dmlc_tpu_torch.ops import paged_attention as tpaged

TOL = 1e-5


def _case(seed, *, n_blocks, bs, w, h, d, s_w, lengths):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    tables = rng.permutation(n_blocks)[:b * w].reshape(b, w).astype(np.int32)
    return (rng.standard_normal((b, s_w, h, d)).astype(np.float32),
            rng.standard_normal((n_blocks, bs, h, d)).astype(np.float32),
            rng.standard_normal((n_blocks, bs, h, d)).astype(np.float32),
            tables, np.asarray(lengths, np.int32))


def _port(args, **kw):
    return tpaged.paged_attention(*(torch.from_numpy(a) for a in args),
                                  **kw).numpy()


@pytest.mark.parametrize("s_w", [1, 3])
def test_paged_matches_lax(s_w):
    bs, w = 4, 4
    lengths = [1, bs - 1, bs, bs + 1, 2 * bs + 1, w * bs - s_w]
    args = _case(0, n_blocks=24, bs=bs, w=w, h=2, d=8, s_w=s_w,
                 lengths=lengths)
    want = np.asarray(jpaged(*(jnp.asarray(a) for a in args), impl="lax"))
    np.testing.assert_allclose(_port(args), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s_w", [1, 3])
def test_paged_matches_pallas_interpret(s_w):
    bs, w = 8, 3
    lengths = [1, bs - 1, bs, bs + 1, w * bs - s_w]
    args = _case(1, n_blocks=16, bs=bs, w=w, h=1, d=128, s_w=s_w,
                 lengths=lengths)
    want = np.asarray(jpaged(*(jnp.asarray(a) for a in args),
                             impl="pallas", interpret=True))
    np.testing.assert_allclose(_port(args), want, rtol=TOL, atol=TOL)


def _split_combine(q, k_pool, v_pool, tables, lengths, scale, pages):
    """The CUDA kernel's split-KV scheme: each split of ``pages`` pages
    gives a partial ``(pv, m, l)`` over the positions it holds (a split
    no window row can see gives m = -1e30, l = 0, pv = 0), and the splits
    merge in split order with ``o = sum_j pv_j e^(m_j - M) /
    max(sum_j l_j e^(m_j - M), 1e-37)``, ``M = max_j m_j``."""
    b, s_w, h, d = q.shape
    w, bs = tables.shape[1], k_pool.shape[1]
    split = pages * bs
    k_ctx = k_pool[tables.long()].reshape(b, w * bs, h, d).float()
    v_ctx = v_pool[tables.long()].reshape(b, w * bs, h, d).float()
    limit = lengths.long()[:, None] + torch.arange(s_w)          # [B, S]
    parts = []
    for p0 in range(0, max(w, 1) * bs, split):
        pos = torch.arange(p0, min(p0 + split, w * bs))
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         k_ctx[:, pos]) * scale
        keep = (pos[None, None, :] <= limit[:, :, None])[:, None]
        s = torch.where(keep, s, torch.full_like(s, -torch.inf))
        m = s.amax(-1).clamp_min(-1e30)                          # [B, H, S]
        p = torch.exp(s - m[..., None])
        parts.append((torch.einsum("bhqk,bkhd->bhqd", p, v_ctx[:, pos]),
                      m, p.sum(-1)))
    big = torch.stack([m for _, m, _ in parts]).amax(0)
    pv = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(big)
    for pv_j, m_j, l_j in parts:
        c = torch.exp(m_j - big)
        pv = pv + pv_j * c[..., None]
        l = l + l_j * c
    return (pv / l.clamp_min(1e-37)[..., None]).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("s_w", [1, 4, 8])
@pytest.mark.parametrize("pages", [1, 3, 8, None])
def test_split_combine_matches_reference_and_lax(s_w, pages):
    """K4's split-and-combine, emulated in plain PyTorch, against the
    plain version and the JAX lax path (float32, 1e-5): several split
    sizes (``None``: the kernel's own for this block size), rows whose
    later splits are empty, a length-0 row with a zero table."""
    bs, w = 8, 12
    lengths = [0, 1, bs - 1, 2 * bs + 3, 5 * bs, w * bs - s_w]
    args = _case(3, n_blocks=80, bs=bs, w=w, h=2, d=64, s_w=s_w,
                 lengths=lengths)
    args[3][0] = 0
    ts = [torch.from_numpy(a) for a in args]
    got = _split_combine(*ts, 64 ** -0.5,
                         pages if pages else -(-w // tpaged.kv_splits(w, bs)))
    want = tpaged.paged_attention_reference(*ts, 64 ** -0.5)
    lax = np.asarray(jpaged(*(jnp.asarray(a) for a in args), impl="lax"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), lax, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("w", [0, 1, 7, 35, 64, 129])
@pytest.mark.parametrize("bs", [8, 16, 24, 128])
def test_kernel_splits_are_whole_pages(w, bs):
    """The kernel cuts a table W pages wide into kv_splits(W, bs) splits
    of ceil(W / splits) whole pages: at most 128 tokens (or one page),
    every page covered, no split past the table, as the C entry point
    requires (1 <= splits <= max(W, 1))."""
    n = tpaged.kv_splits(w, bs)
    pages = -(-w // n)
    assert 1 <= n <= max(w, 1)
    assert pages * bs <= max(128, bs)
    assert n * pages >= w
    assert tpaged.kv_splits(35, 16) == 5 and tpaged.kv_splits(64, 16) == 8


def test_paged_kernel_refuses_cpu_tensors():
    args = _case(2, n_blocks=4, bs=8, w=2, h=1, d=64, s_w=1, lengths=[3, 9])
    with pytest.raises(DMLCError, match="CUDA"):
        _port(args, impl="cuda")
    with pytest.raises(ValueError):
        _port(args, impl="pallas")
