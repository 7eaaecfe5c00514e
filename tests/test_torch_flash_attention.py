"""Port parity: the flash-attention forward (K1's plain version) against
dmlc_tpu's Pallas kernel in interpret mode and its oracles.

The shapes are those of tests/test_flash_attention.py: aligned (T=64,
blocks 32) and unaligned tails (T=200, 77 with blocks 64).  Float32 on
the CPU; 2e-5 is the JAX suite's own kernel-vs-oracle bound.  The
CUDA kernel itself is checked in tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmlc_tpu.ops.flash_attention import flash_attention as jflash
from dmlc_tpu.ops.flash_attention import lax_block_attend
from dmlc_tpu.parallel.ring_attention import ring_attention_reference
from dmlc_tpu_torch.base import DMLCError
from dmlc_tpu_torch.ops import flash_attention as tflash

TOL = 2e-5


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


def test_flash_attention_is_forward_only():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 8, 8, 1, 64))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        tflash.flash_attention(q, k, v)


def test_flash_kernel_refuses_cpu_tensors():
    """impl="cuda" on CPU tensors raises; it never falls back."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 8, 8, 1, 64))
    with pytest.raises(DMLCError, match="CUDA"):
        tflash.flash_attention(q, k, v, impl="cuda")
