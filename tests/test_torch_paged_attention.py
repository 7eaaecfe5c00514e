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


def test_paged_kernel_refuses_cpu_tensors():
    args = _case(2, n_blocks=4, bs=8, w=2, h=1, d=64, s_w=1, lengths=[3, 9])
    with pytest.raises(DMLCError, match="CUDA"):
        _port(args, impl="cuda")
    with pytest.raises(ValueError):
        _port(args, impl="pallas")
