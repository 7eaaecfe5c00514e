"""The port's CUDA kernels against their plain PyTorch versions, on a card.

The kernels have no CPU mode, so every kernel test here is marked
``cuda`` and skips without a card (the one unmarked test checks how
libraries are keyed, on any machine).  The module imports no jax, so it
also runs where jax is not installed:

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
rounding to the same 1e-2 on the CPU.  The bf16 forward (K1) likewise
rounds P to bf16 before O += P V; its emulation there reads one or two
bf16 ulps of o, inside the 2e-2 max / 2e-3 mean bound held here.
"""

import numpy as np
import pytest
import torch

from dmlc_tpu_torch.ops import _build
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


def _assert_bf16_close(got, want):
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3, \
        (err.max().item(), err.mean().item())


def test_library_is_keyed_by_source_and_shared_headers(tmp_path):
    """An edited header beside a source gives the source a new library
    path, so a stale library is never loaded; libraries stay under
    ``build/``, which git ignores."""
    src = tmp_path / "k.cu"
    src.write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    first = _build.library_path(src)
    assert _build.library_path(src) == first
    header.write_text("// two\n")
    assert _build.library_path(src) != first
    assert first.parent == _build.BUILD_DIR
    assert "build" in _build.BUILD_DIR.relative_to(
        _build.CSRC.parents[2]).parts
    for name in ("flash_fwd.cu", "flash_bwd.cu"):
        assert '#include "wgmma.cuh"' in (_build.CSRC / name).read_text()


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


@pytest.mark.cuda
@pytest.mark.parametrize("q_off,kv_off,tq,tk", [(32, 32, 32, 32), (0, 0, 77, 77),
                                                (8, 40, 32, 24),
                                                (512, 0, 256, 768),
                                                (0, 64, 128, 200)])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_block_attend_offsets_bf16(card, q_off, kv_off, tq, tk,
                                                d):
    """The ring-step (pv, m, l) contract on the bf16 tensor-core kernel:
    m and l from f32 scores (1e-4, l relative), o = pv / l within the
    bf16 tolerance (P is rounded to bf16 before P V); rows with no
    visible key keep m = -1e30, l = 0, pv = 0."""
    rng = np.random.default_rng(q_off + kv_off + d)
    q = _randn(rng, 2, tq, 2, d).to(card, torch.bfloat16)
    k, v = (_randn(rng, 2, tk, 2, d).to(card, torch.bfloat16)
            for _ in range(2))
    kw = dict(scale=d ** -0.5, causal=True, q_offset=q_off,
              kv_offset=kv_off)
    pv, m, l = tflash.block_attend(q, k, v, **kw)
    pv_r, m_r, l_r = tflash.block_attend(q, k, v, impl="torch", **kw)
    assert all(torch.isfinite(x).all() for x in (pv, m, l))
    assert (m - m_r).abs().max().item() <= 1e-4
    assert ((l - l_r).abs() / l_r.clamp_min(1.0)).max().item() <= 1e-4
    dead = l_r == 0
    assert torch.equal(l[dead], l_r[dead]) and (m[dead] == -1e30).all()
    norm = [x / y.clamp_min(1e-20).transpose(1, 2)[..., None]
            for x, y in ((pv, l), (pv_r, l_r))]
    _assert_bf16_close(*norm)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [77, 200])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", ["contiguous", "qkv", "unaligned"])
def test_flash_kernel_layouts_bf16(card, t, d, layout):
    """The bf16 forward on contiguous, ``qkv``-sliced and unaligned
    inputs (the wrapper copies rows that do not start on 16 bytes)."""
    q, k, v, _ = _bwd_inputs(card, torch.bfloat16, t, d, layout, t + d)
    for causal in (True, False):
        got = tflash.flash_attention(q, k, v, causal=causal)
        assert got.dtype == torch.bfloat16
        _assert_bf16_close(got, tflash.attention_reference(q, k, v,
                                                           causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_kernel_is_deterministic(card, dtype, d):
    """Two launches of K1 on the same inputs give bit-identical o and
    lse: every sum in one fixed order, no atomics."""
    q, k, v, _ = _bwd_inputs(card, dtype, 200, d, "contiguous", 13)
    first = torch.ops.dmlc_tpu_torch.flash_attn_fwd(q, k, v, d ** -0.5,
                                                    True, None)
    second = torch.ops.dmlc_tpu_torch.flash_attn_fwd(q, k, v, d ** -0.5,
                                                     True, None)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


def _paged_wide(card, dtype, d, bs, s_w, seed):
    """A wide table (W=64 pages, several splits a row): a dead row
    (length 0, zero table), short rows whose later splits are empty, and
    a row filling the table (length W * bs - S)."""
    rng = np.random.default_rng(seed)
    w, h = 64, 2
    lengths = [0, 1, 3 * bs + 5, w * bs // 2, w * bs - s_w]
    b = len(lengths)
    n_blocks = b * w
    tables = torch.from_numpy(rng.permutation(n_blocks).reshape(
        b, w).astype(np.int32)).to(card)
    tables[0] = 0
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    q = _randn(rng, b, s_w, h, d).to(card, dtype)
    kp, vp = (_randn(rng, n_blocks, bs, h, d).to(card, dtype)
              for _ in range(2))
    return q, kp, vp, tables, lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", CASES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bs", [8, 32, 128])
@pytest.mark.parametrize("s_w", [1, 2, 3, 5, 8])
def test_paged_kernel_wide_tables(card, dtype, tol, d, bs, s_w):
    """Split-KV K4 on wide tables (4, 16 or 64 splits a row by block
    size, empty splits past the short rows) against the plain version,
    at windows that fill the kernel's row count (1, 8) and that pad it
    (2 and 3 rows of 4, 5 of 8); one launch counted a call."""
    args = _paged_wide(card, dtype, d, bs, s_w, bs + d + s_w)
    before = tpaged.PAGED_ATTENTION.launches
    got = tpaged.paged_attention(*args)
    assert tpaged.PAGED_ATTENTION.launches == before + 1
    want = tpaged.paged_attention(*args, impl="torch")
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_w", [1, 4])
def test_paged_kernel_is_deterministic(card, dtype, s_w):
    """Two launches of K4 give bit-identical outputs: the splits merge
    in a fixed order, no atomics."""
    args = _paged_wide(card, dtype, 128, 16, s_w, 21)
    assert torch.equal(tpaged.paged_attention(*args),
                       tpaged.paged_attention(*args))
