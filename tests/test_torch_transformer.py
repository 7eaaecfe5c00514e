"""Port parity: the serving forwards of the port's transformer
against dmlc_tpu's, on the same weights (``params_from_jax``) and the
same numpy inputs.  The config is tiny but keeps what the converter must
get right: 2 pipeline stages ([S, L/S] stacking) and 2 experts (the
dense soft gate).  Float32 on the CPU; 1e-4 allows for summation order
through 4 layers of f32 matmuls."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu_torch.base import DMLCError
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.models.convert import params_from_jax, tensor_from_numpy

TOL = 1e-4
DIMS = dict(vocab=64, d_model=32, n_heads=2, head_dim=8, d_ff=48,
            n_layers=4, n_experts=2)


@pytest.fixture(scope="module")
def models():
    jcfg = jtfm.TransformerConfig(**DIMS, microbatches=1)
    params = jtfm.init_params(jax.random.PRNGKey(0), jcfg, n_stages=2)
    tree = jax.tree.map(np.asarray, params)
    # the init scale (0.02) makes every layer nearly the identity; a
    # larger scale keeps the comparison sensitive to each weight
    rng = np.random.default_rng(7)
    tree = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape).astype(a.dtype) * 0.2
                   if a.ndim > 2 else a), tree)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_jax(tree, ttfm.TransformerConfig(**DIMS),
                            device="cpu")
    return params, jcfg, model


def test_params_from_jax_layout(models):
    params, jcfg, model = models
    assert jtfm.count_params(jcfg) == sum(p.numel()
                                          for p in model.parameters())
    cfg = model.cfg
    for t in (1, 100):
        assert ttfm.train_flops_per_token(cfg, t) == \
            jtfm.train_flops_per_token(jcfg, t)
        assert ttfm.decode_flops_per_token(cfg, t) == \
            jtfm.decode_flops_per_token(jcfg, t)
    # stage 1, layer 0 of the stacked tree is the port's layer 2
    np.testing.assert_array_equal(
        model.layers[2].wq.detach().numpy(),
        np.asarray(params["blocks"]["wq"][1, 0]))


def test_bf16_leaves_convert_bit_exact():
    a = np.asarray(jnp.asarray([[1.5, -2.25], [3e-3, 7.0]], jnp.bfloat16))
    t = tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_forward_prefill_matches_jax(models):
    params, jcfg, model = models
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 64, size=(2, 12)).astype(np.int32)
    last = np.array([11, 6], np.int32)
    jl, jk, jv = jtfm.forward_prefill_last(params, jnp.asarray(ids),
                                           jnp.asarray(last), jcfg)
    with torch.inference_mode():
        tl, tk, tv = ttfm.forward_prefill_last(
            model, torch.from_numpy(ids).long(), torch.from_numpy(last))
        full, _, _ = ttfm.forward_prefill(model, torch.from_numpy(ids).long())
    jfull, _, _ = jtfm.forward_prefill(params, jnp.asarray(ids), jcfg)
    for got, want in ((tl, jl), (tk, jk), (tv, jv), (full, jfull)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s_w", [1, 3])
def test_forward_decode_paged_matches_jax(models, s_w):
    """Logits and the updated pools.  Row 2 is dead (length 0, table all
    zeros) while block 0 belongs to a live row: its scatter must be
    dropped, not written over that row's block."""
    params, jcfg, model = models
    rng = np.random.default_rng(2)
    n_blocks, bs, w = 12, 4, 3
    shape = (DIMS["n_layers"], n_blocks, bs, DIMS["n_heads"],
             DIMS["head_dim"])
    k_pool = rng.standard_normal(shape).astype(np.float32)
    v_pool = rng.standard_normal(shape).astype(np.float32)
    tables = np.array([[0, 5, 7], [3, 9, 2], [0, 0, 0], [4, 1, 6]], np.int32)
    lengths = np.array([5, 1, 0, w * bs - s_w], np.int32)
    ids = rng.integers(0, 64, size=(4, s_w)).astype(np.int32)
    positions = lengths[:, None] + np.arange(s_w, dtype=np.int32)
    jl, jkp, jvp, _, _ = jtfm.forward_decode_paged(
        params, jnp.asarray(ids), jnp.asarray(positions),
        jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(tables),
        jnp.asarray(lengths), jcfg)
    tkp, tvp = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    with torch.inference_mode():
        tl = ttfm.forward_decode_paged(
            model, torch.from_numpy(ids).long(), torch.from_numpy(positions),
            tkp, tvp, torch.from_numpy(tables), torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tvp.numpy(), np.asarray(jvp), rtol=TOL,
                               atol=TOL)
    # block 0 (row 0's first block) kept row 0's real tokens
    np.testing.assert_array_equal(tkp[:, 0, :4].numpy(), k_pool[:, 0, :4])


def test_parameters_train_and_serving_builds_no_graph(models):
    """Parameters are trainable; the serving forwards, run under
    inference_mode as the engine runs them, record no autograd graph."""
    _, _, model = models
    assert all(p.requires_grad for p in model.parameters())
    with torch.inference_mode():
        logits, k, v = ttfm.forward_prefill(model, torch.zeros(1, 5).long())
    assert all(t.grad_fn is None and not t.requires_grad
               for t in (logits, k, v))


def test_builders_without_device_raise_without_card(models):
    """init_params and params_from_jax default to the card, as the
    engine does; with none they raise instead of building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    cfg = ttfm.TransformerConfig(**DIMS)
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(0), jtfm.TransformerConfig(**DIMS), n_stages=2))
    with pytest.raises(DMLCError, match="no CUDA device"):
        ttfm.init_params(cfg, torch.Generator())
    with pytest.raises(DMLCError, match="no CUDA device"):
        params_from_jax(tree, cfg)
    with pytest.raises(DMLCError, match="no CUDA device"):
        ttfm.Transformer(cfg)
    assert ttfm.init_params(cfg, torch.Generator(), "cpu").device.type == "cpu"
