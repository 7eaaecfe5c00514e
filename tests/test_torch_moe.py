"""Port parity: routed top-k MoE and the ``save_flash_mlp`` remat policy.

The same numpy weights (through ``params_from_jax``) and inputs go
through ``dmlc_tpu.models.transformer`` and the port, in float32 on the
CPU, where attention runs the plain versions on both sides.  The config
has 4 experts routed top-2 at d_model 32 over 2 layers.  Tolerances:

* the routed FFN's output and every weight's gradient 1e-5 (absolute
  and relative): one layer of f32 products summed in another order;
* the loss 1e-5 relative, the serving forwards 1e-4 (two layers), a
  3-step AdamW trajectory 1e-4 relative a step, as in
  tests/test_torch_train.py;
* the overflow counters exactly: they count calls and dropped choices;
* ``save_flash_mlp`` against ``save_flash`` and ``full``: bit-equal,
  since remat recomputes the same ops in the same order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dmlc_tpu import metrics as jmetrics
from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu.ops.core import ShardAxes
from dmlc_tpu.serving import InferenceEngine as JaxEngine
from dmlc_tpu_torch import telemetry
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.models.convert import (params_from_jax, params_to_jax,
                                           train_state_from_jax,
                                           train_state_to_jax)
from dmlc_tpu_torch.serving import InferenceEngine

DIMS = dict(vocab=64, d_model=32, n_heads=2, head_dim=8, d_ff=48,
            n_layers=2, n_experts=4)
ROUTED = dict(moe_topk=2, moe_capacity_factor=1.25)
TOL = 1e-5


def _tree(dtype="float32", scale=0.2, **cfg):
    jcfg = jtfm.TransformerConfig(**DIMS, microbatches=1, dtype=dtype,
                                  **{**ROUTED, **cfg})
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(0), jcfg))
    # the init scale (0.02) leaves the gate near uniform; a larger one
    # spreads the routes and keeps the comparison sensitive to each weight
    rng = np.random.default_rng(7)
    tree = jax.tree.map(
        lambda a: ((a + rng.standard_normal(a.shape) * scale).astype(a.dtype)
                   if a.ndim > 2 else a), tree)
    return tree, jcfg


def _model(tree, **cfg):
    return params_from_jax(
        tree, ttfm.TransformerConfig(**DIMS, **{**ROUTED, **cfg}),
        device="cpu")


def _batch(rng, b=2, t=12):
    ids = rng.integers(0, DIMS["vocab"], size=(b, t)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _layer(tree, i=0):
    return {k: v[0, i] for k, v in tree["blocks"].items()}


def _topk_inputs(seed):
    tree, _ = _tree()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 8, DIMS["d_model"])).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    return tree, x, r


@pytest.mark.parametrize("cf", [2.0, 0.25])
def test_topk_ffn_output_matches_jax(cf):
    """cf 2.0 gives every expert a slot for each token (no drop); 0.25
    drops most choices.  Both sides agree, and each drops as it should."""
    tree, x, _ = _topk_inputs(1)
    jcfg = jtfm.TransformerConfig(**DIMS, moe_topk=2, moe_capacity_factor=cf)
    want = jax.jit(lambda *a: jtfm._moe_topk_ffn(*a, ShardAxes(), jcfg))(
        jnp.asarray(x), _layer(tree))
    model = _model(tree, moe_capacity_factor=cf)
    cfg = model.cfg
    with torch.no_grad():
        got = model.layers[0].moe_ffn(torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    telemetry.reset()
    with torch.no_grad():
        model.layers[0].moe_ffn(torch.from_numpy(x),
                                dataclasses.replace(cfg,
                                                    moe_debug_overflow=True))
    dropped = telemetry.counters_snapshot()["moe"]["overflow_fraction_sum"]
    assert (dropped == 0.0) if cf == 2.0 else (dropped > 0.3)


@pytest.mark.parametrize("cf", [2.0, 0.25])
def test_topk_ffn_gradients_match_jax_grad(cf):
    """Gradients of <y, r> with respect to x, the gate and the three
    expert weights, through the scatter-add dispatch, the gather combine
    and the renormalised top-k weights, with drops and without."""
    tree, x, r = _topk_inputs(2)
    jcfg = jtfm.TransformerConfig(**DIMS, moe_topk=2, moe_capacity_factor=cf)
    names = ("gate", "w_in", "w_gate", "w_out")
    p0 = {k: jnp.asarray(v) for k, v in _layer(tree).items()}

    def jloss(x_, ws):
        return jnp.sum(jtfm._moe_topk_ffn(x_, {**p0, **ws}, ShardAxes(), jcfg)
                       * jnp.asarray(r))

    jgx, jgw = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x), {k: p0[k] for k in names})
    layer = _model(tree, moe_capacity_factor=cf).layers[0]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer.moe_ffn(xt, ttfm.TransformerConfig(**DIMS, moe_topk=2,
                                                 moe_capacity_factor=cf))
    (y * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=TOL,
                               atol=TOL)
    for k in names:
        g = getattr(layer, k).grad
        assert g is not None, k
        np.testing.assert_allclose(g.numpy(), np.asarray(jgw[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_capacity_counts_route_tokens():
    """``route_tokens`` sets the capacity the reference's padded call
    has: the same live tokens routed inside a batch padded with dead rows
    (after them) give the same outputs for the live rows."""
    tree, x, _ = _topk_inputs(3)
    model = _model(tree, moe_capacity_factor=0.5)
    layer, cfg = model.layers[0], model.cfg
    pad = np.concatenate([x, np.zeros((5,) + x.shape[1:], np.float32)])
    with torch.no_grad():
        want = layer.moe_ffn(torch.from_numpy(pad), cfg)[:3]
        got = layer.moe_ffn(torch.from_numpy(x), cfg,
                            route_tokens=pad.shape[0] * pad.shape[1])
        bare = layer.moe_ffn(torch.from_numpy(x), cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(bare, want), "capacity must depend on n"


@pytest.mark.parametrize("remat,policy", [
    (False, "save_flash"), (True, "full"), (True, "save_flash"),
    (True, "save_flash_mlp")])
def test_overflow_counters_match_jax_after_a_train_step(remat, policy):
    """One train step under moe_debug_overflow counts what the JAX step
    counts: one check per routed call, so twice per layer under remat
    (the backward recomputes the block) and once without."""
    tree, jcfg = _tree(moe_capacity_factor=0.5, moe_debug_overflow=True,
                       remat=remat, remat_policy=policy)
    ids, labels = _batch(np.random.default_rng(4))
    jmetrics.reset()
    g = jax.jit(jax.grad(lambda p: jtfm.unsharded_loss(
        p, jnp.asarray(ids), jnp.asarray(labels), jcfg)))(
            jax.tree.map(jnp.asarray, tree))
    jax.block_until_ready(g)
    jax.effects_barrier()
    want = jmetrics.snapshot()["moe"]
    telemetry.reset()
    model = _model(tree, moe_capacity_factor=0.5, moe_debug_overflow=True,
                   remat=remat, remat_policy=policy)
    ttfm.make_train_step(model, ledger=False)(
        torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    got = telemetry.counters_snapshot()["moe"]
    assert got["overflow_checks"] == want["overflow_checks"] == \
        (2 if remat else 1) * DIMS["n_layers"]
    assert got["overflow_fraction_sum"] == pytest.approx(
        want["overflow_fraction_sum"], rel=1e-6)
    assert got["overflow_fraction_sum"] > 0


def test_routed_loss_and_adamw_trajectory_match_optax():
    """unsharded_loss of the routed config, then 3 steps of
    make_train_step(grad_norm=True) against optax.adamw(1e-3), the norm
    against optax.global_norm."""
    tree, jcfg = _tree(moe_capacity_factor=1.0, remat=True)
    opt = optax.adamw(1e-3)

    @jax.jit
    def jstep(p, s, ids, labels):
        loss, g = jax.value_and_grad(
            lambda p_: jtfm.unsharded_loss(p_, ids, labels, jcfg))(p)
        up, s = opt.update(g, s, p)
        return optax.apply_updates(p, up), s, loss, optax.global_norm(g)

    params = jax.tree.map(jnp.asarray, tree)
    state = opt.init(params)
    model = _model(tree, moe_capacity_factor=1.0, remat=True)
    step = ttfm.make_train_step(model, grad_norm=True)
    rng = np.random.default_rng(5)
    for i in range(3):
        ids, labels = _batch(rng)
        params, state, jloss, jnorm = jstep(params, state, jnp.asarray(ids),
                                            jnp.asarray(labels))
        loss, gnorm = step(torch.from_numpy(ids).long(),
                           torch.from_numpy(labels).long())
        assert abs(float(loss) - float(jloss)) <= \
            (TOL if i == 0 else 1e-4) * abs(float(jloss)), i
        assert abs(float(gnorm) - float(jnorm)) <= 1e-4 * float(jnorm), i
    got = params_to_jax(model)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4)


def test_routed_serving_forwards_match_jax():
    """forward_prefill_last and forward_decode_paged (a speculative
    window of 3, a dead row between live ones) of the routed config."""
    tree, jcfg = _tree(moe_capacity_factor=0.5)
    params = jax.tree.map(jnp.asarray, tree)
    model = _model(tree, moe_capacity_factor=0.5)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 64, size=(2, 12)).astype(np.int32)
    last = np.array([11, 6], np.int32)
    jl, jk, _ = jax.jit(lambda *a: jtfm.forward_prefill_last(*a, jcfg))(
        params, jnp.asarray(ids), jnp.asarray(last))
    with torch.inference_mode():
        tl, tk, _ = ttfm.forward_prefill_last(
            model, torch.from_numpy(ids).long(), torch.from_numpy(last))
    for got, want in ((tl, jl), (tk, jk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    s_w, bs = 3, 4
    shape = (DIMS["n_layers"], 12, bs, DIMS["n_heads"], DIMS["head_dim"])
    k_pool = rng.standard_normal(shape).astype(np.float32)
    v_pool = rng.standard_normal(shape).astype(np.float32)
    tables = np.array([[0, 5, 7], [3, 9, 2], [0, 0, 0], [4, 1, 6]], np.int32)
    lengths = np.array([5, 1, 0, 9], np.int32)
    ids = rng.integers(0, 64, size=(4, s_w)).astype(np.int32)
    positions = lengths[:, None] + np.arange(s_w, dtype=np.int32)
    jl, jkp, _, _, _ = jax.jit(
        lambda *a: jtfm.forward_decode_paged(*a, jcfg))(
            params, jnp.asarray(ids), jnp.asarray(positions),
            jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(tables),
            jnp.asarray(lengths))
    tkp, tvp = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    with torch.inference_mode():
        tl = ttfm.forward_decode_paged(
            model, torch.from_numpy(ids).long(), torch.from_numpy(positions),
            tkp, tvp, torch.from_numpy(tables), torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), rtol=1e-4,
                               atol=1e-4)


def _drive(engine, prompts, max_new):
    engine.start()
    try:
        reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
        for r in reqs:
            assert r.wait(300), f"request {r.id} never finished"
            assert r.error is None, r.error
        return [list(r.generated) for r in reqs]
    finally:
        engine.close()


@pytest.mark.parametrize("spec_k", [0, 3])
def test_engine_tokens_match_jax_with_fewer_live_rows_than_max_active(
        monkeypatch, spec_k):
    """The capacity trap: 2 live rows under max_active 6.  The JAX engine
    pads its decode batch to 6 rows, and the capacity counts them; the
    port runs the 2 live rows and must route them the same way.  At a
    capacity factor of 0.5 the drops differ if it does not."""
    tree, jcfg = _tree(moe_capacity_factor=0.5, scale=0.5)
    monkeypatch.setenv("DMLC_SERVE_PAGED_ATTN", "on")
    monkeypatch.setenv("DMLC_SERVE_SPEC_K", str(spec_k))
    monkeypatch.setenv("DMLC_SERVE_SPEC_MIN_CTX", "4")
    kw = dict(n_blocks=32, block_size=4, max_active=6, queue_depth=8)
    prompts = [[3, 9, 27, 17, 3, 9, 27], [5, 1, 5, 1, 5]]
    want = _drive(JaxEngine(jax.tree.map(jnp.asarray, tree), jcfg, **kw),
                  prompts, 10)
    model = _model(tree, moe_capacity_factor=0.5)
    got = _drive(InferenceEngine(model, device="cpu", **kw), prompts, 10)
    assert got == want
    # the same engine computing capacity from the live rows alone strays
    from dmlc_tpu_torch.serving import engine as eng_mod

    real = eng_mod.forward_decode_paged
    monkeypatch.setattr(eng_mod, "forward_decode_paged",
                        lambda *a, route_tokens=None, **k: real(*a, **k))
    bare = _drive(InferenceEngine(model, device="cpu", **kw), prompts, 10)
    assert bare != want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routed_params_and_train_state_convert_bit_for_bit(dtype):
    """[L, X, E, F] experts and the [E, X] gate of a routed config, both
    directions, and the AdamW state after one step through the tree."""
    tree, _ = _tree(dtype)
    model = _model(tree, dtype=dtype)
    back = params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))
    opt = ttfm.adamw(model.parameters(), 1e-3)
    ids, labels = _batch(np.random.default_rng(8))
    ttfm.make_train_step(model, opt, ledger=False)(
        torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    state = train_state_to_jax(model, opt)
    model2 = _model(tree, dtype=dtype)
    opt2 = ttfm.adamw(model2.parameters(), 1e-3)
    train_state_from_jax(state, model2, opt2)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
        sa, sb = opt.state[a], opt2.state[b]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), key


# ---------------------------------------------------------------------------
# save_flash_mlp
# ---------------------------------------------------------------------------

def test_routed_remat_policies_give_the_loss_and_gradients_of_no_remat():
    """The routed block under each remat policy (the dense one:
    tests/test_torch_train.py)."""
    tree, _ = _tree()
    ids, labels = _batch(np.random.default_rng(9))
    batch = torch.from_numpy(ids).long(), torch.from_numpy(labels).long()
    results = []
    for remat, policy in ((True, "save_flash"), (True, "full"),
                          (True, "save_flash_mlp"), (False, "save_flash")):
        model = _model(tree, remat=remat, remat_policy=policy)
        loss = ttfm.unsharded_loss(model, *batch)
        loss.backward()
        results.append((loss.detach(), [p.grad for p in model.parameters()]))
    base_loss, base_grads = results[0]
    for loss, grads in results[1:]:
        assert torch.equal(loss, base_loss)
        assert all(torch.equal(a, b) for a, b in zip(grads, base_grads))


@pytest.mark.parametrize("policy,calls", [
    ("save_flash", 3), ("full", 3), ("save_flash_mlp", 2)])
def test_save_flash_mlp_saves_mlp_act(monkeypatch, policy, calls):
    """``silu`` runs in mlp_act's forward and in its backward.  A step
    under save_flash recomputes the forward in the backward (3 calls a
    layer); save_flash_mlp keeps the op's output (2 calls)."""
    tree, _ = _tree()
    model = _model(tree, moe_topk=0, remat=True, remat_policy=policy)
    n = []
    real = torch.nn.functional.silu

    def spy(*a, **k):
        n.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch.nn.functional, "silu", spy)
    ids, labels = _batch(np.random.default_rng(10))
    ttfm.unsharded_loss(model, torch.from_numpy(ids).long(),
                        torch.from_numpy(labels).long()).backward()
    # the dense gate runs one SwiGLU an expert
    assert len(n) == calls * DIMS["n_layers"] * DIMS["n_experts"]
