"""Port parity: the training path (loss, gradients, AdamW steps, remat)
of the port's transformer against dmlc_tpu's, on the same weights
(``params_from_jax``) and the same numpy batches.

The config is the tiny one of tests/test_torch_transformer.py (2
pipeline stages in the JAX tree, 2 experts) with per-block remat on, in
float32 on the CPU, where attention runs the plain versions on both
sides.  Tolerances:

* loss 1e-5 relative and gradients 1e-5 relative norm per leaf: the same
  f32 arithmetic summed in another order through 4 layers;
* a 20-step AdamW trajectory, each loss within 1e-4 relative: the
  rounding of each step feeds the next;
* weights after 20 steps within 1e-3 absolute: lr 1e-3 moves a weight by
  at most ~2e-2 over the run, and the sign of Adam's normalised step is
  not stable for the gradients that sit at rounding noise.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.models.convert import params_from_jax, params_to_jax
from dmlc_tpu_torch.ops import flash_attention as tflash

DIMS = dict(vocab=64, d_model=32, n_heads=2, head_dim=8, d_ff=48,
            n_layers=4, n_experts=2)
STAGES = 2


def _weights(dtype="float32"):
    """The JAX tree (numpy leaves) and its config.  The init scale (0.02)
    makes every layer nearly the identity; a larger one keeps the
    comparison sensitive to each weight."""
    jcfg = jtfm.TransformerConfig(**DIMS, microbatches=1, remat=True,
                                  dtype=dtype)
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(0), jcfg, n_stages=STAGES))
    rng = np.random.default_rng(7)
    tree = jax.tree.map(
        lambda a: ((a + rng.standard_normal(a.shape) * 0.2).astype(a.dtype)
                   if a.ndim > 2 else a), tree)
    return tree, jcfg


def _jax_loss(jcfg):
    return jax.jit(lambda p, ids, labels: jtfm.unsharded_loss(
        p, ids, labels, jcfg))


def _model(tree, **cfg):
    return params_from_jax(
        tree, ttfm.TransformerConfig(**DIMS, remat=True, **cfg),
        device="cpu")


def _batch(rng, b=2, t=12):
    ids = rng.integers(0, DIMS["vocab"], size=(b, t)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _torch_batch(ids, labels):
    return torch.from_numpy(ids).long(), torch.from_numpy(labels).long()


def _rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _grad_tree(model):
    """The gradients in the JAX tree's layout, through params_to_jax."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for dst, src in zip(g.parameters(), model.parameters()):
            dst.copy_(src.grad)
    return params_to_jax(g, STAGES)


def test_loss_matches_jax():
    tree, jcfg = _weights()
    ids, labels = _batch(np.random.default_rng(1))
    want = float(_jax_loss(jcfg)(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(ids), jnp.asarray(labels)))
    got = ttfm.unsharded_loss(_model(tree),
                              *_torch_batch(ids, labels)).item()
    assert abs(got - want) <= 1e-5 * abs(want)


def test_gradients_match_jax_grad():
    tree, jcfg = _weights()
    ids, labels = _batch(np.random.default_rng(2))
    want = jax.grad(_jax_loss(jcfg))(jax.tree.map(jnp.asarray, tree),
                                     jnp.asarray(ids), jnp.asarray(labels))
    model = _model(tree)
    ttfm.unsharded_loss(model, *_torch_batch(ids, labels)).backward()
    got = _grad_tree(model)
    errs = jax.tree.map(_rel_norm, got, jax.tree.map(np.asarray, want))
    worst = max(jax.tree.leaves(errs))
    assert worst <= 1e-5, errs


def test_train_trajectory_matches_optax_adamw():
    """20 steps of make_train_step (default optimizer adamw 1e-3) against
    optax.adamw(1e-3) on the same stream of batches; the first step's
    grad norm against optax.global_norm."""
    tree, jcfg = _weights()
    opt = optax.adamw(1e-3)

    @jax.jit
    def jstep(p, s, ids, labels):
        loss, g = jax.value_and_grad(
            lambda p_: jtfm.unsharded_loss(p_, ids, labels, jcfg))(p)
        up, s = opt.update(g, s, p)
        return optax.apply_updates(p, up), s, loss, optax.global_norm(g)

    params = jax.tree.map(jnp.asarray, tree)
    state = opt.init(params)
    model = _model(tree)
    step = ttfm.make_train_step(model)
    rng = np.random.default_rng(3)
    for i in range(20):
        ids, labels = _batch(rng)
        params, state, jloss, jnorm = jstep(params, state, jnp.asarray(ids),
                                            jnp.asarray(labels))
        loss = step(*_torch_batch(ids, labels))
        assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss)), i
        if i == 0:  # the step leaves its gradients in p.grad
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(p.grad.float())
                 for p in model.parameters()]))
            assert abs(float(norm) - float(jnorm)) <= 1e-5 * float(jnorm)
    got = params_to_jax(model, STAGES)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-3)


def test_remat_on_and_off_give_the_same_loss_and_gradients():
    tree, _ = _weights()
    batch = _torch_batch(*_batch(np.random.default_rng(4)))
    results = []
    for remat, policy in ((False, "save_flash"), (True, "full"),
                          (True, "save_flash"), (True, "save_flash_mlp")):
        model = _model(tree)
        model.cfg = dataclasses.replace(model.cfg, remat=remat,
                                        remat_policy=policy)
        loss = ttfm.unsharded_loss(model, *batch)
        loss.backward()
        results.append((loss.detach(), [p.grad for p in model.parameters()]))
    base_loss, base_grads = results[0]
    for loss, grads in results[1:]:
        assert torch.equal(loss, base_loss)
        assert all(torch.equal(a, b) for a, b in zip(grads, base_grads))


@pytest.mark.parametrize("remat,policy,calls", [
    (True, "save_flash", 1), (True, "full", 2), (False, "save_flash", 1)])
def test_attention_forward_runs_per_layer_per_step(monkeypatch, remat,
                                                   policy, calls):
    """save_flash keeps the flash forward's outputs: the backward never
    re-runs it (L calls a step); full remat recomputes it (2L)."""
    tree, _ = _weights()
    model = _model(tree)
    model.cfg = dataclasses.replace(model.cfg, remat=remat,
                                    remat_policy=policy)
    n = []
    real = tflash._forward_reference

    def spy(*a, **k):
        n.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tflash, "_forward_reference", spy)
    step = ttfm.make_train_step(model)
    batch = _torch_batch(*_batch(np.random.default_rng(5)))
    for i in range(2):
        step(*batch)
        assert len(n) == calls * DIMS["n_layers"] * (i + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_to_jax_inverts_params_from_jax_bit_for_bit(dtype):
    tree, _ = _weights(dtype)
    back = params_to_jax(_model(tree, dtype=dtype), STAGES)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))


def test_remat_policy_is_checked():
    assert ttfm.TransformerConfig(
        remat_policy="save_flash_mlp").remat_policy == "save_flash_mlp"
    with pytest.raises(ValueError, match="unknown remat_policy"):
        ttfm.TransformerConfig(remat_policy="everything")
    assert ttfm.flagship_config().remat
    assert ttfm.flagship_config().remat_policy == "save_flash"


def test_adamw_has_optax_defaults():
    opt = ttfm.adamw([torch.nn.Parameter(torch.zeros(2))], 1e-4)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (1e-4, (0.9, 0.999), 1e-8, 1e-4)


def test_grad_norm_matches_optax_global_norm():
    """make_train_step(grad_norm=True) returns (loss, gnorm), gnorm within
    1e-6 relative of optax.global_norm of the same gradients."""
    tree, jcfg = _weights()
    ids, labels = _batch(np.random.default_rng(11))
    jloss, g = jax.value_and_grad(_jax_loss(jcfg))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids),
        jnp.asarray(labels))
    want = float(optax.global_norm(g))
    loss, gnorm = ttfm.make_train_step(_model(tree), grad_norm=True)(
        *_torch_batch(ids, labels))
    assert abs(float(gnorm) - want) <= 1e-6 * want
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))


@pytest.mark.parametrize("ledger", [False, True])
def test_declined_step_leaves_params_and_adamw_state_bit_equal(ledger):
    """accept() sees (loss, gnorm) before optimizer.step(); False leaves
    the parameters and AdamW's exp_avg, exp_avg_sq and step bit-equal,
    and the next accepted step goes on from there (as optax from the
    kept references).  A declined step records nothing in the ledger."""
    from dmlc_tpu_torch import telemetry

    tree, _ = _weights()
    model = _model(tree)
    opt = ttfm.adamw(model.parameters(), 1e-3)
    telemetry.reset_steps()
    step = ttfm.make_train_step(model, opt, ledger=ledger, grad_norm=True)
    rng = np.random.default_rng(12)
    step(*_torch_batch(*_batch(rng)))           # the moments exist now

    def snap():
        return ([p.detach().clone() for p in model.parameters()],
                [{k: v.clone() for k, v in opt.state[p].items()}
                 for p in model.parameters()])

    before = snap()
    seen = []
    bad = _torch_batch(*_batch(rng))
    loss, gnorm = step(*bad, accept=lambda l, g: seen.append((l, g)) or False)
    assert len(seen) == 1 and torch.equal(seen[0][1], gnorm)
    after = snap()
    for a, b in zip(before[0], after[0]):
        assert torch.equal(a, b)
    for sa, sb in zip(before[1], after[1]):
        assert sa.keys() == sb.keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    if ledger:
        assert len(telemetry.ledger().records()) == 1
    # accepted: the same update a fresh copy of the pre-skip state makes
    twin = _model(tree)
    twin.load_state_dict(model.state_dict())
    topt = ttfm.adamw(twin.parameters(), 1e-3)
    # load_state_dict keeps the moment tensors it is given: copy them
    topt.load_state_dict(copy.deepcopy(opt.state_dict()))
    nxt = _torch_batch(*_batch(rng))
    step(*nxt, accept=lambda l, g: True)
    ttfm.make_train_step(twin, topt, ledger=False)(*nxt)
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)
    if ledger:
        assert len(telemetry.ledger().records()) == 2
