"""Port parity: the flagship on a dp × sp × tp mesh against dmlc_tpu's
``forward_local`` under ``shard_map`` and its ``make_train_step(mesh)``.

The port runs as a gang of gloo processes (tests/test_torch_parallel.py
``run_gang``) holding the shards ``shard_params_from_jax`` slices from
the JAX tree; the JAX side runs on ``build_mesh(n, ...)`` of the 8 host
devices, pp = ep = 1.  The config is a tiny one with 2 soft-gated experts
in float32.  On each of the meshes (dp1, sp2, tp2), (dp2, sp2, tp1) and
(dp1, sp1, tp2): the loss and EVERY gathered gradient (a missing
``copy_to`` leaves the loss right and the replicated leaves' gradients
wrong), the sharded gradient norm against the one-card norm, and 3 AdamW
steps of each package's train step.  Tolerances: loss 1e-5 relative
(as tests/test_model.py), gradients 1e-5 absolute, the train steps'
losses and final parameters 1e-5 (3 steps of lr 1e-3), the norm 1e-5
relative.  (The pp and ep meshes are tests/test_torch_pipeline.py's
and tests/test_torch_expert_parallel.py's.)"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu.parallel import build_mesh as jbuild_mesh
from dmlc_tpu_torch.base import DMLCError
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.models.convert import params_from_jax
from dmlc_tpu_torch.parallel import build_mesh

from tests.test_torch_parallel import PKG, run_gang

DIMS = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, d_ff=32,
            n_layers=2, n_experts=2)
MESHES = {"dp1_sp2_tp2": ({"dp": 1, "sp": 2, "tp": 2}, True),
          "dp2_sp2_tp1": ({"dp": 2, "sp": 2, "tp": 1}, False),
          "dp1_sp1_tp2": ({"dp": 1, "sp": 1, "tp": 2}, False)}
B, T, STEPS = 4, 16, 3


def _weights():
    """The JAX tree (numpy leaves, one stage) and its config; the
    matrices perturbed to O(0.2) so every weight moves the loss."""
    jcfg = jtfm.TransformerConfig(**DIMS, microbatches=1)
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                     jcfg, n_stages=1))
    rng = np.random.default_rng(7)
    tree = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.2).astype(a.dtype)
        if a.ndim >= 2 else a, tree)
    return tree, jcfg


def _batch():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, DIMS["vocab"], size=(B, T)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _world(shape):
    return int(np.prod(list(shape.values())))


def _jax_mesh(shape):
    return jbuild_mesh(_world(shape), pp=1, ep=1, **shape)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


_BODY = """
from {pkg}.models import transformer as tfm
from {pkg}.models.convert import gather_params, shard_params_from_jax
cfg = tfm.TransformerConfig(**json.loads({dims!r}), remat={remat})
tree = {{"blocks": {{}}}}
for key, a in IN.items():
    if key.startswith("w."):
        parts = key[2:].split(".")
        (tree["blocks"] if len(parts) == 2 else tree)[parts[-1]] = a
ids = torch.from_numpy(IN["ids"]).long()
labels = torch.from_numpy(IN["labels"]).long()
def local(x):
    dp, sp = mesh.axis_size("dp"), mesh.axis_size("sp")
    return (x.chunk(dp, 0)[mesh.axis_rank("dp")]
            .chunk(sp, 1)[mesh.axis_rank("sp")])
def save(prefix, t):
    for k, v in t.items():
        if isinstance(v, dict):
            save(prefix + k + ".", v)
        else:
            OUT[prefix + k] = v
model = shard_params_from_jax(tree, cfg, mesh, device="cpu")
loss = tfm.forward_local(model, local(ids), local(labels), cfg,
                         tfm.SHARDED_AXES, mesh)
loss.backward()
tfm.sync_gradients(model, mesh)
OUT["loss"] = loss.detach()
OUT["gnorm"] = tfm.sharded_grad_norm(model, mesh)
save("grad.", gather_params(model, mesh, grads=True))
model = shard_params_from_jax(tree, cfg, mesh, device="cpu")
step = tfm.make_train_step(model, ledger=False, mesh=mesh)
OUT["losses"] = np.array([float(step(ids, labels)) for _ in range({steps})])
save("param.", gather_params(model, mesh))
"""


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module", params=sorted(MESHES))
def gang(request, weights, tmp_path_factory):
    tree, _ = weights
    shape, remat = MESHES[request.param]
    ids, labels = _batch()
    ins = {"w." + k: v for k, v in _flat(tree).items()}
    ins.update(ids=ids, labels=labels)
    body = _BODY.format(pkg=PKG, dims=json.dumps(DIMS), remat=remat,
                        steps=STEPS)
    outs = run_gang(tmp_path_factory.mktemp(request.param), _world(shape),
                    shape, body, ins)
    return shape, remat, outs


def _jax_loss_and_grads(tree, jcfg, jmesh):
    specs = jtfm.param_specs()
    fn = jax.shard_map(
        lambda p, i, l: jtfm.forward_local(p, i, l, jcfg, jtfm.SHARDED_AXES),
        mesh=jmesh, in_specs=(specs, P("dp", "sp"), P("dp", "sp")),
        out_specs=P())
    ids, labels = _batch()
    return jax.jit(jax.value_and_grad(fn))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids),
        jnp.asarray(labels))


def test_sharded_loss_and_every_gradient_equal_jax(gang, weights):
    shape, remat, outs = gang
    tree, jcfg = weights
    jcfg = dataclasses.replace(jcfg, remat=remat)
    jmesh = _jax_mesh(shape)
    loss, grads = _jax_loss_and_grads(tree, jcfg, jmesh)
    for o in outs:   # the (dp, sp) mean is the same number on every rank
        np.testing.assert_allclose(float(o["loss"]), float(loss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, grads))
    assert len(want) == 13
    for name, g in want.items():
        for o in outs:   # every rank gathers the same global gradient
            np.testing.assert_allclose(o["grad." + name], g, atol=1e-5,
                                       err_msg=name)


def test_sharded_grad_norm_equals_the_one_card_norm(gang, weights):
    shape, remat, outs = gang
    tree, jcfg = weights
    model = params_from_jax(tree, ttfm.TransformerConfig(**DIMS, remat=remat),
                            device="cpu")
    ids, labels = (torch.from_numpy(a).long() for a in _batch())
    ttfm.unsharded_loss(model, ids, labels).backward()
    one_card = float(ttfm._global_norm(p.grad for p in model.parameters()))
    _, grads = _jax_loss_and_grads(tree, jcfg,
                                   _jax_mesh(shape))
    for o in outs:
        np.testing.assert_allclose(float(o["gnorm"]), one_card, rtol=1e-5)
        np.testing.assert_allclose(float(o["gnorm"]),
                                   float(optax.global_norm(grads)),
                                   rtol=1e-5)


def test_train_steps_equal_jax_make_train_step(gang, weights):
    shape, _, outs = gang
    tree, jcfg = weights
    jmesh = _jax_mesh(shape)
    step, init_state = jtfm.make_train_step(jmesh, jcfg, ledger=False)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = init_state(params)
    ids, labels = map(jnp.asarray, _batch())
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, ids, labels)
        losses.append(float(loss))
    for o in outs:
        np.testing.assert_allclose(o["losses"], losses, rtol=1e-5)
        for name, w in _flat(jax.tree.map(np.asarray, params)).items():
            np.testing.assert_allclose(o["param." + name], w, atol=1e-5,
                                       err_msg=name)
    assert losses[-1] < losses[0]


def test_unknown_overlap_mode_raises():
    model = ttfm.init_params(ttfm.TransformerConfig(**DIMS),
                             torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="overlap"):
        ttfm.make_train_step(model, overlap="host")


def test_train_step_refuses_a_model_built_for_another_mesh():
    """A whole model on a mesh would compute every tp shard in full on
    each rank and sum them: refused."""
    model = ttfm.init_params(ttfm.TransformerConfig(**DIMS),
                             torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(DMLCError, match="mesh"):
        ttfm.make_train_step(model, mesh=build_mesh(device="cpu"))


def test_train_step_flops_equals_jax():
    jcfg = jtfm.flagship_config()
    cfg = ttfm.flagship_config()
    for b, t in ((8, 1024), (2, 4096), (1, 8192)):
        assert ttfm.train_step_flops(cfg, b, t) == \
            jtfm.train_step_flops(jcfg, b, t)
        assert ttfm.train_step_flops(cfg, b, t, causal=False) == \
            jtfm.train_step_flops(jcfg, b, t, causal=False)


def test_param_specs_equal_jax():
    """The port's table against the reference's PartitionSpecs, with the
    reference's two leading stage dims dropped."""
    specs = jtfm.param_specs()
    flat = {k: v for k, v in specs.items() if k != "blocks"}
    flat.update(specs["blocks"])
    for name, spec in flat.items():
        dims = tuple(spec)[2:] if name in specs["blocks"] else tuple(spec)
        want = tuple((i, a) for i, a in enumerate(dims) if a is not None)
        assert ttfm.PARAM_SPECS[name] == want, name
    assert set(ttfm.PARAM_SPECS) == set(flat)


def test_world_one_shards_equal_params_from_jax(weights):
    from dmlc_tpu_torch.models.convert import (gather_params,
                                               shard_params_from_jax)

    tree, _ = weights
    cfg = ttfm.TransformerConfig(**DIMS)
    a = shard_params_from_jax(tree, cfg, build_mesh(device="cpu"),
                              device="cpu")
    b = params_from_jax(tree, cfg, device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    got = _flat(gather_params(a))
    for name, w in _flat(tree).items():
        np.testing.assert_array_equal(got[name], w)
