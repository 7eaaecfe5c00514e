"""Port parity: expert parallelism (ep) for the flagship's MoE FFNs, the
routed top-k FFN under tp, and the five-axis mesh, against dmlc_tpu.

The port runs as gangs of gloo processes (``run_gang``), the JAX side on
``build_mesh`` of the 8 host devices, the same mesh shape; weights from
the reference's ``init_params`` (perturbed, tests/test_torch_pipeline.py
``weights``) through ``shard_params_from_jax``.

* Routed top-k, by its loss: ep4 x tp2 at 8 ranks, the reference's
  ``test_topk_moe_sharded_matches_oracle`` config (4 experts, top-2,
  ample capacity): the port's loss against the reference's sharded loss
  and its ``unsharded_loss`` (1e-5 relative), and every gradient.
* Routed top-k, by its gradients, and dense soft gating: ep2 x tp2 at 4
  ranks, routed with capacity factor 100 (no drops) and 0.5 (drops), and
  dense: the loss, every gathered gradient (``gate`` included; 1e-5
  absolute) and the norm against the reference's; with drops, each
  shard's dropped-choice fraction of each routed call equal to the
  reference's (the multiset over shards, layers and microbatches, 1e-6).
* A train step: the loss and gradients, then 3 AdamW steps on dp2 x sp2
  x ep2 (8 ranks) against the reference's ``make_train_step(mesh, cfg)``
  on the config of tests/test_model.py
  ``test_topk_moe_train_step_learns``: losses 1e-5 relative, parameters
  1e-5 absolute, except the few elements whose first gradient is at
  AdamW's eps scale (below 1e-7: one of 8192 in ``w_gate``, 1.7e-8 in
  JAX against 1.9e-8 here), held to lr·steps (``check_train``).
* The mesh: ``build_mesh``'s coordinates and process groups (each axis,
  the (dp, sp) and (ep, tp) planes) against the JAX mesh's device grid
  over several pin sets at world 8, and ``copy_to`` / ``reduce_from``
  over ("ep", "tp") with their gradients against a vma-checked
  ``shard_map`` (1e-6)."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu.parallel import build_mesh as jbuild_mesh
from dmlc_tpu.parallel.mesh import MESH_AXES

from tests.test_torch_parallel import PKG, run_gang
from tests.test_torch_pipeline import (batch, check_loss_and_grads,
                                       check_train, flagship_gang, jax_mesh,
                                       weights)

ROUTED = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, d_ff=32,
              n_layers=2, n_experts=4, microbatches=2, moe_topk=2,
              moe_capacity_factor=100.0)
DENSE = dict(ROUTED, moe_topk=0)

# ---------------------------------------------------------------------------
# the routed FFN over ep4 x tp2, checked by its loss
# ---------------------------------------------------------------------------


def test_routed_ep4_tp2_loss_equals_jax_sharded_and_unsharded(tmp_path):
    shape = {"ep": 4, "tp": 2}
    tree, jcfg = weights(ROUTED, n_stages=1)
    ids, labels = batch(ROUTED["vocab"])
    outs = flagship_gang(tmp_path, shape, ROUTED, tree, overlaps=())
    check_loss_and_grads(outs, tree, jcfg, jax_mesh(shape), ids, labels)
    want = float(jtfm.unsharded_loss(jax.tree.map(jnp.asarray, tree),
                                     jnp.asarray(ids), jnp.asarray(labels),
                                     jcfg))
    for o in outs:
        np.testing.assert_allclose(float(o["loss"]), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# ep2 x tp2: routed with and without drops, dense
# ---------------------------------------------------------------------------

EP_CONFIGS = {
    "routed": dict(ROUTED, moe_debug_overflow=True),
    "routed_drops": dict(ROUTED, moe_capacity_factor=0.5,
                         moe_debug_overflow=True),
    "dense": DENSE,
}
EP_SHAPE = {"ep": 2, "tp": 2}


@pytest.fixture(scope="module", params=sorted(EP_CONFIGS))
def ep_gang(request, tmp_path_factory):
    dims = EP_CONFIGS[request.param]
    tree, jcfg = weights(dims, n_stages=1)
    outs = flagship_gang(tmp_path_factory.mktemp(request.param), EP_SHAPE,
                         dims, tree, overlaps=())
    return request.param, tree, jcfg, outs


def test_ep_loss_and_every_gradient_equal_jax(ep_gang):
    _, tree, jcfg, outs = ep_gang
    ids, labels = batch(ROUTED["vocab"])
    check_loss_and_grads(outs, tree, jcfg, jax_mesh(EP_SHAPE), ids, labels)


def test_ep_overflow_fraction_per_shard_equals_jax(ep_gang, monkeypatch):
    name, tree, jcfg, outs = ep_gang
    if not jcfg.moe_debug_overflow:
        assert all(o["overflow"].size == 0 for o in outs)
        return
    fracs = []
    monkeypatch.setattr(jtfm, "_record_moe_overflow",
                        lambda frac: fracs.append(float(frac)))
    ids, labels = batch(ROUTED["vocab"])
    fn = jax.shard_map(
        lambda p, i, l: jtfm.forward_local(p, i, l, jcfg, jtfm.SHARDED_AXES),
        mesh=jax_mesh(EP_SHAPE),
        in_specs=(jtfm.param_specs(), P("dp", "sp"), P("dp", "sp")),
        out_specs=P())
    jax.block_until_ready(jax.jit(fn)(jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(ids), jnp.asarray(labels)))
    jax.effects_barrier()
    got = sorted(float(f) for o in outs for f in o["overflow"])
    # 4 shards x 2 layers x 2 microbatches, one fraction a call
    assert len(got) == len(fracs) == 16
    np.testing.assert_allclose(got, sorted(fracs), atol=1e-6)
    assert (max(got) > 0) == (name == "routed_drops")


# ---------------------------------------------------------------------------
# a train step on dp2 x sp2 x ep2
# ---------------------------------------------------------------------------

TRAIN = dict(ROUTED, moe_capacity_factor=2.0, remat=True)


def test_routed_train_steps_on_dp2_sp2_ep2_equal_jax(tmp_path):
    shape = {"dp": 2, "sp": 2, "ep": 2}
    tree, jcfg = weights(TRAIN, n_stages=1)
    ids, labels = batch(TRAIN["vocab"], b=8)
    outs = flagship_gang(tmp_path, shape, TRAIN, tree, ids=(ids, labels))
    grads = check_loss_and_grads(outs, tree, jcfg, jax_mesh(shape), ids,
                                 labels)
    check_train(outs, tree, jcfg, jax_mesh(shape), ids, labels, grads=grads)


# ---------------------------------------------------------------------------
# the mesh: coordinates and groups, copy_to / reduce_from over (ep, tp)
# ---------------------------------------------------------------------------

PINS = [{}, {"dp": 2, "ep": 2, "tp": 2}, {"pp": 2, "ep": 2, "tp": 2},
        {"pp": 4, "tp": 2}, {"ep": 4, "tp": 2}, {"pp": 2, "dp": 2, "ep": 2},
        {"pp": 2, "sp": 2, "ep": 2}]
PLANES = {("dp", "sp"), ("ep", "tp")}

_MESH_BODY = """
from {pkg}.parallel import build_mesh
from {pkg}.parallel import collectives as coll
docs = []
for pins in {pins!r}:
    m = build_mesh(device="cpu", **pins)
    docs.append({{"shape": m.shape, "coords": m.coords, "groups": {{
        "+".join(k) if isinstance(k, tuple) else k:
            dist.get_process_group_ranks(pg) for k, pg in m.groups.items()}}}})
OUT["docs"] = np.frombuffer(json.dumps(docs).encode(), np.uint8)
m = build_mesh(device="cpu", pp=2, ep=2, tp=2)
pp = m.axis_rank("pp")
x = torch.from_numpy(IN["x"][pp]).requires_grad_(True)
y = coll.copy_to(x, ("ep", "tp"), mesh=m)
(y * torch.from_numpy(IN["w"][RANK])).sum().backward()
OUT["copy_to"], OUT["copy_to_grad"] = y.detach(), x.grad
x = torch.from_numpy(IN["x"][RANK]).requires_grad_(True)
y = coll.reduce_from(x, ("ep", "tp"), mesh=m)
(y * torch.from_numpy(IN["w"][pp])).sum().backward()
OUT["reduce_from"], OUT["reduce_from_grad"] = y.detach(), x.grad
"""


@pytest.fixture(scope="module")
def mesh_gang(tmp_path_factory):
    rng = np.random.default_rng(3)
    ins = {"x": rng.standard_normal((8, 4, 8)).astype(np.float32),
           "w": rng.standard_normal((8, 4, 8)).astype(np.float32)}
    outs = run_gang(tmp_path_factory.mktemp("mesh5"), 8, {"dp": 8},
                    _MESH_BODY.format(pkg=PKG, pins=PINS), ins)
    return ins, outs


def test_coordinates_and_groups_equal_the_jax_device_grid(mesh_gang):
    _, outs = mesh_gang
    docs = [json.loads(o["docs"].tobytes()) for o in outs]
    for i, pins in enumerate(PINS):
        jmesh = jbuild_mesh(8, **pins)
        grid = np.vectorize(lambda d: d.id)(np.asarray(jmesh.devices))
        for r, doc in enumerate(d[i] for d in docs):
            assert doc["shape"] == dict(jmesh.shape), pins
            pos = tuple(int(c) for c in np.argwhere(grid == r)[0])
            assert [doc["coords"][a] for a in MESH_AXES] == list(pos), pins
            want = {}
            for axes in [(a,) for a in MESH_AXES] + sorted(PLANES):
                dims = [MESH_AXES.index(a) for a in axes]
                if any(grid.shape[d] == 1 for d in dims):
                    continue
                sl = tuple(slice(None) if k in dims else pos[k]
                           for k in range(grid.ndim))
                want["+".join(axes)] = sorted(int(v) for v in
                                              grid[sl].reshape(-1))
            assert {k: sorted(v) for k, v in doc["groups"].items()} == want, \
                (pins, r)


def test_copy_to_and_reduce_from_over_ep_tp_equal_shard_map(mesh_gang):
    ins, outs = mesh_gang
    jmesh = jbuild_mesh(8, pp=2, ep=2, tp=2, dp=1, sp=1)
    every = P(MESH_AXES)
    x, w = (jnp.asarray(ins[k]) for k in ("x", "w"))

    def copy_loss(xp, wr):   # xp varies over pp only, wr over every axis
        return lax.psum(jnp.sum(xp * wr), MESH_AXES)

    def reduce_loss(xr, wp):
        return lax.psum(jnp.sum(lax.psum(xr, ("ep", "tp")) * wp),
                        ("pp", "dp", "sp"))

    cg = jax.grad(jax.shard_map(copy_loss, mesh=jmesh,
                                in_specs=(P("pp"), every), out_specs=P()))(
        x[:2], w)
    rg = jax.grad(jax.shard_map(reduce_loss, mesh=jmesh,
                                in_specs=(every, P("pp")), out_specs=P()))(
        x, w[:2])
    sums = np.asarray(jax.shard_map(
        lambda v: lax.psum(v, ("ep", "tp")), mesh=jmesh, in_specs=every,
        out_specs=every, check_vma=False)(x))
    grid = np.vectorize(lambda d: d.id)(np.asarray(jmesh.devices))
    for r, o in enumerate(outs):
        pp = int(np.argwhere(grid == r)[0][0])
        np.testing.assert_array_equal(o["copy_to"], ins["x"][pp])
        np.testing.assert_allclose(o["copy_to_grad"], np.asarray(cg)[pp],
                                   atol=1e-6)
        np.testing.assert_allclose(o["reduce_from"], sums[r], atol=1e-6)
        np.testing.assert_allclose(o["reduce_from_grad"],
                                   np.asarray(rg)[r], atol=1e-6)
