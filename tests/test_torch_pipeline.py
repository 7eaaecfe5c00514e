"""Port parity: the SPMD pipeline, and the flagship on pp meshes, against
dmlc_tpu's ``pipeline_spmd``, ``forward_local`` under ``shard_map`` and
``make_train_step(mesh)``; and ``make_train_step(overlap="device")``.

The port runs as gangs of gloo processes (tests/test_torch_parallel.py
``run_gang``); the JAX side on ``build_mesh(n, ...)`` of the 8 host
devices, the same mesh shape.  Weights come from the reference's
``init_params(..., n_stages=P)`` (perturbed to O(0.2), as
tests/test_torch_sharded_model.py does) through
``shard_params_from_jax``.

* The pipeline alone: 4 stages of ``tanh(h @ w)``, M=8 (the setup of
  tests/test_parallel.py ``test_pipeline_matches_sequential``) on a pp4
  gang, against the JAX pipeline and the sequential oracle within 1e-5;
  its input and weight gradients against ``jax.grad`` of the JAX
  pipeline in a vma-checked ``shard_map`` within 1e-5; the ``pipeline``
  gauges equal the JAX package's after one call.
* The flagship (float32, tiny widths, 4 layers, 2 microbatches) on pp2 x
  sp2 x tp2 (tests/test_model.py's fixture) and on pp2 x dp2 under
  remat ``save_flash``: the loss (1e-5 relative) and all 13 gathered
  gradients (1e-5 absolute) against ``jax.value_and_grad`` of
  ``shard_map(forward_local)``, ``sharded_grad_norm`` against
  ``optax.global_norm`` (1e-5 relative), and 3 AdamW steps (losses
  1e-5 relative, final parameters 1e-5 absolute) against the
  reference's ``make_train_step(mesh, cfg)``.
* ``overlap="device"`` on dp2 x sp2: 3 AdamW steps against the
  reference's ``make_train_step(mesh, cfg, overlap="device")`` at the
  same tolerances, and equal to the port's ``overlap=None`` within f32
  rounding (losses 1e-6 relative, parameters 1e-6 absolute: a mean
  summed then divided against one divided then summed); the first step's
  (dp, sp)-reduced gradients and their norm in each mode against
  ``jax.value_and_grad`` and ``optax.global_norm`` (1e-5), and the
  device mode's against the fused (1e-6); the bucket count for
  ``DMLC_COLL_BUCKET_MB=0.004`` against the reference's fill rule; the
  buckets reduced in bucket order on every rank while odd ranks' hooks
  fire last-first, some during the backward on the others, the replicas
  equal after; and, in one process with a fake group, each bucket
  issued as soon as it and every earlier one are whole, whatever order
  the hooks fire in, and each sum divided by the group's size."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from dmlc_tpu import telemetry as jtel
from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu.parallel import build_mesh as jbuild_mesh
from dmlc_tpu.parallel import pipeline as jpipeline

from tests.test_torch_parallel import PKG, run_gang

DIMS = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, d_ff=32,
            n_layers=4, n_experts=2, microbatches=2)
B, T, STEPS = 4, 16, 3


def world(shape):
    return int(np.prod(list(shape.values())))


def jax_mesh(shape):
    full = {"pp": 1, "dp": 1, "sp": 1, "ep": 1, "tp": 1, **shape}
    return jbuild_mesh(world(shape), **full)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def weights(dims, n_stages, seed=0):
    """The reference's tree (numpy leaves, blocks ``[S, L/S, ...]``) and
    config; the matrices perturbed to O(0.2) so every weight moves the
    loss."""
    jcfg = jtfm.TransformerConfig(**dims)
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(seed), jcfg, n_stages=n_stages))
    rng = np.random.default_rng(7)
    tree = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.2).astype(a.dtype)
        if a.ndim >= 2 else a, tree)
    return tree, jcfg


def batch(vocab, b=B, t=T, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, t)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


#: the port's side of a flagship parity gang: the loss, gradients and norm
#: of one forward_local, then ``steps`` AdamW steps for each overlap mode
FLAGSHIP_BODY = """
from {pkg} import telemetry
from {pkg}.models import transformer as tfm
from {pkg}.models.convert import gather_params, shard_params_from_jax
cfg = tfm.TransformerConfig(**json.loads({dims!r}))
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
OUT["coords"] = np.array([mesh.coords[a] for a in
                          ("pp", "dp", "sp", "ep", "tp")])
model = shard_params_from_jax(tree, cfg, mesh, device="cpu")
fracs, inc = [], telemetry.inc
def spy(stage, name, value=1.0):   # each routed call's dropped fraction
    if (stage, name) == ("moe", "overflow_fraction_sum"):
        fracs.append(value)
    inc(stage, name, value)
telemetry.inc = spy
loss = tfm.forward_local(model, local(ids), local(labels), cfg,
                         tfm.SHARDED_AXES, mesh)
telemetry.inc = inc
OUT["overflow"] = np.array(fracs)
loss.backward()
tfm.sync_gradients(model, mesh)
OUT["loss"] = loss.detach()
OUT["gnorm"] = tfm.sharded_grad_norm(model, mesh)
save("grad.", gather_params(model, mesh, grads=True))
for overlap in {overlaps!r}:
    model = shard_params_from_jax(tree, cfg, mesh, device="cpu")
    step = tfm.make_train_step(model, ledger=False, mesh=mesh,
                               overlap=overlap, grad_norm=True)
    # a declined first step: the step's reduced gradients and their norm,
    # the parameters untouched
    loss, gnorm = step(ids, labels, accept=lambda loss, gnorm: False)
    OUT["step_loss.%s" % overlap] = loss
    OUT["step_gnorm.%s" % overlap] = gnorm
    save("step_grad.%s." % overlap, gather_params(model, mesh, grads=True))
    OUT["losses." + str(overlap)] = np.array(
        [float(step(ids, labels)[0]) for _ in range({steps})])
    save("param.%s." % overlap, gather_params(model, mesh))
"""


def flagship_gang(tmp, shape, dims, tree, overlaps=(None,), ids=None):
    ids, labels = batch(dims["vocab"]) if ids is None else ids
    ins = {"w." + k: v for k, v in flat(tree).items()}
    ins.update(ids=ids, labels=labels)
    body = FLAGSHIP_BODY.format(pkg=PKG, dims=json.dumps(dims),
                                overlaps=list(overlaps), steps=STEPS)
    return run_gang(tmp, world(shape), shape, body, ins)


def jax_loss_and_grads(tree, jcfg, jmesh, ids, labels):
    specs = jtfm.param_specs()
    fn = jax.shard_map(
        lambda p, i, l: jtfm.forward_local(p, i, l, jcfg, jtfm.SHARDED_AXES),
        mesh=jmesh, in_specs=(specs, P("dp", "sp"), P("dp", "sp")),
        out_specs=P())
    return jax.jit(jax.value_and_grad(fn))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids),
        jnp.asarray(labels))


def jax_train(tree, jcfg, jmesh, ids, labels, **kw):
    step, init_state = jtfm.make_train_step(jmesh, jcfg, ledger=False, **kw)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = init_state(params)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(ids),
                                       jnp.asarray(labels))
        losses.append(float(loss))
    return losses, flat(jax.tree.map(np.asarray, params))


def check_loss_and_grads(outs, tree, jcfg, jmesh, ids, labels):
    """The loss and every gathered gradient against the reference's on the
    same mesh shape, and the sharded norm against ``optax.global_norm``;
    returns the reference's gradients, flattened."""
    loss, grads = jax_loss_and_grads(tree, jcfg, jmesh, ids, labels)
    for o in outs:   # the (dp, sp) mean is the same number on every rank
        np.testing.assert_allclose(float(o["loss"]), float(loss), rtol=1e-5)
    want = flat(jax.tree.map(np.asarray, grads))
    assert len(want) == 13
    for name, g in want.items():
        for o in outs:   # every rank gathers the same global gradient
            np.testing.assert_allclose(o["grad." + name], g, atol=1e-5,
                                       err_msg=name)
    for o in outs:
        np.testing.assert_allclose(float(o["gnorm"]),
                                   float(optax.global_norm(grads)),
                                   rtol=1e-5)
    return want


#: AdamW's eps: a gradient this small steps by g / (|g| + eps), where a
#: rounding difference of 1e-9 in g moves the update by O(lr)
ADAM_EPS_SCALE = 1e-7


def check_train(outs, tree, jcfg, jmesh, ids, labels, overlap=None,
                tol=1e-5, grads=None, **kw):
    """The port's ``STEPS`` AdamW steps against the reference's: the
    losses within ``tol`` relative, every final parameter within ``tol``.
    With ``grads`` (the first step's global gradients), an element whose
    gradient is nonzero and below ``ADAM_EPS_SCALE`` is held to lr·steps
    instead
    (AdamW's eps amplifies its rounding), and at most 0.1% of a leaf's
    elements may be such."""
    losses, params = jax_train(tree, jcfg, jmesh, ids, labels, **kw)
    for o in outs:
        np.testing.assert_allclose(o[f"losses.{overlap}"], losses, rtol=tol)
        for name, w in params.items():
            got = o[f"param.{overlap}.{name}"]
            g = np.abs(grads[name]) if grads is not None else None
            tiny = (np.zeros(w.shape, bool) if g is None
                    else (g > 0) & (g < ADAM_EPS_SCALE))
            assert tiny.mean() <= 1e-3, name
            np.testing.assert_allclose(got[~tiny], w[~tiny], atol=tol,
                                       err_msg=name)
            np.testing.assert_allclose(got[tiny], w[tiny],
                                       atol=1e-3 * STEPS, err_msg=name)
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# the pipeline alone
# ---------------------------------------------------------------------------

N_STAGE, M, MB, DIM = 4, 8, 2, 16

_PIPE_BODY = """
from {pkg} import telemetry
from {pkg}.parallel.pipeline import make_pipeline
ws = torch.from_numpy(IN["ws"]).requires_grad_(True)
x = torch.from_numpy(IN["x"]).requires_grad_(True)
telemetry.reset()
run = make_pipeline(mesh, lambda w, h: torch.tanh(h @ w))
out = run(ws, x)
snap = telemetry.snapshot()
(out * torch.from_numpy(IN["ct"])).sum().backward()
OUT["out"] = out.detach()
OUT["dx"] = x.grad
OUT["dws"] = ws.grad
OUT["telemetry"] = np.frombuffer(json.dumps(
    {{part: snap[part].get("pipeline", {{}})
     for part in ("counters", "gauges", "histograms")}}).encode(), np.uint8)
OUT["spans"] = np.frombuffer(json.dumps(
    [s for s in telemetry.spans() if s["name"] == "pipeline.run"]).encode(),
    np.uint8)
"""


def _pipe_inputs():
    key = jax.random.PRNGKey(3)
    ws = np.asarray(jax.random.normal(key, (N_STAGE, DIM, DIM))
                    / np.sqrt(DIM))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (M, MB, DIM)))
    ct = np.random.default_rng(5).standard_normal((M, MB, DIM)).astype(
        np.float32)
    return ws.astype(np.float32), x.astype(np.float32), ct


def _jax_pipeline(jmesh, check_vma):
    def stage_fn(w, h):
        return jnp.tanh(h @ w)

    def inner(w_local, x_mb):
        return jpipeline.pipeline_spmd(stage_fn, w_local[0], x_mb,
                                       axis_name="pp")

    return jax.shard_map(inner, mesh=jmesh, in_specs=(P("pp"), P()),
                         out_specs=P(), check_vma=check_vma)


@pytest.fixture(scope="module")
def pipe_gang(tmp_path_factory):
    ws, x, ct = _pipe_inputs()
    outs = run_gang(tmp_path_factory.mktemp("pipe"), N_STAGE, {"pp": 4},
                    _PIPE_BODY.format(pkg=PKG), {"ws": ws, "x": x, "ct": ct})
    return (ws, x, ct), outs


def test_pipeline_equals_jax_and_the_sequential_oracle(pipe_gang):
    (ws, x, _), outs = pipe_gang
    want = x
    for s in range(N_STAGE):
        want = np.tanh(want @ ws[s])
    got_jax = np.asarray(jax.jit(_jax_pipeline(jax_mesh({"pp": 4}),
                                               False))(ws, x))
    for o in outs:   # every pp rank holds the outputs
        np.testing.assert_allclose(o["out"], got_jax, atol=1e-5)
        np.testing.assert_allclose(o["out"], want, atol=1e-5)


def test_pipeline_gradients_equal_jax_grad_under_vma(pipe_gang):
    (ws, x, ct), outs = pipe_gang
    fn = _jax_pipeline(jax_mesh({"pp": 4}), True)
    dws, dx = jax.grad(lambda w, v: jnp.sum(fn(w, v) * ct),
                       argnums=(0, 1))(jnp.asarray(ws), jnp.asarray(x))
    for o in outs:   # the input's cotangent is summed over pp
        np.testing.assert_allclose(o["dx"], np.asarray(dx), atol=1e-5)
    # each stage's weight gradient on its own rank, zeros elsewhere
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["dws"][r], np.asarray(dws)[r],
                                   atol=1e-5)
        assert not np.delete(o["dws"], r, axis=0).any()


def test_pipeline_telemetry_equals_jax_after_one_call(pipe_gang):
    (ws, x, _), outs = pipe_gang
    jtel.reset()
    jax.jit(_jax_pipeline(jax_mesh({"pp": 4}), False))(ws, x)
    snap = jtel.snapshot()
    want = {part: snap[part].get("pipeline", {})
            for part in ("counters", "gauges", "histograms")}
    assert want["gauges"]["bubble_fraction"] == pytest.approx(3 / 11)
    for o in outs:
        got = json.loads(o["telemetry"].tobytes())
        assert got == json.loads(json.dumps(want))
        spans = json.loads(o["spans"].tobytes())
        assert [s["args"] for s in spans] == [
            {"stages": 4, "microbatches": M, "tokens": M * MB * DIM}]


# ---------------------------------------------------------------------------
# the flagship on pp meshes
# ---------------------------------------------------------------------------

PP_MESHES = {"pp2_sp2_tp2": ({"pp": 2, "dp": 1, "sp": 2, "tp": 2}, False),
             "pp2_dp2": ({"pp": 2, "dp": 2, "sp": 1, "tp": 1}, True)}


@pytest.fixture(scope="module", params=sorted(PP_MESHES))
def pp_gang(request, tmp_path_factory):
    shape, remat = PP_MESHES[request.param]
    dims = dict(DIMS, remat=remat)
    tree, jcfg = weights(dims, n_stages=shape["pp"])
    outs = flagship_gang(tmp_path_factory.mktemp(request.param), shape, dims,
                         tree)
    return shape, tree, jcfg, outs


def test_pp_mesh_loss_gradients_and_norm_equal_jax(pp_gang):
    shape, tree, jcfg, outs = pp_gang
    ids, labels = batch(DIMS["vocab"])
    check_loss_and_grads(outs, tree, jcfg, jax_mesh(shape), ids, labels)
    # pp rank s holds layers [s·L/P, (s+1)·L/P): its coordinate is the
    # JAX mesh's device grid position of the same rank
    grid = np.asarray(jax_mesh(shape).devices)
    for r, o in enumerate(outs):
        pos = np.argwhere(np.vectorize(lambda d: d.id)(grid) == r)[0]
        np.testing.assert_array_equal(o["coords"], pos)


def test_pp_mesh_train_steps_equal_jax_make_train_step(pp_gang):
    shape, tree, jcfg, outs = pp_gang
    ids, labels = batch(DIMS["vocab"])
    check_train(outs, tree, jcfg, jax_mesh(shape), ids, labels)


def test_microbatches_that_do_not_divide_the_batch_raise():
    from dmlc_tpu_torch.base import DMLCError
    from dmlc_tpu_torch.models import transformer as ttfm
    from dmlc_tpu_torch.models.convert import params_from_jax
    from dmlc_tpu_torch.parallel import build_mesh

    tree, _ = weights(DIMS, n_stages=1)
    cfg = ttfm.TransformerConfig(**dict(DIMS, microbatches=3))
    model = params_from_jax(tree, cfg, device="cpu")
    ids = torch.zeros((4, T), dtype=torch.long)
    with pytest.raises(DMLCError, match="microbatches"):
        ttfm.forward_local(model, ids, ids, cfg, ttfm.SHARDED_AXES,
                           build_mesh(device="cpu"))


def test_flagship_config_runs_one_microbatch_as_jax():
    from dmlc_tpu_torch.models import transformer as ttfm

    assert ttfm.flagship_config().microbatches == \
        jtfm.flagship_config().microbatches == 1
    assert ttfm.TransformerConfig().microbatches == \
        jtfm.TransformerConfig().microbatches


# ---------------------------------------------------------------------------
# overlap="device"
# ---------------------------------------------------------------------------

OVERLAP_SHAPE = {"dp": 2, "sp": 2, "tp": 1}
BUCKET_MB = 0.004     # ~4 KB: the tiny model's leaves fill several buckets

_BUCKET_BODY = """
import os
os.environ["DMLC_COLL_BUCKET_MB"] = {mb!r}
import torch.distributed as dist
from {pkg} import telemetry
from {pkg}.models import transformer as tfm
from {pkg}.models.convert import shard_params_from_jax
from {pkg}.parallel import overlap as ov
cfg = tfm.TransformerConfig(**json.loads({dims!r}))
tree = {{"blocks": {{}}}}
for key, a in IN.items():
    if key.startswith("w."):
        parts = key[2:].split(".")
        (tree["blocks"] if len(parts) == 2 else tree)[parts[-1]] = a
ids = torch.from_numpy(IN["ids"]).long()
model = shard_params_from_jax(tree, cfg, mesh, device="cpu")
order = tfm._reverse_topological(model)
names = {{id(p): n for n, p in model.named_parameters()}}
OUT["order"] = np.frombuffer(json.dumps(
    [names[id(p)] for p in order]).encode(), np.uint8)
OUT["sizes"] = np.array([p.numel() * p.element_size() for p in order])
OUT["names"] = np.frombuffer(json.dumps(sorted(names.values())).encode(),
                             np.uint8)
# the hooks as they fire, and each bucket's all_reduce as it is issued;
# odd ranks hold every hook to the end of the backward and replay them
# last-first, so the ranks' hooks fire in different orders
fired, reduced, in_backward, held = [], [], [], []
ready, leave, all_reduce = (ov.DeviceBucketer._ready,
                            ov.DeviceBucketer.__exit__, dist.all_reduce)
def spy_ready(self, p):
    if self._armed and mesh.rank % 2:
        held.append(p)
        return
    if self._armed:
        fired.append(names[id(p)])
    ready(self, p)
def spy_exit(self, *exc):
    for p in reversed(held):
        fired.append(names[id(p)])
        ready(self, p)
    held.clear()
    leave(self, *exc)
    in_backward.append(self.launched_in_backward)
def spy_all_reduce(tensor, *args, **kw):
    if kw.get("async_op"):
        reduced.append(tensor.numel())
    return all_reduce(tensor, *args, **kw)
ov.DeviceBucketer._ready = spy_ready
ov.DeviceBucketer.__exit__ = spy_exit
dist.all_reduce = spy_all_reduce
step = tfm.make_train_step(model, ledger=False, mesh=mesh, overlap="device")
telemetry.reset()
for _ in range(2):
    step(ids, ids)
OUT["fired"] = np.frombuffer(json.dumps(fired).encode(), np.uint8)
OUT["reduced"] = np.array(reduced)
OUT["in_backward"] = np.array(in_backward)
OUT["buckets"] = telemetry.snapshot()["counters"]["collective"][
    "overlap_buckets"]
OUT["params"] = torch.cat([p.detach().reshape(-1)
                           for p in model.parameters()])
"""


@pytest.fixture(scope="module")
def overlap_gang(tmp_path_factory):
    dims = dict(DIMS, remat=True)
    tree, jcfg = weights(dims, n_stages=1)
    outs = flagship_gang(tmp_path_factory.mktemp("overlap"), OVERLAP_SHAPE,
                         dims, tree, overlaps=(None, "device"))
    return tree, jcfg, outs


def test_overlap_device_train_steps_equal_jax(overlap_gang):
    tree, jcfg, outs = overlap_gang
    ids, labels = batch(DIMS["vocab"])
    check_train(outs, tree, jcfg, jax_mesh(OVERLAP_SHAPE), ids, labels,
                overlap="device")


def test_overlap_device_equals_the_fused_reduction(overlap_gang):
    _, _, outs = overlap_gang
    for o in outs:
        np.testing.assert_allclose(o["losses.device"], o["losses.None"],
                                   rtol=1e-6)
        for name in (k for k in o if k.startswith("param.None.")):
            np.testing.assert_allclose(
                o[name.replace(".None.", ".device.")], o[name], atol=1e-6,
                err_msg=name)


def test_overlap_device_gradients_and_norm_equal_jax(overlap_gang):
    """The step's (dp, sp) means themselves, not only the AdamW steps
    (which hardly see a gradient's scale): each mode's gathered
    gradients and norm against ``jax.value_and_grad`` and
    ``optax.global_norm``, and the device mode's against the fused."""
    tree, jcfg, outs = overlap_gang
    ids, labels = batch(DIMS["vocab"])
    loss, grads = jax_loss_and_grads(tree, jcfg, jax_mesh(OVERLAP_SHAPE),
                                     ids, labels)
    want = flat(jax.tree.map(np.asarray, grads))
    assert len(want) == 13
    for o in outs:
        for mode in ("None", "device"):
            np.testing.assert_allclose(float(o[f"step_loss.{mode}"]),
                                       float(loss), rtol=1e-5)
            np.testing.assert_allclose(float(o[f"step_gnorm.{mode}"]),
                                       float(optax.global_norm(grads)),
                                       rtol=1e-5)
            for name, g in want.items():
                np.testing.assert_allclose(o[f"step_grad.{mode}.{name}"], g,
                                           atol=1e-5, err_msg=name)
        for name in want:
            np.testing.assert_allclose(o[f"step_grad.device.{name}"],
                                       o[f"step_grad.None.{name}"],
                                       atol=1e-6, err_msg=name)


def test_overlap_device_buckets_count_and_order(tmp_path, overlap_gang):
    from dmlc_tpu_torch.parallel.overlap import plan_buckets

    tree, _, _ = overlap_gang
    dims = dict(DIMS, remat=True)
    ids, _ = batch(DIMS["vocab"])
    ins = {"w." + k: v for k, v in flat(tree).items()}
    ins["ids"] = ids
    outs = run_gang(tmp_path, world(OVERLAP_SHAPE), OVERLAP_SHAPE,
                    _BUCKET_BODY.format(pkg=PKG, mb=str(BUCKET_MB),
                                        dims=json.dumps(dims)), ins)
    cap = int(BUCKET_MB * (1 << 20))
    sizes = outs[0]["sizes"]
    want = plan_buckets([torch.empty(int(n) // 4) for n in sizes], cap)
    assert 3 < len(want) < len(sizes)
    numels = [sum(int(sizes[i]) // 4 for i in b) for b in want]
    fired = [json.loads(o["fired"].tobytes()) for o in outs]
    for r, o in enumerate(outs):
        order = json.loads(o["order"].tobytes())
        assert order[:2] == ["unembed", "ln_f"] and order[-1] == "embed"
        # every parameter once: none escapes the (dp, sp) reduction
        assert sorted(order) == json.loads(o["names"].tobytes())
        # two steps, each reducing every bucket once, in bucket order,
        # whatever order this rank's hooks fired in
        assert list(o["reduced"]) == numels * 2
        assert int(o["buckets"]) == 2 * len(want)
        if r % 2:   # every hook held to the end: nothing in the backward
            assert fired[r] != fired[0]
            assert list(o["in_backward"]) == [len(want)] * 2
        else:       # the first buckets went out while the backward ran
            assert all(0 < n <= len(want) for n in o["in_backward"])
        # every leaf is replicated on dp2 x sp2: the replicas stay equal
        np.testing.assert_array_equal(o["params"], outs[0]["params"])


@pytest.mark.parametrize("seed", range(4))
def test_device_bucketer_launches_in_bucket_order_and_divides(seed,
                                                             monkeypatch):
    """One process, a fake group of 3: the hooks fire in a shuffled order;
    each bucket goes to ``all_reduce`` as soon as it and every earlier
    bucket are whole, in bucket order; leaving divides each sum (here
    the rank's own gradients) by the group's size."""
    import torch.distributed as dist

    from dmlc_tpu_torch.parallel.overlap import DeviceBucketer

    class Work:
        def wait(self):
            pass

    class Mesh:
        def group(self, axis):
            return "group"

        def axis_size(self, axis):
            return 3

    rng = np.random.default_rng(seed)
    params = [torch.nn.Parameter(torch.zeros(int(n)))
              for n in rng.integers(1, 40, size=12)]
    buckets = DeviceBucketer(params, ("dp", "sp"), Mesh(), 60 * 4)
    plan = buckets.buckets
    assert 2 < len(plan) < len(params)
    reduced = []
    monkeypatch.setattr(dist, "all_reduce", lambda t, **kw: (
        reduced.append(t.numel()), Work())[1])
    grads = [torch.from_numpy(rng.standard_normal(p.numel()).astype(
        np.float32)) for p in params]
    whole = set()
    with buckets:
        for i in rng.permutation(len(params)):
            params[i].grad = grads[i].clone()
            whole.add(int(i))
            buckets._ready(params[i])
            # launched: the longest prefix of buckets that are whole
            n = 0
            while n < len(plan) and set(plan[n]) <= whole:
                n += 1
            assert len(reduced) == n
    want = [sum(params[i].numel() for i in b) for b in plan]
    assert reduced == want
    for p, g in zip(params, grads):
        torch.testing.assert_close(p.grad, g / 3, rtol=0, atol=0)
