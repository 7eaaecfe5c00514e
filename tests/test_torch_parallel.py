"""Port parity: the mesh over torch.distributed, its named collectives,
ring attention, Ulysses and the psum worker against dmlc_tpu's, on the
CPU.

The port's side runs as gangs of processes on gloo (``run_gang``: each
rank a fresh interpreter with OMP_NUM_THREADS=1, joined with a timeout
so a mismatched collective fails the test instead of hanging the
suite); the JAX side on the 8 host devices of tests/conftest.py, through
``shard_map`` on ``build_mesh(4, ...)``.  Rank r of the port's mesh is
device r of the JAX mesh: both lay ranks out in MESH_AXES order.
Tolerances: collectives exact (sums of a few float32 terms compare at
1e-6); ring attention and Ulysses as tests/test_parallel.py (2e-5
forward, 1e-4 gradients, float32)."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import dmlc_tpu_torch
from dmlc_tpu.ops.flash_attention import block_attend_flash
from dmlc_tpu.parallel import build_mesh as jbuild_mesh
from dmlc_tpu.parallel import collectives as jcoll
from dmlc_tpu.parallel import factorize_devices as jfactorize
from dmlc_tpu.parallel.mesh import MESH_AXES
from dmlc_tpu.parallel.ring_attention import make_sharded_ring_attention
from dmlc_tpu.parallel.ring_attention import ring_attention_reference
from dmlc_tpu.parallel.ulysses import ulysses_attention
from dmlc_tpu_torch.ops import flash_attention as tflash
from dmlc_tpu_torch.parallel import collectives as tcoll
from dmlc_tpu_torch.parallel import factorize_devices, mesh as tmesh

REPO = Path(__file__).resolve().parents[1]
PKG = dmlc_tpu_torch.__name__
GANG_TIMEOUT_S = 240

# ---------------------------------------------------------------------------
# the gang harness (also used by tests/test_torch_sharded_model.py)
# ---------------------------------------------------------------------------

_PRELUDE = """\
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from {pkg}.parallel import build_mesh, initialize_distributed
ARGS = json.loads({args!r})
RANK = int(os.environ["DMLC_TASK_ID"])
initialize_distributed(timeout_s=ARGS["timeout"])
mesh = build_mesh(**ARGS["mesh"], device="cpu")
IN = dict(np.load(ARGS["inputs"])) if ARGS["inputs"] else {{}}
OUT = {{}}
"""

_EPILOGUE = """
np.savez(os.path.join(ARGS["out"], "out.%d.npz" % RANK),
         **{k: np.asarray(v) for k, v in OUT.items()})
dist.barrier()
dist.destroy_process_group()
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gang(tmp_path, world, mesh, body, inputs=None,
             timeout=GANG_TIMEOUT_S):
    """Run ``body`` (Python source that reads ``mesh``, ``IN`` and
    ``ARGS`` and fills ``OUT``) in ``world`` gloo processes on ``mesh``
    (build_mesh's axis sizes); returns each rank's ``OUT`` as numpy
    arrays.  Every rank is killed and the test fails if the gang has not
    ended within ``timeout`` seconds."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    in_path = ""
    if inputs:
        in_path = str(tmp_path / "inputs.npz")
        np.savez(in_path, **inputs)
    args = json.dumps({"mesh": mesh, "inputs": in_path, "out": str(tmp_path),
                       "timeout": timeout})
    script = tmp_path / "rank.py"
    script.write_text(_PRELUDE.format(pkg=PKG, args=args)
                      + textwrap.dedent(body) + _EPILOGUE)
    env = dict(os.environ, OMP_NUM_THREADS="1", DMLC_NUM_WORKER=str(world),
               DMLC_JAX_COORD_URI="127.0.0.1",
               DMLC_JAX_COORD_PORT=str(free_port()),
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = []
    for r in range(world):
        log = open(tmp_path / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(script)], cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT, env=dict(env, DMLC_TASK_ID=str(r))),
            log))
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = {r: (tmp_path / f"rank{r}.log").read_text()[-3000:]
            for r in range(world)}
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exit {p.returncode}:\n{logs[r]}"
    return [dict(np.load(tmp_path / f"out.{r}.npz")) for r in range(world)]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

_PINS = [{}, {"tp": 1}, {"tp": 4}, {"sp": 1, "pp": 1}, {"dp": 2},
         {"tp": 2, "sp": 2}, {"ep": 2}, {"pp": 1, "ep": 1, "tp": 1}]


@pytest.mark.parametrize("world", [1, 2, 3, 4, 6, 8, 12, 16])
def test_factorize_devices_equals_jax(world):
    for pins in _PINS:
        try:
            want = jfactorize(world, **pins)
        except ValueError:
            with pytest.raises(ValueError):
                factorize_devices(world, **pins)
            continue
        assert factorize_devices(world, **pins) == want, (world, pins)


def test_mesh_axes_and_part_contract_equal_jax():
    from dmlc_tpu.parallel.mesh import mesh_config

    assert tmesh.MESH_AXES == MESH_AXES
    jcfg = mesh_config(jbuild_mesh(8, dp=2, sp=2, tp=2, pp=1, ep=1))
    tcfg = tmesh.MeshConfig(shape=dict(jcfg.shape))
    assert tcfg.data_parts == jcfg.data_parts
    for d in range(2):
        for s in range(2):
            c = {"dp": d, "sp": s}
            assert tcfg.part_index(c) == jcfg.part_index(c)


def test_world_one_mesh_makes_no_group_and_collectives_are_identity():
    mesh = tmesh.build_mesh(device="cpu")
    assert mesh.world == 1 and mesh.groups == {}
    x = torch.arange(6.0).reshape(2, 3)
    for y in (tcoll.all_reduce(x, "tp", mesh=mesh),
              tcoll.all_gather(x, "sp", mesh=mesh),
              tcoll.reduce_scatter(x, "dp", mesh=mesh),
              tcoll.broadcast(x, ("dp", "sp"), mesh=mesh),
              tcoll.ppermute_ring(x, "sp", mesh=mesh),
              tcoll.all_to_all(x, "tp", split_axis=1, concat_axis=0,
                               mesh=mesh),
              tcoll.copy_to(x, "tp", mesh=mesh),
              tcoll.reduce_from(x, "tp", mesh=mesh)):
        assert torch.equal(y, x)
    assert tcoll.barrier_sum("sp", mesh=mesh) == 1
    assert mesh.axis_rank("tp") == 0 and mesh.axis_size(("dp", "sp")) == 1


def test_initialize_distributed_raises_without_the_coordinator_port(
        monkeypatch):
    monkeypatch.setenv("DMLC_TASK_ID", "0")
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.delenv("DMLC_JAX_COORD_PORT", raising=False)
    with pytest.raises(RuntimeError, match="DMLC_JAX_COORD_PORT"):
        tcoll.initialize_distributed()
    # the reference raises the same error from the same env
    with pytest.raises(RuntimeError, match="DMLC_JAX_COORD_PORT"):
        jcoll.initialize_distributed()


def test_initialize_distributed_is_a_noop_at_world_one(monkeypatch):
    monkeypatch.setenv("DMLC_TASK_ID", "0")
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    assert tcoll.initialize_distributed() is None


def test_backend_is_picked_from_the_topology(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tcoll.pick_backend(4)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tcoll.pick_backend(4)[0] == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert tcoll.pick_backend(16)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcoll.pick_backend(2) == ("gloo", "no card")


# ---------------------------------------------------------------------------
# the named collectives: 4 processes against shard_map on build_mesh(4)
# ---------------------------------------------------------------------------

MESHES = {"dp1_sp2_tp2": {"dp": 1, "sp": 2, "tp": 2},
          "dp2_sp2_tp1": {"dp": 2, "sp": 2, "tp": 1}}

#: name -> (port call on x, JAX call on v); every axis name is a string
#: or a tuple, as both packages take them
_OPS = {
    "all_reduce_sum_sp": ("all_reduce(x, 'sp', mesh=mesh)",
                          lambda v: jcoll.all_reduce(v, "sp")),
    "all_reduce_sum_tp": ("all_reduce(x, 'tp', mesh=mesh)",
                          lambda v: jcoll.all_reduce(v, "tp")),
    "all_reduce_sum_dp": ("all_reduce(x, 'dp', mesh=mesh)",
                          lambda v: jcoll.all_reduce(v, "dp")),
    "all_reduce_sum_data": ("all_reduce(x, ('dp', 'sp'), mesh=mesh)",
                            lambda v: jcoll.all_reduce(v, ("dp", "sp"))),
    "all_reduce_max_sp": ("all_reduce(x, 'sp', 'max', mesh=mesh)",
                          lambda v: jcoll.all_reduce(v, "sp", "max")),
    "all_reduce_min_tp": ("all_reduce(x, 'tp', 'min', mesh=mesh)",
                          lambda v: jcoll.all_reduce(v, "tp", "min")),
    "all_reduce_mean_data": (
        "all_reduce(x, ('dp', 'sp'), 'mean', mesh=mesh)",
        lambda v: jcoll.all_reduce(v, ("dp", "sp"), "mean")),
    "all_gather_tp_0": ("all_gather(x, 'tp', mesh=mesh)",
                        lambda v: jcoll.all_gather(v, "tp")),
    "all_gather_sp_1": ("all_gather(x, 'sp', mesh=mesh, gather_axis=1)",
                        lambda v: jcoll.all_gather(v, "sp", gather_axis=1)),
    "all_gather_sp_stacked": (
        "all_gather(x, 'sp', mesh=mesh, tiled=False)",
        lambda v: jcoll.all_gather(v, "sp", tiled=False)),
    "reduce_scatter_sp_0": ("reduce_scatter(x, 'sp', mesh=mesh)",
                            lambda v: jcoll.reduce_scatter(v, "sp")),
    "reduce_scatter_data_1": (
        "reduce_scatter(x, ('dp', 'sp'), mesh=mesh, scatter_axis=1)",
        lambda v: jcoll.reduce_scatter(v, ("dp", "sp"), scatter_axis=1)),
    "broadcast_sp_1": ("broadcast(x, 'sp', 1, mesh=mesh)",
                       lambda v: jcoll.broadcast(v, "sp", 1)),
    "broadcast_data_1": ("broadcast(x, ('dp', 'sp'), 1, mesh=mesh)",
                         lambda v: jcoll.broadcast(v, ("dp", "sp"), 1)),
    "ppermute_sp": ("ppermute_ring(x, 'sp', mesh=mesh)",
                    lambda v: jcoll.ppermute_ring(v, "sp")),
    "ppermute_data_back": ("ppermute_ring(x, ('dp', 'sp'), -1, mesh=mesh)",
                           lambda v: jcoll.ppermute_ring(v, ("dp", "sp"),
                                                         -1)),
    "all_to_all_tp": (
        "all_to_all(x, 'tp', split_axis=1, concat_axis=0, mesh=mesh)",
        lambda v: jcoll.all_to_all(v, "tp", split_axis=1, concat_axis=0)),
    "all_to_all_data": (
        "all_to_all(x, ('dp', 'sp'), split_axis=0, concat_axis=1, "
        "mesh=mesh)",
        lambda v: jcoll.all_to_all(v, ("dp", "sp"), split_axis=0,
                                   concat_axis=1)),
}
#: the differentiable ops: the gradient of sum(w * op(x)) wrt x
_GRAD_OPS = ("ppermute_sp", "ppermute_data_back", "all_to_all_tp",
             "all_to_all_data")
_AXES = ("dp", "sp", "tp", ("dp", "sp"))

_COLL_BODY = """
from {pkg}.parallel.collectives import *
x = torch.from_numpy(IN["x"][RANK])
w = torch.from_numpy(IN["w"][RANK])
OPS = {ops!r}
for name, call in OPS.items():
    xg = x.clone().requires_grad_(True)
    y = eval(call, {{**globals(), "x": xg}})
    OUT[name] = y.detach()
    if name in {grad_ops!r}:
        (y * w[: y.shape[0], : y.shape[1]]).sum().backward()
        OUT[name + "_grad"] = xg.grad
for i, axis in enumerate({axes!r}):
    axis = tuple(axis) if isinstance(axis, list) else axis
    OUT["barrier_%d" % i] = barrier_sum(axis, mesh=mesh)
    OUT["rank_%d" % i] = axis_rank(axis, mesh)
    OUT["size_%d" % i] = axis_size(axis, mesh)
"""

_ALL = P(MESH_AXES)


def _jax_mesh(shape):
    return jbuild_mesh(4, pp=1, ep=1, **shape)


def _mapped(fn, jmesh, n_args=1):
    """``fn`` on each device's block of its arguments (leading dim =
    rank), the results stacked by rank."""
    return jax.shard_map(lambda *a: fn(*(t[0] for t in a))[None],
                         mesh=jmesh, in_specs=(_ALL,) * n_args,
                         out_specs=_ALL, check_vma=False)


def _per_rank(fn, jmesh, *args):
    return np.asarray(_mapped(fn, jmesh, len(args))(*args))


@pytest.fixture(scope="module", params=sorted(MESHES))
def collectives_gang(request, tmp_path_factory):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 4, 8)).astype(np.float32)
    w = rng.standard_normal((4, 16, 32)).astype(np.float32)
    body = _COLL_BODY.format(pkg=PKG, ops={k: v[0] for k, v in _OPS.items()},
                             grad_ops=_GRAD_OPS,
                             axes=[list(a) if isinstance(a, tuple) else a
                                   for a in _AXES])
    outs = run_gang(tmp_path_factory.mktemp("coll"), 4,
                    MESHES[request.param], body, {"x": x, "w": w})
    return MESHES[request.param], x, w, outs


@pytest.mark.parametrize("name", sorted(_OPS))
def test_collective_equals_jax_shard_map(collectives_gang, name):
    shape, x, w, outs = collectives_gang
    jmesh = _jax_mesh(shape)
    want = _per_rank(_OPS[name][1], jmesh, jnp.asarray(x))
    got = np.stack([o[name] for o in outs])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if name in _GRAD_OPS:
        def loss(v):
            y = _mapped(_OPS[name][1], jmesh)(v)
            return jnp.sum(y * jnp.asarray(w)[:, : y.shape[1], : y.shape[2]])

        g = np.asarray(jax.grad(loss)(jnp.asarray(x)))
        np.testing.assert_allclose(np.stack([o[name + "_grad"]
                                             for o in outs]), g,
                                   rtol=1e-6, atol=1e-6)


def test_axis_rank_size_and_barrier_equal_jax(collectives_gang):
    shape, _, _, outs = collectives_gang
    jmesh = _jax_mesh(shape)
    for i, axis in enumerate(_AXES):
        ranks = _per_rank(lambda v: jcoll.axis_rank(axis) + 0 * v[0], jmesh,
                          jnp.zeros((4, 1), jnp.int32))
        sizes = _per_rank(lambda v: jcoll.barrier_sum(axis) + 0 * v[0],
                          jmesh, jnp.zeros((4, 1), jnp.int32))
        assert [int(o[f"rank_{i}"]) for o in outs] == \
            [int(r) for r in ranks.reshape(-1)]
        assert [int(o[f"size_{i}"]) for o in outs] == \
            [int(r) for r in sizes.reshape(-1)]
        assert [int(o[f"barrier_{i}"]) for o in outs] == \
            [int(r) for r in sizes.reshape(-1)]


# ---------------------------------------------------------------------------
# block_attend's backward, ring attention and Ulysses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_off,kv_off,causal",
                         [(64, 0, True), (64, 64, True), (32, 96, True),
                          (64, 0, False)])
def test_block_attend_gradients_equal_pallas_interpret(q_off, kv_off,
                                                       causal):
    """The ring step's VJP at nonzero offsets: the port's plain recompute
    against jax.grad of the reference's block_attend_flash (the Pallas
    forward in interpret mode, the lax-twin backward)."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, 64, 2, 128)).astype(np.float32)
               for _ in range(3))
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((1, 64, 2, 128), (1, 2, 64), (1, 2, 64))]
    kw = dict(scale=128 ** -0.5, causal=causal)

    def jloss(q, k, v):
        outs = block_attend_flash(q, k, v, q_offset=q_off, kv_offset=kv_off,
                                  block_q=32, block_k=32, interpret=True,
                                  **kw)
        # a fully masked row's m is -1e30 on both sides; its cotangent
        # would only scale that constant
        return sum(jnp.sum(jnp.where(o > -1e29, o, 0.0) * c)
                   for o, c in zip(outs, cts))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    outs = tflash.block_attend(*leaves, q_offset=q_off, kv_offset=kv_off,
                               **kw)
    loss = sum((torch.where(o > -1e29, o, torch.zeros_like(o))
                * torch.from_numpy(c)).sum() for o, c in zip(outs, cts))
    loss.backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


ATTN_SHAPE = (2, 32, 8, 8)   # B, T, H, D: heads/tp divisible by sp

_ATTN_BODY = """
from {pkg}.parallel.ring_attention import make_sharded_ring_attention
from {pkg}.parallel.ulysses import ulysses_attention
sp, tp = mesh.axis_size("sp"), mesh.axis_size("tp")
si, ti = mesh.axis_rank("sp"), mesh.axis_rank("tp")
def local(a):
    return a.chunk(sp, dim=1)[si].chunk(tp, dim=2)[ti]
w = torch.from_numpy(IN["w"])
for causal in (True, False):
    qkv = [torch.from_numpy(IN[n]).requires_grad_(True) for n in "qkv"]
    out = make_sharded_ring_attention(mesh, causal=causal)(*qkv)
    (out * local(w)).sum().backward()
    tag = "ring_causal" if causal else "ring_full"
    OUT[tag] = out.detach()
    for n, t in zip("qkv", qkv):
        OUT[tag + "_d" + n] = t.grad
qkv = [torch.from_numpy(IN[n]).requires_grad_(True) for n in "qkv"]
out = ulysses_attention(*(local(t) for t in qkv), mesh=mesh, causal=True)
(out * local(w)).sum().backward()
OUT["ulysses"] = out.detach()
for n, t in zip("qkv", qkv):
    OUT["ulysses_d" + n] = t.grad
"""


@pytest.fixture(scope="module")
def attention_gang(tmp_path_factory):
    rng = np.random.default_rng(5)
    ins = {n: rng.standard_normal(ATTN_SHAPE).astype(np.float32)
           for n in "qkvw"}
    outs = run_gang(tmp_path_factory.mktemp("attn"), 4,
                    MESHES["dp1_sp2_tp2"], _ATTN_BODY.format(pkg=PKG), ins)
    return ins, outs


def _assemble(outs, key, sp=2, tp=2):
    """The global [B, T, H, D] from each rank's (sp, tp) block (rank =
    sp_index·tp + tp_index on the dp1 x sp2 x tp2 mesh)."""
    rows = [np.concatenate([outs[s * tp + t][key] for t in range(tp)],
                           axis=2) for s in range(sp)]
    return np.concatenate(rows, axis=1)


def _jax_attention(fn, ins):
    args = [jnp.asarray(ins[n]) for n in "qkv"]
    w = jnp.asarray(ins["w"])
    out = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * w),
                     argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_equals_jax_sharded_ring(attention_gang, causal):
    ins, outs = attention_gang
    jmesh = _jax_mesh(MESHES["dp1_sp2_tp2"])
    want, wgrads = _jax_attention(
        jax.jit(make_sharded_ring_attention(jmesh, causal=causal)), ins)
    tag = "ring_causal" if causal else "ring_full"
    np.testing.assert_allclose(_assemble(outs, tag), want, atol=2e-5)
    oracle = np.asarray(ring_attention_reference(
        *(jnp.asarray(ins[n]) for n in "qkv"), causal=causal))
    np.testing.assert_allclose(_assemble(outs, tag), oracle, atol=2e-5)
    for n, g in zip("qkv", wgrads):
        got = sum(o[f"{tag}_d{n}"] for o in outs)
        np.testing.assert_allclose(got, g, atol=1e-4)


def test_ulysses_equals_jax(attention_gang):
    ins, outs = attention_gang
    jmesh = _jax_mesh(MESHES["dp1_sp2_tp2"])
    spec = P(None, "sp", "tp", None)
    fn = jax.jit(jax.shard_map(
        lambda q, k, v: ulysses_attention(q, k, v, axis_name="sp",
                                          causal=True),
        mesh=jmesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False))
    want, wgrads = _jax_attention(fn, ins)
    np.testing.assert_allclose(_assemble(outs, "ulysses"), want, atol=2e-5)
    for n, g in zip("qkv", wgrads):
        got = sum(o[f"ulysses_d{n}"] for o in outs)
        np.testing.assert_allclose(got, g, atol=1e-4)


# ---------------------------------------------------------------------------
# the psum worker under the port's launcher
# ---------------------------------------------------------------------------

def test_psum_worker_under_the_launcher():
    cmd = [sys.executable, "-m", f"{PKG}.tracker.submit", "--cluster",
           "local", "--num-workers", "2", "--max-attempts", "1",
           "--host-ip", "127.0.0.1", "--", sys.executable, "-m",
           f"{PKG}.examples.psum_worker", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=GANG_TIMEOUT_S)
    text = res.stdout + res.stderr
    assert res.returncode == 0, text[-3000:]
    for r in range(2):
        assert f"rank {r}/2: torch psum OK -> 3.0 (backend gloo" in text, \
            text[-3000:]
