"""Port parity: sharded serving on every mesh the reference's engine
takes, against dmlc_tpu's engine on the same mesh, on the CPU.

tests/test_torch_shard_serve.py holds the dense model on dp × tp meshes;
this file holds the rest of the five axes.  A routed (top-k MoE) config
on dp2 × ep2, ep2 × tp2 and dp2 × tp2, where the gather path's dp split
must still route the whole batch; a dense config on pp2, pp2 × tp2 and
pp2 × dp2, where each stage serves its own layers, and on sp2 × tp2,
over which serving is replicated; a dense soft-gated MoE on ep2.  The
port's side runs as gangs of gloo processes, each rank holding the
shards ``shard_params_from_jax`` slices from one JAX tree; the JAX side is
``InferenceEngine(params, cfg, mesh=build_mesh(...))`` on the host
devices of tests/conftest.py.  Weights are perturbed by 0.2 so that
greedy tokens vary, and the routed config's capacity factor of 1.0 drops
choices at these sizes.

* ``kv_partition_spec`` equal to the reference's on meshes with pp, sp
  and ep;
* each rank's ``forward_prefill_last``, ``forward_decode``,
  ``forward_decode_spec`` and ``forward_decode_paged`` against the JAX
  one-device forwards: logits within 1e-5, its new K/V (and paged
  pools) within 1e-5 of its stage's layers and its heads of the JAX
  ones;
* a route over each dp rank's rows alone gives other logits and keeps
  other choices than the whole batch's, so these tests see that fault;
* the engine token for token against the JAX mesh engine under
  ``auto``, ``on`` and ``off`` at spec_k 0 and 3 through preemptions,
  on the path the reference's ``auto`` picks, the routed runs dropping
  choices;
* ``close()`` ends every follower, the other pp stage's too;
* what still raises: heads, experts or layers that do not divide their
  axis, sp named in the serving axes;
* ``chip_smoke.shard_serve_wide_phase`` end to end on the CPU with the
  tiny model, routed on dp2 × ep2 and dense on pp2 × tp2, served by
  ``shard_serve_phase``'s workers after their own gang as in the smoke.

Every test runs under its own SIGALRM limit (``LIMIT_S``)."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu.parallel import build_mesh as jbuild_mesh
from dmlc_tpu.serving import InferenceEngine as JaxEngine
from dmlc_tpu.serving.kv_cache import kv_partition_spec as jkv_spec
from dmlc_tpu_torch import telemetry
from dmlc_tpu_torch.base import DMLCError
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.models.convert import params_from_jax
from dmlc_tpu_torch.parallel.mesh import MESH_AXES, Mesh
from dmlc_tpu_torch.serving import kv_cache as tkv

from tests.test_torch_parallel import (PKG, REPO, _EPILOGUE, _PRELUDE,
                                       free_port)

DIMS = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, d_ff=32,
            n_layers=4)
#: the three configs: routed top-2 of 4 experts, dense, dense soft-gated
#: MoE of 2 experts
CONFIGS = {"routed": dict(n_experts=4, moe_topk=2, moe_capacity_factor=1.0),
           "dense": dict(n_experts=1), "soft": dict(n_experts=2)}
#: name -> (config, the mesh's axes of more than one rank)
MESHES = {"routed_dp2_ep2": ("routed", {"dp": 2, "ep": 2}),
          "routed_ep2_tp2": ("routed", {"ep": 2, "tp": 2}),
          "routed_dp2_tp2": ("routed", {"dp": 2, "tp": 2}),
          "dense_pp2": ("dense", {"pp": 2}),
          "dense_pp2_tp2": ("dense", {"pp": 2, "tp": 2}),
          "dense_pp2_dp2": ("dense", {"pp": 2, "dp": 2}),
          "dense_sp2_tp2": ("dense", {"sp": 2, "tp": 2}),
          "soft_ep2": ("soft", {"ep": 2})}
MODES = [(m, k) for m in ("auto", "on", "off") for k in (0, 3)]
PROMPTS = [[3, 9, 27, 17, 3, 9, 27], [5, 1, 5, 1, 5], [2, 2, 7, 2, 2],
           [11, 4, 11, 4, 11, 4]]
MAX_NEW = 12
#: a pool of 14 blocks of 4 tokens: the four requests start together and
#: cannot all finish, so the engine preempts
KW = dict(n_blocks=14, block_size=4, max_active=4, queue_depth=8)
TOL = 1e-5
#: gangs run at most this many at a time, beside the JAX engine runs
GANGS_AT_ONCE = 2
GANG_TIMEOUT_S = 150

LIMIT_S = {"test_sharded_forwards_equal_jax": 300,
           "test_engine_tokens_equal_jax_mesh_engine": 300,
           "test_close_ends_every_follower": 300,
           "test_chip_smoke_shard_serve_wide_phase_on_the_cpu": 360}
LIMIT_DEFAULT_S = 60


@pytest.fixture(autouse=True)
def time_limit(request):
    limit = LIMIT_S.get(request.node.originalname, LIMIT_DEFAULT_S)

    def expire(signum, frame):
        raise TimeoutError(f"{request.node.name}: over its {limit} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def serving_knobs(monkeypatch):
    monkeypatch.setenv("DMLC_SERVE_SPEC_MIN_CTX", "4")
    for knob in ("DMLC_SERVE_PAGED_ATTN", "DMLC_SERVE_SPEC_K"):
        monkeypatch.delenv(knob, raising=False)


def _dims(config):
    return dict(DIMS, **CONFIGS[config])


def _shape(axes):
    """Every mesh axis pinned: the named ones, the rest 1."""
    return {a: axes.get(a, 1) for a in MESH_AXES}


def _world(axes):
    return int(np.prod(list(axes.values()) or [1]))


def _weights(config):
    """The JAX tree (numpy leaves, one stage), perturbed to O(0.2)."""
    jcfg = jtfm.TransformerConfig(**_dims(config), microbatches=1)
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                     jcfg, n_stages=1))
    rng = np.random.default_rng(7)
    tree = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.2).astype(a.dtype)
        if a.ndim >= 2 else a, tree)
    return tree, jcfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _stand_in(rank=0, **axes):
    """Rank ``rank`` of a mesh of ``axes`` without process groups (for
    what reads only the mesh's shape and coordinates)."""
    shape = _shape(axes)
    coords = np.unravel_index(rank, [shape[a] for a in MESH_AXES])
    return Mesh(shape=shape, coords={a: int(c) for a, c in
                                     zip(MESH_AXES, coords)},
                rank=rank, device=torch.device("cpu"), groups={})


# ---------------------------------------------------------------------------
# the forwards' inputs (global: every layer, every head, every row)
# ---------------------------------------------------------------------------

B, TC, NBLK, BS, W = 4, 16, 12, 4, 3


def _inputs():
    """A prefill batch, a gathered cache with garbage past each length and
    a dead row, and paged pools whose row 2 is dead."""
    rng = np.random.default_rng(3)
    kv = (DIMS["n_layers"], B, TC, DIMS["n_heads"], DIMS["head_dim"])
    k = rng.standard_normal(kv).astype(np.float32)
    v = rng.standard_normal(kv).astype(np.float32)
    lengths = np.array([5, 0, TC, 9], np.int32)
    for i, n in enumerate(lengths):
        k[:, i, n:] = 1e3
        v[:, i, n:] = -1e3
    pools = (DIMS["n_layers"], NBLK, BS, DIMS["n_heads"], DIMS["head_dim"])
    p_lengths = np.array([5, 1, 0, W * BS - 3], np.int32)
    return {
        "pre_ids": rng.integers(0, DIMS["vocab"], (2, 12)).astype(np.int64),
        "pre_last": np.array([11, 6], np.int64),
        "ids": rng.integers(0, DIMS["vocab"], (B, 3)).astype(np.int64),
        "k": k, "v": v, "lengths": lengths,
        "positions": (lengths[:, None] + np.arange(3)).astype(np.int64),
        "k_pool": rng.standard_normal(pools).astype(np.float32),
        "v_pool": rng.standard_normal(pools).astype(np.float32),
        "tables": np.array([[0, 5, 7], [3, 9, 2], [0, 0, 0], [4, 1, 6]],
                           np.int32),
        "p_lengths": p_lengths,
        "p_positions": (p_lengths[:, None] + np.arange(3)).astype(np.int64),
    }


# ---------------------------------------------------------------------------
# the gangs: every rank runs the forwards, then the engine in each mode
# ---------------------------------------------------------------------------

_BODY = """
from {pkg} import serving
from {pkg} import telemetry
from {pkg}.models import transformer as tfm
from {pkg}.models.convert import shard_params_from_jax
cfg = tfm.TransformerConfig(**json.loads({dims!r}))
tree = {{"blocks": {{}}}}
for key, a in IN.items():
    if key.startswith("w."):
        parts = key[2:].split(".")
        (tree["blocks"] if len(parts) == 2 else tree)[parts[-1]] = a
model = shard_params_from_jax(tree, cfg, mesh, device="cpu")
T = {{k: torch.from_numpy(a) for k, a in IN.items() if not k.startswith("w.")}}
tp, ti = mesh.axis_size("tp"), mesh.axis_rank("tp")
dp, di = mesh.axis_size("dp"), mesh.axis_rank("dp")
pp, si = mesh.axis_size("pp"), mesh.axis_rank("pp")
ax = tfm.serving_axes(mesh)

def mine(x):   # this rank's layers [L, ...] and heads [..., H, D]
    x = x.chunk(pp, dim=0)[si]
    return x.chunk(tp, dim=-2)[ti].contiguous()

# 1. the forwards
with torch.inference_mode():
    lg, k, v = tfm.forward_prefill_last(model, T["pre_ids"], T["pre_last"],
                                        axes=ax, mesh=mesh)
    OUT.update({{"prefill.logits": lg, "prefill.k": k, "prefill.v": v}})
    rows = slice(di * T["k"].shape[1] // dp, (di + 1) * T["k"].shape[1] // dp)
    kc, vc = mine(T["k"])[:, rows], mine(T["v"])[:, rows]
    lg, k, v = tfm.forward_decode(model, T["ids"][:, 0],
                                  T["positions"][:, 0], kc, vc,
                                  T["lengths"], axes=ax, mesh=mesh)
    OUT.update({{"decode.logits": lg, "decode.k": k, "decode.v": v}})
    lg, k, v = tfm.forward_decode_spec(model, T["ids"], T["positions"], kc,
                                       vc, T["lengths"], axes=ax, mesh=mesh)
    OUT.update({{"spec.logits": lg, "spec.k": k, "spec.v": v}})
    kp, vp = mine(T["k_pool"]), mine(T["v_pool"])
    lg = tfm.forward_decode_paged(model, T["ids"], T["p_positions"], kp, vp,
                                  T["tables"], T["p_lengths"], axes=ax,
                                  mesh=mesh)
    OUT.update({{"paged.logits": lg, "paged.k_pool": kp, "paged.v_pool": vp}})

# 2. the engine: the controller serves, the followers follow
PROMPTS = json.loads({prompts!r})
KW = json.loads({kw!r})
model.cfg = dataclasses.replace(cfg, moe_debug_overflow=cfg.routed)

def run(name, mode, spec_k):
    os.environ["DMLC_SERVE_PAGED_ATTN"] = mode
    telemetry.reset()
    eng = serving.InferenceEngine(model, mesh=mesh, device="cpu",
                                  spec_k=spec_k, **KW)
    OUT["pool_layers." + name] = np.array(eng.cache.k_pool.shape[0])
    if mesh.rank != 0:
        eng.follow()
        OUT["followed." + name] = np.array(1)
    else:
        # every request queued before the loop starts, as on the JAX side:
        # a routed model's tokens depend on which rows share a call
        reqs = [eng.submit(p, max_new_tokens={max_new}) for p in PROMPTS]
        eng.start()
        try:
            for r in reqs:
                assert r.wait(120), r.id
                assert r.error is None, r.error
        finally:
            eng.close()
        c = eng.counters
        OUT["tok." + name] = np.array([list(r.generated) for r in reqs])
        OUT["counters." + name] = np.array(
            [c["prefills"], c["preemptions"], c["tokens_generated"]])
        OUT["paged." + name] = np.array(eng._use_paged)
    OUT["dropped." + name] = np.array(
        telemetry.core.counter_value("moe", "overflow_fraction_sum"))

for mode, spec in json.loads({modes!r}):
    run(f"{{mode}}.{{spec}}", mode, spec)
"""

_GANGS = {}


def _start(name, root):
    """Start ``name``'s gang (run_gang's harness, not waited for)."""
    config, axes = MESHES[name]
    tree, _ = _weights(config)
    inputs = {"w." + k: v for k, v in _flat(tree).items()}
    inputs.update(_inputs())
    root.mkdir(parents=True, exist_ok=True)
    np.savez(root / "inputs.npz", **inputs)
    body = "import dataclasses\n" + _BODY.format(
        pkg=PKG, dims=json.dumps(_dims(config)), prompts=json.dumps(PROMPTS),
        kw=json.dumps(KW), modes=json.dumps(MODES), max_new=MAX_NEW)
    args = json.dumps({"mesh": _shape(axes), "inputs": str(root /
                                                            "inputs.npz"),
                       "out": str(root), "timeout": GANG_TIMEOUT_S})
    script = root / "rank.py"
    script.write_text(_PRELUDE.format(pkg=PKG, args=args)
                      + textwrap.dedent(body) + _EPILOGUE)
    world = _world(axes)
    env = dict(os.environ, OMP_NUM_THREADS="1", DMLC_NUM_WORKER=str(world),
               DMLC_JAX_COORD_URI="127.0.0.1",
               DMLC_JAX_COORD_PORT=str(free_port()),
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = []
    for r in range(world):
        log = open(root / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(script)], cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT, env=dict(env, DMLC_TASK_ID=str(r))),
            log))
    return root, procs


def _finish(started):
    """Wait for a started gang (every rank killed past its timeout) and
    return each rank's ``OUT``; fails unless every rank exited 0."""
    root, procs = started
    try:
        for p, _ in procs:
            p.wait(timeout=GANG_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        log = (root / f"rank{r}.log").read_text()[-3000:]
        assert p.returncode == 0, f"rank {r} exit {p.returncode}:\n{log}"
    return [dict(np.load(root / f"out.{r}.npz")) for r in range(len(procs))]


def _gang(name, tmp_path_factory):
    """Each mesh's gang, run once for the module: the first call starts
    the first ``GANGS_AT_ONCE`` and each finished one starts the next, so
    that gangs run while the JAX engine runs here."""
    order = sorted(MESHES)
    pending = _GANGS.setdefault("_pending", {})
    while name not in _GANGS:
        running = [n for n in order if n in pending]
        for n in order:
            if len(running) >= GANGS_AT_ONCE:
                break
            if n not in _GANGS and n not in pending:
                pending[n] = _start(n, tmp_path_factory.mktemp(n))
                running.append(n)
        first = name if name in pending else running[0]
        _GANGS[first] = _finish(pending.pop(first))
    return _GANGS[name]


@pytest.fixture(scope="module")
def weights():
    out = {}
    for config in CONFIGS:
        tree, jcfg = _weights(config)
        out[config] = (jax.tree.map(jnp.asarray, tree), jcfg)
    return out


_JAX_RUNS = {}


def _jax_tokens(weights, mesh_name, mode, spec_k):
    """The JAX mesh engine's tokens, its requests' preemptions and its
    data path."""
    key = (mesh_name, mode, spec_k)
    if key not in _JAX_RUNS:
        config, axes = MESHES[mesh_name]
        params, jcfg = weights[config]
        os.environ["DMLC_SERVE_PAGED_ATTN"] = mode
        os.environ["DMLC_SERVE_SPEC_K"] = str(spec_k)
        try:
            eng = JaxEngine(params, jcfg, mesh=jbuild_mesh(
                _world(axes), **_shape(axes)), **KW)
            reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
            eng.start()
            try:
                for r in reqs:
                    assert r.wait(120) and r.error is None, r.error
            finally:
                eng.close()
        finally:
            del os.environ["DMLC_SERVE_PAGED_ATTN"]
            del os.environ["DMLC_SERVE_SPEC_K"]
        _JAX_RUNS[key] = ([list(r.generated) for r in reqs],
                          sum(r.preemptions for r in reqs), eng._use_paged)
    return _JAX_RUNS[key]


# ---------------------------------------------------------------------------
# kv_partition_spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [{"pp": 2}, {"pp": 2, "tp": 2},
                                  {"pp": 2, "dp": 2}, {"sp": 2, "tp": 2},
                                  {"ep": 2}, {"dp": 2, "ep": 2},
                                  {"ep": 2, "tp": 2}, {"sp": 2},
                                  {"pp": 2, "sp": 2, "tp": 2}],
                         ids=lambda a: "x".join(f"{k}{v}" for k, v in
                                                a.items()))
def test_kv_partition_spec_equals_jax(axes):
    want = jkv_spec(jbuild_mesh(_world(axes), **_shape(axes)))
    got = tkv.kv_partition_spec(_stand_in(**axes))
    if want is None:
        assert got is None
    else:
        assert got == tuple((i, a) for i, a in enumerate(want)
                            if a is not None)


# ---------------------------------------------------------------------------
# the forwards
# ---------------------------------------------------------------------------

def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


_JAX_FORWARDS = {}


def _jax_forwards(weights, config):
    """The JAX one-device forwards on ``_inputs()``."""
    if config not in _JAX_FORWARDS:
        params, jcfg = weights[config]
        x = _inputs()

        def run(fn, *args):
            return jax.jit(lambda *a: fn(*a, jcfg))(
                params, *(jnp.asarray(a) for a in args))

        _JAX_FORWARDS[config] = {
            "prefill": run(jtfm.forward_prefill_last, x["pre_ids"],
                           x["pre_last"]),
            "decode": run(jtfm.forward_decode, x["ids"][:, 0],
                          x["positions"][:, 0], x["k"], x["v"],
                          x["lengths"]),
            "spec": run(jtfm.forward_decode_spec, x["ids"], x["positions"],
                        x["k"], x["v"], x["lengths"]),
            "paged": run(jtfm.forward_decode_paged, x["ids"],
                         x["p_positions"], x["k_pool"], x["v_pool"],
                         x["tables"], x["p_lengths"])[:3]}
    return _JAX_FORWARDS[config]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_forwards_equal_jax(weights, mesh_name, tmp_path_factory):
    config, axes = MESHES[mesh_name]
    want = _jax_forwards(weights, config)
    outs = _gang(mesh_name, tmp_path_factory)
    pl, kp, vp = want["paged"]
    shape = _shape(axes)
    for r, out in enumerate(outs):
        coords = dict(zip(MESH_AXES, np.unravel_index(
            r, [shape[a] for a in MESH_AXES])))

        def mine(a):   # the rank's stage's layers, its heads
            a = np.split(np.asarray(a), shape["pp"], axis=0)[coords["pp"]]
            return np.split(a, shape["tp"], axis=-2)[coords["tp"]]

        for name in ("prefill", "decode", "spec"):
            logits, k, v = want[name]
            _close(out[f"{name}.logits"], logits)
            _close(out[f"{name}.k"], mine(k))
            _close(out[f"{name}.v"], mine(v))
        _close(out["paged.logits"], pl)
        _close(out["paged.k_pool"], mine(kp))
        _close(out["paged.v_pool"], mine(vp))


def test_a_route_over_each_dp_share_alone_differs(weights):
    """The 11a fault, seen: the routed spec window routed over each dp
    rank's two rows alone (capacity still counted over the batch) keeps
    other choices and gives other logits than one program's route over
    the whole batch, which the dp gangs above equal."""
    params, jcfg = weights["routed"]
    tree, _ = _weights("routed")
    cfg = ttfm.TransformerConfig(**_dims("routed"), moe_debug_overflow=True)
    model = params_from_jax(tree, cfg, device="cpu")
    x = {k: torch.from_numpy(a) for k, a in _inputs().items()}
    want = np.asarray(_jax_forwards(weights, "routed")["spec"][0])

    def dropped():
        return telemetry.core.counter_value("moe", "overflow_fraction_sum")

    telemetry.reset()
    with torch.inference_mode():
        whole = ttfm.forward_decode_spec(model, x["ids"], x["positions"],
                                         x["k"], x["v"], x["lengths"])[0]
        whole_dropped = dropped()
        telemetry.reset()
        halves = [ttfm.forward_decode_spec(
            model, x["ids"][rows], x["positions"][rows], x["k"][:, rows],
            x["v"][:, rows], x["lengths"][rows],
            route_tokens=x["ids"].numel())[0]
            for rows in (slice(0, 2), slice(2, 4))]
    split = torch.cat(halves).numpy()
    _close(whole, want)
    # dropped choices: each call records its fraction of its n·k choices
    n_k = x["ids"].numel() * cfg.moe_topk
    assert whole_dropped > 0, "the routed config must drop choices"
    assert dropped() * n_k / 2 < whole_dropped * n_k
    assert np.abs(split - want).max() > 1e-3


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,spec_k", MODES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_engine_tokens_equal_jax_mesh_engine(weights, mesh_name, mode,
                                             spec_k, tmp_path_factory):
    toks, preempted, jax_paged = _jax_tokens(weights, mesh_name, mode,
                                             spec_k)
    outs = _gang(mesh_name, tmp_path_factory)
    name = f"{mode}.{spec_k}"
    ctl = outs[0]
    assert ctl[f"tok.{name}"].tolist() == toks
    assert bool(ctl[f"paged.{name}"]) == jax_paged
    prefills, preemptions, tokens = ctl[f"counters.{name}"].tolist()
    assert preemptions == preempted and preemptions > 0, \
        "the pool must force preemptions"
    assert prefills == len(PROMPTS) + preempted
    assert tokens == len(PROMPTS) * MAX_NEW
    config, axes = MESHES[mesh_name]
    for out in outs:
        # the pools hold the rank's stage's layers
        assert int(out[f"pool_layers.{name}"]) == \
            DIMS["n_layers"] // axes.get("pp", 1)
        if config == "routed":
            assert float(out[f"dropped.{name}"]) > 0, \
                "the routed config must drop choices"


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_close_ends_every_follower(mesh_name, tmp_path_factory):
    """_finish fails unless every rank exits 0; each follower, the other
    pp stage's among them, returned from follow() once per engine the
    controller closed."""
    outs = _gang(mesh_name, tmp_path_factory)
    for out in outs[1:]:
        assert all(int(out[f"followed.{m}.{k}"]) == 1 for m, k in MODES)


# ---------------------------------------------------------------------------
# what still raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,axes,what", [
    ({"n_heads": 3}, {"tp": 2}, "n_heads=3"),
    ({"n_experts": 3}, {"ep": 2}, "n_experts=3"),
    ({"n_layers": 3}, {"pp": 2}, "n_layers=3")],
    ids=["heads_tp", "experts_ep", "layers_pp"])
def test_what_does_not_divide_its_axis_raises(dims, axes, what):
    cfg = ttfm.TransformerConfig(**{**DIMS, "n_experts": 2, **dims})
    mesh = _stand_in(**axes)
    with pytest.raises(DMLCError, match=what):
        ttfm.check_serving_mesh(cfg, mesh)
    with pytest.raises(DMLCError, match=what):
        ttfm.Transformer(cfg, device="cpu", mesh=mesh)
    if "n_experts" not in dims:
        with pytest.raises(DMLCError, match=what):
            tkv.PagedKVCache(cfg.n_layers, cfg.n_heads, cfg.head_dim,
                             device="cpu", mesh=mesh)


def test_sp_in_the_serving_axes_raises():
    cfg = ttfm.TransformerConfig(**DIMS)
    mesh = _stand_in(sp=2)
    model = ttfm.Transformer(cfg, device="cpu", mesh=mesh)
    assert ttfm.serving_axes(mesh) == ttfm.ShardAxes()
    with pytest.raises(DMLCError, match="replicated over sp"):
        ttfm.forward_prefill_last(model, torch.zeros((1, 4)).long(),
                                  torch.tensor([3]),
                                  axes=ttfm.SHARDED_AXES, mesh=mesh)


# ---------------------------------------------------------------------------
# the chip smoke's phase, on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_shard_serve_wide_phase_on_the_cpu(tmp_path):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    run = dict(model="tiny", device="cpu", dir=str(tmp_path / "job"),
               log_dir=str(tmp_path / "logs"), prompt_lens=[17, 100, 300, 511],
               max_tokens=8)
    t0 = time.monotonic()
    # the smoke's path: shard_serve's workers serve these gangs after theirs
    serve_line, serve_launches, docs = chip_smoke.shard_serve_phase(
        "cpu", None, run, wide=True)
    assert serve_line["f32"]["tokens_equal"] is True
    line, launches = chip_smoke.shard_serve_wide_phase("cpu", None, docs,
                                                       run)
    assert launches == serve_launches == {"flash_fwd": 0,
                                          "paged_attention": 0}
    assert line["workers"] == 4 and line["ranks_done"] == 4
    r, p = line["gangs"]["R"], line["gangs"]["P"]
    assert r["mesh"] == {"dp": 2, "ep": 2} and r["routed"]
    assert r["experts_per_rank"] == 4 and r["layers_per_rank"] == 4
    assert p["mesh"] == {"pp": 2, "tp": 2} and not p["routed"]
    assert p["layers_per_rank"] == 2 and p["heads_per_rank"] == 2
    for gang in (r, p):
        assert gang["f32"]["tokens_equal"] is True
        assert gang["f32"]["prefill_logits_rel"] <= 1e-4
        assert all(x <= 1e-4
                   for x in gang["f32"]["decode_logits_rel"].values())
        for name in ("gather", "paged"):
            doc = gang["runs"][name]
            assert doc["requests_200"] == doc["requests"]
            assert doc["paged"] is (name == "paged")
            assert doc["tokens_per_s"] > 0
    drop = r["f32"]["dropped_fraction"]
    assert drop["paged"] == drop["one_card"]
    # the pp stage's handoff and the logits broadcast over pp on rank 0's
    # direct decode step; the routed choices gathered over dp
    step = p["decode_step_rank0"]["paged"]["collectives"]
    assert step["ppermute"]["calls"] == 1 and step["broadcast"]["calls"] == 1
    gather = r["decode_step_rank0"]["gather"]["collectives"]
    assert gather["all_gather"]["calls"] >= r["n_layers"]
    assert not (tmp_path / "job").exists()
    assert time.monotonic() - t0 < 300
