"""Port parity: sharded serving, the engine on a dp × tp mesh over
``torch.distributed``, against dmlc_tpu's engine on a mesh, on the CPU.

The port's side runs as gangs of gloo processes (tests/test_torch_parallel.py
``run_gang``) on dp2 × tp2, dp1 × tp2 and dp2 × tp1, each rank holding the
shards ``shard_params_from_jax`` slices from one JAX tree; the JAX side is
``InferenceEngine(params, cfg, mesh=build_mesh(...))`` on the 8 host
devices of tests/conftest.py.  The config is the tiny one of
tests/test_torch_sharded_model.py with one expert (dense), float32, its
weights perturbed by 0.2 so that greedy tokens vary.

* ``kv_partition_spec`` equal to the reference's on five meshes;
* the sharded ``forward_prefill_last``, ``forward_decode``,
  ``forward_decode_spec`` and ``forward_decode_paged`` against the JAX
  one-device forwards: logits within 1e-5, each rank's new K/V (and the
  paged pools) within 1e-5 of its slice of the JAX heads;
* the engine token for token against the JAX mesh engine under ``auto``,
  ``on`` and ``off`` at spec_k 0 and 3, through a pool small enough to
  force preemptions, the controller's prefill / preemption / token
  counters equal to the JAX requests'; ``max_active`` 4 splits the
  gathered view over dp, ``max_active`` 3 runs it whole on each dp rank
  (the reference's fallback) with equal tokens;
* what still raises: a model built for another mesh, heads or experts
  that do not divide their axis, sp named in the serving axes (a routed
  config and meshes with pp, sp or ep > 1 serve:
  tests/test_torch_shard_serve_mesh.py);
* ``close()`` ends every follower (every rank exits 0); a follower killed
  mid-run fails the controller's pending request within a bounded time;
* rank 0's HTTP server over the sharded engine answers the engine's
  tokens;
* ``chip_smoke.shard_serve_phase`` end to end on the CPU with the tiny
  model.

Every test runs under its own SIGALRM limit (``LIMIT_S``)."""

import json
import os
import signal
import subprocess
import sys
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
from dmlc_tpu_torch.base import DMLCError
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.parallel.mesh import MESH_AXES, Mesh
from dmlc_tpu_torch.serving import InferenceEngine, kv_cache as tkv

from tests.test_torch_parallel import PKG, REPO, free_port, run_gang

DIMS = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, d_ff=32,
            n_layers=2, n_experts=1)
MESHES = {"dp2_tp2": {"dp": 2, "tp": 2}, "dp1_tp2": {"dp": 1, "tp": 2},
          "dp2_tp1": {"dp": 2, "tp": 1}}
MODES = [(m, k) for m in ("auto", "on", "off") for k in (0, 3)]
PROMPTS = [[3, 9, 27, 17, 3, 9, 27], [5, 1, 5, 1, 5], [2, 2, 7, 2, 2],
           [11, 4, 11, 4, 11, 4]]
MAX_NEW = 12
#: a pool of 14 blocks of 4 tokens: the four requests start together,
#: so both dp ranks decode live rows, and cannot finish together
KW = dict(n_blocks=14, block_size=4, max_active=4, queue_depth=8)
TOL = 1e-5

LIMIT_S = {"test_engine_tokens_equal_jax_mesh_engine": 120,
           "test_sharded_forwards_equal_jax": 120,
           "test_killed_follower_fails_the_pending_request": 120,
           "test_chip_smoke_shard_serve_phase_on_the_cpu": 240}
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


def _weights():
    """The JAX tree (numpy leaves, one stage), perturbed to O(0.2)."""
    jcfg = jtfm.TransformerConfig(**DIMS, microbatches=1)
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


def _world(shape):
    return int(np.prod(list(shape.values())))


def _jax_mesh(shape):
    return jbuild_mesh(_world(shape), pp=1, sp=1, ep=1, **shape)


def _stand_in(rank=0, **axes):
    """Rank ``rank`` of a mesh of ``axes`` without process groups (for
    what reads only the mesh's shape and coordinates)."""
    shape = {a: axes.get(a, 1) for a in MESH_AXES}
    coords = np.unravel_index(rank, [shape[a] for a in MESH_AXES])
    return Mesh(shape=shape, coords={a: int(c) for a, c in
                                     zip(MESH_AXES, coords)},
                rank=rank, device=torch.device("cpu"), groups={})


# ---------------------------------------------------------------------------
# the forwards' inputs (global: every head, every row)
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
import dataclasses
import urllib.request
from {pkg} import serving
from {pkg}.models import transformer as tfm
from {pkg}.models.convert import shard_params_from_jax
from {pkg}.serving import kv_cache
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
ax = tfm.SERVING_AXES

def heads(x):   # this rank's heads of [..., H, D]
    return x.chunk(tp, dim=-2)[ti].contiguous()

# 1. the forwards
with torch.inference_mode():
    lg, k, v = tfm.forward_prefill_last(model, T["pre_ids"], T["pre_last"],
                                        axes=ax, mesh=mesh)
    OUT.update({{"prefill.logits": lg, "prefill.k": k, "prefill.v": v}})
    rows = slice(di * T["k"].shape[1] // dp, (di + 1) * T["k"].shape[1] // dp)
    kc, vc = heads(T["k"])[:, rows], heads(T["v"])[:, rows]
    lg, k, v = tfm.forward_decode(model, T["ids"][:, 0],
                                  T["positions"][:, 0], kc, vc,
                                  T["lengths"], axes=ax, mesh=mesh)
    OUT.update({{"decode.logits": lg, "decode.k": k, "decode.v": v}})
    lg, k, v = tfm.forward_decode_spec(model, T["ids"], T["positions"], kc,
                                       vc, T["lengths"], axes=ax, mesh=mesh)
    OUT.update({{"spec.logits": lg, "spec.k": k, "spec.v": v}})
    kp, vp = heads(T["k_pool"]), heads(T["v_pool"])
    lg = tfm.forward_decode_paged(model, T["ids"], T["p_positions"], kp, vp,
                                  T["tables"], T["p_lengths"], axes=ax,
                                  mesh=mesh)
    OUT.update({{"paged.logits": lg, "paged.k_pool": kp, "paged.v_pool": vp}})

# 2. the engine: the controller serves, the followers follow
PROMPTS = json.loads({prompts!r})
KW = json.loads({kw!r})
seen_rows = []

def engine(max_active=KW["max_active"], spec_k=0, **_):
    eng = serving.InferenceEngine(model, mesh=mesh, device="cpu",
                                  spec_k=spec_k,
                                  **dict(KW, max_active=max_active))
    real = eng.cache.shard_gathered
    def shard(k, v):
        got = real(k, v)
        seen_rows.append(got[0].shape[1])
        return got
    eng.cache.shard_gathered = shard
    return eng

def run(name, mode, http=False, **kw):
    os.environ["DMLC_SERVE_PAGED_ATTN"] = mode
    eng = engine(**kw)
    seen_rows.clear()
    if mesh.rank != 0:
        eng.follow()
        OUT["followed." + name] = np.array(1)
    else:
        eng.start()
        srv = serving.ServingHTTPServer(eng) if http else None
        try:
            if http:
                toks = []
                for p in PROMPTS:
                    body = json.dumps({{"prompt": p, "max_tokens": {max_new}}})
                    req = urllib.request.Request(
                        srv.url + "/generate", data=body.encode(),
                        headers={{"Content-Type": "application/json"}})
                    with urllib.request.urlopen(req, timeout=120) as r:
                        toks.append(json.loads(r.read())["output_ids"])
            else:
                reqs = [eng.submit(p, max_new_tokens={max_new})
                        for p in PROMPTS]
                for r in reqs:
                    assert r.wait(120), r.id
                    assert r.error is None, r.error
                toks = [list(r.generated) for r in reqs]
        finally:
            if srv is not None:
                srv.close()
            eng.close()
        c = eng.counters
        OUT["tok." + name] = np.array(toks)
        OUT["counters." + name] = np.array(
            [c["prefills"], c["preemptions"], c["tokens_generated"]])
        OUT["paged." + name] = np.array(eng._use_paged)
    OUT["rows." + name] = np.array(max(seen_rows or [0]))

for mode, spec in json.loads({modes!r}):
    run(f"{{mode}}.{{spec}}", mode, spec_k=spec)
run("off.0.max3", "off", max_active=3)
run("http", "auto", http=True)
"""


_GANGS = {}


def _gang(name, tmp_path_factory):
    """Each mesh's gang, run once for the module."""
    if name not in _GANGS:
        tree, _ = _weights()
        inputs = {"w." + k: v for k, v in _flat(tree).items()}
        inputs.update(_inputs())
        body = _BODY.format(pkg=PKG, dims=json.dumps(DIMS),
                            prompts=json.dumps(PROMPTS), kw=json.dumps(KW),
                            modes=json.dumps(MODES), max_new=MAX_NEW)
        _GANGS[name] = run_gang(tmp_path_factory.mktemp(name),
                                _world(MESHES[name]), MESHES[name], body,
                                inputs, timeout=110)
    return _GANGS[name]


@pytest.fixture(scope="module")
def weights():
    tree, jcfg = _weights()
    return jax.tree.map(jnp.asarray, tree), jcfg


_JAX_RUNS = {}


def _jax_tokens(weights, mesh_name, mode, spec_k, max_active=KW["max_active"]):
    """The JAX mesh engine's tokens and its requests' preemptions."""
    key = (mesh_name, mode, spec_k, max_active)
    if key not in _JAX_RUNS:
        params, jcfg = weights
        os.environ["DMLC_SERVE_PAGED_ATTN"] = mode
        os.environ["DMLC_SERVE_SPEC_K"] = str(spec_k)
        try:
            eng = JaxEngine(params, jcfg, mesh=_jax_mesh(MESHES[mesh_name]),
                            **dict(KW, max_active=max_active))
            eng.start()
            try:
                reqs = [eng.submit(p, max_new_tokens=MAX_NEW)
                        for p in PROMPTS]
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

@pytest.mark.parametrize("axes", [{}, {"dp": 2}, {"tp": 2},
                                  {"dp": 2, "tp": 2}, {"dp": 4, "tp": 2}],
                         ids=lambda a: "x".join(f"{k}{v}" for k, v in
                                                a.items()) or "one")
def test_kv_partition_spec_equals_jax(axes):
    world = int(np.prod(list(axes.values()) or [1]))
    want = jkv_spec(jbuild_mesh(world, pp=1, sp=1, ep=1,
                                dp=axes.get("dp", 1), tp=axes.get("tp", 1)))
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


@pytest.fixture(scope="module")
def jax_forwards(weights):
    """The JAX one-device forwards on ``_inputs()``."""
    params, jcfg = weights
    x = _inputs()

    def run(fn, *args):
        return jax.jit(lambda *a: fn(*a, jcfg))(
            params, *(jnp.asarray(a) for a in args))

    return {
        "prefill": run(jtfm.forward_prefill_last, x["pre_ids"],
                       x["pre_last"]),
        "decode": run(jtfm.forward_decode, x["ids"][:, 0],
                      x["positions"][:, 0], x["k"], x["v"], x["lengths"]),
        "spec": run(jtfm.forward_decode_spec, x["ids"], x["positions"],
                    x["k"], x["v"], x["lengths"]),
        "paged": run(jtfm.forward_decode_paged, x["ids"], x["p_positions"],
                     x["k_pool"], x["v_pool"], x["tables"],
                     x["p_lengths"])[:3]}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_forwards_equal_jax(jax_forwards, mesh_name,
                                    tmp_path_factory):
    outs = _gang(mesh_name, tmp_path_factory)
    want = jax_forwards
    pl, kp, vp = want["paged"]
    tp = MESHES[mesh_name]["tp"]
    for r, out in enumerate(outs):
        ti = r % tp   # tp is the innermost axis

        def heads(a):
            return np.split(np.asarray(a), tp, axis=-2)[ti]

        for name in ("prefill", "decode", "spec"):
            logits, k, v = want[name]
            _close(out[f"{name}.logits"], logits)
            _close(out[f"{name}.k"], heads(k))
            _close(out[f"{name}.v"], heads(v))
        _close(out["paged.logits"], pl)
        _close(out["paged.k_pool"], heads(kp))
        _close(out["paged.v_pool"], heads(vp))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,spec_k", MODES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_engine_tokens_equal_jax_mesh_engine(weights, mesh_name, mode,
                                             spec_k, tmp_path_factory):
    outs = _gang(mesh_name, tmp_path_factory)
    toks, preempted, jax_paged = _jax_tokens(weights, mesh_name, mode,
                                             spec_k)
    name = f"{mode}.{spec_k}"
    ctl = outs[0]
    assert ctl[f"tok.{name}"].tolist() == toks
    assert bool(ctl[f"paged.{name}"]) == jax_paged
    prefills, preemptions, tokens = ctl[f"counters.{name}"].tolist()
    assert preemptions == preempted and preemptions > 0, \
        "the pool must force preemptions"
    assert prefills == len(PROMPTS) + preempted
    assert tokens == len(PROMPTS) * MAX_NEW
    # the gather path splits the view over dp (max_active 4 divides it)
    dp = MESHES[mesh_name]["dp"]
    want_rows = 0 if jax_paged else KW["max_active"] // dp
    assert all(int(o[f"rows.{name}"]) == want_rows for o in outs)


def test_batch_that_does_not_divide_dp_runs_whole(weights,
                                                  tmp_path_factory):
    outs = _gang("dp2_tp2", tmp_path_factory)
    toks, _, _ = _jax_tokens(weights, "dp2_tp2", "off", 0, max_active=3)
    assert outs[0]["tok.off.0.max3"].tolist() == toks
    assert all(int(o["rows.off.0.max3"]) == 3 for o in outs)
    assert int(outs[0]["rows.off.0"]) == 2


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_close_ends_every_follower(mesh_name, tmp_path_factory):
    """run_gang fails unless every rank exits 0; each follower returned
    from follow() once per engine the controller closed."""
    outs = _gang(mesh_name, tmp_path_factory)
    runs = [f"{m}.{k}" for m, k in MODES] + ["off.0.max3", "http"]
    for out in outs[1:]:
        assert all(int(out[f"followed.{n}"]) == 1 for n in runs)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_http_server_over_the_sharded_engine(weights, mesh_name,
                                             tmp_path_factory):
    outs = _gang(mesh_name, tmp_path_factory)
    toks, _, _ = _jax_tokens(weights, mesh_name, "auto", 0)
    assert outs[0]["tok.http"].tolist() == toks
    assert outs[0]["tok.http"].tolist() == outs[0]["tok.auto.0"].tolist()


# ---------------------------------------------------------------------------
# what sharded serving still refuses
# ---------------------------------------------------------------------------

def test_raises_routed_wide_mesh_and_foreign_model():
    """A routed config and meshes with pp, sp or ep > 1 serve now (the
    name is kept); what raises is what the reference refuses too: a
    model that does not split over the mesh, the serving forwards asked
    to shard over sp, and a model built for another mesh."""
    cfg = ttfm.TransformerConfig(**DIMS)
    dp2 = _stand_in(dp=2)
    model = ttfm.Transformer(cfg, device="cpu", mesh=dp2)
    routed = ttfm.TransformerConfig(**dict(DIMS, n_experts=4), moe_topk=2)
    for wide in ({"sp": 2}, {"pp": 2}, {"ep": 2, "tp": 2}, {"dp": 2}):
        ttfm.check_serving_mesh(routed, _stand_in(**wide))
    for dims, wide, what in (({"n_heads": 3}, {"tp": 2}, "n_heads=3"),
                             ({"n_experts": 3}, {"ep": 2}, "n_experts=3"),
                             ({"n_layers": 3}, {"pp": 2}, "n_layers=3")):
        bad = ttfm.TransformerConfig(**{**DIMS, **dims})
        with pytest.raises(DMLCError, match=what):
            ttfm.check_serving_mesh(bad, _stand_in(**wide))
    with pytest.raises(DMLCError, match="replicated over sp"):
        ttfm.forward_decode(model, torch.zeros(2).long(),
                            torch.zeros(2).long(), torch.zeros(1),
                            torch.zeros(1), torch.zeros(2).int(),
                            axes=ttfm.SHARDED_AXES, mesh=dp2)
    for other in (None, _stand_in(dp=2)):
        with pytest.raises(DMLCError, match="not built for this mesh"):
            InferenceEngine(model, mesh=other, device="cpu")


# ---------------------------------------------------------------------------
# a follower dies
# ---------------------------------------------------------------------------

_KILLED = """
import json, os, signal, sys, time
import torch
torch.set_num_threads(1)
from {pkg} import serving
from {pkg}.models import transformer as tfm
from {pkg}.parallel import build_mesh, initialize_distributed
rank = int(os.environ["DMLC_TASK_ID"])
initialize_distributed(timeout_s=60)
mesh = build_mesh(dp=2, tp=2, device="cpu")
cfg = tfm.TransformerConfig(**json.loads({dims!r}))
torch.manual_seed(0)
model = tfm.Transformer(cfg, device="cpu", mesh=mesh)
with torch.no_grad():
    for p in model.parameters():
        p.normal_(0, 0.2)
os.environ["DMLC_SERVE_PAGED_ATTN"] = "off"
eng = serving.InferenceEngine(model, mesh=mesh, device="cpu", n_blocks=64,
                              block_size=4, max_active=4)
if rank == 0:
    eng.start()
    t0 = time.monotonic()
    req = eng.submit([1, 2, 3], max_new_tokens=200)
    done = req.wait(90)
    print(json.dumps({{"done": done, "error": req.error,
                       "seconds": time.monotonic() - t0,
                       "generated": req.n_generated}}), flush=True)
    eng.close()
    sys.exit(0)
real, plans = eng._exec, []
def exec_(plan):
    plans.append(plan)
    if rank == 3 and len(plans) == 12:   # mid-run: prefill and 5 decodes
        os.kill(os.getpid(), signal.SIGKILL)
    return real(plan)
eng._exec = exec_
eng.follow()
"""


def test_killed_follower_fails_the_pending_request(tmp_path):
    script = tmp_path / "killed.py"
    script.write_text(_KILLED.format(pkg=PKG, dims=json.dumps(DIMS)))
    env = dict(os.environ, OMP_NUM_THREADS="1", DMLC_NUM_WORKER="4",
               DMLC_JAX_COORD_URI="127.0.0.1",
               DMLC_JAX_COORD_PORT=str(free_port()),
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(script)], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(env, DMLC_TASK_ID=str(r))) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=100)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert codes[0] == 0 and codes[3] == -signal.SIGKILL, (codes, outs)
    # the others saw their connections close and raised
    assert codes[1] != 0 and codes[2] != 0, (codes, outs)
    doc = json.loads(outs[0].strip().splitlines()[-1])
    assert doc["done"] and "gang failed" in doc["error"], doc
    assert 0 < doc["generated"] < 200
    assert doc["seconds"] < 30, doc


# ---------------------------------------------------------------------------
# the chip smoke's phase, on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_shard_serve_phase_on_the_cpu(tmp_path):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    run = dict(model="tiny", device="cpu", dir=str(tmp_path / "job"),
               log_dir=str(tmp_path / "logs"), prompt_lens=[17, 100, 300, 511],
               max_tokens=8)
    t0 = time.monotonic()
    line, launches = chip_smoke.shard_serve_phase("cpu", None, run)
    assert launches == {"flash_fwd": 0, "paged_attention": 0}
    assert line["mesh"] == {"dp": 2, "tp": 2} and line["workers"] == 4
    assert line["f32"]["tokens_equal"] is True
    assert line["f32"]["prefill_logits_rel"] <= 1e-4
    assert all(r <= 1e-4 for r in line["f32"]["decode_logits_rel"].values())
    for run_name in ("gather", "gather_spec", "paged"):
        doc = line["runs"][run_name]
        assert doc["requests_200"] == doc["requests"]
        assert doc["tokens_per_s"] > 0
    assert line["ranks_done"] == 4
    assert not (tmp_path / "job").exists()
    assert time.monotonic() - t0 < 200
