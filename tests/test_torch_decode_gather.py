"""Port parity: the gather decode path (``DMLC_SERVE_PAGED_ATTN=off``).

The same numpy weights (through ``params_from_jax``) and inputs go
through ``dmlc_tpu`` and the port, in float32 on the CPU:

* ``forward_decode`` and ``forward_decode_spec`` against the reference's:
  logits and the new K/V within 1e-5 (absolute and relative), on a
  gathered cache holding garbage past each row's length and a dead row
  (length 0), dense and routed top-2; ``forward_decode_spec`` at S=1
  bit-equal to ``forward_decode``;
* ``PagedKVCache.gather`` against the reference's: equal on every live
  slot, dead rows zero with length 0, the same ``pad_len`` errors;
  ``shard_gathered`` without a mesh returns its input, on a dp2 mesh
  this rank's rows (the input where the batch does not divide dp), and
  a cache on a mesh with sp > 1 raises;
* ``decode_phase_flops`` equal to the reference's, and summing to
  ``decode_flops_per_token``;
* the engine under ``off``: greedy tokens equal to the JAX engine's
  under ``off`` at spec_k 0 and 3 through forced preemption, dense and
  routed, and equal to the port's own ``on``; the gather and sampling
  phases measured, every decode record with ``membw_util`` and
  ``bound``; a bad knob value raises ``ValueError`` as the reference's
  does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu.serving import InferenceEngine as JaxEngine
from dmlc_tpu.serving.kv_cache import PagedKVCache as JaxCache
from dmlc_tpu_torch import telemetry
from dmlc_tpu_torch.base import DMLCError
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.models.convert import params_from_jax
from dmlc_tpu_torch.parallel.mesh import MESH_AXES, Mesh
from dmlc_tpu_torch.serving import InferenceEngine, PagedKVCache

DIMS = dict(vocab=64, d_model=32, n_heads=2, head_dim=8, d_ff=48,
            n_layers=2)
CONFIGS = {"dense": dict(n_experts=1),
           "routed": dict(n_experts=4, moe_topk=2, moe_capacity_factor=1.25)}
TOL = 1e-5


def _weights(kind, scale=0.2):
    """The reference's tree (perturbed so every weight moves the logits),
    its config, and the port's model on the CPU."""
    cfg = dict(DIMS, **CONFIGS[kind])
    jcfg = jtfm.TransformerConfig(**cfg, microbatches=1)
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    rng = np.random.default_rng(7)
    tree = jax.tree.map(
        lambda a: ((a + rng.standard_normal(a.shape) * scale).astype(a.dtype)
                   if a.ndim > 2 else a), tree)
    model = params_from_jax(tree, ttfm.TransformerConfig(**cfg), device="cpu")
    return tree, jcfg, model


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def weights(request):
    return _weights(request.param)


def _cache_inputs(seed, b=4, s_w=1, tc=16):
    """A gathered cache with garbage (large values) past each length and a
    dead row; positions at each row's length."""
    rng = np.random.default_rng(seed)
    shape = (DIMS["n_layers"], b, tc, DIMS["n_heads"], DIMS["head_dim"])
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    lengths = np.array([5, 0, tc, 9][:b], np.int32)
    for i, n in enumerate(lengths):
        k[:, i, n:] = 1e3
        v[:, i, n:] = -1e3
    ids = rng.integers(0, DIMS["vocab"], size=(b, s_w)).astype(np.int32)
    positions = (lengths[:, None] + np.arange(s_w)).astype(np.int32)
    return ids, positions, k, v, lengths


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_forward_decode_equals_jax(weights):
    tree, jcfg, model = weights
    ids, pos, k, v, lengths = _cache_inputs(1)
    want = jtfm.forward_decode(jax.tree.map(jnp.asarray, tree), ids[:, 0],
                               pos[:, 0], k, v, lengths, jcfg)
    ti, tp, tk, tv, tl = _t(ids, pos, k, v, lengths)
    with torch.inference_mode():
        got = ttfm.forward_decode(model, ti[:, 0].long(), tp[:, 0].long(), tk,
                                  tv, tl)
    assert got[0].shape == (4, DIMS["vocab"])
    assert got[1].shape == (DIMS["n_layers"], 4, DIMS["n_heads"],
                            DIMS["head_dim"])
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("s_w", [1, 4])
def test_forward_decode_spec_equals_jax(weights, s_w):
    tree, jcfg, model = weights
    ids, pos, k, v, lengths = _cache_inputs(2, s_w=s_w)
    want = jtfm.forward_decode_spec(jax.tree.map(jnp.asarray, tree), ids,
                                    pos, k, v, lengths, jcfg)
    ti, tp, tk, tv, tl = _t(ids, pos, k, v, lengths)
    with torch.inference_mode():
        got = ttfm.forward_decode_spec(model, ti.long(), tp.long(), tk, tv,
                                       tl)
    assert got[0].shape == (4, s_w, DIMS["vocab"])
    for g, w in zip(got, want):
        _close(g, w)


def test_spec_at_one_position_is_forward_decode_exactly(weights):
    _, _, model = weights
    ids, pos, k, v, lengths = _t(*_cache_inputs(3))
    with torch.inference_mode():
        one = ttfm.forward_decode(model, ids[:, 0].long(), pos[:, 0].long(),
                                  k, v, lengths)
        spec = ttfm.forward_decode_spec(model, ids.long(), pos.long(), k, v,
                                        lengths)
    assert torch.equal(one[0], spec[0][:, 0])
    assert torch.equal(one[1], spec[1][:, :, 0])
    assert torch.equal(one[2], spec[2][:, :, 0])


def test_decode_phase_flops_equal_jax_and_sum_to_decode_flops():
    for kind in sorted(CONFIGS):
        cfg = dict(DIMS, **CONFIGS[kind])
        jcfg = jtfm.TransformerConfig(**cfg)
        tcfg = ttfm.TransformerConfig(**cfg)
        for ctx in (1, 40, 543):
            got = ttfm.decode_phase_flops(tcfg, ctx)
            assert got == jtfm.decode_phase_flops(jcfg, ctx)
            assert sum(got.values()) == ttfm.decode_flops_per_token(tcfg, ctx)
    flag = ttfm.flagship_config()
    assert ttfm.decode_phase_flops(flag, 512) == jtfm.decode_phase_flops(
        jtfm.flagship_config(), 512)


# ---------------------------------------------------------------------------
# the gather view
# ---------------------------------------------------------------------------

BS = 4


def _caches(lens, seed=4):
    """The reference's cache and the port's with the same sequences
    written (ids 10, 11, ...), each of ``lens`` tokens."""
    shape = (DIMS["n_layers"], DIMS["n_heads"], DIMS["head_dim"])
    jc = JaxCache(*shape, n_blocks=16, block_size=BS)
    tc = PagedKVCache(*shape, n_blocks=16, block_size=BS, device="cpu")
    rng = np.random.default_rng(seed)
    for i, n in enumerate(lens):
        k = rng.standard_normal((DIMS["n_layers"], n, *shape[1:])
                                ).astype(np.float32)
        v = rng.standard_normal(k.shape).astype(np.float32)
        for c in (jc, tc):
            assert c.allocate(10 + i, n)
        jc.write(10 + i, k, v, start=0)
        tc.write(10 + i, *_t(k, v), start=0)
    return jc, tc


@pytest.mark.parametrize("pad", [{}, {"pad_len": 16, "pad_batch": 5}])
def test_gather_equals_jax_on_live_slots(pad):
    lens = [3, 9, 4]
    jc, tc = _caches(lens)
    # a freed and reused block holds stale data past a new row's length
    tc.free(11)
    jc.free(11)
    for c in (jc, tc):
        assert c.allocate(11, 2)
    jc.write(11, np.ones((DIMS["n_layers"], 2, 2, 8), np.float32),
             np.ones((DIMS["n_layers"], 2, 2, 8), np.float32), start=0)
    tc.write(11, torch.ones(DIMS["n_layers"], 2, 2, 8),
             torch.ones(DIMS["n_layers"], 2, 2, 8), start=0)
    lens[1] = 2
    seqs = [10, 11, 12]
    jk, jv, jl = jc.gather(seqs, **pad)
    tk, tv, tl = tc.gather(seqs, **pad)
    assert tk.shape == jk.shape and tv.shape == jv.shape
    assert tl.dtype == torch.int32 and tk.device == tc.k_pool.device
    np.testing.assert_array_equal(tl.numpy(), jl)
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(tk[:, i, :n].numpy(), jk[:, i, :n])
        np.testing.assert_array_equal(tv[:, i, :n].numpy(), jv[:, i, :n])
    b = jk.shape[1]
    assert b == pad.get("pad_batch", 3)
    for i in range(3, b):   # dead rows
        assert not tk[:, i].any() and not tv[:, i].any() and tl[i] == 0
    t = pad.get("pad_len", 4)   # the longest row (4) in whole blocks
    assert tk.shape[2] == t


@pytest.mark.parametrize("pad_len,match", [(10, "not a multiple"),
                                           (8, "< required")])
def test_gather_pad_len_errors_equal_jax(pad_len, match):
    jc, tc = _caches([3, 9])
    for c in (jc, tc):
        with pytest.raises(ValueError, match=match):
            c.gather([10, 11], pad_len=pad_len)


def _mesh(rank=0, **axes):
    """A one-process stand-in for rank ``rank`` of a mesh of ``axes``
    (no process groups: ``shard_gathered`` only reads coordinates)."""
    shape = {a: axes.get(a, 1) for a in MESH_AXES}
    coords = dict(zip(MESH_AXES, np.unravel_index(
        rank, [shape[a] for a in MESH_AXES])))
    return Mesh(shape=shape, coords={a: int(c) for a, c in coords.items()},
                rank=rank, device=torch.device("cpu"), groups={})


def test_shard_gathered_is_identity_without_a_mesh_and_raises_with_one():
    _, tc = _caches([3, 5])
    k, v, _ = tc.gather([10, 11])
    got = tc.shard_gathered(k, v)
    assert got[0] is k and got[1] is v
    # on a dp2 mesh (the reference's batch-over-dp placement): the rows of
    # this rank's dp coordinate, and the whole view when B does not divide
    for rank in (0, 1):
        tc.mesh = _mesh(rank, dp=2)
        gk, gv = tc.shard_gathered(k, v)
        assert torch.equal(gk, k[:, rank:rank + 1])
        assert torch.equal(gv, v[:, rank:rank + 1])
        k3, v3, _ = tc.gather([10, 11], pad_batch=3)
        got = tc.shard_gathered(k3, v3)
        assert got[0] is k3 and got[1] is v3
    shape = (DIMS["n_layers"], DIMS["n_heads"], DIMS["head_dim"])
    # sp replicates the pools, as the reference places nothing over it; a
    # mesh that does not split the layers over pp raises
    rep = PagedKVCache(*shape, n_blocks=4, block_size=BS, device="cpu",
                       mesh=_mesh(sp=2))
    assert rep.k_pool.shape == (DIMS["n_layers"], 4, BS, DIMS["n_heads"],
                                DIMS["head_dim"])
    with pytest.raises(DMLCError, match="n_layers=2 does not split"):
        PagedKVCache(*shape, n_blocks=4, block_size=BS, device="cpu",
                     mesh=_mesh(pp=3))


# ---------------------------------------------------------------------------
# the engine under DMLC_SERVE_PAGED_ATTN=off
# ---------------------------------------------------------------------------

def _drive(engine, prompts, max_new):
    engine.start()
    try:
        reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
        for r in reqs:
            assert r.wait(300), f"request {r.id} never finished"
            assert r.error is None, r.error
            assert r.n_generated == max_new
        return [list(r.generated) for r in reqs]
    finally:
        engine.close()


PROMPTS = [[3, 9, 27, 17, 3, 9, 27], [5, 1, 5, 1, 5], [2, 2, 7, 2, 2]]
KW = dict(n_blocks=8, block_size=4, max_active=3, queue_depth=8)


@pytest.mark.parametrize("spec_k", [0, 3])
def test_engine_off_equals_jax_off_and_port_on(weights, monkeypatch, spec_k):
    tree, jcfg, model = weights
    monkeypatch.setenv("DMLC_SERVE_SPEC_K", str(spec_k))
    monkeypatch.setenv("DMLC_SERVE_SPEC_MIN_CTX", "4")
    monkeypatch.setenv("DMLC_SERVE_PAGED_ATTN", "off")
    want = _drive(JaxEngine(jax.tree.map(jnp.asarray, tree), jcfg, **KW),
                  PROMPTS, 12)
    telemetry.reset()
    telemetry.reset_steps()
    telemetry.compute.reset_compute()
    eng = InferenceEngine(model, device="cpu", spec_k=spec_k, **KW)
    assert not eng._use_paged
    got = _drive(eng, PROMPTS, 12)
    assert got == want
    assert eng.counters["preemptions"] > 0, "pool must force preemption"
    if spec_k:
        assert eng.counters["spec_proposed"] > 0
    snap = telemetry.snapshot()
    assert snap["gauges"]["serving"]["paged_active"] == 0.0
    assert "paged_decode_steps" not in snap["counters"].get("serving", {})
    shares = telemetry.compute.phase_shares()
    assert shares["gather"] > 0 and shares["sampling"] > 0
    site = "serving.decode_spec" if spec_k else "serving.decode"
    st = telemetry.compute.sites()[site].stats()
    assert st["traces"] >= 1 and st["aot_fallbacks"] == 0
    recs = telemetry.ledger().records()
    assert recs and all(r["membw_util"] is not None and r["bound"]
                        for r in recs)
    monkeypatch.setenv("DMLC_SERVE_PAGED_ATTN", "on")
    assert _drive(InferenceEngine(model, device="cpu", spec_k=spec_k, **KW),
                  PROMPTS, 12) == got


@pytest.mark.parametrize("value", ["paged", "1", ""])
def test_bad_paged_attn_value_raises_as_jax(weights, monkeypatch, value):
    tree, jcfg, model = weights
    monkeypatch.setenv("DMLC_SERVE_PAGED_ATTN", value)
    with pytest.raises(ValueError, match="auto|on|off"):
        JaxEngine(jax.tree.map(jnp.asarray, tree), jcfg, **KW)
    with pytest.raises(ValueError, match="auto|on|off"):
        InferenceEngine(model, device="cpu", **KW)


@pytest.mark.parametrize("value,paged", [("auto", True), ("ON", True),
                                         ("Off", False)])
def test_paged_attn_values_pick_the_path(weights, monkeypatch, value, paged):
    _, _, model = weights
    monkeypatch.setenv("DMLC_SERVE_PAGED_ATTN", value)
    assert InferenceEngine(model, device="cpu", **KW)._use_paged is paged
