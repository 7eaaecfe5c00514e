"""Port parity: the compute ledger (``telemetry.compute``).

Each test is the port-side counterpart of one in
tests/test_compute_ledger.py (:51-306), on the port's
``profiled_site`` in place of ``profiled_jit``: hits, traces and
recompiles; a recompile's signature; static arguments; the signature
cap; the compile span; reregister; the counted cost (exact FLOPs and
bytes of a matmul); ``roofline`` with both verdicts and its None case;
the step ledger's ``membw_util`` and ``bound``; memory samples and the
host-RSS fallback; phase shares and ``phase_estimate`` ignoring garbage;
the status and report documents (the JAX package's keys); the storm;
the Prometheus families; ``DMLC_COMPUTE_PROFILE=0``.  ``roofline`` and
the phase shares are held to the JAX package's results on the same
inputs.  The cost pass is held to ``decode_flops_per_token`` on a small
CPU decode step (exactly, plus the gate products the formula leaves
out), sees the train step's backward, counts an indexed write by what it
touches, and never raises or changes a result.
"""

import json
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmlc_tpu import telemetry as jtel
from dmlc_tpu.telemetry import compute as jcompute
from dmlc_tpu_torch import telemetry
from dmlc_tpu_torch.base import DMLCError
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.telemetry import compute


@pytest.fixture(autouse=True)
def _clean_registry():
    for pkg, comp in ((telemetry, compute), (jtel, jcompute)):
        pkg.reset()
        pkg.reset_events()
        comp.reset_compute()
    yield
    for pkg, comp in ((telemetry, compute), (jtel, jcompute)):
        pkg.reset()
        pkg.reset_events()
        comp.reset_compute()


# ---------------------------------------------------------------------------
# site ledger: hit/trace counting + recompile attribution
# ---------------------------------------------------------------------------

def test_profiled_site_counts_hits_and_traces():
    ps = compute.profiled_site(lambda x: x * 2.0, site="t.basic")
    x = torch.arange(4, dtype=torch.float32)
    for _ in range(3):
        assert float(ps(x)[0]) == 0.0
    st = ps.stats()
    assert st["traces"] == 1 and st["hits"] == 2
    assert st["recompiles"] == 0 and st["signatures"] == 1
    assert compute.sites()["t.basic"] is ps
    assert compute.recompiles_total() == 0


def test_recompile_attributed_to_signature():
    ps = compute.profiled_site(lambda x: x + 1, site="t.attr")
    ps(torch.zeros(4))
    ps(torch.zeros(8))                       # new shape -> recompile
    ps(torch.zeros(8, dtype=torch.int32))    # new dtype -> recompile
    st = ps.stats()
    assert st["traces"] == 3 and st["recompiles"] == 2
    assert "8" in st["last_signature"] and "int32" in st["last_signature"]
    assert compute.recompiles_total() == 2


def test_static_args_split_signatures():
    def f(x, n):
        return x * n

    ps = compute.profiled_site(f, site="t.static", static_argnums=(1,))
    x = torch.ones(2)
    assert float(ps(x, 2)[0]) == 2.0
    assert float(ps(x, 3)[0]) == 3.0     # same tensor, new static value
    assert float(ps(x, 2)[0]) == 2.0     # hit on the first
    st = ps.stats()
    assert st["traces"] == 2 and st["hits"] == 1
    assert st["last_signature"] == "2:float32;static:3"   # the last trace


def test_unhashable_static_runs_uncounted_as_a_fallback():
    ps = compute.profiled_site(lambda x, n: x + len(n), site="t.unhash",
                               static_argnums=(1,))
    assert float(ps(torch.ones(2), [1, 2])[0]) == 3.0
    st = ps.stats()
    assert st["aot_fallbacks"] >= 1 and st["traces"] == 0


def test_keyword_arguments_pass_through_and_key_nothing():
    seen = []

    def f(x, accept=None):
        seen.append(accept)
        return x

    ps = compute.profiled_site(f, site="t.kw")
    ps(torch.ones(2), accept=1)
    ps(torch.ones(2), accept=2)
    assert seen == [1, 2]
    assert ps.stats()["traces"] == 1 and ps.stats()["hits"] == 1


def test_signature_cap_raises_dmlc_error():
    ps = compute.profiled_site(lambda x: x, site="t.cap", max_signatures=2)
    ps(torch.zeros(1))
    ps(torch.zeros(2))
    with pytest.raises(DMLCError, match="signature cap"):
        ps(torch.zeros(3))
    # the capped site still serves its existing signatures
    assert float(ps(torch.zeros(2))[0]) == 0.0


def test_compile_span_lands_on_the_span_ring():
    ps = compute.profiled_site(lambda x: x * x, site="t.span")
    ps(torch.ones(3))
    trace = json.loads(telemetry.to_chrome_trace_json())
    spans = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and e["name"] == "compile:t.span"]
    assert len(spans) == 1 and spans[0]["args"]["trace"] == 1


def test_reregister_survives_reset():
    ps = compute.profiled_site(lambda x: x, site="t.rereg")
    ps(torch.zeros(2))
    compute.reset_compute()
    assert compute.sites() == {}
    ps.reregister()   # what the engine's process-wide program cache does
    assert compute.sites()["t.rereg"] is ps
    assert ps.stats()["traces"] == 1  # ledger state rode along


def test_module_argument_keys_on_its_tensors():
    cfg = ttfm.TransformerConfig(vocab=32, d_model=16, n_heads=2,
                                 head_dim=8, d_ff=16, n_layers=1)
    gen = torch.Generator().manual_seed(0)
    a = ttfm.init_params(cfg, gen, device="cpu")
    b = ttfm.init_params(cfg, gen, device="cpu")
    wide = ttfm.init_params(cfg.__class__(**{**cfg.__dict__, "d_ff": 32}),
                            gen, device="cpu")
    ps = compute.profiled_site(lambda m, x: m.embed[x], site="t.module")
    ids = torch.zeros(3, dtype=torch.long)
    for m in (a, b, a, wide):
        ps(m, ids)
    st = ps.stats()   # a and b share a signature; the wider model does not
    assert st["traces"] == 2 and st["hits"] == 2
    assert "Transformer[" in st["last_signature"]


# ---------------------------------------------------------------------------
# counted cost + roofline verdicts
# ---------------------------------------------------------------------------

def test_cost_of_a_matmul_is_exact():
    ps = compute.profiled_site(lambda a, b: a @ b, site="t.cost")
    a = torch.ones(16, 16)
    ps(a, a)
    cost = ps.stats()["last_cost"]
    assert cost == {"flops": 2.0 * 16 ** 3,
                    "bytes_accessed": 3.0 * 16 * 16 * 4}
    # the reference's XLA figure for the same product is the same FLOPs
    pj = jcompute.profiled_jit(lambda a, b: a @ b, site="t.cost")
    pj(jnp.ones((16, 16)), jnp.ones((16, 16)))
    assert pj.stats()["last_cost"]["flops"] == cost["flops"]


def test_indexed_write_counts_what_it_touches_and_views_nothing():
    def f(pool, blk, vals):
        pool[blk] = vals
        return pool.view(-1)[:4].t()

    ps = compute.profiled_site(f, site="t.index")
    pool = torch.zeros(256, 64)
    blk = torch.tensor([3, 7])
    ps(pool, blk, torch.ones(2, 64))
    # indices + values read + values written; the 64 KB pool is not read
    assert ps.stats()["last_cost"] == {
        "flops": 0.0, "bytes_accessed": 2 * 8 + 2 * (2 * 64 * 4)}
    assert pool[3].sum() == 64 and pool[7].sum() == 64


def test_a_failed_cost_pass_never_raises_or_changes_the_result():
    @torch.library.custom_op("portcheck::twice", mutates_args=())
    def twice(x: torch.Tensor) -> torch.Tensor:
        return x * 2

    def bad(args, kwargs, out):
        raise RuntimeError("no formula")

    compute.register_flops("portcheck::twice", bad)
    ps = compute.profiled_site(lambda x: twice(x) + 1, site="t.fail")
    x = torch.arange(3.0)
    assert torch.equal(ps(x), x * 2 + 1)
    assert torch.equal(ps(x), x * 2 + 1)
    st = ps.stats()
    assert st["aot_fallbacks"] == 1 and st["last_cost"] is None
    assert st["traces"] == 1 and st["hits"] == 1
    assert compute.report()["aot_fallbacks_total"] == 1


def test_roofline_both_verdicts_equal_jax():
    cases = [(1e6, 1e4, 1.0, 1e7, 1e6), (1e3, 1e4, 1.0, 1e7, 1e6),
             (3.3e12, 7.1e9, 0.013, 989e12, 3.35e12)]
    for args in cases:
        assert compute.roofline(*args) == jcompute.roofline(*args)
    r = compute.roofline(flops=1e6, bytes_accessed=1e4, wall_s=1.0,
                         peak_flops=1e7, peak_bw=1e6)
    assert r["bound"] == "compute" and r["mfu"] == pytest.approx(0.1)
    r = compute.roofline(flops=1e3, bytes_accessed=1e4, wall_s=1.0,
                         peak_flops=1e7, peak_bw=1e6)
    assert r["bound"] == "memory"
    assert r["membw_util"] == pytest.approx(0.01)
    assert r["intensity"] == pytest.approx(0.1)


def test_roofline_degrades_to_none():
    for args in ((None, None, 1.0, None, None), (1e6, 1e4, 0.0, 1e7, 1e6)):
        r = compute.roofline(*args)
        assert r == jcompute.roofline(*args)
        assert r["bound"] is None and r["mfu"] is None


def test_step_ledger_carries_membw_and_bound(monkeypatch):
    monkeypatch.setenv("DMLC_PEAK_FLOPS", "1e9")
    monkeypatch.setenv("DMLC_PEAK_HBM_GBPS", "1")  # 1e9 B/s, balance=1
    telemetry.reset_steps()
    telemetry.step_begin()
    time.sleep(0.001)
    telemetry.step_end(tokens=128, flops=1e5, bytes_accessed=1e7)
    summ = telemetry.ledger().summary()
    assert summ["bound"] == "memory"       # intensity 0.01 < balance 1
    assert summ["membw_util"] is not None and summ["membw_util"] > 0
    roof = telemetry.ledger().roofline_summary()
    assert roof["bound"] == "memory"
    assert roof["peak_flops"] == pytest.approx(1e9)
    assert roof["peak_membw_bytes_per_s"] == pytest.approx(1e9)
    assert roof["intensity"] == pytest.approx(0.01)
    telemetry.reset_steps()


# ---------------------------------------------------------------------------
# memory accounting
# ---------------------------------------------------------------------------

def test_sample_hbm_reports_peak_and_gauges():
    doc = compute.sample_hbm()
    assert doc["source"] in ("device", "host_rss")
    assert doc["peak_bytes"] and doc["peak_bytes"] > 0
    snap = telemetry.export_json()
    assert snap["gauges"]["compute"]["hbm_peak_bytes"] > 0


def test_sample_hbm_host_rss_fallback(monkeypatch):
    # no card: the sample degrades to the host-RSS proxy, flagged as
    # such, never dark, with the reference's keys
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    doc = compute.sample_hbm(publish=False)
    assert doc["source"] == "host_rss" and not doc["available"]
    assert doc["peak_bytes"] and doc["peak_bytes"] > 0
    assert doc["limit_bytes"] and doc["limit_bytes"] > doc["peak_bytes"]
    assert doc["headroom_bytes"] is not None
    assert set(doc) == set(jcompute._host_rss())


def test_sample_hbm_device_doc_reads_each_card_total_once(monkeypatch):
    # a card's live and peak come from the allocator on every sample;
    # its total is one mem_get_info a card, as the driver call is slow
    gib = 1 << 30
    stats = {0: {"current": 3 * gib, "peak": 5 * gib},
             1: {"current": 1 * gib, "peak": 2 * gib}}
    totals = {0: 80 * gib, 1: 40 * gib}
    asked = []

    def mem_get_info(i):
        asked.append(i)
        return (0, totals[i])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card{i}")
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(
        torch.cuda, "memory_stats_as_nested_dict",
        lambda i: {"allocated_bytes": {"all": dict(stats[i])}})
    compute._card_total.cache_clear()
    try:
        docs = [compute.sample_hbm(publish=False) for _ in range(3)]
        stats[0]["current"] = 4 * gib
        last = compute.sample_hbm(publish=False)
    finally:
        compute._card_total.cache_clear()
    assert asked == [0, 1]
    assert docs[0] == docs[2]
    doc = docs[0]
    assert doc["source"] == "device" and doc["available"]
    assert [d["kind"] for d in doc["devices"]] == ["card0", "card1"]
    assert doc["live_bytes"] == 4 * gib and doc["peak_bytes"] == 5 * gib
    assert doc["limit_bytes"] == 120 * gib
    assert doc["headroom_bytes"] == 39 * gib
    assert last["live_bytes"] == 5 * gib
    assert last["devices"][0]["headroom_bytes"] == 76 * gib


# ---------------------------------------------------------------------------
# phase decomposition
# ---------------------------------------------------------------------------

def test_phase_shares_mix_measured_and_estimated():
    with compute.phase("gather"):
        time.sleep(0.002)
    compute.phase_estimate({"attention": 3.0, "mlp": 6.0,
                            "unembed": 1.0}, 0.010)
    shares = compute.phase_shares()
    assert set(shares) == set(compute.PHASES) == set(jcompute.PHASES)
    assert sum(shares.values()) == pytest.approx(1.0)
    assert shares["mlp"] > shares["attention"] > shares["unembed"]
    assert shares["gather"] > 0
    assert shares["sampling"] == 0.0


def test_phase_estimate_equals_jax_and_ignores_garbage():
    calls = [({"attention": 3.0, "mlp": 6.0, "unembed": 1.0}, 0.010),
             ({}, 1.0), ({"attention": 0.0}, 1.0), ({"attention": 1.0}, -1.0),
             ({"mlp": 2.0, "unembed": -5.0, "other": 9.0}, 0.004)]
    for shares, secs in calls:
        compute.phase_estimate(shares, secs)
        jcompute.phase_estimate(shares, secs)
    got, want = compute.phase_shares(), jcompute.phase_shares()
    assert set(got) == set(want)
    for name in got:
        assert got[name] == pytest.approx(want[name], rel=1e-12)


def test_phase_estimate_alone_ignores_garbage():
    compute.phase_estimate({}, 1.0)
    compute.phase_estimate({"attention": 0.0}, 1.0)
    compute.phase_estimate({"attention": 1.0}, -1.0)
    assert compute.phase_shares() == {}


def test_decode_phase_flops_sums_to_decode_flops():
    cfg = ttfm.TransformerConfig(vocab=64, d_model=32, n_heads=2,
                                 head_dim=8, d_ff=64, n_layers=2,
                                 n_experts=1, dtype="float32")
    shares = ttfm.decode_phase_flops(cfg, ctx=40)
    assert set(shares) == {"attention", "mlp", "unembed"}
    assert sum(shares.values()) == pytest.approx(
        ttfm.decode_flops_per_token(cfg, 40))


# ---------------------------------------------------------------------------
# the cost pass on the model
# ---------------------------------------------------------------------------

CFG = dict(vocab=64, d_model=32, n_heads=2, head_dim=8, d_ff=48, n_layers=2)


def _extra(cfg, x, b):
    """What ``decode_flops_per_token`` leaves out, at most: the gate and
    the experts' combine, 2·E·X each a token a layer (torch's einsum may
    run a one-expert combine as a product the counter does not count)."""
    return b * cfg.n_layers * 4 * cfg.d_model * x


def test_decode_step_flops_equal_decode_flops_per_token():
    """forward_decode of B rows at one cache depth Tc: the formula's
    FLOPs for a context of Tc + 1 per row, plus at most the gate and
    combine products it leaves out."""
    for x in (1, 3):
        cfg = ttfm.TransformerConfig(**CFG, n_experts=x)
        model = ttfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        b, tc = 3, 11
        gen = torch.Generator().manual_seed(1)
        kc = torch.randn((2, b, tc, 2, 8), generator=gen)
        ps = compute.profiled_site(ttfm.forward_decode, site=f"t.decode{x}")
        with torch.inference_mode():
            ps(model, torch.tensor([1, 2, 3]), torch.tensor([tc] * b), kc,
               kc, torch.tensor([tc] * b, dtype=torch.int32))
        got = ps.stats()["last_cost"]["flops"]
        want = b * ttfm.decode_flops_per_token(cfg, tc + 1)
        assert want < got <= want + _extra(cfg, x, b), (x, got, want)


def test_paged_decode_step_flops_on_cpu_count_the_plain_attention():
    """The paged forward on the CPU runs the plain paged attention, which
    attends every slot of the table (masked): its FLOPs are the formula's
    at the table's width, plus the gate and combine."""
    cfg = ttfm.TransformerConfig(**CFG, n_experts=1)
    model = ttfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    pool = torch.zeros((2, 8, 4, 2, 8))
    tables = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    lengths = torch.tensor([9, 5], dtype=torch.int32)
    ps = compute.profiled_site(ttfm.forward_decode_paged, site="t.paged")
    with torch.inference_mode():
        ps(model, torch.tensor([[1], [2]]), lengths.long()[:, None], pool,
           pool.clone(), tables, lengths)
    # 12 slots a row, the query's own among them
    want = 2 * ttfm.decode_flops_per_token(cfg, 12)
    got = ps.stats()["last_cost"]["flops"]
    assert want < got <= want + _extra(cfg, 1, 2)


def test_train_step_cost_sees_the_backward():
    cfg = ttfm.TransformerConfig(**CFG, n_experts=1)
    model = ttfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    ids = torch.randint(0, 64, (2, 16), generator=torch.Generator()
                        .manual_seed(2))
    fwd = compute.profiled_site(ttfm.unsharded_loss, site="t.fwd")
    fwd(model, ids, ids)
    step = ttfm.make_train_step(model, ledger=False)
    step(ids, ids)
    f_fwd = fwd.stats()["last_cost"]["flops"]
    f_step = compute.sites()["train.step"].stats()["last_cost"]["flops"]
    # the backward's products are twice the forward's, K2+K3's 14·D a
    # pair against K1's 4·D
    assert f_step >= 2.9 * f_fwd
    assert f_step / ttfm.train_step_flops(cfg, 2, 16) > 1.0


def test_train_step_ledger_records_bytes_and_a_memory_sample():
    cfg = ttfm.TransformerConfig(**CFG, n_experts=1)
    model = ttfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    telemetry.reset_steps()
    step = ttfm.make_train_step(model)
    ids = torch.randint(0, 64, (2, 16), generator=torch.Generator()
                        .manual_seed(3))
    for _ in range(3):
        step(ids, ids)
    recs = telemetry.ledger().records()
    cost = compute.sites()["train.step"].stats()
    assert cost["traces"] == 1 and cost["hits"] == 2
    assert all(r["bytes_accessed"] == cost["last_cost"]["bytes_accessed"]
               and r["membw_util"] is not None and r["bound"]
               for r in recs)
    assert compute.status()["hbm_peak_bytes"] > 0
    telemetry.reset_steps()


# ---------------------------------------------------------------------------
# views: status / report / prometheus text
# ---------------------------------------------------------------------------

def test_status_empty_without_sites():
    assert compute.status() == {} == jcompute.status()


def _keys(doc):
    """Every key path of a JSON document (list items merged)."""
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    if isinstance(doc, (list, tuple)) and doc and isinstance(doc[0], dict):
        return [_keys(doc[0])]
    return None


def test_status_and_report_schema_equal_jax():
    ps = compute.profiled_site(lambda x: x + 1, site="t.schema")
    ps(torch.zeros(2))
    ps(torch.zeros(4))
    pj = jcompute.profiled_jit(lambda x: x + 1, site="t.schema")
    pj(jnp.zeros((2,), jnp.float32))
    pj(jnp.zeros((4,), jnp.float32))
    compute.sample_hbm()
    jcompute.sample_hbm()
    st, jst = compute.status(), jcompute.status()
    assert st["traces"] == 2 and st["recompiles"] == 1
    assert "storm" in st and st["hbm_peak_bytes"] > 0
    assert _keys(st) == _keys(jst)
    rep, jrep = compute.report(), jcompute.report()
    assert rep["enabled"] and "t.schema" in rep["sites"]
    assert rep["traces_total"] == 2 == jrep["traces_total"]
    assert rep["recompiles_total"] == 1 == jrep["recompiles_total"]
    assert rep["storm"]["threshold"] >= 1
    assert rep["hbm"]["peak_bytes"] > 0
    assert set(rep["phases"]) == {"shares", "estimated", "measured"}
    assert "bound" in rep["roofline"]
    rep["hbm"].pop("devices"), jrep["hbm"].pop("devices")
    assert _keys(rep) == _keys(jrep)
    assert _keys(rep["sites"]["t.schema"]) == _keys(
        jrep["sites"]["t.schema"])


def test_storm_detector_trips_on_churn(monkeypatch):
    monkeypatch.setenv("DMLC_COMPUTE_STORM_TRACES", "3")
    ps = compute.profiled_site(lambda x: x, site="t.storm")
    for n in range(1, 5):
        ps(torch.zeros(n))
    storm = compute.status()["storm"]
    assert storm["active"]
    assert storm["sites"][0]["site"] == "t.storm"
    assert storm["sites"][0]["traces_in_window"] == 4


def test_prometheus_text_per_site_families():
    ps = compute.profiled_site(lambda x: x, site="t.prom")
    ps(torch.zeros(2))
    ps(torch.zeros(3))
    text = compute.prometheus_text()
    fam = "dmlc_compute_"
    assert f"# TYPE {fam}recompiles_total counter" in text
    assert f'{fam}recompiles_total{{site="t.prom"}} 1' in text
    assert f'{fam}traces_total{{site="t.prom"}} 2' in text
    assert f'{fam}cache_hits_total{{site="t.prom"}} 0' in text
    jps = jcompute.profiled_jit(lambda x: x, site="t.prom")
    jps(jnp.zeros((2,)))
    jps(jnp.zeros((3,)))
    strip = lambda t: [ln for ln in t.splitlines()  # noqa: E731
                       if not ln.startswith("# HELP")]
    assert strip(text) == strip(jcompute.prometheus_text())


# ---------------------------------------------------------------------------
# dark-cheap contract: DMLC_COMPUTE_PROFILE=0
# ---------------------------------------------------------------------------

def test_disabled_returns_the_function_itself(monkeypatch):
    monkeypatch.setenv("DMLC_COMPUTE_PROFILE", "0")

    def f(x):
        return x * 2.0

    assert compute.profiled_site(f, site="t.off") is f
    assert compute.sites() == {}     # no registry entry
    assert compute.status() == {}


def test_disabled_phase_scope_accumulates_nothing(monkeypatch):
    monkeypatch.setenv("DMLC_COMPUTE_PROFILE", "0")
    with compute.phase("gather"):
        time.sleep(0.001)
    compute.phase_estimate({"attention": 1.0}, 1.0)
    assert compute.phase_shares() == {}


def test_disabled_engine_and_train_step_run_plain(monkeypatch):
    monkeypatch.setenv("DMLC_COMPUTE_PROFILE", "0")
    from dmlc_tpu_torch.serving import InferenceEngine

    cfg = ttfm.TransformerConfig(**CFG, n_experts=1)
    model = ttfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    eng = InferenceEngine(model, device="cpu", n_blocks=8, block_size=4,
                          max_active=2)
    assert eng._decode is ttfm.forward_decode_paged
    eng.start()
    try:
        assert len(eng.generate([1, 2, 3], 4)) == 4
    finally:
        eng.close()
    ttfm.make_train_step(model)(torch.zeros((1, 8), dtype=torch.long),
                                torch.zeros((1, 8), dtype=torch.long))
    assert compute.sites() == {} and compute.status() == {}


def test_engine_sites_and_heartbeat_field(monkeypatch):
    """The engine's four program sites, each with a cost; the heartbeat
    carries ``compute.status()``."""
    from dmlc_tpu_torch.serving import InferenceEngine
    from dmlc_tpu_torch.telemetry.heartbeat import HeartbeatSender

    cfg = ttfm.TransformerConfig(**CFG, n_experts=1)
    model = ttfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    for mode, spec_k in (("on", 0), ("off", 0), ("off", 2)):
        monkeypatch.setenv("DMLC_SERVE_PAGED_ATTN", mode)
        eng = InferenceEngine(model, device="cpu", n_blocks=8, block_size=4,
                              max_active=2, spec_k=spec_k)
        eng.start()
        try:
            eng.generate([1, 2, 3, 1, 2, 3], 4)
        finally:
            eng.close()
    rep = compute.report()
    for site in ("serving.prefill", "serving.decode", "serving.decode_spec",
                 "serving.decode_paged"):
        assert rep["sites"][site]["last_cost"]["flops"] > 0, site
    assert rep["aot_fallbacks_total"] == 0
    sent = []

    class Client:
        def send_metrics(self, payload):
            sent.append(json.loads(payload))

    HeartbeatSender(Client(), interval=3600, auto_start=False).send_once()
    assert sent[0]["compute"] == json.loads(json.dumps(compute.status()))


def test_packed_feed_expander_is_the_feed_expand_site(tmp_path):
    """The packed transport's expander is the site ``feed.expand`` (the
    reference's :1222-1224): one trace for the feed's one shape, a hit
    a batch after, and rows byte-equal to the padded route's."""
    from dmlc_tpu.io.recordio import RecordIOWriter
    from dmlc_tpu.io.stream import Stream
    from dmlc_tpu_torch.feed import recordio_feed

    rng = np.random.default_rng(5)
    path = str(tmp_path / "d.rec")
    with Stream.create(path, "w") as s:
        w = RecordIOWriter(s)
        for i in range(40):
            w.write_record(rng.integers(0, 256, 4 + i % 50,
                                        dtype=np.uint8).tobytes())
    epochs = {}
    for kw in ({}, {"pack_bytes": 200}):
        feed = recordio_feed(path, batch_records=4, max_bytes=64,
                             num_parts=2, device="cpu", **kw)
        try:
            epochs[bool(kw)] = [{k: np.array(v) for k, v in b.items()}
                                for b in feed]
        finally:
            feed.close()
    for a, b in zip(epochs[False], epochs[True]):
        np.testing.assert_array_equal(a["length"], b["length"])
        np.testing.assert_array_equal(a["data"], b["data"])
    st = compute.sites()["feed.expand"].stats()
    assert st["traces"] == 1 and st["hits"] == len(epochs[True]) - 1
    assert st["aot_fallbacks"] == 0 and st["last_cost"]["bytes_accessed"] > 0


def test_composite_products_count_whole_under_inference_mode():
    """Under ``torch.inference_mode()`` einsum and matmul reach the mode
    whole: their FLOPs by formula, their bytes the operands and the
    result (what autograd mode counts through their mm/bmm)."""
    a, w = torch.ones(2, 3, 8), torch.ones(8, 4, 5)
    fns = {"einsum": lambda x, y: torch.einsum("bte,ehd->bthd", x, y),
           "matmul": lambda x, y: x @ y.reshape(8, 20)}
    for name, fn in fns.items():
        ps = compute.profiled_site(fn, site=f"t.{name}")
        with torch.inference_mode():
            out = ps(a, w)
        assert ps.stats()["last_cost"] == {
            "flops": 2.0 * 2 * 3 * 8 * 20,
            "bytes_accessed": 4.0 * (a.numel() + w.numel() + out.numel())}
    ps = compute.profiled_site(fns["einsum"], site="t.grad_mode")
    ps(a, w)   # outside inference mode: decomposed before the mode, bmm
    assert ps.stats()["last_cost"]["flops"] == 2.0 * 2 * 3 * 8 * 20
