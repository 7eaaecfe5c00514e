"""The port's anomaly watchdog (``telemetry.anomaly``) against the JAX
package's: the same step-record streams and shipped sub-docs go through
both ``Watchdog`` classes, and after every call the two serve the same
``report()``, ``compute_report()``, ``trace_markers()`` and
``prometheus_text()``, count the same ``anomaly`` counters and record
the same ``anomaly`` events.

The watchdog stamps flags and verdicts with ``time.time()``: both
modules' clocks are pinned to one instant, so every document is
compared exactly (the event ring's own stamps are left out of the event
comparison).  The streams are those of the JAX package's watchdog tests
(``tests/test_step_ledger.py``, ``tests/test_slo.py``,
``tests/test_compute_ledger.py``, ``tests/test_goodput.py``) plus
seeded random ones."""

import json
import types

import numpy as np
import pytest

import dmlc_tpu.telemetry as jtel
import dmlc_tpu.telemetry.anomaly as janom
import dmlc_tpu_torch.telemetry as ptel
import dmlc_tpu_torch.telemetry.anomaly as panom
from dmlc_tpu.telemetry import exporters as jexp
from dmlc_tpu_torch.telemetry import exporters as pexp

T_FIXED = 1_700_000_000.25
KNOBS = ("DMLC_WATCHDOG_K", "DMLC_WATCHDOG_WINDOW",
         "DMLC_WATCHDOG_REGRESSION", "DMLC_WATCHDOG_FEED_FRAC",
         "DMLC_WATCHDOG_GOODPUT_FRAC", "DMLC_GOODPUT_MIN_FRACTION")


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    clock = types.SimpleNamespace(time=lambda: T_FIXED)
    for mod in (janom, panom):
        monkeypatch.setattr(mod, "time", clock)
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for tel in (jtel, ptel):
        tel.reset()
        tel.reset_events()
    yield
    for tel in (jtel, ptel):
        tel.reset()
        tel.reset_events()


def _doc(x):
    return json.dumps(x, sort_keys=True)


def _events(tel):
    return [{k: v for k, v in e.items() if k not in ("t", "mono", "seq")}
            for e in tel.events_tail(4096)]


def _same(j, p):
    assert _doc(p.report()) == _doc(j.report())
    assert _doc(p.compute_report()) == _doc(j.compute_report())
    assert p.trace_markers() == j.trace_markers()
    assert p.prometheus_text() == j.prometheus_text()
    assert ptel.counters_snapshot().get("anomaly") == \
        jtel.counters_snapshot().get("anomaly")
    assert _events(ptel) == _events(jtel)


def _run(ops, **kw):
    """One JAX and one port Watchdog through ``ops`` (``(method, *args)``
    each, every argument a fresh copy for each package); the documents
    are compared after every call.  Returns the port's watchdog."""
    dogs = (janom.Watchdog(**kw), panom.Watchdog(**kw))
    for name, *args in ops:
        text = json.dumps(args)
        for w in dogs:
            getattr(w, name)(*json.loads(text))
        _same(*dogs)
    return dogs[1]


def _steps(n, wall, start=1, feed=0.0, goodput=None, t0=1000.0):
    return [{"seq": start + i, "wall_s": wall, "feed_wait_s": feed,
             "t_wall": t0 + i, "goodput_tokens_per_s": goodput}
            for i in range(n)]


def _storm(active=True):
    return {"traces": 6, "hits": 0, "recompiles": 5,
            "hbm_peak_bytes": 1 << 30,
            "storm": {"active": active, "window_s": 60.0, "threshold": 4,
                      "sites": [{"site": "smoke.churn",
                                 "traces_in_window": 6}]}}


def _goodput(eff, in_step):
    return {"goodput_fraction": 0.5, "effective_tokens_per_s": eff,
            "in_step_tokens_per_s": in_step, "current": "feed_stall",
            "window": {"wall_s": 30.0, "tokens": eff * 30.0,
                       "effective_tokens_per_s": eff,
                       "in_step_tokens_per_s": in_step}}


# The JAX package's watchdog tests, op for op: (kwargs, ops, the port's
# flags per rank at the end).
SCENARIOS = {
    "straggler_then_recovery": (dict(k=4, window=3), [
        ("ingest", 0, _steps(20, 0.01), 1.0),
        ("ingest", 1, _steps(20, 0.05), 1.0),
        ("ingest", 1, _steps(20, 0.01, start=21), 1.0)], {"0": [], "1": []}),
    "straggler_flagged": (dict(k=4, window=3), [
        ("ingest", 0, _steps(20, 0.01), 1.0),
        ("ingest", 1, _steps(20, 0.05), 1.0)],
        {"0": [], "1": ["straggler"]}),
    "single_spike": (dict(k=4, window=3), [
        ("ingest", 0, _steps(20, 0.01), 1.0),
        ("ingest", 1, _steps(19, 0.01) + _steps(1, 0.5, start=20), 1.0)],
        {"0": [], "1": []}),
    "regression": (dict(window=3), [
        ("ingest", 0, _steps(30, 0.01), 1.0),
        ("ingest", 0, _steps(10, 0.03, start=31), 1.0)],
        {"0": ["regression"]}),
    "feed_stall": (dict(window=3), [
        ("ingest", 0, _steps(30, 0.02, feed=0.015), 1.0)],
        {"0": ["feed_stall"]}),
    "goodput_collapse": (dict(window=3), [
        ("ingest", 0, _steps(30, 0.01, goodput=1000.0), 1.0),
        ("ingest", 0, _steps(10, 0.01, start=31, goodput=100.0), 1.0)],
        {"0": ["goodput_collapse"]}),
    "reshipped_records": (dict(window=3), [
        ("ingest", 0, _steps(10, 0.01), 1.0),
        ("ingest", 0, _steps(10, 0.01), 1.0)], {"0": []}),
    "restart_resets_baselines": (dict(window=3), [
        ("ingest_remediation", 0, {"last_action": "skip", "skips": 1}),
        ("ingest_compute", 0, _storm()),
        ("ingest", 0, _steps(30, 0.01), 1.0),
        ("ingest", 0, _steps(5, 0.02), 2.0)], {"0": ["recompile_storm"]}),
    "ingest_json_and_garbage": (dict(window=2), [
        ("ingest_json", 0, json.dumps({"trace": {
            "anchor": 1.0, "steps": _steps(3, 0.01)}})),
        ("ingest_json", 0, "not json"),
        ("ingest_json", 0, json.dumps({"trace": {"steps": [
            {"wall_s": "garbage"}, 17,
            {"seq": 9, "wall_s": 0.01, "t_wall": 1.0}]}})),
        ("ingest_json", 0, json.dumps([1, 2])),
        ("ingest", 0, [{"seq": 10, "wall_s": float("nan")},
                       {"seq": 11, "wall_s": -1.0}, {"seq": 12}], 1.0),
        ("ingest", -1, _steps(3, 0.01), 1.0),
        ("ingest", 0, "not a list", 1.0),
        ("ingest", 0, _steps(2, 0.01, start=13), "unplaceable")],
        {"0": []}),
    "drop_forgets": (dict(window=3), [
        ("ingest", 0, _steps(10, 0.01), 1.0),
        ("drop", 0), ("drop", 5)], {}),
    "slo_set_and_clear": (dict(window=3), [
        ("ingest_slo", 2, {"active": ["slo_ttft"], "burn": {
            "ttft_p99": {"fast": 50.0, "slow": 20.0}}}),
        ("ingest_slo", 2, {"active": []}),
        ("ingest_slo", 2, {"active": "nope"}),
        ("ingest_slo", -1, {"active": ["slo_tbt"]})], {"2": []}),
    "step_ingest_keeps_slo": (dict(window=2), [
        ("ingest_slo", 0, {"active": ["slo_error_rate", "not_a_kind"]}),
        ("ingest", 0, [{"seq": i + 1, "wall_s": 0.1} for i in range(10)])],
        {"0": ["slo_error_rate"]}),
    "slo_from_heartbeat_json": (dict(window=2), [
        ("ingest_json", 1, json.dumps({"slo": {"active": ["slo_tbt"],
                                               "burn": {}},
                                       "trace": {"anchor": 123.0,
                                                 "steps": []}}))],
        {"1": ["slo_tbt"]}),
    "compute_storm_flags_and_clears": ({}, [
        ("ingest_json", 1, json.dumps({"compute": _storm()})),
        ("ingest_compute", 1, _storm(active=False))], {"1": []}),
    "compute_sanitized": ({}, [
        ("ingest_compute", 1, {"traces": "NaN-ish", "recompiles": 2,
                               "storm": "not-a-dict"}),
        ("ingest_compute", 1, {"storm": {
            "active": True, "sites": ["x", {"site": "y" * 300}]}}),
        ("ingest_compute", -1, _storm())], {"1": ["recompile_storm"]}),
    "effective_goodput_collapse": ({}, [
        ("ingest_goodput", 0, _goodput(eff=10.0, in_step=100.0)),
        ("ingest_goodput", 0, _goodput(eff=90.0, in_step=100.0)),
        ("ingest_json", 1, json.dumps(
            {"goodput": _goodput(eff=1.0, in_step=100.0)})),
        ("ingest_goodput", 2, {"window": "nope"})],
        {"0": [], "1": ["effective_goodput_collapse"], "2": []}),
    "remediation_sanitized": ({}, [
        ("ingest_remediation", 0, {"last_action": "rollback",
                                   "reason": "nonfinite", "step": 21,
                                   "skips": 2, "rollbacks": 1,
                                   "consecutive": 0, "t": 5.0,
                                   "extra": "dropped"}),
        ("ingest_remediation", 1, {"reason": "x" * 300, "step": [1]}),
        ("ingest_remediation", 2, {"skips": 1}),
        ("ingest_remediation", -1, {"skips": 1})],
        {"0": [], "2": []}),
    "fleet_saturation": ({}, [
        ("ingest_fleet", 0, {"saturated": True, "detail": "no hosts"}),
        ("ingest_json", 0, json.dumps({"fleet": {"saturated": True}})),
        ("ingest_fleet", 0, {"saturated": False}),
        ("ingest_fleet", 1, {"saturated": True})],
        {"0": [], "1": ["fleet_saturated"]}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_watchdog_scenarios_equal_jax(name):
    kw, ops, flags = SCENARIOS[name]
    w = _run(ops, **kw)
    rep = w.report()
    assert {r: st["flags"] for r, st in rep["ranks"].items()} == flags
    text = w.prometheus_text()
    kinds = (panom.ANOMALY_KINDS + panom.SLO_KINDS + panom.COMPUTE_KINDS
             + panom.FLEET_KINDS + panom.GOODPUT_KINDS)
    assert jexp.validate_exposition_text(text) == \
        pexp.validate_exposition_text(text) == len(flags) * len(kinds)


def test_straggler_surfaces_in_every_view():
    """The reference's straggler case, read off the port alone: the flag,
    its counter, its event and its trace marker."""
    w = _run(SCENARIOS["straggler_flagged"][1], k=4, window=3)
    rep = w.report()
    assert rep["active"] == [{"rank": 1, "kind": "straggler",
                              "since": T_FIXED}]
    assert ptel.counters_snapshot()["anomaly"]["straggler_flags"] == 1
    assert [e["kind"] for e in ptel.events_tail()] == ["anomaly"]
    assert [m["name"] for m in w.trace_markers()] == [
        "anomaly:straggler rank 1"]
    assert 'dmlc_anomaly_active{rank="1",kind="straggler"} 1' in \
        w.prometheus_text()


def _random_ops(seed, n_ranks=4, n_steps=80):
    """Seeded step streams: lognormal step times, one rank slowed 3x
    half way, feed waits and goodput rates; shipped in chunks of 1-9 in
    a random rank order, 20% re-shipped, one rank restarted, and status
    sub-docs interleaved."""
    rng = np.random.default_rng(seed)
    slow, restarted = int(rng.integers(n_ranks)), int(rng.integers(n_ranks))
    streams = {}
    for r in range(n_ranks):
        recs = []
        for i in range(n_steps):
            wall = float(rng.lognormal(np.log(0.02), 0.1))
            if r == slow and i >= n_steps // 2:
                wall *= 3.0
            recs.append({"seq": i + 1, "wall_s": wall,
                         "feed_wait_s": float(wall * rng.uniform(0, 0.7)),
                         "collective_s": float(wall * 0.1),
                         "t_wall": 1000.0 + i,
                         "goodput_tokens_per_s":
                             float(4096 / wall * rng.uniform(0.2, 1.0)),
                         "mfu": float(rng.uniform(0.1, 0.5))})
        streams[r] = recs
    cursor = {r: 0 for r in range(n_ranks)}
    anchor = {r: 100.0 + r for r in range(n_ranks)}
    ops, last = [], {}
    while any(cursor[r] < n_steps for r in cursor):
        r = int(rng.choice([q for q in cursor if cursor[q] < n_steps]))
        if r == restarted and cursor[r] >= n_steps // 3 \
                and anchor[r] < 200.0:
            anchor[r] += 100.0   # a new process: seq restarts at 1
            streams[r] = [dict(rec, seq=rec["seq"] - cursor[r])
                          for rec in streams[r]]
        n = int(rng.integers(1, 10))
        chunk = [rec for rec in streams[r][cursor[r]:cursor[r] + n]
                 if rec["seq"] > 0]
        cursor[r] += n
        ops.append(("ingest", r, chunk, anchor[r]))
        if r in last and rng.random() < 0.2:
            ops.append(("ingest", r, last[r], anchor[r]))
        last[r] = chunk
        u = rng.random()
        if u < 0.05:
            ops.append(("ingest_slo", r, {"active": ["slo_ttft"]
                                          if rng.random() < 0.5 else []}))
        elif u < 0.10:
            ops.append(("ingest_compute", r,
                        _storm(active=bool(rng.random() < 0.5))))
        elif u < 0.15:
            eff = float(rng.uniform(1.0, 100.0))
            ops.append(("ingest_goodput", r, _goodput(eff, 100.0)))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watchdog_random_streams_equal_jax(seed):
    w = _run(_random_ops(seed), window=3)
    rep = w.report()
    assert len(rep["ranks"]) == 4
    assert all(st["steps"] > 0 for st in rep["ranks"].values())
    assert rep["recent_verdicts"]   # the slowed rank was flagged


def test_verdict_ring_bounded_as_jax():
    """More verdicts than the ring holds: both keep the newest
    ``MAX_VERDICTS`` (the markers) and report the last 32."""
    ops = []
    for i in range(300):
        ops.append(("ingest_slo", i % 3, {"active": ["slo_tbt"]}))
        ops.append(("ingest_slo", i % 3, {"active": []}))
    w = _run(ops)
    assert len(w.trace_markers()) == panom.Watchdog.MAX_VERDICTS
    assert len(w.report()["recent_verdicts"]) == 32


def test_knobs_read_as_jax(monkeypatch):
    for knob, val in zip(KNOBS, ("2.5", "2", "0.2", "0.3", "0.8", "0.05")):
        monkeypatch.setenv(knob, val)
    dogs = (janom.Watchdog(), panom.Watchdog())
    attrs = ("k", "window", "regression_frac", "feed_frac", "goodput_frac",
             "goodput_min_fraction")
    got = [getattr(dogs[1], a) for a in attrs]
    assert got == [getattr(dogs[0], a) for a in attrs]
    assert got == [2.5, 2, 0.2, 0.3, 0.8, 0.05]
    w = _run(_random_ops(7))
    assert w.k == 2.5
    # window 0 clamps to 1 in both
    assert panom.Watchdog(window=0).window == janom.Watchdog(window=0).window


def test_constants_and_lower_median_equal_jax():
    for name in ("ANOMALY_KINDS", "COMPUTE_KINDS", "FLEET_KINDS",
                 "GOODPUT_KINDS", "SLO_KINDS", "_RECENT", "_WARMUP_STEPS",
                 "_BASELINE_SKIP", "_EWMA_FAST", "_EWMA_SLOW"):
        assert getattr(panom, name) == getattr(janom, name), name
    assert panom.Watchdog.MAX_VERDICTS == janom.Watchdog.MAX_VERDICTS
    rng = np.random.default_rng(3)
    for n in range(1, 40):
        vals = rng.standard_normal(n).tolist()
        assert panom._lower_median(vals) == janom._lower_median(vals)
