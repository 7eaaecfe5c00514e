"""The port's incident forensics (``telemetry.forensics``) and decision
log (``telemetry.tracecontext.DecisionLog``) against the JAX package's.

``build_incidents`` and ``IncidentReporter`` take the inputs of the JAX
package's forensics tests (``tests/test_goodput.py``) and seeded random
intervals, decision chains, events and anomaly flags; the incident
documents are compared exactly (the reporter's own ``t`` pinned).  The
decision log takes the calls of ``tests/test_tracecontext.py`` on both
packages, with the records' ``t`` pinned."""

import types

import numpy as np
import pytest

from dmlc_tpu.telemetry import forensics as jfor
from dmlc_tpu.telemetry import tracecontext as jtc
from dmlc_tpu_torch.telemetry import forensics as pfor
from dmlc_tpu_torch.telemetry import tracecontext as ptc

T_FIXED = 1_700_000_000.25


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    clock = types.SimpleNamespace(time=lambda: T_FIXED)
    for mod in (jfor, pfor, jtc, ptc):
        monkeypatch.setattr(mod, "time", clock)
    monkeypatch.delenv("DMLC_TRACE_MAX_DECISIONS", raising=False)
    for mod in (jtc, ptc):
        mod.reset_decisions()
    yield
    for mod in (jtc, ptc):
        mod.reset_decisions()


def _both(fn_name, **kw):
    got = getattr(pfor, fn_name)(**kw)
    assert got == getattr(jfor, fn_name)(**kw)
    return got


# ---------------------------------------------------------------------------
# incidents
# ---------------------------------------------------------------------------

T = 1000.0
CASES = {
    "intervals_and_decisions_joined": dict(
        intervals=[{"bucket": "resize", "t0": T, "t1": T + 3.0,
                    "dur_s": 3.0, "rank": 2}],
        decisions=[{"kind": "preempt_kill_rank", "t": T + 1.0, "seq": 7},
                   {"kind": "unrelated", "t": T + 500.0, "seq": 8}],
        events=[{"kind": "world_resized", "t": T + 2.0, "seq": 3}],
        anomalies=[{"kind": "straggler", "rank": 2, "t": T + 1.5}]),
    "decision_chain_one_episode": dict(decisions=[
        {"kind": k, "t": 2000.0 + i, "seq": i} for i, k in enumerate(
            ["autoscale_verdict", "preempt_acquire", "preempt_kill_rank",
             "preempt_resize", "preempt_replica_added", "scale_up"])]),
    "open_chain_bridges_gap": dict(decisions=[
        {"kind": "preempt_resize", "t": 3000.0, "seq": 1},
        {"kind": "preempt_replica_added", "t": 3030.0, "seq": 2},
        {"kind": "scale_up", "t": 3031.0, "seq": 3}]),
    "terminal_decisions_stay_apart": dict(decisions=[
        {"kind": "scale_up", "t": 3000.0, "seq": 1},
        {"kind": "scale_down", "t": 3030.0, "seq": 2}]),
    "distant_episodes_newest_first": dict(intervals=[
        {"bucket": "resize", "t0": 100.0, "t1": 101.0, "dur_s": 1.0},
        {"bucket": "preempted", "t0": 500.0, "t1": 502.0, "dur_s": 2.0}]),
    "degenerate_inputs": dict(
        intervals=[{"bucket": "resize", "t0": 5.0, "t1": 5.0},
                   {"bucket": "resize", "t0": None, "t1": 9.0},
                   {"t0": 20.0, "t1": 21.0}],
        decisions=[{"kind": "scale_up", "t": 0}, {"kind": "scale_up"}],
        events=[{"kind": "no_time"}],
        anomalies=[{"kind": "ambient", "rank": None}]),
    "nothing": dict(),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_incidents_equal_jax(name):
    _both("build_incidents", **CASES[name])


def test_build_incidents_reads_as_jax():
    """The reference's join, read off the port alone."""
    (inc,) = _both("build_incidents",
                   **CASES["intervals_and_decisions_joined"])
    assert inc["kinds"] == ["preempt_kill_rank", "resize"]
    assert inc["ranks"] == [2] and inc["badput_s"] == 3.0
    assert [r["what"] for r in inc["timeline"]] == ["decision", "event"]
    assert inc["anomalies"] == [{"kind": "straggler", "rank": 2}]
    assert inc["summary"].startswith("3.00s badput (worst: resize)")
    chain = _both("build_incidents", **CASES["open_chain_bridges_gap"])
    assert len(chain) == 1
    assert len(_both("build_incidents",
                     **CASES["terminal_decisions_stay_apart"])) == 2


def _random_inputs(seed):
    rng = np.random.default_rng(seed)
    kinds = list(pfor.DECISION_EPISODE_KINDS) + ["tenant_reject", "route"]
    buckets = ["resize", "preempted", "checkpoint_save", "feed_stall",
               "rollback_replay", "compile"]
    t, intervals = 0.0, []
    for i in range(int(rng.integers(5, 30))):
        t += float(rng.exponential(8.0))
        dur = float(rng.exponential(2.0))
        iv = {"bucket": str(rng.choice(buckets)), "t0": t, "t1": t + dur,
              "dur_s": dur, "seq": i + 1}
        if rng.random() < 0.7:
            iv["rank"] = int(rng.integers(4))
        intervals.append(iv)
    horizon = t + 10.0
    decisions = [{"kind": str(rng.choice(kinds)),
                  "t": float(rng.uniform(0, horizon)), "seq": i + 1}
                 for i in range(int(rng.integers(0, 25)))]
    events = [{"kind": str(rng.choice(["world_resized", "anomaly",
                                       "declared_dead"])),
               "t": float(rng.uniform(0, horizon)), "seq": i + 1}
              for i in range(int(rng.integers(0, 25)))]
    anomalies = [{"kind": "straggler", "rank": int(rng.integers(4)),
                  "t": (None if rng.random() < 0.2
                        else float(rng.uniform(0, horizon)))}
                 for _ in range(int(rng.integers(0, 6)))]
    return dict(intervals=intervals, decisions=decisions, events=events,
                anomalies=anomalies, gap_s=float(rng.uniform(1, 10)),
                margin_s=float(rng.uniform(0, 4)),
                limit=int(rng.integers(1, 40)))


@pytest.mark.parametrize("seed", range(6))
def test_build_incidents_random_equal_jax(seed):
    _both("build_incidents", **_random_inputs(seed))


def test_incident_reporter_equal_jax():
    """Bound sources, a failing one among them: the same report, and a
    source that raises never fails it."""
    inputs = _random_inputs(11)

    def boom():
        raise RuntimeError("source down")

    docs = []
    for mod in (jfor, pfor):
        rep = mod.IncidentReporter(
            intervals_source=lambda: inputs["intervals"],
            decisions_source=lambda: inputs["decisions"],
            events_source=boom,
            anomalies_source=lambda: inputs["anomalies"], gap_s=3.0)
        docs.append(rep.report(limit=8))
    assert docs[1] == docs[0]
    assert docs[1]["t"] == T_FIXED and docs[1]["count"] <= 8
    assert all(not i["events"] for i in docs[1]["incidents"])
    empty = [mod.IncidentReporter().report() for mod in (jfor, pfor)]
    assert empty[1] == empty[0] == {"t": T_FIXED, "count": 0,
                                    "incidents": []}


def test_watchdog_anomaly_records_and_constants_equal_jax():
    for doc in ({"active": [{"rank": 3, "kind": "straggler", "since": 42.0},
                            {"rank": 1, "kind": "slo_tbt"}]},
                {}, None, {"active": None}):
        assert pfor.watchdog_anomaly_records(doc) == \
            jfor.watchdog_anomaly_records(doc)
    assert pfor.watchdog_anomaly_records(
        {"active": [{"rank": 3, "kind": "straggler", "since": 42.0}]}) == [
        {"kind": "straggler", "rank": 3, "t": 42.0}]
    assert pfor.DECISION_EPISODE_KINDS == jfor.DECISION_EPISODE_KINDS
    assert pfor._CHAIN_AWAITING == jfor._CHAIN_AWAITING
    assert pfor.__all__ == jfor.__all__


# ---------------------------------------------------------------------------
# the decision log
# ---------------------------------------------------------------------------

def _log_calls(log):
    out = []
    for i in range(5):
        out.append(log.record("scale_up", replica=f"r{i}"))
    out.append(log.records_since(0))
    out.append(log.records_since(3))
    out.append(log.records_since(5))
    out.append(log.records_since(0, limit=2))
    out.append(log.records_since(0, limit=None))
    out.append(log.tail(2))
    for i in range(10):
        log.record("k", i=i)
    out.append(log.records_since(0))
    out.append(log.tail(3))
    log.reset()
    out.append(log.records_since(0))
    out.append(log.record("after_reset"))
    return out


@pytest.mark.parametrize("capacity", [4, 8, 0])
def test_decision_log_equal_jax(capacity):
    got = _log_calls(ptc.DecisionLog(capacity=capacity))
    assert got == _log_calls(jtc.DecisionLog(capacity=capacity))
    recs, last = got[5]
    assert [r["seq"] for r in recs] == [1, 2, 3, 4, 5][-max(1, capacity):]
    assert last == 5 and got[-1]["seq"] == 16


def test_decision_log_default_ring_and_knob_equal_jax(monkeypatch):
    monkeypatch.setenv("DMLC_TRACE_MAX_DECISIONS", "3")
    for mod in (jtc, ptc):
        for i in range(5):
            mod.record_decision("preempt_kill_rank", rank=i)
    assert ptc.decision_log().tail(10) == jtc.decision_log().tail(10)
    assert [r["rank"] for r in ptc.decision_log().tail(10)] == [2, 3, 4]
    ptc.reset_decisions()
    assert ptc.decision_log().tail(10) == []
    assert ptc.decision_log() is ptc.decision_log()
