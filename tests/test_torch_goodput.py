"""The port's job goodput ledger and its aggregator against the JAX
package's: the same scripted spans and ``enter()`` sequences on a pinned
clock give equal bucket documents, the port mirrors the JAX tests of
``tests/test_goodput.py`` on the live clock, the aggregator's reports and
Prometheus text are byte-equal for the same ingested docs, and beats
carry the ``goodput`` sub-doc into the port's tracker, whose ``/goodput``
serves it."""

import json
import threading
import time
import urllib.request

import pytest

import dmlc_tpu.telemetry as jtel
import dmlc_tpu.telemetry.goodput as jgp
import dmlc_tpu_torch.telemetry as ptel
import dmlc_tpu_torch.telemetry.goodput as pgp
import dmlc_tpu_torch.tracker as ptr
from dmlc_tpu.telemetry import exporters as jexp
from dmlc_tpu_torch.telemetry import exporters as pexp


@pytest.fixture(autouse=True)
def fresh_telemetry():
    for tel in (jtel, ptel):
        tel.reset()
        tel.reset_steps()
        tel.reset_goodput()
    yield
    for tel in (jtel, ptel):
        tel.reset()
        tel.reset_steps()
        tel.reset_goodput()


def _assert_partition(doc):
    """Every instant in exactly one bucket (1e-6 s: float sums)."""
    assert set(doc["buckets"]) <= set(pgp.BUCKETS)
    assert sum(doc["buckets"].values()) == pytest.approx(
        doc["wall_s"], abs=1e-6)


def test_taxonomy_equals_jax():
    assert pgp.BUCKETS == jgp.BUCKETS
    assert pgp.BADPUT_BUCKETS == jgp.BADPUT_BUCKETS
    assert "productive" not in pgp.BADPUT_BUCKETS


# ---------------------------------------------------------------------------
# the ledger against the JAX ledger on one scripted clock
# ---------------------------------------------------------------------------

class _ScriptedCore:
    """The slice of ``telemetry.core`` the ledger reads, driven by hand:
    a clock in µs, a ring of closed spans and a list of open ones."""

    def __init__(self):
        self.now = 0.0
        self.ring = []
        self.open = []

    def now_ts(self):
        return self.now

    def anchor_epoch(self):
        return 1.7e9

    def spans_since(self, after_seq, limit=None):
        new = [r for r in self.ring if r["seq"] > after_seq]
        return new, (self.ring[-1]["seq"] if self.ring else after_seq)

    def open_spans(self):
        return [dict(r) for r in self.open]

    def close(self, name, cat, ts, dur, tid):
        self.ring.append({"name": name, "cat": cat, "ts": ts, "dur": dur,
                          "tid": tid, "seq": len(self.ring) + 1})


class _FixedTime:
    @staticmethod
    def time():
        return 1.7e9 + 123.0


def _script(led, core, tid, other):
    """One run's worth of evidence: startup, steps with feed waits and a
    checkpoint inside them, a compile, a resize landing mid feed-wait, a
    rollback chain, spans on another thread and an unrelated span; a
    status document at every stage."""
    docs = []

    def at(t):
        core.now = t

    def sample():
        docs.append(led.status())

    at(1000.0)
    sample()                                    # startup only
    core.close("compile:train_step", "compile", 1100.0, 400.0, tid)
    core.close("step", "step", 1600.0, 900.0, tid)
    core.close("feed.wait", "feed", 1600.0, 150.0, tid)
    core.close("checkpoint.save", "checkpoint", 2200.0, 200.0, tid)
    at(2600.0)
    led.on_step(tokens=512, step_s=900e-6)
    sample()
    core.close("collective.allreduce", "collective", 2600.0, 300.0, tid)
    core.close("step", "step", 2700.0, 1000.0, other)   # not the owner
    core.open.append({"name": "feed.wait", "cat": "feed", "ts": 3000.0,
                      "tid": tid})
    at(3200.0)
    sample()                                    # open span: provisional
    prev = led.enter("resize")                  # WorldResized mid-wait
    assert prev is None
    at(3500.0)
    sample()
    led.enter(prev)                             # generation settled
    at(3800.0)
    core.open.clear()
    core.close("feed.wait", "feed", 3000.0, 900.0, tid)
    core.close("checkpoint.restore", "checkpoint", 4100.0, 80.0, tid)
    core.close("step", "step", 3000.0, 1300.0, tid)
    at(4300.0)
    led.on_step(tokens=512, step_s=1300e-6)
    sample()
    first = led.enter("rollback_replay")
    at(4500.0)
    core.close("checkpoint.restore", "checkpoint", 4400.0, 80.0, tid)
    inner = led.enter("resize")                 # a resize inside replay
    assert inner == "rollback_replay"
    at(4700.0)
    led.enter(inner)
    core.close("step", "step", 4700.0, 400.0, tid)
    at(5100.0)
    led.on_step(tokens=512, step_s=400e-6)
    led.enter(first)
    at(5600.0)
    sample()
    return docs


def test_ledger_documents_equal_jax_on_a_scripted_clock(monkeypatch):
    """Both ledgers see the same spans, overrides and steps on a pinned
    clock; every status document is equal, key for key (exact: the same
    float operations in the same order)."""
    tid = threading.get_ident()
    docs = []
    for mod in (jgp, pgp):
        core = _ScriptedCore()
        monkeypatch.setattr(mod, "core", core)
        monkeypatch.setattr(mod, "time", _FixedTime)
        docs.append(_script(mod.GoodputLedger(window_s=0.002), core, tid,
                            tid + 1))
    want, got = docs
    assert got == want
    last = got[-1]
    _assert_partition(last)
    for bucket in ("startup", "compile", "feed_stall", "checkpoint_save",
                   "checkpoint_restore", "resize", "rollback_replay",
                   "productive", "unattributed"):
        assert last["buckets"][bucket] > 0, bucket
    assert [iv["bucket"] for iv in last["intervals"]] == \
        [iv["bucket"] for iv in want[-1]["intervals"]]


# ---------------------------------------------------------------------------
# the JAX tests of the ledger, on the port (live clock)
# ---------------------------------------------------------------------------

def test_partition_sums_to_wall_with_mixed_evidence():
    led = pgp.GoodputLedger()
    with ptel.span("step", stage="step"):
        time.sleep(0.02)
        with ptel.span("checkpoint.save", stage="checkpoint"):
            time.sleep(0.02)
    prev = led.enter("resize")
    assert prev is None
    time.sleep(0.02)
    led.enter(prev)
    led.on_step(tokens=1000, step_s=0.04)
    doc = led.status()
    _assert_partition(doc)
    assert doc["buckets"]["checkpoint_save"] >= 0.015
    assert doc["buckets"]["productive"] >= 0.015
    assert doc["buckets"]["resize"] >= 0.015
    assert doc["buckets"].get("startup", 0.0) > 0.0
    assert doc["goodput_fraction"] == pytest.approx(
        doc["buckets"]["productive"] / doc["wall_s"], rel=1e-6)
    assert doc["tokens"] == 1000
    assert doc["effective_tokens_per_s"] == pytest.approx(
        1000 / doc["wall_s"], rel=1e-6)


def test_partition_holds_at_every_call_and_buckets_are_monotone():
    led = pgp.GoodputLedger()
    led.on_step(tokens=1, step_s=0.001)
    prior = {}
    for i in range(4):
        if i == 1:
            with ptel.span("feed.wait", stage="feed"):
                time.sleep(0.01)
        if i == 2:
            led.enter("rollback_replay")
            time.sleep(0.01)
            led.enter(None)
        time.sleep(0.005)
        doc = led.status()
        _assert_partition(doc)
        for b, s in prior.items():
            assert doc["buckets"].get(b, 0.0) >= s - 1e-6, b
        prior = dict(doc["buckets"])
    assert prior["feed_stall"] >= 0.008
    assert prior["rollback_replay"] >= 0.008


def test_open_span_is_not_double_counted_across_samples():
    led = pgp.GoodputLedger()
    with ptel.span("checkpoint.restore", stage="checkpoint"):
        time.sleep(0.02)
        mid = led.status()
        _assert_partition(mid)
        assert mid["buckets"].get("checkpoint_restore", 0.0) >= 0.015
        assert mid["current"] == "checkpoint_restore"
        time.sleep(0.02)
    done = led.status()
    _assert_partition(done)
    assert done["buckets"]["checkpoint_restore"] >= 0.035
    assert done["buckets"]["checkpoint_restore"] < mid["wall_s"] + 0.1


def test_resize_mid_feed_wait_attributes_both():
    """A WorldResized landing inside feed.wait: the recovery is
    ``resize``, the surrounding wait ``feed_stall``, nothing leaks to
    ``unattributed`` (under 10 ms of it)."""
    led = pgp.GoodputLedger()
    led.on_step(tokens=1, step_s=0.001)
    with ptel.span("feed.wait", stage="feed"):
        time.sleep(0.02)
        prev = led.enter("resize")
        time.sleep(0.02)
        led.enter(prev)
        time.sleep(0.02)
    doc = led.status()
    _assert_partition(doc)
    assert doc["buckets"]["resize"] >= 0.015
    assert doc["buckets"]["feed_stall"] >= 0.03
    assert doc["buckets"].get("unattributed", 0.0) < 0.01


def test_enter_restore_chain_preserves_rollback_override():
    led = pgp.GoodputLedger()
    led.enter("rollback_replay")
    time.sleep(0.01)
    prev = led.enter("resize")
    assert prev == "rollback_replay"
    time.sleep(0.01)
    led.enter(prev)
    time.sleep(0.01)
    led.enter(None)
    doc = led.status()
    _assert_partition(doc)
    assert doc["buckets"]["rollback_replay"] >= 0.015
    assert doc["buckets"]["resize"] >= 0.008


def test_enter_rejects_unknown_bucket():
    with pytest.raises(ValueError):
        pgp.GoodputLedger().enter("coffee_break")


def test_badput_intervals_recorded_for_forensics():
    led = pgp.GoodputLedger(max_intervals=8)
    led.enter("resize")
    time.sleep(0.02)
    led.enter(None)
    with ptel.span("checkpoint.save", stage="checkpoint"):
        time.sleep(0.015)
    doc = led.status()
    ivs = doc["intervals"]
    assert [iv["bucket"] for iv in ivs] == ["resize", "checkpoint_save"]
    now = time.time()
    for iv in ivs:
        assert iv["t1"] > iv["t0"]
        assert iv["dur_s"] == pytest.approx(iv["t1"] - iv["t0"], abs=1e-6)
        assert abs(iv["t1"] - now) < 60  # epoch-stamped, not monotonic
    assert ivs[0]["seq"] < ivs[1]["seq"]


def test_window_doc_tracks_recent_rate():
    led = pgp.GoodputLedger(window_s=0.05)
    led.on_step(tokens=100, step_s=0.01)
    time.sleep(0.06)
    led.on_step(tokens=900, step_s=0.01)
    win = led.status()["window"]
    assert win["wall_s"] <= 0.2
    assert win["tokens"] == pytest.approx(900)
    assert win["effective_tokens_per_s"] > 0


def test_window_and_interval_knobs(monkeypatch):
    monkeypatch.setenv("DMLC_GOODPUT_WINDOW_S", "7.5")
    monkeypatch.setenv("DMLC_GOODPUT_MAX_INTERVALS", "3")
    for mod in (jgp, pgp):
        led = mod.GoodputLedger()
        assert (led.window_s, led.max_intervals) == (7.5, 3)


def test_step_record_carves_checkpoint_stall():
    led = ptel.StepLedger()
    led.step_begin()
    with ptel.span("checkpoint.save", stage="checkpoint"):
        time.sleep(0.02)
    time.sleep(0.01)
    rec = led.step_end(tokens=10)
    assert rec["checkpoint_stall_s"] >= 0.015
    total = (rec["feed_wait_s"] + rec["checkpoint_stall_s"]
             + rec["collective_s"] + rec["compute_s"])
    assert total == pytest.approx(rec["wall_s"], rel=1e-6)


def test_step_end_feeds_goodput_ledger_when_opted_in():
    pgp.ledger()  # opt in
    led = ptel.StepLedger()
    led.step_begin()
    time.sleep(0.01)
    led.step_end(tokens=123)
    doc = pgp.status()
    assert doc is not None
    assert doc["tokens"] == pytest.approx(123)
    assert doc["steps"] == 1
    _assert_partition(doc)


def test_goodput_status_is_none_without_opt_in():
    led = ptel.StepLedger()
    led.step_begin()
    led.step_end(tokens=5)  # module-level on_step must not create one
    assert pgp.status() is None


def test_status_keys_equal_jax():
    """The live documents carry the JAX ledger's keys, bucket names and
    window keys (the heartbeat's wire format)."""
    docs = []
    for mod, tel in ((jgp, jtel), (pgp, ptel)):
        led = mod.ledger()
        led.enter("resize")
        led.enter(None)
        tel.step_begin()
        tel.step_end(tokens=8)
        docs.append(mod.status())
    want, got = docs
    assert sorted(got) == sorted(want)
    assert sorted(got["window"]) == sorted(want["window"])
    assert sorted(got["intervals"][0]) == sorted(want["intervals"][0])
    assert got["steps"] == want["steps"] == 1


# ---------------------------------------------------------------------------
# the aggregator against the JAX aggregator
# ---------------------------------------------------------------------------

def _doc(anchor=100.0, wall=10.0, productive=6.0, tokens=600.0, seqs=()):
    buckets = {b: 0.0 for b in pgp.BUCKETS}
    buckets["productive"] = productive
    buckets["startup"] = wall - productive
    return {
        "t": 1.7e9, "anchor": anchor, "wall_s": wall,
        "buckets": buckets, "goodput_fraction": productive / wall,
        "tokens": tokens, "steps": 3, "in_step_s": productive,
        "effective_tokens_per_s": tokens / wall,
        "in_step_tokens_per_s": tokens / productive,
        "window": {"wall_s": wall, "tokens": tokens,
                   "effective_tokens_per_s": tokens / wall,
                   "in_step_tokens_per_s": tokens / productive},
        "current": "productive",
        "intervals": [{"seq": s, "bucket": "resize",
                       "t0": 50.0 + s, "t1": 51.0 + s, "dur_s": 1.0}
                      for s in seqs],
    }


def test_aggregator_report_and_fractions():
    agg = pgp.GoodputAggregator()
    agg.ingest(0, _doc(wall=10.0, productive=6.0))
    agg.ingest(1, _doc(wall=10.0, productive=8.0))
    rep = agg.report()
    assert rep["ranks"] == 2
    cl = rep["cluster"]
    assert cl["wall_s"] == pytest.approx(20.0)
    assert cl["goodput_fraction"] == pytest.approx(0.7)
    assert sum(cl["fractions"].values()) == pytest.approx(1.0)
    assert cl["effective_tokens_per_s"] == pytest.approx(
        cl["tokens"] / cl["wall_s"])


def test_aggregator_dead_rank_accrues_preempted_until_relaunch():
    agg = pgp.GoodputAggregator()
    agg.ingest(0, _doc(anchor=100.0))
    agg.mark_dead(0)
    time.sleep(0.05)
    rep = agg.report()
    assert rep["per_rank"]["0"]["buckets"]["preempted"] >= 0.04
    agg.ingest(0, _doc(anchor=222.0))   # relaunched under the same rank
    gap1 = agg.report()["per_rank"]["0"]["buckets"]["preempted"]
    assert gap1 >= 0.04
    time.sleep(0.02)
    gap2 = agg.report()["per_rank"]["0"]["buckets"]["preempted"]
    assert gap2 == pytest.approx(gap1, abs=0.01)  # stopped accruing


def test_aggregator_remap_ranks_moves_survivor_and_drops_dead():
    agg = pgp.GoodputAggregator()
    for r in (0, 1, 2):
        agg.ingest(r, _doc(anchor=100.0 + r, wall=10.0 + r,
                           productive=5.0 + r, seqs=(1,)))
    agg.remap_ranks({0: 0, 2: 1})
    rep = agg.report()
    assert sorted(rep["per_rank"]) == ["0", "1"]
    assert rep["per_rank"]["0"]["wall_s"] == pytest.approx(10.0)
    assert rep["per_rank"]["1"]["wall_s"] == pytest.approx(12.0)
    assert rep["per_rank"]["1"]["buckets"]["productive"] == pytest.approx(7.0)
    agg.ingest(1, _doc(anchor=102.0, wall=12.5, productive=7.2,
                       seqs=(1, 2)))
    ivs = [iv for iv in agg.badput_intervals() if iv["rank"] == 1]
    assert sorted(iv["seq"] for iv in ivs) == [1, 2]
    assert agg.report()["per_rank"]["1"]["wall_s"] == pytest.approx(12.5)


def test_aggregator_ignores_garbage():
    agg = pgp.GoodputAggregator()
    agg.ingest(0, None)
    agg.ingest(0, {"no": "buckets"})
    garbage = _doc()
    garbage["intervals"] = [{"seq": "NaN"}, {"bucket": "resize"}, "nope"]
    agg.ingest(0, garbage)
    assert agg.report()["ranks"] == 1
    assert agg.badput_intervals() == []


def test_aggregator_reports_and_text_equal_jax(monkeypatch):
    """The same docs, deaths, remaps and drops into both aggregators on a
    pinned wall clock: equal reports and interval feeds, and Prometheus
    text byte-equal and valid under both packages' checkers."""
    aggs = []
    for mod in (jgp, pgp):
        monkeypatch.setattr(mod, "time", _FixedTime)
        agg = mod.GoodputAggregator()
        agg.ingest(0, _doc(seqs=(2,)))
        agg.ingest(1, _doc(anchor=101.0, wall=20.0, productive=4.0,
                           seqs=(1,)))
        agg.ingest(2, _doc(anchor=102.0, wall=12.0, productive=9.5))
        agg.mark_dead(3)
        agg.remap_ranks({0: 0, 2: 1, 3: 2})
        agg.ingest(0, _doc(anchor=100.0, wall=11.0, productive=6.5,
                           seqs=(2, 3)))
        aggs.append(agg)
    want, got = aggs
    assert got.report() == want.report()
    assert got.badput_intervals() == want.badput_intervals()
    text = got.prometheus_text()
    assert text == want.prometheus_text()
    jexp.validate_exposition_text(text)
    pexp.validate_exposition_text(text)
    assert 'dmlc_goodput_bucket_seconds{rank="0",bucket="productive"}' in text
    assert "dmlc_goodput_cluster_fraction" in text


# ---------------------------------------------------------------------------
# beats into the port's tracker; /goodput
# ---------------------------------------------------------------------------

def test_beats_carry_goodput_to_the_tracker_and_goodput_serves_it():
    tracker = ptr.RabitTracker("127.0.0.1", 1, metrics_port=0)
    tracker.start(1)
    try:
        c = ptr.TrackerClient("127.0.0.1", tracker.port, jobid="gp").start()
        hb = ptel.HeartbeatSender(c, interval=60.0, auto_start=False)
        hb.send_once()   # not opted in: no sub-doc, nothing aggregated
        assert tracker.goodput.report()["ranks"] == 0
        led = pgp.ledger()
        led.enter("resize")
        time.sleep(0.01)
        led.enter(None)
        ptel.step_begin()
        ptel.step_end(tokens=64)
        hb.send_once()
        hb.close()
        base = f"http://127.0.0.1:{tracker.metrics_port}"
        doc = json.loads(urllib.request.urlopen(base + "/goodput",
                                                timeout=10).read())
        rank0 = doc["per_rank"]["0"]
        assert rank0["buckets"]["resize"] >= 0.008
        assert rank0["tokens"] == 64
        assert sum(rank0["buckets"].values()) == pytest.approx(
            rank0["wall_s"], rel=0.02)
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        assert 'dmlc_goodput_fraction{rank="0"}' in text
        pexp.validate_exposition_text(text)
        c.shutdown()
        tracker.join(timeout=20)
    finally:
        tracker.close()
