"""Parity of the port's telemetry package with the JAX package's.

The same calls go through ``dmlc_tpu.telemetry`` and the port's
``telemetry``, with every timestamp explicit: spans through
``record_span(t0=, t1=)``, the ledgers' ``t=``/``now=`` arguments, and a
patched ``perf_counter`` wherever a module reads a wall.  Nothing here
times a sleep.  Tolerances: everything is compared exactly (the two
packages run the same arithmetic in the same order on the same floats),
except where a test says otherwise.

Also: the train step's ledger on the CPU, the feed's spans and
counters, the checkpoint's spans and counters, and the integrity
counters against the JAX package's.
"""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from dmlc_tpu import telemetry as jtel
from dmlc_tpu.io import integrity as jintegrity
from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu.telemetry import core as jcore
from dmlc_tpu.telemetry import exporters as jexp
from dmlc_tpu.telemetry import goodput as jgoodput
from dmlc_tpu.telemetry import steps as jsteps
from dmlc_tpu.telemetry import tracecontext as jtrace
from dmlc_tpu_torch import telemetry as ttel
from dmlc_tpu_torch.checkpoint import (CheckpointManager, restore_pytree,
                                       save_pytree)
from dmlc_tpu_torch.checkpoint.sharded import CorruptCheckpoint
from dmlc_tpu_torch.feed import DeviceFeed
from dmlc_tpu_torch.io import integrity as tintegrity
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.telemetry import core as tcore
from dmlc_tpu_torch.telemetry import goodput as tgoodput
from dmlc_tpu_torch.telemetry.metric_names import METRIC_NAMES
from dmlc_tpu_torch.telemetry import steps as tsteps
from dmlc_tpu_torch.telemetry import tracecontext as ttrace

BOTH = (jtel, ttel)
H100 = "NVIDIA H100 80GB HBM3"


def _reset_all():
    for tel in BOTH:
        tel.reset()
        tel.reset_steps()
        tel.declare_dtype(None)    # the default ledger's initial state
        tel.reset_events()
        tel.slo.reset_slo()


@pytest.fixture(autouse=True)
def clean_registries():
    """Both packages' process registries and default ledgers start and
    end empty (other tests in the process share them)."""
    _reset_all()
    yield
    _reset_all()


class FakeClock:
    """A ``time`` stand-in whose ``perf_counter`` reads ``now``."""

    def __init__(self, now=100.0):
        self.now = now

    def module(self):
        return types.SimpleNamespace(perf_counter=lambda: self.now,
                                     time=time.time,
                                     monotonic=time.monotonic)


@pytest.fixture
def clock(monkeypatch):
    """One fake clock for both packages' core and step ledger, with the
    span epoch at 0 so span timestamps are equal floats too."""
    clk = FakeClock()
    for mod in (jcore, tcore, jsteps, tsteps):
        monkeypatch.setattr(mod, "time", clk.module())
    monkeypatch.setattr(jcore, "_T0", 0.0)
    monkeypatch.setattr(tcore, "_T0", 0.0)
    return clk


def _strip(rec, keys=("seq",)):
    return {k: v for k, v in rec.items() if k not in keys}


# ---------------------------------------------------------------------------
# core: histograms, registry, exporters, spans, events
# ---------------------------------------------------------------------------

_VALUE_SETS = {
    "uniform": np.random.default_rng(0).uniform(1e-5, 2.0, 500),
    "lognormal": np.random.default_rng(1).lognormal(-6, 2, 2000),
    "one_value": np.array([0.003]),
    "overflow": np.array([1e-7, 0.5, 200.0, 1e3]),
}


@pytest.mark.parametrize("case", sorted(_VALUE_SETS))
@pytest.mark.parametrize("bounds", [None, (0.001, 0.01, 0.1, 1.0)])
def test_histogram_percentiles_and_summaries_match(case, bounds):
    vals = [float(v) for v in _VALUE_SETS[case]]
    hj, ht = jcore.Histogram(bounds), tcore.Histogram(bounds)
    assert ht.bounds == hj.bounds
    for v in vals:
        hj.observe(v)
        ht.observe(v)
    for q in (0, 1, 25, 50, 90, 99, 99.9, 100):
        assert ht.percentile(q) == hj.percentile(q)
    assert ht.summary() == hj.summary()
    assert ht.summary(include_buckets=False) == hj.summary(False)
    # the wire round trip and a merge
    rj = jcore.Histogram.from_dict(hj.summary())
    rt = tcore.Histogram.from_dict(ht.summary())
    rj.merge(hj)
    rt.merge(ht)
    assert rt.summary() == rj.summary()


def _drive_registry(tel, clk):
    tel.inc("serving", "requests")
    tel.inc("serving", "requests", 2)
    tel.inc("feed", "bytes_to_device", 4096)
    tel.set_gauge("step", "mfu_pct", 12.5)
    tel.set_gauge("serving", "draining", 1)
    for v in (1e-4, 3e-3, 0.2, 0.2, 7.0):
        tel.observe("serving", "decode_batch", v)
        tel.observe_duration("step", "time", v)
    with tel.timed("checkpoint", "save"):
        clk.now += 0.25
    tel.observe("serving", "spec_tokens_per_step", 2.0,
                bounds=(1.0, 2.0, 4.0))


def test_registry_snapshot_and_prometheus_text_match(clock):
    for tel in BOTH:
        _drive_registry(tel, clock)
    assert ttel.snapshot() == jtel.snapshot()
    assert ttel.snapshot(False) == jtel.snapshot(False)
    assert ttel.counters_snapshot() == jtel.counters_snapshot()
    assert ttel.export_json() == jtel.export_json()
    text = ttel.to_prometheus_text()
    assert text == jtel.to_prometheus_text()
    labeled = ttel.to_prometheus_text(labels={"rank": 'a"b\\c'})
    assert labeled == jtel.to_prometheus_text(labels={"rank": 'a"b\\c'})
    # the JAX package's strict exposition checker accepts the port's text
    assert jexp.validate_exposition_text(text) > 0
    assert jexp.validate_exposition_text(labeled) > 0
    assert ttel.exporters.validate_exposition_text(text) == \
        jexp.validate_exposition_text(text)


def test_spans_chrome_trace_and_cursor_match(clock):
    other = 1 << 40
    for tel in BOTH:
        cursor = tel.core.span_seq()
        tel.record_span("feed.parse", "feed", t0=1.0, t1=1.5, tid=other,
                        thread="feed-worker", args={"part": 0})
        tel.record_span("checkpoint.save", "checkpoint", t0=2.0, t1=3.25,
                        args={"uri": "/x"})
        clock.now = 4.0
        with tel.span("step", stage="step", args={"n": 1}):
            clock.now = 4.5
            with tel.span("feed.wait", stage="feed"):
                clock.now = 4.75
        got, last = tel.spans_since(cursor, limit=2)
        assert len(got) == 2 and last == got[-1]["seq"]
        rest, last2 = tel.spans_since(last)
        assert len(rest) == 2 and last2 == tel.core.span_seq()
    tj, tt = jtel.spans(), ttel.spans()
    assert [_strip(r) for r in tt] == [_strip(r) for r in tj]
    assert ttel.to_chrome_trace(tt) == jtel.to_chrome_trace(tj)
    assert json.loads(ttel.to_chrome_trace_json(tt)) == \
        json.loads(jtel.to_chrome_trace_json(tj))
    assert ttel.core.now_ts() == jtel.core.now_ts()


def test_events_match():
    for tel in BOTH:
        tel.record_event("corrupt_record", what="crc", where="a @[0,8)",
                         policy="skip")
        tel.record_event("serving_drain_begin", active=2, waiting=1)
    tail = {tel: tel.events_tail(8) for tel in BOTH}
    clocks = ("t", "mono", "seq")
    assert [_strip(e, clocks) for e in tail[ttel]] == \
        [_strip(e, clocks) for e in tail[jtel]]
    lines = ttel.events.to_jsonl(tail[ttel]).splitlines()
    assert [json.loads(x)["kind"] for x in lines] == \
        ["corrupt_record", "serving_drain_begin"]


# ---------------------------------------------------------------------------
# the step ledger
# ---------------------------------------------------------------------------

OTHER_TID = 1 << 41
# (name, stage, t0, t1, on the stepping thread?) inside a step at
# [100, 101] seconds of the fake clock
_LAYOUTS = {
    "feed_checkpoint_collective": [
        ("feed.wait", "feed", 100.0, 100.1, True),
        ("checkpoint.save", "checkpoint", 100.2, 100.45, True),
        ("collective.allreduce", "collective", 100.5, 100.55, True),
    ],
    "overlapped_collectives": [
        ("collective.bucket", "collective", 100.1, 100.6, False),
        ("collective.allreduce", "collective", 100.2, 100.3, False),
        ("collective.join", "collective", 100.5, 100.7, True),
        ("collective.bucket", "collective", 99.5, 100.05, False),
    ],
    "other_threads_feed_ignored": [
        ("feed.parse", "feed", 100.0, 100.9, False),
        ("feed.wait", "feed", 100.1, 100.8, False),
        ("feed.place", "feed", 100.2, 100.3, False),
        ("pipeline.run", "dmlc", 100.3, 100.9, True),
    ],
    "stall_longer_than_the_step": [
        ("feed.wait", "feed", 99.0, 100.8, True),
        ("checkpoint.restore", "checkpoint", 100.1, 100.9, True),
    ],
}


def _ledgered_step(tel, clock, layout, tokens=2048.0):
    """One step through a fresh ledger of ``tel``'s package (the default
    ledgers' declared peaks would leak between tests)."""
    led = tel.StepLedger(peak_flops=1e15)
    led.declare_flops_per_token(3e9)
    clock.now = 100.0
    led.step_begin()
    for name, stage, t0, t1, own in layout:
        tel.record_span(name, stage, t0=t0, t1=t1,
                        tid=None if own else OTHER_TID)
    tel.inc("feed", "bytes_to_device", 65536)
    clock.now = 101.0
    return led, led.step_end(tokens=tokens, tokens_per_step=1.5,
                             spec_accept_rate=0.25)


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_step_ledger_wall_split_matches(clock, layout):
    out = {tel: _ledgered_step(tel, clock, _LAYOUTS[layout])
           for tel in BOTH}
    want, got = out[jtel][1], out[ttel][1]
    assert set(want) <= set(got)
    assert {k: got[k] for k in want if k != "t_wall"} == \
        {k: v for k, v in want.items() if k != "t_wall"}
    # no card: no event, and the host's issue time is the whole wall
    assert got["host_issue_s"] == got["wall_s"] == 1.0
    assert got["event_span_s"] is None
    assert out[ttel][0].summary() == out[jtel][0].summary()
    if layout == "other_threads_feed_ignored":
        assert got["feed_wait_s"] == 0.0 and got["pipeline_span_s"] > 0
    if layout == "overlapped_collectives":
        assert got["collective_overlapped_s"] > 0
    # the registry mirror is the same, family for family
    snap_j, snap_t = jtel.snapshot(), ttel.snapshot()
    assert snap_t["histograms"]["step"] == snap_j["histograms"]["step"]
    assert snap_t["gauges"]["step"] == snap_j["gauges"]["step"]


def test_declared_flops_times_tokens_and_mfu_against_the_h100(
        clock, monkeypatch):
    monkeypatch.setattr(tsteps, "_card_name", lambda: H100)
    monkeypatch.delenv("DMLC_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("DMLC_PEAK_HBM_GBPS", raising=False)
    assert tsteps.detect_peaks("bfloat16") == (989e12, 3350.0e9)
    assert tsteps.detect_peaks("float32") == (67e12, 3350.0e9)
    assert tsteps.detect_peak_flops() == 989e12
    fpt, tokens = ttfm.train_flops_per_token(
        ttfm.TransformerConfig(), 1024), 8192.0
    recs = {}
    # the JAX table names no CUDA card: its ledger is given the peak
    for led in (jsteps.StepLedger(peak_flops=989e12), tsteps.StepLedger()):
        led.declare_dtype("bfloat16")
        led.declare_flops_per_token(fpt)
        clock.now = 10.0
        led.step_begin()
        clock.now = 10.4
        recs[led] = led.step_end(tokens=tokens)
    want, got = recs.values()
    assert got["flops"] == fpt * tokens == want["flops"]
    assert got["mfu"] == want["mfu"]
    assert got["mfu"] == pytest.approx(fpt * tokens / 0.4 / 989e12,
                                       rel=1e-12)
    assert list(recs)[1].peak_membw() == 3350.0e9


def test_unknown_card_reports_no_peak(clock, monkeypatch):
    monkeypatch.delenv("DMLC_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("DMLC_PEAK_HBM_GBPS", raising=False)
    monkeypatch.setattr(tsteps, "_card_name", lambda: "NVIDIA H100 PCIe")
    assert tsteps.detect_peaks("bf16") == (None, None)
    assert tsteps.detect_peak_flops() is None
    led = tsteps.StepLedger()
    led.declare_dtype("bfloat16")
    led.declare_flops_per_token(1e9)
    led.step_begin()
    clock.now += 0.5
    rec = led.step_end(tokens=100.0)
    assert rec["flops"] == 1e11 and rec["mfu"] is None
    # an operator's statement wins; a typo mutes MFU, never a step
    monkeypatch.setenv("DMLC_PEAK_FLOPS", "2e14")
    assert tsteps.detect_peak_flops() == 2e14
    monkeypatch.setenv("DMLC_PEAK_FLOPS", "fast")
    assert tsteps.detect_peak_flops() is None
    assert tsteps.detect_peaks("bf16") == (None, None)


def test_no_card_calibrates_the_cpu(monkeypatch):
    monkeypatch.delenv("DMLC_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("DMLC_PEAK_HBM_GBPS", raising=False)
    monkeypatch.setattr(tsteps, "_card_name", lambda: None)
    flops, bw = tsteps.detect_peaks("f32")
    assert flops > 0 and bw > 0
    assert tsteps.detect_peak_flops() is None   # no card, no table row


def test_abandoned_step_unwinds(clock):
    depth = {}
    for tel in BOTH:
        led = tel.StepLedger(peak_flops=1e15)
        base = len(tel.core._span_stack())
        led.step_begin()
        clock.now += 1.0
        led.step_begin()             # the first step raised: abandoned
        clock.now += 0.5
        rec = led.step_end(tokens=10.0)
        depth[tel] = len(tel.core._span_stack()) - base
        assert rec["seq"] == 1 and rec["wall_s"] == 0.5
        assert led.step_end() is None          # nothing open any more
        assert len(led.records()) == 1
        out, last = led.records_since(0)
        assert len(out) == 1 and last == 1
    assert depth[ttel] == depth[jtel] == 0


# ---------------------------------------------------------------------------
# request ledger, SLO monitor, availability, trace context
# ---------------------------------------------------------------------------

def _request_story(tel, now):
    """One event sequence through a RequestLedger + SLOMonitor: slow and
    fast TTFTs, bursts of tokens, a preempt/resume, failures with a
    known and an unknown reason."""
    mon = tel.SLOMonitor(ttft_p99_s=0.5, tbt_p99_s=0.1, error_rate=0.2,
                         fast_window_s=60.0, slow_window_s=300.0,
                         min_eval_interval_s=0.0)
    led = tel.RequestLedger(slo=mon, trace_rows=True)
    t = 1000.0
    for i in range(8):
        rid = 100 + i
        led.on_submit(rid, n_prompt=10 + i, max_new_tokens=16, t=t)
        led.on_prefill_begin(rid, t=t + 0.05 * i)
        led.on_first_token(rid, t=t + 0.1 + 0.15 * i)
        for k in range(3):
            led.on_token(rid, t=t + 1.0 + 0.2 * k + 0.01 * i,
                         n=1 + (k == 1) * 2)
        if i == 3:
            led.on_preempt(rid, t=t + 2.0)
            led.on_prefill_begin(rid, t=t + 2.1, resume=True)
            led.on_prefill_end(rid, t=t + 2.3)
            led.on_token(rid, t=t + 2.4)
        led.on_iteration(active=4, waiting=i, preempted=int(i == 3),
                         tokens=5, kv_stats={"blocks_in_use": 7,
                                             "n_blocks": 64,
                                             "occupancy": 7 / 64,
                                             "waste_tokens": 3,
                                             "cached_tokens": 99})
        error = reason = None
        if i in (5, 6):
            error, reason = "boom", ("crash" if i == 5 else "weird")
        led.on_finish(rid, error=error, reason=reason, t=t + 3.0)
        t += 0.5
    led.on_submit(999, n_prompt=4, t=t)        # still live
    led.on_token(12345)                        # unknown ids are ignored
    evaluated = mon.evaluate(now)
    return led, mon, evaluated


def test_request_ledger_and_slo_monitor_match():
    now = time.monotonic() + 1.0
    (lj, mj, ej), (lt, mt, et) = (_request_story(tel, now) for tel in BOTH)
    assert lt.summary() == lj.summary()
    walls = ("submit_wall", "t_wall", "age_s")
    rj, rt = lj.report(), lt.report()
    assert rt["summary"] == rj["summary"]
    assert [_strip(r, walls) for r in rt["recent"]] == \
        [_strip(r, walls) for r in rj["recent"]]
    assert [_strip(r, walls) for r in rt["live"]] == \
        [_strip(r, walls) for r in rj["live"]]
    assert [_strip(r, walls) for r in rt["iterations"]] == \
        [_strip(r, walls) for r in rj["iterations"]]
    assert lt.records_since(2, limit=3)[1] == lj.records_since(2, limit=3)[1]
    assert et == ej
    assert et["ttft_p99"]["violating"] and et["tbt_p99"]["violating"]

    def slo_doc(mon):
        doc = mon.report()
        doc["active_since"] = sorted(doc["active_since"])
        doc["recent_violations"] = [_strip(v, ("t",))
                                    for v in doc["recent_violations"]]
        return doc

    assert slo_doc(mt) == slo_doc(mj)
    assert mt.active() == mj.active()
    assert _strip(mt.status(), ("t",)) == _strip(mj.status(), ("t",))
    assert mt.prometheus_text() == mj.prometheus_text()
    assert jexp.validate_exposition_text(mt.prometheus_text()) > 0
    # the registry families the ledgers drove are the same
    snap_j, snap_t = jtel.snapshot(), ttel.snapshot()
    for part in ("counters", "histograms"):
        assert snap_t[part]["serving"] == snap_j[part]["serving"]
    assert snap_t["counters"]["slo"] == snap_j["counters"]["slo"]


def test_availability_ledger_fractions_match(monkeypatch):
    clk = FakeClock(50.0)
    for mod in (jgoodput, tgoodput):
        monkeypatch.setattr(mod, "time", clk.module())
    ledgers = [jgoodput.AvailabilityLedger(), tgoodput.AvailabilityLedger()]
    assert tgoodput.AVAILABILITY_STATES == jgoodput.AVAILABILITY_STATES
    for state, dt, tokens in (("starved_idle", 1.0, 0), ("serving", 2.0, 300),
                              ("serving", 0.75, 500),
                              ("crashed_recovering", 0.5, 0),
                              ("draining", 1.25, 40)):
        for led in ledgers:
            led.set_state(state)
        clk.now += dt
        for led in ledgers:
            led.note_tokens(tokens)
    rj, rt = (led.report() for led in ledgers)
    assert rt == rj
    assert sum(rt["fractions"].values()) == pytest.approx(1.0, abs=1e-12)
    assert ledgers[1].prometheus_text() == ledgers[0].prometheus_text()
    with pytest.raises(ValueError):
        ledgers[1].set_state("asleep")


def test_trace_header_helpers_match(monkeypatch):
    assert ttrace.TRACE_HEADER == jtrace.TRACE_HEADER
    for rid in ("a", "req-42", "été"):
        assert ttrace.mint_trace_id(rid) == jtrace.mint_trace_id(rid)
    tid = ttrace.mint_trace_id("x")
    span = ttrace.new_span_id()
    hdr = ttrace.format_header(tid, span)
    assert hdr == jtrace.format_header(tid, span)
    for value in (hdr, hdr.upper(), " " + hdr, "nope", None, tid, 7):
        assert ttrace.parse_header(value) == jtrace.parse_header(value)
    for env in ("1", "0", None):
        if env is None:
            monkeypatch.delenv("DMLC_TRACE_FLEET", raising=False)
        else:
            monkeypatch.setenv("DMLC_TRACE_FLEET", env)
        assert ttrace.enabled() == jtrace.enabled()


# ---------------------------------------------------------------------------
# the layers that feed the ledger: train step, feed, checkpoint, integrity
# ---------------------------------------------------------------------------

TINY = dict(vocab=64, d_model=32, n_heads=2, head_dim=8, d_ff=64,
            n_layers=2, n_experts=1)


def test_train_step_drives_the_ledger():
    cfg = ttfm.TransformerConfig(**TINY)
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    labels = ids.roll(-1, 1)
    models = [ttfm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
              for _ in range(2)]
    ledgered = ttfm.make_train_step(models[0])
    bare = ttfm.make_train_step(models[1], ledger=False)
    losses = [(float(ledgered(ids, labels)), float(bare(ids, labels)))
              for _ in range(3)]
    assert all(a == b for a, b in losses)      # the ledger changes nothing
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(p, q)
    recs = ttel.ledger().records()
    assert len(recs) == 3                      # the bare step records none
    jcfg = jtfm.TransformerConfig(**TINY)
    want = jtfm.train_step_flops(jcfg, 2, 16)
    for r in recs:
        assert r["tokens"] == 32.0 and r["flops"] == want
        assert r["host_issue_s"] == r["wall_s"] > 0
        assert r["mfu"] is not None
    assert ttel.ledger().summary()["steps"] == 3


def _feed_source(n_batches, rows=2, width=4, key=0):
    def it():
        for i in range(n_batches):
            yield {"x": np.full((rows, width), key * 100 + i, np.int32)}
    return it


def test_feed_spans_counters_and_the_ledger_feed_wait():
    """``feed.wait`` runs on the consumer's thread and is the ledger's
    feed-wait; the producers' spans run on other threads and are not
    billed; the counters agree with the feed's own stats."""
    feed = DeviceFeed([_feed_source(5, key=p) for p in range(2)],
                      device="cpu", num_workers=2, queue_depth=2)
    me = threading.get_ident()
    n, waits = 0, []
    try:
        it = iter(feed)
        while True:
            before = feed.stats()["wait_s"]
            ttel.step_begin()
            batch = next(it, None)
            rec = ttel.step_end(tokens=4.0)
            if batch is None:
                break
            waits.append((rec["feed_wait_s"],
                          feed.stats()["wait_s"] - before))
            n += 1
    finally:
        feed.close()
    assert n == 5
    for ledger_wait, feed_wait in waits:
        # the span wraps the block the feed's own clock times
        assert ledger_wait >= feed_wait >= 0.0
    spans = ttel.spans()
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], set()).add(s["tid"])
    assert by_name["feed.wait"] == {me}
    for name in ("feed.parse", "feed.stage", "feed.place", "feed.assemble"):
        assert name in by_name and me not in by_name[name], name
    stats = feed.stats()
    counters = ttel.counters_snapshot()["feed"]
    assert counters["batches"] == stats["batches"] == 5
    assert counters["bytes_to_device"] == stats["bytes_to_device"]
    assert ttel.snapshot()["gauges"]["feed"]["staging_pool_bytes"] > 0


def test_checkpoint_spans_counters_and_stall_in_a_step(tmp_path):
    tree = {"w": torch.arange(64, dtype=torch.float32),
            "b": np.arange(8, dtype=np.int64)}
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    ttel.step_begin()
    mgr.save(1, tree)
    rec = ttel.step_end()
    save_spans = [s for s in ttel.spans() if s["name"] == "checkpoint.save"]
    assert len(save_spans) == 1
    assert rec["checkpoint_stall_s"] == pytest.approx(
        save_spans[0]["dur"] / 1e6, rel=1e-9)
    assert 0 < rec["checkpoint_stall_s"] <= rec["wall_s"]
    step, back = mgr.restore_latest(tree)
    assert step == 1 and torch.equal(back["w"], tree["w"])
    c = ttel.counters_snapshot()["checkpoint"]
    assert c["saves"] == 1 and c["restores"] == 1
    assert c["bytes_written"] == c["bytes_read"] == 64 * 4 + 8 * 8
    hist = ttel.snapshot()["histograms"]["checkpoint"]
    assert hist["save_secs"]["count"] == hist["restore_secs"]["count"] == 1
    # a flipped shard: counted, an event, and CorruptCheckpoint
    path = tmp_path / "bad"
    save_pytree(str(path), tree)
    shard = next(p for p in path.iterdir() if p.name.startswith("w."))
    raw = bytearray(shard.read_bytes())
    raw[0] ^= 0xFF
    shard.write_bytes(bytes(raw))
    with pytest.raises(CorruptCheckpoint):
        restore_pytree(str(path), tree)
    assert ttel.counters_snapshot()["integrity"]["checksum_failures"] == 1
    assert ttel.events_tail(1)[0]["kind"] == "checkpoint_shard_corrupt"


@pytest.mark.parametrize("policy", ["skip", "quarantine"])
def test_integrity_counters_and_events_match(monkeypatch, policy):
    monkeypatch.setenv("DMLC_INTEGRITY_POLICY", policy)
    for mod in (jintegrity, tintegrity):
        mod.reset_quarantine()
        try:
            for begin in (0, 64, 64):
                mod.handle_corrupt("crc mismatch", source="s.rec",
                                   begin=begin, end=begin + 32)
            for begin in (0, 1, 64):
                mod.should_drop("s.rec", begin)
        finally:
            mod.reset_quarantine()
    assert ttel.counters_snapshot()["integrity"] == \
        jtel.counters_snapshot()["integrity"]
    keep = ("kind", "what", "where", "policy", "source", "begin", "end")
    tail_j = [{k: e[k] for k in keep if k in e} for e in jtel.events_tail()]
    tail_t = [{k: e[k] for k in keep if k in e} for e in ttel.events_tail()]
    assert tail_t == tail_j


def test_port_families_here_are_registered(clock):
    """Every metric family the port's registry holds after this file's
    calls is a registered name of the port's own contract."""
    _drive_registry(ttel, clock)
    _ledgered_step(ttel, clock, _LAYOUTS["feed_checkpoint_collective"])
    snap = ttel.snapshot()
    names = {f"dmlc_{stage}_{name}" for part in ("counters", "gauges",
                                                 "histograms")
             for stage, vals in snap[part].items() for name in vals}
    assert names and names <= METRIC_NAMES, names - METRIC_NAMES


#: names only the port emits (each also stands under its own commented
#: block in the port's ``metric_names``): the bytes a gloo point-to-point
#: of a CUDA tensor stages through pinned host memory.  Spelled in two
#: pieces: the JAX package's metric-name lint reads the literals of
#: tests/ against the JAX registry, which lacks this family.
PORT_ONLY_NAMES = frozenset({"dmlc_" + "collective_ppermute_staged_bytes"})


def test_metric_name_registry_equals_jax():
    """The port's registry is the JAX package's, set for set, plus the
    port-only names listed above."""
    from dmlc_tpu.telemetry import metric_names as jnames
    from dmlc_tpu_torch.telemetry import metric_names as pnames

    assert PORT_ONLY_NAMES <= pnames.METRIC_NAMES
    assert pnames.METRIC_NAMES - PORT_ONLY_NAMES == jnames.METRIC_NAMES
    assert pnames.SPAN_ANNOTATIONS == jnames.SPAN_ANNOTATIONS
    assert pnames.NON_METRIC_TOKENS == jnames.NON_METRIC_TOKENS
    assert pnames.__all__ == jnames.__all__
    assert ttel.metric_names is pnames
