"""The port's flight recorder (``telemetry.flight``) and the telemetry
its tracker serves, against the JAX package's.

The same ingests go through both ``FlightRecorder`` classes — the JAX
package's flight-recorder test inputs (``tests/test_flight_recorder.py``:
clock samples, skewed ranks, dedup, restart, garbage, renumbering with
request rows, the per-rank bound, the tracker's own row, anomaly
markers) and seeded random streams — and the merged Chrome traces are
compared exactly after every call.

At the tracker level, a JAX and a port ``RabitTracker`` receive the same
heartbeat payloads over the wire and serve the same ``/trace``,
``/anomalies``, ``/compute`` and ``/incidents`` documents and the same
``dmlc_anomaly_*`` lines on ``/metrics``, with the wall clocks of the
modules that stamp them pinned to one instant; ``scripts/dmlc_top.py``
renders the same panes from either.  A 2-rank job of port workers runs
end to end against the port's tracker."""

import copy
import importlib.util
import json
import re
import threading
import time
import types
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import dmlc_tpu.telemetry as jtel
import dmlc_tpu.tracker as jtr
import dmlc_tpu_torch.telemetry as ptel
import dmlc_tpu_torch.tracker as ptr
from dmlc_tpu.telemetry import tracecontext as jtc
from dmlc_tpu_torch.telemetry import tracecontext as ptc
from dmlc_tpu.telemetry import anomaly as janom
from dmlc_tpu.telemetry import core as jcore
from dmlc_tpu.telemetry import events as jevents
from dmlc_tpu.telemetry import flight as jflight
from dmlc_tpu.telemetry import forensics as jfor
from dmlc_tpu.telemetry import goodput as jgp
from dmlc_tpu.telemetry.requests import REQUEST_ROW_TID_BASE
from dmlc_tpu_torch.telemetry import anomaly as panom
from dmlc_tpu_torch.telemetry import core as pcore
from dmlc_tpu_torch.telemetry import events as pevents
from dmlc_tpu_torch.telemetry import flight as pflight
from dmlc_tpu_torch.telemetry import forensics as pfor
from dmlc_tpu_torch.telemetry import goodput as pgp
from dmlc_tpu_torch.telemetry.exporters import validate_exposition_text

ROOT = Path(__file__).resolve().parents[1]
T_FIXED = 1_700_000_000.25


@pytest.fixture(autouse=True)
def fresh_telemetry():
    for tel in (jtel, ptel):
        tel.reset()
        tel.reset_events()
    yield
    for tel in (jtel, ptel):
        tel.reset()
        tel.reset_events()


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def _same(j, p):
    assert p.to_chrome_trace() == j.to_chrome_trace()
    assert p.to_chrome_trace_json() == j.to_chrome_trace_json()
    assert p.span_counts() == j.span_counts()
    assert p.ranks() == j.ranks()
    assert p.clock.snapshot() == j.clock.snapshot()


def _run(ops, **kw):
    """One JAX and one port FlightRecorder through ``ops`` (``(method,
    *args)``, each argument a fresh copy per package), compared after
    every call.  Returns the port's recorder."""
    recs = (jflight.FlightRecorder(**kw), pflight.FlightRecorder(**kw))
    for name, *args in ops:
        for fr in recs:
            getattr(fr, name)(*copy.deepcopy(args))
        _same(*recs)
    return recs[1]


def _ship(rank, anchor, offset, names, step_s=1.0, seq0=0):
    spans = [{"name": n, "ts": i * step_s * 1e6, "dur": 1000.0,
              "tid": 7, "seq": seq0 + i + 1, "cat": "t",
              "thread": f"w{rank}"}
             for i, n in enumerate(names)]
    return ("ingest", rank, {
        "anchor": anchor, "seq": seq0 + len(names), "spans": spans,
        "clock": {"offset_s": offset, "rtt_s": 0.001}}, f"host{rank}")


def _request_rows():
    ops = []
    for r in (0, 1, 2):
        spans = [{"name": f"req.r{r}", "ts": 1.0, "dur": 5.0,
                  "tid": REQUEST_ROW_TID_BASE + 100 + r, "seq": 1,
                  "cat": "serving", "thread": f"req {100 + r}",
                  "args": {"trace_id": f"{r:032x}"}}]
        ops.append(("ingest", r, {"anchor": 100.0 + r, "spans": spans,
                                  "clock": {"offset_s": float(r),
                                            "rtt_s": 0.001}},
                    f"host{r}"))
    ops.append(("remap_ranks", {0: 0, 2: 1}))
    ops.append(("ingest", 1, {"anchor": 102.0, "spans": [
        {"name": "req.r2", "ts": 1.0, "dur": 5.0,
         "tid": REQUEST_ROW_TID_BASE + 102, "seq": 1,
         "args": {"trace_id": f"{2:032x}"}}]}))
    return ops


# The JAX package's flight-recorder test inputs: (kwargs, ops, the
# port's span names by pid at the end).
SCENARIOS = {
    "skewed_ranks_interleave": ({}, [
        _ship(0, 1000.0, 0.0, ["a0", "a1"], step_s=2.0),
        _ship(1, 901.0, 100.0, ["b0", "b1"], step_s=2.0)],
        {1: ["a0", "a1"], 2: ["b0", "b1"]}),
    "within_rtt_of_true_skew": ({}, [
        _ship(0, 500.0 - 3.0, 3.0 + 0.004, ["x"]),
        _ship(1, 500.0 + 7.0, -7.0 - 0.004, ["y"])], {1: ["x"], 2: ["y"]}),
    "dedup_and_bound": (dict(max_spans_per_rank=8), [
        _ship(0, 100.0, 0.0, ["s0", "s1"]),
        _ship(0, 100.0, 0.0, ["s0", "s1"]),
        _ship(0, 100.0, 0.0, [f"t{i}" for i in range(20)], seq0=2)],
        {1: [f"t{i}" for i in range(12, 20)]}),
    "restart_resets_rank": ({}, [
        _ship(0, 100.0, 5.0, ["old0", "old1"]),
        _ship(0, 333.0, 0.5, ["new0"])], {1: ["new0"]}),
    "restart_resets_clock": ({}, [
        ("ingest", 0, {"anchor": 100.0, "spans": [],
                       "clock": {"offset_s": 5.0, "rtt_s": 0.0001}}),
        ("ingest", 0, {"anchor": 200.0, "spans": [],
                       "clock": {"offset_s": -2.0, "rtt_s": 0.5}})], {}),
    "remap_moves_request_rows": ({}, _request_rows(),
                                 {1: ["req.r0"], 2: ["req.r2"]}),
    "garbage": ({}, [
        ("ingest_json", 0, "{not json"),
        ("ingest_json", 0, json.dumps({"trace": {"spans": "nope"}})),
        ("ingest_json", 0, json.dumps({"trace": {"anchor": "NaNope",
                                                 "spans": []}})),
        ("ingest_json", 0, json.dumps([1])),
        ("ingest_json", 1, json.dumps(
            {"trace": {"anchor": 1.0,
                       "spans": [{"bogus": 1}, "str", None,
                                 {"name": "ok", "ts": 0.0, "dur": 1.0,
                                  "tid": 1, "seq": 1},
                                 {"name": "bad", "ts": "x", "dur": 1.0,
                                  "tid": 1, "seq": 2}]}})),
        ("ingest", -1, {"anchor": 1.0, "spans": []}),
        ("ingest", 2, "not a dict"),
        ("ingest", 2, {"anchor": 3.0, "spans": [], "clock": {"rtt_s": 1}})],
        {2: ["ok"]}),
    "drop_forgets_store_and_clock": ({}, [
        _ship(0, 100.0, 1.0, ["a"]), _ship(1, 100.0, 2.0, ["b"]),
        ("drop", 0), ("drop", 9)], {2: ["b"]}),
    "seqless_spans_always_kept": ({}, [
        ("ingest", 0, {"anchor": 50.0, "spans": [
            {"name": "n", "ts": 1.0, "dur": 1.0, "tid": 3}]}),
        ("ingest", 0, {"anchor": 50.0, "spans": [
            {"name": "n", "ts": 1.0, "dur": 1.0, "tid": 3}]})],
        {1: ["n", "n"]}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_recorder_scenarios_equal_jax(name):
    kw, ops, want = SCENARIOS[name]
    fr = _run(ops, **kw)
    by_pid = {}
    for e in fr.to_chrome_trace()["traceEvents"]:
        if e["ph"] == "X":
            by_pid.setdefault(e["pid"], []).append(e["name"])
    assert by_pid == want


def test_skewed_ranks_corrected_as_jax():
    """The reference's interleave, read off the port alone: corrected
    order a0 < b0 < a1 < b1, 1 s apart, rebased to 0, labelled rows."""
    fr = _run(SCENARIOS["skewed_ranks_interleave"][1])
    doc = fr.to_chrome_trace()
    evs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    order = sorted(evs, key=lambda n: evs[n]["ts"])
    assert order == ["a0", "b0", "a1", "b1"]
    assert [evs[n]["ts"] for n in order] == [0.0, 1e6, 2e6, 3e6]
    meta = {(e["pid"], e["name"]): e for e in doc["traceEvents"]
            if e["ph"] == "M"}
    assert meta[(2, "process_name")]["args"]["name"] == "rank 1 (host1)"
    assert fr.clock.offset(1) == 100.0


def test_tracker_row_and_markers_equal_jax(monkeypatch):
    """The tracker's own spans ride along at pid 0 and the watchdog's
    verdicts land as instant markers; both anchors pinned."""
    monkeypatch.setattr(jcore, "anchor_epoch", lambda: 995.0)
    monkeypatch.setattr(pcore, "anchor_epoch", lambda: 995.0)
    local = [{"name": "tracker.side", "ts": 2.5e6, "dur": 10.0, "tid": 1,
              "thread": "MainThread", "cat": "t", "args": {"k": 1}}]
    markers = [{"t": 1001.5, "name": "anomaly:straggler rank 0"},
               {"t": 10.0, "name": "anomaly:early"}]
    recs = []
    for mod in (jflight, pflight):
        fr = mod.FlightRecorder(local_spans=lambda: local)
        fr.marker_source = lambda: markers
        fr.ingest(*copy.deepcopy(_ship(0, 1000.0, 0.0, ["w"])[1:]))
        recs.append(fr)
    _same(*recs)
    evs = recs[1].to_chrome_trace()["traceEvents"]
    assert {e["pid"] for e in evs if e["ph"] == "X"} == {
        pflight.TRACKER_PID, 1}
    inst = [e for e in evs if e["ph"] == "i"]
    assert [(e["name"], e["ts"]) for e in inst] == [
        ("anomaly:straggler rank 0", 4e6), ("anomaly:early", 0.0)]

    def boom():
        raise RuntimeError("source down")

    for fr in recs:   # failing sources never fail the render
        fr._local_spans = boom
        fr.marker_source = boom
    _same(*recs)


def test_span_bound_knob_read_as_jax(monkeypatch):
    monkeypatch.setenv("DMLC_TRACE_MAX_SPANS_PER_RANK", "5")
    fr = _run([_ship(0, 100.0, 0.0, [f"s{i}" for i in range(9)])])
    assert fr.max_spans_per_rank == 5 and fr.span_counts() == {0: 5}


def _random_ops(seed, n_ranks=5, n_beats=40):
    """Seeded beats: random spans (ts, dur, tid, thread, args), clock
    samples with varying rtt, re-shipped and overlapping seq ranges,
    garbage records, a restart, an elastic remap and a drop."""
    rng = np.random.default_rng(seed)
    seq = {r: 0 for r in range(n_ranks)}
    anchor = {r: float(rng.uniform(900, 1100)) for r in range(n_ranks)}
    ranks = list(range(n_ranks))
    ops = []
    for b in range(n_beats):
        r = int(rng.choice(ranks))
        if b == n_beats // 3:
            anchor[r] += 50.0   # a restarted process: seq from 1 again
            seq[r] = 0
        lo = max(0, seq[r] - int(rng.integers(0, 4)))   # overlap re-ship
        spans = []
        for s in range(lo + 1, lo + 1 + int(rng.integers(1, 12))):
            rec = {"name": f"op{int(rng.integers(6))}",
                   "ts": float(rng.uniform(0, 5e7)),
                   "dur": float(rng.uniform(0, 1e5)),
                   "tid": int(rng.integers(1, 4)), "seq": s,
                   "cat": str(rng.choice(["train", "feed", "collective"]))}
            if rng.random() < 0.5:
                rec["thread"] = f"t{rec['tid']}"
            if rng.random() < 0.3:
                rec["args"] = {"step": int(rng.integers(100))}
            if rng.random() < 0.05:
                del rec["ts"]   # malformed: skipped by both
            spans.append(rec)
        seq[r] = max(seq[r], spans[-1]["seq"])
        trace = {"anchor": anchor[r], "seq": seq[r], "spans": spans}
        if rng.random() < 0.8:
            trace["clock"] = {"offset_s": float(rng.normal(0, 2)),
                              "rtt_s": float(rng.uniform(1e-4, 1e-2))}
        ops.append(("ingest", r, trace, f"host{r % 2}"))
        if b == 2 * n_beats // 3:   # elastic shrink: rank 1 leaves
            mapping = {old: new for new, old in
                       enumerate(q for q in ranks if q != 1)}
            ops.append(("remap_ranks", mapping))
            ranks = sorted(mapping.values())
            seq = {mapping[q]: v for q, v in seq.items() if q in mapping}
            anchor = {mapping[q]: v for q, v in anchor.items()
                      if q in mapping}
    ops.append(("drop", ranks[-1]))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recorder_random_streams_equal_jax(seed):
    fr = _run(_random_ops(seed), max_spans_per_rank=64)
    assert fr.ranks() and max(fr.span_counts().values()) <= 64


# ---------------------------------------------------------------------------
# the trackers: the same beats, the same documents
# ---------------------------------------------------------------------------

def _beat(rank, rnd):
    """Rank ``rank``'s beat of round ``rnd``: a snapshot, a trace with
    spans, step records and a clock sample, and the selfheal, compute and
    goodput sub-docs.  Rank 2 is a straggler from round 1 (and so
    regresses against its own baseline); its compile ledger storms in
    round 1 only; rank 0's self-heal guard skipped and rolled back."""
    steps = [{"seq": 8 * rnd + i + 1,
              "wall_s": (0.05 if rank == 2 and rnd else 0.01)
              * (1 + 0.01 * i),
              "feed_wait_s": 0.001 * i, "collective_s": 0.002,
              "compute_s": 0.007, "t_wall": T_FIXED - 40 + 8 * rnd + i,
              "goodput_tokens_per_s": 4096.0 / (0.01 + 0.001 * rank),
              "mfu": 0.3 + 0.01 * rank}
             for i in range(8)]
    spans = [{"name": "train.step", "ts": (8 * rnd + i) * 1e6,
              "dur": 9000.0 + rank, "tid": 1, "seq": 8 * rnd + i + 1,
              "cat": "train", "thread": "MainThread",
              "args": {"step": 8 * rnd + i + 1}} for i in range(8)]
    doc = {"counters": {"train": {"steps": 8.0 * (rnd + 1)}},
           "gauges": {}, "histograms": {},
           "trace": {"anchor": T_FIXED - 60 + rank, "seq": 8 * (rnd + 1),
                     "spans": spans, "steps": steps,
                     "step_seq": 8 * (rnd + 1),
                     "clock": {"offset_s": 0.01 * rank, "rtt_s": 0.002}},
           "compute": {"traces": 1 + rnd, "hits": 8 * rnd, "recompiles": rnd,
                       "hbm_peak_bytes": 1 << 30,
                       "storm": {"active": rank == 2 and rnd == 1,
                                 "sites": [{"site": "train.step"}]}},
           "goodput": {"anchor": T_FIXED - 60 + rank, "t": T_FIXED,
                       "wall_s": 60.0,
                       "buckets": {"productive": 50.0, "resize": 6.0,
                                   "checkpoint_save": 4.0},
                       "tokens": 1e6, "in_step_s": 50.0,
                       "effective_tokens_per_s": 1e6 / 60,
                       "in_step_tokens_per_s": 1e6 / 50,
                       "current": "productive", "goodput_fraction": 5 / 6,
                       "window": {"wall_s": 30.0, "tokens": 5e5,
                                  "effective_tokens_per_s": 5e5 / 30,
                                  "in_step_tokens_per_s": 2e4},
                       "intervals": [
                           {"bucket": "resize", "t0": T_FIXED - 3.0,
                            "t1": T_FIXED - 1.0, "dur_s": 2.0, "seq": 1},
                           {"bucket": "checkpoint_save",
                            "t0": T_FIXED - 100.0, "t1": T_FIXED - 96.0,
                            "dur_s": 4.0, "seq": 2}]}}
    if rank == 0:
        doc["selfheal"] = {"last_action": "rollback", "reason": "nonfinite",
                           "step": 21, "skips": 2, "rollbacks": 1,
                           "t": T_FIXED - 5}
    return json.dumps(doc)


@pytest.fixture
def pinned(monkeypatch):
    """The modules that stamp wall time in these documents read one
    instant; both event rings number from 1."""
    clock = types.SimpleNamespace(time=lambda: T_FIXED,
                                  monotonic=time.monotonic,
                                  perf_counter=time.perf_counter)
    for mod in (janom, panom, jfor, pfor, jgp, pgp, jevents, pevents):
        monkeypatch.setattr(mod, "time", clock)
    for mod in (jevents, pevents):
        monkeypatch.setattr(mod, "_seq", 0)


def _feed(kind, rounds=3, ranks=3):
    mod = jtr if kind == "jax" else ptr
    tracker = mod.RabitTracker("127.0.0.1", ranks, metrics_port=0)
    tracker.start(ranks)
    for rnd in range(rounds):
        for rank in range(ranks):
            c = ptr.TrackerClient("127.0.0.1", tracker.port, jobid="beat")
            c.rank = rank
            c.send_metrics(_beat(rank, rnd))
    # the tracker replies to a beat before it ingests it: wait until the
    # watchdog, the last to take a beat, holds every rank's last step
    want = {str(r): 8 * rounds for r in range(ranks)}
    deadline = time.monotonic() + 30
    while {r: st["last_step_seq"] for r, st in
           tracker.watchdog.report()["ranks"].items()} != want:
        assert time.monotonic() < deadline, "beats never ingested"
        time.sleep(0.005)
    return tracker


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        body = r.read()
    return body.decode() if path == "/metrics" else json.loads(body)


def _anomaly_lines(text):
    return [ln for ln in text.splitlines()
            if re.match(r"(# (HELP|TYPE) )?dmlc_anomaly_", ln)]


def _load_top():
    spec = importlib.util.spec_from_file_location(
        "top_view_port_fixture", ROOT / "scripts" / "dmlc_top.py")
    top = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(top)
    return top


def _reset_process_rings():
    """Both packages' span and event rings and their process-wide
    decision logs: each tracker's incident reporter reads its package's
    decision log, which other tests of the same process fill."""
    for tel in (jtel, ptel):
        tel.reset()
        tel.reset_events()
    for tc in (jtc, ptc):
        tc.reset_decisions()


def test_trackers_serve_the_same_documents(pinned):
    """Two trackers, the same beats over the wire: the same /anomalies,
    /compute, /incidents and /trace, the same anomaly lines on /metrics,
    and the same dmlc-top panes."""
    _same_documents()


def test_trackers_serve_the_same_documents_after_a_fleet_decision(pinned):
    """A fleet decision left in the port's process-wide decision log by
    an earlier test (as another file's autoscaler tests leave one under
    one xdist worker) does not reach the comparison."""
    ptc.record_decision("autoscale_verdict", action="scale_up",
                        reason="utilization", replicas=2, target=3)
    _same_documents()


def _same_documents():
    top = _load_top()
    docs = {}
    for kind in ("jax", "port"):
        _reset_process_rings()
        tracker = _feed(kind)
        base = f"http://127.0.0.1:{tracker.metrics_port}"
        try:
            docs[kind] = {p: _get(base, p) for p in (
                "/anomalies", "/compute", "/incidents", "/trace",
                "/goodput", "/metrics")}
            poll = top.fetch(base)
        finally:
            tracker.close()
        poll["healthz"] = {}   # heartbeat ages are the wall's, not the beats'
        docs[kind]["top"] = top.render_table(poll).splitlines()[1:]
    want, got = docs["jax"], docs["port"]
    for path in ("/anomalies", "/compute", "/incidents", "/goodput"):
        assert got[path] == want[path], (
            f"{path} differs; port: {json.dumps(got[path], sort_keys=True)}"
            f" jax: {json.dumps(want[path], sort_keys=True)}")
    # the tracker's own row is its package's span ring: neither recorded
    # a span here, and the workers' rows are compared whole
    for d in (want, got):
        assert not [e for e in d["/trace"]["traceEvents"]
                    if e["ph"] == "X" and e["pid"] == 0]
    assert got["/trace"] == want["/trace"]
    assert _anomaly_lines(got["/metrics"]) == _anomaly_lines(want["/metrics"])
    assert got["top"] == want["top"]

    # and what they say, read off the port's
    an = got["/anomalies"]
    assert {r: st["steps"] for r, st in an["ranks"].items()} == {
        "0": 24, "1": 24, "2": 24}
    assert an["ranks"]["2"]["flags"] == ["regression", "straggler"]
    assert an["ranks"]["0"]["remediation"]["rollbacks"] == 1
    assert got["/compute"]["storming_ranks"] == []
    assert got["/compute"]["ranks"]["2"]["recompiles"] == 2
    incidents = got["/incidents"]["incidents"]
    assert [i["kinds"] for i in incidents] == [["resize"],
                                               ["checkpoint_save"]]
    assert incidents[0]["ranks"] == [0, 1, 2]
    assert incidents[0]["badput_s"] == 6.0
    assert [e["kind"] for e in incidents[0]["events"]] == ["anomaly"] * 3
    assert incidents[0]["anomalies"] == [
        {"kind": "regression", "rank": 2}, {"kind": "straggler", "rank": 2}]
    pids = {e["pid"] for e in got["/trace"]["traceEvents"] if e["ph"] == "X"}
    assert pids == {1, 2, 3}
    assert any(e["ph"] == "i" and e["name"] == "anomaly:straggler rank 2"
               for e in got["/trace"]["traceEvents"])
    text = got["/metrics"]
    assert validate_exposition_text(text) > 0
    assert 'dmlc_anomaly_active{rank="2",kind="straggler"} 1' in text
    assert 'dmlc_anomaly_straggler_flags{rank="tracker"} 1' in text
    assert any(ln.startswith("    2 ") and "straggler" in ln
               for ln in got["top"])
    assert any("rollback@21" in ln for ln in got["top"])
    assert any(ln.startswith("incident inc-") for ln in got["top"])


def test_tracker_drops_a_dead_ranks_baselines(pinned):
    """A rank declared dead loses its watchdog state at once (its
    replacement's baselines start over); its spans stay on /trace."""
    tracker = _feed("port", rounds=1)
    try:
        assert "1" in tracker.watchdog.report()["ranks"]
        tracker._declare_dead(1, 9.0)
        assert "1" not in tracker.watchdog.report()["ranks"]
        assert tracker.flight.ranks() == [0, 1, 2]
        assert tracker.telemetry.healthz()["dead_ranks"] == [1]
    finally:
        tracker.close()


def test_port_job_serves_clock_corrected_merged_trace():
    """A 2-rank gang of port workers against the port's tracker (the JAX
    package's live flight-recorder test): both ranks' spans under their
    own pids, their steps on /anomalies, their clock offsets on /healthz."""
    tracker = ptr.RabitTracker("127.0.0.1", 2, metrics_port=0)
    tracker.start(2)
    errors = []

    def work(i):
        try:
            c = ptr.TrackerClient("127.0.0.1", tracker.port, jobid=f"tr{i}")
            c.start()
            off, rtt = c.clock_ping()   # same host: offset ~ 0
            assert rtt >= 0 and abs(off) < 60.0
            with ptel.span(f"work.r{c.rank}", stage="e2e"):
                time.sleep(0.01)
            ptel.step_begin()
            ptel.step_end(tokens=64)
            hb = ptel.HeartbeatSender(c, interval=30.0, auto_start=False)
            hb.send_once()
            c.shutdown()
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    ptel.reset_steps()
    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    base = f"http://127.0.0.1:{tracker.metrics_port}"
    try:
        doc = _get(base, "/trace")
        an = _get(base, "/anomalies")
        hz = _get(base, "/healthz")
        tracker.join(timeout=30)
    finally:
        tracker.close()
        ptel.reset_steps()
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {1, 2} <= {e["pid"] for e in evs}
    assert {"work.r0", "work.r1"} <= {e["name"] for e in evs}
    assert min(e["ts"] for e in evs) >= 0.0
    procs = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert {"tracker"} < procs
    assert any(p.startswith("rank 0") for p in procs)
    assert any(p.startswith("rank 1") for p in procs)
    assert set(an["ranks"]) == {"0", "1"}
    assert all(st["steps"] >= 1 for st in an["ranks"].values())
    assert set(hz["clock_offsets"]) == {"0", "1"}
