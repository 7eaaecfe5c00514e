"""The port's fleet trace store against the JAX package's, on the CPU.

* Seeded span-increment documents (trace-stamped and unstamped spans,
  the router's ``cat == "router"`` instants, garbage rows, anchor moves
  with the cursor past 0, more spans than the ring holds) go through
  ``dmlc_tpu``'s ``FleetTraceStore`` and the port's: every ``ingest``
  return, ``sources()``, ``cursor()``, ``anchor()``, ``trace_ids()``,
  each ``timeline(id)``, ``trace_summaries()`` and ``to_chrome_trace()``
  are equal as JSON after every document.  The decision records both
  stores join are made at the same pinned clock.
* The four store tests of ``tests/test_tracecontext.py`` run on both
  stores: the reference's assertions on the port's output, and the two
  outputs equal.
* ``ingest_local`` pulls each package's own span ring.
* The tracing-off contract on the port's router: with
  ``DMLC_TRACE_FLEET`` unset, minting, span ids and header parsing are
  booby-trapped and a request still routes, no store exists and no
  header is forwarded; the port's request ledger stamps nothing.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

from dmlc_tpu import telemetry as jtel
from dmlc_tpu.telemetry import core as jcore
from dmlc_tpu.telemetry import tracecontext as jtc
from dmlc_tpu_torch import telemetry as ttel
from dmlc_tpu_torch.telemetry import core as tcore
from dmlc_tpu_torch.telemetry import tracecontext as ttc
from dmlc_tpu_torch.telemetry.requests import RequestLedger

PKGS = {"jax": jtc, "port": ttc}
TID = ttc.mint_trace_id("req-join")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DMLC_TRACE_FLEET", raising=False)
    monkeypatch.delenv("DMLC_TRACE_FLEET_MAX_SPANS", raising=False)
    for tel, tc in ((jtel, jtc), (ttel, ttc)):
        tel.reset()
        tc.reset_decisions()
    yield
    for tel, tc in ((jtel, jtc), (ttel, ttc)):
        tel.reset()
        tc.reset_decisions()


@pytest.fixture()
def pinned_clock(monkeypatch):
    """Both modules' ``time.time()`` on one scripted clock, so decision
    records made in the same order carry the same ``t``."""
    for tc in (jtc, ttc):
        ticks = iter(1000.0 + 0.25 * i for i in range(10_000))
        monkeypatch.setattr(tc, "time",
                            SimpleNamespace(time=lambda it=ticks: next(it)))


def _json(x):
    return json.dumps(x, sort_keys=True)


def _span(name, ts_us, dur_us=1000.0, cat="serving", tid=1, **args):
    rec = {"name": name, "ts": ts_us, "dur": dur_us, "cat": cat,
           "tid": tid, "seq": 0}
    if args:
        rec["args"] = args
    return rec


def _views(store):
    """Every read-side view of a store, as one JSON string."""
    srcs = store.sources()
    return _json({
        "sources": srcs,
        "cursors": {s: store.cursor(s) for s in srcs},
        "anchors": {s: store.anchor(s) for s in srcs},
        "trace_ids": store.trace_ids(),
        "timelines": {t: store.timeline(t) for t in store.trace_ids()},
        "summaries": store.trace_summaries(),
        "summaries_3": store.trace_summaries(limit=3),
        "chrome": store.to_chrome_trace(),
        "unknown": store.timeline("0" * 32),
    })


def _random_docs(seed, n_docs=60):
    """A seeded stream of ``(source, doc)`` span increments: a router and
    three replicas, trace-stamped spans over eight traces, unstamped
    router instants and engine spans, garbage rows, anchor moves (a
    replica restart) and runs long enough to overflow a 16-span ring."""
    rng = np.random.default_rng(seed)
    traces = [ttc.mint_trace_id(f"req-{i}") for i in range(8)]
    sources = ["router", "http://r1", "http://r2", "http://r3"]
    anchors = {s: 100.0 + 0.1 * i for i, s in enumerate(sources)}
    seqs = {s: 0 for s in sources}
    docs = []
    for _ in range(n_docs):
        src = sources[int(rng.integers(len(sources)))]
        if src != "router" and rng.random() < 0.08:
            anchors[src] += float(rng.integers(1, 50))   # a restart
            seqs[src] = 0
        spans = []
        for _ in range(int(rng.integers(0, 9))):
            ts = float(rng.integers(0, 2_000_000))
            dur = float(rng.integers(0, 400_000))
            tid = traces[int(rng.integers(len(traces)))]
            kind = rng.random()
            if src == "router":
                if kind < 0.6:
                    rep = sources[1 + int(rng.integers(3))]
                    spans.append(_span(
                        "router.dispatch", ts, dur, cat="router",
                        tid=int(rng.integers(1, 4)), trace_id=tid,
                        replica=rep, kind=["primary", "retry",
                                           "hedge"][int(rng.integers(3))],
                        outcome="ok", status=200))
                elif kind < 0.8:
                    spans.append(_span("router.circuit_open", ts, 0.0,
                                       cat="router", replica="http://r1"))
                else:
                    spans.append(_span("router.hedge", ts, 0.0,
                                       cat="router", trace_id=tid,
                                       replica="http://r2"))
            else:
                if kind < 0.7:
                    name = ["serving.queue", "serving.prefill",
                            "serving.decode", "serving.admitted"][
                        int(rng.integers(4))]
                    spans.append(_span(name, ts, dur,
                                       tid=int(rng.integers(1, 6)),
                                       trace_id=tid))
                elif kind < 0.9:
                    spans.append(_span("engine.step", ts, dur, cat="engine"))
                else:
                    spans.append("garbage")
        seqs[src] += len(spans)
        doc = {"spans": spans, "last_seq": seqs[src],
               "anchor_epoch": anchors[src]}
        if rng.random() < 0.05:
            doc.pop("anchor_epoch")
        if rng.random() < 0.05:
            doc.pop("last_seq")
        docs.append((src, doc))
    return docs, traces


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_increments_give_equal_views(seed, pinned_clock):
    docs, traces = _random_docs(seed)
    stores = {pkg: tc.FleetTraceStore(max_spans_per_source=16)
              for pkg, tc in PKGS.items()}
    saw_rewind = saw_bound = False
    for i, (src, doc) in enumerate(docs):
        if i % 7 == 0:
            # decisions naming a trace join its timeline and its
            # Chrome trace's instants
            for tc in PKGS.values():
                tc.record_decision("scale_up", replica=src,
                                   trace_id=traces[i % len(traces)])
        kept = {}
        for pkg, st in stores.items():
            before = st.cursor(src)
            kept[pkg] = st.ingest(src, json.loads(json.dumps(doc)))
            saw_rewind |= before > 0 and st.cursor(src) == 0
        assert kept["port"] == kept["jax"], (i, src)
        assert _views(stores["port"]) == _views(stores["jax"]), (i, src)
        saw_bound |= any(len(s.spans) == 16
                         for s in stores["port"]._snapshot())
    # the stream exercised a restart rewind and the ring bound
    assert saw_rewind and saw_bound


def test_knob_bounds_the_ring_on_both(monkeypatch):
    monkeypatch.setenv("DMLC_TRACE_FLEET_MAX_SPANS", "20")
    got = {}
    for pkg, tc in PKGS.items():
        st = tc.FleetTraceStore()
        st.ingest("http://r1", {"anchor_epoch": 1.0, "last_seq": 30,
                                "spans": [_span("serving.queue", float(i),
                                                trace_id=TID)
                                          for i in range(30)]})
        got[pkg] = [r["ts"] for r in st._snapshot()[0].spans]
    assert got["port"] == got["jax"] == [float(i) for i in range(10, 30)]


# ---------------------------------------------------------------------------
# the store tests of tests/test_tracecontext.py, on both stores
# ---------------------------------------------------------------------------

def _store_keeps_only_the_trace_join(tc):
    st = tc.FleetTraceStore(max_spans_per_source=64)
    kept = st.ingest("router", {"anchor_epoch": 100.0, "last_seq": 3,
                                "spans": [
        _span("router.dispatch", 0.0, cat="router", trace_id=TID,
              replica="http://r1"),
        _span("router.circuit_open", 10.0, cat="router"),
        _span("engine.step", 20.0, cat="engine"),
        "garbage",
    ]})
    assert kept == 2
    assert st.cursor("router") == 3 and st.sources() == ["router"]
    assert st.trace_ids() == [TID]
    return st


def _timeline_summary_and_ordering(tc):
    st = tc.FleetTraceStore(max_spans_per_source=64)
    st.ingest("router", {"anchor_epoch": 100.0, "last_seq": 2, "spans": [
        _span("router.dispatch", 0.0, 50e4, cat="router", trace_id=TID,
              replica="http://r1", kind="primary"),
        _span("router.dispatch", 20e4, 30e4, cat="router", trace_id=TID,
              replica="http://r2", kind="hedge"),
    ]})
    st.ingest("http://r1", {"anchor_epoch": 100.0, "last_seq": 2,
                            "spans": [
        _span("serving.queue", 1e4, 2e4, trace_id=TID),
        _span("serving.prefill", 3e4, 4e4, trace_id=TID),
    ]})
    st.ingest("http://r2", {"anchor_epoch": 100.2, "last_seq": 1,
                            "spans": [
        _span("serving.decode", 1e4, 25e4, trace_id=TID),
    ]})
    tid2 = tc.mint_trace_id("req-fast")
    st.ingest("router", {"anchor_epoch": 100.0, "last_seq": 3, "spans": [
        _span("router.dispatch", 90e4, 1e4, cat="router", trace_id=tid2,
              replica="http://r1"),
    ]})
    tc.record_decision("scale_up", replica="http://r2", trace_id=TID)
    tc.record_decision("scale_down", replica="http://r9")

    tl = st.timeline(TID)
    assert tl["trace_id"] == TID
    walls = [e["t_wall"] for e in tl["events"]]
    assert walls == sorted(walls) and len(walls) == 5
    assert tl["sources"] == ["http://r1", "http://r2", "router"]
    assert [d["kind"] for d in tl["decisions"]] == ["scale_up"]
    s = tl["summary"]
    assert s["attempts"] == 2 and s["hedged"] is True
    assert s["attempt_replicas"] == ["http://r1", "http://r2"]
    assert s["replicas"] == ["http://r1", "http://r2"]
    assert s["queue_s"] == pytest.approx(0.02)
    assert s["prefill_s"] == pytest.approx(0.04)
    assert s["ttft_s"] == pytest.approx(0.06)
    assert s["latency_s"] > 0
    assert [x["trace_id"] for x in st.trace_summaries()] == [TID, tid2]
    assert st.trace_ids()[0] == tid2
    return st


def _chrome_trace_flows_and_instants(tc):
    st = tc.FleetTraceStore(max_spans_per_source=64)
    st.ingest("router", {"anchor_epoch": 100.0, "last_seq": 1, "spans": [
        _span("router.dispatch", 0.0, 50e4, cat="router", trace_id=TID,
              replica="http://r1", kind="primary"),
    ]})
    st.ingest("http://r1", {"anchor_epoch": 100.0, "last_seq": 1,
                            "spans": [
        _span("serving.queue", 1e4, 2e4, trace_id=TID),
    ]})
    tc.record_decision("autoscale_verdict", verdict="scale_up")
    evs = st.to_chrome_trace()
    names = {e.get("name") for e in evs if e.get("ph") == "M"}
    assert {"process_name", "process_sort_index"} <= names
    labels = {e["args"]["name"] for e in evs
              if e.get("name") == "process_name"}
    assert labels == {"router", "replica http://r1"}
    xs = [e for e in evs if e.get("ph") == "X"]
    assert {e["name"] for e in xs} == {"router.dispatch", "serving.queue"}
    assert all(e["ts"] >= 0 for e in xs)
    router_pid = next(e["pid"] for e in evs
                      if e.get("name") == "process_name"
                      and e["args"]["name"] == "router")
    inst = [e for e in evs if e.get("ph") == "i"]
    assert inst and inst[0]["name"] == "decision:autoscale_verdict"
    assert inst[0]["pid"] == router_pid
    s = [e for e in evs if e.get("ph") == "s"]
    f = [e for e in evs if e.get("ph") == "f"]
    assert len(s) == 1 and len(f) == 1
    assert s[0]["id"] == f[0]["id"] and f[0]["bp"] == "e"
    assert s[0]["pid"] == router_pid and f[0]["pid"] != router_pid
    return st


def _restart_rewinds_cursor_keeps_history(tc):
    st = tc.FleetTraceStore(max_spans_per_source=64)
    st.ingest("http://r1", {"anchor_epoch": 100.0, "last_seq": 5,
                            "spans": [_span("serving.queue", 1e4, 2e4,
                                            trace_id=TID)]})
    assert st.cursor("http://r1") == 5
    kept = st.ingest("http://r1", {"anchor_epoch": 200.0, "last_seq": 9,
                                   "spans": [_span("serving.queue", 1e4,
                                                   2e4, trace_id=TID)]})
    assert kept == 0 and st.cursor("http://r1") == 0
    assert st.anchor("http://r1") == 200.0
    assert st.trace_ids() == [TID]
    kept = st.ingest("http://r1", {"anchor_epoch": 200.0, "last_seq": 2,
                                   "spans": [_span("serving.decode", 3e4,
                                                   1e4, trace_id=TID)]})
    assert kept == 1 and st.cursor("http://r1") == 2
    return st


@pytest.mark.parametrize("case", [
    _store_keeps_only_the_trace_join,
    _timeline_summary_and_ordering,
    _chrome_trace_flows_and_instants,
    _restart_rewinds_cursor_keeps_history,
], ids=lambda f: f.__name__.strip("_"))
def test_store_case_equal_on_both(case, pinned_clock):
    views = {pkg: _views(case(tc)) for pkg, tc in PKGS.items()}
    assert views["port"] == views["jax"]


def test_ingest_local_pulls_each_packages_own_ring(monkeypatch):
    got = {}
    for pkg, (tel, core, tc) in {"jax": (jtel, jcore, jtc),
                                 "port": (ttel, tcore, ttc)}.items():
        monkeypatch.setattr(core, "anchor_epoch", lambda: 100.0)
        st = tc.FleetTraceStore(max_spans_per_source=64)
        t = 5.0
        tel.record_span("router.dispatch", stage="router", t0=t,
                        t1=t + 0.5, args={"trace_id": TID,
                                          "replica": "http://r1"})
        tel.record_span("router.circuit_open", stage="router", t0=t,
                        t1=t, args={"replica": "http://r1"})
        tel.record_span("engine.step", stage="engine", t0=t, t1=t + 1)
        kept = st.ingest_local()
        again = st.ingest_local()      # nothing new past the cursor
        # the cursor is the package's own ring position
        assert st.cursor("router") == core.span_seq() > 0
        tl = st.timeline(TID)
        got[pkg] = (kept, again, st.sources(), st.anchor("router"),
                    st.trace_ids(),
                    [(e["name"], e["dur_s"], e["args"])
                     for e in tl["events"]])
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (2, 0)


# ---------------------------------------------------------------------------
# the zero-overhead off path, on the port's router
# ---------------------------------------------------------------------------

class _OkReplica:
    """Minimal healthy replica that records the trace header it gets."""

    def __init__(self):
        outer = self

        class H(BaseHTTPRequestHandler):
            def _send(self, doc):
                body = json.dumps(doc).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._send({"status": "ok", "active": 0, "waiting": 0,
                            "max_active": 4, "draining": False})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n))
                outer.trace_headers.append(
                    self.headers.get(ttc.TRACE_HEADER))
                self._send({"state": "done", "output_ids": [1],
                            "n_generated": 1,
                            "request_id": doc.get("request_id")})

            def log_message(self, *a):
                pass

        self.trace_headers = []
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_disabled_tracing_is_zero_overhead_on_the_port_router(monkeypatch):
    from dmlc_tpu_torch.serving.router import Router

    assert ttc.enabled() is False

    def boom(*a, **k):
        raise AssertionError("tracecontext touched on the off path")

    monkeypatch.setattr(ttc, "mint_trace_id", boom)
    monkeypatch.setattr(ttc, "new_span_id", boom)
    monkeypatch.setattr(ttc, "parse_header", boom)

    rep = _OkReplica()
    r = Router([rep.url], retries=2, dispatch_timeout_s=5.0,
               request_timeout_s=10.0, start_health_thread=False)
    try:
        r.poll_once()
        code, doc, _ = r.route({"prompt": [1], "request_id": "off-1"},
                               trace_parent=f"{TID}-{'0' * 16}")
        assert code == 200 and doc["request_id"] == "off-1"
        assert r.trace_store is None
        assert rep.trace_headers == [None]
    finally:
        r.close()
        rep.close()

    led = RequestLedger(capacity=8, trace_rows=True)
    led.on_submit(1, n_prompt=3, t=0.0)
    led.on_prefill_begin(1, t=0.1)
    led.on_first_token(1, t=0.2)
    rec = led.on_finish(1, t=0.3)
    assert "trace_id" not in rec
    spans, _ = ttel.spans_since(0)
    assert all((s.get("args") or {}).get("trace_id") is None
               for s in spans)
    assert not any(s["name"] == "serving.admitted" for s in spans)
