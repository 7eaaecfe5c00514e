"""Trace-context propagation for serving requests, the decision audit
log and the fleet trace store (the port of
``dmlc_tpu/telemetry/tracecontext.py``).

A ``(trace_id, parent_span_id)`` pair rides every ``/generate`` hop in
the ``X-DMLC-Trace`` header (``<32 hex>-<16 hex>``).  The trace id is
minted **deterministically from the idempotency request_id**
(:func:`mint_trace_id`), so client retries, router retries and hedges of
one logical request land in ONE trace with no coordination; an explicit
inbound header overrides the derivation.  The router and the replica's
request ledger stamp the id into their span ``args``, and
``GET /spans?since=N`` exports them.

Per-request tracing is dark behind ``DMLC_TRACE_FLEET=1`` (default
off): when disabled, :func:`enabled` is the only call on the hot path.

:class:`DecisionLog` is a bounded ring of structured cluster-brain
decision records (autoscaler verdicts, preemption chains, tenant
rejections) with the ``records_since`` incremental-export contract of
the request ledger; the decision ring is control-plane rate and
therefore ALWAYS on (like ``events.record_event``).  The tracker's
incident reporter and the router's ``/decisions`` read it.

:class:`FleetTraceStore` merges span increments from the router's own
ring plus every replica into one wall-clock timeline: the router's
``GET /trace/<trace_id>`` (one request's causal journey as JSON),
``GET /trace`` (a merged Chrome trace with ``ph:"s"/"f"`` flow arrows
from each router attempt to the replica lifecycle it started) and
``GET /traces`` (slowest-recent summaries).  A span's wall time is
``anchor_epoch * 1e6 + ts`` microseconds; the processes of one fleet
share a host clock.
"""

from __future__ import annotations

import hashlib
import os
import re
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..base import get_env
from ..concurrency import make_lock
from . import core

__all__ = [
    "TRACE_HEADER",
    "enabled",
    "mint_trace_id",
    "new_span_id",
    "format_header",
    "parse_header",
    "DecisionLog",
    "decision_log",
    "record_decision",
    "reset_decisions",
    "FleetTraceStore",
]

#: the propagation header: ``X-DMLC-Trace: <trace_id>-<parent_span_id>``
TRACE_HEADER = "X-DMLC-Trace"

_HEADER_RE = re.compile(r"^([0-9a-f]{32})-([0-9a-f]{16})$")


def enabled() -> bool:
    """Is fleet tracing on?  ``DMLC_TRACE_FLEET`` (default off).

    This is the ONE call allowed on the per-request hot path when
    tracing is off; everything else in this module runs only behind
    it (the tested zero-overhead contract)."""
    return bool(get_env("DMLC_TRACE_FLEET", False))


def mint_trace_id(request_id: str) -> str:
    """Deterministic 32-hex trace id from the idempotency request_id.

    Every hop that knows the request_id can re-derive the SAME trace
    id with no coordination — a hedge, a router retry, and a client
    retry under one idempotency key are one trace by construction."""
    h = hashlib.blake2b(str(request_id).encode("utf-8", "replace"),
                        digest_size=16)
    return h.hexdigest()


def new_span_id() -> str:
    """A fresh random 16-hex span id (one per dispatch attempt)."""
    return os.urandom(8).hex()


def format_header(trace_id: str, span_id: str) -> str:
    """Render the ``X-DMLC-Trace`` header value."""
    return f"{trace_id}-{span_id}"


def parse_header(value: Optional[str]) -> Optional[Tuple[str, str]]:
    """Parse a header value into ``(trace_id, parent_span_id)``.

    Tolerant: anything malformed (wrong lengths, non-hex, missing
    separator, ``None``) returns ``None`` — a bad tracer upstream must
    never fail a request."""
    if not value or not isinstance(value, str):
        return None
    m = _HEADER_RE.match(value.strip().lower())
    if not m:
        return None
    return m.group(1), m.group(2)


# ---------------------------------------------------------------------------
# decision audit log
# ---------------------------------------------------------------------------

class DecisionLog:
    """Bounded ring of structured cluster-brain decision records.

    Each record is a small JSON-able dict ``{"seq", "t", "kind",
    ...fields}`` with a monotone ``seq`` (1-based, never reused), the
    same incremental-export contract as ``RequestLedger.records_since``
    so pollers (``GET /decisions?since=N``) never re-read history.
    Recording is control-plane rate (scale events, preemptions,
    tenant rejections) — cheap, always on, bounded by
    ``DMLC_TRACE_MAX_DECISIONS`` (default 1024).
    """

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = get_env("DMLC_TRACE_MAX_DECISIONS", 1024)
        self._lock = make_lock("DecisionLog._lock")
        # dmlc-check: guarded-by(_lock)
        self._recs: deque = deque(maxlen=max(1, int(capacity)))
        # dmlc-check: guarded-by(_lock)
        self._seq = 0

    def record(self, kind: str, **fields: Any) -> Dict:
        """Append one decision; returns the recorded dict.  Fields must
        be JSON-serializable (callers pass strings/numbers)."""
        rec = {"kind": str(kind), "t": time.time()}
        rec.update(fields)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._recs.append(rec)
        return rec

    def records_since(self, after_seq: int = 0,
                      limit: int = 256) -> Tuple[List[Dict], int]:
        """Records with ``seq > after_seq`` (oldest first, capped at
        the OLDEST ``limit``) plus the ring's latest seq for the next
        poll cursor."""
        with self._lock:
            out = [dict(r) for r in self._recs if r["seq"] > after_seq]
            last = self._seq
        if limit is not None and len(out) > limit:
            out = out[:int(limit)]
        return out, last

    def tail(self, n: int = 64) -> List[Dict]:
        """Newest ``n`` records, oldest first."""
        with self._lock:
            recs = list(self._recs)
        return [dict(r) for r in recs[-int(n):]]

    def reset(self) -> None:
        """Clear the ring (test isolation); seq keeps going."""
        with self._lock:
            self._recs.clear()


_default_log: Optional[DecisionLog] = None
_default_log_lock = make_lock("tracecontext._default_log_lock")


def decision_log() -> DecisionLog:
    """The process-default decision ring (what ``/decisions`` serves)."""
    global _default_log
    with _default_log_lock:
        if _default_log is None:
            _default_log = DecisionLog()
        return _default_log


def record_decision(kind: str, **fields: Any) -> Dict:
    """Record one decision on the process-default ring."""
    return decision_log().record(kind, **fields)


def reset_decisions() -> None:
    """Drop the process-default ring (test isolation)."""
    global _default_log
    with _default_log_lock:
        _default_log = None


# ---------------------------------------------------------------------------
# fleet trace assembly
# ---------------------------------------------------------------------------

def _span_trace_id(rec: Dict) -> Optional[str]:
    args = rec.get("args")
    if isinstance(args, dict):
        tid = args.get("trace_id")
        if tid:
            return str(tid)
    return None


class _Source:
    """One span source (the router itself, or one replica URL)."""

    __slots__ = ("name", "pid", "anchor", "spans", "cursor")

    def __init__(self, name: str, pid: int, max_spans: int):
        self.name = name
        self.pid = pid
        self.anchor: Optional[float] = None
        self.spans: deque = deque(maxlen=max_spans)
        self.cursor = 0  # last seq ingested (the next ?since=)


class FleetTraceStore:
    """Router-side store merging trace-annotated spans across sources.

    ``ingest(source, doc)`` consumes one ``GET /spans?since=N``
    response (``{"spans", "last_seq", "anchor_epoch"}``), keeping ONLY
    spans stamped with ``args.trace_id`` (the fleet store is a trace
    join, not a mirror of every ring).  ``ingest_local()`` pulls the
    calling process's own ring the same way.  A replica restart is
    detected by its anchor moving: the old incarnation's spans are
    kept (they are real history — exactly what a post-SIGKILL trace
    needs), the cursor rewinds so the fresh ring is re-read from 0.
    """

    LOCAL = "router"

    def __init__(self, max_spans_per_source: Optional[int] = None):
        if max_spans_per_source is None:
            max_spans_per_source = get_env("DMLC_TRACE_FLEET_MAX_SPANS",
                                           16384)
        self._max = max(16, int(max_spans_per_source))
        self._lock = make_lock("FleetTraceStore._lock")
        # dmlc-check: guarded-by(_lock)
        self._sources: Dict[str, _Source] = {}

    # -- ingest ----------------------------------------------------------

    def _source(self, name: str) -> _Source:
        src = self._sources.get(name)
        if src is None:
            src = _Source(name, len(self._sources), self._max)
            self._sources[name] = src
        return src

    def cursor(self, source: str) -> int:
        """The ``?since=`` cursor for the next poll of ``source``."""
        with self._lock:
            src = self._sources.get(source)
            return src.cursor if src else 0

    def anchor(self, source: str) -> Optional[float]:
        with self._lock:
            src = self._sources.get(source)
            return src.anchor if src else None

    def ingest(self, source: str, doc: Dict) -> int:
        """Merge one span-increment doc; returns spans kept."""
        spans = doc.get("spans") or []
        anchor = doc.get("anchor_epoch")
        last_seq = doc.get("last_seq")
        kept = 0
        with self._lock:
            src = self._source(source)
            if anchor is not None:
                if src.anchor is not None \
                        and abs(anchor - src.anchor) > 1e-6 \
                        and src.cursor > 0:
                    # new incarnation (the source restarted): its seq
                    # counter reset, so a batch fetched with the stale
                    # cursor may be gapped — drop it, rewind, and let
                    # the next poll re-read the fresh ring from 0.
                    # The old incarnation's spans stay: they are the
                    # history a post-SIGKILL trace needs.
                    src.cursor = 0
                    src.anchor = float(anchor)
                    return 0
                src.anchor = float(anchor)
            for rec in spans:
                if not isinstance(rec, dict):
                    continue
                if _span_trace_id(rec) is None \
                        and rec.get("cat") != "router":
                    # keep the trace join + the router's control-plane
                    # instants (circuit/drain), not every ring span
                    continue
                row = dict(rec)
                row["_anchor"] = src.anchor
                src.spans.append(row)
                kept += 1
            if last_seq is not None:
                src.cursor = int(last_seq)
        return kept

    def ingest_local(self, source: Optional[str] = None) -> int:
        """Pull the calling process's own span ring incrementally."""
        name = source or self.LOCAL
        since = self.cursor(name)
        spans, last = core.spans_since(since, limit=4096)
        return self.ingest(name, {"spans": spans, "last_seq": last,
                                  "anchor_epoch": core.anchor_epoch()})

    # -- views -----------------------------------------------------------

    @staticmethod
    def _wall_us(rec: Dict) -> float:
        anchor = rec.get("_anchor") or 0.0
        return anchor * 1e6 + float(rec.get("ts", 0.0))

    def _snapshot(self) -> List[_Source]:
        with self._lock:
            srcs = []
            for s in self._sources.values():
                c = _Source(s.name, s.pid, self._max)
                c.anchor = s.anchor
                c.spans = deque(s.spans)
                c.cursor = s.cursor
                srcs.append(c)
        return srcs

    def sources(self) -> List[str]:
        with self._lock:
            return list(self._sources)

    def trace_ids(self) -> List[str]:
        """Distinct trace ids, most recently started first."""
        seen: Dict[str, float] = {}
        for src in self._snapshot():
            for rec in src.spans:
                tid = _span_trace_id(rec)
                if tid is None:
                    continue
                w = self._wall_us(rec)
                if tid not in seen or w < seen[tid]:
                    seen[tid] = w
        return [t for t, _ in
                sorted(seen.items(), key=lambda kv: -kv[1])]

    def timeline(self, trace_id: str) -> Dict:
        """The single-request causal journey: every span across every
        source carrying this trace id, wall-clock sorted, plus the
        decision records that name it."""
        events: List[Dict] = []
        for src in self._snapshot():
            for rec in src.spans:
                if _span_trace_id(rec) != trace_id:
                    continue
                args = dict(rec.get("args") or {})
                args.pop("trace_id", None)
                events.append({
                    "source": src.name,
                    "name": rec.get("name"),
                    "cat": rec.get("cat"),
                    "t_wall": self._wall_us(rec) / 1e6,
                    "dur_s": float(rec.get("dur", 0.0)) / 1e6,
                    "args": args,
                })
        events.sort(key=lambda e: e["t_wall"])
        decisions = [r for r in decision_log().tail(256)
                     if r.get("trace_id") == trace_id]
        doc = {"trace_id": trace_id, "events": events,
               "decisions": decisions,
               "sources": sorted({e["source"] for e in events})}
        doc["summary"] = self._summarize(trace_id, events)
        return doc

    @staticmethod
    def _summarize(trace_id: str, events: List[Dict]) -> Dict:
        attempts = [e for e in events if e["name"] == "router.dispatch"]
        serving = [e for e in events
                   if str(e.get("cat", "")).startswith("serving")]
        phases: Dict[str, float] = {}
        for e in serving:
            key = str(e["name"]).split(".")[-1]
            phases[key] = phases.get(key, 0.0) + e["dur_s"]
        t0 = min((e["t_wall"] for e in events), default=0.0)
        t1 = max((e["t_wall"] + e["dur_s"] for e in events), default=0.0)
        return {
            "trace_id": trace_id,
            "t_start": t0,
            "latency_s": max(t1 - t0, 0.0),
            "attempts": len(attempts),
            "attempt_replicas": sorted(
                {str(e["args"].get("replica"))
                 for e in attempts if e["args"].get("replica")}),
            "replicas": sorted({e["source"] for e in serving}),
            "hedged": any(e["args"].get("kind") == "hedge"
                          for e in attempts),
            "phases_s": phases,
            "queue_s": phases.get("queue", 0.0),
            "prefill_s": phases.get("prefill", 0.0),
            "ttft_s": phases.get("queue", 0.0) + phases.get("prefill",
                                                            0.0),
        }

    def trace_summaries(self, limit: int = 32) -> List[Dict]:
        """Per-trace summaries, slowest first (the dmlc-top pane)."""
        by_trace: Dict[str, List[Dict]] = {}
        for src in self._snapshot():
            for rec in src.spans:
                tid = _span_trace_id(rec)
                if tid is None:
                    continue
                args = dict(rec.get("args") or {})
                args.pop("trace_id", None)
                by_trace.setdefault(tid, []).append({
                    "source": src.name,
                    "name": rec.get("name"),
                    "cat": rec.get("cat"),
                    "t_wall": self._wall_us(rec) / 1e6,
                    "dur_s": float(rec.get("dur", 0.0)) / 1e6,
                    "args": args,
                })
        out = [self._summarize(tid, evs)
               for tid, evs in by_trace.items()]
        out.sort(key=lambda s: -s["latency_s"])
        return out[:int(limit)]

    # -- Chrome trace ----------------------------------------------------

    def to_chrome_trace(self) -> List[Dict]:
        """One merged Chrome trace: a process row per source plus
        ``ph:"s"/"f"`` flow arrows stitching each router dispatch
        attempt to the replica lifecycle it triggered."""
        srcs = self._snapshot()
        events: List[Dict] = []
        walls: List[float] = []
        for src in srcs:
            for rec in src.spans:
                walls.append(self._wall_us(rec))
        t0 = min(walls) if walls else 0.0

        for src in srcs:
            label = "router" if src.name == self.LOCAL \
                else f"replica {src.name}"
            events.append({"ph": "M", "name": "process_name",
                           "pid": src.pid, "tid": 0,
                           "args": {"name": label}})
            events.append({"ph": "M", "name": "process_sort_index",
                           "pid": src.pid, "tid": 0,
                           "args": {"sort_index": src.pid}})
            for rec in src.spans:
                ev = {"name": rec.get("name"),
                      "cat": rec.get("cat", "dmlc"),
                      "ph": "X",
                      "ts": self._wall_us(rec) - t0,
                      "dur": float(rec.get("dur", 0.0)),
                      "pid": src.pid,
                      "tid": int(rec.get("tid", 0))}
                if rec.get("args"):
                    ev["args"] = rec["args"]
                events.append(ev)

        # cluster-brain decisions as global instants on the router row
        router_pid = next((s.pid for s in srcs
                           if s.name == self.LOCAL), 0)
        for rec in decision_log().tail(256):
            events.append({"name": f"decision:{rec['kind']}",
                           "cat": "decision", "ph": "i", "s": "g",
                           "pid": router_pid, "tid": 0,
                           "ts": rec["t"] * 1e6 - t0,
                           "args": {k: v for k, v in rec.items()
                                    if k != "t"}})

        events.extend(self._flow_events(srcs, t0))
        return events

    def _flow_events(self, srcs: List[_Source],
                     t0: float) -> List[Dict]:
        """Flow arrows: router ``router.dispatch`` span (start) ->
        earliest serving span of the same trace on the dispatched
        replica (finish)."""
        pid_by_name = {s.name: s.pid for s in srcs}
        # earliest serving span per (trace, source)
        first_serving: Dict[Tuple[str, str], Dict] = {}
        dispatches: List[Tuple[_Source, Dict]] = []
        for src in srcs:
            for rec in src.spans:
                tid = _span_trace_id(rec)
                if tid is None:
                    continue
                if rec.get("name") == "router.dispatch":
                    dispatches.append((src, rec))
                    continue
                if not str(rec.get("cat", "")).startswith("serving"):
                    continue
                key = (tid, src.name)
                cur = first_serving.get(key)
                if cur is None or self._wall_us(rec) < self._wall_us(cur):
                    first_serving[key] = rec

        flows: List[Dict] = []
        n = 0
        for src, rec in dispatches:
            tid = _span_trace_id(rec)
            replica = (rec.get("args") or {}).get("replica")
            target = first_serving.get((tid, str(replica)))
            if target is None:
                continue
            n += 1
            fid = int(hashlib.blake2b(
                f"{tid}/{replica}/{n}".encode(),
                digest_size=6).hexdigest(), 16)
            common = {"cat": "trace", "name": "journey", "id": fid}
            flows.append(dict(common, ph="s", pid=src.pid,
                              tid=int(rec.get("tid", 0)),
                              ts=self._wall_us(rec) - t0))
            tgt_pid = pid_by_name.get(str(replica))
            if tgt_pid is None:
                continue
            flows.append(dict(common, ph="f", bp="e", pid=tgt_pid,
                              tid=int(target.get("tid", 0)),
                              ts=self._wall_us(target) - t0))
        return flows
