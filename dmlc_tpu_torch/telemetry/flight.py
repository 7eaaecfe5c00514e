"""Tracker-side flight recorder: per-rank span store + merged /trace
(the port of ``dmlc_tpu/telemetry/flight.py``: the same store, bounds,
dedup, restart and renumbering rules and the same Chrome-trace
document, so either package's tracker renders a job of either package's
workers alike).

Workers ship their span rings incrementally with each telemetry
heartbeat (a ``trace`` sub-document: new spans since the last ship,
the wall-clock anchor of their span clock, and their latest NTP-style
clock sample — see telemetry.clock).  The :class:`FlightRecorder`
keeps a bounded per-rank store and renders ONE Chrome trace for the
whole cluster: each rank is a distinct ``pid`` with a labeled process
row, every timestamp is mapped onto the tracker's clock through the
per-rank offset estimate, and the tracker's own spans ride along under
their own row — so cross-rank skew (who reached the collective last)
is directly visible as horizontal offset in Perfetto.
"""

from __future__ import annotations

import json
import logging
from collections import deque
from typing import Dict, List, Optional

from ..base import get_env
from . import core
from .clock import ClockOffsetEstimator
from ..concurrency import make_lock

__all__ = ["FlightRecorder", "TRACKER_PID"]

logger = logging.getLogger("dmlc_tpu_torch.tracker")

#: pid of the tracker's own row in the merged trace (workers are
#: pid == rank + 1, so rank 0 and the tracker never collide)
TRACKER_PID = 0

_SPAN_KEYS = ("name", "ts", "dur", "tid")


class FlightRecorder:
    """Bounded per-rank span store with clock-corrected merged export.

    ``local_spans`` (zero-arg callable returning a span list) adds the
    tracker process's own spans to the merged view under
    :data:`TRACKER_PID`; its clock IS the reference, so no correction
    applies.  ``marker_source`` (zero-arg callable returning
    ``[{"t": epoch_s, "name": ...}]``, e.g. ``Watchdog.trace_markers``)
    adds instant-marker rows to the merged trace — anomaly verdicts
    land as global instants at their wall time, so "when did the
    straggler flag fire" lines up against the spans that caused it.
    Per-rank capacity: ``DMLC_TRACE_MAX_SPANS_PER_RANK``
    (default 4096) — bounded so a chatty rank cannot OOM the tracker.
    """

    def __init__(self, max_spans_per_rank: Optional[int] = None,
                 local_spans=None, log=logger):
        if max_spans_per_rank is None:
            max_spans_per_rank = get_env(
                "DMLC_TRACE_MAX_SPANS_PER_RANK", 4096)
        self.max_spans_per_rank = max_spans_per_rank
        self.clock = ClockOffsetEstimator()
        self._local_spans = local_spans
        self.marker_source = None
        self._log = log
        self._lock = make_lock("FlightRecorder._lock")
        self._spans: Dict[int, deque] = {}
        self._anchor: Dict[int, float] = {}
        self._host: Dict[int, str] = {}
        self._last_seq: Dict[int, int] = {}

    # ---- ingest ---------------------------------------------------------
    def ingest_json(self, rank: int, payload: str,
                    host: Optional[str] = None) -> None:
        """Extract and ingest the ``trace`` sub-document of a heartbeat
        payload; heartbeats without one (older workers, plain metric
        beats) are ignored, and malformed ones are dropped with a
        warning — trace shipping must never poison the accept loop."""
        try:
            doc = json.loads(payload)
            trace = doc.get("trace") if isinstance(doc, dict) else None
            if trace is not None:
                self.ingest(rank, trace, host=host)
        except Exception as e:  # noqa: BLE001 - see docstring
            self._log.warning("rank %d sent malformed trace: %r", rank, e)

    def ingest(self, rank: int, trace: Dict,
               host: Optional[str] = None) -> None:
        if rank < 0 or not isinstance(trace, dict):
            return
        try:
            anchor = float(trace["anchor"])
        except (KeyError, TypeError, ValueError):
            return  # spans are unplaceable without their wall anchor
        spans = trace.get("spans")
        if not isinstance(spans, list):
            spans = []
        with self._lock:
            # a restarted worker ships a NEW span clock (fresh anchor,
            # seq restarting from 1): drop the dead incarnation's store
            # — including its clock relation — so its seq high-water
            # mark cannot swallow the new spans.  This runs BEFORE the
            # beat's own clock sample is applied, so the new
            # incarnation's first sample survives the reset.
            if abs(self._anchor.get(rank, anchor) - anchor) > 1e-6:
                self._spans.pop(rank, None)
                self._last_seq.pop(rank, None)
                self.clock.drop(rank)
            self._anchor[rank] = anchor
        clock = trace.get("clock")
        if isinstance(clock, dict):
            try:
                self.clock.update(rank, float(clock["offset_s"]),
                                  float(clock["rtt_s"]))
            except (KeyError, TypeError, ValueError):
                pass
        with self._lock:
            if host:
                self._host[rank] = host
            store = self._spans.setdefault(
                rank, deque(maxlen=self.max_spans_per_rank))
            last = self._last_seq.get(rank, 0)
            for rec in spans:
                if not isinstance(rec, dict):
                    continue
                try:
                    seq = int(rec.get("seq", 0))
                    if seq <= last and seq != 0:
                        continue  # already shipped in an earlier beat
                    clean = {k: rec[k] for k in _SPAN_KEYS}
                    clean["ts"] = float(clean["ts"])
                    clean["dur"] = float(clean["dur"])
                    clean["cat"] = str(rec.get("cat", "dmlc"))
                    clean["thread"] = str(rec.get("thread", clean["tid"]))
                    if isinstance(rec.get("args"), dict):
                        clean["args"] = rec["args"]
                    store.append(clean)
                    if seq:
                        last = max(last, seq)
                except (KeyError, TypeError, ValueError):
                    continue
            self._last_seq[rank] = last

    def drop(self, rank: int) -> None:
        """Forget a rank's store AND clock estimate (declared dead: the
        replacement's clock relation starts over).  Its already-merged
        spans vanish from /trace — the postmortem dump is the dead
        incarnation's record, not the tracker."""
        with self._lock:
            self._spans.pop(rank, None)
            self._anchor.pop(rank, None)
            self._host.pop(rank, None)
            self._last_seq.pop(rank, None)
        self.clock.drop(rank)

    def remap_ranks(self, mapping: Dict[int, int]) -> None:
        """Atomically renumber every per-rank store into a new
        generation's rank space (elastic resize; same contract as
        ``TelemetryAggregator.remap_ranks``): ranks absent from
        ``mapping`` are dropped.  Span *contents* are untouched — a
        request-row tid (``1<<48 + req_id``) or a span's ``trace_id``
        names a logical entity, not a rank, so both survive renumbering
        verbatim; only the store key (→ merged-trace pid) moves.
        Without this, a survivor's spans would render under a pid now
        owned by a different process — or collide with the rank that
        inherited its old number."""
        with self._lock:
            self._spans = {mapping[r]: s for r, s in self._spans.items()
                           if r in mapping}
            self._anchor = {mapping[r]: a for r, a in self._anchor.items()
                            if r in mapping}
            self._host = {mapping[r]: h for r, h in self._host.items()
                          if r in mapping}
            self._last_seq = {mapping[r]: q
                              for r, q in self._last_seq.items()
                              if r in mapping}
        self.clock.remap_ranks(mapping)

    # ---- views ----------------------------------------------------------
    def ranks(self) -> List[int]:
        with self._lock:
            return sorted(self._spans)

    def span_counts(self) -> Dict[int, int]:
        with self._lock:
            return {r: len(s) for r, s in self._spans.items()}

    def to_chrome_trace(self) -> Dict:
        """Merged, offset-corrected Chrome trace dict.

        One ``pid`` per rank (pid == rank + 1; the tracker's own spans
        are pid 0) with ``process_name``/``process_sort_index`` rows and
        per-thread ``thread_name`` rows.  Timestamps are each rank's
        span clock mapped to tracker wall time via its clock offset,
        then rebased so the earliest event is ts == 0 (Perfetto renders
        absolute-epoch µs poorly).
        """
        with self._lock:
            per_rank = {r: list(s) for r, s in self._spans.items()}
            anchors = dict(self._anchor)
            hosts = dict(self._host)
        rows = []  # (pid, label, anchor_epoch_s, offset_s, spans)
        for r in sorted(per_rank):
            label = f"rank {r}"
            if r in hosts:
                label += f" ({hosts[r]})"
            off = self.clock.offset(r)
            rows.append((r + 1, label, anchors[r],
                         0.0 if off is None else off, per_rank[r]))
        if self._local_spans is not None:
            try:
                rows.append((TRACKER_PID, "tracker",
                             core.anchor_epoch(), 0.0,
                             list(self._local_spans())))
            except Exception as e:  # noqa: BLE001 - render must not 500
                self._log.warning("tracker local spans failed: %r", e)

        # corrected wall-clock µs for every event, then one global rebase
        placed = []  # (pid, label, [(wall_us, rec)])
        t_min = None
        for pid, label, anchor, off, recs in rows:
            evs = []
            for rec in recs:
                wall_us = (anchor + off) * 1e6 + rec["ts"]
                evs.append((wall_us, rec))
                if t_min is None or wall_us < t_min:
                    t_min = wall_us
            placed.append((pid, label, evs))
        t_min = t_min or 0.0

        events: List[Dict] = []
        for pid, label, evs in placed:
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": label}})
            events.append({"name": "process_sort_index", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"sort_index": pid}})
            threads = {}
            for wall_us, rec in evs:
                if rec["tid"] not in threads:
                    threads[rec["tid"]] = rec.get("thread", str(rec["tid"]))
                ev = {
                    "name": rec["name"],
                    "cat": rec.get("cat", "dmlc"),
                    "ph": "X",
                    "ts": round(wall_us - t_min, 3),
                    "dur": round(rec["dur"], 3),
                    "pid": pid,
                    "tid": rec["tid"],
                }
                if "args" in rec:
                    ev["args"] = rec["args"]
                events.append(ev)
            for tid, tname in threads.items():
                events.append({"name": "thread_name", "ph": "M", "pid": pid,
                               "tid": tid, "args": {"name": tname}})
        # anomaly verdicts as global instant markers: their wall time is
        # already on the tracker's clock (the watchdog stamps them when
        # the verdict fires), so they share the same rebase as the
        # corrected spans and line up against what caused them
        if self.marker_source is not None:
            try:
                for m in self.marker_source():
                    events.append({
                        "name": str(m["name"]), "cat": "anomaly",
                        "ph": "i", "s": "g",
                        "ts": round(max(float(m["t"]) * 1e6 - t_min, 0.0),
                                    3),
                        "pid": TRACKER_PID, "tid": 0,
                    })
            except Exception as e:  # noqa: BLE001 - render must not 500
                self._log.warning("anomaly markers failed: %r", e)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def to_chrome_trace_json(self) -> str:
        return json.dumps(self.to_chrome_trace())
