"""Trace-context propagation for serving requests and the decision
audit log (the port of ``dmlc_tpu/telemetry/tracecontext.py``, less its
fleet trace store).

A ``(trace_id, parent_span_id)`` pair rides every ``/generate`` hop in
the ``X-DMLC-Trace`` header (``<32 hex>-<16 hex>``).  The trace id is
minted **deterministically from the idempotency request_id**
(:func:`mint_trace_id`), so client retries of one logical request land
in ONE trace with no coordination; an explicit inbound header overrides
the derivation.  The replica's request ledger stamps the id into its
span ``args``, and ``GET /spans?since=N`` exports them.

Per-request tracing is dark behind ``DMLC_TRACE_FLEET=1`` (default
off): when disabled, :func:`enabled` is the only call on the hot path.

:class:`DecisionLog` is a bounded ring of structured cluster-brain
decision records (autoscaler verdicts, preemption chains, tenant
rejections) with the ``records_since`` incremental-export contract of
the request ledger; the decision ring is control-plane rate and
therefore ALWAYS on (like ``events.record_event``).  The tracker's
incident reporter reads its tail (telemetry.forensics).  The fleet
trace store of the JAX package belongs to the router (ROADMAP.md
Queue 1 item 9c).
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
