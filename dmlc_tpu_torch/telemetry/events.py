"""Bounded structured event log (the port of
``dmlc_tpu/telemetry/events.py``).

Counters say HOW MANY corrupt records or drains happened; the event log
says WHICH, WHEN, and in WHAT ORDER.  Events are small dicts in a
bounded ring (``DMLC_TELEMETRY_MAX_EVENTS``, default 2048) with
wall-clock and monotonic timestamps, JSONL-exportable, recorded by the
integrity layer (corrupt records, quarantines, corrupt checkpoint
shards), the serving engine (drain begin and end) and the SLO monitor
(violations and recoveries).

Recording is cheap (one dict + deque append under a lock) but not free:
use it for *control-plane* transitions, not per-batch data-plane flow —
that is what counters/histograms/spans are for.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, List, Optional

from ..base import get_env
from ..concurrency import make_lock

__all__ = ["record_event", "events", "events_tail", "to_jsonl",
           "reset_events"]

_MAX_EVENTS = get_env("DMLC_TELEMETRY_MAX_EVENTS", 2048)

_lock = make_lock("events._lock")
_events: deque = deque(maxlen=_MAX_EVENTS)
_seq = 0


def record_event(kind: str, **fields) -> Dict:
    """Append one event; returns the recorded dict.  ``kind`` is the
    event's name (``corrupt_record``, ``quarantine``,
    ``serving_drain_begin``, ``anomaly``, ...); keyword fields carry its context and must
    be JSON-serializable (callers pass strings/numbers)."""
    global _seq
    rec = {"kind": str(kind), "t": time.time(), "mono": time.monotonic()}
    rec.update(fields)
    with _lock:
        _seq += 1
        rec["seq"] = _seq
        _events.append(rec)
    return rec


def events() -> List[Dict]:
    """Copy of the event ring, oldest first."""
    with _lock:
        return list(_events)


def events_tail(n: int = 256) -> List[Dict]:
    """Newest ``n`` events, oldest first."""
    with _lock:
        tail = list(_events)
    return tail[-n:]


def to_jsonl(recs: Optional[List[Dict]] = None) -> str:
    """Events as JSON Lines (one compact object per line)."""
    if recs is None:
        recs = events()
    return "\n".join(
        json.dumps(r, separators=(",", ":"), default=str) for r in recs)


def reset_events() -> None:
    """Clear the ring (test isolation); the seq counter keeps going."""
    with _lock:
        _events.clear()
