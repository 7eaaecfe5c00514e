"""Data integrity: CRC-32C, the corruption policy and the quarantine set
(the port of ``dmlc_tpu/io/integrity.py``).

* :func:`crc32c` — CRC-32C (Castagnoli), the checksum of the RecordIO
  record variant (``io.recordio``) and of checkpoint shards
  (``checkpoint.sharded``), computed by the port's native core
  (``native/csrc/crc32c.cc``).  :func:`_crc32c_py` is its plain Python
  version.
* ``DMLC_INTEGRITY_POLICY`` — what a reader does with a record that
  fails its checksum or a corrupted frame: ``raise`` (default) fails,
  ``skip`` drops the record and resyncs to the next record head,
  ``quarantine`` also records the poisoned ``(source, span)`` so a
  replay drops it on sight (the byte-range partition contract
  reproduces the same record begins).

Each event is counted as the JAX package counts it
(``integrity.corrupt_records``, ``integrity.quarantined_spans``,
``integrity.skiplist_drops``) and the corrupt records and quarantines
land in the event ring (``telemetry.events``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import logging as log
from .. import telemetry
from ..base import DMLCError, get_env
from ..concurrency import make_lock

__all__ = [
    "CorruptRecord",
    "crc32c",
    "policy",
    "handle_corrupt",
    "record_quarantine",
    "has_quarantine",
    "should_drop",
    "quarantined_spans",
    "reset_quarantine",
]

ENV_POLICY = "DMLC_INTEGRITY_POLICY"
_POLICIES = ("raise", "skip", "quarantine")


class CorruptRecord(DMLCError):
    """A record failed its integrity check under policy ``raise``."""


def _make_table() -> List[int]:
    tbl = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        tbl.append(c)
    return tbl


_TABLE = _make_table()


def _crc32c_py(data, value: int = 0) -> int:
    """The plain version: one table lookup per byte."""
    mv = memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    c = value ^ 0xFFFFFFFF
    tbl = _TABLE
    for b in mv.tobytes():
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c(data, value: int = 0) -> int:
    """CRC-32C of ``data`` (any bytes-like), chained from ``value``."""
    from .. import native

    return native.crc32c(data, value)


def policy() -> str:
    """The active corruption policy (read at every call)."""
    p = get_env(ENV_POLICY, "raise").strip().lower() or "raise"
    if p not in _POLICIES:
        raise DMLCError(f"bad {ENV_POLICY}={p!r} (choose from {_POLICIES})")
    return p


_lock = make_lock("integrity._lock")
# source -> {begin_offset: end_offset}: record-head offsets in the split's
# logical byte space, the same for any partition count
_spans: Dict[str, Dict[int, int]] = {}


def record_quarantine(source: str, begin: int, end: int) -> None:
    """Add a poisoned span to the skip-list (idempotent per (source,
    begin)) and count it."""
    with _lock:
        per = _spans.setdefault(source, {})
        fresh = begin not in per
        per[begin] = max(end, per.get(begin, end))
    if fresh:
        telemetry.inc("integrity", "quarantined_spans")
        telemetry.record_event("quarantine", source=source, begin=begin,
                               end=end)


def should_drop(source: Optional[str], begin: Optional[int]) -> bool:
    """True (and counted) when the record at ``begin`` was quarantined
    and a replay must drop it."""
    if source is None or begin is None or not _spans:
        # the unlocked emptiness probe is a benign race (_spans only grows
        # between resets): it keeps the per-record read paths lock-free
        # while nothing is quarantined
        return False
    with _lock:
        per = _spans.get(source)
        if per is None or begin not in per:
            return False
    telemetry.inc("integrity", "skiplist_drops")
    return True


def has_quarantine(source: Optional[str]) -> bool:
    """True when ``source`` has any quarantined span."""
    if source is None or not _spans:
        return False
    with _lock:
        return bool(_spans.get(source))


def quarantined_spans(source: Optional[str] = None
                      ) -> List[Tuple[str, int, int]]:
    with _lock:
        if source is not None:
            return [(source, b, e)
                    for b, e in sorted(_spans.get(source, {}).items())]
        return [(s, b, e) for s, per in sorted(_spans.items())
                for b, e in sorted(per.items())]


def reset_quarantine() -> None:
    with _lock:
        _spans.clear()


def handle_corrupt(what: str, *, source: Optional[str] = None,
                   begin: Optional[int] = None,
                   end: Optional[int] = None) -> None:
    """One corrupt record: raise :class:`CorruptRecord` under ``raise``,
    return (the caller skips and resyncs) under ``skip``, and also
    record the span under ``quarantine``."""
    telemetry.inc("integrity", "corrupt_records")
    p = policy()
    where = (f"{source or '<stream>'}"
             + (f" @[{begin},{end})" if begin is not None else ""))
    telemetry.record_event("corrupt_record", what=what, where=where,
                           policy=p)
    if p == "raise":
        raise CorruptRecord(f"corrupt record ({what}) at {where}")
    if p == "quarantine" and source is not None and begin is not None:
        record_quarantine(source, begin, end if end is not None else begin)
    log.warning(f"integrity: {what} at {where} — record "
                f"{'quarantined' if p == 'quarantine' else 'skipped'}")
