"""Trace-context propagation for serving requests (the header half of
``dmlc_tpu/telemetry/tracecontext.py``).

A ``(trace_id, parent_span_id)`` pair rides every ``/generate`` hop in
the ``X-DMLC-Trace`` header (``<32 hex>-<16 hex>``).  The trace id is
minted **deterministically from the idempotency request_id**
(:func:`mint_trace_id`), so client retries of one logical request land
in ONE trace with no coordination; an explicit inbound header overrides
the derivation.  The replica's request ledger stamps the id into its
span ``args``, and ``GET /spans?since=N`` exports them.

Per-request tracing is dark behind ``DMLC_TRACE_FLEET=1`` (default
off): when disabled, :func:`enabled` is the only call on the hot path.
The decision audit log and the fleet trace store of the JAX package
belong to the fleet (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Optional, Tuple

from ..base import get_env

__all__ = [
    "TRACE_HEADER",
    "enabled",
    "mint_trace_id",
    "new_span_id",
    "format_header",
    "parse_header",
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
