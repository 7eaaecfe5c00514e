"""Telemetry core: thread-safe counters, gauges, histograms and spans (the
port of ``dmlc_tpu/telemetry/core.py``).

Four primitives, all process-global and thread-safe, with the JAX
package's names, bucket bounds and snapshot layout, so exporters and
dashboards read either package:

  * ``inc(stage, name, v)``        monotonic counters (dict add under a lock)
  * ``set_gauge(stage, name, v)``  last-write-wins gauges
  * ``observe(stage, name, v)``    fixed-bucket histograms (p50/p90/p99)
  * ``span(name, stage=...)``      nested, thread-aware timed spans in a
                                   bounded ring buffer (Chrome-trace
                                   exportable; see telemetry.exporters)

``timed`` records both the counter and the histogram under
``<name>_secs``.  ``span(..., profile=True)`` (and ``annotate``) also
opens a ``torch.profiler.record_function`` range while a profiler is
recording, so feed batches and the serving engine's phases show up in a
``torch.profiler`` trace; ``trace(log_dir)`` captures one around a
block and writes it as a Chrome trace.  The ring's clock is anchored
to the wall clock by one (``time.time_ns``, ``perf_counter_ns``) pair
(``anchor_epoch_ns``): a ``torch.profiler`` trace stamps host ranges
in wall-clock ns, so a span's ``ts`` converts to the profiler's
timeline (off only by what the wall clock has been slewed since).
"""

from __future__ import annotations

import contextlib
import math
import sys
import threading
import time
from bisect import bisect_left
from collections import defaultdict, deque
from typing import Dict, List, Optional

from ..base import get_env
from ..concurrency import make_lock

__all__ = [
    "Histogram",
    "DEFAULT_BOUNDS",
    "inc",
    "set_gauge",
    "observe",
    "observe_duration",
    "timed",
    "record_span",
    "span",
    "spans",
    "spans_since",
    "open_spans",
    "anchor_epoch",
    "anchor_epoch_ns",
    "annotate",
    "trace",
    "snapshot",
    "counters_snapshot",
    "reset",
]

# geometric bounds 1 µs .. ~134 s (doubling): one bucket set serves both
# microsecond-scale parse latencies and multi-second checkpoint saves
DEFAULT_BOUNDS = tuple(1e-6 * 2.0 ** i for i in range(28))

# spans ring capacity; bounded so a week-long run cannot OOM the host
_MAX_SPANS = get_env("DMLC_TELEMETRY_MAX_SPANS", 8192)


class Histogram:
    """Fixed-bucket histogram with percentile summaries.

    Bucket ``i`` covers ``(bounds[i-1], bounds[i]]``; the final bucket is
    the ``+Inf`` overflow — the same cumulative ``le`` semantics as a
    Prometheus histogram, so export is a direct rendering.  Percentiles
    interpolate linearly inside the bucket and clamp to the observed
    min/max, which keeps p50 exact-ish even with coarse buckets.
    Mutation is NOT internally locked: callers go through the
    module-level functions, which hold the registry lock.
    """

    __slots__ = ("bounds", "counts", "total", "count", "vmin", "vmax")

    def __init__(self, bounds=None):
        self.bounds = tuple(bounds) if bounds is not None else DEFAULT_BOUNDS
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.total += v
        self.count += 1
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def percentile(self, q: float) -> Optional[float]:
        """q-th percentile (0-100) estimated from bucket counts."""
        if self.count == 0:
            return None
        rank = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if c and cum >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                frac = (rank - (cum - c)) / c
                val = lo + frac * (hi - lo)
                return min(max(val, self.vmin), self.vmax)
        return self.vmax

    def summary(self, include_buckets: bool = True) -> Dict:
        out = {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }
        if include_buckets:
            out["bounds"] = list(self.bounds)
            out["buckets"] = list(self.counts)
        return out

    @classmethod
    def from_dict(cls, d: Dict) -> "Histogram":
        """Rebuild from a ``summary(include_buckets=True)`` dict, so
        aggregation can merge bucket counts.
        Every field is coerced eagerly: garbage raises TypeError /
        ValueError HERE, where wire-facing callers catch it, instead of
        being stored and crashing a later summary()/merge()."""
        bounds = d.get("bounds")
        if bounds is not None:
            bounds = tuple(float(b) for b in bounds)
        h = cls(bounds)
        buckets = d.get("buckets")
        if buckets is not None and len(buckets) == len(h.counts):
            h.counts = [int(c) for c in buckets]
        h.count = int(d.get("count", 0))
        h.total = float(d.get("sum", 0.0))
        h.vmin = float(d["min"]) if d.get("min") is not None else math.inf
        h.vmax = float(d["max"]) if d.get("max") is not None else -math.inf
        return h

    def merge(self, other: "Histogram") -> None:
        """Accumulate ``other`` into self (cluster-wide aggregation).
        Bucket counts merge only for identical bounds; count/sum/min/max
        always merge."""
        if other.bounds == self.bounds:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)


# ---------------------------------------------------------------------------
# process-global registry
# ---------------------------------------------------------------------------

_lock = make_lock("telemetry_core._lock")
_counters: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
_gauges: Dict[str, Dict[str, float]] = defaultdict(dict)
_hists: Dict[str, Dict[str, Histogram]] = defaultdict(dict)
_spans: deque = deque(maxlen=_MAX_SPANS)
_span_seq = 0  # monotone id per recorded span (incremental trace shipping)
# the span clock's anchor, one pair of reads: span ts (µs since _T0) +
# _T0_EPOCH places a span on this process's wall clock (the /spans
# endpoint ships it beside the spans; a torch.profiler trace stamps
# host ranges in wall-clock ns, so ts * 1e3 + _T0_EPOCH_NS is the
# span's start on the profiler's timeline)
_T0_NS = time.perf_counter_ns()
_T0_EPOCH_NS = time.time_ns()
_T0 = _T0_NS / 1e9  # process-relative span clock (µs in exports)
_T0_EPOCH = _T0_EPOCH_NS / 1e9
_tls = threading.local()
# tid -> (thread, open-span stack): the spans every thread is INSIDE
# right now, not just finished ones
_open_stacks: Dict[int, tuple] = {}


def inc(stage: str, name: str, value: float = 1.0) -> None:
    """Add ``value`` to counter ``name`` of ``stage``."""
    with _lock:
        _counters[stage][name] += value


def set_gauge(stage: str, name: str, value: float) -> None:
    """Set gauge ``name`` of ``stage`` to ``value`` (last write wins)."""
    with _lock:
        _gauges[stage][name] = float(value)


def observe(stage: str, name: str, value: float, bounds=None) -> None:
    """Record ``value`` into the histogram ``name`` of ``stage``.  The
    first observation fixes the bucket bounds."""
    with _lock:
        h = _hists[stage].get(name)
        if h is None:
            h = _hists[stage][name] = Histogram(bounds)
        h.observe(value)


def observe_duration(stage: str, name: str, secs: float) -> None:
    """Duration convention: counter ``<name>_secs`` += secs (the flat
    total old call sites read) plus a histogram observation under the
    same key (the distribution new consumers read)."""
    key = name + "_secs"
    with _lock:
        _counters[stage][key] += secs
        h = _hists[stage].get(key)
        if h is None:
            h = _hists[stage][key] = Histogram()
        h.observe(secs)


@contextlib.contextmanager
def timed(stage: str, name: str):
    """Time a block into counter + histogram ``<name>_secs`` of ``stage``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        observe_duration(stage, name, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------

def _span_stack() -> List[Dict]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
        th = threading.current_thread()
        with _lock:
            _open_stacks[th.ident] = (th, stack)
    return stack


def profiling() -> bool:
    """Whether a ``torch.profiler`` is recording: one module attribute
    read, no call into torch (False before torch is imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return bool(prof is not None
                and getattr(prof, "_is_profiler_enabled", True))


@contextlib.contextmanager
def span(name: str, stage: str = "dmlc", args: Optional[Dict] = None,
         profile: bool = False):
    """Nested, thread-aware timed span recorded into the bounded ring.

    Nesting is tracked per thread (a span opened inside another on the
    same thread records ``depth`` = enclosing count); Perfetto nests by
    ts/dur containment per tid, so exports render the tree directly.
    ``profile=True`` also opens a ``record_function`` range of the same
    name while a profiler records (:func:`profiling`); without one it
    costs that one check.
    """
    global _span_seq
    stack = _span_stack()
    t0 = time.perf_counter()
    stack.append({"name": name, "cat": stage, "ts": (t0 - _T0) * 1e6,
                  "args": dict(args) if args else None})
    ranged = None
    if profile and profiling():
        from torch.autograd.profiler import record_function

        ranged = record_function(name)
        ranged.__enter__()
    try:
        yield
    finally:
        if ranged is not None:
            ranged.__exit__(None, None, None)
        t1 = time.perf_counter()
        stack.pop()
        th = threading.current_thread()
        rec = {
            "name": name,
            "cat": stage,
            "ts": (t0 - _T0) * 1e6,
            "dur": (t1 - t0) * 1e6,
            "tid": th.ident,
            "thread": th.name,
            "depth": len(stack),
        }
        if args:
            rec["args"] = dict(args)
        with _lock:
            _span_seq += 1
            rec["seq"] = _span_seq
            _spans.append(rec)


def record_span(name: str, stage: str = "dmlc", *, t0: float, t1: float,
                tid=None, thread: Optional[str] = None,
                args: Optional[Dict] = None) -> Dict:
    """Record an ALREADY-COMPLETED span into the ring.

    ``t0``/``t1`` are ``time.perf_counter()`` stamps (the span clock's
    timebase).  Unlike :func:`span`, the caller may assign a synthetic
    ``tid``/``thread`` — the request ledger (telemetry.requests) draws
    each request's lifecycle (queue → prefill → decode slices) on its
    own per-request row of the Chrome trace this way, and the record
    lands in the ordinary ring that ``/trace`` and ``/spans`` export.
    Synthetic spans do not touch the per-thread open-span
    stacks (they are closed by construction)."""
    global _span_seq
    th = threading.current_thread()
    rec: Dict = {
        "name": name,
        "cat": stage,
        "ts": (t0 - _T0) * 1e6,
        "dur": max(t1 - t0, 0.0) * 1e6,
        "tid": th.ident if tid is None else tid,
        "thread": th.name if thread is None else str(thread),
        "depth": 0,
    }
    if args:
        rec["args"] = dict(args)
    with _lock:
        _span_seq += 1
        rec["seq"] = _span_seq
        _spans.append(rec)
    return rec


def spans() -> List[Dict]:
    """Copy of the span ring, oldest first."""
    with _lock:
        return list(_spans)


def spans_since(after_seq: int, limit: Optional[int] = None) -> tuple:
    """(new_spans, last_seq): spans recorded after ``after_seq``, oldest
    first, capped at the OLDEST ``limit`` — a shipper that falls behind
    catches up over subsequent calls instead of losing the middle.  The
    incremental-shipping primitive behind the server's ``/spans``:
    resume from the returned ``last_seq``.  When nothing was truncated,
    ``last_seq`` is the high-water mark INCLUDING ring-evicted spans,
    so a slow shipper skips the evicted gap (gone from the ring, not
    recoverable) rather than resending the whole ring forever; when
    ``limit`` truncated, it is the last RETURNED span's seq, so the
    still-retained remainder ships next call."""
    out = []
    with _lock:
        # seqs rise along the ring: walk in from the newest end, so a
        # cursor near the head costs the spans after it, not the ring
        for r in reversed(_spans):
            if r["seq"] <= after_seq:
                break
            out.append(r)
        last = _span_seq
    out.reverse()
    if limit is not None and len(out) > limit:
        out = out[:limit]
        last = out[-1]["seq"]
    return out, last


def span_seq() -> int:
    """Current span high-water mark (the seq of the newest recorded
    span, including ring-evicted ones).  A cheap cursor for interval
    consumers — the step ledger stamps it at ``step_begin`` and asks
    :func:`spans_since` for everything the step enclosed."""
    with _lock:
        return _span_seq


def now_ts() -> float:
    """Current time in the span timebase (µs since the process span
    epoch) — lets interval consumers clip span [ts, ts+dur] extents
    against their own window (the step ledger's overlapped-collective
    accounting)."""
    return (time.perf_counter() - _T0) * 1e6


def counter_value(stage: str, name: str, default: float = 0.0) -> float:
    """One counter's current value without copying the whole registry —
    the step ledger reads per-step deltas (bytes fed, flash FLOPs) on
    the hot path, where a full ``counters_snapshot()`` per step would
    be a dict-copy tax proportional to total metric count."""
    with _lock:
        vals = _counters.get(stage)
        return vals.get(name, default) if vals else default


def open_spans() -> List[Dict]:
    """Spans currently OPEN on any thread (innermost last per thread) —
    what every thread was doing right now."""
    now_ts = (time.perf_counter() - _T0) * 1e6
    with _lock:
        stacks = [(th, list(stack)) for th, stack in _open_stacks.values()]
    out = []
    for th, stack in stacks:
        for depth, rec in enumerate(stack):
            if not isinstance(rec, dict):  # torn mid-append: skip
                continue
            out.append({
                "name": rec["name"], "cat": rec["cat"], "ts": rec["ts"],
                "open_us": now_ts - rec["ts"], "tid": th.ident,
                "thread": th.name, "depth": depth,
                **({"args": rec["args"]} if rec.get("args") else {}),
            })
    return out


def anchor_epoch() -> float:
    """Wall-clock time (time.time) corresponding to span ts == 0."""
    return _T0_EPOCH


def anchor_epoch_ns() -> int:
    """Wall-clock ns (``time.time_ns``) corresponding to span ts == 0,
    read in one pair with the span clock's origin."""
    return _T0_EPOCH_NS


@contextlib.contextmanager
def annotate(name: str):
    """Named span in BOTH our ring buffer and, while a profiler
    records, the ``torch.profiler`` trace."""
    with span(name, stage="annotate", profile=True):
        yield


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host ops, and the card's
    kernels where there is one) around a block and write it to
    ``<log_dir>/trace.json`` as a Chrome trace (e.g. a bench run)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

def counters_snapshot() -> Dict[str, Dict[str, float]]:
    """Flat stage → name → value counter copy."""
    with _lock:
        return {stage: dict(vals) for stage, vals in _counters.items()}


def snapshot(include_buckets: bool = True) -> Dict:
    """Full structured snapshot: counters, gauges, and histogram
    summaries with p50/p90/p99 (plus raw buckets for merging unless
    ``include_buckets`` is False)."""
    with _lock:
        return {
            "counters": {s: dict(v) for s, v in _counters.items()},
            "gauges": {s: dict(v) for s, v in _gauges.items()},
            "histograms": {
                s: {n: h.summary(include_buckets) for n, h in hs.items()}
                for s, hs in _hists.items()
            },
        }


def reset() -> None:
    """Clear every counter, gauge, histogram, and recorded span
    (test isolation).  Open-span stacks of LIVE threads are left alone
    (they own their list objects mid-span); dead threads' are pruned."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _spans.clear()
        for tid in [t for t, (th, _s) in _open_stacks.items()
                    if not th.is_alive() and th is not threading.main_thread()]:
            del _open_stacks[tid]
