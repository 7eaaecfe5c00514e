"""Job-level goodput/badput ledger and the serving availability ledger
(the port of ``dmlc_tpu/telemetry/goodput.py``, with its bucket
taxonomy, priority sweep, ``DMLC_GOODPUT_*`` knobs and JSON keys).

``GoodputLedger``
    Per-process.  Sweeps the telemetry span ring (checkpoint.save /
    checkpoint.restore / feed.wait / compile:* / step spans) plus explicit
    :meth:`GoodputLedger.enter` overrides into a partition of wall time:
    every instant lands in exactly **one** bucket, so ``sum(buckets) ==
    wall`` holds by construction.  Ships on the heartbeat ``goodput``
    sub-doc.  The port compiles nothing at run time, so ``compile`` stays
    0 (no ``compile:*`` span is recorded).

``GoodputAggregator``
    Tracker-side.  Ingests per-rank docs (cumulative per-bucket seconds,
    re-shipped fully every beat so a dropped beat or a rank remap
    self-corrects), tracks death→relaunch gaps as cluster ``preempted``
    seconds, survives elastic renumbering via :meth:`remap_ranks`, and
    renders ``GET /goodput`` + the ``dmlc_goodput_*`` gauge families.

``AvailabilityLedger``
    The serving twin: a replica's wall clock partitioned into serving /
    draining / crashed_recovering / starved_idle, plus tokens served
    against capacity-tokens (peak observed decode rate × wall).

Attribution: explicit ``enter()`` overrides win over span evidence,
specific badput spans (checkpoint/feed/compile) win over the generic
``step`` span (productive), and the base is ``startup`` until the first
step, ``unattributed`` after.  The sweep horizon never passes the start
of an *open* attributable span on the owner thread, so a span closing
after a sample is never counted twice; the tail between horizon and
"now" is classified provisionally at report time, so the partition holds
at every :func:`status` call.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..base import get_env
from ..concurrency import make_lock
from . import core, exporters

__all__ = [
    "BUCKETS",
    "BADPUT_BUCKETS",
    "GoodputLedger",
    "GoodputAggregator",
    "AvailabilityLedger",
    "AVAILABILITY_STATES",
    "ledger",
    "status",
    "enter",
    "on_step",
    "reset_goodput",
]

# The full taxonomy.  ``productive`` is in-step time; everything else is
# badput.  Order is the canonical render/report order.
BUCKETS: Tuple[str, ...] = (
    "productive",
    "startup",
    "compile",
    "feed_stall",
    "checkpoint_save",
    "checkpoint_restore",
    "resize",
    "rollback_replay",
    "preempted",
    "unattributed",
)

BADPUT_BUCKETS: Tuple[str, ...] = tuple(b for b in BUCKETS if b != "productive")

# Span-name → (bucket, specific?) mapping for the sweep.  Specific spans
# (badput with a precise cause) out-rank the generic ``step`` span so a
# checkpoint.save or feed.wait *inside* a step is carved out of
# productive time, matching the step ledger's stall families.
_SPAN_BUCKETS = {
    "checkpoint.save": "checkpoint_save",
    "checkpoint.restore": "checkpoint_restore",
    "feed.wait": "feed_stall",
}

_PRI_EXPLICIT = 0  # enter() override — always wins
_PRI_SPECIFIC = 1  # checkpoint/feed/compile spans
_PRI_STEP = 2      # step span → productive
_PRI_BASE = 3      # startup / unattributed residual


def _span_bucket(name: str, cat: str) -> Optional[Tuple[str, int]]:
    """Classify a span record into (bucket, priority), or None."""
    b = _SPAN_BUCKETS.get(name)
    if b is not None:
        return (b, _PRI_SPECIFIC)
    if name.startswith("compile:"):
        return ("compile", _PRI_SPECIFIC)
    if name == "step" and cat == "step":
        return ("productive", _PRI_STEP)
    return None


class GoodputLedger:
    """Wall-clock partition for one process.  Thread-safe; cheap enough
    to sample on every heartbeat."""

    def __init__(self, *, window_s: Optional[float] = None,
                 max_intervals: Optional[int] = None):
        self._lock = make_lock("GoodputLedger._lock")
        if window_s is None:
            window_s = get_env("DMLC_GOODPUT_WINDOW_S", 60.0)
        if max_intervals is None:
            max_intervals = get_env("DMLC_GOODPUT_MAX_INTERVALS", 64)
        self.window_s = float(window_s)
        self.max_intervals = int(max_intervals)
        # The ledger accounts the *entire* run: ts 0 is process start on
        # the span timebase (anchor_epoch() + 0), not ledger creation.
        self._t0_us = 0.0
        self._cursor_us = self._t0_us   # swept up to here
        self._span_cursor = 0           # span ring cursor (from the top)
        self._pending_spans: List[Dict] = []
        self._acc: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        # Explicit override state: current bucket (or None) + transition
        # log [(ts_us, bucket-or-None)] not yet consumed by the sweep.
        self._override: Optional[str] = None
        self._override_since_us: Optional[float] = None
        self._transitions: List[Tuple[float, Optional[str]]] = []
        self._owner_tid: Optional[int] = None
        # Throughput accounting (fed by the step ledger's on_step hook).
        self._tokens = 0.0
        self._steps = 0
        self._in_step_s = 0.0
        self._first_step_us: Optional[float] = None
        # Rolling (t_us, tokens, in_step_s) snapshots for the window doc.
        self._snaps: deque = deque()
        # Closed badput intervals for forensics: dicts with a local seq.
        self._intervals: deque = deque(maxlen=self.max_intervals)
        self._interval_seq = 0

    # -- explicit hooks ------------------------------------------------

    def _adopt_tid(self) -> None:
        if self._owner_tid is None:
            self._owner_tid = threading.get_ident()

    def enter(self, bucket: Optional[str]) -> Optional[str]:
        """Enter an explicit interval (``None`` clears the override).

        Returns the *previous* override so call sites can restore it —
        the resize path re-enters whatever interval it was in before
        ``WorldResized`` instead of leaking recovery into unattributed::

            prev = ledger.enter("resize")
            ...  # drain generation, resize, resync
            ledger.enter(prev)
        """
        if bucket is not None and bucket not in BUCKETS:
            raise ValueError(f"unknown goodput bucket: {bucket!r}")
        with self._lock:
            self._adopt_tid()
            now = core.now_ts()
            prev = self._override
            if bucket == prev:
                return prev
            if prev is not None and prev != "productive" \
                    and self._override_since_us is not None:
                self._record_interval(prev, self._override_since_us, now)
            self._override = bucket
            self._override_since_us = now if bucket is not None else None
            self._transitions.append((now, bucket))
            return prev

    def on_step(self, *, tokens: float = 0.0, step_s: float = 0.0) -> None:
        """Fed by the step ledger at each step_end: throughput numerator
        plus in-step wall for the effective-vs-in-step comparison."""
        with self._lock:
            self._adopt_tid()
            now = core.now_ts()
            if self._first_step_us is None:
                self._first_step_us = max(now - step_s * 1e6, self._t0_us)
            self._tokens += float(tokens)
            self._steps += 1
            self._in_step_s += float(step_s)
            self._snaps.append((now, self._tokens, self._in_step_s))
            horizon = (now - self.window_s * 2.0 * 1e6)
            while len(self._snaps) > 2 and self._snaps[0][0] < horizon:
                self._snaps.popleft()

    def _record_interval(self, bucket: str, t0_us: float, t1_us: float) -> None:
        # lock held
        dur = (t1_us - t0_us) / 1e6
        if dur <= 0.0:
            return
        anchor = core.anchor_epoch()
        self._interval_seq += 1
        self._intervals.append({
            "seq": self._interval_seq,
            "bucket": bucket,
            "t0": anchor + t0_us / 1e6,
            "t1": anchor + t1_us / 1e6,
            "dur_s": dur,
        })

    # -- the sweep -----------------------------------------------------

    def _base_bucket(self, ts_us: float) -> str:
        if self._first_step_us is None or ts_us < self._first_step_us:
            return "startup"
        return "unattributed"

    def _collect_layers(self, lo: float, hi: float, spans: List[Dict],
                        open_extra: Optional[List[Dict]] = None
                        ) -> List[Tuple[float, float, str, int]]:
        """Clip span/override evidence into (t0, t1, bucket, priority)
        layers covering [lo, hi].  lock held."""
        tid = self._owner_tid
        layers: List[Tuple[float, float, str, int]] = []
        for rec in spans:
            if tid is not None and rec.get("tid") != tid:
                continue
            bp = _span_bucket(rec.get("name", ""), rec.get("cat", ""))
            if bp is None:
                continue
            s = rec["ts"]
            e = s + rec.get("dur", 0.0)
            s, e = max(s, lo), min(e, hi)
            if e > s:
                layers.append((s, e, bp[0], bp[1]))
        for rec in (open_extra or ()):
            if tid is not None and rec.get("tid") != tid:
                continue
            bp = _span_bucket(rec.get("name", ""), rec.get("cat", ""))
            if bp is None:
                continue
            s = max(rec["ts"], lo)
            if hi > s:
                layers.append((s, hi, bp[0], bp[1]))
        # Explicit override intervals from the transition log + current.
        prev_ts: Optional[float] = None
        prev_bucket: Optional[str] = None
        start_bucket: Optional[str] = None
        # Reconstruct override state at `lo`: walk transitions <= lo.
        for ts, b in self._transitions:
            if ts <= lo:
                start_bucket = b
            else:
                if prev_ts is None:
                    prev_ts, prev_bucket = lo, start_bucket
                if prev_bucket is not None:
                    s, e = max(prev_ts, lo), min(ts, hi)
                    if e > s:
                        layers.append((s, e, prev_bucket, _PRI_EXPLICIT))
                prev_ts, prev_bucket = ts, b
        if prev_ts is None:
            prev_ts, prev_bucket = lo, start_bucket
        if prev_bucket is not None and hi > prev_ts:
            layers.append((max(prev_ts, lo), hi, prev_bucket, _PRI_EXPLICIT))
        return layers

    @staticmethod
    def _sweep(lo: float, hi: float, layers, base_fn) -> Dict[str, float]:
        """Partition [lo, hi] among layers by priority; returns seconds
        per bucket.  Every instant lands in exactly one bucket."""
        out: Dict[str, float] = {}
        if hi <= lo:
            return out
        bounds = {lo, hi}
        for s, e, _b, _p in layers:
            bounds.add(s)
            bounds.add(e)
        pts = sorted(bounds)
        for a, b in zip(pts[:-1], pts[1:]):
            if b <= a:
                continue
            mid = (a + b) / 2.0
            best: Optional[Tuple[int, float, str]] = None
            for s, e, bucket, pri in layers:
                if s <= mid < e:
                    # Among equal priority, the later-starting (inner
                    # nested) span wins.
                    key = (pri, -s, bucket)
                    if best is None or key < (best[0], best[1], best[2]):
                        best = (pri, -s, bucket)
            bucket = best[2] if best is not None else base_fn(mid)
            out[bucket] = out.get(bucket, 0.0) + (b - a) / 1e6
        return out

    def _advance(self) -> None:
        """Fold settled evidence into the cumulative accumulator.  The
        horizon stops at the earliest *open* attributable span on the
        owner thread, so closed spans processed here can never overlap
        a span that will close later.  lock held."""
        now = core.now_ts()
        spans, self._span_cursor = core.spans_since(self._span_cursor)
        horizon = now
        open_now = core.open_spans()
        tid = self._owner_tid
        for rec in open_now:
            if tid is not None and rec.get("tid") != tid:
                continue
            if _span_bucket(rec.get("name", ""), rec.get("cat", "")) is None:
                continue
            horizon = min(horizon, rec["ts"])
        horizon = max(horizon, self._cursor_us)
        self._pending_spans.extend(
            r for r in spans
            if _span_bucket(r.get("name", ""), r.get("cat", "")) is not None)
        layers = self._collect_layers(self._cursor_us, horizon,
                                      self._pending_spans)
        part = self._sweep(self._cursor_us, horizon, layers,
                           self._base_bucket)
        for b, s in part.items():
            self._acc[b] = self._acc.get(b, 0.0) + s
        # Record span-derived badput episodes for forensics (explicit
        # intervals are recorded at enter(); avoid double-recording by
        # only taking spans not covered by an override).
        for rec in self._pending_spans:
            e = rec["ts"] + rec.get("dur", 0.0)
            if e > horizon:
                continue
            bp = _span_bucket(rec.get("name", ""), rec.get("cat", ""))
            if bp is None or bp[0] == "productive":
                continue
            if self._covered_by_override(rec["ts"], e):
                continue
            if rec.get("dur", 0.0) / 1e6 >= 0.01:
                self._record_interval(bp[0], rec["ts"], e)
        # Drop spans fully behind the new cursor; keep stragglers that
        # extend past the horizon for the next advance.
        self._pending_spans = [
            r for r in self._pending_spans
            if r["ts"] + r.get("dur", 0.0) > horizon]
        # Compact the transition log: keep the last transition at or
        # before the new cursor (it defines the state) plus later ones.
        keep_from = 0
        for i, (ts, _b) in enumerate(self._transitions):
            if ts <= horizon:
                keep_from = i
        self._transitions = self._transitions[keep_from:]
        self._cursor_us = horizon

    def _covered_by_override(self, s: float, e: float) -> bool:
        # lock held; True if [s, e) midpoint falls inside an explicit
        # override interval (the override wins the sweep there anyway).
        mid = (s + e) / 2.0
        state: Optional[str] = None
        for ts, b in self._transitions:
            if ts <= mid:
                state = b
            else:
                break
        return state is not None

    # -- reports -------------------------------------------------------

    def sample(self) -> None:
        """Advance the settled accumulator (heartbeat calls status(),
        which samples; explicit sample() is for tests)."""
        with self._lock:
            self._advance()

    def status(self) -> Dict:
        """Full decomposition.  Buckets sum to wall at every call: the
        settled accumulator covers [t0, cursor] and the tail
        [cursor, now] is classified provisionally (open spans + current
        override + base) without advancing cursors."""
        with self._lock:
            self._advance()
            now = core.now_ts()
            wall = (now - self._t0_us) / 1e6
            buckets = dict(self._acc)
            # Provisional tail: pending closed spans that straddle the
            # horizon plus open spans plus the live override.
            tail_layers = self._collect_layers(
                self._cursor_us, now, self._pending_spans,
                open_extra=core.open_spans())
            for b, s in self._sweep(self._cursor_us, now, tail_layers,
                                    self._base_bucket).items():
                buckets[b] = buckets.get(b, 0.0) + s
            eff = self._tokens / wall if wall > 0 else 0.0
            in_step = (self._tokens / self._in_step_s
                       if self._in_step_s > 0 else 0.0)
            win = self._window_doc(now)
            return {
                "t": time.time(),
                "anchor": core.anchor_epoch(),
                "wall_s": wall,
                "buckets": buckets,
                "goodput_fraction": (buckets.get("productive", 0.0) / wall
                                     if wall > 0 else 0.0),
                "tokens": self._tokens,
                "steps": self._steps,
                "in_step_s": self._in_step_s,
                "effective_tokens_per_s": eff,
                "in_step_tokens_per_s": in_step,
                "window": win,
                "current": self._classify_now(now),
                "intervals": list(self._intervals)[-16:],
            }

    def _window_doc(self, now_us: float) -> Dict:
        # lock held
        lo = now_us - self.window_s * 1e6
        base: Optional[Tuple[float, float, float]] = None
        for snap in self._snaps:
            if snap[0] >= lo:
                break
            base = snap
        if base is None:
            base = (self._t0_us, 0.0, 0.0)
        dt = (now_us - base[0]) / 1e6
        dtok = self._tokens - base[1]
        dstep = self._in_step_s - base[2]
        return {
            "wall_s": dt,
            "tokens": dtok,
            "effective_tokens_per_s": dtok / dt if dt > 0 else 0.0,
            "in_step_tokens_per_s": dtok / dstep if dstep > 0 else 0.0,
        }

    def _classify_now(self, now_us: float) -> str:
        # lock held — provisional bucket of this very instant.
        if self._override is not None:
            return self._override
        best: Optional[Tuple[int, float, str]] = None
        tid = self._owner_tid
        for rec in core.open_spans():
            if tid is not None and rec.get("tid") != tid:
                continue
            bp = _span_bucket(rec.get("name", ""), rec.get("cat", ""))
            if bp is None:
                continue
            key = (bp[1], -rec["ts"], bp[0])
            if best is None or key < best:
                best = key
        if best is not None:
            return best[2]
        return self._base_bucket(now_us)


# ---------------------------------------------------------------------------
# Module-level singleton (mirrors steps.ledger() / selfheal.status()).

_ledger_lock = make_lock("goodput._ledger_lock")
_ledger: Optional[GoodputLedger] = None


def ledger() -> GoodputLedger:
    """The process-wide goodput ledger (created on first use)."""
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = GoodputLedger()
        return _ledger


def status() -> Optional[Dict]:
    """Heartbeat hook: the ledger's decomposition, or None if the
    process never touched goodput accounting (no sub-doc shipped)."""
    with _ledger_lock:
        led = _ledger
    if led is None:
        return None
    return led.status()


def enter(bucket: Optional[str]) -> Optional[str]:
    """Module-level convenience for ``ledger().enter(bucket)``."""
    return ledger().enter(bucket)


def on_step(*, tokens: float = 0.0, step_s: float = 0.0) -> None:
    """Step-ledger hook (lazy: only feeds an already-created ledger, so
    merely using the step ledger does not opt a process into goodput
    heartbeat sub-docs)."""
    with _ledger_lock:
        led = _ledger
    if led is not None:
        led.on_step(tokens=tokens, step_s=step_s)


def reset_goodput() -> None:
    """Drop the singleton (tests)."""
    global _ledger
    with _ledger_lock:
        _ledger = None


# ---------------------------------------------------------------------------
# Tracker-side aggregation.


class GoodputAggregator:
    """Cluster goodput: per-rank docs + tracker-observed preemption gaps.

    Ranks re-ship cumulative bucket seconds every beat, so ingest is
    idempotent and self-correcting: after :meth:`remap_ranks` (elastic
    renumbering) or :meth:`drop`, one fresh beat restores truth.  A rank
    the tracker declared dead accrues ``preempted`` seconds until a doc
    with a *new* anchor (a relaunched process) arrives under that rank.
    """

    def __init__(self):
        self._lock = make_lock("GoodputAggregator._lock")
        self._docs: Dict[int, Dict] = {}
        self._dead_since: Dict[int, float] = {}
        self._gap_s: Dict[int, float] = {}
        self._intervals: Dict[int, Dict[int, Dict]] = {}

    def ingest(self, rank: int, doc: Dict) -> None:
        if not isinstance(doc, dict) or "buckets" not in doc:
            return
        with self._lock:
            prev = self._docs.get(rank)
            if rank in self._dead_since:
                # Relaunch under the same rank: close the gap.
                self._gap_s[rank] = (self._gap_s.get(rank, 0.0)
                                     + time.time() - self._dead_since.pop(rank))
            elif prev is not None and doc.get("anchor") != prev.get("anchor"):
                # New incarnation we never saw die — count the blind gap.
                gap = doc.get("t", time.time()) - prev.get("t", 0.0) \
                    - doc.get("wall_s", 0.0)
                if gap > 0:
                    self._gap_s[rank] = self._gap_s.get(rank, 0.0) + gap
            self._docs[rank] = doc
            store = self._intervals.setdefault(rank, {})
            for iv in doc.get("intervals", ()) or ():
                try:
                    store[int(iv["seq"])] = iv
                except (KeyError, TypeError, ValueError):
                    continue
            while len(store) > 256:
                store.pop(min(store))

    def mark_dead(self, rank: int) -> None:
        """The tracker declared this rank dead; wall time until a
        relaunched process reports under this rank is ``preempted``."""
        with self._lock:
            self._dead_since.setdefault(rank, time.time())

    def drop(self, rank: int) -> None:
        with self._lock:
            self._docs.pop(rank, None)
            self._dead_since.pop(rank, None)
            self._gap_s.pop(rank, None)
            self._intervals.pop(rank, None)

    def remap_ranks(self, rank_map: Dict[int, int]) -> None:
        """Apply an elastic renumbering (old → new).  Unmapped ranks are
        dropped; data follows the surviving process."""
        with self._lock:
            for store in (self._docs, self._dead_since, self._gap_s,
                          self._intervals):
                moved = {rank_map[r]: v for r, v in store.items()
                         if r in rank_map}
                store.clear()
                store.update(moved)

    def badput_intervals(self) -> List[Dict]:
        """All known badput intervals (rank-tagged), wall-ordered — the
        forensics feed."""
        with self._lock:
            out = []
            for rank, store in self._intervals.items():
                for seq, iv in store.items():
                    d = dict(iv)
                    d["rank"] = rank
                    out.append(d)
        out.sort(key=lambda d: d.get("t0", 0.0))
        return out

    def report(self) -> Dict:
        with self._lock:
            now = time.time()
            per_rank = {}
            cluster = {b: 0.0 for b in BUCKETS}
            wall_total = 0.0
            tokens = 0.0
            in_step_s = 0.0
            for rank, doc in sorted(self._docs.items()):
                buckets = dict(doc.get("buckets", {}))
                gap = self._gap_s.get(rank, 0.0)
                if rank in self._dead_since:
                    gap += now - self._dead_since[rank]
                if gap > 0:
                    buckets["preempted"] = buckets.get("preempted", 0.0) + gap
                wall = doc.get("wall_s", 0.0) + gap
                per_rank[str(rank)] = {
                    "wall_s": wall,
                    "buckets": buckets,
                    "goodput_fraction": (buckets.get("productive", 0.0) / wall
                                         if wall > 0 else 0.0),
                    "tokens": doc.get("tokens", 0.0),
                    "effective_tokens_per_s":
                        doc.get("effective_tokens_per_s", 0.0),
                    "in_step_tokens_per_s":
                        doc.get("in_step_tokens_per_s", 0.0),
                    "current": doc.get("current"),
                }
                for b, s in buckets.items():
                    cluster[b] = cluster.get(b, 0.0) + s
                wall_total += wall
                tokens += doc.get("tokens", 0.0)
                in_step_s += doc.get("in_step_s", 0.0)
            # Dead ranks with no successor doc still accrue preempted.
            for rank, since in self._dead_since.items():
                if rank not in self._docs:
                    gap = now - since + self._gap_s.get(rank, 0.0)
                    cluster["preempted"] += gap
                    wall_total += gap
            fractions = {b: (s / wall_total if wall_total > 0 else 0.0)
                         for b, s in cluster.items()}
            return {
                "t": now,
                "ranks": len(self._docs),
                "per_rank": per_rank,
                "cluster": {
                    "wall_s": wall_total,
                    "buckets": cluster,
                    "fractions": fractions,
                    "goodput_fraction": fractions.get("productive", 0.0),
                    "tokens": tokens,
                    "effective_tokens_per_s": (tokens / wall_total
                                               if wall_total > 0 else 0.0),
                    "in_step_tokens_per_s": (tokens / in_step_s
                                             if in_step_s > 0 else 0.0),
                },
            }

    def prometheus_text(self) -> str:
        rep = self.report()
        lines: List[str] = []
        lines.append(exporters.help_type_lines(
            "dmlc_goodput_bucket_seconds", "gauge",
            "Cumulative wall-clock seconds per goodput bucket per rank."))
        for rank, doc in sorted(rep["per_rank"].items(), key=lambda kv: int(kv[0])):
            for b in BUCKETS:
                s = doc["buckets"].get(b, 0.0)
                lines.append('dmlc_goodput_bucket_seconds{rank="%s",bucket="%s"} %.6f'
                             % (rank, b, s))
        lines.append(exporters.help_type_lines(
            "dmlc_goodput_fraction", "gauge",
            "Fraction of wall-clock spent productive, per rank."))
        for rank, doc in sorted(rep["per_rank"].items(), key=lambda kv: int(kv[0])):
            lines.append('dmlc_goodput_fraction{rank="%s"} %.6f'
                         % (rank, doc["goodput_fraction"]))
        lines.append(exporters.help_type_lines(
            "dmlc_goodput_effective_tokens_per_s", "gauge",
            "Tokens per second of wall-clock (effective goodput), per rank."))
        for rank, doc in sorted(rep["per_rank"].items(), key=lambda kv: int(kv[0])):
            lines.append('dmlc_goodput_effective_tokens_per_s{rank="%s"} %.6f'
                         % (rank, doc["effective_tokens_per_s"]))
        cl = rep["cluster"]
        lines.append(exporters.help_type_lines(
            "dmlc_goodput_cluster_fraction", "gauge",
            "Cluster-wide goodput fraction (productive / total wall)."))
        lines.append("dmlc_goodput_cluster_fraction %.6f"
                     % cl["goodput_fraction"])
        lines.append(exporters.help_type_lines(
            "dmlc_goodput_cluster_bucket_seconds", "gauge",
            "Cluster-wide cumulative seconds per goodput bucket."))
        for b in BUCKETS:
            lines.append('dmlc_goodput_cluster_bucket_seconds{bucket="%s"} %.6f'
                         % (b, cl["buckets"].get(b, 0.0)))
        lines.append(exporters.help_type_lines(
            "dmlc_goodput_cluster_effective_tokens_per_s", "gauge",
            "Cluster tokens per second of wall-clock."))
        lines.append("dmlc_goodput_cluster_effective_tokens_per_s %.6f"
                     % cl["effective_tokens_per_s"])
        # help_type_lines returns "...\n" already; labeled lines don't.
        return "".join(
            ln if ln.endswith("\n") else ln + "\n" for ln in lines)



# ---------------------------------------------------------------------------
# Serving twin: per-replica availability.

AVAILABILITY_STATES: Tuple[str, ...] = (
    "serving",
    "draining",
    "crashed_recovering",
    "starved_idle",
)


class AvailabilityLedger:
    """Replica availability: a state machine whose state fractions sum
    to 1 by construction, plus tokens served vs. capacity-tokens (peak
    observed decode rate × wall) so the autoscaler's decisions can be
    audited against real capacity."""

    def __init__(self):
        self._lock = make_lock("AvailabilityLedger._lock")
        self._t0 = time.perf_counter()
        self._state = "serving"
        self._since = self._t0
        self._acc: Dict[str, float] = {s: 0.0 for s in AVAILABILITY_STATES}
        self._tokens = 0.0
        self._peak_rate = 0.0
        self._rate_mark: Optional[Tuple[float, float]] = None  # (t, tokens)

    def set_state(self, state: str) -> None:
        if state not in AVAILABILITY_STATES:
            raise ValueError(f"unknown availability state: {state!r}")
        with self._lock:
            now = time.perf_counter()
            if state == self._state:
                return
            self._acc[self._state] += now - self._since
            self._state = state
            self._since = now

    def note_tokens(self, n: float) -> None:
        """Record n tokens committed (decode iterations call this)."""
        if n <= 0:
            return
        with self._lock:
            now = time.perf_counter()
            self._tokens += n
            if self._rate_mark is None:
                self._rate_mark = (now, self._tokens)
            else:
                dt = now - self._rate_mark[0]
                if dt >= 0.5:
                    rate = (self._tokens - self._rate_mark[1]) / dt
                    if rate > self._peak_rate:
                        self._peak_rate = rate
                    self._rate_mark = (now, self._tokens)

    def report(self) -> Dict:
        with self._lock:
            now = time.perf_counter()
            wall = now - self._t0
            states = dict(self._acc)
            states[self._state] += now - self._since
            fractions = {s: (t / wall if wall > 0 else
                             (1.0 if s == self._state else 0.0))
                         for s, t in states.items()}
            capacity = self._peak_rate * wall
            return {
                "wall_s": wall,
                "state": self._state,
                "states": states,
                "fractions": fractions,
                "availability": fractions.get("serving", 0.0),
                "tokens_served": self._tokens,
                "capacity_tokens_per_s": self._peak_rate,
                "capacity_tokens": capacity,
                "capacity_utilization": (self._tokens / capacity
                                         if capacity > 0 else 0.0),
            }

    def prometheus_text(self) -> str:
        rep = self.report()
        lines: List[str] = []
        lines.append(exporters.help_type_lines(
            "dmlc_availability_state_seconds", "gauge",
            "Cumulative seconds this replica spent in each availability state."))
        for s in AVAILABILITY_STATES:
            lines.append('dmlc_availability_state_seconds{state="%s"} %.6f'
                         % (s, rep["states"][s]))
        lines.append(exporters.help_type_lines(
            "dmlc_availability_fraction", "gauge",
            "Fraction of wall-clock this replica was serving."))
        lines.append("dmlc_availability_fraction %.6f" % rep["availability"])
        lines.append(exporters.help_type_lines(
            "dmlc_availability_tokens_served_total", "counter",
            "Tokens committed by this replica since start."))
        lines.append("dmlc_availability_tokens_served_total %.6f"
                     % rep["tokens_served"])
        lines.append(exporters.help_type_lines(
            "dmlc_availability_capacity_tokens", "gauge",
            "Capacity-tokens (peak observed decode rate x wall-clock)."))
        lines.append("dmlc_availability_capacity_tokens %.6f"
                     % rep["capacity_tokens"])
        return "".join(
            ln if ln.endswith("\n") else ln + "\n" for ln in lines)
