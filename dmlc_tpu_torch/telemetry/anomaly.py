"""Tracker-side online anomaly watchdog over shipped step records (the
port of ``dmlc_tpu/telemetry/anomaly.py``: the same kinds, knobs, robust
statistics and documents).

The flight recorder made failures *reconstructable*; the watchdog makes
degradation *observable while it happens*.  It consumes the step-ledger
records each worker ships with its heartbeats (telemetry.steps →
heartbeat ``trace.steps``) and keeps robust online baselines — EWMA
per rank plus a median/MAD view across the cluster — chosen because
training step times are heavy-tailed (checkpoint steps, compilation,
GC) and a mean/stddev detector would either page on every checkpoint
or widen until real stragglers hide inside the band.

Four verdict kinds, each requiring ``DMLC_WATCHDOG_WINDOW`` (default 5)
*consecutive* offending steps before flagging (single-step spikes are
normal):

  * ``straggler``        rank step time > cluster median + k·MAD
                         (``DMLC_WATCHDOG_K``, default 4)
  * ``regression``       rank fast-EWMA > (1+r)·slow-EWMA baseline
                         (``DMLC_WATCHDOG_REGRESSION``, default 0.5)
  * ``feed_stall``       feed-wait fraction EWMA > threshold
                         (``DMLC_WATCHDOG_FEED_FRAC``, default 0.5)
  * ``goodput_collapse`` goodput EWMA < fraction of its own peak EWMA
                         (``DMLC_WATCHDOG_GOODPUT_FRAC``, default 0.5)

Fresh verdicts surface everywhere an operator might already be looking:
``dmlc_anomaly_*`` counters in the tracker registry (→ /metrics under
``rank="tracker"``), per-(rank, kind) ``dmlc_anomaly_active`` gauges
(→ /metrics via the aggregator's extra text hook), the structured event
ring (→ postmortems / JSONL), instant-marker rows on the merged /trace
timeline, and the ``/anomalies`` JSON endpoint that ``dmlc top`` polls.
Flags clear themselves when the offending condition stops holding.
"""

from __future__ import annotations

import json
import logging
import math
import time
from collections import deque
from typing import Dict, List, Optional

from ..base import get_env
from ..concurrency import make_lock
from .slo import SLO_KINDS

__all__ = ["Watchdog", "ANOMALY_KINDS", "COMPUTE_KINDS", "FLEET_KINDS",
           "GOODPUT_KINDS"]

logger = logging.getLogger("dmlc_tpu_torch.tracker")

ANOMALY_KINDS = ("straggler", "regression", "feed_stall",
                 "goodput_collapse")

# compute-ledger kinds ride the heartbeat ``compute`` sub-doc
# (telemetry.compute.status); like the SLO kinds they apply/clear
# directly from each shipped verdict — no consecutive-step gating
COMPUTE_KINDS = ("recompile_storm",)

# fleet-controller kinds ride the heartbeat ``fleet`` sub-doc (the
# autoscaler's status); the saturation verdict is the controller's own
# hysterized decision (scale-up wanted but no host/replica headroom),
# so flags apply/clear directly — no consecutive-step gating
FLEET_KINDS = ("fleet_saturated",)

# goodput-ledger kinds ride the heartbeat ``goodput`` sub-doc
# (telemetry.goodput.status): effective (wall-clock) tokens/s collapsing
# below DMLC_GOODPUT_MIN_FRACTION of the in-step rate over the ledger's
# window means the job is paying for badput, not compute — distinct from
# the step-gated ``goodput_collapse`` rule, which only sees in-step
# throughput and is blind to the time *between* steps.  Flags
# apply/clear directly from each shipped window — no step gating.
GOODPUT_KINDS = ("effective_goodput_collapse",)

# per-rank recent-step window used for the cluster median/MAD view
_RECENT = 32
# slow-baseline warmup: regression/goodput rules stay silent until a
# rank has this many steps (an EWMA seeded on compile-step times would
# flag the *recovery* to steady state as a change)
_WARMUP_STEPS = 12
# the slow baseline additionally ignores the first few steps entirely:
# step 1 is compile (way slow) or pre-gang-sync (way fast), and with
# alpha=0.02 whatever seeds the EWMA anchors it for hundreds of steps
_BASELINE_SKIP = 3
_EWMA_FAST = 0.3
_EWMA_SLOW = 0.02


def _lower_median(vals: List[float]) -> float:
    s = sorted(vals)
    return s[(len(s) - 1) // 2]


class _RankState:
    __slots__ = ("recent", "steps", "ewma_fast", "ewma_slow",
                 "goodput_ewma", "goodput_peak", "feed_frac_ewma",
                 "last", "last_seq", "anchor", "consec", "active",
                 "active_since", "remediation", "compute", "goodput")

    def __init__(self):
        self.recent: deque = deque(maxlen=_RECENT)
        self.steps = 0
        self.ewma_fast: Optional[float] = None
        self.ewma_slow: Optional[float] = None
        self.goodput_ewma: Optional[float] = None
        self.goodput_peak: Optional[float] = None
        self.feed_frac_ewma: Optional[float] = None
        self.last: Optional[Dict] = None
        self.last_seq = 0
        self.anchor: Optional[float] = None
        self.consec: Dict[str, int] = {k: 0 for k in ANOMALY_KINDS}
        self.active: set = set()
        self.active_since: Dict[str, float] = {}
        self.remediation: Optional[Dict] = None  # shipped selfheal doc
        self.compute: Optional[Dict] = None      # shipped compute doc
        self.goodput: Optional[Dict] = None      # shipped goodput window


def _ewma(prev: Optional[float], x: float, alpha: float) -> float:
    return x if prev is None else prev + alpha * (x - prev)


class Watchdog:
    """Online per-rank + cluster anomaly detection over step records."""

    MAX_VERDICTS = 256  # bounded recent-verdict ring for /anomalies

    def __init__(self, k: Optional[float] = None,
                 window: Optional[int] = None, log=logger):
        if k is None:
            k = get_env("DMLC_WATCHDOG_K", 4.0)
        if window is None:
            window = get_env("DMLC_WATCHDOG_WINDOW", 5)
        self.k = k
        self.window = max(1, window)
        self.regression_frac = get_env("DMLC_WATCHDOG_REGRESSION", 0.5)
        self.feed_frac = get_env("DMLC_WATCHDOG_FEED_FRAC", 0.5)
        self.goodput_frac = get_env("DMLC_WATCHDOG_GOODPUT_FRAC", 0.5)
        self.goodput_min_fraction = get_env("DMLC_GOODPUT_MIN_FRACTION", 0.5)
        self._log = log
        self._lock = make_lock("Watchdog._lock")
        self._ranks: Dict[int, _RankState] = {}
        self._verdicts: deque = deque(maxlen=self.MAX_VERDICTS)

    # ---- ingest ---------------------------------------------------------
    def ingest_json(self, rank: int, payload: str) -> None:
        """Pull ``trace.steps`` out of a heartbeat payload; malformed
        payloads are dropped (the aggregator already warned)."""
        try:
            doc = json.loads(payload)
            if not isinstance(doc, dict):
                return
            sh = doc.get("selfheal")
            if isinstance(sh, dict):
                self.ingest_remediation(rank, sh)
            slo = doc.get("slo")
            if isinstance(slo, dict):
                self.ingest_slo(rank, slo)
            comp = doc.get("compute")
            if isinstance(comp, dict):
                self.ingest_compute(rank, comp)
            fleet = doc.get("fleet")
            if isinstance(fleet, dict):
                self.ingest_fleet(rank, fleet)
            gd = doc.get("goodput")
            if isinstance(gd, dict):
                self.ingest_goodput(rank, gd)
            trace = doc.get("trace")
            if not isinstance(trace, dict):
                return
            steps = trace.get("steps")
            if steps:
                self.ingest(rank, steps, anchor=trace.get("anchor"))
        except Exception:  # noqa: BLE001 - accept loop must survive
            pass

    def ingest_remediation(self, rank: int, doc: Dict) -> None:
        """Record a worker's shipped self-heal status (a small scalar
        doc: last_action/reason/step/skips/rollbacks) so /anomalies and
        ``dmlc top`` show what the cluster DID about a flag, not just
        that one fired."""
        if rank < 0 or not isinstance(doc, dict):
            return
        clean = {}
        for k in ("last_action", "reason", "step", "skips", "rollbacks",
                  "consecutive", "t"):
            v = doc.get(k)
            if isinstance(v, (int, float)) or (isinstance(v, str)
                                               and len(v) <= 256):
                clean[k] = v
        if not clean:
            return
        with self._lock:
            st = self._ranks.setdefault(rank, _RankState())
            st.remediation = clean

    def ingest_slo(self, rank: int, doc: Dict) -> None:
        """Mirror a serving replica's shipped SLO status (the heartbeat
        ``slo`` sub-doc from telemetry.slo) into this rank's anomaly
        flags under :data:`SLO_KINDS`.  The burn-rate windows already
        hysterize on the worker side, so flags apply/clear directly —
        no consecutive-step gating — and step-record ingestion never
        touches them (its clear loop covers ANOMALY_KINDS only)."""
        if rank < 0 or not isinstance(doc, dict):
            return
        active = doc.get("active")
        if not isinstance(active, list):
            return
        active_set = {k for k in active if k in SLO_KINDS}
        burn = doc.get("burn") if isinstance(doc.get("burn"), dict) else {}
        fresh = []
        with self._lock:
            st = self._ranks.setdefault(rank, _RankState())
            for kind in SLO_KINDS:
                if kind in active_set and kind not in st.active:
                    st.active.add(kind)
                    st.active_since[kind] = time.time()
                    fresh.append((kind,
                                  f"replica-reported SLO violation "
                                  f"(burn {burn})"))
                elif kind not in active_set and kind in st.active:
                    st.active.discard(kind)
                    st.active_since.pop(kind, None)
                    self._log.info("anomaly cleared: rank %d %s",
                                   rank, kind)
        for kind, detail in fresh:
            self._flag(rank, kind, detail, {}, step_gated=False)

    def ingest_compute(self, rank: int, doc: Dict) -> None:
        """Mirror a worker's shipped compute-ledger status (the
        heartbeat ``compute`` sub-doc from telemetry.compute) into this
        rank's anomaly flags under :data:`COMPUTE_KINDS`.  The storm
        verdict is computed worker-side over a sliding window, so flags
        apply/clear directly — no consecutive-step gating — and
        step-record ingestion never touches them (its clear loop covers
        ANOMALY_KINDS only)."""
        if rank < 0 or not isinstance(doc, dict):
            return
        clean = {}
        for k in ("traces", "hits", "recompiles", "hbm_peak_bytes",
                  "hbm_headroom_bytes"):
            v = doc.get(k)
            if isinstance(v, (int, float)):
                clean[k] = v
        storm = doc.get("storm") if isinstance(doc.get("storm"), dict) \
            else {}
        storming = bool(storm.get("active"))
        hot = storm.get("sites")
        if isinstance(hot, list):
            clean["storm_sites"] = [
                str(s.get("site"))[:128] for s in hot[:8]
                if isinstance(s, dict)]
        fresh = []
        with self._lock:
            st = self._ranks.setdefault(rank, _RankState())
            st.compute = clean or None
            kind = "recompile_storm"
            if storming and kind not in st.active:
                st.active.add(kind)
                st.active_since[kind] = time.time()
                fresh.append((kind,
                              f"worker-reported recompile storm "
                              f"(sites {clean.get('storm_sites')})"))
            elif not storming and kind in st.active:
                st.active.discard(kind)
                st.active_since.pop(kind, None)
                self._log.info("anomaly cleared: rank %d %s", rank, kind)
        for kind, detail in fresh:
            self._flag(rank, kind, detail, {}, step_gated=False)

    def ingest_fleet(self, rank: int, doc: Dict) -> None:
        """Mirror a fleet controller's shipped status (the heartbeat
        ``fleet`` sub-doc from ``fleet.Autoscaler.status``) into this
        rank's anomaly flags under :data:`FLEET_KINDS`.  Saturation is
        the controller's own hysterized verdict — scale-up wanted but
        no host/replica headroom left — so flags apply/clear directly,
        no consecutive-step gating."""
        if rank < 0 or not isinstance(doc, dict):
            return
        saturated = bool(doc.get("saturated"))
        why = doc.get("detail")
        fresh = []
        with self._lock:
            st = self._ranks.setdefault(rank, _RankState())
            kind = "fleet_saturated"
            if saturated and kind not in st.active:
                st.active.add(kind)
                st.active_since[kind] = time.time()
                fresh.append((kind,
                              "controller-reported fleet saturation "
                              f"({why or 'scale-up wanted, no headroom'})"))
            elif not saturated and kind in st.active:
                st.active.discard(kind)
                st.active_since.pop(kind, None)
                self._log.info("anomaly cleared: rank %d %s", rank, kind)
        for kind, detail in fresh:
            self._flag(rank, kind, detail, {}, step_gated=False)

    def ingest_goodput(self, rank: int, doc: Dict) -> None:
        """Mirror a rank's shipped goodput window (the heartbeat
        ``goodput`` sub-doc from ``telemetry.goodput.status``) and flag
        :data:`GOODPUT_KINDS` when effective (wall-clock) tokens/s over
        the window collapses below ``DMLC_GOODPUT_MIN_FRACTION`` of the
        in-step rate.  The ledger's window is the gate — no
        consecutive-step counting here."""
        if rank < 0 or not isinstance(doc, dict):
            return
        win = doc.get("window")
        eff = in_step = None
        if isinstance(win, dict):
            eff = win.get("effective_tokens_per_s")
            in_step = win.get("in_step_tokens_per_s")
        collapsed = bool(
            eff is not None and in_step
            and eff < self.goodput_min_fraction * in_step)
        fresh = []
        with self._lock:
            st = self._ranks.setdefault(rank, _RankState())
            st.goodput = {
                "goodput_fraction": doc.get("goodput_fraction"),
                "effective_tokens_per_s": doc.get("effective_tokens_per_s"),
                "in_step_tokens_per_s": doc.get("in_step_tokens_per_s"),
                "current": doc.get("current"),
                "window": win if isinstance(win, dict) else None,
            }
            kind = "effective_goodput_collapse"
            if collapsed and kind not in st.active:
                st.active.add(kind)
                st.active_since[kind] = time.time()
                fresh.append((kind,
                              f"effective {eff:.1f} tok/s < "
                              f"{self.goodput_min_fraction:.2f} x in-step "
                              f"{in_step:.1f} tok/s over the goodput window "
                              f"(current: {doc.get('current')})"))
            elif not collapsed and kind in st.active:
                st.active.discard(kind)
                st.active_since.pop(kind, None)
                self._log.info("anomaly cleared: rank %d %s", rank, kind)
        for kind, detail in fresh:
            self._flag(rank, kind, detail, {}, step_gated=False)

    def ingest(self, rank: int, records: List[Dict],
               anchor: Optional[float] = None) -> None:
        if rank < 0 or not isinstance(records, list):
            return
        if anchor is not None:
            try:
                anchor = float(anchor)
            except (TypeError, ValueError):
                anchor = None  # unplaceable anchor: keep old baselines
        with self._lock:
            st = self._ranks.setdefault(rank, _RankState())
            if anchor is not None:
                # restarted worker = fresh ledger (seq restarts at 1):
                # keep the flags' history but restart the baselines —
                # the replacement process recompiles, re-warms caches
                if st.anchor is not None and abs(st.anchor - anchor) > 1e-6:
                    fresh = _RankState()
                    fresh.anchor = anchor
                    fresh.consec = st.consec
                    fresh.active = st.active
                    fresh.active_since = st.active_since
                    fresh.remediation = st.remediation
                    fresh.compute = st.compute
                    st = self._ranks[rank] = fresh
                st.anchor = anchor
        for rec in records:
            if not isinstance(rec, dict):
                continue
            try:
                self._ingest_one(rank, rec)
            except (TypeError, ValueError, KeyError):
                continue  # malformed record: skip, never poison

    def _ingest_one(self, rank: int, rec: Dict) -> None:
        wall = float(rec["wall_s"])
        if not math.isfinite(wall) or wall <= 0:
            return
        seq = int(rec.get("seq", 0))
        fresh_flags = []
        with self._lock:
            st = self._ranks.setdefault(rank, _RankState())
            if seq and seq <= st.last_seq:
                return  # re-shipped after a torn beat: already counted
            st.last_seq = max(st.last_seq, seq)
            st.steps += 1
            st.recent.append(wall)
            st.ewma_fast = _ewma(st.ewma_fast, wall, _EWMA_FAST)
            if st.steps > _BASELINE_SKIP:
                st.ewma_slow = _ewma(st.ewma_slow, wall, _EWMA_SLOW)
            frac = float(rec.get("feed_wait_s") or 0.0) / wall
            st.feed_frac_ewma = _ewma(st.feed_frac_ewma, frac, _EWMA_FAST)
            gp = rec.get("goodput_tokens_per_s")
            if gp:
                st.goodput_ewma = _ewma(st.goodput_ewma, float(gp),
                                        _EWMA_FAST)
                if st.steps > _WARMUP_STEPS:
                    st.goodput_peak = max(st.goodput_peak or 0.0,
                                          st.goodput_ewma)
            st.last = dict(rec)

            verdicts = self._evaluate(rank, st, wall)
            for kind, detail in verdicts:
                st.consec[kind] += 1
                if (st.consec[kind] >= self.window
                        and kind not in st.active):
                    st.active.add(kind)
                    st.active_since[kind] = time.time()
                    fresh_flags.append((kind, detail))
            cleared = [k for k in ANOMALY_KINDS
                       if k not in {k_ for k_, _ in verdicts}]
            for kind in cleared:
                st.consec[kind] = 0
                if kind in st.active:
                    st.active.discard(kind)
                    st.active_since.pop(kind, None)
                    self._log.info("anomaly cleared: rank %d %s",
                                   rank, kind)
        for kind, detail in fresh_flags:
            self._flag(rank, kind, detail, rec)

    def _evaluate(self, rank: int, st: _RankState, wall: float) -> List:
        """Rules that currently hold for this rank (lock held)."""
        out = []
        med, mad = self._cluster_stats_locked()
        if med is not None and len(self._ranks) >= 2:
            # MAD floor: a perfectly quiet cluster (MAD→0) must not
            # flag micro-jitter, so the band is never tighter than a
            # few percent of the median
            band = self.k * max(mad, 0.05 * med, 1e-4)
            if wall > med + band:
                out.append(("straggler",
                            f"step {wall:.4f}s > cluster median "
                            f"{med:.4f}s + {self.k:g}*MAD ({band:.4f}s)"))
        if (st.steps > _WARMUP_STEPS and st.ewma_slow
                and st.ewma_fast
                and st.ewma_fast > (1 + self.regression_frac)
                * st.ewma_slow):
            out.append(("regression",
                        f"ewma {st.ewma_fast:.4f}s > baseline "
                        f"{st.ewma_slow:.4f}s * "
                        f"{1 + self.regression_frac:g}"))
        if (st.steps > _WARMUP_STEPS and st.feed_frac_ewma is not None
                and st.feed_frac_ewma > self.feed_frac):
            out.append(("feed_stall",
                        f"feed-wait fraction {st.feed_frac_ewma:.2f} > "
                        f"{self.feed_frac:g}"))
        if (st.goodput_peak and st.goodput_ewma is not None
                and st.goodput_ewma
                < self.goodput_frac * st.goodput_peak):
            out.append(("goodput_collapse",
                        f"goodput {st.goodput_ewma:.1f} tok/s < "
                        f"{self.goodput_frac:g}x peak "
                        f"{st.goodput_peak:.1f}"))
        return out

    def _cluster_stats_locked(self):
        """(median, MAD) of recent step times across the cluster —
        lower medians, so an inflated rank cannot drag the baseline up
        and mask itself (same reasoning as heartbeat._median)."""
        samples = [w for st in self._ranks.values() for w in st.recent]
        if not samples:
            return None, None
        med = _lower_median(samples)
        mad = _lower_median([abs(x - med) for x in samples])
        return med, mad

    def _flag(self, rank: int, kind: str, detail: str, rec: Dict,
              step_gated: bool = True) -> None:
        from . import core, events

        core.inc("anomaly", f"{kind}_flags")
        v = {"rank": rank, "kind": kind, "detail": detail,
             "t": time.time(), "t_step": rec.get("t_wall"),
             "step_seq": rec.get("seq")}
        with self._lock:
            self._verdicts.append(v)
        events.record_event("anomaly", rank=rank, anomaly=kind,
                            detail=detail)
        if step_gated:
            self._log.warning(
                "anomaly: rank %d %s for %d consecutive steps (%s)",
                rank, kind, self.window, detail)
        else:
            # SLO kinds fire on one shipped heartbeat (the replica's
            # burn-rate windows already hysterize) — a step count here
            # would be fabricated
            self._log.warning("anomaly: rank %d %s (%s)",
                              rank, kind, detail)

    def drop(self, rank: int) -> None:
        """Forget a rank (declared dead): the replacement's baselines
        start over; its verdict history stays in the ring."""
        with self._lock:
            self._ranks.pop(rank, None)

    # ---- views ----------------------------------------------------------
    def report(self) -> Dict:
        """The /anomalies JSON document (and ``dmlc top``'s data feed)."""
        with self._lock:
            med, mad = self._cluster_stats_locked()
            ranks = {}
            active = []
            for r, st in sorted(self._ranks.items()):
                last = st.last or {}
                ranks[str(r)] = {
                    "steps": st.steps,
                    "last_step_seq": st.last_seq,
                    "step_time_s": last.get("wall_s"),
                    "step_time_ewma_s": st.ewma_fast,
                    "feed_wait_s": last.get("feed_wait_s"),
                    "collective_s": last.get("collective_s"),
                    "compute_s": last.get("compute_s"),
                    "feed_stall_frac": st.feed_frac_ewma,
                    "goodput_tokens_per_s": st.goodput_ewma,
                    "mfu": last.get("mfu"),
                    "flags": sorted(st.active),
                    "remediation": st.remediation,
                    "compute": st.compute,
                    "goodput": st.goodput,
                }
                for kind in sorted(st.active):
                    active.append({"rank": r, "kind": kind,
                                   "since": st.active_since.get(kind)})
            return {
                "k": self.k,
                "window": self.window,
                "cluster": {"median_step_s": med, "mad_s": mad,
                            "ranks": len(self._ranks)},
                "ranks": ranks,
                "active": active,
                "recent_verdicts": list(self._verdicts)[-32:],
            }

    def compute_report(self) -> Dict:
        """The tracker's ``GET /compute`` document: each rank's shipped
        compute-ledger status (compile/recompile totals, storm sites,
        HBM headlines) keyed by rank, plus which ranks are currently
        storm-flagged — the cluster counterpart of a replica's local
        ``telemetry.compute.report``."""
        with self._lock:
            ranks = {str(r): st.compute
                     for r, st in sorted(self._ranks.items())
                     if st.compute is not None}
            storming = sorted(r for r, st in self._ranks.items()
                              if "recompile_storm" in st.active)
        return {"ranks": ranks, "storming_ranks": storming}

    def trace_markers(self) -> List[Dict]:
        """Verdicts as (wall-epoch-seconds, label) pairs for instant
        markers on the merged /trace timeline.  ``v["t"]`` is stamped
        on the TRACKER's clock when the verdict fires — the merged
        trace's reference clock — so no per-rank offset correction
        applies (the record's own ``t_wall`` is on the worker's
        uncorrected clock and would land skew seconds away)."""
        with self._lock:
            return [{"t": v["t"],
                     "name": f"anomaly:{v['kind']} rank {v['rank']}"}
                    for v in self._verdicts]

    def prometheus_text(self) -> str:
        """``dmlc_anomaly_active{rank,kind}`` gauges: the live flag
        surface scrapers alert on (counters for flag *events* live in
        the tracker registry as ``dmlc_anomaly_<kind>_flags``)."""
        lines = ["# HELP dmlc_anomaly_active watchdog anomaly flag "
                 "currently active (1) per rank and kind",
                 "# TYPE dmlc_anomaly_active gauge"]
        with self._lock:
            items = [(r, sorted(st.active))
                     for r, st in sorted(self._ranks.items())]
        for r, kinds in items:
            for kind in (ANOMALY_KINDS + SLO_KINDS + COMPUTE_KINDS
                         + FLEET_KINDS + GOODPUT_KINDS):
                val = 1 if kind in kinds else 0
                lines.append(
                    f'dmlc_anomaly_active{{rank="{r}",kind="{kind}"}} '
                    f'{val}')
        return "\n".join(lines) + "\n"
