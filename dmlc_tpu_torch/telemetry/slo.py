"""Declarative serving SLOs evaluated as multi-window burn rates (the port
of ``dmlc_tpu/telemetry/slo.py``).

An SLO here is "at most ``budget`` of requests may be *bad*" — bad
meaning TTFT over ``DMLC_SLO_TTFT_P99_S``, a token gap over
``DMLC_SLO_TBT_P99_S`` (both p99 objectives: budget 1%), or a failed
request against ``DMLC_SLO_ERROR_RATE`` (the configured rate IS the
budget).  Rather than alerting on raw threshold crossings (one slow
request pages nobody should read), the monitor uses the SRE
multi-window **burn rate**: over a window, ``burn = bad_fraction /
budget`` — burn 1.0 spends the error budget exactly at the sustainable
rate; a violation fires only when the fast window (default 60 s) burns
above ``DMLC_SLO_FAST_BURN`` (14.4, the "budget gone in ~2 % of the
period" rate) **and** the slow window (default 300 s) confirms it
above ``DMLC_SLO_SLOW_BURN`` (6.0) — the fast window gives low
detection latency, the slow window keeps a brief blip from paging, and
the flag self-clears when either window recovers (or traffic stops:
zero events burn nothing).

Violations surface in the structured event ring (``kind="anomaly"``),
a bounded recent-violations ring rendered as instant markers on
``/trace``, and ``dmlc_slo_*`` gauges on ``/metrics`` (hand-rendered
families with ``objective``/``window`` labels); ``status()`` is the
compact document a fleet watchdog would ingest (:data:`SLO_KINDS`).

Observations stream in from the request ledger (telemetry.requests):
TTFT per first token, TBT per decode gap, outcome per finish.  All
timestamps are ``time.monotonic`` (windowing must not jump with the
wall clock); tests drive explicit clocks through every method.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Dict, List, Optional

from ..base import get_env
from . import core, events
from ..concurrency import make_lock

__all__ = ["SLOMonitor", "SLO_KINDS", "monitor", "status", "reset_slo"]

logger = logging.getLogger("dmlc_tpu_torch.serving")

#: anomaly kinds SLO violations surface under (the JAX package's
#: watchdog keeps these apart from its step-evidence kinds)
SLO_KINDS = ("slo_ttft", "slo_tbt", "slo_error_rate")

_OBJECTIVE_KIND = {
    "ttft_p99": "slo_ttft",
    "tbt_p99": "slo_tbt",
    "error_rate": "slo_error_rate",
}

#: events ring per objective; at 8192 the slow window is fully covered
#: up to ~27 req/s of events — beyond that the burn estimate degrades
#: toward the newest traffic, which is the right direction to degrade
_MAX_EVENTS = 8192
_MAX_VIOLATIONS = 256

#: below this many events in the fast window no verdict fires: one bad
#: request out of two is not a trend, it is arithmetic
MIN_EVENTS = 5


class _Objective:
    __slots__ = ("name", "kind", "threshold", "budget", "events",
                 "burn_fast", "burn_slow", "n_fast", "n_slow",
                 "exemplars")

    def __init__(self, name: str, threshold: float, budget: float,
                 max_exemplars: int = 16):
        self.name = name
        self.kind = _OBJECTIVE_KIND[name]
        self.threshold = float(threshold)
        self.budget = float(budget)
        self.events: deque = deque(maxlen=_MAX_EVENTS)  # (t_mono, bad)
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.n_fast = 0
        self.n_slow = 0
        #: last-N *bad* observations that carried a fleet trace id —
        #: {"trace_id", "v", "t"} — the hop from "the p99 is burning"
        #: to "here is a concrete request journey to open"
        self.exemplars: deque = deque(maxlen=max(1, int(max_exemplars)))

    def burn_thresholds(self, fast_burn: float, slow_burn: float) -> tuple:
        """Effective per-objective burn thresholds: burn is capped at
        1/budget (100% bad events), so a generous budget (e.g.
        error_rate 0.2 → max burn 5x) is clamped to stay reachable —
        without this, a configured objective could be violated by EVERY
        request and still never fire."""
        cap = 1.0 / self.budget
        return min(fast_burn, cap), min(slow_burn, cap)


class SLOMonitor:
    """Burn-rate evaluation over streamed request observations.

    Objectives default from the ``DMLC_SLO_*`` knobs; an unset
    threshold disables that objective entirely (no events kept, never
    flags).  ``evaluate()`` is cheap enough to run per decode iteration
    but self-throttles to ``min_eval_interval_s`` — endpoint reads
    (``/slo``) force a fresh evaluation.
    """

    def __init__(self, ttft_p99_s: Optional[float] = None,
                 tbt_p99_s: Optional[float] = None,
                 error_rate: Optional[float] = None,
                 fast_window_s: Optional[float] = None,
                 slow_window_s: Optional[float] = None,
                 fast_burn: Optional[float] = None,
                 slow_burn: Optional[float] = None,
                 min_eval_interval_s: float = 0.25):
        if ttft_p99_s is None:
            ttft_p99_s = get_env("DMLC_SLO_TTFT_P99_S", None, float)
        if tbt_p99_s is None:
            tbt_p99_s = get_env("DMLC_SLO_TBT_P99_S", None, float)
        if error_rate is None:
            error_rate = get_env("DMLC_SLO_ERROR_RATE", None, float)
        self.fast_window_s = (fast_window_s if fast_window_s is not None
                              else get_env("DMLC_SLO_FAST_WINDOW_S", 60.0))
        self.slow_window_s = (slow_window_s if slow_window_s is not None
                              else get_env("DMLC_SLO_SLOW_WINDOW_S", 300.0))
        self.fast_burn = (fast_burn if fast_burn is not None
                          else get_env("DMLC_SLO_FAST_BURN", 14.4))
        self.slow_burn = (slow_burn if slow_burn is not None
                          else get_env("DMLC_SLO_SLOW_BURN", 6.0))
        self.min_eval_interval_s = float(min_eval_interval_s)
        self._lock = make_lock("SLOMonitor._lock")
        n_ex = get_env("DMLC_TRACE_EXEMPLARS", 16, int)
        self._objectives: Dict[str, _Objective] = {}
        if ttft_p99_s is not None and ttft_p99_s > 0:
            self._objectives["ttft_p99"] = _Objective(
                "ttft_p99", ttft_p99_s, 0.01, max_exemplars=n_ex)
        if tbt_p99_s is not None and tbt_p99_s > 0:
            self._objectives["tbt_p99"] = _Objective(
                "tbt_p99", tbt_p99_s, 0.01, max_exemplars=n_ex)
        if error_rate is not None and error_rate > 0:
            self._objectives["error_rate"] = _Objective(
                "error_rate", error_rate, error_rate, max_exemplars=n_ex)
        self._active: set = set()
        self._active_since: Dict[str, float] = {}
        self._violations: deque = deque(maxlen=_MAX_VIOLATIONS)
        self._last_eval = 0.0

    @property
    def enabled(self) -> bool:
        return bool(self._objectives)

    # ---- observations ---------------------------------------------------
    def _observe(self, name: str, bad: bool, t: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 value: Optional[float] = None) -> None:
        obj = self._objectives.get(name)
        if obj is None:
            return
        t = time.monotonic() if t is None else t
        with self._lock:
            obj.events.append((t, bool(bad)))
            if bad and trace_id is not None:
                ex = {"trace_id": str(trace_id), "t": time.time()}
                if value is not None:
                    ex["v"] = round(float(value), 6)
                obj.exemplars.append(ex)

    def observe_ttft(self, ttft_s: float, t: Optional[float] = None,
                     trace_id: Optional[str] = None) -> None:
        obj = self._objectives.get("ttft_p99")
        if obj is not None:
            self._observe("ttft_p99", ttft_s > obj.threshold, t,
                          trace_id=trace_id, value=ttft_s)

    def observe_tbt(self, gap_s: float, t: Optional[float] = None,
                    trace_id: Optional[str] = None) -> None:
        obj = self._objectives.get("tbt_p99")
        if obj is not None:
            self._observe("tbt_p99", gap_s > obj.threshold, t,
                          trace_id=trace_id, value=gap_s)

    def observe_outcome(self, ok: bool, t: Optional[float] = None,
                        trace_id: Optional[str] = None) -> None:
        self._observe("error_rate", not ok, t, trace_id=trace_id)

    # ---- evaluation -----------------------------------------------------
    def maybe_evaluate(self, now: Optional[float] = None) -> None:
        """Throttled evaluate — the engine calls this per iteration."""
        now = time.monotonic() if now is None else now
        with self._lock:
            due = now - self._last_eval >= self.min_eval_interval_s
        if due:
            self.evaluate(now)

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Dict]:
        """Recompute every objective's window burn rates, fire fresh
        violations, clear recovered ones.  Returns the per-objective
        numbers (also cached on the objective for report())."""
        now = time.monotonic() if now is None else now
        fired: List[tuple] = []
        cleared: List[str] = []
        out: Dict[str, Dict] = {}
        with self._lock:
            self._last_eval = now
            for name, obj in self._objectives.items():
                # expire events older than the slow window (the wider)
                horizon = now - self.slow_window_s
                while obj.events and obj.events[0][0] < horizon:
                    obj.events.popleft()
                fast_t0 = now - self.fast_window_s
                n_s = bad_s = n_f = bad_f = 0
                for t, bad in obj.events:
                    n_s += 1
                    bad_s += bad
                    if t >= fast_t0:
                        n_f += 1
                        bad_f += bad
                obj.n_fast, obj.n_slow = n_f, n_s
                obj.burn_fast = (bad_f / n_f / obj.budget) if n_f else 0.0
                obj.burn_slow = (bad_s / n_s / obj.budget) if n_s else 0.0
                fast_thr, slow_thr = obj.burn_thresholds(
                    self.fast_burn, self.slow_burn)
                violating = (n_f >= MIN_EVENTS
                             and obj.burn_fast >= fast_thr
                             and obj.burn_slow >= slow_thr)
                if violating and obj.kind not in self._active:
                    self._active.add(obj.kind)
                    self._active_since[obj.kind] = time.time()
                    detail = (
                        f"{name}: burn {obj.burn_fast:.1f}x over "
                        f"{self.fast_window_s:g}s (>= {fast_thr:g}) "
                        f"and {obj.burn_slow:.1f}x over "
                        f"{self.slow_window_s:g}s (>= {slow_thr:g}); "
                        f"threshold {obj.threshold:g}, "
                        f"budget {obj.budget:g}")
                    v = {"kind": obj.kind, "objective": name,
                         "detail": detail, "t": time.time(),
                         "burn_fast": obj.burn_fast,
                         "burn_slow": obj.burn_slow,
                         # recent offending fleet trace ids (may be
                         # empty when tracing is off): the violation
                         # is directly openable as request journeys
                         "exemplar_trace_ids": [
                             e["trace_id"] for e in obj.exemplars]}
                    self._violations.append(v)
                    fired.append((obj.kind, detail))
                elif not violating and obj.kind in self._active:
                    self._active.discard(obj.kind)
                    self._active_since.pop(obj.kind, None)
                    cleared.append(obj.kind)
                out[name] = {
                    "burn_fast": obj.burn_fast,
                    "burn_slow": obj.burn_slow,
                    "events_fast": n_f,
                    "events_slow": n_s,
                    "violating": violating,
                }
        for kind, detail in fired:
            core.inc("slo", "violations")
            events.record_event("anomaly", anomaly=kind, detail=detail)
            logger.warning("SLO violation: %s (%s)", kind, detail)
        for kind in cleared:
            events.record_event("slo_recovered", anomaly=kind)
            logger.info("SLO recovered: %s", kind)
        return out

    # ---- views ----------------------------------------------------------
    def active(self) -> List[str]:
        with self._lock:
            return sorted(self._active)

    def report(self) -> Dict:
        """The ``/slo`` JSON document (evaluation NOT forced — callers
        serving an endpoint should ``evaluate()`` first)."""
        with self._lock:
            objectives = {}
            for name, obj in self._objectives.items():
                objectives[name] = {
                    "kind": obj.kind,
                    "threshold": obj.threshold,
                    "budget": obj.budget,
                    "burn_fast": obj.burn_fast,
                    "burn_slow": obj.burn_slow,
                    "events_fast": obj.n_fast,
                    "events_slow": obj.n_slow,
                    "violating": obj.kind in self._active,
                    "exemplars": list(obj.exemplars),
                }
            return {
                "enabled": bool(self._objectives),
                "windows": {"fast_s": self.fast_window_s,
                            "slow_s": self.slow_window_s,
                            "fast_burn": self.fast_burn,
                            "slow_burn": self.slow_burn},
                "objectives": objectives,
                "active": sorted(self._active),
                "active_since": dict(self._active_since),
                "recent_violations": list(self._violations)[-32:],
            }

    def status(self) -> Optional[Dict]:
        """Compact status document (None when nothing is configured):
        what the JAX package's heartbeats ship to its watchdog.  Forces a
        (throttled) evaluation first, so a shipped status can never be
        a stale violation the windows have long since recovered from."""
        self.maybe_evaluate()
        with self._lock:
            if not self._objectives:
                return None
            return {
                "active": sorted(self._active),
                "burn": {name: {"fast": round(obj.burn_fast, 3),
                                "slow": round(obj.burn_slow, 3)}
                         for name, obj in self._objectives.items()},
                "t": time.time(),
            }

    def trace_markers(self) -> List[Dict]:
        """Violations as wall-clock instant markers for the serving
        ``/trace``."""
        with self._lock:
            return [{"t": v["t"], "name": f"slo:{v['kind']}"}
                    for v in self._violations]

    def prometheus_text(self) -> str:
        """Hand-rendered ``dmlc_slo_*`` families with ``objective`` /
        ``window`` labels (the core registry is label-free)."""
        with self._lock:
            rows = [(name, obj.threshold, obj.burn_fast, obj.burn_slow,
                     1 if obj.kind in self._active else 0)
                    for name, obj in sorted(self._objectives.items())]
        if not rows:
            return ""
        lines = ["# HELP dmlc_slo_objective_threshold configured SLO "
                 "threshold per objective",
                 "# TYPE dmlc_slo_objective_threshold gauge"]
        for name, thr, _bf, _bs, _a in rows:
            lines.append(
                f'dmlc_slo_objective_threshold{{objective="{name}"}} '
                f'{thr!r}')
        lines += ["# HELP dmlc_slo_burn_rate error-budget burn rate per "
                  "objective and window (1.0 = sustainable)",
                  "# TYPE dmlc_slo_burn_rate gauge"]
        for name, _thr, bf, bs, _a in rows:
            lines.append(f'dmlc_slo_burn_rate{{objective="{name}",'
                         f'window="fast"}} {bf!r}')
            lines.append(f'dmlc_slo_burn_rate{{objective="{name}",'
                         f'window="slow"}} {bs!r}')
        lines += ["# HELP dmlc_slo_violation_active SLO violation "
                  "currently active (1) per objective",
                  "# TYPE dmlc_slo_violation_active gauge"]
        for name, _thr, _bf, _bs, a in rows:
            lines.append(f'dmlc_slo_violation_active{{objective="{name}"}}'
                         f' {a}')
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            for obj in self._objectives.values():
                obj.events.clear()
                obj.exemplars.clear()
                obj.burn_fast = obj.burn_slow = 0.0
                obj.n_fast = obj.n_slow = 0
            self._active.clear()
            self._active_since.clear()
            self._violations.clear()
            self._last_eval = 0.0


# ---------------------------------------------------------------------------
# process-default monitor (the one engines share)
# ---------------------------------------------------------------------------

_default: Optional[SLOMonitor] = None
_default_lock = make_lock("slo._default_lock")


def monitor() -> SLOMonitor:
    """The process-default monitor, built from the ``DMLC_SLO_*`` env
    on first use (serving engines share it unless given their own)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = SLOMonitor()
        return _default


def status() -> Optional[Dict]:
    """The default monitor's compact status, or None when no monitor
    was ever built or nothing is configured (a training process)."""
    with _default_lock:
        mon = _default
    return mon.status() if mon is not None else None


def reset_slo() -> None:
    """Drop the default monitor (test isolation; the next ``monitor()``
    re-reads the environment)."""
    global _default
    with _default_lock:
        _default = None
