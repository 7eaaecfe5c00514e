"""Serving availability ledger (the port of ``AvailabilityLedger`` from
``dmlc_tpu/telemetry/goodput.py``).

A replica's wall clock partitioned into serving / draining /
crashed_recovering / starved_idle, plus tokens served against
capacity-tokens (peak observed decode rate × wall).  The job-level
``GoodputLedger`` of the JAX package and its cluster aggregation are
ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ..concurrency import make_lock
from . import exporters

__all__ = ["AVAILABILITY_STATES", "AvailabilityLedger"]

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
