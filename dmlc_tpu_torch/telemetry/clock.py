"""NTP-style clock-offset estimation between workers and the tracker
(the port of ``dmlc_tpu/telemetry/clock.py``).

Spans from different ranks can only be merged onto one timeline if each
rank's wall clock is mapped onto a common reference — the tracker's.
The classic 4-timestamp exchange does it without any clock discipline
on the hosts:

    worker sends  t0  (its clock)          --->  tracker receives at t1
    worker receives reply at t3            <---  tracker replies with (t1, t2)

    offset = ((t1 - t0) + (t2 - t3)) / 2      (tracker_clock - worker_clock)
    rtt    = (t3 - t0) - (t2 - t1)            (sample quality: lower = better)

The worker drives the exchange over a short ``clock`` tracker session
(``TrackerClient.clock_ping``; the tracker half stamps t1/t2 in its
accept loop) and ships each sample with its telemetry heartbeat; the
tracker-side :class:`ClockOffsetEstimator` keeps a per-rank estimate,
preferring low-RTT samples — the error of a sample is bounded by rtt/2,
so a tight ping beats any amount of averaging over loose ones.
"""

from __future__ import annotations

from typing import Dict, Optional
from ..concurrency import make_lock

__all__ = ["ClockSample", "ClockOffsetEstimator", "offset_from_timestamps"]


def offset_from_timestamps(t0: float, t1: float, t2: float,
                           t3: float) -> tuple:
    """(offset_s, rtt_s) from one 4-timestamp exchange (see module doc).
    ``offset_s`` maps the t0/t3 clock onto the t1/t2 clock:
    ``their_time = my_time + offset_s``."""
    offset = ((t1 - t0) + (t2 - t3)) / 2.0
    rtt = (t3 - t0) - (t2 - t1)
    return offset, rtt


class ClockSample:
    """One measured (offset, rtt) pair."""

    __slots__ = ("offset_s", "rtt_s")

    def __init__(self, offset_s: float, rtt_s: float):
        self.offset_s = float(offset_s)
        self.rtt_s = float(rtt_s)


class ClockOffsetEstimator:
    """Per-rank clock-offset estimates, fed by worker-shipped samples.

    Keeps, per rank, the best (lowest-RTT) sample of the last ``window``
    accepted ones: offset error is bounded by rtt/2, so the estimate's
    worst-case error is that of the tightest recent ping, and the
    sliding window lets the estimate track genuine drift/steps instead
    of being pinned forever to one lucky early sample.  Samples with
    negative RTT (clock stepped mid-exchange) are rejected.
    """

    def __init__(self, window: int = 16):
        self.window = max(1, int(window))
        self._lock = make_lock("ClockOffsetEstimator._lock")
        self._samples: Dict[int, list] = {}   # rank -> recent ClockSamples
        self._best: Dict[int, ClockSample] = {}

    def update(self, rank: int, offset_s: float, rtt_s: float) -> None:
        try:
            s = ClockSample(offset_s, rtt_s)
        except (TypeError, ValueError):
            return
        if rank < 0 or s.rtt_s < 0:
            return
        with self._lock:
            window = self._samples.setdefault(rank, [])
            window.append(s)
            del window[:-self.window]
            self._best[rank] = min(window, key=lambda x: x.rtt_s)

    def offset(self, rank: int) -> Optional[float]:
        """Best current estimate of ``tracker_clock - rank_clock`` in
        seconds, or None when the rank never reported a sample."""
        with self._lock:
            best = self._best.get(rank)
        return best.offset_s if best is not None else None

    def rtt(self, rank: int) -> Optional[float]:
        with self._lock:
            best = self._best.get(rank)
        return best.rtt_s if best is not None else None

    def snapshot(self) -> Dict[int, Dict[str, float]]:
        """rank -> {offset_s, rtt_s} for every estimated rank."""
        with self._lock:
            return {r: {"offset_s": s.offset_s, "rtt_s": s.rtt_s}
                    for r, s in self._best.items()}

    def drop(self, rank: int) -> None:
        """Forget a rank (declared dead / finished): a replacement
        process boots with a fresh clock relation."""
        with self._lock:
            self._samples.pop(rank, None)
            self._best.pop(rank, None)

    def remap_ranks(self, mapping: Dict[int, int]) -> None:
        """Renumber the per-rank estimates into a new generation's rank
        space (elastic resize); ranks absent from ``mapping`` are
        dropped.  The clock relation belongs to the surviving *process*,
        which keeps its physical clock across renumbering — so the
        estimate travels with it rather than restarting from zero."""
        with self._lock:
            self._samples = {mapping[r]: s for r, s in self._samples.items()
                             if r in mapping}
            self._best = {mapping[r]: s for r, s in self._best.items()
                          if r in mapping}
