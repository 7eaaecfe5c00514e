"""Ledger-driven feed auto-tuning (the port of ``dmlc_tpu/feed/autotune.py``).

The DeviceFeed ships with one hand-tuned default for
``DMLC_FEED_WORKERS`` / ``DMLC_FEED_DEPTH`` — right for one host shape
and wrong for every other.  The step ledger (``telemetry.steps``)
already decomposes each training step's wall time into feed-wait /
collective / compute, so the right worker count is observable at
runtime: a feed-wait fraction
persistently above noise means the producers cannot keep the device
busy (add workers, then depth); a fraction pinned at ~zero means the
pipeline is over-provisioned (host threads and staging memory doing
nothing).

:class:`FeedAutotuner` is the pure decision core — it sees only a
stream of feed-wait fractions and answers with a (workers, depth)
target, which keeps it unit-testable against synthetic ledger traces.
``DeviceFeed`` drives it at every epoch boundary (worker→partition
assignment is ``p ≡ w (mod W)``, so W may only change between epochs
without breaking per-partition batch order) when ``DMLC_FEED_AUTOTUNE=1``,
bounded by ``DMLC_FEED_WORKERS_MIN`` / ``DMLC_FEED_WORKERS_MAX`` /
``DMLC_FEED_DEPTH_MAX``.

Anti-oscillation contract: growth is only ever triggered by a high
feed-wait fraction, and a shrink that is immediately punished (the next
observation jumps back above the high-water mark) RAISES THE FLOOR to
the re-grown size — the controller converges to the smallest
configuration that keeps feed-wait below the high-water mark and then
holds, instead of ping-ponging around it.
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["FeedAutotuner"]


class FeedAutotuner:
    """Hysteresis controller mapping feed-wait fraction → (workers,
    depth) within bounds.

    ``high`` / ``low`` are the feed-wait fractions above which the
    pipeline grows and below which it may shrink; between them the
    controller holds (the dead band is the hysteresis).  ``window`` is
    the minimum number of ledger step records per decision — the
    DeviceFeed skips the controller entirely on thinner evidence.
    """

    def __init__(self, workers: int, depth: int, *, min_workers: int = 1,
                 max_workers: int = 8, max_depth: int = 4,
                 high: float = 0.15, low: float = 0.02,
                 window: int = 5):
        self.workers = max(min_workers, min(int(workers), int(max_workers)))
        self.depth = max(1, min(int(depth), int(max_depth)))
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.min_depth = self.depth  # never shrink below the configured depth
        self.max_depth = int(max_depth)
        self.high = float(high)
        self.low = float(low)
        self.window = int(window)
        # oscillation guards: sizes a shrink may not go below again,
        # raised whenever a shrink is punished by renewed feed-wait
        self._worker_floor = self.min_workers
        self._depth_floor = self.min_depth
        self._last_action = "hold"   # grow | shrink | hold
        self._last_shrink = None     # which dimension the last shrink cut

    def observe(self, feed_wait_fraction: float) -> Tuple[int, int]:
        """One controller step.  Returns the new (workers, depth)."""
        fw = float(feed_wait_fraction)
        if fw > self.high:
            if (self._last_action == "shrink"
                    and self._last_shrink == "workers"
                    and self.workers < self.max_workers):
                # the worker shrink we just made starved the device:
                # undo THAT dimension and pin its floor there
                self.workers += 1
                self._worker_floor = max(self._worker_floor, self.workers)
                self._last_action = "grow"
            elif (self._last_action == "shrink"
                    and self._last_shrink == "depth"
                    and self.depth < self.max_depth):
                self.depth += 1
                self._depth_floor = max(self._depth_floor, self.depth)
                self._last_action = "grow"
            elif self.workers < self.max_workers:
                self.workers += 1
                self._last_action = "grow"
            elif self.depth < self.max_depth:
                self.depth += 1
                self._last_action = "grow"
            else:
                self._last_action = "hold"  # at the ceiling: nothing left
        elif fw < self.low:
            if self.workers > max(self.min_workers, self._worker_floor):
                self.workers -= 1
                self._last_action = "shrink"
                self._last_shrink = "workers"
            elif self.depth > max(self.min_depth, self._depth_floor):
                self.depth -= 1
                self._last_action = "shrink"
                self._last_shrink = "depth"
            else:
                self._last_action = "hold"  # converged at the floor
        else:
            self._last_action = "hold"  # inside the dead band
        return self.workers, self.depth

    @property
    def last_action(self) -> str:
        return self._last_action
