"""Back-compatible shim over :mod:`dmlc_tpu_torch.telemetry` (the port of
``dmlc_tpu/metrics.py``).

The flat per-stage counters of the first rebuild live on as a view of
the telemetry package:

  * ``inc`` / ``timed`` / ``annotate`` / ``trace`` delegate directly
    (``timed`` also feeds a histogram);
  * ``snapshot()`` returns the legacy flat ``{stage: {name: value}}``
    counter view (``telemetry.snapshot()`` has the structured one);
  * ``reset()`` clears the whole telemetry registry (test isolation).
"""

from __future__ import annotations

from typing import Dict

from . import telemetry

__all__ = ["inc", "timed", "snapshot", "reset", "annotate", "trace"]

inc = telemetry.inc
timed = telemetry.timed
annotate = telemetry.annotate
trace = telemetry.trace
reset = telemetry.reset


def snapshot() -> Dict[str, Dict[str, float]]:
    """Point-in-time copy of every stage's flat counters (legacy shape)."""
    return telemetry.counters_snapshot()
