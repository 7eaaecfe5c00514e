"""Fleet control plane: the cluster brain over serving + training (the
port of ``dmlc_tpu/fleet``).

A latency-sensitive serving fleet behind the router shares hosts with a
low-priority background elastic training job.

  * :class:`Autoscaler` — the closed-loop controller: router
    utilization + per-replica SLO burn in, hysteresis + cooldown
    scale decisions out.
  * :class:`TrainingPreemptingProvider` / :class:`HostProvider` —
    where scale-up hosts come from: preempt one training rank
    (kill + ``POST /resize`` with a remove list), launch a replica on
    the freed host; give it back on scale-down and training regrows
    with loss parity.
  * :class:`ResizeClient` — the thin programmatic client for the
    tracker's elastic resize surface.

The HTTP surface is the router's ``/fleet`` endpoint plus the
hand-rendered ``dmlc_fleet_*`` Prometheus families
(``serving.router.RouterHTTPServer(fleet_source=...)``); ``chip_smoke.py``'s
``fleet`` phase runs the whole loop on the card.
"""

from .autoscaler import Autoscaler
from .preempt import (CallbackProvider, HostProvider, ResizeClient,
                      TrainingPreemptingProvider)

__all__ = ["Autoscaler", "CallbackProvider", "HostProvider",
           "ResizeClient", "TrainingPreemptingProvider"]
