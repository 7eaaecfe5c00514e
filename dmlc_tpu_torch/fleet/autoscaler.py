"""The fleet's closed-loop controller: load in, scale decisions out (the
port of ``dmlc_tpu/fleet/autoscaler.py``, same control law, knobs,
decisions, events, documents and metric families).

The router balances and fails over but never changes the fleet's shape;
the SLO monitor measures burn but nobody acts on it.  The
:class:`Autoscaler` closes the loop, with the control policy of a
thermostat rather than a scheduler paper:

  * **signals**: the router's aggregate ``utilization()`` (inflight +
    queued over non-down capacity) each tick, plus each live replica's
    ``/slo`` burn verdict (any active burn-rate violation marks the
    fleet "hot" regardless of utilization — queue depth can look fine
    while TTFT burns).
  * **hysteresis**: a scale decision needs ``DMLC_AUTOSCALE_HYSTERESIS``
    *consecutive* over/under-water ticks — one spiky scrape must not
    buy a host.
  * **cooldown**: after any action, ``DMLC_AUTOSCALE_COOLDOWN_S`` of
    quiet — the loop must never flap faster than a replica warms up.
  * **scale-up**: ``provider.acquire()`` funds a host (preempting the
    background training job — see :mod:`.preempt`), the ready replica
    registers with the router, and traffic shifts immediately.  A
    scale-up wanted but unfundable (max replicas, or the provider is
    out of hosts) flags the ``fleet_saturated`` anomaly instead of
    silently doing nothing.
  * **scale-down**: only replicas THIS controller launched are ever
    drained (``_owned``) — the seed fleet belongs to the operator.
    The replica is flipped DRAINING at the router first (no new work),
    then the provider drains/stops it and gives the host back so
    training regrows to its original world.

``tick()`` is public and takes an injectable clock so tests drive the
control law deterministically; ``start()`` runs it on a daemon thread
at ``DMLC_AUTOSCALE_INTERVAL_S``.  ``report()`` is the router's
``/fleet`` document, ``status()`` the compact heartbeat sub-doc
(``Watchdog.ingest_fleet``), and ``prometheus_text()`` the hand-
rendered label-free ``dmlc_fleet_*`` families.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Dict, Optional

from ..base import get_env
from ..concurrency import make_lock
from ..telemetry.tracecontext import record_decision
from .preempt import HostProvider

__all__ = ["Autoscaler"]

logger = logging.getLogger("dmlc_tpu_torch.fleet")

#: /slo poll timeout per replica — a stuck replica must not stall the
#: control loop for more than this per tick
_SLO_POLL_TIMEOUT_S = 1.0


def _default_slo_poll(url: str) -> Dict:
    """GET one replica's /slo document (errors -> empty doc: a replica
    that cannot answer its SLO probe is the health prober's problem,
    not a scale signal)."""
    try:
        with urllib.request.urlopen(url.rstrip("/") + "/slo",
                                    timeout=_SLO_POLL_TIMEOUT_S) as resp:
            doc = json.loads(resp.read())
        return doc if isinstance(doc, dict) else {}
    except Exception:  # noqa: BLE001 - control loop must survive
        return {}


class Autoscaler:
    """Hysteresis + cooldown controller over a Router and a HostProvider."""

    def __init__(self, router, provider: HostProvider,
                 interval_s: Optional[float] = None,
                 high_water: Optional[float] = None,
                 low_water: Optional[float] = None,
                 hysteresis: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 slo_poll=None, log=logger):
        self.router = router
        self.provider = provider
        self.interval_s = (get_env("DMLC_AUTOSCALE_INTERVAL_S", 2.0)
                           if interval_s is None else float(interval_s))
        self.high_water = (get_env("DMLC_AUTOSCALE_HIGH_WATER", 0.8)
                           if high_water is None else float(high_water))
        self.low_water = (get_env("DMLC_AUTOSCALE_LOW_WATER", 0.3)
                          if low_water is None else float(low_water))
        self.hysteresis = max(1, get_env("DMLC_AUTOSCALE_HYSTERESIS", 3)
                              if hysteresis is None else int(hysteresis))
        self.cooldown_s = (get_env("DMLC_AUTOSCALE_COOLDOWN_S", 30.0)
                           if cooldown_s is None else float(cooldown_s))
        self.min_replicas = max(1, get_env("DMLC_AUTOSCALE_MIN_REPLICAS", 1)
                                if min_replicas is None
                                else int(min_replicas))
        self.max_replicas = (get_env("DMLC_AUTOSCALE_MAX_REPLICAS", 4)
                             if max_replicas is None else int(max_replicas))
        if self.low_water >= self.high_water:
            raise ValueError("need low_water < high_water")
        if self.max_replicas < self.min_replicas:
            raise ValueError("need max_replicas >= min_replicas")
        self._slo_poll = slo_poll or _default_slo_poll
        self._log = log
        self._lock = make_lock("Autoscaler._lock")
        # dmlc-check: guarded-by(_lock)
        self._owned: list = []          # replica urls this loop launched
        # dmlc-check: guarded-by(_lock)
        self._high_streak = 0
        # dmlc-check: guarded-by(_lock)
        self._low_streak = 0
        # dmlc-check: guarded-by(_lock)
        self._last_action_t: Optional[float] = None
        # dmlc-check: guarded-by(_lock)
        self._saturated = False
        # dmlc-check: guarded-by(_lock)
        self._last_decision = "none"
        # dmlc-check: guarded-by(_lock)
        self._last_util = 0.0
        # dmlc-check: guarded-by(_lock)
        self._last_slo_hot = False
        # dmlc-check: guarded-by(_lock)
        self._counters = {"ticks": 0, "scale_ups": 0, "scale_downs": 0,
                          "saturations": 0}
        self._stop = threading.Event()
        # dmlc-check: unguarded(owner-thread start()/close() handshake)
        self._thread: Optional[threading.Thread] = None

    # ---- signals --------------------------------------------------------
    def _fleet_hot(self) -> bool:
        """Any live replica reporting an active SLO burn violation."""
        for rep in self.router.replica_views():
            if rep.get("state") == "down":
                continue
            doc = self._slo_poll(rep["url"])
            active = doc.get("active")
            if isinstance(active, list) and active:
                return True
        return False

    # ---- control law ----------------------------------------------------
    def tick(self, now: Optional[float] = None) -> str:
        """One controller evaluation; returns the decision taken
        (``scale_up`` / ``scale_down`` / ``saturated`` / ``hold``).
        Public and clock-injectable so tests drive the law directly."""
        if now is None:
            now = time.monotonic()
        util = self.router.utilization()
        slo_hot = self._fleet_hot()
        overloaded = util >= self.high_water or slo_hot
        underloaded = util <= self.low_water and not slo_hot
        n_replicas = len(self.router.replica_views())

        with self._lock:
            self._counters["ticks"] += 1
            self._last_util = util
            self._last_slo_hot = slo_hot
            self._high_streak = self._high_streak + 1 if overloaded else 0
            self._low_streak = self._low_streak + 1 if underloaded else 0
            if not overloaded:
                self._saturated = False  # pressure gone: verdict clears
            cooling = (self._last_action_t is not None
                       and now - self._last_action_t < self.cooldown_s)
            want_up = (self._high_streak >= self.hysteresis
                       and not cooling)
            want_down = (self._low_streak >= self.hysteresis
                         and not cooling and bool(self._owned)
                         and n_replicas > self.min_replicas)
            high_streak, low_streak = self._high_streak, self._low_streak

        if want_up or want_down:
            # the verdict that STARTS an action chain, with the signal
            # inputs that justified it — /decisions shows why the fleet
            # moved, not just that it did (hold ticks are not logged:
            # the audit log records decisions, not heartbeats)
            record_decision(
                "autoscale_verdict",
                verdict="scale_up" if want_up else "scale_down",
                util=round(util, 4), slo_hot=slo_hot,
                high_streak=high_streak, low_streak=low_streak,
                replicas=n_replicas)
        if want_up:
            return self._scale_up(now, n_replicas, util)
        if want_down:
            return self._scale_down(now)
        with self._lock:
            self._last_decision = "hold"
        return "hold"

    def _scale_up(self, now: float, n_replicas: int, util: float) -> str:
        from .. import telemetry

        url = None
        if n_replicas < self.max_replicas:
            url = self.provider.acquire()  # blocks through the launch
        if url is None:
            with self._lock:
                entered = not self._saturated
                self._saturated = True
                self._last_decision = "saturated"
                if entered:
                    self._counters["saturations"] += 1
            if entered:
                why = ("replica cap reached"
                       if n_replicas >= self.max_replicas
                       else "host provider exhausted")
                self._log.warning(
                    "fleet saturated: scale-up wanted (util %.2f, "
                    "%d replicas) but %s", util, n_replicas, why)
                telemetry.record_event("fleet_saturated", detail=why,
                                       replicas=n_replicas)
                record_decision("fleet_saturated", detail=why,
                                replicas=n_replicas, util=round(util, 4))
            return "saturated"
        self.router.add_replica(url)
        with self._lock:
            self._owned.append(url)
            self._counters["scale_ups"] += 1
            self._last_action_t = now
            self._high_streak = self._low_streak = 0
            self._saturated = False
            self._last_decision = "scale_up"
        self._log.info("fleet scale-up: %s registered (now %d replicas)",
                       url, len(self.router.replica_views()))
        telemetry.record_event("fleet_scale_up", replica=url)
        record_decision("scale_up", replica=url,
                        replicas=len(self.router.replica_views()))
        return "scale_up"

    def _scale_down(self, now: float) -> str:
        from .. import telemetry

        with self._lock:
            url = self._owned[-1]  # newest first: LIFO back to training
        # no new work at the router FIRST, then the provider drains the
        # replica's backlog and stops it — zero client-visible failures
        self.router.set_draining(url)
        self.provider.release(url)
        self.router.remove_replica(url)
        with self._lock:
            self._owned.remove(url)
            self._counters["scale_downs"] += 1
            self._last_action_t = now
            self._high_streak = self._low_streak = 0
            self._last_decision = "scale_down"
        self._log.info("fleet scale-down: %s drained and released "
                       "(now %d replicas)", url,
                       len(self.router.replica_views()))
        telemetry.record_event("fleet_scale_down", replica=url)
        record_decision("scale_down", replica=url,
                        replicas=len(self.router.replica_views()))
        return "scale_down"

    # ---- lifecycle ------------------------------------------------------
    def start(self) -> None:
        """Run the control loop on a daemon thread."""
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - loop must survive
                    self._log.exception("autoscaler tick failed")

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="fleet-autoscaler")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ---- views ----------------------------------------------------------
    def report(self) -> Dict:
        """The router's ``GET /fleet`` document."""
        with self._lock:
            cd = 0.0
            if self._last_action_t is not None:
                cd = max(0.0, self.cooldown_s
                         - (time.monotonic() - self._last_action_t))
            return {
                "config": {"interval_s": self.interval_s,
                           "high_water": self.high_water,
                           "low_water": self.low_water,
                           "hysteresis": self.hysteresis,
                           "cooldown_s": self.cooldown_s,
                           "min_replicas": self.min_replicas,
                           "max_replicas": self.max_replicas},
                "replicas": len(self.router.replica_views()),
                "owned": list(self._owned),
                "utilization": self._last_util,
                "slo_hot": self._last_slo_hot,
                "high_streak": self._high_streak,
                "low_streak": self._low_streak,
                "cooldown_remaining_s": round(cd, 3),
                "saturated": self._saturated,
                "last_decision": self._last_decision,
                "counters": dict(self._counters),
                "provider": self.provider.stats(),
            }

    def status(self) -> Dict:
        """Compact heartbeat sub-doc (``Watchdog.ingest_fleet``)."""
        with self._lock:
            detail = (f"util {self._last_util:.2f}, "
                      f"{len(self._owned)} owned replicas")
            return {"saturated": self._saturated, "detail": detail,
                    "replicas": len(self.router.replica_views()),
                    "utilization": self._last_util}

    def prometheus_text(self) -> str:
        """Label-free ``dmlc_fleet_*`` families, hand-rendered (this
        controller may share a process with the router's registry —
        rendering its own families keeps them collision-free)."""
        with self._lock:
            cd = 0.0
            if self._last_action_t is not None:
                cd = max(0.0, self.cooldown_s
                         - (time.monotonic() - self._last_action_t))
            rows = (
                ("dmlc_fleet_replicas", "gauge",
                 "replicas currently registered at the router",
                 len(self.router.replica_views())),
                ("dmlc_fleet_owned_replicas", "gauge",
                 "replicas launched (and drainable) by the autoscaler",
                 len(self._owned)),
                ("dmlc_fleet_utilization", "gauge",
                 "aggregate fleet utilization at the last tick",
                 round(self._last_util, 6)),
                ("dmlc_fleet_slo_hot", "gauge",
                 "1 when any replica reported an active SLO violation",
                 int(self._last_slo_hot)),
                ("dmlc_fleet_high_streak", "gauge",
                 "consecutive over-water ticks", self._high_streak),
                ("dmlc_fleet_low_streak", "gauge",
                 "consecutive under-water ticks", self._low_streak),
                ("dmlc_fleet_cooldown_remaining_s", "gauge",
                 "seconds left in the post-action cooldown",
                 round(cd, 3)),
                ("dmlc_fleet_saturated", "gauge",
                 "1 when scale-up is wanted but unfundable",
                 int(self._saturated)),
                ("dmlc_fleet_ticks_total", "counter",
                 "controller evaluations", self._counters["ticks"]),
                ("dmlc_fleet_scale_ups_total", "counter",
                 "replicas added by the controller",
                 self._counters["scale_ups"]),
                ("dmlc_fleet_scale_downs_total", "counter",
                 "replicas drained and released by the controller",
                 self._counters["scale_downs"]),
                ("dmlc_fleet_saturations_total", "counter",
                 "transitions into the saturated state",
                 self._counters["saturations"]),
            )
        lines = []
        for name, typ, help_, val in rows:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {typ}")
            lines.append(f"{name} {val}")
        return "\n".join(lines) + "\n"
