"""Host providers: where scale-up replicas come FROM (the port of
``dmlc_tpu/fleet/preempt.py``, same names, sequencing, decisions and
events).

A job that wants more resources asks one question of the cluster
backend: *whose* resources.  This module answers it for the autoscaler:
a scale-up replica's host is funded by **preempting a low-priority
background elastic training job** — shrink its world by one rank
through the tracker's ``POST /resize`` surface, launch a serving replica
on the freed host, and on scale-down give the host back so training
regrows to its original world with loss parity (the elastic resync
protocol makes the round trip loss-invisible).

:class:`ResizeClient` is the thin programmatic client for the tracker's
resize endpoint; :class:`TrainingPreemptingProvider` sequences a
preemption correctly — **kill the victim first, then resize with the
victim on the remove list** — because the generation machinery clamps a
bare world-target to the live-rank count (evicting a live rank needs it
killed, not resized; ``rendezvous._open_generation``).  The process
transport (how a rank is killed, how a replica is launched) is injected
as callables, so the provider is unit-testable and backend-agnostic.
"""

from __future__ import annotations

import json
import logging
import urllib.request
from typing import Callable, Dict, List, Optional

from ..concurrency import make_lock
from ..telemetry.tracecontext import record_decision

__all__ = ["HostProvider", "CallbackProvider", "ResizeClient",
           "TrainingPreemptingProvider"]

logger = logging.getLogger("dmlc_tpu_torch.fleet")


class ResizeClient:
    """Programmatic client for the tracker's elastic resize surface.

    ``POST /resize`` on the tracker's metrics endpoint requests a new
    generation (400 on a malformed body, 409 when the tracker is not
    elastic); ``GET /healthz`` reads the elastic block back (generation,
    world, resizes) so a caller can await the generation actually
    opening.
    """

    def __init__(self, metrics_url: str, timeout_s: float = 5.0):
        self.url = metrics_url.rstrip("/")
        self.timeout_s = float(timeout_s)

    def resize(self, world: int,
               remove: Optional[List[int]] = None) -> Dict:
        body: Dict = {"world": int(world)}
        if remove:
            body["remove"] = [int(r) for r in remove]
        req = urllib.request.Request(
            self.url + "/resize", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read())

    def elastic_status(self) -> Dict:
        with urllib.request.urlopen(self.url + "/healthz",
                                    timeout=self.timeout_s) as resp:
            doc = json.loads(resp.read())
        el = doc.get("elastic")
        return el if isinstance(el, dict) else {}


class HostProvider:
    """Where a scale-up replica comes from / where it goes back to.

    ``acquire()`` returns a ready replica base URL, or ``None`` when
    the provider has no more capacity (the autoscaler flags
    ``fleet_saturated``); ``release(url)`` tears that replica down
    (graceful drain included) and returns its host to whoever was
    preempted for it.  Both run on the autoscaler's control thread —
    they may block for the seconds a launch or drain takes.
    """

    def acquire(self) -> Optional[str]:
        raise NotImplementedError

    def release(self, url: str) -> None:
        raise NotImplementedError

    def stats(self) -> Dict:
        return {}


class CallbackProvider(HostProvider):
    """A provider from two callables plus a capacity bound — the
    simplest harness for tests and custom backends."""

    def __init__(self, acquire_fn: Callable[[], Optional[str]],
                 release_fn: Callable[[str], None], capacity: int = 1):
        self._acquire = acquire_fn
        self._release = release_fn
        self.capacity = int(capacity)
        self._lock = make_lock("CallbackProvider._lock")
        # dmlc-check: guarded-by(_lock)
        self._leased: List[str] = []

    def acquire(self) -> Optional[str]:
        with self._lock:
            if len(self._leased) >= self.capacity:
                return None
        url = self._acquire()
        if url is not None:
            with self._lock:
                self._leased.append(url)
        return url

    def release(self, url: str) -> None:
        self._release(url)
        with self._lock:
            if url in self._leased:
                self._leased.remove(url)

    def stats(self) -> Dict:
        with self._lock:
            return {"kind": "callback", "capacity": self.capacity,
                    "leased": len(self._leased)}


class TrainingPreemptingProvider(HostProvider):
    """Fund replica hosts by shrinking a low-priority elastic training
    job, host by host, and grow it back on release.

    ``acquire()`` picks the victim rank (highest first — rank 0 is the
    checkpoint/resync anchor, so it is never evicted), calls
    ``kill_rank(rank)`` to stop the victim's worker process, then posts
    the shrink WITH the victim on the remove list — the deterministic
    eviction path, no grace-window wait — and finally
    ``launch_replica(rank) -> url`` launches a warmed serving replica on
    the freed host.  ``release(url)`` reverses it: ``stop_replica(url)``
    drains and stops the replica, ``relaunch_rank(rank)`` starts a fresh
    training worker, and the grow resize restores the original world —
    the elastic checkpoint-restore-broadcast resync makes the final loss
    match the uninterrupted oracle.

    As in the reference, the victim is killed and the world shrunk
    before ``launch_replica`` runs: a launch that raises leaves training
    shrunk with no lease.

    The transport callables are injected (subprocess management is the
    harness's business, sequencing is ours); ``min_world`` bounds how
    far training may be eaten (default 1: never preempt the whole
    job).
    """

    def __init__(self, resize: ResizeClient, full_world: int,
                 kill_rank: Callable[[int], None],
                 launch_replica: Callable[[int], str],
                 stop_replica: Callable[[str], None],
                 relaunch_rank: Callable[[int], None],
                 min_world: int = 1, log=logger):
        if full_world < 1:
            raise ValueError("full_world must be >= 1")
        if not 1 <= min_world <= full_world:
            raise ValueError("need 1 <= min_world <= full_world")
        self.resize = resize
        self.full_world = int(full_world)
        self.min_world = int(min_world)
        self._kill_rank = kill_rank
        self._launch_replica = launch_replica
        self._stop_replica = stop_replica
        self._relaunch_rank = relaunch_rank
        self._log = log
        self._lock = make_lock("TrainingPreemptingProvider._lock")
        # dmlc-check: guarded-by(_lock)
        self._leases: Dict[str, int] = {}   # replica url -> victim rank
        # dmlc-check: guarded-by(_lock)
        self._preemptions = 0
        # dmlc-check: guarded-by(_lock)
        self._restores = 0

    def _training_world(self) -> int:
        """Current training world target (lock held by caller)."""
        return self.full_world - len(self._leases)

    def acquire(self) -> Optional[str]:
        from .. import telemetry

        with self._lock:
            world = self._training_world()
            if world <= self.min_world:
                return None  # training eaten to the bone: saturated
            victim = world - 1  # highest rank; rank 0 is the anchor
            new_world = world - 1
        self._log.info("fleet preempt: evicting training rank %d "
                       "(world %d -> %d) to fund a replica",
                       victim, world, new_world)
        # the decision chain below mirrors the action sequence step by
        # step so GET /decisions replays a preemption in causal order:
        # acquire intent -> victim killed -> world shrunk -> replica up
        record_decision("preempt_acquire", victim_rank=victim,
                        world=world, new_world=new_world)
        # kill FIRST: the resize generation machinery clamps the world
        # target to the live-rank count, so a live victim cannot be
        # resized away — eviction is kill + shrink-with-remove
        self._kill_rank(victim)
        record_decision("preempt_kill_rank", victim_rank=victim)
        self.resize.resize(new_world, remove=[victim])
        record_decision("preempt_resize", world=new_world,
                        removed=[victim])
        url = self._launch_replica(victim)
        with self._lock:
            self._leases[url] = victim
            self._preemptions += 1
        telemetry.record_event("fleet_preempt", rank=victim,
                               world=new_world, replica=url)
        record_decision("preempt_replica_added", replica=url,
                        victim_rank=victim)
        return url

    def release(self, url: str) -> None:
        from .. import telemetry

        with self._lock:
            if url not in self._leases:
                raise KeyError(f"no lease for replica {url}")
            victim = self._leases[url]
        # drain + stop the replica before the host is re-purposed; the
        # restore chain is audited like the acquire chain
        record_decision("preempt_release", replica=url,
                        victim_rank=victim)
        self._stop_replica(url)
        self._relaunch_rank(victim)
        record_decision("preempt_relaunch_rank", victim_rank=victim)
        with self._lock:
            del self._leases[url]
            new_world = self._training_world()
            self._restores += 1
        self._log.info("fleet restore: replica %s released, training "
                       "regrows to world %d", url, new_world)
        self.resize.resize(new_world)
        telemetry.record_event("fleet_restore", rank=victim,
                               world=new_world, replica=url)
        record_decision("preempt_restore_resize", world=new_world,
                        replica=url)

    def stats(self) -> Dict:
        with self._lock:
            return {"kind": "training_preempting",
                    "full_world": self.full_world,
                    "min_world": self.min_world,
                    "training_world": self._training_world(),
                    "leases": dict(self._leases),
                    "preemptions": self._preemptions,
                    "restores": self._restores}
