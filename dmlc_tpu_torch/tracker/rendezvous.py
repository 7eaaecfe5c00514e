"""Rank rendezvous server (RabitTracker) + PS scheduler bootstrap (the
port of ``dmlc_tpu/tracker/rendezvous.py``: same wire protocol, rank
assignment, overlay, brokering, heartbeat sink, failure detector and
elastic generations, so JAX and port workers join one job).

Behavioral rebuild of tracker/dmlc_tracker/tracker.py:137-433: TCP
server on a scanned port, handshake (magic, rank, world_size, jobid,
cmd ∈ {start, recover, shutdown, print}), batch rank assignment sorted
by host for locality, connection brokering between peers, `recover`
re-issuing topology to restarted workers, job wall-time logging.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import threading
import time
from typing import Dict, List, Optional

from ..base import DMLCError, get_env
from ..concurrency import make_lock
from .protocol import MAGIC, FrameSocket, link_maps, parse_worker_cmd, \
    resolve_ip

logger = logging.getLogger("dmlc_tpu_torch.tracker")


def _sock_timeout() -> Optional[float]:
    """Per-connection timeout for worker sockets.  A worker that dies
    without a FIN (SIGKILL'd host, dropped link) would otherwise leave
    the tracker blocked forever on a dead recv mid-brokering; the
    reference tracker (tracker.py:80-135) hangs exactly this way.
    0 disables (DMLC_TRACKER_TIMEOUT seconds, default 300)."""
    t = get_env("DMLC_TRACKER_TIMEOUT", 300.0)
    return t if t > 0 else None


class AcceptRegistry:
    """Ranks currently listening for inbound peer dials.

    A worker lands here after its brokering round leaves it with a
    nonzero inbound quota (peers that were not yet assigned when it
    finished, and so will be told to dial IT later).  Each time the
    tracker directs some later worker to dial rank r, r's quota drops;
    at zero the rank stops being a dial target and leaves the registry.

    Lock-protected: the failure detector (a separate thread) may
    ``drop()`` a dead rank while the accept loop brokers.
    """

    def __init__(self):
        self._listening: Dict[int, "WorkerEntry"] = {}
        self._lock = make_lock("AcceptRegistry._lock")

    def __contains__(self, rank: int) -> bool:
        with self._lock:
            return rank in self._listening

    def add(self, rank: int, worker: "WorkerEntry") -> None:
        if worker.inbound_quota > 0:
            with self._lock:
                self._listening[rank] = worker

    def drop(self, rank: int) -> None:
        """Remove a rank declared dead: later workers must not be told
        to dial its stale endpoint (they will be counted as accepts and
        satisfied when the replacement re-brokers)."""
        with self._lock:
            self._listening.pop(rank, None)

    def dial_targets(self, ranks) -> Dict[int, tuple]:
        """Atomic snapshot {rank: (host, port)} for the subset of
        ``ranks`` currently listening — membership and endpoint resolve
        under ONE lock hold, so a concurrent ``drop()`` by the failure
        detector can never KeyError the brokering loop between a
        membership check and the endpoint read."""
        with self._lock:
            return {r: (self._listening[r].host, self._listening[r].port)
                    for r in ranks if r in self._listening}

    def note_dialed(self, ranks) -> List[int]:
        """Record that ``ranks`` each just received one inbound link;
        returns those whose quota is now exhausted (and drops them).
        Ranks no longer present (dropped as dead mid-round) are
        skipped."""
        filled = []
        with self._lock:
            for r in ranks:
                w = self._listening.get(r)
                if w is None:
                    continue
                w.inbound_quota -= 1
                if w.inbound_quota == 0:
                    filled.append(r)
                    del self._listening[r]
        return filled


class WorkerEntry:
    """One accepted worker connection (reference SlaveEntry role)."""

    def __init__(self, sock: socket.socket, addr):
        sock.settimeout(_sock_timeout())
        self.sock = FrameSocket(sock)
        self.host = resolve_ip(addr[0])
        magic = self.sock.recv_int()
        if magic != MAGIC:
            raise ConnectionError(f"invalid magic {magic:#x} from {self.host}")
        self.sock.send_int(MAGIC)
        self.rank = self.sock.recv_int()
        self.world_size = self.sock.recv_int()
        self.jobid = self.sock.recv_str()
        self.cmd = self.sock.recv_str()
        self.inbound_quota = 0          # peers that will dial in later
        self.port: Optional[int] = None  # worker's accept port

    def decide_rank(self, job_map: Dict[str, int]) -> int:
        if self.rank >= 0:
            return self.rank
        if self.jobid != "NULL" and self.jobid in job_map:
            return job_map[self.jobid]
        return -1

    def _send_topology(self, rank, tree_map, parent_map, ring_map):
        """Issue rank + overlay neighbours; returns the full set of peer
        ranks this worker must end up linked to (tree ∪ ring)."""
        peers = set(tree_map[rank])
        self.sock.send_int(rank)
        self.sock.send_int(parent_map[rank])
        self.sock.send_int(len(tree_map))
        self.sock.send_int(len(peers))
        for r in peers:
            self.sock.send_int(r)
        for ring_nbr in ring_map[rank]:  # (prev, next)
            if ring_nbr != -1 and ring_nbr != rank:
                peers.add(ring_nbr)
                self.sock.send_int(ring_nbr)
            else:
                self.sock.send_int(-1)
        return peers

    def assign_rank(self, rank, registry: AcceptRegistry, tree_map,
                    parent_map, ring_map) -> List[int]:
        """Send topology, then broker peer links until the worker reports
        a clean round.  Wire format: reference tracker.py:80-135.

        Each round: the worker reports which links it already holds; the
        tracker answers with the endpoints it should DIAL now (peers
        already listening) and the count it should expect to ACCEPT
        later; the worker replies with its dial-error count — nonzero
        restarts the round, zero ends with the worker's accept port.
        Returns ranks whose inbound quota filled during this exchange.
        """
        self.rank = rank
        required = self._send_topology(rank, tree_map, parent_map, ring_map)
        filled: List[int] = []
        debited: set = set()  # dial targets already charged one inbound link
        dialed: set = set()   # every target we have handed out so far
        while True:
            n_held = self.sock.recv_int()
            held = {self.sock.recv_int() for _ in range(n_held)}
            if not held.issubset(required):
                raise DMLCError(
                    f"rank {rank} ({self.host}) reported links "
                    f"{sorted(held - required)} outside its assigned "
                    f"peer set {sorted(required)} — protocol violation")
            # dials that stuck during a FAILED earlier round show up in the
            # worker's held set now — charge their quotas exactly once
            confirmed = (held & dialed) - debited
            filled += registry.note_dialed(confirmed)
            debited |= confirmed
            missing = required - held
            targets = registry.dial_targets(missing)  # one atomic snapshot
            dial_now = sorted(targets)
            n_accept = len(missing) - len(dial_now)
            self.sock.send_int(len(dial_now))
            self.sock.send_int(n_accept)
            for r in dial_now:
                host, port = targets[r]
                self.sock.send_str(host)
                self.sock.send_int(port)
                self.sock.send_int(r)
            dialed |= set(dial_now)
            n_dial_errors = self.sock.recv_int()
            if n_dial_errors != 0:
                continue  # transient dial failures: rebroker from scratch
            self.port = self.sock.recv_int()
            # a clean round means every dial in it succeeded
            filled += registry.note_dialed(set(dial_now) - debited)
            self.inbound_quota = n_accept
            registry.add(rank, self)
            return filled


class RabitTracker:
    """Rendezvous server; one thread accepts workers until all shut down.

    Beyond rendezvous, the tracker is the cluster's telemetry sink:
    workers push periodic heartbeats (``metrics`` command sessions, same
    shape as the ``print`` relay) into a :class:`TelemetryAggregator`,
    and ``metrics_port`` (or ``DMLC_TRACKER_METRICS_PORT``; 0 =
    ephemeral) serves the merged view over HTTP ``/metrics``
    (Prometheus text) + ``/healthz`` (+ ``POST /resize``), with
    straggler ranks flagged via ``logging.warning``.  The heartbeats'
    clock samples feed a :class:`ClockOffsetEstimator` (``/healthz``
    ``clock_offsets``).  The JAX tracker's flight recorder, anomaly
    watchdog, goodput aggregator and incident reporter (``/trace``,
    ``/anomalies``, ``/compute``, ``/goodput``, ``/incidents``) are not
    ported yet (ROADMAP.md Queue 1 item 9): the heartbeat fields they
    read are accepted and ignored.

    Failure detection: with a positive ``miss_window_s`` (or
    ``DMLC_TRACKER_MISS_WINDOW_S``; default 0 = disabled) a monitor
    thread watches the heartbeat stream and declares a rank DEAD once
    its heartbeats go missing for the window: the rank's connection is
    dropped (closed + removed from the dial registry) WITHOUT killing
    the accept loop, the death is logged and counted
    (``resilience.worker_declared_dead``), and /healthz lists the rank
    under ``dead_ranks``.  A replacement worker re-admitted through the
    existing ``recover``/job-map path clears the flag and counts as
    ``resilience.worker_readmitted`` — the tracker's half of supervised
    restart (the launcher's restart budget owns re-running the task).

    Elastic mode (``elastic=True`` or ``DMLC_ELASTIC=1``) makes the
    world size a run-time variable via *resize generations*: a rank
    still dead ``elastic_grace_s`` (``DMLC_ELASTIC_GRACE_S``, default 5)
    past its death declaration is evicted — the tracker opens a new
    generation, renumbering survivors into a dense ``[0, N')`` rank
    space, rebuilding the tree+ring overlay, and re-brokering links as
    each survivor re-enters rendezvous (``recover@<gen>`` announces are
    translated through per-generation rank maps).  Scale-up arrives via
    ``POST /resize`` on the metrics server (or implicitly: a join
    announce against a full world grows it by one) and is pushed to
    survivors as the generation id piggybacked on every heartbeat
    reply.  Resizes are applied by the accept-loop thread at session
    boundaries, so generation state needs no extra locking; every
    resize lands in the event ring (``world_resized``) and on /metrics
    (``dmlc_elastic_*``).
    """

    #: generations of rank-translation history kept for stale recovers
    MAX_RANK_MAP_HISTORY = 8

    def __init__(self, host_ip: str, n_workers: int,
                 port: int = 9091, port_end: int = 9999,
                 metrics_port: Optional[int] = None,
                 miss_window_s: Optional[float] = None,
                 elastic: Optional[bool] = None,
                 elastic_grace_s: Optional[float] = None):
        family = socket.getaddrinfo(host_ip, None)[0][0]
        # the accept loop IS the tracker's main loop: blocking forever
        # on accept() between sessions is its designed idle state, and
        # every ACCEPTED connection gets a per-socket timeout in
        # WorkerEntry  # dmlc-check: disable=socket-no-timeout
        sock = socket.socket(family, socket.SOCK_STREAM)
        for p in range(port, port_end):
            try:
                sock.bind((host_ip, p))
                self.port = p
                break
            except OSError:
                continue
        else:
            raise OSError(f"no free tracker port in [{port},{port_end})")
        sock.listen(256)
        self.sock = sock
        self.host_ip = host_ip
        self.n_workers = n_workers
        # dmlc-check: unguarded(start/join control-thread lifecycle)
        self.thread: Optional[threading.Thread] = None
        # dmlc-check: unguarded(accept-loop writes; logged after join)
        self.start_time: Optional[float] = None
        # dmlc-check: unguarded(accept-loop writes; logged after join)
        self.end_time: Optional[float] = None
        if miss_window_s is None:
            miss_window_s = get_env("DMLC_TRACKER_MISS_WINDOW_S", 0.0)
        self.miss_window_s = miss_window_s
        if elastic is None:
            elastic = get_env("DMLC_ELASTIC", False)
        self.elastic = bool(elastic)
        if elastic_grace_s is None:
            elastic_grace_s = get_env("DMLC_ELASTIC_GRACE_S", 5.0)
        self.elastic_grace_s = elastic_grace_s
        # dmlc-check: unguarded(accept-loop-owned; cross-thread int reads are stale-tolerant)
        self.gen = 0
        self._resize_lock = make_lock("RabitTracker._resize_lock")
        self._resize_req: Optional[Dict] = None
        # dmlc-check: unguarded(accept-loop-confined — class docstring)
        self._rank_maps: Dict[int, Dict[int, int]] = {}  # gen -> old->new
        self._dead_since: Dict[int, float] = {}          # rank -> monotonic
        self._evicted_total = 0
        # accept-loop world state (mutated only on the accept thread)
        # dmlc-check: unguarded(accept-loop-owned; cross-thread int reads are stale-tolerant)
        self._world = n_workers
        # dmlc-check: unguarded(accept-loop-confined — class docstring)
        self._tree_map = None
        # dmlc-check: unguarded(accept-loop-confined — class docstring)
        self._parent_map = None
        # dmlc-check: unguarded(accept-loop-confined — class docstring)
        self._ring_map = None
        # dmlc-check: unguarded(accept-loop-confined — class docstring)
        self._job_map: Dict[str, int] = {}
        # dmlc-check: unguarded(accept-loop-confined — class docstring)
        self._todo: List[int] = []
        # dmlc-check: unguarded(accept-loop-confined — class docstring)
        self._pending: List["WorkerEntry"] = []
        # dmlc-check: unguarded(accept-loop-confined — class docstring)
        self._shutdown: Dict[int, "WorkerEntry"] = {}
        self.dead_ranks: set = set()
        self._finished_ranks: set = set()  # clean shutdowns: never "dead"
        self._dead_lock = make_lock("RabitTracker._dead_lock")
        # dmlc-check: unguarded(accept-loop-confined — class docstring)
        self._entries: Dict[int, "WorkerEntry"] = {}
        # dmlc-check: unguarded(accept-loop-confined — class docstring)
        self._registry: Optional[AcceptRegistry] = None
        # dmlc-check: unguarded(start/close control-thread lifecycle)
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        from ..telemetry import ClockOffsetEstimator, TelemetryAggregator, \
            exporters

        # local_snapshot: the tracker process IS the launcher for local
        # jobs — its own registry carries restart/retry counters that no
        # worker heartbeat ever will; publish them under rank="tracker"
        self.telemetry = TelemetryAggregator(
            log=logger,
            local_snapshot=lambda: exporters.export_json(
                include_buckets=True))
        self.telemetry.extra_health = lambda: {
            "dead_ranks": self._dead_snapshot(),
            "clock_offsets": self._clock_snapshot(),
            "elastic": self._elastic_snapshot()}
        # per-rank clock offsets from the samples each heartbeat's trace
        # sub-document carries (TrackerClient.clock_ping)
        self.clock = ClockOffsetEstimator()
        # dmlc-check: unguarded(built pre-start; closed by the control thread)
        self.metrics_server = None
        self.metrics_port: Optional[int] = None
        if metrics_port is None:
            metrics_port = get_env("DMLC_TRACKER_METRICS_PORT", None, int)
        if metrics_port is not None:
            from ..telemetry import TelemetryHTTPServer

            self.metrics_server = TelemetryHTTPServer(
                self.telemetry, host=host_ip, port=metrics_port,
                resize_handler=self._http_resize)
            self.metrics_port = self.metrics_server.port
            logger.info("tracker /metrics + /healthz + /resize on %s:%d",
                        host_ip, self.metrics_port)
        logger.info("tracker listening on %s:%d", host_ip, self.port)

    def worker_envs(self) -> Dict[str, str]:
        return {
            "DMLC_TRACKER_URI": self.host_ip,
            "DMLC_TRACKER_PORT": str(self.port),
        }

    def _fail(self, msg: str) -> DMLCError:
        # protocol violations from REGISTERED workers corrupt the
        # job's rank/link state: fail the whole tracker loudly (the
        # reference dies on a bare assert here; we say why) — the
        # launcher's retry machinery owns restarting the job
        return DMLCError(f"tracker protocol violation: {msg}")

    def _reject_announce(self, w: "WorkerEntry", why: str) -> None:
        """A malformed announce (world_size mismatch, recover without a
        rank, rank beyond the world, unknown command) is the announcing
        CONNECTION's problem, not the job's: drop it, count it, keep
        brokering.  The reference tracker dies on a bare assert here and
        takes the whole accept loop — and every other worker — with it."""
        from .. import telemetry

        telemetry.inc("tracker", "rejected_announces")
        telemetry.record_event("announce_rejected", host=w.host,
                               cmd=w.cmd, rank=w.rank, why=why)
        logger.warning("rejected %r announce from %s (rank %d): %s",
                       w.cmd, w.host, w.rank, why)
        w.sock.close()

    def _broker(self, entry: "WorkerEntry", rank: int) -> None:
        # a worker dying (or going silent past DMLC_TRACKER_TIMEOUT)
        # mid-brokering leaves the overlay unbuildable: error out so
        # join()/_await_job abort instead of hanging the whole gang.
        # In elastic mode the job OUTLIVES individual workers: the
        # half-brokered rank is declared dead instead (grace then
        # shrinks the world past it) and the loop keeps serving.
        try:
            entry.assign_rank(rank, self._registry, self._tree_map,
                              self._parent_map, self._ring_map)
        except socket.timeout as e:
            if self.elastic:
                self._broker_casualty(entry, rank, f"went silent: {e}")
                return
            raise DMLCError(
                f"worker rank {rank} ({entry.host}) went silent "
                f"mid-brokering (DMLC_TRACKER_TIMEOUT="
                f"{_sock_timeout()}s)") from e
        except OSError as e:
            if self.elastic:
                self._broker_casualty(entry, rank, f"died: {e}")
                return
            raise DMLCError(
                f"worker rank {rank} ({entry.host}) died "
                f"mid-brokering: {e}") from e
        self._entries[rank] = entry
        if entry.jobid != "NULL":
            self._job_map[entry.jobid] = rank
        self._note_admitted(rank, entry.cmd)

    def _broker_casualty(self, entry: "WorkerEntry", rank: int,
                         why: str) -> None:
        """Elastic-mode brokering failure: the rank is treated as a
        fresh death (registry cull + dead flag), so the grace window
        shrinks the world past it instead of the tracker dying."""
        logger.warning("worker rank %d (%s) %s mid-brokering; declaring "
                       "dead (elastic mode keeps serving)", rank,
                       entry.host, why)
        entry.sock.close()
        self._registry.drop(rank)
        self._declare_dead(rank, 0.0)

    # ---- elastic resize machinery --------------------------------------
    def request_resize(self, world: Optional[int] = None, remove=(),
                       reason: str = "operator") -> int:
        """Record a pending membership change; thread-safe.  The change
        is APPLIED by the accept-loop thread at its next session
        boundary (heartbeats arrive continuously, so that is prompt) —
        resizing between sessions means generation state never needs a
        lock against mid-brokering mutation.  Returns the current
        generation (the resize, once applied, will be a later one)."""
        from .. import telemetry

        if not self.elastic:
            raise RuntimeError(
                "tracker is not elastic; start it with elastic=True or "
                "DMLC_ELASTIC=1 to resize the world at run time")
        remove = set(remove)
        with self._resize_lock:
            req = self._resize_req or {"world": None, "remove": set(),
                                       "reasons": []}
            if world is not None:
                world = int(world)
                req["world"] = max(world, req["world"] or 0)
            req["remove"] |= remove
            if reason not in req["reasons"]:
                req["reasons"].append(reason)
            self._resize_req = req
        telemetry.record_event("resize_requested", world=world,
                               remove=sorted(remove), reason=reason,
                               gen=self.gen)
        logger.info("resize requested (%s): world=%s remove=%s",
                    reason, world, sorted(remove))
        return self.gen

    def _http_resize(self, doc: Dict) -> Dict:
        """POST /resize handler: {'world': N} grows (or re-targets) the
        world; an optional {'remove': [rank, ...]} list names ranks to
        evict from the next generation (the fleet autoscaler's
        preemption path: the victim is killed first, then named here so
        the shrink opens deterministically instead of waiting out the
        miss window).  Survivors learn via the heartbeat generation
        piggyback."""
        world = doc.get("world")
        if world is not None:
            if isinstance(world, bool) or not isinstance(world, int):
                raise ValueError("world must be an integer")
            if not 0 < world <= 65536:
                raise ValueError(f"world {world} out of range")
        remove = doc.get("remove", ())
        if remove:
            if (not isinstance(remove, list)
                    or not all(isinstance(r, int)
                               and not isinstance(r, bool)
                               for r in remove)):
                raise ValueError("remove must be a list of ranks")
            if not all(0 <= r < 65536 for r in remove):
                raise ValueError(f"remove ranks {remove} out of range")
        gen = self.request_resize(world=world, remove=remove,
                                  reason=str(doc.get("reason", "operator")))
        return {"requested": True, "gen": gen, "world_target": world,
                "remove": sorted(set(remove)) if remove else [],
                "current_world": self._world}

    def _apply_pending_resize(self) -> None:
        """Accept-loop thread only: open a new generation if a resize
        request is pending."""
        if not self.elastic:
            return
        with self._resize_lock:
            req, self._resize_req = self._resize_req, None
        if req is None:
            return
        if self._tree_map is None:
            # world not formed yet: just re-target the initial size
            if req["world"]:
                self._world = req["world"]
                logger.info("pre-start resize: initial world now %d",
                            self._world)
            return
        self._open_generation(req)

    def _open_generation(self, req: Dict) -> None:
        """Renumber survivors into a dense [0, N') rank space, rebuild
        the overlay maps, and reset brokering state.  Survivors carry
        their old rank into ``recover@<gen>`` announces and are
        translated through ``_rank_maps``; new ranks (scale-up) fill
        ``todo`` and are assigned to joining workers."""
        from .. import telemetry

        remove = set(req["remove"])
        # a slot still in todo has no worker behind it: carrying it into
        # the new generation would mint a phantom member that never
        # heartbeats and never brokers, wedging everyone else's
        # rendezvous.  Its expected joiner (if any) re-enters through
        # the pending claim / implicit-grow paths instead.
        unassigned = set(self._todo)
        survivors = [r for r in range(self._world)
                     if r not in remove and r not in self._shutdown
                     and r not in unassigned]
        target = req["world"] or len(survivors)
        if target < len(survivors):
            logger.warning(
                "resize target %d below survivor count %d; clamping "
                "(evicting live ranks needs them killed, not resized)",
                target, len(survivors))
            target = len(survivors)
        # joiners parked in _pending keep their claim on a slot across
        # the resize — without this a shrink that rebuilt todo empty
        # would strand them forever (and their presence would suppress
        # the implicit +1 grow for anyone after them)
        target = max(target, len(survivors) + len(self._pending))
        rank_map = {old: new for new, old in enumerate(survivors)}
        self._rank_maps[self.gen] = rank_map
        for g in list(self._rank_maps):
            if g <= self.gen - self.MAX_RANK_MAP_HISTORY:
                del self._rank_maps[g]
        old_world, old_gen = self._world, self.gen
        self.gen += 1
        self._world = target
        self._tree_map, self._parent_map, self._ring_map = \
            link_maps(target)
        self._todo = list(range(len(survivors), target))
        self._job_map = {jid: rank_map[r]
                         for jid, r in self._job_map.items()
                         if r in rank_map}
        self._shutdown = {}
        # stale listeners and rendezvous sockets of the old generation
        # must never be handed out as dial targets again
        self._registry = AcceptRegistry()
        for entry in self._entries.values():
            entry.sock.close()
        self._entries = {}
        with self._dead_lock:
            self._evicted_total += len(remove & self.dead_ranks)
            # dead bookkeeping follows the renumbering too: a rank dead
            # but still inside grace IS a survivor and keeps its flag
            # under the new id; entries for removed ranks drop out (a
            # stale old-generation id left behind would later evict
            # whichever LIVE worker now holds that number)
            self.dead_ranks = {rank_map[r] for r in self.dead_ranks
                               if r in rank_map}
            self._dead_since = {rank_map[r]: t
                                for r, t in self._dead_since.items()
                                if r in rank_map}
            self._finished_ranks.clear()
        # heartbeat bookkeeping follows the renumbering: a survivor's
        # age must not be split between its old and new rank ids (the
        # failure detector would re-declare phantom deaths)
        self.telemetry.remap_ranks(rank_map)
        # clock relations move with the surviving process too
        self.clock.remap_ranks(rank_map)
        telemetry.inc("elastic", "resizes_total")
        telemetry.inc("elastic", "shrinks_total"
                      if target < old_world else "grows_total")
        telemetry.set_gauge("elastic", "generation", self.gen)
        telemetry.set_gauge("elastic", "world_size", self._world)
        telemetry.record_event(
            "world_resized", gen=self.gen, world=target,
            old_world=old_world, survivors=len(survivors),
            removed=sorted(remove), new_slots=len(self._todo),
            reasons=req["reasons"])
        logger.info(
            "@tracker generation %d -> %d: world %d -> %d (%d survivors "
            "renumbered, %d removed, %d new slots) [%s]", old_gen,
            self.gen, old_world, target, len(survivors), len(remove),
            len(self._todo), ",".join(req["reasons"]))
        if self._pending and self._todo \
                and len(self._pending) >= len(self._todo):
            self._assign_pending()

    def _translate_rank(self, rank: int, announced_gen: int) -> Optional[int]:
        """Chase a rank from ``announced_gen`` through the per-generation
        maps into the current generation; None once it left membership
        (evicted while away — the caller re-admits it as a scale-up
        join) or the history no longer reaches back that far."""
        if announced_gen > self.gen:
            return None
        for g in range(announced_gen, self.gen):
            m = self._rank_maps.get(g)
            if m is None or rank not in m:
                return None
            rank = m[rank]
        return rank

    def _gen_doc(self) -> str:
        with self._dead_lock:
            n_dead = len(self.dead_ranks)
        return json.dumps({"gen": self.gen, "world": self._world,
                           "elastic": self.elastic, "dead": n_dead})

    def _hosts_doc(self) -> str:
        """Rank → (host, accept-port) snapshot of every fully-brokered
        worker.  Served by the accept-loop thread, which is the only
        mutator of ``_entries``, so no locking.  Clients poll until the
        map covers the whole world (a worker mid-brokering has no port
        yet and is omitted)."""
        hosts = {str(r): [e.host, e.port]
                 for r, e in self._entries.items() if e.port is not None}
        return json.dumps({"gen": self.gen, "world": self._world,
                           "hosts": hosts})

    def _accept_loop(self, n_workers: int) -> None:
        self._world = n_workers
        self._registry = AcceptRegistry()

        while True:
            if self._tree_map is not None \
                    and len(self._shutdown) >= self._world:
                break  # every member of the current generation finished
            fd, addr = self.sock.accept()
            # apply membership changes at the session boundary, BEFORE
            # this session is interpreted: a joiner's announce must see
            # the grown world, and the heartbeat reply below must carry
            # the post-resize generation
            self._apply_pending_resize()
            try:
                w = WorkerEntry(fd, addr)
                if w.cmd == "print":
                    logger.info("%s", w.sock.recv_str().strip())
                    continue
                if w.cmd == "gen":
                    # elastic status probe: resize()'s settle-wait polls
                    # this until the membership change lands
                    w.sock.send_str(self._gen_doc())
                    continue
                if w.cmd == "hosts":
                    # job-map probe: rank -> (host, accept port) of the
                    # current generation — the hier collective's auto
                    # host-grouping and leader-ring dialing read this
                    w.sock.send_str(self._hosts_doc())
                    continue
                if w.cmd == "metrics":
                    # telemetry heartbeat: latest snapshot for this rank
                    # (short session, like print; never fails the job).
                    # Parsed ONCE here — beats run up to
                    # DMLC_TELEMETRY_MAX_BEAT_BYTES and this loop also
                    # serves rendezvous/clock traffic
                    payload = w.sock.recv_str()
                    try:
                        doc = json.loads(payload)
                        if not isinstance(doc, dict):
                            raise TypeError("non-dict telemetry "
                                            f"({type(doc).__name__})")
                    except Exception as e:  # noqa: BLE001 - keep serving
                        logger.warning(
                            "rank %d sent malformed telemetry: %r",
                            w.rank, e)
                        doc = None
                    # the reply carries the current generation — the
                    # scale-up push channel (a grow resize severs no
                    # links, so the heartbeat is how survivors learn);
                    # sent even for malformed beats so the sender's
                    # reply read never stalls on its own bad payload
                    w.sock.send_int(self.gen)
                    if doc is None:
                        continue
                    self.telemetry.update(w.rank, doc)
                    # the selfheal/compute/goodput fields and the trace's
                    # spans and steps feed consumers not ported yet
                    # (ROADMAP.md Queue 1 items 8-9); its clock sample
                    # feeds the offset estimator
                    trace = doc.get("trace")
                    clk = trace.get("clock") if isinstance(trace, dict) \
                        else None
                    if isinstance(clk, dict):
                        try:
                            self.clock.update(w.rank,
                                              float(clk["offset_s"]),
                                              float(clk["rtt_s"]))
                        except (KeyError, TypeError, ValueError):
                            pass
                    continue
                if w.cmd == "clock":
                    # NTP-style ping: stamp receipt (t1) and reply send
                    # (t2) on the tracker's clock; the worker computes
                    # the offset sample and ships it with its next beat
                    w.sock.recv_str()  # worker's t0 (it keeps its own)
                    t1 = time.time()
                    w.sock.send_str(json.dumps(
                        {"t1": t1, "t2": time.time()}))
                    continue
            except (OSError, UnicodeDecodeError) as e:
                # pre-registration garbage (port scans, torn handshakes,
                # bad frames) must not kill the job: reject and serve on
                logger.warning("rejected connection from %s: %s",
                               addr[0], e)
                fd.close()
                continue
            base_cmd, announced_gen = parse_worker_cmd(w.cmd)
            if base_cmd == "shutdown":
                rank = w.rank
                if self.elastic and announced_gen is not None \
                        and announced_gen < self.gen:
                    # the finishing worker may never have re-brokered
                    # into the newest generation: chase its rank through
                    # the maps so the RIGHT completion slot is marked
                    rank = self._translate_rank(w.rank, announced_gen)
                    if rank is None:
                        logger.info(
                            "shutdown from evicted rank %d of gen %d "
                            "(%s); no longer a member — ignored",
                            w.rank, announced_gen, w.host)
                        w.sock.close()
                        continue
                if rank < 0 or rank >= self._world \
                        or rank in self._shutdown:
                    raise self._fail(
                        f"shutdown from rank {rank} "
                        f"(out of range for {self._world} workers, "
                        f"already shut down, or never assigned)")
                if rank in self._registry:
                    raise self._fail(f"rank {rank} shut down while "
                                     f"peers still expect to dial it")
                self._shutdown[rank] = w
                # a cleanly-finished rank leaves the failure detector's
                # watch: its heartbeat age grows forever from here, and
                # flagging it dead would corrupt the death counters
                self._entries.pop(rank, None)
                with self._dead_lock:
                    self._finished_ranks.add(rank)
                    self.dead_ranks.discard(rank)
                logger.debug("shutdown from rank %d", rank)
                continue
            self._handle_announce(w)
        self.end_time = time.time()
        if self.start_time is not None:
            logger.info("@tracker %.3f secs between start and finish",
                        self.end_time - self.start_time)

    def _handle_announce(self, w: "WorkerEntry") -> None:
        """One start/recover announce: resolve the rank (translating
        elastic recovers across generations), then broker."""
        cmd, announced_gen = parse_worker_cmd(w.cmd)
        if cmd not in ("start", "recover"):
            self._reject_announce(w, "unknown command")
            return
        if self._tree_map is None:
            if cmd != "start":
                self._reject_announce(w, "recover before any worker "
                                      "started")
                return
            if w.world_size > 0:
                self._world = w.world_size
            self._tree_map, self._parent_map, self._ring_map = \
                link_maps(self._world)
            self._todo = list(range(self._world))
        elif w.world_size not in (-1, self._world):
            self._reject_announce(
                w, f"announced world_size {w.world_size} != "
                   f"{self._world}")
            return
        if cmd == "recover" and w.rank < 0:
            self._reject_announce(w, "recover without a rank")
            return

        if self.elastic and announced_gen is not None \
                and announced_gen < self.gen:
            # an elastic re-rendezvous carrying a rank from an older
            # generation: chase it through the rank maps; a worker that
            # was evicted while away re-joins as a scale-up
            rank = self._translate_rank(w.rank, announced_gen)
            if rank is None:
                logger.info(
                    "rank %d of gen %d (%s) no longer a member; "
                    "re-admitting as a scale-up join", w.rank,
                    announced_gen, w.host)
                rank = -1
        else:
            rank = w.decide_rank(self._job_map)
        # a client-supplied rank must be a real slot — an out-of-range
        # value would KeyError deep inside the topology send instead
        # of dying diagnosably here
        if rank >= self._world:
            self._reject_announce(
                w, f"rank {rank} >= world size {self._world}")
            return
        if rank == -1:
            if not self._todo and not self._pending:
                if not self.elastic:
                    raise self._fail(
                        f"{w.host} asked for a rank but all "
                        f"{self._world} slots are assigned")
                # elastic: a join against a full world is an implicit
                # scale-up generation of +1 (a gang-rescheduled slice
                # arriving after its old ranks were evicted lands here)
                self.request_resize(world=self._world + 1, reason="join")
                self._apply_pending_resize()
            self._pending.append(w)
            if self._todo and len(self._pending) >= len(self._todo):
                self._assign_pending()
        else:
            self._broker(w, rank)
            logger.debug("%s from rank %d", w.cmd, rank)

    def _assign_pending(self) -> None:
        """Batch-assign waiting joiners to the open ``todo`` slots
        (sorted by host for locality).  A resize can leave more joiners
        waiting than slots; the overflow stays pending for the next
        generation."""
        self._pending.sort(key=lambda x: x.host)
        assign, self._pending = (self._pending[:len(self._todo)],
                                 self._pending[len(self._todo):])
        for p in assign:
            rank = self._todo.pop(0)
            if p.jobid != "NULL":
                self._job_map[p.jobid] = rank
            self._broker(p, rank)
            logger.debug("assigned rank %d to %s", p.rank, p.host)
        if not self._todo:
            logger.info("@tracker all %d workers started", self._world)
            if self.start_time is None:
                self.start_time = time.time()

    # ---- heartbeat-driven failure detection ----------------------------
    def _elastic_snapshot(self) -> Dict:
        """The /healthz elastic block.  ``_evicted_total`` is mutated
        under ``_dead_lock`` so the read takes it too; ``gen``/``_world``
        are accept-loop-owned ints whose stale snapshot a health view
        tolerates (see their declarations)."""
        with self._dead_lock:
            evicted = self._evicted_total
        return {"enabled": self.elastic, "gen": self.gen,
                "world": self._world, "evicted_total": evicted}

    def _dead_snapshot(self) -> List[int]:
        with self._dead_lock:  # the monitor mutates the set concurrently
            return sorted(self.dead_ranks)

    def _clock_snapshot(self) -> Dict[str, Dict[str, float]]:
        return {str(r): s for r, s in self.clock.snapshot().items()}

    def _note_admitted(self, rank: int, cmd: str) -> None:
        """A worker finished brokering under ``rank``: if that rank was
        declared dead, this is the supervised-restart re-admission."""
        with self._dead_lock:
            was_dead = rank in self.dead_ranks
            self.dead_ranks.discard(rank)
            self._dead_since.pop(rank, None)
            self._finished_ranks.discard(rank)
        self.telemetry.touch(rank)  # restart the miss-window clock
        if was_dead:
            from .. import telemetry

            telemetry.inc("resilience", "worker_readmitted")
            telemetry.record_event("worker_readmitted", rank=rank, cmd=cmd)
            logger.info("rank %d re-admitted via %r after being declared "
                        "dead", rank, cmd)

    def _declare_dead(self, rank: int, age: float) -> None:
        from .. import telemetry

        with self._dead_lock:
            if rank in self.dead_ranks:
                return
            self.dead_ranks.add(rank)
            # elastic grace clock: a rank still dead this long past the
            # declaration is evicted via a shrink generation
            self._dead_since.setdefault(rank, time.monotonic())
        telemetry.inc("resilience", "worker_declared_dead")
        telemetry.record_event("declared_dead", rank=rank,
                               age_s=round(age, 3),
                               miss_window_s=self.miss_window_s)
        logger.warning(
            "rank %d declared dead: no heartbeat for %.1fs (miss window "
            "%.1fs); dropping its connection and awaiting a replacement",
            rank, age, self.miss_window_s)
        entry = self._entries.pop(rank, None)
        if entry is not None:
            entry.sock.close()  # usually already closed by the worker
        if self._registry is not None:
            self._registry.drop(rank)

    def _monitor_loop(self) -> None:
        interval = max(0.1, min(1.0, self.miss_window_s / 4))
        while not self._monitor_stop.wait(interval):
            with self._dead_lock:
                finished = set(self._finished_ranks)
            for rank, age in self.telemetry.ranks().items():
                if rank in finished:
                    continue  # clean shutdown: silence is expected
                if rank >= self._world:
                    # a pre-resize rank id lingering in the heartbeat
                    # store (its owner now beats under a renumbered
                    # rank): never a death, just stale bookkeeping
                    continue
                if age > self.miss_window_s:
                    self._declare_dead(rank, age)
                else:
                    # heartbeats resumed (replacement already pushing
                    # before its brokering finished): clear the flag
                    with self._dead_lock:
                        self.dead_ranks.discard(rank)
                        self._dead_since.pop(rank, None)
            if self.elastic:
                now = time.monotonic()
                with self._dead_lock:
                    expired = sorted(
                        r for r, t in self._dead_since.items()
                        if r in self.dead_ranks
                        and now - t > self.elastic_grace_s)
                if expired:
                    # still dead past the grace window: evict via a
                    # shrink generation (idempotent until applied by
                    # the accept loop at its next session)
                    self.request_resize(remove=expired,
                                        reason="grace_expired")

    def start(self, n_workers: Optional[int] = None) -> None:
        n = self.n_workers if n_workers is None else n_workers
        # dmlc-check: unguarded(written before thread exit; join() reads after)
        self.error: Optional[BaseException] = None

        def run():
            try:
                self._accept_loop(n)
            except BaseException as e:  # surfaced by join()/_await_job
                self.error = e
                logger.error("tracker accept loop died: %s", e)
            finally:
                self._monitor_stop.set()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        if self.miss_window_s > 0 and self._monitor is None:
            self._monitor = threading.Thread(
                target=self._monitor_loop, daemon=True,
                name="tracker-failure-detector")
            self._monitor.start()

    def join(self, timeout: Optional[float] = None) -> None:
        assert self.thread is not None
        deadline = None if timeout is None else time.time() + timeout
        while self.thread.is_alive():
            self.thread.join(0.1)
            if deadline is not None and time.time() > deadline:
                raise TimeoutError("tracker did not finish in time")
        if self.error is not None:
            raise RuntimeError(f"tracker failed: {self.error}") from self.error

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def close(self) -> None:
        self._monitor_stop.set()
        try:
            self.sock.close()
        except OSError:
            pass
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None


def free_port(host_ip: str = "127.0.0.1") -> int:
    """Find a currently-free TCP port on ``host_ip`` without holding it."""
    probe = socket.socket()
    probe.settimeout(5.0)  # bind/getsockname never block, but keep the
    probe.bind((host_ip, 0))  # no-unbounded-socket invariant uniform
    port = probe.getsockname()[1]
    probe.close()
    return port


class PSTracker:
    """Parameter-server scheduler bootstrap (tracker.py:336-386 analog):
    runs the scheduler process locally with the PS env contract."""

    def __init__(self, host_ip: str, cmd: Optional[str], envs: Dict[str, str],
                 port: int = 9091, port_end: int = 9999):
        self.host_ip = host_ip
        self.cmd = cmd
        # dmlc-check: unguarded(start/join control-thread lifecycle)
        self.thread = None
        self.proc: Optional[subprocess.Popen] = None
        # dmlc-check: unguarded(written before the watcher thread exits; join() reads after it)
        self.error: Optional[BaseException] = None
        # dmlc-check: unguarded(control-thread terminate latch; watcher read race is benign)
        self._terminated = False
        self.port = free_port(host_ip)
        if cmd is None:
            return
        env = os.environ.copy()
        env.update(envs)
        env.update({
            "DMLC_ROLE": "scheduler",
            "DMLC_PS_ROOT_URI": str(self.host_ip),
            "DMLC_PS_ROOT_PORT": str(self.port),
        })
        # Popen (not check_call) so an aborting job can terminate() the
        # scheduler: a lingering scheduler child inherits the launcher's
        # stdio and keeps a captured pipe open long after dmlc-submit
        # exits, hanging whoever waits on that pipe.
        self.proc = subprocess.Popen(self.cmd, shell=True, env=env)

        def run():
            # a dead scheduler must abort the job fast, not leave every
            # worker hanging on DMLC_PS_ROOT_PORT — record the failure
            # for _await_job/join instead of losing it in a daemon thread
            try:
                rc = self.proc.wait()
                if rc != 0 and not self._terminated:
                    raise RuntimeError(f"scheduler exited {rc}")
            except BaseException as e:
                self.error = e
                logger.error("PS scheduler died: %s", e)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def terminate(self) -> None:
        """Kill the scheduler process (job abort path).  Flagged first
        so the watcher thread reports the deliberate kill as cleanup,
        not as a scheduler failure."""
        self._terminated = True
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()

    def worker_envs(self) -> Dict[str, str]:
        return {
            "DMLC_PS_ROOT_URI": str(self.host_ip),
            "DMLC_PS_ROOT_PORT": str(self.port),
        }

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def join(self) -> None:
        if self.thread is not None:
            self.thread.join()
        if self.error is not None:
            raise RuntimeError(
                f"PS scheduler failed: {self.error}") from self.error


def submit_job(n_workers: int, n_servers: int, fun_submit, host_ip: str = "auto",
               pscmd: Optional[str] = None, join: bool = True):
    """Start tracker(s), call fun_submit(n_workers, n_servers, envs), wait.

    The reference's tracker.submit (tracker.py:410-433): rabit path when
    n_servers == 0, PS path otherwise.
    """
    if host_ip == "auto":
        host_ip = get_env("DMLC_TRACKER_URI", "") or _default_host_ip()
    envs = {"DMLC_NUM_WORKER": str(n_workers),
            "DMLC_NUM_SERVER": str(n_servers)}
    # The jax.distributed coordinator is a gRPC service that rank 0 of the
    # JOB must host — it cannot share DMLC_TRACKER_PORT, which is the rabit
    # tracker's own listener in THIS process.  The tracker owns port
    # assignment, so it hands out a distinct free port; the URI defaults to
    # the tracker host (right for local jobs; gang backends override it
    # with the host where task 0 is placed).  The freeness probe runs on
    # THIS machine — for remote coordinators it is only a sane default;
    # override with --env DMLC_JAX_COORD_PORT=... if it collides there.
    envs["DMLC_JAX_COORD_URI"] = host_ip
    envs["DMLC_JAX_COORD_PORT"] = str(free_port(host_ip))
    rabit = ps = None
    if n_servers == 0:
        rabit = RabitTracker(host_ip, n_workers)
        envs.update(rabit.worker_envs())
        rabit.start(n_workers)
    else:
        ps = PSTracker(host_ip, pscmd, envs)
        envs.update(ps.worker_envs())
    fun_submit(n_workers, n_servers, envs)
    if join and rabit is not None:
        rabit.join()
    if join and ps is not None:
        ps.join()  # raises if the scheduler died — sge has no _await_job
    # PS path returns the PSTracker so callers (_await_job) can watch the
    # scheduler's liveness/error the same way they watch the rabit tracker
    return rabit if rabit is not None else ps


def _default_host_ip() -> str:
    """Best-effort local IP (no egress needed: UDP connect is routing-only)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.settimeout(5.0)
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"
