"""Worker-side rendezvous client + host-side tree collectives (the port
of ``dmlc_tpu/tracker/client.py``: same handshake, frames, fold order
and algorithm choice, so port and JAX clients can share one gang and
get bitwise-equal results).

The reference keeps the worker half of the tracker protocol downstream
(in rabit); shipping it here makes the rendezvous testable in-repo and
gives workers a host-side allreduce (tree, chunked ring, and the
hierarchical shm+ring path over ``native/shm_collective``).

The collectives take host arrays (numpy, or anything ``np.asarray``
reads without a device copy, such as a CPU tensor).  A tensor on the
card is refused with a ``TypeError``: the device-to-host copy is the
caller's to make, once and explicitly (``t.cpu().numpy()``), or the
``parallel.overlap.GradientBucketer``'s, which stages CUDA leaves
through pinned host buckets.

Peer links established through tracker brokering are real TCP
connections; peers identify themselves with (MAGIC, rank) frames after
connect.

Elasticity: against an elastic tracker (``DMLC_ELASTIC=1``) the world
size is a run-time variable.  Every host-collective array frame carries
the world *generation* id, so traffic from a stale generation is
rejected instead of folded into the reduction; a collective interrupted
by a peer loss (or by a tracker-announced generation change, delivered
as a piggyback on the heartbeat reply) raises the retryable
:class:`WorldResized` instead of hanging — bounded by the
``DMLC_CLIENT_*`` socket timeouts — and :meth:`TrackerClient.resize`
re-enters rendezvous to learn the new rank/world and rebuild the
overlay.  Against a non-elastic tracker nothing changes: peer loss
stays an ``OSError`` and ``recover()`` keeps the same-rank semantics.
"""

from __future__ import annotations

import json
import logging
import select
import socket
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..base import DMLCError, check, get_env
from ..resilience import RetryPolicy, fault_point
from .protocol import MAGIC, FrameSocket, recover_cmd

__all__ = ["TrackerClient", "WorldResized"]

logger = logging.getLogger("dmlc_tpu_torch.tracker")


class WorldResized(DMLCError):
    """The elastic world changed under a collective: a peer was lost, a
    stale-generation frame arrived, or the tracker announced a new
    generation.  Retryable — the raising client has already torn down
    its peer links (waking peers blocked on them, so the whole gang
    cascades out of the dead collective); call
    :meth:`TrackerClient.resize` to re-enter rendezvous, learn the new
    rank/world, restore state from the last checkpoint, and retry."""

    def __init__(self, msg: str, gen: int = -1):
        super().__init__(msg)
        self.gen = gen


def _host_only(arr, what: str) -> None:
    """Refuse a tensor that does not live on the host (see the module
    docstring): no collective copies a device tensor behind its
    caller's back."""
    if isinstance(arr, torch.Tensor) and arr.device.type != "cpu":
        raise TypeError(
            f"{what} takes host arrays; got a tensor on {arr.device}: "
            "copy it to the host first (t.cpu().numpy()) or reduce it "
            "through parallel.overlap.GradientBucketer")


def _coll_algo_env() -> str:
    """Default allreduce algorithm (``DMLC_COLL_ALGO``):

    * ``auto`` (default) — the hierarchical shm+ring path (C shm
      collective per host + chunked ring across host leaders) from
      DMLC_COLL_HIER_MIN_BYTES (64 KB) up when it can be set up, the
      flat chunked ring from DMLC_COLL_RING_MIN_BYTES (1 MB) when it
      cannot, the binomial tree below both cutovers.
    * ``tree`` / ``ring`` / ``hier`` — pin the algorithm (``hier``
      still degrades to ``ring`` when no shm segment can be mapped,
      with a one-time warning, so a heterogeneous fleet never hangs).
    """
    algo = get_env("DMLC_COLL_ALGO", "auto").strip().lower()
    if algo not in ("auto", "tree", "ring", "hier"):
        raise ValueError(f"DMLC_COLL_ALGO={algo!r} not in "
                         "tree|ring|hier|auto")
    return algo


class _HierState:
    """Per-generation hierarchical-collective state: host groups, this
    rank's shm group handle, and the leader sub-ring."""

    __slots__ = ("gen", "ok", "shm", "group", "local_rank", "leader",
                 "leaders", "leader_idx", "n_groups", "warned")

    def __init__(self, gen: int):
        self.gen = gen
        self.ok = False
        self.shm = None           # native.shm_collective.ShmCollective
        self.group = []           # my host group's ranks, sorted
        self.local_rank = 0
        self.leader = -1          # my group's leader (min rank)
        self.leaders = []         # every group's leader, group order
        self.leader_idx = 0
        self.n_groups = 0
        self.warned = False


def _hier_min_bytes() -> int:
    """Payload size at which ``auto`` prefers the hierarchical shm+ring
    path (DMLC_COLL_HIER_MIN_BYTES, default 64 KB — bench_collective's
    cutover sweep shows the shm leg already beating both tree and flat
    ring there; below it the tree's 2·log2(n) latency wins).  Negative
    disables hier in auto mode."""
    return get_env("DMLC_COLL_HIER_MIN_BYTES", 64 << 10)


def _ring_min_bytes() -> int:
    """Payload size at which allreduce cuts over from the binomial tree
    to the chunked ring (DMLC_COLL_RING_MIN_BYTES, default 1 MB; 0
    forces the ring whenever links exist, negative disables it).

    The tree finishes in 2·log2(n) hops but moves the FULL payload
    through every tree level — its per-link traffic does not shrink
    with n.  The ring pays 2·(n-1) latency rounds but each rank only
    ever sends 2·(n-1)/n of the payload, all links busy at once, so it
    wins as soon as bandwidth dominates latency.  Small control-plane
    messages stay on the tree."""
    return get_env("DMLC_COLL_RING_MIN_BYTES", 1 << 20)


_RING_PIECE = 1 << 20  # sub-chunk granularity for the duplex transfer


def _connect_timeout() -> Optional[float]:
    """Per-dial connect timeout (DMLC_CLIENT_CONNECT_TIMEOUT_S, default
    15; 0 disables).  Bounds how long one attempt can hang on a dead
    tracker or peer before the reconnect backoff takes over."""
    t = get_env("DMLC_CLIENT_CONNECT_TIMEOUT_S", 15.0)
    return t if t > 0 else None


def _op_timeout() -> Optional[float]:
    """Per-socket operation timeout (DMLC_CLIENT_OP_TIMEOUT_S, default
    300 — the DMLC_TRACKER_TIMEOUT / shm-collective companion; 0
    disables).  A tracker or peer that dies without a FIN raises
    ``socket.timeout`` (an OSError, so the recover path catches it)
    instead of blocking a recv forever."""
    t = get_env("DMLC_CLIENT_OP_TIMEOUT_S", 300.0)
    return t if t > 0 else None


def _resize_timeout() -> float:
    """Upper bound on one resize() re-rendezvous, settle-wait included
    (DMLC_ELASTIC_RESIZE_TIMEOUT_S, default 120)."""
    return get_env("DMLC_ELASTIC_RESIZE_TIMEOUT_S", 120.0)


def _dial_policy() -> RetryPolicy:
    """Reconnect-with-backoff for tracker dials (DMLC_CLIENT_RETRIES,
    default 5): rides out a tracker restart / slow bind instead of
    failing the worker on the first refused connection."""
    return RetryPolicy.from_env(retries_env="DMLC_CLIENT_RETRIES",
                                default_attempts=5,
                                base_env="DMLC_CLIENT_RETRY_BASE_S",
                                default_base=0.3, name="tracker_dial")


class TrackerClient:
    """One worker's connection to the tracker and its peer overlay."""

    def __init__(self, tracker_uri: Optional[str] = None,
                 tracker_port: Optional[int] = None,
                 jobid: Optional[str] = None):
        self.tracker_uri = tracker_uri or get_env(
            "DMLC_TRACKER_URI", "127.0.0.1")
        self.tracker_port = int(
            tracker_port or get_env("DMLC_TRACKER_PORT", "9091"))
        self.jobid = jobid or get_env("DMLC_TASK_ID", "NULL")
        self.rank = -1
        self.world_size = -1
        self.parent = -1
        self.tree_nbrs = []
        self.ring_prev = -1
        self.ring_next = -1
        self.links: Dict[int, FrameSocket] = {}
        self._listener: Optional[socket.socket] = None
        # elastic state: generation of the topology this client holds,
        # and whether the tracker runs elastic at all (learned from the
        # `gen` query after every rendezvous).  _resize_pending is set by
        # the heartbeat thread (gen piggyback on the metrics reply) and
        # consumed on the worker thread at the next collective entry —
        # a plain bool flag, single-writer/single-reader.
        self.gen = 0
        self.elastic = False
        self._resize_pending = False
        self._hier: Optional[_HierState] = None

    # ---- tracker session helpers ---------------------------------------
    def _dial(self) -> FrameSocket:
        """Connect to the tracker with timeouts + backoff: a dead or
        restarting tracker yields a prompt, classified failure (after
        DMLC_CLIENT_RETRIES attempts) instead of an indefinite hang."""

        def attempt() -> FrameSocket:
            fault_point("tracker.dial", host=self.tracker_uri)
            s = socket.create_connection(
                (self.tracker_uri, self.tracker_port),
                timeout=_connect_timeout())
            s.settimeout(_op_timeout())
            fs = FrameSocket(s)
            try:
                fs.send_int(MAGIC)
                if fs.recv_int() != MAGIC:
                    raise ConnectionError("tracker answered bad magic")
            except BaseException:
                fs.close()
                raise
            return fs

        return _dial_policy().call(attempt)

    def _session(self, cmd: str, rank: int, world: int) -> FrameSocket:
        fs = self._dial()
        fs.send_int(rank)
        fs.send_int(world)
        fs.send_str(self.jobid)
        fs.send_str(cmd)
        return fs

    # ---- rendezvous ----------------------------------------------------
    def start(self, world_size: int = -1, cmd: str = "start") -> "TrackerClient":
        """Rendezvous: obtain rank + topology, establish peer links."""
        if self._listener is not None:  # recover: drop the old accept port
            self._listener.close()
        self._listener = socket.socket()
        self._listener.bind(("0.0.0.0", 0))
        self._listener.listen(16)
        # a gang-mate dying before it dials us must not park accept()
        # forever: surface as socket.timeout -> OSError -> recover path
        self._listener.settimeout(_op_timeout())
        my_port = self._listener.getsockname()[1]

        fs = self._session(cmd, self.rank, world_size)
        self.rank = fs.recv_int()
        self.parent = fs.recv_int()
        self.world_size = fs.recv_int()
        n_nbrs = fs.recv_int()
        self.tree_nbrs = [fs.recv_int() for _ in range(n_nbrs)]
        self.ring_prev = fs.recv_int()
        self.ring_next = fs.recv_int()

        # brokering dance: report already-good links, connect to assigned
        # peers, then report our accept port.  A failed peer dial (the
        # peer died, or the tracker handed out a stale endpoint before
        # its failure detector caught the death) is REPORTED as a dial
        # error — the tracker restarts the round — instead of crashing
        # this worker; rounds are bounded so a permanently-dead peer
        # still surfaces as an error rather than a livelock.
        policy = _dial_policy()
        round_no = 0
        while True:
            good = sorted(self.links.keys())
            fs.send_int(len(good))
            for r in good:
                fs.send_int(r)
            n_conn = fs.recv_int()
            n_accept = fs.recv_int()
            n_errors = 0
            for _ in range(n_conn):
                host = fs.recv_str()
                port = fs.recv_int()
                peer_rank = fs.recv_int()
                try:
                    self.links[peer_rank] = self._dial_peer(host, port,
                                                            peer_rank)
                except OSError:
                    n_errors += 1
            fs.send_int(n_errors)
            if n_errors == 0:
                break
            round_no += 1
            if round_no >= policy.attempts:
                fs.close()
                raise ConnectionError(
                    f"rank {self.rank}: peer dials kept failing after "
                    f"{round_no} brokering rounds")
            policy.sleep_for(round_no - 1)  # let dead peers get culled
        fs.send_int(my_port)
        fs.close()

        for _ in range(n_accept):
            conn, _ = self._listener.accept()
            conn.settimeout(_op_timeout())
            ps = FrameSocket(conn)
            assert ps.recv_int() == MAGIC
            peer_rank = ps.recv_int()
            ps.send_int(MAGIC)
            ps.send_int(self.rank)
            self.links[peer_rank] = ps
        # learn the world generation this topology belongs to (and
        # whether the tracker is elastic at all) — a separate short
        # session so the topology wire format stays C-ABI compatible
        info = self._query_gen()
        self.gen = int(info.get("gen", 0))
        self.elastic = bool(info.get("elastic", False))
        self._resize_pending = False
        return self

    def _dial_peer(self, host: str, port: int, peer_rank: int,
                   handshake_timeout: Optional[float] = None) -> FrameSocket:
        """One peer link: connect + (MAGIC, rank) identification.
        ``handshake_timeout`` bounds the identification exchange (the
        hier leader dance uses a short one so a peer that bailed on
        setup cannot stall the gang); the socket reverts to the normal
        op timeout once the link is up."""
        s = socket.create_connection((host, port),
                                     timeout=_connect_timeout())
        s.settimeout(handshake_timeout or _op_timeout())
        ps = FrameSocket(s)
        try:
            ps.send_int(MAGIC)
            ps.send_int(self.rank)
            if ps.recv_int() != MAGIC:
                raise ConnectionError(f"peer {peer_rank} at {host}:{port} "
                                      f"answered bad magic")
            got = ps.recv_int()
            if got != peer_rank:
                raise ConnectionError(f"dialed {host}:{port} expecting "
                                      f"rank {peer_rank}, got {got}")
        except BaseException:
            ps.close()
            raise
        if handshake_timeout is not None:
            s.settimeout(_op_timeout())
        return ps

    def recover(self) -> "TrackerClient":
        """Reconnect after restart keeping our rank (tracker 'recover')."""
        assert self.rank >= 0
        self._links_down()
        return self.start(cmd="recover")

    # ---- elastic world resize ------------------------------------------
    def _links_down(self) -> None:
        """Close every peer link.  Beyond local cleanup this is the
        resize *cascade*: a peer blocked mid-collective on one of these
        sockets wakes with a ConnectionError, raises its own
        WorldResized, closes ITS links — so one lost rank propagates to
        the whole gang without any tracker push channel."""
        for fs in self.links.values():
            fs.close()
        self.links = {}
        # the shm half of the cascade: same-host peers blocked inside a
        # hier shm phase see no socket die, so poison the group too
        self._hier_teardown()

    def _resized(self, why: str, cause: Optional[BaseException] = None):
        from .. import telemetry

        self._links_down()
        telemetry.record_event("world_resized_signal", rank=self.rank,
                               gen=self.gen, why=why)
        err = WorldResized(
            f"rank {self.rank} (gen {self.gen}): {why}; call resize() to "
            f"re-enter rendezvous", gen=self.gen)
        if cause is not None:
            raise err from cause
        raise err

    @property
    def resize_pending(self) -> bool:
        """True once the tracker has announced a newer generation (via
        the heartbeat reply) than the topology this client holds."""
        return self._resize_pending

    def check_resized(self) -> None:
        """Raise :class:`WorldResized` if the tracker announced a new
        generation since the last rendezvous — the cheap per-step check
        for loops that do not touch a host collective every step."""
        if self.elastic and self._resize_pending:
            self._resized("world generation advanced (tracker heartbeat)")

    def _query_gen(self) -> dict:
        """Short ``gen`` session: the tracker's current generation,
        world size, elastic flag and dead-rank count."""
        fs = self._session("gen", self.rank, -1)
        try:
            return json.loads(fs.recv_str())
        finally:
            fs.close()

    def _await_settle(self, old_gen: int, deadline: float) -> int:
        """Wait for the membership change behind a WorldResized to
        settle before re-entering rendezvous: either the tracker opened
        a new generation (gen advances — shrink past grace, or a
        scale-up), or the lost rank was re-admitted at its old rank
        within the grace window (dead count returns to zero — the
        supervised-restart path, same generation).  Re-entering blind
        would park this worker in a brokering round that waits on a
        peer the tracker has not yet culled."""
        seen_dead = False
        poll = 0.05
        while True:
            try:
                info = self._query_gen()
            except (OSError, ValueError):
                info = None  # tracker mid-restart: keep polling
            if info is not None:
                gen = int(info.get("gen", 0))
                if gen > old_gen:
                    return gen
                if int(info.get("dead", 0)) > 0:
                    seen_dead = True
                elif seen_dead:
                    return gen  # same-gen readmission completed
            if time.monotonic() > deadline:
                logger.warning(
                    "rank %d: resize settle-wait timed out (gen still "
                    "%d); attempting a same-generation recover", self.rank,
                    old_gen)
                return old_gen
            time.sleep(poll)
            poll = min(poll * 1.5, 0.5)

    def resize(self, timeout_s: Optional[float] = None) -> "TrackerClient":
        """Re-enter rendezvous after :class:`WorldResized`.

        Waits for the tracker's membership change to settle, then
        announces ``recover@<old-gen>`` — the tracker translates the
        stale rank through its generation maps into this worker's rank
        in the new dense ``[0, N')`` space (or admits it as a scale-up
        join if it was evicted while away) and re-brokers the overlay.
        On return ``rank``/``world_size``/``gen`` describe the new
        world; the caller owns restoring training state (checkpoint
        restore onto the new mesh) and repartitioning data
        (``DeviceFeed.resize``).  Bounded by ``timeout_s`` (default
        ``DMLC_ELASTIC_RESIZE_TIMEOUT_S``)."""
        from .. import telemetry

        check(self.rank >= 0, "resize() before a successful rendezvous")
        t = _resize_timeout() if timeout_s is None else float(timeout_s)
        deadline = time.monotonic() + t
        rank0, gen0 = self.rank, self.gen
        self._links_down()
        self._resize_pending = False
        last: Optional[BaseException] = None
        while True:
            settled = self._await_settle(gen0, deadline)
            cmd = recover_cmd(gen0) if settled > gen0 else "recover"
            self.rank = rank0  # announce in terms of the OLD identity
            try:
                self.start(cmd=cmd)
            except (OSError, ConnectionError) as e:
                # a racing second resize (another death mid-recovery)
                # can break this rendezvous; retry against the newest
                # generation until the deadline
                last = e
                self._links_down()
                if time.monotonic() > deadline:
                    raise DMLCError(
                        f"rank {rank0}: resize did not complete within "
                        f"{t:.0f}s: {last}") from last
                time.sleep(0.2)
                continue
            telemetry.inc("elastic", "client_resizes")
            telemetry.record_event(
                "client_resized", old_rank=rank0, rank=self.rank,
                old_gen=gen0, gen=self.gen, world=self.world_size)
            logger.info(
                "rank %d (gen %d) resized -> rank %d/%d (gen %d)",
                rank0, gen0, self.rank, self.world_size, self.gen)
            return self

    # ---- tracker utility commands --------------------------------------
    def log(self, msg: str) -> None:
        fs = self._session("print", self.rank, -1)
        fs.send_str(msg)
        fs.close()

    def send_metrics(self, payload: str) -> None:
        """Push a telemetry heartbeat (JSON snapshot) to the tracker's
        aggregator over a short ``metrics`` session — same session shape
        as the ``print`` relay.  See telemetry.heartbeat.HeartbeatSender
        for the periodic-push wrapper.

        The tracker's reply carries its current world generation: the
        heartbeat doubles as the scale-up push channel — when the
        generation advances with no link dying (a grow resize), this is
        how a survivor learns it must re-enter rendezvous."""
        fs = self._session("metrics", self.rank, -1)
        try:
            fs.send_str(payload)
            gen = fs.recv_int()
        finally:
            fs.close()
        if self.elastic and gen > self.gen:
            self._resize_pending = True

    def clock_ping(self) -> tuple:
        """One NTP-style clock exchange with the tracker: returns
        ``(offset_s, rtt_s)`` where ``tracker_time = local_time +
        offset_s``.  The tracker stamps receipt/reply times in its
        accept loop (``clock`` session); the sample ships with the next
        telemetry heartbeat so the tracker can place this rank's spans
        on the cluster timeline (telemetry.clock / telemetry.flight)."""
        from ..telemetry.clock import offset_from_timestamps

        # connect + handshake happen BEFORE t0 is stamped: the dial can
        # pay reconnect backoff and 4 handshake frames, and folding that
        # into the forward path would bias every offset sample positive
        # by ~half the setup cost (the tracker stamps t1 only when the
        # payload frame lands).  t0..t3 must bracket ONLY the ping
        # round-trip itself.
        fs = self._session("clock", self.rank, -1)
        try:
            t0 = time.time()
            fs.send_str(json.dumps({"t0": t0}))
            reply_raw = fs.recv_str()
            t3 = time.time()
        finally:
            fs.close()
        reply = json.loads(reply_raw)
        return offset_from_timestamps(
            t0, float(reply["t1"]), float(reply["t2"]), t3)

    def shutdown(self) -> None:
        # elastic: stamp the generation our rank belongs to — a resize
        # we never re-brokered into may have renumbered it, and the
        # tracker must mark the right completion slot (or ignore us if
        # we were evicted while finishing)
        cmd = f"shutdown@{self.gen}" if self.elastic else "shutdown"
        fs = self._session(cmd, self.rank, -1)
        fs.close()
        for ps in self.links.values():
            ps.close()
        self.links = {}
        self._hier_teardown()
        if self._listener is not None:
            self._listener.close()

    # ---- host-side tree collectives ------------------------------------
    def _send_array(self, fs: FrameSocket, arr: np.ndarray) -> None:
        # every array frame is generation-stamped: (gen, nbytes, data).
        # Python-to-Python only — the C-ABI workers run their own
        # collective framing over their own links, never these.
        data = arr.tobytes()
        fs.send_int(self.gen)
        fs.send_int(len(data))
        fs.sock.sendall(data)

    def _recv_array(self, fs: FrameSocket, like: np.ndarray) -> np.ndarray:
        g = fs.recv_int()
        if g != self.gen:
            # a stale (or future) generation's traffic must never be
            # folded into this reduction — reject the frame and force
            # both sides back through rendezvous
            self._resized(f"stale-generation frame (peer gen {g}, "
                          f"ours {self.gen})")
        n = fs.recv_int()
        return np.frombuffer(fs.recv_all(n), dtype=like.dtype).reshape(like.shape)

    def allreduce(self, arr: np.ndarray, op: str = "sum",
                  algo: Optional[str] = None,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        """Host-side allreduce, op ∈ {sum, max, min}.

        Small payloads ride the binomial tree (reduce to root, broadcast
        back — 2·log2(n) hops); payloads at or above
        DMLC_COLL_RING_MIN_BYTES cut over to a bandwidth-optimal
        algorithm: the hierarchical ``hier`` path (reduce-scatter inside
        each host through the C shm collective, the chunked ring across
        host LEADERS only, broadcast back intra-host — so only one rank
        per host pays the network) when its setup succeeds, else the
        flat chunked ring over the tracker-brokered
        ``ring_prev``/``ring_next`` links.  ``algo`` ∈ {None, "tree",
        "ring", "hier"} pins the choice (None defers to
        ``DMLC_COLL_ALGO``, default ``auto``); the benchmark reports all
        three side by side.

        Inputs of any shape/contiguity are accepted: the payload is
        flattened to one contiguous 1-D view up front (copying at most
        once) and the result is reshaped back, so >1-D, 0-d and sliced
        arrays all reduce correctly.

        ``out`` (optional) is a preallocated C-contiguous result buffer
        of the same dtype and element count — pass the INPUT itself for
        a true in-place reduction.  This is the steady-state hot path:
        a fresh 64 MB result allocation costs more in page faults than
        the entire shm reduce-scatter on an oversubscribed host, and a
        training loop reducing gradients every step should pay it never
        rather than every step.

        Fully instrumented: a ``collective.allreduce`` span (op/byte/rank
        /algo tags) plus a ``barrier_enter`` event — on the tracker's
        corrected /trace timeline these spans line up across ranks, so
        the rank whose span STARTS last is the straggler by direct
        reading, and the ``barrier_wait_secs`` histogram (time blocked on
        the reduce wave) quantifies how long everyone else paid for it."""
        from .. import telemetry

        if algo not in (None, "tree", "ring", "hier"):
            raise ValueError(f"unknown allreduce algo {algo!r} "
                             "(expected None, 'tree', 'ring' or 'hier')")
        _host_only(arr, "allreduce")
        _host_only(out, "allreduce out=")
        # flatten ONCE up front: a non-C-contiguous or >1-D input is
        # copied exactly here, and every algorithm below (the ring's
        # uint8 reinterpret, the shm path's raw pointer) sees the same
        # flat contiguous 1-D buffer.  0-d inputs become shape (1,).
        orig_shape = np.shape(arr)  # before ascontiguousarray: numpy 2
        arr = np.ascontiguousarray(arr)  # promotes 0-d to (1,)
        flat = arr.reshape(-1)
        if out is None:
            work = None  # lazily copied below (after the world-1 exit)
        else:
            if (not out.flags.c_contiguous or out.dtype != flat.dtype
                    or out.size != flat.size):
                raise ValueError(
                    "allreduce out= must be C-contiguous with the "
                    "input's dtype and element count")
            work = out.reshape(-1)
            if not np.shares_memory(work, flat):
                np.copyto(work, flat)
        if self.world_size <= 1:
            if work is None:
                return flat.copy().reshape(orig_shape)
            return work.reshape(orig_shape)
        if work is None:
            work = flat.copy()
        if algo is None:
            # NB: the cutover must be gang-uniform — every rank has to
            # pick the same algorithm for the same collective or the
            # byte streams desynchronize (the launcher propagates one
            # env to all workers, so the DMLC_COLL_* knobs are uniform
            # unless an operator splits them on purpose).  Selection is
            # therefore a pure function of (env, payload size/dtype); a
            # rank whose ring links are missing fails loudly below
            # instead of silently diverging onto the tree.  The hier
            # path's availability is itself made gang-uniform by the
            # MIN-veto inside _hier_state().
            algo = _coll_algo_env()
            if algo == "auto":
                min_bytes = _ring_min_bytes()
                hier_min = _hier_min_bytes()
                if (hier_min >= 0 and flat.nbytes >= hier_min
                        and self._hier_wanted(flat.dtype)):
                    algo = "hier"
                elif min_bytes >= 0 and flat.nbytes >= min_bytes:
                    algo = "ring"
                else:
                    algo = "tree"
        if algo == "hier":
            try:
                hier_ok = self._hier_ready(flat.dtype)
            except OSError as e:
                # the setup's gang-wide veto is itself a tree collective;
                # a peer preempted during it must surface as the same
                # retryable signal as one lost mid-fold below
                if self.elastic:
                    self._resized(f"peer lost during hier setup: {e}",
                                  cause=e)
                raise
            if not hier_ok:
                # uniform degrade (veto'd setup / bad dtype): to the
                # ring where bandwidth dominates, the tree below its
                # cutover
                min_bytes = _ring_min_bytes()
                algo = ("ring" if min_bytes >= 0
                        and flat.nbytes >= min_bytes else "tree")
        if algo == "ring" and (self.ring_prev not in self.links
                               or self.ring_next not in self.links):
            raise ConnectionError(
                f"rank {self.rank}: ring allreduce selected but ring "
                f"links ({self.ring_prev}, {self.ring_next}) are not "
                "established — topology bug or partial recovery")
        self.check_resized()
        telemetry.record_event("barrier_enter", site="allreduce", op=op,
                               rank=self.rank, bytes=int(flat.nbytes))
        with telemetry.span("collective.allreduce", stage="collective",
                            args={"op": op, "bytes": int(flat.nbytes),
                                  "rank": self.rank, "algo": algo}):
            try:
                if algo == "hier":
                    self._hier_allreduce(work, op)
                elif algo == "ring":
                    self._ring_allreduce(work, op)
                else:
                    self._tree_allreduce(work, op)
                return work.reshape(orig_shape)
            except OSError as e:
                if self.elastic:
                    # peer lost mid-fold (preemption): retryable resize
                    # signal instead of a crash; closing our links below
                    # cascades the wake-up to peers blocked on us
                    self._resized(f"peer lost mid-allreduce: {e}", cause=e)
                raise

    def _tree_allreduce(self, acc: np.ndarray, op: str) -> np.ndarray:
        """Binomial tree, IN PLACE on ``acc`` (the caller owns the
        buffer: ``allreduce`` hands a private copy, or the caller's own
        array via ``out=``)."""
        from .. import telemetry

        fold = {"sum": np.add, "max": np.maximum, "min": np.minimum}[op]
        children = [r for r in self.tree_nbrs if r != self.parent]
        t0 = time.perf_counter()
        for c in children:
            fold(acc, self._recv_array(self.links[c], acc), out=acc)
        if self.parent >= 0:
            self._send_array(self.links[self.parent], acc)
            np.copyto(acc, self._recv_array(self.links[self.parent], acc))
        # the reduce wave completes here: everything this rank spent
        # blocked on slower subtree/parent progress is barrier wait
        telemetry.observe_duration("collective", "barrier_wait",
                                   time.perf_counter() - t0)
        for c in children:
            self._send_array(self.links[c], acc)
        return acc

    def _ring_duplex(self, snd: socket.socket, rcv: socket.socket,
                     send_mv: memoryview, recv_mv: memoryview):
        """Push ``send_mv`` to ``snd`` while pulling ``recv_mv`` from
        ``rcv``, progressing whichever direction is ready — full-duplex
        on blocking sockets without helper threads, and deadlock-free
        when the chunk exceeds the socket buffers (every rank sends and
        receives simultaneously).  The two links are the same socket at
        ring size == 2."""
        # Non-blocking for the duplex, whatever the op-timeout setting:
        # with DMLC_CLIENT_OP_TIMEOUT_S=0 the sockets are fully blocking
        # and send() of a piece larger than the free socket buffer would
        # park until the PEER drains — but every rank is in the same
        # loop, so nobody would ever reach its recv and the whole ring
        # would deadlock.  Non-blocking send() enqueues what fits and
        # returns; progress then strictly follows select() readiness.
        prev_timeouts = (snd.gettimeout(), rcv.gettimeout())
        snd.setblocking(False)
        rcv.setblocking(False)
        ns, ng = len(send_mv), len(recv_mv)
        sent, got = 0, 0
        try:
            while sent < ns or got < ng:
                rs, ws, _ = select.select(
                    [rcv] if got < ng else [],
                    [snd] if sent < ns else [], [],
                    _op_timeout() or None)
                if not rs and not ws:
                    raise socket.timeout("ring allreduce stalled")
                if rs:
                    try:
                        k = rcv.recv_into(recv_mv[got:got + _RING_PIECE])
                    except BlockingIOError:
                        k = None  # spurious readiness; retry via select
                    if k == 0:
                        raise ConnectionError(
                            "ring peer closed mid-collective")
                    if k:
                        got += k
                if ws:
                    try:
                        sent += snd.send(send_mv[sent:sent + _RING_PIECE])
                    except BlockingIOError:
                        pass
        finally:
            snd.settimeout(prev_timeouts[0])
            rcv.settimeout(prev_timeouts[1])

    def _ring_allreduce(self, out: np.ndarray, op: str) -> np.ndarray:
        """Chunked ring over the whole world (the tracker-brokered
        ``ring_prev``/``ring_next`` links), IN PLACE on ``out``."""
        self._ring_pass(out, op, self.ring_prev, self.ring_next,
                        self.world_size, self.rank)
        return out

    def _ring_pass(self, out: np.ndarray, op: str, prev_rank: int,
                   next_rank: int, n: int, idx: int) -> None:
        """In-place chunked ring allreduce over an arbitrary sub-ring:
        n-1 reduce-scatter steps (each member ends up owning the full
        reduction of one payload slice) followed by n-1 allgather steps
        circulating the reduced slices.  The flat world ring
        (``idx``/``n`` = rank/world) and the hier leader ring
        (``idx``/``n`` = leader index/host count) share this code; the
        links must already exist in ``self.links``."""
        from .. import telemetry

        if n <= 1:
            return
        fold = {"sum": np.add, "max": np.maximum, "min": np.minimum}[op]
        nxt, prv = self.links[next_rank], self.links[prev_rank]
        # the ring's bulk transfers are raw (headerless) byte streams,
        # so the generation check happens ONCE up front: exchange gen
        # ids around the ring (a 2-member ring collapses both
        # directions onto one socket, which still works)
        nxt.send_int(self.gen)
        peer_gen = prv.recv_int()
        if peer_gen != self.gen:
            self._resized(f"stale-generation ring peer (gen {peer_gen}, "
                          f"ours {self.gen})")
        flat = out.view(np.uint8).reshape(-1)
        item = out.itemsize
        per = ((out.size + n - 1) // n) * item
        bounds = [min(i * per, flat.size) for i in range(n + 1)]
        scratch = np.empty(per, np.uint8)
        t0 = time.perf_counter()
        for s in range(n - 1):  # reduce-scatter
            si, ri = (idx - s) % n, (idx - s - 1) % n
            slo, shi = bounds[si], bounds[si + 1]
            rlo, rhi = bounds[ri], bounds[ri + 1]
            self._ring_duplex(nxt.sock, prv.sock,
                              memoryview(flat[slo:shi]),
                              memoryview(scratch[: rhi - rlo]))
            if rhi > rlo:
                dst = flat[rlo:rhi].view(out.dtype)
                fold(dst, scratch[: rhi - rlo].view(out.dtype), out=dst)
        # every member now owns the reduced slice (idx+1) % n; the
        # reduce wave completes here (straggler wait, as in the tree)
        telemetry.observe_duration("collective", "barrier_wait",
                                   time.perf_counter() - t0)
        for s in range(n - 1):  # allgather
            si, ri = (idx + 1 - s) % n, (idx - s) % n
            slo, shi = bounds[si], bounds[si + 1]
            rlo, rhi = bounds[ri], bounds[ri + 1]
            self._ring_duplex(nxt.sock, prv.sock,
                              memoryview(flat[slo:shi]),
                              memoryview(flat[rlo:rhi]))

    # ---- hierarchical allreduce (shm intra-host + ring across hosts) ----
    def _hier_wanted(self, dtype) -> bool:
        """Cheap gang-uniform pre-checks for the auto selector: dtype
        foldable by the shm collective and shm not env-disabled.  Library
        availability is deliberately NOT checked here (it can differ per
        host); _hier_state()'s MIN-veto makes the real verdict uniform."""
        from ..native import shm_collective as shmc

        return shmc.supports_dtype(dtype) and get_env("DMLC_COLL_SHM", 1) != 0

    def _hier_ready(self, dtype) -> bool:
        """True when the hier path can run this payload: dtype is
        shm-foldable and the per-generation setup (collective on first
        use) survived the gang-wide veto."""
        from ..native import shm_collective as shmc

        if not shmc.supports_dtype(dtype):
            return False
        return self._hier_state().ok

    def _hier_state(self) -> _HierState:
        """The per-generation hier state, set up collectively on first
        use.  EVERY rank must reach this from the same collective call
        (selection is a pure function of uniform env + payload), because
        setup ends in a MIN-allreduce veto over the tree: one rank that
        failed to map its segment or dial a leader flips the whole gang
        to the flat ring instead of leaving it split across algorithms."""
        st = self._hier
        if st is not None and st.gen == self.gen:
            return st
        self._hier_teardown()
        st = self._hier_setup()
        self._hier = st
        return st

    def _hier_teardown(self) -> None:
        st, self._hier = self._hier, None
        if st is not None and st.shm is not None:
            # abort BEFORE unmap: peers blocked in an shm phase wake
            # with an error instead of spinning out the timeout
            st.shm.abort()
            st.shm.close()
            st.shm = None

    def _query_hostmap(self) -> dict:
        """Short ``hosts`` session: the tracker's rank → (host, port)
        job map for the current generation."""
        fs = self._session("hosts", self.rank, -1)
        try:
            return json.loads(fs.recv_str())
        finally:
            fs.close()

    def _host_groups(self):
        """(groups, hostports): ranks grouped by host (auto, from the
        tracker's job map) or by rank blocks of ``DMLC_COLL_HIER_GROUPS``
        (an explicit topology override, also how CI exercises the
        leader ring on one box).  Polls the tracker until the map covers
        the whole world — a worker still mid-brokering has no accept
        port yet."""
        deadline = time.monotonic() + get_env(
            "DMLC_COLL_HIER_SETUP_TIMEOUT_S", 20.0)
        hostports: Dict[int, tuple] = {}
        while True:
            doc = self._query_hostmap()
            if int(doc.get("gen", 0)) != self.gen:
                raise ValueError("world generation changed during hier "
                                 "setup")
            hosts = doc.get("hosts", {})
            if len(hosts) >= self.world_size:
                hostports = {int(r): (h, int(p))
                             for r, (h, p) in hosts.items()}
                if all(r in hostports for r in range(self.world_size)):
                    break
            if time.monotonic() > deadline:
                raise ValueError(
                    f"tracker job map covers {len(hosts)}/"
                    f"{self.world_size} ranks (workers still brokering?)")
            time.sleep(0.2)
        block = get_env("DMLC_COLL_HIER_GROUPS", 0)
        if block > 0:
            groups = [list(range(i, min(i + block, self.world_size)))
                      for i in range(0, self.world_size, block)]
        else:
            by_host: Dict[str, list] = {}
            for r in range(self.world_size):
                by_host.setdefault(hostports[r][0], []).append(r)
            groups = sorted(by_host.values(), key=lambda g: g[0])
        return groups, hostports

    def _ensure_leader_links(self, need, hostports) -> None:
        """Direct leader-to-leader links for the inter-host ring.  The
        tracker-brokered overlay may already connect some leader pairs
        (tree/ring neighbours) — those sockets are reused; missing pairs
        are dialed directly with the standard (MAGIC, rank) peer
        identification, lower rank dialing higher (a DAG, so the dial/
        accept order can never cycle into a deadlock).  New links land
        in ``self.links`` so teardown and the WorldResized cascade cover
        them like any brokered link."""
        setup_t = get_env("DMLC_COLL_HIER_SETUP_TIMEOUT_S", 20.0)
        to_accept = set()
        for peer in sorted(need):
            if peer == self.rank or peer in self.links:
                continue
            if self.rank < peer:
                host, port = hostports[peer]
                self.links[peer] = self._dial_peer(host, port, peer,
                                                   handshake_timeout=setup_t)
            else:
                to_accept.add(peer)
        # bound the accept wait by the SETUP timeout, not the op
        # timeout: a remote leader that bailed on its own setup (shm
        # veto) never dials, and a 300 s stall here would wedge the
        # whole gang's veto allreduce behind this one rank
        prev_timeout = self._listener.gettimeout()
        if to_accept:
            self._listener.settimeout(setup_t)
        try:
            self._accept_leader_links(to_accept)
        finally:
            self._listener.settimeout(prev_timeout)

    def _accept_leader_links(self, to_accept) -> None:
        while to_accept:
            conn, _ = self._listener.accept()
            conn.settimeout(_op_timeout())
            ps = FrameSocket(conn)
            try:
                if ps.recv_int() != MAGIC:
                    raise ConnectionError("bad magic")
                peer = ps.recv_int()
                if peer not in to_accept:
                    raise ConnectionError(f"unexpected dialer rank {peer}")
                ps.send_int(MAGIC)
                ps.send_int(self.rank)
            except (OSError, ConnectionError):
                ps.close()
                continue  # stray/torn dial: keep waiting for real peers
            self.links[peer] = ps
            to_accept.discard(peer)

    def _hier_setup(self) -> _HierState:
        """Collective hier setup: host grouping from the tracker job
        map, one shm group per multi-rank host, leader-ring links —
        ending in the gang-wide MIN veto that keeps the algorithm
        choice uniform.  Never raises for setup-class failures (those
        veto); link-level OSErrors during the veto itself propagate
        like any collective error."""
        from ..native import shm_collective as shmc

        st = _HierState(self.gen)
        ok = True
        groups = []
        hostports: Dict[int, tuple] = {}
        try:
            groups, hostports = self._host_groups()
        except (OSError, ValueError, ConnectionError) as e:
            logger.warning("rank %d: hier host grouping failed: %s",
                           self.rank, e)
            ok = False
        if ok:
            st.group = next(g for g in groups if self.rank in g)
            st.leaders = [g[0] for g in groups]
            st.n_groups = len(groups)
            st.leader = st.group[0]
            st.local_rank = st.group.index(self.rank)
            st.leader_idx = st.leaders.index(st.leader)
            if all(len(g) == 1 for g in groups):
                ok = False  # no intra-host sharing: hier ≡ ring + overhead
        if ok and len(st.group) > 1:
            try:
                chunk_kb = get_env("DMLC_COLL_SHM_CHUNK_KB", 0)
                st.shm = shmc.ShmCollective(
                    f"dmlc-hier-{self.tracker_port}-{self.gen}-{st.leader}",
                    st.local_rank, len(st.group), chunk_kb=chunk_kb)
            except shmc.ShmGroupError as e:
                logger.warning("rank %d: hier shm group setup failed: %s",
                               self.rank, e)
                ok = False
        if ok and st.n_groups > 1 and self.rank == st.leader:
            try:
                prev = st.leaders[(st.leader_idx - 1) % st.n_groups]
                nxt = st.leaders[(st.leader_idx + 1) % st.n_groups]
                self._ensure_leader_links({prev, nxt}, hostports)
            except (OSError, ConnectionError) as e:
                logger.warning("rank %d: hier leader-link setup failed: "
                               "%s", self.rank, e)
                ok = False
        # gang-wide veto: every rank reaches this allreduce (setup-class
        # failures above only flip `ok`), so the verdict is uniform
        verdict = self._tree_allreduce(
            np.asarray([1 if ok else 0], np.int32), "min")
        st.ok = bool(int(verdict[0]))
        if not st.ok:
            if st.shm is not None:
                st.shm.close()
                st.shm = None
            if not st.warned:
                st.warned = True
                logger.info(
                    "rank %d: hierarchical allreduce unavailable this "
                    "generation; using the flat ring", self.rank)
        return st

    def _hier_allreduce(self, out: np.ndarray, op: str) -> np.ndarray:
        """Hierarchy, IN PLACE on ``out``: reduce-scatter + allgather
        inside the host over the C shm collective (= intra-host
        allreduce, one streaming fold per member), chunked TCP ring
        across host leaders only, then an intra-host shm broadcast of
        the global result — network traffic is one ring's worth per
        HOST instead of per rank."""
        from ..native.shm_collective import ShmGroupError

        st = self._hier
        try:
            if st.shm is not None:
                st.shm.reduce_scatter(out, op)
                st.shm.allgather(out)
            if st.n_groups > 1:
                if self.rank == st.leader:
                    prev = st.leaders[(st.leader_idx - 1) % st.n_groups]
                    nxt = st.leaders[(st.leader_idx + 1) % st.n_groups]
                    self._ring_pass(out, op, prev, nxt, st.n_groups,
                                    st.leader_idx)
                if st.shm is not None:
                    st.shm.broadcast(out, root=0)
        except ShmGroupError as e:
            if self.elastic:
                # a same-host peer bailed (resize cascade reached the
                # group, or it died and the wait timed out): retryable
                self._resized(f"shm group failed mid-allreduce: {e}",
                              cause=e)
            raise ConnectionError(str(e)) from e
        return out

    def allreduce_sum(self, arr: np.ndarray,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
        return self.allreduce(arr, "sum", out=out)

    def broadcast(self, arr: np.ndarray, root: int = 0) -> np.ndarray:
        """Tree broadcast from root (root's value wins everywhere).
        Instrumented like :meth:`allreduce` (span + barrier event)."""
        from .. import telemetry

        _host_only(arr, "broadcast")
        arr = np.ascontiguousarray(arr)
        if self.world_size <= 1:
            return arr.copy()
        assert root == 0, "tree broadcast is rooted at rank 0"
        self.check_resized()
        telemetry.record_event("barrier_enter", site="broadcast",
                               rank=self.rank, bytes=int(arr.nbytes))
        with telemetry.span("collective.broadcast", stage="collective",
                            args={"bytes": int(arr.nbytes),
                                  "rank": self.rank}):
            try:
                children = [r for r in self.tree_nbrs if r != self.parent]
                out = arr
                if self.parent >= 0:
                    t0 = time.perf_counter()
                    out = self._recv_array(self.links[self.parent], arr)
                    telemetry.observe_duration("collective", "barrier_wait",
                                               time.perf_counter() - t0)
                for c in children:
                    self._send_array(self.links[c], out)
            except OSError as e:
                if self.elastic:
                    self._resized(f"peer lost mid-broadcast: {e}", cause=e)
                raise
        return out.copy() if out is arr else out
