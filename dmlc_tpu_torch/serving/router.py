"""Fleet router: a health-checked front door over N engine replicas (the
port of ``dmlc_tpu/serving/router.py``, same behavior, names, knobs,
metric families, events and spans).

One ``InferenceEngine`` process is a single point of failure: the
process dies and every in-flight and queued generation dies with it.
The :class:`Router` makes a replica crash under live traffic
**invisible to clients**:

  * **registry + health**: replicas come from a static URL list or the
    tracker's job map (:func:`discover_replicas`).  A background
    thread polls each replica's ``/healthz`` (liveness + drain state +
    the request-ledger load summary); a failed poll or a failed
    dispatch marks the replica DOWN and opens its circuit — re-probes
    back off exponentially (``DMLC_ROUTER_PROBE_BASE_S`` →
    ``DMLC_ROUTER_PROBE_MAX_S``) so a dead host is not hammered, and
    one successful probe closes the circuit again.
  * **least-loaded routing**: dispatch picks the healthy replica with
    the smallest ``router-inflight + decode-queue-depth`` — the request
    ledger's load signal (``live_waiting`` / ``decode_queue_depth`` in
    the ``/requests`` summary, embedded in ``/healthz``).
  * **idempotent retry**: every routed request carries a
    ``request_id`` (client-supplied or minted here).  A dispatch that
    dies on the wire (connection reset, timeout, replica SIGKILL
    mid-decode) is re-dispatched to another healthy replica with the
    SAME id — the engine-side dedupe ring guarantees a retry can
    never double-generate on a replica that already saw the id, and
    recompute-resume makes the re-generation output-invisible.
    Connection-shaped failures mark the replica down and count
    ``dmlc_router_failovers_total``; a dispatch *timeout* retries
    WITHOUT opening the circuit (slow is not dead — liveness is the
    prober's verdict, under its own bounded timeout).
  * **hedging**: when a dispatch outlives
    ``DMLC_ROUTER_HEDGE_AFTER_P99_MULT`` × the router's observed p99
    latency (0 disables), a duplicate dispatch is launched on a
    different replica; the first completion wins and the loser is
    abandoned (its replica-side work is bounded and its result is
    discarded — the client sees exactly one response).
  * **drain awareness**: a replica whose ``/healthz`` shows
    ``draining`` (or that answers 503 "draining") stops receiving new
    work while it finishes its backlog — a SIGTERM'd replica sheds
    traffic onto the fleet with zero client-facing 503s.
  * **honest backpressure**: when every healthy replica answers 429,
    the router answers 429 with a Retry-After computed from the
    aggregate queue depth and the observed per-request service time,
    not a made-up constant.
  * **per-tenant fairness**: every request carries a tenant key
    (``"tenant"`` body field, default ``"default"``); a weighted
    token bucket per tenant (:class:`TenantGovernor`,
    ``DMLC_TENANT_RATE`` × per-tenant ``DMLC_TENANT_WEIGHTS``) gates
    admission BEFORE placement, so one hot tenant's burst absorbs its
    own 429s — with an honest per-tenant Retry-After (its bucket
    deficit over its own fill rate) — instead of starving the rest.
    Rate 0 (the default) is accounting-only: per-tenant labeled
    metrics without any admission behavior change.
  * **dynamic registry**: ``add_replica`` / ``remove_replica`` /
    ``set_draining`` let a controller (a fleet autoscaler) reshape the
    fleet at runtime; ``utilization()`` is the aggregate load signal it
    polls.

Fault-injection sites: ``router.dispatch`` (armed error = a torn
dispatch, exercising the retry path deterministically) and
``router.replica_down`` (fires at the moment a replica is marked
down).  The HTTP surface is :class:`RouterHTTPServer`; the command
line is ``python -m dmlc_tpu_torch.serving.route``.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import urllib.error
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

from .. import telemetry
from ..base import get_env
from ..concurrency import make_lock
from ..resilience.fault import fault_point
from ..telemetry import tracecontext
from ..telemetry.requests import percentile

__all__ = ["Replica", "Router", "RouterHTTPServer", "TenantGovernor",
           "discover_replicas", "parse_tenant_weights",
           "HEALTHY", "DOWN", "DRAINING"]

logger = logging.getLogger("dmlc_tpu_torch.serving")

HEALTHY = "healthy"
DOWN = "down"
DRAINING = "draining"

#: Prometheus value encoding of the per-replica health gauge
_HEALTH_VALUE = {HEALTHY: 1, DOWN: 0, DRAINING: 2}

_LATENCY_RING = 512      # completed-request latency samples kept
_HEDGE_MIN_SAMPLES = 8   # latency evidence required before hedging
_MIN_LAUNCH_WINDOW_S = 1.0  # no new dispatch into less deadline than this

MAX_BODY_BYTES = 1 << 20


def discover_replicas(tracker_uri: str, tracker_port: int,
                      serve_port: int) -> List[str]:
    """Replica URLs from the tracker's job map: rank ``r`` of the
    current generation is expected to serve on ``serve_port + r`` on
    its brokered host (the convention ``serving.route --tracker``
    takes; co-hosted replicas get distinct ports, distinct hosts
    keep a predictable base)."""
    from ..tracker.client import TrackerClient

    tc = TrackerClient(tracker_uri, tracker_port)
    doc = tc._query_hostmap()
    hosts = doc.get("hosts", {})
    out = []
    for r in sorted(hosts, key=int):
        host = hosts[r][0]
        out.append(f"http://{host}:{serve_port + int(r)}")
    return out


class Replica:
    """One replica's routing state (mutated only under Router._lock)."""

    __slots__ = ("url", "state", "fail_streak", "next_probe_t",
                 "last_ok_t", "inflight", "queue_depth", "live",
                 "active", "waiting", "max_active", "dispatches",
                 "failures", "last_error", "availability")

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.state = HEALTHY     # optimistic: first dispatch/poll decides
        self.fail_streak = 0
        self.next_probe_t = 0.0
        self.last_ok_t: Optional[float] = None
        self.inflight = 0        # router-side in-flight dispatches
        self.queue_depth = 0     # decode queue depth from the last poll
        self.live = 0            # live requests from the last poll
        self.active = 0
        self.waiting = 0
        self.max_active = 0
        self.dispatches = 0
        self.failures = 0
        self.last_error: Optional[str] = None
        # availability-ledger doc from the replica's last /healthz poll
        # (serving/draining/crashed/starved fractions, tokens served
        # vs. capacity) — the /fleet audit trail for scaling decisions
        self.availability: Optional[Dict] = None

    def view(self) -> Dict:
        return {
            "url": self.url, "state": self.state,
            "inflight": self.inflight, "queue_depth": self.queue_depth,
            "live": self.live, "active": self.active,
            "waiting": self.waiting, "max_active": self.max_active,
            "dispatches": self.dispatches, "failures": self.failures,
            "fail_streak": self.fail_streak,
            "last_error": self.last_error,
            "availability": self.availability,
        }


def parse_tenant_weights(spec: Optional[str]) -> Dict[str, float]:
    """``DMLC_TENANT_WEIGHTS`` parser: ``"paid=4,free=1"`` → dict.
    Malformed entries are skipped with a warning rather than raising —
    a typo in one tenant's weight must not take the router down."""
    out: Dict[str, float] = {}
    if not spec:
        return out
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, val = part.partition("=")
        name = name.strip()
        try:
            w = float(val)
            if not sep or not name or len(name) > 64 or w <= 0:
                raise ValueError(part)
        except ValueError:
            logger.warning("ignoring malformed tenant weight %r", part)
            continue
        out[name] = w
    return out


class _TenantState:
    """One tenant's bucket + counters (mutated under the governor's
    lock only)."""

    __slots__ = ("name", "weight", "tokens", "last_refill", "requests",
                 "admitted", "rejected", "tokens_generated")

    def __init__(self, name: str, weight: float, burst: float,
                 now: float):
        self.name = name
        self.weight = weight
        self.tokens = burst          # buckets start full: no cold 429s
        self.last_refill = now
        self.requests = 0
        self.admitted = 0
        self.rejected = 0
        self.tokens_generated = 0

    def view(self) -> Dict:
        return {"tenant": self.name, "weight": self.weight,
                "bucket_level": round(self.tokens, 3),
                "requests": self.requests, "admitted": self.admitted,
                "rejected": self.rejected,
                "tokens_generated": self.tokens_generated}


class TenantGovernor:
    """Weighted token-bucket admission per tenant (router front door).

    Each tenant refills at ``weight × rate`` requests/second into a
    bucket holding ``burst_s`` seconds of its own rate, so a hot
    tenant rides its burst then gets per-tenant 429s with an HONEST
    Retry-After (seconds until ITS bucket holds one token) while every
    other tenant's admission is untouched — noisy-neighbor isolation
    as an edge verdict instead of a shared-queue lottery.

    ``rate <= 0`` (the default) disables enforcement: the governor
    still does per-tenant accounting (requests/tokens/labeled metrics)
    but never rejects, so existing single-tenant deployments see zero
    behavior change.  Distinct tenant keys are capped at
    ``max_tenants``; past that, unknown keys fold into the
    ``"overflow"`` pseudo-tenant — a hostile client minting random
    keys gets ONE shared bucket and bounded label cardinality, not an
    unbounded metrics surface.
    """

    OVERFLOW = "overflow"

    def __init__(self, *, rate: Optional[float] = None,
                 burst_s: Optional[float] = None,
                 weights: Optional[Dict[str, float]] = None,
                 default_weight: Optional[float] = None,
                 max_tenants: Optional[int] = None):
        self.rate = (rate if rate is not None
                     else get_env("DMLC_TENANT_RATE", 0.0))
        self.burst_s = (burst_s if burst_s is not None
                        else get_env("DMLC_TENANT_BURST_S", 10.0))
        self.default_weight = (
            default_weight if default_weight is not None
            else get_env("DMLC_TENANT_DEFAULT_WEIGHT", 1.0))
        self.max_tenants = (max_tenants if max_tenants is not None
                            else get_env("DMLC_TENANT_MAX", 64))
        self.weights = (dict(weights) if weights is not None
                        else parse_tenant_weights(
                            get_env("DMLC_TENANT_WEIGHTS", None, str)))
        self._lock = make_lock("TenantGovernor._lock")
        self._tenants: Dict[str, _TenantState] = {}

    def _burst(self, weight: float) -> float:
        return max(1.0, weight * max(self.rate, 0.0) * self.burst_s)

    def _state(self, tenant: str, now: float) -> _TenantState:
        """Lock held.  Configured tenants always get their own bucket;
        unknown ones fold to overflow past the cardinality cap."""
        st = self._tenants.get(tenant)
        if st is not None:
            return st
        if (tenant not in self.weights
                and len(self._tenants) >= self.max_tenants):
            tenant = self.OVERFLOW
            st = self._tenants.get(tenant)
            if st is not None:
                return st
        w = self.weights.get(tenant, self.default_weight)
        st = _TenantState(tenant, w, self._burst(w), now)
        self._tenants[tenant] = st
        return st

    def admit(self, tenant: str,
              now: Optional[float] = None) -> Tuple[bool, float]:
        """One admission decision: ``(admitted, retry_after_s)``.
        Refill-then-spend under the lock; the rejection's Retry-After
        is the seconds until THIS tenant's bucket refills one token —
        computed from its own weighted rate, never a constant."""
        now = time.monotonic() if now is None else now
        with self._lock:
            st = self._state(tenant, now)
            st.requests += 1
            if self.rate <= 0:
                st.admitted += 1
                return True, 0.0
            fill_rate = st.weight * self.rate
            st.tokens = min(self._burst(st.weight),
                            st.tokens + (now - st.last_refill) * fill_rate)
            st.last_refill = now
            if st.tokens >= 1.0:
                st.tokens -= 1.0
                st.admitted += 1
                return True, 0.0
            st.rejected += 1
            retry = (1.0 - st.tokens) / max(fill_rate, 1e-9)
        telemetry.inc("router", "tenant_rejections")
        return False, max(0.1, min(retry, 60.0))

    def observe_completion(self, tenant: str, n_generated: int) -> None:
        now = time.monotonic()
        with self._lock:
            st = self._state(tenant, now)
            st.tokens_generated += max(0, int(n_generated or 0))

    def views(self) -> List[Dict]:
        with self._lock:
            return [st.view() for _, st in sorted(self._tenants.items())]

    def stats(self) -> Dict:
        return {"rate_per_weight": self.rate, "burst_s": self.burst_s,
                "enforcing": self.rate > 0,
                "default_weight": self.default_weight,
                "tenants": self.views()}

    def prometheus_text(self) -> str:
        """Hand-rendered ``dmlc_tenant_*`` families with a ``tenant``
        label (the core registry is label-free — same pattern as the
        per-replica ``dmlc_router_replica_*`` families)."""
        views = self.views()
        if not views:
            return ""

        def esc(v: str) -> str:
            return (v.replace("\\", r"\\").replace('"', r'\"')
                    .replace("\n", r"\n"))

        fams = (
            ("dmlc_tenant_requests_total", "counter",
             "requests seen at the router per tenant",
             lambda v: v["requests"]),
            ("dmlc_tenant_admitted_total", "counter",
             "requests admitted past the tenant token bucket",
             lambda v: v["admitted"]),
            ("dmlc_tenant_rejected_total", "counter",
             "per-tenant 429s from the weighted token bucket",
             lambda v: v["rejected"]),
            ("dmlc_tenant_tokens_generated_total", "counter",
             "generated tokens attributed to this tenant",
             lambda v: v["tokens_generated"]),
            ("dmlc_tenant_bucket_level", "gauge",
             "admission tokens currently in the tenant's bucket",
             lambda v: v["bucket_level"]),
            ("dmlc_tenant_weight", "gauge",
             "configured fair-share weight per tenant",
             lambda v: v["weight"]),
        )
        lines = []
        for name, typ, help_text, getter in fams:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {typ}")
            for v in views:
                lines.append(
                    f'{name}{{tenant="{esc(v["tenant"])}"}} {getter(v)}')
        return "\n".join(lines) + "\n"


def _is_timeout(exc: BaseException) -> bool:
    """A dispatch timeout means SLOW, not dead: ``socket.timeout`` is
    ``TimeoutError`` since 3.10, and urllib wraps connect timeouts in
    ``URLError(reason=timeout)``."""
    if isinstance(exc, TimeoutError):
        return True
    return isinstance(getattr(exc, "reason", None), TimeoutError)


class _Outcome:
    """One dispatch attempt's result, posted to the route() waiter."""

    __slots__ = ("replica", "kind", "ok", "code", "doc", "retry_after",
                 "transport", "timed_out", "error")

    def __init__(self, replica: Replica, kind: str, *, ok: bool = False,
                 code: Optional[int] = None, doc: Optional[Dict] = None,
                 retry_after: Optional[str] = None,
                 transport: bool = False, timed_out: bool = False,
                 error: Optional[str] = None):
        self.replica = replica
        self.kind = kind          # primary | retry | hedge
        self.ok = ok
        self.code = code
        self.doc = doc
        self.retry_after = retry_after
        self.transport = transport
        self.timed_out = timed_out
        self.error = error


class Router:
    """Retrying, hedging, drain-aware dispatcher over a replica fleet.

    Defaults come from the ``DMLC_ROUTER_*`` knobs (README "Fleet
    serving on the port") so ``serving.route`` and embedded/test uses
    read one configuration surface.
    """

    def __init__(self, replicas: Sequence[str], *,
                 health_interval_s: Optional[float] = None,
                 probe_timeout_s: Optional[float] = None,
                 probe_base_s: Optional[float] = None,
                 probe_max_s: Optional[float] = None,
                 retries: Optional[int] = None,
                 dispatch_timeout_s: Optional[float] = None,
                 request_timeout_s: Optional[float] = None,
                 hedge_after_p99_mult: Optional[float] = None,
                 hedge_min_samples: int = _HEDGE_MIN_SAMPLES,
                 tenants: Optional[TenantGovernor] = None,
                 start_health_thread: bool = True):
        if not replicas:
            raise ValueError("router needs at least one replica URL")
        self._lock = make_lock("Router._lock")
        self.replicas: List[Replica] = [Replica(u) for u in replicas]
        if len({r.url for r in self.replicas}) != len(self.replicas):
            raise ValueError("duplicate replica URLs")
        # per-tenant fairness at the front door (accounting-only until
        # DMLC_TENANT_RATE turns enforcement on)
        self.tenants = tenants if tenants is not None else TenantGovernor()
        self.health_interval_s = (
            health_interval_s if health_interval_s is not None
            else get_env("DMLC_ROUTER_HEALTH_INTERVAL_S", 1.0))
        self.probe_timeout_s = (
            probe_timeout_s if probe_timeout_s is not None
            else get_env("DMLC_ROUTER_PROBE_TIMEOUT_S", 2.0))
        self.probe_base_s = (
            probe_base_s if probe_base_s is not None
            else get_env("DMLC_ROUTER_PROBE_BASE_S", 0.5))
        self.probe_max_s = (
            probe_max_s if probe_max_s is not None
            else get_env("DMLC_ROUTER_PROBE_MAX_S", 15.0))
        self.retries = (retries if retries is not None
                        else get_env("DMLC_ROUTER_RETRIES", 3))
        self.dispatch_timeout_s = (
            dispatch_timeout_s if dispatch_timeout_s is not None
            else get_env("DMLC_ROUTER_DISPATCH_TIMEOUT_S", 120.0))
        self.request_timeout_s = (
            request_timeout_s if request_timeout_s is not None
            else get_env("DMLC_ROUTER_REQUEST_TIMEOUT_S", 300.0))
        self.hedge_after_p99_mult = (
            hedge_after_p99_mult if hedge_after_p99_mult is not None
            else get_env("DMLC_ROUTER_HEDGE_AFTER_P99_MULT", 0.0))
        self.hedge_min_samples = max(1, int(hedge_min_samples))
        self._latencies: List[float] = []  # bounded ring (see _record)
        # fleet trace assembly (DMLC_TRACE_FLEET=1): the health sweep
        # pulls every replica's span increments into this store, so a
        # replica's history survives its own death (the post-SIGKILL
        # trace is exactly the point)
        self.trace_store: Optional[tracecontext.FleetTraceStore] = (
            tracecontext.FleetTraceStore()
            if tracecontext.enabled() else None)
        self._stop = threading.Event()
        self._publish_fleet_gauges()
        self._health_thread: Optional[threading.Thread] = None
        if start_health_thread:
            self._health_thread = threading.Thread(
                target=self._health_loop, daemon=True,
                name="router-health")
            self._health_thread.start()

    # ---- dynamic registry (the autoscaler's surface) --------------------
    def add_replica(self, url: str) -> Replica:
        """Register a replica at run time (fleet scale-up).  The new
        replica starts HEALTHY-optimistic exactly like an init-time one
        — the next health sweep corrects it within one interval — and
        is eligible for dispatch immediately.  Raises ``ValueError``
        on a duplicate URL (the caller's registry bug, not a no-op:
        silently keeping one Replica for two registrations would
        double-count its load)."""
        rep = Replica(url)
        with self._lock:
            if any(r.url == rep.url for r in self.replicas):
                raise ValueError(f"replica {rep.url} already registered")
            self.replicas.append(rep)
        telemetry.inc("router", "replicas_added")
        telemetry.record_event("router_replica_added", replica=rep.url)
        logger.info("router: replica %s registered", rep.url)
        self._publish_fleet_gauges()
        return rep

    def remove_replica(self, url: str) -> bool:
        """Drop a replica from the registry (fleet scale-down, after
        its drain completed).  In-flight dispatches to it finish on
        their own threads — removal only stops NEW placement.  Returns
        False when the URL is unknown (already removed)."""
        url = url.rstrip("/")
        with self._lock:
            for i, r in enumerate(self.replicas):
                if r.url == url:
                    del self.replicas[i]
                    break
            else:
                return False
        telemetry.inc("router", "replicas_removed")
        telemetry.record_event("router_replica_removed", replica=url)
        logger.info("router: replica %s removed", url)
        self._publish_fleet_gauges()
        return True

    def set_draining(self, url: str) -> bool:
        """Flip a replica to DRAINING by URL (the autoscaler's
        scale-down first step: shift traffic BEFORE the engine's
        begin_drain, so no dispatch races the drain gate).  Returns
        False when the URL is unknown."""
        url = url.rstrip("/")
        with self._lock:
            rep = next((r for r in self.replicas if r.url == url), None)
        if rep is None:
            return False
        self._mark_draining(rep)
        return True

    # ---- registry views -------------------------------------------------
    def replica_views(self) -> List[Dict]:
        with self._lock:
            return [r.view() for r in self.replicas]

    def utilization(self) -> float:
        """Aggregate fleet load in [0, ∞): queued+running work over
        non-DOWN decode capacity (the autoscaler's primary signal;
        >1 means work is queueing faster than the fleet decodes)."""
        with self._lock:
            load = sum(r.live + r.inflight for r in self.replicas
                       if r.state != DOWN)
            capacity = sum(r.max_active for r in self.replicas
                           if r.state != DOWN)
        return load / capacity if capacity else float(load > 0)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = {HEALTHY: 0, DOWN: 0, DRAINING: 0}
            for r in self.replicas:
                out[r.state] += 1
        return out

    def _publish_fleet_gauges(self) -> None:
        c = self.counts()
        telemetry.set_gauge("router", "replicas_healthy", c[HEALTHY])
        telemetry.set_gauge("router", "replicas_down", c[DOWN])
        telemetry.set_gauge("router", "replicas_draining", c[DRAINING])

    # ---- health ---------------------------------------------------------
    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 - watcher must not die
                logger.warning("router health sweep failed: %r", e)

    def poll_once(self) -> None:
        """One health sweep: refresh every replica's load + drain state,
        probe DOWN replicas whose circuit-breaker backoff expired.
        Probes run CONCURRENTLY (one short-lived daemon thread per due
        replica, same isolation _attempt gives dispatches) so a
        blackholed host costs one probe timeout, not a serialized
        timeout per victim that starves the whole fleet's freshness.
        Returns after every probe resolved — tests (and the smoke)
        drive it deterministically."""
        now = time.monotonic()
        with self._lock:
            due = [r for r in self.replicas
                   if not (r.state == DOWN and now < r.next_probe_t)]
        threads = [threading.Thread(target=self._probe_one, args=(r,),
                                    daemon=True, name="router-probe")
                   for r in due]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.probe_timeout_s + 2.0)
        self._publish_fleet_gauges()
        self.pull_spans_once()

    # ---- fleet trace assembly (DMLC_TRACE_FLEET) ------------------------
    def pull_spans_once(self) -> None:
        """One trace sweep: the router's own span ring plus every
        non-DOWN replica's ``GET /spans?since=N`` increment into the
        fleet trace store.  Riding the health interval keeps a killed
        replica's spans captured up to within one sweep of its death.
        No-op when tracing is off."""
        store = self.trace_store
        if store is None:
            return
        try:
            store.ingest_local()
        except Exception as e:  # noqa: BLE001 - sweep must not die
            logger.debug("trace self-ingest failed: %r", e)
        with self._lock:
            urls = [r.url for r in self.replicas if r.state != DOWN]
        for url in urls:
            try:
                since = store.cursor(url)
                with urllib.request.urlopen(
                        f"{url}/spans?since={since}",
                        timeout=self.probe_timeout_s) as resp:
                    store.ingest(url, json.loads(resp.read()))
            except (urllib.error.URLError, OSError, ValueError):
                pass  # replica died mid-pull: its captured history stays

    def _probe_one(self, rep: Replica) -> None:
        try:
            with urllib.request.urlopen(
                    rep.url + "/healthz",
                    timeout=self.probe_timeout_s) as resp:
                doc = json.loads(resp.read())
        except (urllib.error.URLError, OSError, ValueError) as e:
            self._mark_down(rep, f"healthz probe failed: {e!r}")
            return
        self._mark_alive(rep, doc)

    def _mark_alive(self, rep: Replica, doc: Dict) -> None:
        draining = bool(doc.get("draining"))
        reqs = doc.get("requests") or {}
        recovered = False
        with self._lock:
            if rep.state == DOWN:
                recovered = True
            rep.state = DRAINING if draining else HEALTHY
            rep.fail_streak = 0
            rep.next_probe_t = 0.0
            rep.last_ok_t = time.monotonic()
            rep.last_error = None
            rep.active = int(doc.get("active") or 0)
            rep.waiting = int(doc.get("waiting") or 0)
            rep.max_active = int(doc.get("max_active") or 0)
            rep.live = int(reqs.get("live_requests") or 0)
            # live_waiting == 0 is a real (idle) reading — only fall
            # back to the last decode-iteration's queue depth when the
            # key is genuinely absent (an older replica), else a stale
            # nonzero iteration record would repel traffic from an
            # idle replica forever
            qd = reqs.get("live_waiting")
            if qd is None:
                qd = reqs.get("decode_queue_depth") or 0
            rep.queue_depth = int(qd)
            av = doc.get("availability")
            if isinstance(av, dict):
                rep.availability = av
        if recovered:
            telemetry.inc("router", "probe_recoveries")
            telemetry.record_event("router_replica_up", replica=rep.url)
            self._trace_instant("router.circuit_close", rep.url)
            logger.info("router: replica %s recovered", rep.url)

    def _mark_down(self, rep: Replica, error: str) -> None:
        fault_point("router.replica_down", replica=rep.url)
        was = None
        with self._lock:
            was = rep.state
            rep.state = DOWN
            rep.fail_streak += 1
            rep.failures += 1
            rep.last_error = error
            backoff = min(self.probe_base_s * (2 ** (rep.fail_streak - 1)),
                          self.probe_max_s)
            rep.next_probe_t = time.monotonic() + backoff
        if was != DOWN:
            telemetry.inc("router", "replica_down_total")
            telemetry.record_event("router_replica_down",
                                   replica=rep.url, error=error)
            self._trace_instant("router.circuit_open", rep.url,
                                error=str(error)[:200])
            logger.warning("router: replica %s marked down (%s)",
                           rep.url, error)
        self._publish_fleet_gauges()

    def _mark_draining(self, rep: Replica) -> None:
        changed = False
        with self._lock:
            if rep.state != DRAINING:
                rep.state = DRAINING
                changed = True
        if changed:
            telemetry.inc("router", "drain_shifts")
            telemetry.record_event("router_replica_draining",
                                   replica=rep.url)
            self._trace_instant("router.drain_shift", rep.url)
            logger.info("router: replica %s draining; shifting traffic",
                        rep.url)
        self._publish_fleet_gauges()

    @staticmethod
    def _trace_instant(name: str, replica: str, **fields) -> None:
        """Zero-duration control-plane span (circuit open/close, drain
        shift) into the span ring — trace-visible context for why a
        request's attempt pattern changed.  Off with tracing."""
        if not tracecontext.enabled():
            return
        t = time.perf_counter()
        telemetry.record_span(name, stage="router", t0=t, t1=t,
                              args={"replica": replica, **fields})

    # ---- placement ------------------------------------------------------
    def pick(self, exclude: Optional[set] = None) -> Optional[Replica]:
        """Least-loaded healthy replica (drain-aware: a DRAINING
        replica never receives new work), or None.  Load is the
        router's own in-flight count plus the replica's decode queue
        depth from the last poll — live signal + ledger signal."""
        exclude = exclude or set()
        with self._lock:
            candidates = [r for r in self.replicas
                          if r.state == HEALTHY and r.url not in exclude]
            if not candidates:
                return None
            return min(candidates,
                       key=lambda r: (r.inflight + r.queue_depth,
                                      r.inflight, r.url))

    # ---- latency evidence (hedge threshold + honest Retry-After) -------
    def _record_latency(self, secs: float) -> None:
        with self._lock:
            self._latencies.append(secs)
            if len(self._latencies) > _LATENCY_RING:
                del self._latencies[:len(self._latencies) - _LATENCY_RING]

    def _latency_pct(self, q: float) -> Optional[float]:
        with self._lock:
            samples = list(self._latencies)
        return percentile(samples, q)

    def hedge_after_s(self) -> Optional[float]:
        """Seconds a dispatch may run before a hedge fires, or None
        when hedging is off / latency evidence is still thin."""
        if self.hedge_after_p99_mult <= 0:
            return None
        with self._lock:
            n = len(self._latencies)
        if n < self.hedge_min_samples:
            return None
        p99 = self._latency_pct(99)
        if p99 is None:
            return None
        return self.hedge_after_p99_mult * p99

    def retry_after_s(self) -> int:
        """Honest 429 Retry-After: aggregate queued work over aggregate
        decode capacity, scaled by the observed per-request service
        time (p50 of routed latencies; 1s before evidence exists),
        clamped to [1, 60]."""
        with self._lock:
            queued = sum(r.live + r.inflight for r in self.replicas
                         if r.state != DOWN)
            capacity = sum(r.max_active for r in self.replicas
                           if r.state != DOWN)
        service = self._latency_pct(50) or 1.0
        est = queued * service / max(capacity, 1)
        return max(1, min(60, int(est + 0.999)))

    # ---- dispatch -------------------------------------------------------
    def _attempt(self, rep: Replica, kind: str, payload: bytes,
                 timeout_s: float, out_q: "queue.Queue",
                 trace_id: Optional[str] = None) -> None:
        """One POST to one replica; the outcome (success, HTTP error,
        or transport failure) is posted to the route() waiter.  Runs on
        a daemon thread so a wedged replica cannot wedge the router.
        With tracing on, every attempt carries the trace id and a
        FRESH span id in ``X-DMLC-Trace`` and leaves a
        ``router.dispatch`` span (replica, kind, outcome, status)."""
        with self._lock:
            rep.inflight += 1
            rep.dispatches += 1
        telemetry.inc("router", "dispatches")
        headers = {"Content-Type": "application/json"}
        span_t0 = 0.0
        if trace_id is not None:
            headers[tracecontext.TRACE_HEADER] = \
                tracecontext.format_header(trace_id,
                                           tracecontext.new_span_id())
            span_t0 = time.perf_counter()
        outcome: str = "transport"
        status: Optional[int] = None
        try:
            fault_point("router.dispatch", replica=rep.url, attempt=kind)
            req = urllib.request.Request(
                rep.url + "/generate", data=payload, headers=headers)
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                doc = json.loads(resp.read())
            outcome, status = "ok", 200
            out_q.put(_Outcome(rep, kind, ok=True, code=200, doc=doc))
        except urllib.error.HTTPError as e:
            body = e.read()[:4096]
            try:
                doc = json.loads(body)
            except ValueError:
                doc = {"error": body.decode(errors="replace")}
            outcome, status = "http_error", e.code
            out_q.put(_Outcome(
                rep, kind, code=e.code, doc=doc,
                retry_after=e.headers.get("Retry-After"),
                error=f"HTTP {e.code}: {doc.get('error')}"))
        except (urllib.error.URLError, OSError, ValueError) as e:
            outcome = "timeout" if _is_timeout(e) else "transport"
            out_q.put(_Outcome(rep, kind, transport=True,
                               timed_out=_is_timeout(e),
                               error=f"dispatch failed: {e!r}"))
        finally:
            with self._lock:
                rep.inflight -= 1
            if trace_id is not None:
                telemetry.record_span(
                    "router.dispatch", stage="router",
                    t0=span_t0, t1=time.perf_counter(),
                    args={"trace_id": trace_id, "replica": rep.url,
                          "kind": kind, "outcome": outcome,
                          "status": status})

    def _launch(self, rep: Replica, kind: str, payload: bytes,
                deadline: float, out_q: "queue.Queue",
                trace_id: Optional[str] = None) -> None:
        timeout_s = max(0.05, min(self.dispatch_timeout_s,
                                  deadline - time.monotonic()))
        threading.Thread(
            target=self._attempt, args=(rep, kind, payload, timeout_s,
                                        out_q, trace_id),
            daemon=True, name=f"router-dispatch-{kind}").start()

    def route(self, body: Dict,
              timeout_s: Optional[float] = None,
              trace_parent: Optional[str] = None
              ) -> Tuple[int, Dict, Dict[str, str]]:
        """Route one /generate body: returns ``(status, doc, headers)``
        for the client.  Guarantees: at most one 200 is ever returned
        per call (first-wins across hedges), a replica that dies
        mid-dispatch is retried elsewhere under the same idempotency
        key, and a saturation verdict carries an honest Retry-After.

        ``trace_parent`` is the inbound ``X-DMLC-Trace`` value, if any;
        with ``DMLC_TRACE_FLEET=1`` it (or, absent/malformed, a trace
        id derived from the idempotency key) rides every dispatch
        attempt, so retries and hedges of one request are one trace."""
        t0 = time.monotonic()
        rid = body.get("request_id")
        if rid is None:
            rid = uuid.uuid4().hex
            body = dict(body, request_id=rid)
        trace_id: Optional[str] = None
        if tracecontext.enabled():
            parsed = tracecontext.parse_header(trace_parent)
            trace_id = parsed[0] if parsed \
                else tracecontext.mint_trace_id(rid)
        payload = json.dumps(body).encode()
        deadline = t0 + (timeout_s if timeout_s is not None
                         else self.request_timeout_s)
        telemetry.inc("router", "requests")
        out_q: "queue.Queue[_Outcome]" = queue.Queue()
        tried: set = set()
        primary = self.pick()
        if primary is None:
            return self._no_replica_verdict()
        tried.add(primary.url)
        self._launch(primary, "primary", payload, deadline, out_q,
                     trace_id)
        last_launch = time.monotonic()
        pending = 1
        retries_left = max(0, int(self.retries))
        hedged = False
        saw_429 = saw_other = False
        last_error: Optional[str] = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                telemetry.inc("router", "failed")
                return (503, {"error": "router request deadline "
                              "exceeded", "request_id": rid,
                              "last_error": last_error},
                        {"Retry-After": "5"})
            # a retry/hedge launched into a sliver of deadline would be
            # clamped into a guaranteed timeout — wasted replica work;
            # past this floor, only already-in-flight attempts decide
            can_launch = remaining > _MIN_LAUNCH_WINDOW_S
            wait = remaining
            hedge_after = None if hedged else self.hedge_after_s()
            if hedge_after is not None and can_launch:
                # the hedge clock starts at the LATEST dispatch: a
                # retry gets its own full threshold before a hedge
                # fires, per the knob's per-dispatch contract
                until_hedge = (last_launch + hedge_after) \
                    - time.monotonic()
                if until_hedge <= 0:
                    hedged = True  # single shot, even if no peer is free
                    rep2 = self.pick(exclude=tried)
                    if rep2 is not None:
                        tried.add(rep2.url)
                        telemetry.inc("router", "hedges")
                        telemetry.record_event("router_hedge",
                                               request_id=rid,
                                               replica=rep2.url)
                        if trace_id is not None:
                            tn = time.perf_counter()
                            telemetry.record_span(
                                "router.hedge", stage="router",
                                t0=tn, t1=tn,
                                args={"trace_id": trace_id,
                                      "replica": rep2.url})
                        self._launch(rep2, "hedge", payload, deadline,
                                     out_q, trace_id)
                        pending += 1
                    continue
                wait = min(wait, until_hedge)
            try:
                out = out_q.get(timeout=wait)
            except queue.Empty:
                continue
            pending -= 1
            if out.ok:
                if pending > 0:
                    # a hedge race was lost somewhere: observe the
                    # stragglers off-thread so abandoned work is counted
                    self._reap_stragglers(out_q, pending, trace_id,
                                          out.replica.url)
                return self._win(out, rid, t0, trace_id)
            # ---- a failed attempt ---------------------------------------
            last_error = out.error
            if out.code in (400, 404, 413):
                # the client's error: deterministic on any replica, so
                # retrying elsewhere would just repeat it
                telemetry.inc("router", "failed")
                return out.code, out.doc or {}, {}
            if out.code == 429:
                saw_429 = True  # saturated, NOT unhealthy
            elif out.code == 503 and "drain" in str(
                    (out.doc or {}).get("error", "")):
                self._mark_draining(out.replica)
            elif out.transport and not out.timed_out:
                saw_other = True
                self._mark_down(out.replica, out.error or "dispatch "
                                "failed")
            else:
                # a dispatch TIMEOUT (slow, not dead — liveness is the
                # health prober's verdict, which carries its own
                # bounded timeout) or a 5xx with the replica still
                # answering HTTP: retry elsewhere without opening the
                # circuit
                saw_other = True
            nxt = (self.pick(exclude=tried)
                   if retries_left > 0 and can_launch else None)
            if nxt is not None:
                retries_left -= 1
                tried.add(nxt.url)
                telemetry.inc("router", "retries")
                if out.transport and not out.timed_out:
                    telemetry.inc("router", "failovers_total")
                    telemetry.record_event("router_failover",
                                           request_id=rid,
                                           from_replica=out.replica.url,
                                           to_replica=nxt.url)
                self._launch(nxt, "retry", payload, deadline, out_q,
                             trace_id)
                last_launch = time.monotonic()
                pending += 1
                continue
            if pending > 0:
                continue  # a hedge/retry is still in flight; it decides
            if saw_429 and not saw_other:
                telemetry.inc("router", "rejected_busy")
                telemetry.inc("router", "failed")
                return (429, {"error": "all replicas saturated",
                              "request_id": rid},
                        {"Retry-After": str(self.retry_after_s())})
            telemetry.inc("router", "failed")
            return (503, {"error": "no replica could serve the request",
                          "request_id": rid, "last_error": last_error},
                    {"Retry-After": "5"})

    def _reap_stragglers(self, out_q: "queue.Queue", pending: int,
                         trace_id: Optional[str],
                         winner_url: str) -> None:
        """After a win with attempts still in flight (a hedge race),
        drain the losers off-thread: an abandoned hedge loser that
        completed anyway did real decode work — count its generated
        tokens (``dmlc_router_hedge_abandoned_tokens``, from its own
        ledger-derived response) and mark its span abandoned, so
        wasted fleet work is measurable instead of invisible."""
        timeout = self.dispatch_timeout_s + 5.0

        def _reap() -> None:
            left = pending
            deadline = time.monotonic() + timeout
            while left > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                try:
                    out = out_q.get(timeout=remaining)
                except queue.Empty:
                    return
                left -= 1
                if not out.ok:
                    continue
                tokens = 0
                if isinstance(out.doc, dict):
                    try:
                        tokens = max(0, int(out.doc.get(
                            "n_generated", 0) or 0))
                    except (TypeError, ValueError):
                        tokens = 0
                telemetry.inc("router", "hedge_abandoned")
                if tokens:
                    telemetry.inc("router", "hedge_abandoned_tokens",
                                  tokens)
                if trace_id is not None:
                    tn = time.perf_counter()
                    telemetry.record_span(
                        "router.hedge_abandoned", stage="router",
                        t0=tn, t1=tn,
                        args={"trace_id": trace_id,
                              "replica": out.replica.url,
                              "winner": winner_url,
                              "abandoned": True, "tokens": tokens})

        threading.Thread(target=_reap, daemon=True,
                         name="router-hedge-reap").start()

    def _win(self, out: _Outcome, rid: str, t0: float,
             trace_id: Optional[str] = None
             ) -> Tuple[int, Dict, Dict[str, str]]:
        elapsed = time.monotonic() - t0
        self._record_latency(elapsed)
        telemetry.inc("router", "completed")
        telemetry.observe_duration("router", "latency", elapsed)
        doc = dict(out.doc or {})
        doc.setdefault("request_id", rid)
        doc["served_by"] = out.replica.url
        if trace_id is not None:
            doc.setdefault("trace_id", trace_id)
        if out.kind == "hedge":
            telemetry.inc("router", "hedge_wins")
            if trace_id is not None:
                tn = time.perf_counter()
                telemetry.record_span(
                    "router.hedge_win", stage="router", t0=tn, t1=tn,
                    args={"trace_id": trace_id,
                          "replica": out.replica.url})
        ttft = doc.get("ttft_s")
        if isinstance(ttft, (int, float)):
            telemetry.observe_duration("router", "ttft", float(ttft))
        return 200, doc, {}

    def _no_replica_verdict(self) -> Tuple[int, Dict, Dict[str, str]]:
        telemetry.inc("router", "failed")
        c = self.counts()
        if c[DRAINING] and not c[HEALTHY]:
            doc = {"error": "every replica is draining"}
        else:
            doc = {"error": "no healthy replica"}
        doc["replicas"] = c
        return 503, doc, {"Retry-After": str(self.retry_after_s())}

    # ---- observability --------------------------------------------------
    def stats(self) -> Dict:
        c = self.counts()
        with self._lock:
            agg_live = sum(r.live for r in self.replicas)
            agg_inflight = sum(r.inflight for r in self.replicas)
            agg_capacity = sum(r.max_active for r in self.replicas
                               if r.state != DOWN)
        return {
            "replicas": self.replica_views(),
            "healthy": c[HEALTHY], "down": c[DOWN],
            "draining": c[DRAINING],
            "aggregate": {"live": agg_live, "inflight": agg_inflight,
                          "capacity": agg_capacity,
                          "utilization": self.utilization()},
            "latency_p50_s": self._latency_pct(50),
            "latency_p99_s": self._latency_pct(99),
            "hedge_after_s": self.hedge_after_s(),
            "tenants": self.tenants.stats(),
        }

    def prometheus_text(self) -> str:
        """Hand-rendered per-replica families with a ``replica`` label
        (the core registry is label-free, same pattern as
        ``SLOMonitor.prometheus_text``)."""
        views = self.replica_views()
        if not views:
            return ""

        def esc(v: str) -> str:
            return (v.replace("\\", r"\\").replace('"', r'\"')
                    .replace("\n", r"\n"))

        fams = (
            ("dmlc_router_replica_health",
             "replica health: 1 healthy, 0 down (circuit open), "
             "2 draining", lambda v: _HEALTH_VALUE[v["state"]]),
            ("dmlc_router_replica_inflight",
             "router-side in-flight dispatches per replica",
             lambda v: v["inflight"]),
            ("dmlc_router_replica_queue_depth",
             "replica decode queue depth from the last health poll",
             lambda v: v["queue_depth"]),
            ("dmlc_router_replica_dispatches",
             "dispatches sent to this replica", lambda v: v["dispatches"]),
            ("dmlc_router_replica_failures",
             "transport/probe failures observed on this replica",
             lambda v: v["failures"]),
        )
        lines = []
        for name, help_text, getter in fams:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} gauge")
            for v in views:
                lines.append(
                    f'{name}{{replica="{esc(v["url"])}"}} {getter(v)}')
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        self._stop.set()
        t = self._health_thread
        if t is not None:
            t.join(timeout=5.0)


#: the status codes the router edge answers with, each a registered
#: counter family (mirrors serving/server.py _STATUS_COUNTERS)
_ROUTER_STATUS_COUNTERS = {200: "http_200", 400: "http_400",
                           404: "http_404", 429: "http_429",
                           503: "http_503"}


class RouterHTTPServer:
    """HTTP front door over a :class:`Router` (the fleet's /generate).

    Same threading model as :class:`.server.ServingHTTPServer`:
    one cheap parked handler thread per in-flight client request; the
    router decides placement, retry, and hedging underneath it.

    Endpoints:
      POST /generate   tenant-fairness gate (weighted token bucket; an
                       over-budget tenant gets **429** with its own
                       honest Retry-After) then forwarded to the
                       least-loaded healthy replica (idempotency key
                       injected when absent; retried / hedged
                       transparently).  Body may carry ``"tenant"``
                       (str ≤64) and ``"priority"`` (validated on the
                       replica) alongside the prompt
      GET  /healthz    fleet view: per-replica states + aggregates
                       (utilization, per-tenant admission stats)
      GET  /replicas   the replica registry document alone
      GET  /fleet      the autoscaler's control-loop document (only
                       when the server was built with a fleet source —
                       a fleet autoscaler)
      GET  /decisions  the cluster-brain decision audit log
                       (``?since=N&limit=M`` incremental export —
                       autoscaler verdicts, preemption chains, tenant
                       rejections; always on)
      GET  /incidents  incident forensics over the fleet plane:
                       decision chains (preemption / scale episodes)
                       joined with the event ring into postmortem
                       timelines (``?limit=N``; always on — see
                       telemetry.forensics)
      GET  /traces     per-trace summaries, slowest first (dmlc-top's
                       traces pane; ``DMLC_TRACE_FLEET=1``)
      GET  /trace      the merged fleet Chrome trace (router +
                       replica spans joined by trace id, with
                       ``ph:"s"/"f"`` flow arrows)
      GET  /trace/<id> one request's cross-process causal timeline
                       as JSON (spans + linked decisions)
      GET  /metrics    router-process Prometheus exposition plus the
                       hand-rendered per-replica ``dmlc_router_replica_*``
                       and per-tenant ``dmlc_tenant_*`` labeled families
                       (+ ``dmlc_fleet_*`` when a fleet source is wired)
    """

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0, fleet_source=None):
        rt = router

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, ctype: str, body: bytes,
                      extra_headers=None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _answer(self, code: int, doc, extra_headers=None) -> None:
                telemetry.inc("router", _ROUTER_STATUS_COUNTERS.get(
                    code, "http_other"))
                self._send(code, "application/json",
                           json.dumps(doc).encode(),
                           extra_headers=extra_headers)

            def _qs_int(self, key: str, default: int) -> int:
                _, _, qs = self.path.partition("?")
                for part in qs.split("&"):
                    k, _, v = part.partition("=")
                    if k == key:
                        try:
                            return int(v)
                        except ValueError:
                            return default
                return default

            def do_GET(self):  # noqa: N802 - http.server API
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    text = (telemetry.to_prometheus_text()
                            + rt.prometheus_text()
                            + rt.tenants.prometheus_text())
                    if fleet_source is not None:
                        try:
                            text += fleet_source().prometheus_text()
                        except Exception as e:  # noqa: BLE001 - no 500s
                            logger.warning(
                                "/metrics fleet render failed: %r", e)
                    self._send(200,
                               "text/plain; version=0.0.4; charset=utf-8",
                               text.encode())
                elif path == "/healthz":
                    st = rt.stats()
                    status = "ok" if st["healthy"] else "degraded"
                    self._send(200, "application/json",
                               json.dumps({"status": status,
                                           **st}).encode())
                elif path == "/replicas":
                    self._send(200, "application/json",
                               json.dumps(rt.replica_views()).encode())
                elif path == "/fleet" and fleet_source is not None:
                    try:
                        doc = fleet_source().report()
                        # per-replica availability ledgers captured by
                        # the health poller: the audit trail scaling
                        # decisions are judged against (capacity-tokens
                        # vs. tokens actually served)
                        doc["replica_availability"] = {
                            v["url"]: v.get("availability")
                            for v in rt.replica_views()}
                        body = json.dumps(doc).encode()
                    except Exception as e:  # noqa: BLE001 - no 500s
                        logger.warning("/fleet render failed: %r", e)
                        self._send(503, "text/plain",
                                   b"fleet render failed\n")
                        return
                    self._send(200, "application/json", body)
                elif path == "/incidents":
                    # fleet-plane forensics: preemption / scale decision
                    # chains joined with the event ring (the router has
                    # no goodput aggregator — the tracker's /incidents
                    # adds the training-plane badput intervals)
                    try:
                        from ..telemetry.events import events as _events
                        from ..telemetry.forensics import IncidentReporter
                        rep = IncidentReporter(
                            decisions_source=lambda:
                                tracecontext.decision_log().tail(256),
                            events_source=_events)
                        body = json.dumps(rep.report(
                            self._qs_int("limit", 32))).encode()
                    except Exception as e:  # noqa: BLE001 - no 500s
                        logger.warning("/incidents render failed: %r", e)
                        self._send(503, "text/plain",
                                   b"incidents render failed\n")
                        return
                    self._send(200, "application/json", body)
                elif path == "/decisions":
                    # the cluster-brain audit log: incremental export
                    # with the RequestLedger records_since contract
                    recs, last = tracecontext.decision_log() \
                        .records_since(self._qs_int("since", 0),
                                       self._qs_int("limit", 256))
                    self._send(200, "application/json",
                               json.dumps({"decisions": recs,
                                           "last_seq": last}).encode())
                elif path == "/traces":
                    store = rt.trace_store
                    doc = {"enabled": store is not None, "traces": []}
                    if store is not None:
                        rt.pull_spans_once()
                        doc["traces"] = store.trace_summaries(
                            self._qs_int("limit", 32))
                        doc["sources"] = store.sources()
                    self._send(200, "application/json",
                               json.dumps(doc).encode())
                elif path == "/trace" and rt.trace_store is not None:
                    rt.pull_spans_once()
                    body = json.dumps(
                        rt.trace_store.to_chrome_trace()).encode()
                    self._send(200, "application/json", body)
                elif path.startswith("/trace/") \
                        and rt.trace_store is not None:
                    rt.pull_spans_once()
                    tid = path[len("/trace/"):]
                    body = json.dumps(
                        rt.trace_store.timeline(tid)).encode()
                    self._send(200, "application/json", body)
                else:
                    # GET 404s uncounted: monitors probe optional
                    # endpoints by design (same policy as the replica)
                    self._send(404, "text/plain", b"not found\n")

            def do_POST(self):  # noqa: N802 - http.server API
                path = self.path.split("?", 1)[0]
                if path != "/generate":
                    telemetry.inc("router", "http_404")
                    self._send(404, "text/plain", b"not found\n")
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    if n > MAX_BODY_BYTES:
                        self._answer(400, {"error": "body too large"})
                        return
                    doc = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(doc, dict):
                        raise ValueError("body must be a JSON object")
                    rid = doc.get("request_id")
                    if rid is not None and (not isinstance(rid, str)
                                            or not rid or len(rid) > 128):
                        raise ValueError("request_id must be a non-empty "
                                         "string of at most 128 chars")
                    tenant = doc.get("tenant")
                    if tenant is None:
                        tenant = "default"
                    if (not isinstance(tenant, str) or not tenant
                            or len(tenant) > 64):
                        raise ValueError("tenant must be a non-empty "
                                         "string of at most 64 chars")
                except (ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    self._answer(400, {"error": f"bad request: {e}"})
                    return
                # tenant fairness gate BEFORE placement: an over-budget
                # tenant is rejected here with the honest per-tenant
                # Retry-After (bucket deficit / its own fill rate), so
                # one hot tenant's burst never occupies replica slots
                # other tenants are entitled to
                admitted, retry_s = rt.tenants.admit(tenant)
                if not admitted:
                    fields = {"tenant": tenant,
                              "retry_after_s": round(retry_s, 3)}
                    if tracecontext.enabled():
                        parsed = tracecontext.parse_header(
                            self.headers.get(tracecontext.TRACE_HEADER))
                        rid0 = doc.get("request_id")
                        tid = parsed[0] if parsed else (
                            tracecontext.mint_trace_id(rid0)
                            if rid0 else None)
                        if tid:
                            fields["trace_id"] = tid
                    tracecontext.record_decision("tenant_rejected",
                                                 **fields)
                    self._answer(
                        429, {"error": "tenant over budget",
                              "tenant": tenant},
                        extra_headers={"Retry-After": f"{retry_s:.1f}"})
                    return
                code, out, headers = rt.route(
                    doc, trace_parent=self.headers.get(
                        tracecontext.TRACE_HEADER))
                if code == 200 and isinstance(out, dict):
                    rt.tenants.observe_completion(
                        tenant, int(out.get("n_generated", 0) or 0))
                self._answer(code, out, extra_headers=headers)

            def log_message(self, fmt, *args):
                logger.debug("router http: " + fmt, *args)

        class _Server(ThreadingHTTPServer):
            # a burst of simultaneous client connects (every stream of a
            # load spike at once) overflows the 5-entry default listen
            # backlog and the kernel resets the overflow; size it as the
            # replicas' server does
            daemon_threads = True
            request_queue_size = 128

        self._httpd = _Server((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self.router = router
        # dmlc-check: unguarded(owner-thread close() latch; double shutdown is benign)
        self._closed = False
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="router-http")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        self.router.close()
