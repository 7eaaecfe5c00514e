"""Inference engine: the per-iteration prefill/decode loop.

Port of ``dmlc_tpu/serving/engine.py``: ``_jitted_programs`` (:129-191,
as :func:`_programs`), ``submit``, ``generate``, ``start``, ``close``,
``step``, ``_run_prefill`` (:643), ``_ensure_decode_capacity`` (:716),
``_draft_tokens`` (:754) and ``_run_decode`` (:789-995) on both of its
data paths.  Every iteration admits what fits (prefill runs the
flash-attention kernel) and then runs one decode window for every
active request.  ``DMLC_SERVE_PAGED_ATTN`` picks the path: ``on`` (and
``auto`` without a mesh) reads the pools in place through the
paged-attention kernel; ``off`` (and ``auto`` on a mesh that
``kv_partition_spec`` places the view over, :270-287) gathers each
row's blocks into a dense view (``PagedKVCache.gather``, the ``gather``
phase) and attends it with plain products (``forward_decode`` /
``forward_decode_spec``), then writes each row's committed K/V back.
Sampling is greedy; with ``spec_k > 0`` an n-gram drafter proposes up to
``spec_k`` tokens per row and the longest-accepted-prefix walk keeps the
output identical to plain greedy decoding.

Instrumentation, as the reference's (``dmlc_tpu/serving/engine.py``
:826-995): every decode iteration is a **step** on the process step ledger
(``telemetry.step_begin`` before the window is built, ``step_end`` with
the committed tokens, the exact forward FLOPs of each row's context,
tokens per row and the draft accept rate, after the host commit and
before completions are delivered); every admitted request is tracked by
a :class:`telemetry.RequestLedger` (``engine.requests``: queue wait,
prefill, TTFT, token gaps, preemptions, finish with a reason) that
streams into the :class:`telemetry.SLOMonitor` (``engine.slo``), and an
:class:`telemetry.AvailabilityLedger` (``engine.availability``) splits
the replica's wall into serving / draining / crashed_recovering /
starved_idle.  ``submit(request_id=...)`` is idempotent through a
bounded dedupe table (``DMLC_SERVE_DEDUPE_MAX``); ``begin_drain`` /
``drain`` stop admitting (:class:`EngineDraining`) while in-flight
generations finish.

The compute ledger (``telemetry.compute``) as the reference's: the
prefill and decode programs are its sites ``serving.prefill``,
``serving.decode``, ``serving.decode_spec`` and ``serving.decode_paged``;
each decode step's ledger record carries the site's counted bytes (so
``membw_util`` and the ``bound`` verdict), the step's device time is
split across attention / mlp / unembed by ``decode_phase_flops``, the
host's ``gather`` and ``sampling`` phases are measured, and every 8th
iteration samples the card's memory.

The loop's thread marks its phases with ``serving`` spans, each also a
``torch.profiler`` range while a profiler records (:func:`_phase`):
``serving.iteration`` (one :meth:`InferenceEngine.step`) encloses each
``serving.prefill`` and a decode step's ``serving.decode.build`` (the
window's ids, tables and positions), ``serving.decode.issue`` (the
forward's host issue), ``serving.decode.wait`` (the host's first wait
on the card), ``serving.decode.sample`` (the sampling walk, the cache
commit and the rows' tokens; it is the ``sampling`` phase too) and,
after ``step_end``, ``serving.decode.finish`` (completions, the
registry, the per-iteration record, SLO); ``serving.idle`` is the
loop's sleep when nothing ran.  The step ledger reads them: a decode
step's ``build_s``, ``device_wait_s`` and ``host_issue_s`` (begin until
the wait), and the prefills and idle time between two steps.

Differences from the reference: no jit (PyTorch runs eagerly, so there
are no shape buckets to pin and the decode batch is the live rows only,
with no dead padding rows, though a routed config's expert capacity
counts them); the pools live only on the device.  Because the rows
count is part of a decode site's signature here, each decode site's
cap is ``DMLC_SERVE_MAX_DECODE_SIGS`` signatures per rows count
(``× max_active``): the reference's cap counts (window, width) at its
one padded batch size.  ``stats()`` also keeps plain integer counters
and the kernels' launch counts.

The engine runs on the CUDA card unless the caller passes
``device="cpu"`` (the tests do); with no card and no device it raises.

Sharded serving (``mesh=``, any pp × dp × sp × ep × tp mesh over
``torch.distributed`` whose model ``shard_params_from_jax`` built):
every rank builds the engine on the same arguments and holds pools of
its own heads of its pp stage's layers; the programs shard over every
axis wider than one rank but sp, which replicates them
(``serving_axes``), and ``auto`` picks the data path by
``kv_partition_spec`` as the reference's does (pp2 alone runs paged,
pp2 × tp2 gathers).  Rank 0
is the controller, single as the reference's is: the scheduler, the
allocator, sampling and the clients (``submit``, ``start``, the HTTP
server) live there.  Each iteration it broadcasts a plan of its device
work (a prefill's ids and cache addresses; a decode window's ids,
positions, block tables or gather indices and lengths; the committed
K/V's addresses) and carries it out itself, while every other rank runs
:meth:`InferenceEngine.follow`, which carries out each plan on its own
pools.  On the gather path the batch is padded to ``max_active``
(:799) and split over dp (``shard_gathered``, :850-851), a routed FFN
still routing the whole batch; the paged program runs it whole on every
dp rank.  On a pp mesh each stage runs its layers on the previous
stage's output and the last stage's logits are broadcast over pp.
``close()`` (and so ``drain()``) ends the followers; an idle controller
sends an empty plan every second.  On a mesh an iteration that raises
breaks the gang: its collectives cannot be resumed, so the controller
fails every pending request and destroys the process groups, which ends
any rank waiting in one (a follower that fails does the same and
raises).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from .. import concurrency, telemetry
from ..base import DMLCError, get_env, resolve_device
from ..concurrency import make_lock
from ..models.transformer import (Transformer, check_serving_mesh,
                                  decode_flops_per_token,
                                  decode_phase_flops, forward_decode,
                                  forward_decode_paged, forward_decode_spec,
                                  forward_prefill_last, serving_axes)
from ..ops.flash_attention import FLASH_FWD
from ..ops.paged_attention import PAGED_ATTENTION
from ..parallel.collectives import broadcast_object
from .kv_cache import PagedKVCache, kv_partition_spec
from .scheduler import (ACTIVE, WAITING, AlreadyFinished,
                        ContinuousBatchScheduler, Request, coerce_priority)

__all__ = ["InferenceEngine", "AdmissionFull", "RequestTooLarge",
           "EngineDraining", "resolve_device", "kernel_launches"]

logger = logging.getLogger("dmlc_tpu_torch.serving")

#: seconds an idle sharded controller waits before it sends an empty
#: plan, so a follower's wait for the next plan never reaches the
#: process group's timeout
_IDLE_PLAN_S = 1.0


def _phase(name: str):
    """One phase of the loop's iteration: a ``serving`` span on the
    ring and, while a profiler records, a profiler range."""
    return telemetry.span(name, stage="serving", profile=True)


class AdmissionFull(DMLCError):
    """The admission queue stayed full past the timeout (HTTP 429)."""


class RequestTooLarge(DMLCError):
    """The request could never fit the KV pool, even alone (HTTP 413)."""


class EngineDraining(DMLCError):
    """The engine stopped admitting (SIGTERM drain); HTTP 503 +
    Retry-After — in-flight generations keep decoding to completion."""


def kernel_launches() -> Dict[str, int]:
    """Process-wide launch counts of the kernels the serving path runs."""
    return {"flash_fwd": FLASH_FWD.launches,
            "paged_attention": PAGED_ATTENTION.launches}


class _DedupeTable:
    """Idempotency-key table: client ``request_id`` → :class:`Request`.

    A duplicate submission while the original is live returns the SAME
    request (the second waiter parks on it), and a duplicate after a
    successful finish returns the finished request from a bounded ring
    (``DMLC_SERVE_DEDUPE_MAX``) instead of generating again.  FAILED
    requests are dropped from the table: a retry of a failed id is a
    fresh attempt."""

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._lock = make_lock("_DedupeTable._lock")
        self._live: dict = {}
        self._done: dict = {}
        self._order: deque = deque()

    def get(self, key: str) -> Optional[Request]:
        with self._lock:
            return self._live.get(key) or self._done.get(key)

    def claim(self, key: str, req: Request) -> Request:
        """Publish ``req`` under ``key`` unless a concurrent submit got
        there first; returns whichever request owns the key."""
        with self._lock:
            prior = self._live.get(key) or self._done.get(key)
            if prior is not None:
                return prior
            self._live[key] = req
            return req

    def drop(self, key: str, req: Request) -> None:
        """Un-publish after a failed admission/finish — only if the
        mapping is still ours (a fresh retry may have re-claimed)."""
        with self._lock:
            if self._live.get(key) is req:
                del self._live[key]

    def finish(self, key: str, req: Request) -> None:
        """Move a successfully finished request into the bounded ring."""
        with self._lock:
            if self._live.get(key) is not req:
                return
            del self._live[key]
            self._done[key] = req
            self._order.append(key)
            while len(self._order) > self.capacity:
                self._done.pop(self._order.popleft(), None)


class _Slots:
    """Admission slots: a bounded counter whose ``kill`` wakes waiters."""

    def __init__(self, n: int):
        self._free = int(n)
        self._dead = False
        self._cv = threading.Condition(make_lock("_Slots._cv"))

    def acquire(self, timeout: Optional[float]) -> bool:
        with self._cv:
            # dmlc-check: guarded-by(_cv) -- wait_for calls it under _cv
            self._cv.wait_for(lambda: self._dead or self._free > 0, timeout)
            if self._dead or self._free <= 0:
                return False
            self._free -= 1
            return True

    def release(self) -> None:
        with self._cv:
            self._free += 1
            self._cv.notify()

    def kill(self) -> None:
        with self._cv:
            self._dead = True
            self._cv.notify_all()


_PROGRAMS: Dict[tuple, object] = {}


def _programs(use_paged: bool, window: int, max_active: int):
    """Process-wide prefill and decode programs: the compute ledger's
    sites, one wrapper per program variant so every engine of the
    process shares one signature ledger (and one cost pass a
    signature).  The decode program is the gather path's
    ``forward_decode`` (site ``serving.decode``) or its window twin
    ``forward_decode_spec`` (``serving.decode_spec``), or the paged
    ``forward_decode_paged`` (``serving.decode_paged``; the window is a
    shape).  Under ``DMLC_COMPUTE_PROFILE=0`` they are the plain
    functions; the cache is keyed on that mode, and on the function
    this module names at the engine's construction.  A decode site's
    cap is ``DMLC_SERVE_MAX_DECODE_SIGS`` per rows count (see the module
    docstring), so its wrapper is keyed on ``max_active`` too; the
    engine passes ``route_tokens`` (``max_active`` times the window) by
    keyword, outside the signature, which it does not change."""
    compute = telemetry.compute
    mode = "profiled" if compute.enabled() else "plain"
    if use_paged:
        fn, site = forward_decode_paged, "serving.decode_paged"
    elif window > 1:
        fn, site = forward_decode_spec, "serving.decode_spec"
    else:
        fn, site = forward_decode, "serving.decode"
    prefill_key = (mode, "serving.prefill", forward_prefill_last)
    decode_key = (mode, site, fn, max_active)
    if prefill_key not in _PROGRAMS or decode_key not in _PROGRAMS:
        # this cache outlives any one engine: when an interleaving
        # scenario (analysis.scenarios) builds the process's first
        # engine for a key, the sites must not capture the scenario's
        # scheduler-owned locks, or every later engine of that key would
        # inherit a lock wired to a finished controller
        prev_hook = concurrency._lock_factory_hook
        concurrency.set_lock_factory_hook(None)
        try:
            if prefill_key not in _PROGRAMS:
                _PROGRAMS[prefill_key] = compute.profiled_site(
                    forward_prefill_last, site="serving.prefill")
            if decode_key not in _PROGRAMS:
                _PROGRAMS[decode_key] = compute.profiled_site(
                    fn, site=site, max_signatures=get_env(
                        "DMLC_SERVE_MAX_DECODE_SIGS", 64) * max_active)
        finally:
            concurrency.set_lock_factory_hook(prev_hook)
    progs = (_PROGRAMS[prefill_key], _PROGRAMS[decode_key])
    for prog in progs:
        rereg = getattr(prog, "reregister", None)
        if rereg is not None:
            rereg()
    return progs


class InferenceEngine:
    """Continuous-batching generation over one model replica.

    Defaults come from the reference's ``DMLC_SERVE_*`` knobs
    (``MAX_ACTIVE``, ``KV_BLOCKS``, ``KV_BLOCK_SIZE``, ``QUEUE_DEPTH``,
    ``ADMIT_TIMEOUT_S``, ``MAX_TOKENS``, ``SPEC_K``, ``SPEC_MIN_CTX``,
    ``CRASH_REQUEUE_MAX``, ``DEDUPE_MAX``, ``DRAIN_S``); the SLO
    objectives from ``DMLC_SLO_*`` (the process-default monitor unless
    ``slo_monitor`` is given)."""

    def __init__(self, model: Transformer, *, device=None, mesh=None,
                 n_blocks: Optional[int] = None,
                 block_size: Optional[int] = None,
                 max_active: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 admit_timeout_s: Optional[float] = None,
                 max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 spec_k: Optional[int] = None,
                 slo_monitor=None):
        if mesh is not model.mesh:
            raise DMLCError("the model's parameters were not built for "
                            "this mesh (shard_params_from_jax builds them)")
        check_serving_mesh(model.cfg, mesh)
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        if model.device != self.device:
            raise DMLCError(f"model is on {model.device}, engine on "
                            f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        self.mesh = mesh
        # the programs' shard axes: those of the mesh's that are wider
        # than one rank, sp aside (serving_axes)
        self._gang = mesh is not None and mesh.world > 1
        self._fwd = {} if not self._gang else {"mesh": mesh,
                                               "axes": serving_axes(mesh)}
        self.is_controller = mesh is None or mesh.rank == 0
        # dmlc-check: unguarded(engine thread sets it; close() reads it after the join)
        self._gang_ended = False
        # dmlc-check: unguarded(engine-thread-confined; close() sends only after joining it)
        self._last_plan_t = time.monotonic()
        # dmlc-check: unguarded(engine-thread-confined)
        self._window_kv = None   # the last gather window's K/V
        self.max_active = (max_active if max_active is not None
                           else get_env("DMLC_SERVE_MAX_ACTIVE", 8))
        self.admit_timeout_s = (
            admit_timeout_s if admit_timeout_s is not None
            else get_env("DMLC_SERVE_ADMIT_TIMEOUT_S", 2.0))
        self.default_max_new_tokens = (
            max_new_tokens if max_new_tokens is not None
            else get_env("DMLC_SERVE_MAX_TOKENS", 64))
        self.eos_id = eos_id
        # priority classes: admission order and KV-pressure eviction
        # both prefer low-priority victims (scheduler policy); the class
        # count and the unlabeled default are knobs, clamped as in the
        # JAX engine
        self.priority_levels = max(1, get_env(
            "DMLC_SERVE_PRIORITY_LEVELS", 3))
        self.priority_default = min(
            max(0, get_env("DMLC_SERVE_PRIORITY_DEFAULT", 1)),
            self.priority_levels - 1)
        with torch.inference_mode():
            self.cache = PagedKVCache(
                self.cfg.n_layers, self.cfg.n_heads, self.cfg.head_dim,
                n_blocks=(n_blocks if n_blocks is not None
                          else get_env("DMLC_SERVE_KV_BLOCKS", 256)),
                block_size=(block_size if block_size is not None
                            else get_env("DMLC_SERVE_KV_BLOCK_SIZE", 16)),
                dtype=self.cfg.torch_dtype, device=self.device, mesh=mesh)
        self.scheduler = ContinuousBatchScheduler(
            self.cache, max_active=self.max_active)
        self._slots = _Slots(queue_depth if queue_depth is not None
                             else get_env("DMLC_SERVE_QUEUE_DEPTH", 64))
        self.spec_k = max(0, int(spec_k if spec_k is not None
                                 else get_env("DMLC_SERVE_SPEC_K", 0)))
        self.spec_min_ctx = max(1, get_env("DMLC_SERVE_SPEC_MIN_CTX", 4))
        self._spec_window = 1 + self.spec_k
        # the decode data path: "auto" is the paged path, except where
        # the mesh places the gathered view over dp/tp (:282-287)
        sharded = mesh is not None and kv_partition_spec(mesh) is not None
        self.paged_mode = str(get_env("DMLC_SERVE_PAGED_ATTN",
                                      "auto")).lower()
        if self.paged_mode not in ("auto", "on", "off"):
            raise ValueError(
                f"DMLC_SERVE_PAGED_ATTN must be auto|on|off, got "
                f"{self.paged_mode!r}")
        if self.paged_mode == "auto":
            self._use_paged = not sharded
        else:
            self._use_paged = self.paged_mode == "on"
        self._prefill, self._decode = _programs(
            self._use_paged, self._spec_window, self.max_active)
        # dmlc-check: unguarded(engine-thread-confined)
        self._hbm_tick = 0
        self._crash_requeue_max = get_env("DMLC_SERVE_CRASH_REQUEUE_MAX", 2)
        # request-scoped observability: the per-request lifecycle ledger
        # (/requests) feeding the SLO burn-rate monitor (/slo), and the
        # availability ledger; a replica is idle until its loop works
        self.slo = (slo_monitor if slo_monitor is not None
                    else telemetry.slo.monitor())
        self.requests = telemetry.RequestLedger(slo=self.slo)
        self.availability = telemetry.AvailabilityLedger()
        self.availability.set_state("starved_idle")
        self._dedupe = _DedupeTable(get_env("DMLC_SERVE_DEDUPE_MAX", 512))
        self._stop = threading.Event()
        self._draining = threading.Event()
        # iteration seqlock: odd while an iteration is mid-flight (its
        # pop window can hold a request in NEITHER queue), even when
        # quiescent; single writer (the engine thread), read by drain()
        # dmlc-check: unguarded(seqlock: single-writer engine thread; GIL-atomic int reads)
        self._step_seq = 0
        # dmlc-check: unguarded(start/close control-thread lifecycle; close joins before the sweep)
        self._thread: Optional[threading.Thread] = None
        # dmlc-check: unguarded(engine-thread-confined)
        self._flops_declared = False
        # the open serving.idle span of the loop's current idle stretch
        # dmlc-check: unguarded(engine-thread-confined)
        self._idle = None
        # dmlc-check: unguarded(engine-thread-confined)
        self._fpt_cache: Dict[int, float] = {}   # context → FLOPs/token
        # dmlc-check: unguarded(engine-thread writes; stats() copies, a count may lag a step)
        self.counters = {"prefills": 0, "decode_steps": 0,
                         "tokens_generated": 0, "spec_proposed": 0,
                         "spec_accepted": 0, "preemptions": 0,
                         "crash_requeues": 0}

    # ---- client surface -------------------------------------------------
    def submit(self, prompt_ids: List[int],
               max_new_tokens: Optional[int] = None,
               timeout: Optional[float] = None,
               request_id: Optional[str] = None,
               priority=None, tenant: Optional[str] = None,
               trace_id: Optional[str] = None) -> Request:
        """Admit a request or raise: :class:`AdmissionFull` when no queue
        slot frees within ``timeout`` (default ``admit_timeout_s``),
        :class:`RequestTooLarge` when it could never fit the pool,
        :class:`EngineDraining` while draining, ``ValueError`` for bad
        ids, priority or tenant.

        ``request_id`` is the client's idempotency key: a duplicate of a
        live request, or of a successfully finished one still in the
        dedupe ring, returns the ORIGINAL request instead of generating
        again.  The lookup runs before the drain gate, so a retry of
        already-admitted work resolves on a draining replica too.
        ``tenant`` labels the request; ``trace_id`` (the X-DMLC-Trace
        context) stamps it and its ledger rows."""
        t_submit = time.perf_counter()
        if not self.is_controller:
            raise DMLCError("requests go to rank 0, the sharded engine's "
                            "controller")
        if request_id is not None:
            if (not isinstance(request_id, str) or not request_id
                    or len(request_id) > 128):
                raise ValueError("request_id must be a non-empty string "
                                 "of at most 128 chars")
            prior = self._dedupe.get(request_id)
            if prior is not None:
                telemetry.inc("serving", "dedupe_hits")
                return prior
        if self._draining.is_set():
            raise EngineDraining(
                "engine is draining (shutdown notice); retry against "
                "another replica")
        mnt = (max_new_tokens if max_new_tokens is not None
               else self.default_max_new_tokens)
        prio = coerce_priority(priority, self.priority_levels,
                               self.priority_default)
        if tenant is None:
            tenant = "default"
        elif (not isinstance(tenant, str) or not tenant
                or len(tenant) > 64):
            raise ValueError("tenant must be a non-empty string of at "
                             "most 64 chars")
        req = Request(prompt_ids, mnt, eos_id=self.eos_id, priority=prio,
                      tenant=tenant)
        req.client_id = request_id
        if trace_id is not None:
            req.trace_id = str(trace_id)
        if any(t < 0 or t >= self.cfg.vocab for t in req.prompt_ids):
            raise ValueError(
                f"prompt ids out of range for vocab {self.cfg.vocab}")
        # spec decode reserves a whole verify window ahead of each step
        if not self.cache.fits_at_all(req.n_prompt + mnt + self.spec_k):
            raise RequestTooLarge(
                f"request needs up to {req.n_prompt + mnt + self.spec_k} "
                f"cached tokens; cache holds "
                f"{self.cache.n_blocks * self.cache.block_size}")
        if request_id is not None:
            # publish BEFORE the slot wait so a concurrent duplicate parks
            # on this request instead of racing it into a second one
            claimed = self._dedupe.claim(request_id, req)
            if claimed is not req:
                telemetry.inc("serving", "dedupe_hits")
                return claimed
        if not self._slots.acquire(
                self.admit_timeout_s if timeout is None else timeout):
            telemetry.inc("serving", "rejected")
            if request_id is not None:
                # un-publish so a later retry is a fresh attempt, and wake
                # any duplicate that parked during the slot wait
                self._dedupe.drop(request_id, req)
                req.rejected_busy = True
                req.reject("admission queue full; retry later")
            raise AdmissionFull("admission queue full; retry later")
        req.slot_held = True
        telemetry.inc("serving", "requests")
        # the ledger entry opens at the submit stamp, so queue_s includes
        # the admission-slot wait a saturated server imposes
        self.requests.on_submit(req.id, req.n_prompt, mnt, t=t_submit,
                                trace_id=req.trace_id)
        self.scheduler.enqueue(req)
        if self._stop.is_set():
            # close() may have swept between the acquire and the enqueue
            try:
                self._finish(req, error="engine shut down",
                             reason="shutdown")
            except AlreadyFinished:
                pass
            raise DMLCError("engine shut down")
        return req

    def generate(self, prompt_ids: List[int],
                 max_new_tokens: Optional[int] = None,
                 timeout: float = 120.0) -> List[int]:
        """Blocking convenience: submit, wait, return generated ids."""
        req = self.submit(prompt_ids, max_new_tokens)
        if not req.wait(timeout):
            raise DMLCError(f"request {req.id} timed out after {timeout}s")
        if req.error:
            raise DMLCError(f"request {req.id} failed: {req.error}")
        return list(req.generated)

    # ---- engine loop ----------------------------------------------------
    def start(self) -> None:
        if not self.is_controller:
            raise DMLCError("a follower rank of a sharded engine runs "
                            "follow(), not start()")
        if self._thread is not None and self._thread.is_alive():
            return
        if self._stop.is_set():
            raise DMLCError("engine is closed")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-engine")
        self._thread.start()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def begin_drain(self) -> None:
        """Stop admitting; the decode loop keeps running so active (and
        already-queued) generations finish."""
        if not self._draining.is_set():
            self._draining.set()
            self.availability.set_state("draining")
            telemetry.set_gauge("serving", "draining", 1)
            active, waiting = self.scheduler.counts()
            telemetry.record_event("serving_drain_begin", active=active,
                                   waiting=waiting)

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting, finish every in-flight
        generation within ``timeout_s`` (``DMLC_SERVE_DRAIN_S``, default
        30), then close.  Returns True when the backlog fully drained,
        False when the deadline cut it off (close() fails the rest)."""
        t = (timeout_s if timeout_s is not None
             else get_env("DMLC_SERVE_DRAIN_S", 30.0))
        self.begin_drain()
        deadline = time.monotonic() + t
        # "drained" is judged on a consistent cut: queue membership from
        # one lock hold, and the step seqlock covers a request popped by
        # next_prefill but not yet activated (in neither queue): either a
        # read is odd or the two reads differ, and both retry
        while True:
            s1 = self._step_seq
            active, waiting = self.scheduler.counts()
            s2 = self._step_seq
            if not active and not waiting and s1 == s2 and s1 % 2 == 0:
                break
            if time.monotonic() > deadline:
                logger.warning(
                    "drain deadline (%.1fs) hit with %d active / %d "
                    "waiting; failing the rest", t, active, waiting)
                self.close()
                telemetry.record_event("serving_drain_end", clean=False)
                return False
            time.sleep(0.02)
        self.close()
        telemetry.record_event("serving_drain_end", clean=True)
        return True

    def close(self) -> None:
        """Stop the loop, fail whatever is still queued or active, and
        wake blocked submitters."""
        self._stop.set()
        self._slots.kill()
        t = self._thread
        if t is not None:
            t.join(timeout=60.0)
            if t.is_alive():
                logger.error("engine thread still running after 60s; "
                             "skipping the shutdown sweep")
                return
            self._thread = None
        for req in self.scheduler.all_pending():
            try:
                self._finish(req, error="engine shut down",
                             reason="shutdown")
            except AlreadyFinished:
                pass
        if self._gang and self.is_controller and not self._gang_ended:
            # the followers return from follow()
            self._gang_ended = True
            try:
                self._send({"op": "stop"})
            except (EngineDraining, AlreadyFinished):
                raise              # a request's state, never the gang's
            except RuntimeError:   # a follower is gone: no rank waits
                logger.exception("sharded serving: stopping the followers")
                _destroy_groups()

    # ---- the sharded gang -----------------------------------------------
    def _send(self, plan: dict) -> None:
        """Broadcast ``plan`` to the followers (a no-op off a mesh)."""
        if self._gang:
            broadcast_object(plan, mesh=self.mesh)
            self._last_plan_t = time.monotonic()

    def _run(self, plan: dict):
        """Send ``plan`` and carry it out here."""
        self._send(plan)
        return self._exec(plan)

    def _exec(self, plan: dict):
        """The device half of an iteration, the same on the controller
        and on every follower, on this rank's pools: ``prefill`` (the
        prefill program, its K/V written at the plan's addresses;
        returns the last position's logits), ``paged`` (the paged decode
        program; returns its logits), ``gather`` (the dense view, this
        rank's share of it, the gather program; returns logits, k_new
        and v_new, every window as ``[B, S, ...]``) and ``commit`` (the
        last gather window's committed rows written at the plan's
        addresses)."""
        op, dev, fwd = plan["op"], self.device, self._fwd
        if op == "prefill":
            n = plan["n"]
            logits, k, v = self._prefill(
                self.model, plan["ids"].to(dev),
                torch.tensor([n - 1], device=dev), **fwd)
            self.cache.scatter(plan["blk"], plan["slot"], k[:, 0, :n],
                               v[:, 0, :n])
            return logits
        if op == "commit":
            k_new, v_new = self._window_kv
            rows = plan["rows"]
            self.cache.scatter(
                plan["blk"], plan["slot"],
                torch.cat([k_new[:, i, :n] for i, n in rows], dim=1),
                torch.cat([v_new[:, i, :n] for i, n in rows], dim=1))
            return None
        ids, positions = plan["ids"].to(dev), plan["positions"].to(dev)
        lengths = plan["lengths"].to(dev)
        if op == "paged":
            return self._decode(
                self.model, ids, positions, self.cache.k_pool,
                self.cache.v_pool, plan["tables"].to(dev), lengths,
                route_tokens=plan["route"], **fwd)
        with telemetry.compute.phase("gather"):
            k, v = self.cache.shard_gathered(
                *self.cache.dense(plan["idx"], plan["valid"]))
        if ids.shape[1] > 1:
            out = self._decode(self.model, ids, positions, k, v, lengths,
                               route_tokens=plan["route"], **fwd)
        else:
            logits, k_new, v_new = self._decode(
                self.model, ids[:, 0], positions[:, 0], k, v, lengths,
                route_tokens=plan["route"], **fwd)
            # the single-token program's [B, V] logits, [L, B, H, D]
            out = logits[:, None], k_new[:, :, None], v_new[:, :, None]
        self._window_kv = out[1:]
        return out

    def follow(self) -> None:
        """A follower rank's side of a sharded engine: carry out each
        plan the controller broadcasts until it ends the gang (``close``
        returns from here).  A failure destroys this rank's process
        groups, so no rank waits on it, and raises."""
        if not self._gang or self.is_controller:
            raise DMLCError("follow() runs on a follower rank (rank > 0) "
                            "of a sharded engine")
        try:
            with torch.inference_mode():
                while True:
                    plan = broadcast_object(mesh=self.mesh)
                    if plan["op"] == "stop":
                        return
                    if plan["op"] != "idle":
                        self._exec(plan)
        except Exception:
            _destroy_groups()
            raise

    def _break_gang(self, e: BaseException) -> None:
        """An iteration of a sharded engine raised: fail every pending
        request, stop admitting, and destroy the process groups so a
        follower waiting in a collective fails too."""
        logger.exception("sharded serving: the gang failed")
        self._gang_ended = True
        self._stop.set()
        self._slots.kill()
        for req in self.scheduler.all_pending():
            try:
                self._finish(req, error=f"sharded serving gang failed: "
                             f"{e!r}", reason="crash")
            except AlreadyFinished:
                pass
        self.availability.set_state("crashed_recovering")
        _destroy_groups()

    def _loop(self) -> None:
        while not self._stop.is_set():
            crashed = False
            try:
                did = self.step()
                if (not did and self._gang and time.monotonic()
                        - self._last_plan_t > _IDLE_PLAN_S):
                    self._send({"op": "idle"})
            except Exception as e:  # noqa: BLE001 - the loop must not die
                if self._gang:
                    self._end_idle()
                    self._break_gang(e)
                    return
                crashed = True
                # the active set's cache state is unknown after a crash,
                # its output is not: requeue each for recompute-resume
                # (bounded per request), fail it past the budget
                logger.exception("serving iteration failed")
                for req in self.scheduler.active_requests():
                    if (req.crash_requeues < self._crash_requeue_max
                            and self.scheduler.requeue_active(req)):
                        self.counters["crash_requeues"] += 1
                        telemetry.inc("serving", "crash_requeues")
                        self.requests.on_preempt(req.id)
                        continue
                    try:
                        self._finish(
                            req, error=f"engine iteration failed: {e!r}",
                            reason="crash")
                    except AlreadyFinished:
                        pass
                did = False
            # draining wins (work still finishes during a drain), then
            # crash recovery, then serving vs idle; set_state is a no-op
            # when the state is unchanged
            if self._draining.is_set():
                self.availability.set_state("draining")
            elif crashed:
                self.availability.set_state("crashed_recovering")
            elif did:
                self.availability.set_state("serving")
            else:
                self.availability.set_state("starved_idle")
            if not did:
                # idle: the SLO windows keep aging, so evaluation keeps
                # running (throttled inside); one serving.idle span
                # covers the stretch, closed when work comes
                self.slo.maybe_evaluate()
                if self._idle is None:
                    self._idle = _phase("serving.idle")
                    self._idle.__enter__()
                time.sleep(0.002)
        self._end_idle()

    def _end_idle(self) -> None:
        if self._idle is not None:
            self._idle.__exit__(None, None, None)
            self._idle = None

    # ---- one iteration --------------------------------------------------
    def step(self) -> bool:
        """Admit every prefill that fits (up to ``max_active``), then run
        one decode window for every active request.  Returns whether any
        work happened.  Public so tests can single-step the engine."""
        self._step_seq += 1
        try:
            if not any(self.scheduler.counts()):
                return False
            self._end_idle()
            with torch.inference_mode(), _phase("serving.iteration"):
                did = False
                while True:
                    req = self.scheduler.next_prefill()
                    if req is None:
                        break
                    self._run_prefill(req)
                    did = True
                    if req.state == WAITING:
                        break  # allocate lost a race; retry next iteration
                active = self.scheduler.active_requests()
                if active:
                    self._run_decode(active)
                    did = True
                return did
        finally:
            self._step_seq += 1

    def _finish(self, req: Request, error: Optional[str] = None,
                reason: Optional[str] = None) -> None:
        self.scheduler.finish(req, error=error)
        # scheduler.finish raising AlreadyFinished above is the
        # exactly-once guard for the ledger too
        self.requests.on_finish(req.id, error=error, reason=reason)
        if req.client_id is not None:
            if error:
                # a retry of a FAILED request is a fresh attempt
                self._dedupe.drop(req.client_id, req)
            else:
                self._dedupe.finish(req.client_id, req)
        if req.latency_s is not None:
            telemetry.observe_duration("serving", "latency", req.latency_s)
        tps = req.decode_tokens_per_s
        if tps is not None:
            telemetry.set_gauge("serving", "tokens_per_s_per_user", tps)
        if req.slot_held:
            req.slot_held = False
            self._slots.release()

    def _run_prefill(self, req: Request) -> None:
        """Prefill ``req``'s context into the pools.  A fresh request
        samples its first token here (its TTFT); a preemption resume
        does not (its context already excludes the un-consumed last
        token, which the next decode step consumes)."""
        ctx = req.context_ids()
        n = len(ctx)
        bs = self.cache.block_size
        if not self.cache.allocate(req.id, n):
            self.scheduler.requeue_front(req)
            return
        resume = bool(req.generated)
        try:
            padded = n + (-n % bs)   # the kernel's tail mask keeps this safe
            ids = torch.zeros((1, padded), dtype=torch.long)
            ids[0, :n] = torch.tensor(ctx, dtype=torch.long)
            t0 = time.perf_counter()
            self.requests.on_prefill_begin(req.id, t=t0, resume=resume)
            with telemetry.span("serving.prefill", stage="serving",
                                args={"tokens": n, "req": req.id},
                                profile=True):
                blk, slot = self.cache.reserve(req.id, n, start=0)
                logits = self._run({"op": "prefill", "ids": ids, "n": n,
                                    "blk": blk, "slot": slot})
                logits = logits[0].float().cpu()   # waits for the card
            telemetry.observe_duration("serving", "prefill",
                                       time.perf_counter() - t0)
            telemetry.inc("serving", "prefill_tokens", n)
        except Exception as e:  # noqa: BLE001 - fail THIS request only
            if self._gang:
                raise   # the gang's collectives are out of step
            logger.exception("prefill of request %d failed", req.id)
            self._finish(req, error=f"prefill failed: {e!r}",
                         reason="prefill")
            return
        self.counters["prefills"] += 1
        if not resume:
            if not bool(torch.isfinite(logits).all()):
                telemetry.inc("serving", "nonfinite_failures")
                self._finish(req, error="non-finite logits during prefill "
                             "(numeric corruption); retry the request",
                             reason="nonfinite")
                return
            next_id = int(torch.argmax(logits))
            req.generated.append(next_id)
            self.counters["tokens_generated"] += 1
            telemetry.inc("serving", "tokens_generated")
            req.ttft_s = time.monotonic() - req.submit_t
            telemetry.observe_duration("serving", "ttft", req.ttft_s)
            # the ledger's TTFT moment: ttft_s = queue_s + prefill_s
            self.requests.on_first_token(req.id)
            if req.is_finished_by(next_id):
                self._finish(req)
                return
        else:
            # the resume re-cached its context without sampling; decode
            # resumes from generated[-1] next iteration
            self.requests.on_prefill_end(req.id)
        self.scheduler.activate(req)

    def _ensure_decode_capacity(self, active: List[Request],
                                n_tokens: int = 1) -> tuple:
        """Reserve ``n_tokens`` more slots per active request, preempting
        youngest-first under pressure; returns ``(survivors,
        n_preempted)``."""
        if active and self.cache.extend_many([r.id for r in active],
                                             n_tokens):
            return list(active), 0
        alive = []
        n_preempted = 0
        for req in active:
            if req.state != ACTIVE:
                continue  # a preemption below already took it out
            while not self.cache.extend(req.id, n_tokens):
                victim = self.scheduler.preempt_youngest()
                if victim is not None:
                    n_preempted += 1
                    self.counters["preemptions"] += 1
                    telemetry.inc("serving", "preemptions")
                    self.requests.on_preempt(victim.id)
                if victim is None:
                    self._finish(req, error="kv cache exhausted with "
                                 "nothing left to evict",
                                 reason="kv_exhausted")
                    break
                if victim is req:
                    break  # preempted itself; resumes via re-prefill
            else:
                alive.append(req)
        # a later request's eviction can preempt an earlier survivor
        return [r for r in alive if r.state == ACTIVE], n_preempted

    def _draft_tokens(self, req: Request) -> List[int]:
        """n-gram drafter: the longest (3→1) suffix of prompt+generated
        that recurs earlier in the context predicts what followed its
        previous occurrence.  No proposal below ``spec_min_ctx`` tokens."""
        ctx = list(req.prompt_ids) + list(req.generated)
        n = len(ctx)
        if n < self.spec_min_ctx:
            return []
        try:
            text = "".join(map(chr, ctx))   # C-speed rfind over ids
        except ValueError:
            text = None
        for m in (3, 2, 1):
            if n <= m:
                continue
            if text is not None:
                p = text.rfind(text[n - m:], 0, n - 1)
            else:
                suffix = ctx[-m:]
                p = next((s for s in range(n - m - 1, -1, -1)
                          if ctx[s:s + m] == suffix), -1)
            if p >= 0:
                return ctx[p + m:p + m + self.spec_k]
        return []

    def _run_decode(self, active: List[Request]) -> None:
        s_w = self._spec_window
        active, n_preempted = self._ensure_decode_capacity(active, s_w)
        if not active:
            if n_preempted:
                self.requests.on_iteration(
                    active=0, waiting=self.scheduler.n_waiting,
                    preempted=n_preempted, kv_stats=self.cache.stats())
            return
        compute = telemetry.compute
        if not self._flops_declared:
            # per-token FLOPs vary with context: declared once for the
            # ledger's goodput math, the exact FLOPs passed every step
            telemetry.declare_flops_per_token(
                decode_flops_per_token(self.cfg, self.cache.block_size))
            telemetry.declare_dtype(self.cfg.dtype)
            self._flops_declared = True
        telemetry.step_begin()
        with _phase("serving.decode.build"):
            b = len(active)
            # under a mesh the gather path pads the window to max_active
            # rows (:799), dead ones after the live: the batch then
            # splits over dp
            rows = (self.max_active if self.mesh is not None
                    and not self._use_paged else b)
            # column 0 is the token each row consumes; columns 1..k carry
            # the drafter's proposals (zeros when it has none: the window
            # mask is causal, so junk columns cannot change earlier
            # positions)
            ids = torch.zeros((rows, s_w), dtype=torch.long)
            drafts: List[List[int]] = []
            for i, req in enumerate(active):
                ids[i, 0] = req.generated[-1]
                d = self._draft_tokens(req) if s_w > 1 else []
                if d:
                    ids[i, 1:1 + len(d)] = torch.tensor(d, dtype=torch.long)
                drafts.append(d)
            seq_ids = [r.id for r in active]
            # a routed config's expert capacity counts the reference's
            # padded batch (max_active rows, the dead ones after the
            # live): the live tokens then route exactly as they do there
            plan = {"ids": ids, "route": self.max_active * s_w}
            if self._use_paged:
                plan["op"] = "paged"
                plan["tables"], lengths = self.cache.block_tables(seq_ids)
                ctx_depth = plan["tables"].shape[1] * self.cache.block_size
            else:
                plan["op"] = "gather"
                with compute.phase("gather"):
                    plan["idx"], plan["valid"], lengths = \
                        self.cache.gather_plan(seq_ids, pad_batch=rows)
                ctx_depth = plan["idx"].shape[1] * self.cache.block_size
            base_lens = lengths[:b].tolist()
            positions = torch.zeros((rows, s_w), dtype=torch.long)
            positions[:b] = lengths[:b, None].long() + torch.arange(s_w)
            plan["positions"], plan["lengths"] = positions, lengths
        t_dev = time.perf_counter()
        with _phase("serving.decode.issue"):
            out = self._run(plan)
            logits = (out if self._use_paged else out[0])[:b]
            amax = logits.argmax(dim=-1)                          # [B, S]
            fin = torch.isfinite(
                torch.gather(logits, 2, amax[..., None]))[..., 0]
        # the host's first wait on the step: the device time ends here
        with _phase("serving.decode.wait"):
            amax, fin = amax.cpu().tolist(), fin.cpu().tolist()
        dev_s = time.perf_counter() - t_dev
        # executed FLOPs: every window position runs the full forward
        # whether or not its token commits (MFU counts work executed);
        # context depths repeat across rows and steps, so memoized
        flops = 0.0
        for n0 in base_lens:
            for c in range(n0 + 1, n0 + s_w + 1):
                f = self._fpt_cache.get(c)
                if f is None:
                    f = self._fpt_cache[c] = decode_flops_per_token(
                        self.cfg, c)
                flops += f
        if compute.enabled():
            # the step's device time split by the model's exact per-phase
            # FLOPs at the batch's context depth
            compute.phase_estimate(decode_phase_flops(self.cfg, ctx_depth),
                                   dev_s)
        # longest-accepted-prefix walk: position s emits argmax(logits[s]);
        # the walk continues only while the draft matches that argmax, so
        # the output is exactly plain greedy decoding
        outcomes = []
        n_tokens = n_proposed = n_accepted = 0
        with compute.phase("sampling", span="serving.decode.sample"):
            for i, req in enumerate(active):
                draft = drafts[i]
                n_proposed += len(draft)
                n_row = 0
                fail = done = False
                for s in range(1 + len(draft)):
                    if not fin[i][s]:
                        telemetry.inc("serving", "nonfinite_failures")
                        logger.error("request %d produced non-finite "
                                     "logits at decode position %d",
                                     req.id, base_lens[i] + s)
                        fail = True
                        break
                    next_id = amax[i][s]
                    req.generated.append(next_id)
                    n_row += 1
                    if req.is_finished_by(next_id):
                        done = True
                        break
                    if s < len(draft) and draft[s] == next_id:
                        n_accepted += 1
                        continue
                    break
                outcomes.append((req, i, n_row, fail, done))
                n_tokens += n_row
            # commit each row's prefix before any finish below frees
            # blocks: the paged step already scattered it into the pools;
            # the gather path writes it at the row's old length.  A row's
            # non-finite position and what follows are not committed
            if self._use_paged:
                self.cache.advance_many([(req.id, n) for req, _, n, _, _
                                         in outcomes if n])
            elif n_tokens:
                blk, slot = self.cache.reserve_many(
                    [(req.id, n) for req, _, n, _, _ in outcomes if n])
                self._run({"op": "commit", "blk": blk, "slot": slot,
                           "rows": [(i, n) for _, i, n, _, _ in outcomes
                                    if n]})
            t_commit = time.perf_counter()
            for req, _, n_row, _, _ in outcomes:
                if n_row:
                    self.requests.on_token(req.id, t=t_commit, n=n_row)
        stats_fn = getattr(self._decode, "stats", None)   # absent when off
        cost = stats_fn() if stats_fn else None
        telemetry.step_end(
            tokens=float(n_tokens), flops=flops,
            bytes_accessed=(cost["last_cost"] or {}).get("bytes_accessed")
            if cost else None,
            tokens_per_step=n_tokens / b,
            spec_accept_rate=(n_accepted / n_proposed
                              if n_proposed else None))
        with _phase("serving.decode.finish"):
            # completion delivery happens AFTER step_end: waking a handler
            # thread is response streaming, not decode work
            for req, _, _, fail, done in outcomes:
                if fail:
                    self._finish(req, error="non-finite logits during decode "
                                 "(numeric corruption); retry the request",
                                 reason="nonfinite")
                elif done:
                    self._finish(req)
            self.counters["decode_steps"] += 1
            self.counters["tokens_generated"] += n_tokens
            self.counters["spec_proposed"] += n_proposed
            self.counters["spec_accepted"] += n_accepted
            if n_tokens:
                telemetry.inc("serving", "tokens_generated", n_tokens)
            telemetry.inc("serving", "decode_steps")
            telemetry.observe("serving", "decode_batch", b)
            telemetry.set_gauge("serving", "paged_active",
                                1.0 if self._use_paged else 0.0)
            if self._use_paged:
                telemetry.inc("serving", "paged_decode_steps")
            if s_w > 1:
                telemetry.inc("serving", "spec_proposed", n_proposed)
                telemetry.inc("serving", "spec_accepted", n_accepted)
                if n_proposed:
                    telemetry.set_gauge("serving", "spec_accept_rate",
                                        100.0 * n_accepted / n_proposed)
                telemetry.observe("serving", "spec_tokens_per_step",
                                  n_tokens / b)
            if cost:
                telemetry.set_gauge("serving", "decode_signatures",
                                    cost["signatures"])
            # memory peaks need only periodic samples: every 8th iteration
            # (and the first, so short runs still record a peak)
            self._hbm_tick += 1
            if compute.enabled() and (self._hbm_tick - 1) % 8 == 0:
                compute.sample_hbm()
            # the per-iteration record (batch composition, queue depth, KV
            # pressure: the /requests load signal), then a throttled SLO
            # evaluation on fresh evidence
            self.requests.on_iteration(
                active=b, waiting=self.scheduler.n_waiting,
                preempted=n_preempted, tokens=n_tokens,
                kv_stats=self.cache.stats())
            self.availability.note_tokens(n_tokens)
            self.slo.maybe_evaluate()

    # ---- observability --------------------------------------------------
    def stats(self) -> dict:
        active, waiting = self.scheduler.counts()
        return {
            "active": active,
            "waiting": waiting,
            "max_active": self.max_active,
            "draining": self.draining,
            "device": str(self.device),
            "kv": self.cache.stats(),
            "counters": dict(self.counters),
            "kernel_launches": kernel_launches(),
            "ledger": telemetry.ledger().summary(),
            "requests": self.requests.summary(),
            "slo_active": self.slo.active(),
            "availability": self.availability.report(),
        }


def _destroy_groups() -> None:
    """Destroy every process group of this process (closing its
    connections, so no peer waits on it); a no-op when there is none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
