"""Inference engine: the per-iteration prefill/decode loop.

Port of the paged branch of ``dmlc_tpu/serving/engine.py``: ``submit``,
``generate``, ``start``, ``close``, ``step``, ``_run_prefill`` (:643),
``_ensure_decode_capacity`` (:716), ``_draft_tokens`` (:754) and
``_run_decode`` (:789).  Every iteration admits what fits (prefill runs
the flash-attention kernel) and then runs one decode window for every
active request (the paged-attention kernel, reading the pools in place).
Sampling is greedy; with ``spec_k > 0`` an n-gram drafter proposes up to
``spec_k`` tokens per row and the longest-accepted-prefix walk keeps the
output identical to plain greedy decoding.

Differences from the reference: no jit (PyTorch runs eagerly, so there
are no shape buckets to pin and the decode batch is the live rows only,
with no dead padding rows); the pools live only on the device; and the
dedupe table, SLO monitor, request/step/availability ledgers, compute
telemetry and drain-on-SIGTERM wait for a later slice.  ``stats()``
keeps plain integer counters instead.

The engine runs on the CUDA card unless the caller passes
``device="cpu"`` (the tests do); with no card and no device it raises.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

import torch

from ..base import DMLCError, get_env, resolve_device
from ..models.transformer import (Transformer, forward_decode_paged,
                                  forward_prefill_last)
from ..ops.flash_attention import FLASH_FWD
from ..ops.paged_attention import PAGED_ATTENTION
from .kv_cache import PagedKVCache
from .scheduler import (ACTIVE, WAITING, AlreadyFinished,
                        ContinuousBatchScheduler, Request, coerce_priority)

__all__ = ["InferenceEngine", "AdmissionFull", "RequestTooLarge",
           "resolve_device", "kernel_launches"]

logger = logging.getLogger("dmlc_tpu_torch.serving")


class AdmissionFull(DMLCError):
    """The admission queue stayed full past the timeout (HTTP 429)."""


class RequestTooLarge(DMLCError):
    """The request could never fit the KV pool, even alone (HTTP 413)."""


def kernel_launches() -> Dict[str, int]:
    """Process-wide launch counts of the kernels the serving path runs."""
    return {"flash_fwd": FLASH_FWD.launches,
            "paged_attention": PAGED_ATTENTION.launches}


class _Slots:
    """Admission slots: a bounded counter whose ``kill`` wakes waiters."""

    def __init__(self, n: int):
        self._free = int(n)
        self._dead = False
        self._cv = threading.Condition()

    def acquire(self, timeout: Optional[float]) -> bool:
        with self._cv:
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


class InferenceEngine:
    """Continuous-batching generation over one model replica.

    Defaults come from the reference's ``DMLC_SERVE_*`` knobs
    (``MAX_ACTIVE``, ``KV_BLOCKS``, ``KV_BLOCK_SIZE``, ``QUEUE_DEPTH``,
    ``ADMIT_TIMEOUT_S``, ``MAX_TOKENS``, ``SPEC_K``, ``SPEC_MIN_CTX``,
    ``CRASH_REQUEUE_MAX``)."""

    def __init__(self, model: Transformer, *, device=None,
                 n_blocks: Optional[int] = None,
                 block_size: Optional[int] = None,
                 max_active: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 admit_timeout_s: Optional[float] = None,
                 max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 spec_k: Optional[int] = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise DMLCError(f"model is on {model.device}, engine on "
                            f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        self.max_active = (max_active if max_active is not None
                           else get_env("DMLC_SERVE_MAX_ACTIVE", 8))
        self.admit_timeout_s = (
            admit_timeout_s if admit_timeout_s is not None
            else get_env("DMLC_SERVE_ADMIT_TIMEOUT_S", 2.0))
        self.default_max_new_tokens = (
            max_new_tokens if max_new_tokens is not None
            else get_env("DMLC_SERVE_MAX_TOKENS", 64))
        self.eos_id = eos_id
        self.priority_levels = 3
        self.priority_default = 1
        with torch.inference_mode():
            self.cache = PagedKVCache(
                self.cfg.n_layers, self.cfg.n_heads, self.cfg.head_dim,
                n_blocks=(n_blocks if n_blocks is not None
                          else get_env("DMLC_SERVE_KV_BLOCKS", 256)),
                block_size=(block_size if block_size is not None
                            else get_env("DMLC_SERVE_KV_BLOCK_SIZE", 16)),
                dtype=self.cfg.torch_dtype, device=self.device)
        self.scheduler = ContinuousBatchScheduler(
            self.cache, max_active=self.max_active)
        self._slots = _Slots(queue_depth if queue_depth is not None
                             else get_env("DMLC_SERVE_QUEUE_DEPTH", 64))
        self.spec_k = max(0, int(spec_k if spec_k is not None
                                 else get_env("DMLC_SERVE_SPEC_K", 0)))
        self.spec_min_ctx = max(1, get_env("DMLC_SERVE_SPEC_MIN_CTX", 4))
        self._spec_window = 1 + self.spec_k
        self._crash_requeue_max = get_env("DMLC_SERVE_CRASH_REQUEUE_MAX", 2)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.counters = {"prefills": 0, "decode_steps": 0,
                         "tokens_generated": 0, "spec_proposed": 0,
                         "spec_accepted": 0, "preemptions": 0,
                         "crash_requeues": 0}

    # ---- client surface -------------------------------------------------
    def submit(self, prompt_ids: List[int],
               max_new_tokens: Optional[int] = None,
               timeout: Optional[float] = None, priority=None) -> Request:
        """Admit a request or raise: :class:`AdmissionFull` when no queue
        slot frees within ``timeout`` (default ``admit_timeout_s``),
        :class:`RequestTooLarge` when it could never fit the pool,
        ``ValueError`` for bad ids or priority."""
        mnt = (max_new_tokens if max_new_tokens is not None
               else self.default_max_new_tokens)
        prio = coerce_priority(priority, self.priority_levels,
                               self.priority_default)
        req = Request(prompt_ids, mnt, eos_id=self.eos_id, priority=prio)
        if any(t < 0 or t >= self.cfg.vocab for t in req.prompt_ids):
            raise ValueError(
                f"prompt ids out of range for vocab {self.cfg.vocab}")
        # spec decode reserves a whole verify window ahead of each step
        if not self.cache.fits_at_all(req.n_prompt + mnt + self.spec_k):
            raise RequestTooLarge(
                f"request needs up to {req.n_prompt + mnt + self.spec_k} "
                f"cached tokens; cache holds "
                f"{self.cache.n_blocks * self.cache.block_size}")
        if not self._slots.acquire(
                self.admit_timeout_s if timeout is None else timeout):
            raise AdmissionFull("admission queue full; retry later")
        req.slot_held = True
        self.scheduler.enqueue(req)
        if self._stop.is_set():
            # close() may have swept between the acquire and the enqueue
            try:
                self._finish(req, error="engine shut down")
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
        if self._thread is not None and self._thread.is_alive():
            return
        if self._stop.is_set():
            raise DMLCError("engine is closed")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-engine")
        self._thread.start()

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
                self._finish(req, error="engine shut down")
            except AlreadyFinished:
                pass

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                did = self.step()
            except Exception as e:  # noqa: BLE001 - the loop must not die
                # the active set's cache state is unknown after a crash,
                # its output is not: requeue each for recompute-resume
                # (bounded per request), fail it past the budget
                logger.exception("serving iteration failed")
                for req in self.scheduler.active_requests():
                    if (req.crash_requeues < self._crash_requeue_max
                            and self.scheduler.requeue_active(req)):
                        self.counters["crash_requeues"] += 1
                        continue
                    try:
                        self._finish(
                            req, error=f"engine iteration failed: {e!r}")
                    except AlreadyFinished:
                        pass
                did = False
            if not did:
                time.sleep(0.002)

    # ---- one iteration --------------------------------------------------
    def step(self) -> bool:
        """Admit every prefill that fits (up to ``max_active``), then run
        one decode window for every active request.  Returns whether any
        work happened.  Public so tests can single-step the engine."""
        with torch.inference_mode():
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

    def _finish(self, req: Request, error: Optional[str] = None) -> None:
        self.scheduler.finish(req, error=error)
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
            logits, k, v = forward_prefill_last(
                self.model, ids.to(self.device),
                torch.tensor([n - 1], device=self.device))
            self.cache.write(req.id, k[:, 0, :n], v[:, 0, :n], start=0)
            logits = logits[0].float().cpu()
        except Exception as e:  # noqa: BLE001 - fail THIS request only
            logger.exception("prefill of request %d failed", req.id)
            self._finish(req, error=f"prefill failed: {e!r}")
            return
        self.counters["prefills"] += 1
        if not resume:
            if not bool(torch.isfinite(logits).all()):
                self._finish(req, error="non-finite logits during prefill "
                             "(numeric corruption); retry the request")
                return
            next_id = int(torch.argmax(logits))
            req.generated.append(next_id)
            self.counters["tokens_generated"] += 1
            req.ttft_s = time.monotonic() - req.submit_t
            if req.is_finished_by(next_id):
                self._finish(req)
                return
        self.scheduler.activate(req)

    def _ensure_decode_capacity(self, active: List[Request],
                                n_tokens: int = 1) -> List[Request]:
        """Reserve ``n_tokens`` more slots per active request, preempting
        youngest-first under pressure; returns the survivors."""
        if active and self.cache.extend_many([r.id for r in active],
                                             n_tokens):
            return list(active)
        alive = []
        for req in active:
            if req.state != ACTIVE:
                continue  # a preemption below already took it out
            while not self.cache.extend(req.id, n_tokens):
                victim = self.scheduler.preempt_youngest()
                if victim is not None:
                    self.counters["preemptions"] += 1
                if victim is None:
                    self._finish(req, error="kv cache exhausted with "
                                 "nothing left to evict")
                    break
                if victim is req:
                    break  # preempted itself; resumes via re-prefill
            else:
                alive.append(req)
        # a later request's eviction can preempt an earlier survivor
        return [r for r in alive if r.state == ACTIVE]

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
        active = self._ensure_decode_capacity(active, s_w)
        if not active:
            return
        b = len(active)
        # column 0 is the token each row consumes; columns 1..k carry the
        # drafter's proposals (zeros when it has none: the window mask is
        # causal, so junk columns cannot change earlier positions)
        ids = torch.zeros((b, s_w), dtype=torch.long)
        drafts: List[List[int]] = []
        for i, req in enumerate(active):
            ids[i, 0] = req.generated[-1]
            d = self._draft_tokens(req) if s_w > 1 else []
            if d:
                ids[i, 1:1 + len(d)] = torch.tensor(d, dtype=torch.long)
            drafts.append(d)
        tables, lengths = self.cache.block_tables_array(
            [r.id for r in active])
        base = torch.tensor([self.cache.length(r.id) for r in active],
                            dtype=torch.long)
        positions = base[:, None] + torch.arange(s_w)
        logits = forward_decode_paged(
            self.model, ids.to(self.device), positions.to(self.device),
            self.cache.k_pool, self.cache.v_pool, tables, lengths)
        amax = logits.argmax(dim=-1)                              # [B, S]
        fin = torch.isfinite(torch.gather(logits, 2, amax[..., None]))[..., 0]
        amax, fin = amax.cpu().tolist(), fin.cpu().tolist()
        # longest-accepted-prefix walk: position s emits argmax(logits[s]);
        # the walk continues only while the draft matches that argmax, so
        # the output is exactly plain greedy decoding
        outcomes = []
        n_tokens = n_proposed = n_accepted = 0
        for i, req in enumerate(active):
            draft = drafts[i]
            n_proposed += len(draft)
            n_row = 0
            fail = done = False
            for s in range(1 + len(draft)):
                if not fin[i][s]:
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
            outcomes.append((req, n_row, fail, done))
            n_tokens += n_row
        # the pools already hold the committed prefix (scattered by the
        # step); commit before any finish below frees blocks
        self.cache.advance_many([(req.id, n) for req, n, _, _ in outcomes
                                 if n])
        for req, _, fail, done in outcomes:
            if fail:
                self._finish(req, error="non-finite logits during decode "
                             "(numeric corruption); retry the request")
            elif done:
                self._finish(req)
        self.counters["decode_steps"] += 1
        self.counters["tokens_generated"] += n_tokens
        self.counters["spec_proposed"] += n_proposed
        self.counters["spec_accepted"] += n_accepted

    # ---- observability --------------------------------------------------
    def stats(self) -> dict:
        active, waiting = self.scheduler.counts()
        return {
            "active": active,
            "waiting": waiting,
            "max_active": self.max_active,
            "device": str(self.device),
            "kv": self.cache.stats(),
            "counters": dict(self.counters),
            "kernel_launches": kernel_launches(),
        }
