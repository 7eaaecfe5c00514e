"""Continuous-batching scheduler: iteration-level admit / evict.

Port of ``dmlc_tpu/serving/scheduler.py`` (``Request`` :99,
``ContinuousBatchScheduler`` :219) with the same policy: admission is
highest-priority-first, FIFO within a class, gated on a free active slot
and on the free list covering the context plus one decode slot; memory
pressure evicts the lowest-priority active request, youngest within its
class, which re-enters the FRONT of the wait queue keeping the tokens it
generated (its re-prefill recomputes ``context_ids()``).  The reference's
queue-depth and active-request gauges are left out: the engine's request
ledger records both every decode iteration.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..base import DMLCError
from ..concurrency import make_lock
from .kv_cache import PagedKVCache

__all__ = ["AlreadyFinished", "Request", "ContinuousBatchScheduler",
           "WAITING", "ACTIVE", "DONE", "FAILED", "PRIORITY_CLASSES",
           "coerce_priority"]

#: named priority classes; higher = admitted first, evicted later
PRIORITY_CLASSES = {"batch": 0, "standard": 1, "interactive": 2}


def coerce_priority(value, levels: int, default: int) -> int:
    """None → ``default``; a name from :data:`PRIORITY_CLASSES` or an int
    in ``[0, levels)`` → its level; anything else raises ``ValueError``."""
    if value is None:
        return int(default)
    if isinstance(value, str):
        if value not in PRIORITY_CLASSES:
            raise ValueError(
                f"priority must be one of {sorted(PRIORITY_CLASSES)} "
                f"or an int in [0, {levels})")
        value = PRIORITY_CLASSES[value]
    if not isinstance(value, int) or isinstance(value, bool):
        raise ValueError("priority must be an int or a named class")
    if not 0 <= value < levels:
        raise ValueError(f"priority {value} out of range [0, {levels})")
    return value


class AlreadyFinished(DMLCError):
    """:meth:`ContinuousBatchScheduler.finish` on a request that already
    reached a terminal state."""


WAITING = "waiting"
ACTIVE = "active"
DONE = "done"
FAILED = "failed"

_req_ids = itertools.count(1)


class Request:
    """One generation request's lifetime record.  ``generated`` persists
    across preemptions; ``wait()`` blocks until the engine finishes it."""

    def __init__(self, prompt_ids: List[int], max_new_tokens: int,
                 eos_id: Optional[int] = None, priority: int = 1,
                 tenant: str = "default"):
        if not prompt_ids:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        self.id = next(_req_ids)
        self.prompt_ids = [int(t) for t in prompt_ids]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.priority = int(priority)
        self.tenant = str(tenant)
        self.submit_t = time.monotonic()
        # dmlc-check: unguarded(scheduler-lock guarded; terminal write fenced by _done)
        self.state = WAITING
        self.generated: List[int] = []
        self.ttft_s: Optional[float] = None
        # dmlc-check: unguarded(scheduler-lock guarded; terminal write fenced by _done)
        self.finish_t: Optional[float] = None
        # dmlc-check: unguarded(scheduler-lock guarded; terminal write fenced by _done)
        self.error: Optional[str] = None
        self.preemptions = 0
        self.crash_requeues = 0
        self.slot_held = False
        self.client_id: Optional[str] = None  # idempotency key, if any
        self.trace_id: Optional[str] = None   # X-DMLC-Trace trace id
        self._done = threading.Event()

    @property
    def n_prompt(self) -> int:
        return len(self.prompt_ids)

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    def context_ids(self) -> List[int]:
        """Tokens a (re-)prefill consumes: the prompt plus everything
        generated, minus the last generated token (the next decode
        input, not consumed yet)."""
        if self.generated:
            return self.prompt_ids + self.generated[:-1]
        return list(self.prompt_ids)

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return self.finish_t - self.submit_t

    @property
    def decode_tokens_per_s(self) -> Optional[float]:
        """Per-user decode throughput: generated tokens over the time
        after the first token (None until finished or with one token)."""
        if self.finish_t is None or self.ttft_s is None:
            return None
        decode_s = (self.finish_t - self.submit_t) - self.ttft_s
        if self.n_generated <= 1 or decode_s <= 0:
            return None
        return (self.n_generated - 1) / decode_s

    def is_finished_by(self, token: int) -> bool:
        return (self.n_generated >= self.max_new_tokens
                or (self.eos_id is not None and token == self.eos_id))

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def reject(self, error: str) -> None:
        """Terminal transition for a request that was never enqueued
        (its admission failed after a dedupe claim published it): mark it
        FAILED and wake duplicate waiters; no scheduler or cache state
        to release."""
        self.state = FAILED
        self.error = error
        self.finish_t = time.monotonic()
        self._done.set()

    def result(self) -> Dict:
        """JSON-able completion document (the server's response body)."""
        out = {
            "id": self.id,
            "state": self.state,
            "error": self.error,
            "n_prompt": self.n_prompt,
            "n_generated": self.n_generated,
            "output_ids": list(self.generated),
            "ttft_s": self.ttft_s,
            "latency_s": self.latency_s,
            "decode_tokens_per_s": self.decode_tokens_per_s,
            "preemptions": self.preemptions,
            "priority": self.priority,
            "tenant": self.tenant,
        }
        if self.client_id is not None:
            out["request_id"] = self.client_id
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        return out


class ContinuousBatchScheduler:
    """Admission queue + active set over a shared :class:`PagedKVCache`."""

    def __init__(self, cache: PagedKVCache, max_active: int = 8):
        if max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {max_active}")
        self.cache = cache
        self.max_active = int(max_active)
        self._waiting: deque = deque()
        self._active: List[Request] = []
        self._lock = make_lock("ContinuousBatchScheduler._lock")

    @property
    def n_waiting(self) -> int:
        with self._lock:
            return len(self._waiting)

    @property
    def n_active(self) -> int:
        with self._lock:
            return len(self._active)

    def active_requests(self) -> List[Request]:
        with self._lock:
            return list(self._active)

    def counts(self) -> tuple:
        """``(n_active, n_waiting)`` under one lock hold."""
        with self._lock:
            return len(self._active), len(self._waiting)

    def enqueue(self, req: Request) -> None:
        with self._lock:
            req.state = WAITING
            self._waiting.append(req)

    def next_prefill(self) -> Optional[Request]:
        """Pop the highest-priority waiting request (FIFO within a class)
        if an active slot is free and the free list covers its context
        plus one decode slot; otherwise admit nothing this iteration
        (skipping past it would starve the request priority says to
        serve first)."""
        with self._lock:
            if len(self._active) >= self.max_active or not self._waiting:
                return None
            req = max(self._waiting, key=lambda r: r.priority)
            if not self.cache.can_reserve(len(req.context_ids()) + 1):
                return None
            self._waiting.remove(req)
            return req

    def requeue_front(self, req: Request) -> None:
        """Put a popped-but-not-started request back at the head."""
        with self._lock:
            req.state = WAITING
            self._waiting.appendleft(req)

    def all_pending(self) -> List[Request]:
        with self._lock:
            return list(self._active) + list(self._waiting)

    def activate(self, req: Request) -> None:
        with self._lock:
            req.state = ACTIVE
            self._active.append(req)

    def requeue_active(self, req: Request) -> bool:
        """Crash requeue: move an active request back to the front of the
        wait queue and free its blocks (its re-prefill recomputes them).
        False when the request is no longer active."""
        with self._lock:
            if req not in self._active:
                return False
            self._active.remove(req)
            req.state = WAITING
            req.crash_requeues += 1
            self._waiting.appendleft(req)
        self.cache.free(req.id)
        return True

    def preempt_youngest(self) -> Optional[Request]:
        """Evict the lowest-priority active request, youngest within its
        class: free its blocks and requeue it at the FRONT.  Returns it,
        or None when nothing is active."""
        with self._lock:
            if not self._active:
                return None
            req = max(self._active,
                      key=lambda r: (-r.priority, r.submit_t, r.id))
            self._active.remove(req)
            req.state = WAITING
            req.preemptions += 1
            self._waiting.appendleft(req)
        self.cache.free(req.id)
        return req

    def finish(self, req: Request, error: Optional[str] = None) -> None:
        """Terminal transition, exactly once: release the request's
        blocks, mark DONE/FAILED and wake its waiter."""
        with self._lock:
            if req.state in (DONE, FAILED):
                raise AlreadyFinished(f"request {req.id} finished twice")
            if req in self._active:
                self._active.remove(req)
            elif req in self._waiting:
                self._waiting.remove(req)
            req.state = FAILED if error else DONE
            req.error = error
            req.finish_t = time.monotonic()
        self.cache.free(req.id)
        req._done.set()
