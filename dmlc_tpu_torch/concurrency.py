"""Host concurrency helpers the device feed, the input splits, the parsers
and telemetry need (the port of ``BufferPool``, ``ThreadedIter`` and
``make_lock`` from ``dmlc_tpu/concurrency.py``).

The JAX package builds its locks through a lock-order checker; the
port's :func:`make_lock` hands out plain ``threading`` locks (the
checker is later work, ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Generic, Iterator, List, Optional, Tuple, TypeVar

from .base import DMLCError

__all__ = ["BufferPool", "ThreadedIter", "make_lock"]

T = TypeVar("T")


def make_lock(name: str) -> threading.Lock:
    """A plain ``threading.Lock``.  ``name`` is the lock's name in the
    JAX package's lock-order graph (``Class.attr`` or ``module.attr``),
    kept at every call site for the checker's port."""
    del name
    return threading.Lock()


class BufferPool(Generic[T]):
    """Bounded pool of reusable buffers (the free-list half of the
    reference's ThreadedIter "Recycle" contract, threadediter.h:170-193).

    ``acquire()`` pops a free buffer, builds one through ``factory`` while
    fewer than ``capacity`` exist, and otherwise blocks until a consumer
    hands one back with ``release()``: a producer runs at most
    ``capacity`` buffers ahead of its consumer and steady state allocates
    nothing.  ``kill()`` wakes every blocked acquirer with ``None``.
    ``acquire(timeout=...)`` returns ``None`` when the deadline passes;
    ``timeout=0`` is a non-blocking try.
    """

    def __init__(self, factory: Callable[[], T], capacity: int = 2):
        self._factory = factory
        self._capacity = max(1, capacity)
        self._free: List[T] = []
        self._created = 0
        self._lock = threading.Lock()
        self._avail = threading.Condition(self._lock)
        self._killed = False

    def acquire(self, timeout: Optional[float] = None) -> Optional[T]:
        """A free buffer, or ``None`` on kill() or timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while not self._killed:
                if self._free:
                    return self._free.pop()
                if self._created < self._capacity:
                    # counted before the build, so concurrent acquirers
                    # cannot overshoot the capacity
                    self._created += 1
                    break
                # an absolute deadline: a wakeup whose buffer another
                # thread takes must not restart the clock
                if deadline is None:
                    self._avail.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._avail.wait(remaining):
                        return None
            else:
                return None
        try:
            obj = self._factory()
        except BaseException:
            with self._lock:
                self._created -= 1
                self._avail.notify()
            raise
        with self._lock:
            if self._killed:
                return None  # a killed pool never hands out buffers
        return obj

    def release(self, obj: T) -> None:
        with self._lock:
            if self._killed:
                return
            self._free.append(obj)
            self._avail.notify()

    def kill(self) -> None:
        """Wake all blocked acquirers; later acquires return None."""
        with self._lock:
            self._killed = True
            self._free.clear()
            self._avail.notify_all()

    @property
    def created(self) -> int:
        """Buffers built so far (at most ``capacity``)."""
        with self._lock:
            return self._created


class ThreadedIter(Generic[T]):
    """Single-producer-thread prefetch iterator with buffer recycling.

    The producer is a callable ``next_fn(recycled) -> Optional[T]`` which
    receives a previously-consumed object to refill (or ``None`` if the free
    list is empty) and returns a filled object, or ``None`` at end of stream.
    An optional ``before_first_fn()`` rewinds the underlying source; calling
    :meth:`before_first` mid-stream drains in-flight items and restarts
    production, matching reference semantics (threadediter.h:170-234).

    Usage::

        it = ThreadedIter(next_fn, before_first_fn, max_capacity=2)
        while True:
            ok, v = it.next()
            if not ok: break
            consume(v)
            it.recycle(v)      # hand buffer back for reuse
    """

    # producer control signals (threadediter.h:200-205)
    _PRODUCE, _BEFORE_FIRST, _DESTROY = 0, 1, 2

    def __init__(
        self,
        next_fn: Callable[[Optional[T]], Optional[T]],
        before_first_fn: Optional[Callable[[], None]] = None,
        max_capacity: int = 8,
    ):
        self._next_fn = next_fn
        self._before_first_fn = before_first_fn
        self._cap = max(1, max_capacity)
        self._lock = make_lock("ThreadedIter._lock")
        self._cv_consumer = threading.Condition(self._lock)
        self._cv_producer = threading.Condition(self._lock)
        self._queue: deque = deque()          # filled items awaiting consumption
        self._free: List[T] = []              # recycled buffers
        self._produced_end = False            # producer hit end-of-stream
        self._signal = self._PRODUCE
        self._signal_ack = False
        self._producer_exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._producer_loop, daemon=True)
        self._thread.start()

    # -- producer side ----------------------------------------------------
    def _producer_loop(self) -> None:
        while True:
            with self._lock:
                while (
                    self._signal == self._PRODUCE
                    and (len(self._queue) >= self._cap or self._produced_end)
                ):
                    self._cv_producer.wait()
                sig = self._signal
                if sig == self._DESTROY:
                    self._signal_ack = True
                    self._cv_consumer.notify_all()
                    return
                if sig == self._BEFORE_FIRST:
                    # drain queue into free list, rewind source, resume
                    while self._queue:
                        self._free.append(self._queue.popleft())
                    try:
                        if self._before_first_fn is not None:
                            self._before_first_fn()
                        self._produced_end = False
                    except BaseException as exc:  # noqa: BLE001
                        self._producer_exc = exc
                        self._produced_end = True
                    self._signal = self._PRODUCE
                    self._signal_ack = True
                    self._cv_consumer.notify_all()
                    continue
                recycled = self._free.pop() if self._free else None
            # produce outside the lock (the whole point of the thread)
            try:
                item = self._next_fn(recycled)
            except BaseException as exc:  # noqa: BLE001
                with self._lock:
                    self._producer_exc = exc
                    self._produced_end = True
                    self._cv_consumer.notify_all()
                continue
            with self._lock:
                if self._signal != self._PRODUCE:
                    # a BeforeFirst/Destroy raced in: drop the item to free list
                    if item is not None:
                        self._free.append(item)
                    continue
                if item is None:
                    self._produced_end = True
                else:
                    self._queue.append(item)
                self._cv_consumer.notify_all()

    # -- consumer side ----------------------------------------------------
    def next(self) -> Tuple[bool, Optional[T]]:
        """Blocking pop. Returns ``(False, None)`` at end of stream; re-raises
        any exception thrown by the producer (threadediter.h:305-320)."""
        with self._lock:
            while not self._queue and not self._produced_end:
                self._cv_consumer.wait()
            if self._producer_exc is not None:
                exc, self._producer_exc = self._producer_exc, None
                raise DMLCError(f"ThreadedIter producer failed: {exc!r}") from exc
            if not self._queue:
                return False, None
            item = self._queue.popleft()
            self._cv_producer.notify()
            return True, item

    def recycle(self, obj: T) -> None:
        """Return a consumed object to the free list for producer reuse
        (threadediter.h:170-193)."""
        with self._lock:
            self._free.append(obj)
            self._cv_producer.notify()

    def before_first(self) -> None:
        """Rewind: drain in-flight production and restart from the source's
        beginning (threadediter.h:236-269)."""
        with self._lock:
            self._signal = self._BEFORE_FIRST
            self._signal_ack = False
            self._cv_producer.notify_all()
            while not self._signal_ack:
                self._cv_consumer.wait()
            self._signal_ack = False
            if self._producer_exc is not None:
                exc, self._producer_exc = self._producer_exc, None
                raise DMLCError(f"ThreadedIter rewind failed: {exc!r}") from exc

    def destroy(self) -> None:
        with self._lock:
            self._signal = self._DESTROY
            self._signal_ack = False
            self._cv_producer.notify_all()
        self._thread.join(timeout=10.0)

    def __del__(self):  # best-effort cleanup
        try:
            if self._thread.is_alive():
                self.destroy()
        except Exception:  # noqa: BLE001
            pass

    def __iter__(self) -> Iterator[T]:
        while True:
            ok, v = self.next()
            if not ok:
                return
            yield v
