"""Host concurrency helpers the device feed and telemetry need (the port
of ``BufferPool`` and ``make_lock`` from ``dmlc_tpu/concurrency.py``).

The JAX package builds its locks through a lock-order checker; the
port's :func:`make_lock` hands out plain ``threading`` locks (the
checker is later work, ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Generic, List, Optional, TypeVar

__all__ = ["BufferPool", "make_lock"]

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
