"""Host-side memory pools: recyclable buffers for ingest/feed consumers.

The port of ``dmlc_tpu/memory.py``, dmlc-core's allocator layer
(include/dmlc/memory.h:22-261: ``MemoryPool``, fixed-size pieces carved
from page-sized arenas, ``ThreadlocalAllocator``, and the thread-local
object pool behind ``ThreadlocalSharedPtr``).  The role is host-buffer
recycling: ingestion and feeds allocate the same large numpy buffers
every batch, and Python's allocator returns MB-sized blocks to the OS
between uses, so steady-state pipelines pay repeated page-faulting.
These pools keep hot buffers alive instead.

Design deviations from dmlc-core (deliberate, as in the reference):
  - buffers are numpy uint8 arrays, not raw pointers (nor torch
    tensors: these are host pools, and nothing on the card path uses
    them); a leaked buffer is garbage collected instead of leaked;
  - ``BufferPool`` adds power-of-two size classes (dmlc-core's pool
    is single-size) because feed/parse buffers vary with batch shape;
  - pools are bounded (``max_bytes``) so a burst cannot pin unbounded
    memory — overflow buffers are simply dropped to the GC.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from .base import check
from .concurrency import make_lock

__all__ = ["MemoryPool", "BufferPool", "ThreadLocalPool"]


class MemoryPool:
    """Fixed-size buffer pool (memory.h:22-77 role).

    ``alloc()`` returns a uint8 array of exactly ``obj_size`` bytes;
    ``free(buf)`` recycles it.  Buffers are carved from arenas of
    ``arena_objects`` pieces so a million small allocs don't mean a
    million numpy allocations — dmlc-core's page-chunk move.
    """

    def __init__(self, obj_size: int, *, arena_objects: int = 64,
                 max_free: int = 1024):
        check(obj_size > 0, "MemoryPool: obj_size must be positive")
        self.obj_size = int(obj_size)
        self._arena_objects = max(1, int(arena_objects))
        self._max_free = int(max_free)
        self._free: List[np.ndarray] = []    # returned via free()
        self._fresh: List[np.ndarray] = []   # carved, never handed out
        self._lock = make_lock("MemoryPool._lock")
        self.allocated = 0   # total pieces handed out over the lifetime
        self.recycled = 0    # pieces that went through free() and back

    def _grow(self) -> None:
        arena = np.empty(self.obj_size * self._arena_objects, np.uint8)
        self._fresh.extend(
            arena[i * self.obj_size:(i + 1) * self.obj_size]
            for i in range(self._arena_objects))

    def alloc(self) -> np.ndarray:
        with self._lock:
            self.allocated += 1
            if self._free:
                self.recycled += 1
                return self._free.pop()
            if not self._fresh:
                self._grow()
            return self._fresh.pop()

    def free(self, buf: np.ndarray) -> None:
        check(buf.nbytes == self.obj_size,
              "MemoryPool.free: buffer is not from this pool")
        with self._lock:
            if len(self._free) < self._max_free:
                self._free.append(buf)


class BufferPool:
    """Size-class buffer recycler for variable-size consumers.

    ``acquire(nbytes)`` returns a uint8 array of AT LEAST nbytes
    (rounded up to the next power of two, so reuse hits are frequent);
    ``release(buf)`` returns it for reuse.  Total retained bytes are
    bounded by ``max_bytes``; anything beyond is dropped to the GC.
    Thread-safe — one pool can serve every parser/feed thread.
    """

    def __init__(self, *, max_bytes: int = 256 << 20):
        self._classes: Dict[int, List[np.ndarray]] = {}
        self._lock = make_lock("BufferPool._lock")
        self._max_bytes = int(max_bytes)
        self._held = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _cls(nbytes: int) -> int:
        return 1 << max(6, (int(nbytes) - 1).bit_length())  # >= 64 B

    def acquire(self, nbytes: int) -> np.ndarray:
        check(nbytes >= 0, "BufferPool.acquire: negative size")
        c = self._cls(max(nbytes, 1))
        with self._lock:
            lst = self._classes.get(c)
            if lst:
                self.hits += 1
                self._held -= c
                return lst.pop()
            self.misses += 1
        return np.empty(c, np.uint8)

    def release(self, buf: np.ndarray) -> None:
        n = buf.nbytes
        # only whole, owning uint8 arrays of a pool size class come
        # back: foreign dtypes would make acquire() hand out wrongly-
        # typed buffers, and a sliced view would pin its entire base
        # array while held_bytes counts only the slice
        if (n & (n - 1) or n < 64 or buf.dtype != np.uint8
                or buf.base is not None or buf.ndim != 1):
            return  # not one of ours: let the GC have it
        with self._lock:
            if self._held + n > self._max_bytes:
                return
            self._held += n
            self._classes.setdefault(n, []).append(buf)

    @property
    def held_bytes(self) -> int:
        with self._lock:
            return self._held


class ThreadLocalPool:
    """Per-thread BufferPool facade (ThreadlocalAllocator role,
    memory.h:85-124): no lock contention on the hot path because every
    thread recycles through its own pool.  Suitable for buffers that do
    not cross threads (parse scratch, per-thread chunk staging)."""

    def __init__(self, *, max_bytes_per_thread: int = 64 << 20):
        self._tls = threading.local()
        self._max = int(max_bytes_per_thread)

    def _pool(self) -> BufferPool:
        p: Optional[BufferPool] = getattr(self._tls, "pool", None)
        if p is None:
            p = BufferPool(max_bytes=self._max)
            self._tls.pool = p
        return p

    def acquire(self, nbytes: int) -> np.ndarray:
        return self._pool().acquire(nbytes)

    def release(self, buf: np.ndarray) -> None:
        self._pool().release(buf)
