"""Host concurrency helpers the device feed, the input splits, the parsers
and telemetry need, and the runtime lock-order and race checkers (the
port of ``BufferPool``, ``ThreadedIter``, ``make_lock``/``make_rlock``
and the ``DMLC_LOCKCHECK``/``DMLC_RACECHECK`` watchdog from
``dmlc_tpu/concurrency.py``).

With both knobs unset :func:`make_lock` and :func:`make_rlock` hand out
plain ``threading`` locks, so the hot paths pay nothing.  Under
``DMLC_LOCKCHECK=1`` each lock is a :class:`CheckedLock` that feeds a
process-wide lock-order graph (order inversions, acquires that block
while another lock is held); ``DMLC_RACECHECK=1`` adds the record of
which lock each ``with`` site held, cross-checked against the static
race pass over the port's tree.  ``ConcurrentBlockingQueue`` (bounded
FIFO or priority, ``signal_for_kill``) and ``MultiThreadedIter`` (N
workers, end of stream by N sentinels) are the reference's queue
classes.  Inside an interleaving-explorer scenario
(``analysis.interleave``) :func:`make_lock` hands out the explorer's
scheduler-owned locks through :func:`set_lock_factory_hook`.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from typing import Callable, Generic, Iterator, List, Optional, Tuple, TypeVar

from .base import DMLCError, get_env

__all__ = ["BufferPool", "CheckedLock", "ConcurrentBlockingQueue",
           "MultiThreadedIter", "ThreadedIter",
           "lockcheck_assert_clean", "lockcheck_enabled",
           "lockcheck_report", "lockcheck_reset", "make_lock", "make_rlock",
           "racecheck_assert_clean", "racecheck_enabled",
           "racecheck_observed", "racecheck_report",
           "set_lock_factory_hook"]

T = TypeVar("T")


# ---------------------------------------------------------------------------
# runtime lock-order watchdog (DMLC_LOCKCHECK=1)
# ---------------------------------------------------------------------------
# The static concurrency pass (analysis/concurrency_pass.py)
# proves what it can from the AST; acquisition ORDERS it cannot.  Under
# DMLC_LOCKCHECK=1 every lock built through make_lock()/make_rlock()
# is wrapped in a CheckedLock that maintains a per-thread held stack
# and a process-wide dynamic lock-order graph:
#
#   * order inversion — acquiring B while holding A after ANY thread
#     ever acquired A while holding B.  The classic deadlock pair,
#     flagged even when the two runs never actually interleave (which
#     is exactly the case a stress test gets "lucky" on).
#   * held-while-blocked — an acquire that stalled longer than
#     DMLC_LOCKCHECK_BLOCK_S (default 1 s) while the thread holds
#     another lock: some lock holder is doing blocking work.
#
# Violations are logged and collected (bounded, deduplicated);
# lockcheck_report() returns them and lockcheck_assert_clean() raises.
# Off (the default) make_lock returns a plain threading.Lock — zero
# overhead, byte-identical behavior.

_lc_graph_lock = threading.Lock()
_lc_edges: dict = {}        # (held_name, acquired_name) -> witness str
_lc_violations: List[dict] = []
_LC_MAX_VIOLATIONS = 256
_lc_tls = threading.local()

#: DMLC_RACECHECK=1 observation store: (file basename, with/acquire
#: line) -> set of runtime lock names seen held at that site.  The
#: static race pass (analysis.race_pass.guarded_region_map) knows which
#: lock *should* guard each site's attributes; racecheck_report()
#: cross-checks the two.
_rc_sites: dict = {}

#: deterministic-interleaving hook (analysis.interleave installs it for
#: a scenario's extent): when set, make_lock/make_rlock offer the
#: construction to the explorer first, so a scenario's objects are built
#: over scheduler-owned locks.  The hook returns a lock-like object or
#: None (= not under exploration).
_lock_factory_hook = None


def set_lock_factory_hook(hook) -> None:
    """Install/clear (None) the interleaving explorer's lock factory."""
    global _lock_factory_hook
    _lock_factory_hook = hook


def lockcheck_enabled() -> bool:
    """Whether make_lock() instruments (``DMLC_LOCKCHECK``, read per
    lock construction so tests can flip it).  ``DMLC_RACECHECK=1``
    implies it — the racecheck rides the same CheckedLock."""
    return get_env("DMLC_LOCKCHECK", False) or racecheck_enabled()


def racecheck_enabled() -> bool:
    """Whether acquire sites record attribute→lock pairing evidence
    (``DMLC_RACECHECK``)."""
    return get_env("DMLC_RACECHECK", False)


def _lc_held() -> list:
    held = getattr(_lc_tls, "held", None)
    if held is None:
        held = _lc_tls.held = []
    return held


def _lc_site() -> str:
    """The USER frame that acquired the lock: walk up past this module
    and threading.py (a Condition ``with``/wait adds interpreter
    frames, so any fixed depth reports threading internals)."""
    import sys

    try:
        depth = 1
        while True:
            f = sys._getframe(depth)
            fn = f.f_code.co_filename
            base = fn.rsplit("/", 1)[-1]
            if base not in ("threading.py", "concurrency.py"):
                return f"{base}:{f.f_lineno}"
            depth += 1
    except (ValueError, AttributeError):
        return "?"


def _lc_record(kind: str, detail: str, **ctx) -> None:
    with _lc_graph_lock:
        for v in _lc_violations:
            if v["kind"] == kind and v["detail"] == detail:
                return  # deduplicate repeat offenders
        if len(_lc_violations) >= _LC_MAX_VIOLATIONS:
            return
        _lc_violations.append({"kind": kind, "detail": detail, **ctx})
    import logging

    logging.getLogger(__name__).error(
        "lockcheck %s: %s", kind, detail)


class CheckedLock:
    """Instrumented lock for the DMLC_LOCKCHECK watchdog.  Context
    manager + acquire/release, so it drops in for ``threading.Lock``
    (and, with ``reentrant=True``, ``threading.RLock``) everywhere in
    this codebase, including as the lock behind a
    ``threading.Condition`` (whose wait() releases and re-acquires
    through these methods, keeping the held stack truthful)."""

    __slots__ = ("name", "graph_name", "_lock", "_reentrant", "_block_s",
                 "_racecheck")

    #: instance counter: edges are recorded per INSTANCE (``name#n``),
    #: not per class-level name — two queues of the same class acquired
    #: q1→q2 on one thread and q2→q1 on another are a real ABBA pair
    #: that identical names would collapse into an invisible self-edge
    _counter = [0]

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        with _lc_graph_lock:
            self._counter[0] += 1
            self.graph_name = f"{name}#{self._counter[0]}"
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self._reentrant = reentrant
        self._block_s = get_env("DMLC_LOCKCHECK_BLOCK_S", 1.0)
        self._racecheck = racecheck_enabled()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _lc_held()
        t0 = time.monotonic()
        got = self._lock.acquire(blocking, timeout)
        if not got:
            return False
        if self._racecheck:
            self._rc_note(self._rc_site())
        waited = time.monotonic() - t0
        reacquire = self._reentrant and any(l is self for l in held)
        outer = [l for l in held if l is not self]
        if outer and not reacquire:
            site = _lc_site()
            if waited > self._block_s:
                _lc_record(
                    "held-while-blocked",
                    f"acquire of {self.graph_name} blocked "
                    f"{waited:.2f}s at {site} while holding "
                    f"{[l.graph_name for l in outer]}",
                    lock=self.name, waited_s=waited, site=site)
            a, b = outer[-1].graph_name, self.graph_name
            if a != b:
                with _lc_graph_lock:
                    _lc_edges.setdefault((a, b), site)
                    inverse = _lc_edges.get((b, a))
                if inverse is not None:
                    _lc_record(
                        "order-inversion",
                        f"{b} -> {a} (at {inverse}) but also "
                        f"{a} -> {b} (at {site}) — potential "
                        f"deadlock pair",
                        locks=sorted((a, b)), site=site)
        held.append(self)
        return True

    def _rc_note(self, site: str) -> None:
        """Record this acquire's (site, lock name) pairing for the
        DMLC_RACECHECK static/dynamic cross-check."""
        try:
            base, line = site.rsplit(":", 1)
            key = (base, int(line))
        except ValueError:
            return
        with _lc_graph_lock:
            if key not in _rc_sites:
                if len(_rc_sites) >= get_env(
                        "DMLC_RACECHECK_MAX_SITES", 4096):
                    return
                _rc_sites[key] = set()
            _rc_sites[key].add(self.name)

    def _rc_site(self) -> str:
        """The ``with self.<lock>:`` frame for the racecheck pairing.
        Unlike :func:`_lc_site` this must NOT skip all of
        concurrency.py — BufferPool/ThreadedIter acquire their own
        locks here and those with-statements ARE the annotated sites —
        only CheckedLock's own plumbing frames and threading.py."""
        import sys

        own = _CHECKEDLOCK_CODE
        try:
            depth = 1
            while True:
                f = sys._getframe(depth)
                code = f.f_code
                base = code.co_filename.rsplit("/", 1)[-1]
                if base != "threading.py" and code not in own:
                    return f"{base}:{f.f_lineno}"
                depth += 1
        except (ValueError, AttributeError):
            return "?"

    def release(self) -> None:
        held = _lc_held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._lock.release()

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked() if not self._reentrant \
            else self._lock._is_owned()  # type: ignore[attr-defined]

    # -- threading.Condition integration --------------------------------
    # Condition(lock) prefers these over plain acquire/release; without
    # _is_owned a reentrant lock would fail Condition's ownership probe
    # (its fallback treats a successful try-acquire as "not owned",
    # which is wrong for an RLock the CALLER already holds).  All three
    # keep the held stack truthful across wait()'s release/reacquire.
    def _is_owned(self) -> bool:
        if self._reentrant:
            return self._lock._is_owned()  # type: ignore[attr-defined]
        return any(l is self for l in _lc_held())

    def _release_save(self):
        held = _lc_held()
        count = sum(1 for l in held if l is self)
        held[:] = [l for l in held if l is not self]
        if self._reentrant:
            state = self._lock._release_save()  # type: ignore[attr-defined]
        else:
            self._lock.release()
            state = None
        return count, state

    def _acquire_restore(self, saved) -> None:
        count, state = saved
        if self._reentrant:
            self._lock._acquire_restore(state)  # type: ignore[attr-defined]
        else:
            self._lock.acquire()
        _lc_held().extend([self] * count)

    def __repr__(self) -> str:
        return f"CheckedLock({self.name!r})"


#: CheckedLock's own frames, skipped by the racecheck site walk
_CHECKEDLOCK_CODE = frozenset(
    getattr(CheckedLock, m).__code__
    for m in ("acquire", "release", "__enter__", "__exit__",
              "_rc_note", "_rc_site", "_release_save",
              "_acquire_restore"))


def make_lock(name: str):
    """A ``threading.Lock`` — or, under ``DMLC_LOCKCHECK=1`` /
    ``DMLC_RACECHECK=1``, a :class:`CheckedLock` feeding the runtime
    watchdog — or, inside an interleaving-explorer scenario, the
    explorer's scheduler-owned lock.  ``name`` identifies the lock in
    the order graph and in violation reports; by convention
    ``Class.attr`` or ``module.attr`` (matching the static passes'
    node naming — the racecheck cross-check depends on it)."""
    if _lock_factory_hook is not None:
        lk = _lock_factory_hook(name, False)
        if lk is not None:
            return lk
    if lockcheck_enabled():
        return CheckedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """Reentrant variant of :func:`make_lock`."""
    if _lock_factory_hook is not None:
        lk = _lock_factory_hook(name, True)
        if lk is not None:
            return lk
    if lockcheck_enabled():
        return CheckedLock(name, reentrant=True)
    return threading.RLock()


def lockcheck_report() -> List[dict]:
    """Violations recorded so far (deduplicated, bounded)."""
    with _lc_graph_lock:
        return [dict(v) for v in _lc_violations]


def lockcheck_reset() -> None:
    """Clear the order graph, violation list, and racecheck site
    observations (tests)."""
    with _lc_graph_lock:
        _lc_edges.clear()
        del _lc_violations[:]
        _rc_sites.clear()


def racecheck_observed() -> dict:
    """``(file basename, line) -> sorted lock names`` observed held at
    each acquire site so far (``DMLC_RACECHECK=1`` runs)."""
    with _lc_graph_lock:
        return {k: sorted(v) for k, v in _rc_sites.items()}


def racecheck_report() -> List[dict]:
    """Cross-check the observed attribute→lock pairings against the
    static guarded-by analysis: every executed ``with self.<lock>:``
    site of a threaded class must have held the lock the race pass
    says guards that region's attributes (``Class.attr`` naming).  A
    mismatch means the static annotations and the runtime disagree —
    a renamed lock, an aliased lock instance, or a stale annotation."""
    observed = racecheck_observed()
    if not observed:
        return []
    from .analysis.core import PACKAGE, RepoIndex, default_paths
    from .analysis.race_pass import guarded_region_map

    index = RepoIndex(default_paths([PACKAGE]), None)
    expected = guarded_region_map(index)
    out: List[dict] = []
    for key, names in sorted(observed.items()):
        exp = expected.get(key)
        if exp is None:
            continue  # module-level lock, or an ambiguous basename
        for name in names:
            if name != exp:
                out.append({
                    "kind": "attr-lock-mismatch",
                    "site": f"{key[0]}:{key[1]}",
                    "expected": exp, "observed": name,
                    "detail": f"acquire at {key[0]}:{key[1]} held lock "
                              f"{name!r} but the static guarded-by "
                              f"analysis expects {exp!r} to protect "
                              f"that region's attributes"})
    return out


def racecheck_assert_clean() -> None:
    """Raise :class:`DMLCError` on any static/dynamic guarded-by
    mismatch — the smoke-test exit gate next to
    :func:`lockcheck_assert_clean`."""
    bad = racecheck_report()
    if bad:
        lines = "; ".join(v["detail"] for v in bad[:8])
        raise DMLCError(
            f"racecheck recorded {len(bad)} attribute→lock "
            f"mismatch(es): {lines}")


def lockcheck_assert_clean() -> None:
    """Raise :class:`DMLCError` when the watchdog saw violations — the
    smoke-test exit gate."""
    bad = lockcheck_report()
    if bad:
        lines = "; ".join(f"{v['kind']}: {v['detail']}" for v in bad[:8])
        raise DMLCError(
            f"lock-order watchdog recorded {len(bad)} violation(s): "
            f"{lines}")


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
        self._lock = make_lock("BufferPool._lock")
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


class ConcurrentBlockingQueue(Generic[T]):
    """Bounded MPMC blocking queue, FIFO or priority (concurrency.h:63-146).

    ``push`` blocks while ``max_size`` items are queued (0 = unbounded);
    ``pop`` blocks while it is empty.  In priority mode the highest
    ``priority`` pops first, ties in push order.  ``signal_for_kill``
    wakes every blocked producer and consumer; after it ``push`` fails
    and ``pop`` fails once the queue is empty (``SignalForKill``,
    concurrency.h:157-294).
    """

    def __init__(self, max_size: int = 0, priority: bool = False):
        self._max = max_size
        self._priority = priority
        self._fifo: deque = deque()
        self._heap: List[Tuple[int, int, T]] = []
        self._seq = 0
        self._lock = make_lock("ConcurrentBlockingQueue._lock")
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._killed = False

    def push(self, item: T, priority: int = 0) -> bool:
        with self._lock:
            while (not self._killed and self._max > 0
                   and self.size_locked() >= self._max):
                self._not_full.wait()
            if self._killed:
                return False
            if self._priority:
                # heapq is a min-heap: negate, and the sequence breaks ties
                heapq.heappush(self._heap, (-priority, self._seq, item))
                self._seq += 1
            else:
                self._fifo.append(item)
            self._not_empty.notify()
            return True

    def pop(self) -> Tuple[bool, Optional[T]]:
        with self._lock:
            while not self._killed and self.size_locked() == 0:
                self._not_empty.wait()
            if self._killed and self.size_locked() == 0:
                return False, None
            if self._priority:
                item = heapq.heappop(self._heap)[2]
            else:
                item = self._fifo.popleft()
            self._not_full.notify()
            return True, item

    def size_locked(self) -> int:
        return len(self._heap) if self._priority else len(self._fifo)

    def size(self) -> int:
        with self._lock:
            return self.size_locked()

    def signal_for_kill(self) -> None:
        with self._lock:
            self._killed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()


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


class MultiThreadedIter(Generic[T]):
    """``num_threads`` workers map ``work_fn`` over the items pulled from
    ``source_next`` (which returns ``None`` at the end); output order is
    not guaranteed.  The end of the stream is the N-th sentinel, one a
    worker, as the reference's null sentinels (threadediter.h:418-646);
    a worker's exception is raised at the ``next()`` that sees the last
    sentinel."""

    def __init__(
        self,
        source_next: Callable[[], Optional[T]],
        work_fn: Callable[[T], T],
        num_threads: int = 2,
        max_capacity: int = 8,
    ):
        self._source_next = source_next
        self._work = work_fn
        self._n = num_threads
        self._out: ConcurrentBlockingQueue = ConcurrentBlockingQueue(
            max_capacity)
        self._src_lock = make_lock("MultiThreadedIter._src_lock")
        # dmlc-check: unguarded(consumer-confined: next() is single-consumer)
        self._sentinels_seen = 0
        # dmlc-check: unguarded(consumer-confined: next() is single-consumer)
        self._ended = False
        # dmlc-check: unguarded(written before the sentinel push; read after the last sentinel pops)
        self._worker_exc: Optional[BaseException] = None
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(num_threads)]
        for t in self._threads:
            t.start()

    def _worker(self) -> None:
        try:
            while True:
                with self._src_lock:
                    item = self._source_next()
                if item is None:
                    break
                self._out.push((False, self._work(item)))
        except BaseException as exc:  # noqa: BLE001 - surfaced to consumer
            self._worker_exc = exc
        finally:
            self._out.push((True, None))  # the sentinel, failure or not

    def next(self) -> Tuple[bool, Optional[T]]:
        if self._ended:
            return False, None
        while True:
            ok, cell = self._out.pop()
            if not ok:
                self._ended = True
                return False, None
            is_sentinel, value = cell  # type: ignore[misc]
            if is_sentinel:
                self._sentinels_seen += 1
                if self._sentinels_seen == self._n:
                    self._ended = True
                    if self._worker_exc is not None:
                        exc = self._worker_exc
                        raise DMLCError(
                            f"MultiThreadedIter worker failed: "
                            f"{exc!r}") from exc
                    return False, None
                continue
            return True, value

    def destroy(self) -> None:
        self._out.signal_for_kill()
