"""Deterministic interleaving explorer for the threaded control planes
(the port of ``dmlc_tpu/analysis/interleave.py``).

The static race pass proves lock *placement*; the lockcheck watchdog
observes lock *order*; neither can answer "does any interleaving break
an invariant?"  This module does, the systematic-concurrency-testing
way (CHESS-style): a scenario's threads run one at a time under a
controlled scheduler that owns every serialization point —

  * ``concurrency.make_lock``/``make_rlock`` locks (the explorer
    installs a lock-factory hook, so the *real* production classes are
    built over scheduler-owned :class:`SchedLock` s),
  * ``threading.Condition`` waits over those locks (patched to
    :class:`SchedCondition` for the scenario's dynamic extent),
  * ``threading.Event`` s created by scenario code (patched to
    :class:`SchedEvent`), and
  * explicit :func:`sched_point` yields (``time.sleep`` on a
    controlled thread becomes one, so polling loops interleave
    instead of stalling the clock).

Between two serialization points a thread runs atomically; at each
point the scheduler picks the next runnable thread according to a
*schedule* — a replayable decision sequence.  :func:`explore` runs a
scenario under K schedules: a systematic DFS over decision prefixes up
to a depth bound, then seeded random walks — and every failure comes
back with the exact decision list, so :func:`replay` reproduces it
deterministically (no stress, no sleeps, no luck).

Timed waits are modeled as *schedulable timeouts*: a ``wait(t)`` /
``acquire(timeout=t)`` may be answered with "the deadline passed" as
one of the enabled transitions, so timeout paths (BufferPool admission
429s, drain deadlines) are explored without real time passing.

Limits (deliberate): only scheduler-owned primitives park visibly —
a controlled thread blocking on a foreign primitive (a real
``queue.Queue``, socket I/O, ``Thread.join``) trips the watchdog with
a clear error instead of wedging the run.  Scenarios drive the
interesting *methods* from explorer-spawned threads rather than the
classes' own background loops.

Known-hairy-machine scenarios live in :mod:`analysis.scenarios`;
``python -m dmlc_tpu_torch.analysis.scenarios`` runs them all.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Controller", "ExploreResult", "PrefixPolicy", "RandomPolicy",
           "RunResult", "Scenario", "SchedCondition", "SchedEvent",
           "SchedLock", "explore", "replay", "run_scenario",
           "sched_point"]

# thread states
READY = "ready"
RUNNING = "running"
ACQUIRE = "acquire"
COND_WAIT = "cond-wait"
EVENT_WAIT = "event-wait"
DONE = "done"

#: the controller whose scenario is currently installed (one at a time)
_active: Optional["Controller"] = None


class _Aborted(BaseException):
    """Raised inside a controlled thread when the run is over and the
    thread must unwind (BaseException so ``except Exception`` sweeps
    in production code cannot eat it)."""


class SchedLock:
    """Scheduler-owned lock, API-compatible with ``threading.Lock`` /
    ``RLock`` as this repo uses them (``with``, ``acquire(blocking,
    timeout)``, ``release``, ``locked``).  Mutual exclusion is enforced
    by the scheduler's one-runnable-thread discipline; the lock itself
    is pure ownership bookkeeping that decides runnability."""

    def __init__(self, ctl: "Controller", name: str, reentrant: bool):
        self.name = name
        self._ctl = ctl
        self._reentrant = reentrant
        self._owner = None   # _TState, or ("ext", ident) outside control
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ts = self._ctl._current()
        if ts is None:
            return self._acquire_uncontrolled()
        if self._owner is ts:
            if not self._reentrant:
                raise RuntimeError(
                    f"non-reentrant SchedLock {self.name} re-acquired "
                    f"by its owner — real deadlock")
            self._count += 1
            return True
        timeout_ok = (not blocking) or (timeout is not None
                                        and timeout >= 0)
        action = self._ctl._yield(ts, ACQUIRE, lock=self,
                                  timeout_ok=timeout_ok)
        if action == "timeout":
            return False
        self._owner = ts
        self._count = 1
        return True

    def _acquire_uncontrolled(self) -> bool:
        me = ("ext", threading.get_ident())
        if self._owner is None:
            self._owner, self._count = me, 1
            return True
        if self._owner == me and self._reentrant:
            self._count += 1
            return True
        raise RuntimeError(
            f"SchedLock {self.name} contended outside scenario control "
            f"(owner {self._owner!r}) — scenarios must confine "
            f"concurrency to explorer-spawned threads")

    def release(self) -> None:
        if self._count <= 0:
            raise RuntimeError(f"SchedLock {self.name} released while "
                               f"not held")
        self._count -= 1
        if self._count == 0:
            self._owner = None
        ts = self._ctl._current()
        if ts is not None:
            # a release is a serialization point too: whoever was
            # blocked on this lock is schedulable right here
            self._ctl._yield(ts, READY)

    def __enter__(self) -> "SchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._owner is not None

    def __repr__(self) -> str:
        return f"SchedLock({self.name!r})"


class SchedCondition:
    """Condition variable over a :class:`SchedLock` (installed in place
    of ``threading.Condition`` for the scenario's extent)."""

    def __init__(self, ctl: "Controller", lock: SchedLock):
        self._ctl = ctl
        self._lock = lock

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()

    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self):
        self._lock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        ts = self._ctl._current()
        if ts is None:
            raise RuntimeError("SchedCondition.wait outside scenario "
                               "control")
        if self._lock._owner is not ts:
            raise RuntimeError("wait() on un-owned condition lock")
        count, self._lock._count = self._lock._count, 0
        self._lock._owner = None
        ts.notified = False
        action = self._ctl._yield(ts, COND_WAIT, cond=self,
                                  timeout_ok=timeout is not None)
        # the scheduler only delivers go/timeout with the lock free
        self._lock._owner = ts
        self._lock._count = count
        return action == "go"

    def wait_for(self, predicate, timeout: Optional[float] = None):
        result = predicate()
        while not result:
            if not self.wait(timeout):
                return predicate()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        ts = self._ctl._current()
        if ts is not None and self._lock._owner is not ts:
            raise RuntimeError("notify() on un-owned condition lock")
        woken = 0
        for other in self._ctl._threads:
            if woken >= n:
                break
            if (other.status == COND_WAIT and other.cond is self
                    and not other.notified):
                other.notified = True
                woken += 1

    def notify_all(self) -> None:
        self.notify(len(self._ctl._threads))


class SchedEvent:
    """``threading.Event`` stand-in whose waits park under the
    scheduler (so a future's ``result()`` or a request's ``wait()`` is
    a serialization point, not an invisible stall)."""

    def __init__(self, ctl: "Controller"):
        self._ctl = ctl
        self._set = False

    def is_set(self) -> bool:
        return self._set

    isSet = is_set

    def set(self) -> None:
        self._set = True

    def clear(self) -> None:
        self._set = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._set:
            return True
        ts = self._ctl._current()
        if ts is None:
            if timeout is not None:
                return self._set  # uncontrolled timed poll: no block
            # uncontrolled untimed wait (e.g. threading internals):
            # real-time poll, bounded by the watchdog
            deadline = time.monotonic() + self._ctl.watchdog_s
            while not self._set:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        "untimed SchedEvent.wait outside scenario "
                        "control never satisfied")
                self._ctl._real_sleep(0.0005)
            return True
        action = self._ctl._yield(ts, EVENT_WAIT, event=self,
                                  timeout_ok=timeout is not None)
        return action == "go"


class _TState:
    """One controlled thread's scheduler-visible state."""

    def __init__(self, index: int, name: str, gate):
        self.index = index
        self.name = name
        self.status = READY
        self.gate = gate                # REAL Event: grant handshake
        self.action: Optional[str] = None
        self.lock: Optional[SchedLock] = None
        self.cond: Optional[SchedCondition] = None
        self.event: Optional[SchedEvent] = None
        self.timeout_ok = False
        self.notified = False
        self.exc: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None


class SchedulePolicy:
    """Decision source: ``choose(step, options)`` returns an index into
    ``options`` (a list of ``(thread_index, action)`` pairs).  The
    controller records every (choice, len) pair so any run replays via
    :class:`PrefixPolicy`."""

    def choose(self, step: int, options: List[Tuple[int, str]]) -> int:
        raise NotImplementedError


class RandomPolicy(SchedulePolicy):
    """Seeded random walk with *continuation bias*: with probability
    ``stay`` the previously-granted thread keeps running when it is
    still enabled.  Uniform walks almost never execute K consecutive
    steps of one thread (p = n^-K), but real atomic windows — "the
    whole crash-requeue completes between two reads of the drain scan"
    — are exactly such runs; biased walks find them in a bounded
    budget while still exploring switches everywhere."""

    def __init__(self, seed: int, stay: float = 0.7):
        self.seed = seed
        self.stay = stay
        self._rng = random.Random(seed)
        self._last: Optional[int] = None

    def choose(self, step: int, options: List[Tuple[int, str]]) -> int:
        if self._last is not None and self._rng.random() < self.stay:
            for i, (tidx, _action) in enumerate(options):
                if tidx == self._last:
                    return i
        i = self._rng.randrange(len(options))
        self._last = options[i][0]
        return i


class PrefixPolicy(SchedulePolicy):
    """Replay ``decisions`` verbatim, then complete deterministically
    (rotating default, so spinning pollers cannot starve peers)."""

    def __init__(self, decisions: Sequence[int] = ()):
        self.decisions = list(decisions)

    def choose(self, step: int, options: List[Tuple[int, str]]) -> int:
        if step < len(self.decisions):
            return min(self.decisions[step], len(options) - 1)
        return step % len(options)


class RunResult:
    def __init__(self, ok: bool, error: Optional[str], decisions,
                 choice_counts, trace, steps: int):
        self.ok = ok
        self.error = error
        self.decisions = decisions          # chosen indexes, per step
        self.choice_counts = choice_counts  # len(options), per step
        self.trace = trace                  # (thread, action) per step
        self.steps = steps

    def __repr__(self) -> str:
        tail = "" if self.ok else f" error={self.error!r}"
        return f"RunResult(ok={self.ok}, steps={self.steps}{tail})"


class ExploreResult:
    def __init__(self, runs: int, failures: List[RunResult]):
        self.runs = runs
        self.failures = failures

    @property
    def ok(self) -> bool:
        return not self.failures

    def __repr__(self) -> str:
        return f"ExploreResult(runs={self.runs}, " \
               f"failures={len(self.failures)})"


class Scenario:
    """One multi-threaded situation to explore.

    Subclasses implement :meth:`setup` (build the objects under test —
    their ``make_lock`` locks become scheduler-owned), :meth:`bodies`
    (the concurrent thread bodies, each a zero-arg callable), and
    :meth:`check` (invariants, raising ``AssertionError`` on
    violation; runs after every thread finished).
    """

    name = "scenario"
    #: decision budget per run; exceeding it = livelock finding
    max_ops = 20000
    #: seconds a granted thread may run between serialization points
    #: before the watchdog declares it escaped (blocked on a foreign
    #: primitive, or genuinely wedged)
    watchdog_s = 20.0

    def setup(self):
        return None

    def bodies(self, state) -> List[Tuple[str, Callable[[], None]]]:
        raise NotImplementedError

    def check(self, state) -> None:
        pass


class Controller:
    """The scheduler: one controlled thread runs at a time; every
    serialization point hands control back here."""

    def __init__(self, policy: SchedulePolicy, *,
                 max_ops: int = 20000, watchdog_s: float = 20.0):
        self.policy = policy
        self.max_ops = max_ops
        self.watchdog_s = watchdog_s
        # controller state is handshake-fenced: exactly one of the
        # scheduling thread / the single granted thread runs at any instant, and
        # every handoff goes through _drv_cv / the grant gates
        # dmlc-check: unguarded(handshake-fenced: the scheduling and the granted thread alternate)
        self._threads: List[_TState] = []
        # dmlc-check: unguarded(written by a thread's own first act; fenced by its gate)
        self._by_ident: Dict[int, _TState] = {}
        self._drv_lock = threading.Lock()
        self._drv_cv = threading.Condition(self._drv_lock)
        self._sched_ident = threading.get_ident()
        # dmlc-check: unguarded(scheduling-thread writes; parked readers only poll for liveness)
        self._phase = "idle"   # idle | setup | running | teardown
        # dmlc-check: unguarded(scheduling-thread-confined)
        self.decisions: List[int] = []
        # dmlc-check: unguarded(scheduling-thread-confined)
        self.choice_counts: List[int] = []
        # dmlc-check: unguarded(scheduling-thread-confined)
        self.trace: List[Tuple[str, str]] = []

    # ---- identity -------------------------------------------------------
    def _current(self) -> Optional[_TState]:
        return self._by_ident.get(threading.get_ident())

    def _controlled_context(self) -> bool:
        """True for the scheduling thread and controlled threads — the
        creators whose locks/events the explorer owns."""
        ident = threading.get_ident()
        return (ident == self._sched_ident or ident in self._by_ident) \
            and self._phase in ("setup", "running")

    # ---- installation ---------------------------------------------------
    def _lock_hook(self, name: str, reentrant: bool):
        if self._controlled_context():
            return SchedLock(self, name, reentrant)
        return None

    def _cond_factory(self, lock=None):
        if isinstance(lock, SchedLock):
            return SchedCondition(self, lock)
        return self._real_condition(lock) if lock is not None \
            else self._real_condition()

    def _event_factory(self):
        if self._controlled_context():
            return SchedEvent(self)
        return self._real_event()

    def _sleep(self, secs: float) -> None:
        ts = self._current()
        if ts is None:
            self._real_sleep(secs)
            return
        action = self._yield(ts, READY)
        if action == "abort":
            raise _Aborted()

    def install(self):
        """Context manager: route make_lock/Condition/Event/sleep
        through the controller for the scenario's extent."""
        return _Installed(self)

    # ---- the yield/grant handshake --------------------------------------
    def _yield(self, ts: _TState, status: str, *, lock=None, cond=None,
               event=None, timeout_ok: bool = False) -> str:
        if ts.action == "abort":
            # the run is over and this thread is unwinding (a release in
            # a ``with`` exit, say): no grant will come, so do not park
            raise _Aborted()
        with self._drv_cv:
            ts.status = status
            ts.lock, ts.cond, ts.event = lock, cond, event
            ts.timeout_ok = timeout_ok
            self._drv_cv.notify_all()
        self._park(ts)
        ts.gate.clear()
        if ts.action == "abort":
            raise _Aborted()
        return ts.action or "go"

    def _park(self, ts: _TState) -> None:
        """Wait for a grant.  A thread may sit parked for the whole
        run while peers are scheduled, so only a VANISHED scheduler (phase
        left running) aborts it — not mere patience."""
        while not ts.gate.wait(self.watchdog_s):
            if self._phase not in ("setup", "running"):
                ts.exc = ts.exc or RuntimeError(
                    f"thread {ts.name} never re-granted (scheduler gone)")
                raise _Aborted()

    def spawn(self, name: str, fn: Callable[[], None]) -> _TState:
        # the gate must be a REAL Event: it is the grant handshake the
        # scheduler itself rides, created while threading.Event is
        # patched to SchedEvent for scenario code
        ts = _TState(len(self._threads), name,
                     getattr(self, "_real_event", threading.Event)())

        def wrapper():
            self._by_ident[threading.get_ident()] = ts
            try:
                self._park(ts)
                ts.gate.clear()
                if ts.action == "abort":
                    return
                fn()
            except _Aborted:
                pass
            except BaseException as e:  # noqa: BLE001 - run verdict
                ts.exc = e
            finally:
                with self._drv_cv:
                    ts.status = DONE
                    self._drv_cv.notify_all()

        # construct + start with the REAL Event class: Thread's own
        # _started handshake must not ride the patched SchedEvent
        prev_event = threading.Event
        threading.Event = getattr(self, "_real_event", prev_event)
        try:
            ts.thread = threading.Thread(target=wrapper, daemon=True,
                                         name=f"ilv-{name}")
            self._threads.append(ts)
            ts.thread.start()
        finally:
            threading.Event = prev_event
        return ts

    # ---- the schedule loop ----------------------------------------------
    def _enabled(self) -> List[Tuple[_TState, str]]:
        options: List[Tuple[_TState, str]] = []
        for ts in self._threads:
            st = ts.status
            if st == READY:
                options.append((ts, "go"))
            elif st == ACQUIRE:
                lk = ts.lock
                if lk._owner is None:
                    options.append((ts, "go"))
                if ts.timeout_ok:
                    options.append((ts, "timeout"))
            elif st == COND_WAIT:
                if ts.cond._lock._owner is None:
                    if ts.notified:
                        options.append((ts, "go"))
                    if ts.timeout_ok:
                        options.append((ts, "timeout"))
            elif st == EVENT_WAIT:
                if ts.event._set:
                    options.append((ts, "go"))
                if ts.timeout_ok:
                    options.append((ts, "timeout"))
        return options

    def run(self) -> Optional[str]:
        """Schedule until every thread is DONE.  Returns an error
        string (deadlock, livelock, watchdog, body exception) or None."""
        self._phase = "running"
        error: Optional[str] = None
        step = 0
        try:
            while True:
                with self._drv_cv:
                    busy = [t for t in self._threads
                            if t.status == RUNNING]
                    if busy:  # should not happen: grants are awaited
                        error = f"thread {busy[0].name} still running"
                        break
                if all(t.status == DONE for t in self._threads):
                    break
                options = self._enabled()
                if not options:
                    held = [f"{t.name}:{t.status}"
                            for t in self._threads if t.status != DONE]
                    error = f"deadlock: no enabled transition " \
                            f"({', '.join(held)})"
                    break
                if step >= self.max_ops:
                    error = f"livelock: {self.max_ops} scheduling " \
                            f"decisions without quiescence"
                    break
                choice = self.policy.choose(
                    step, [(t.index, a) for t, a in options])
                choice = max(0, min(choice, len(options) - 1))
                ts, action = options[choice]
                self.decisions.append(choice)
                self.choice_counts.append(len(options))
                self.trace.append((ts.name, f"{ts.status}/{action}"))
                step += 1
                if not self._grant(ts, action):
                    error = (f"watchdog: thread {ts.name} left "
                             f"scheduler control (blocked on a foreign "
                             f"primitive or wedged) after "
                             f"{self.trace[-1]}")
                    break
            if error is None:
                failed = [t for t in self._threads if t.exc is not None]
                if failed:
                    t = failed[0]
                    error = f"thread {t.name} raised: {t.exc!r}"
        finally:
            self._abort_stragglers()
            self._phase = "teardown"
        return error

    def _grant(self, ts: _TState, action: str) -> bool:
        with self._drv_cv:
            ts.action = action
            ts.status = RUNNING
            ts.gate.set()
            deadline = time.monotonic() + self.watchdog_s
            while ts.status == RUNNING:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._drv_cv.wait(remaining)
        return True

    def _abort_stragglers(self) -> None:
        for ts in self._threads:
            if ts.status != DONE:
                ts.action = "abort"
                ts.gate.set()
        for ts in self._threads:
            if ts.thread is not None:
                ts.thread.join(timeout=2.0)


class _Installed:
    """The patch set: lock-factory hook + threading.Condition/Event +
    time.sleep, installed for the scenario's dynamic extent and always
    restored."""

    def __init__(self, ctl: Controller):
        self.ctl = ctl

    def __enter__(self):
        global _active
        if _active is not None:
            raise RuntimeError("an interleaving scenario is already "
                               "installed in this process")
        from .. import concurrency

        ctl = self.ctl
        ctl._real_condition = threading.Condition
        ctl._real_event = threading.Event
        ctl._real_sleep = time.sleep
        concurrency.set_lock_factory_hook(ctl._lock_hook)
        threading.Condition = ctl._cond_factory  # type: ignore
        threading.Event = ctl._event_factory     # type: ignore
        time.sleep = ctl._sleep                  # type: ignore
        ctl._phase = "setup"
        _active = ctl
        return ctl

    def __exit__(self, *exc):
        global _active
        from .. import concurrency

        ctl = self.ctl
        concurrency.set_lock_factory_hook(None)
        threading.Condition = ctl._real_condition  # type: ignore
        threading.Event = ctl._real_event          # type: ignore
        time.sleep = ctl._real_sleep               # type: ignore
        ctl._phase = "idle"
        _active = None
        return False


def sched_point(label: Optional[str] = None) -> None:
    """Explicit serialization point.  No-op outside a scenario, so it
    may be sprinkled into test doubles (fake transports, scripted
    workers) to expose interleavings the lock points alone miss."""
    ctl = _active
    if ctl is None:
        return
    ts = ctl._current()
    if ts is None:
        return
    action = ctl._yield(ts, READY)
    if action == "abort":
        raise _Aborted()


# ---------------------------------------------------------------------------
# running and exploring
# ---------------------------------------------------------------------------

def run_scenario(scenario: Scenario,
                 policy: SchedulePolicy) -> RunResult:
    """One scenario under one schedule."""
    ctl = Controller(policy, max_ops=scenario.max_ops,
                     watchdog_s=scenario.watchdog_s)
    error: Optional[str] = None
    with ctl.install():
        try:
            state = scenario.setup()
            for name, fn in scenario.bodies(state):
                ctl.spawn(name, fn)
            error = ctl.run()
            if error is None:
                try:
                    scenario.check(state)
                except AssertionError as e:
                    error = f"invariant violated: {e}"
        except Exception as e:  # noqa: BLE001 - setup/check defects
            error = error or f"scenario error: {e!r}"
    return RunResult(error is None, error, list(ctl.decisions),
                     list(ctl.choice_counts), list(ctl.trace),
                     len(ctl.decisions))


def explore(scenario_factory: Callable[[], Scenario], *,
            schedules: int = 64, seed: int = 0, dfs_depth: int = 10,
            stop_on_failure: bool = True) -> ExploreResult:
    """Run a scenario under up to ``schedules`` distinct schedules:
    a systematic DFS over decision prefixes (every alternative at every
    choice point within the first ``dfs_depth`` decisions) on half the
    budget, then seeded random walks (continuation-biased — see
    :class:`RandomPolicy`) on the rest.  The split is load-bearing:
    prefix DFS nails shallow orderings exhaustively but its frontier
    grows without bound, while deep atomicity windows are the biased
    walks' territory — either alone misses the other's bugs.
    Deterministic for fixed arguments."""
    failures: List[RunResult] = []
    tried = set()
    frontier: List[Tuple[int, ...]] = [()]
    runs = 0
    dfs_budget = max(1, schedules // 2)
    while frontier and runs < dfs_budget:
        prefix = frontier.pop(0)
        res = run_scenario(scenario_factory(), PrefixPolicy(prefix))
        runs += 1
        if not res.ok:
            failures.append(res)
            if stop_on_failure:
                return ExploreResult(runs, failures)
        bound = min(len(res.choice_counts), dfs_depth)
        for i in range(bound):
            for alt in range(res.choice_counts[i]):
                if alt == res.decisions[i]:
                    continue
                cand = tuple(res.decisions[:i]) + (alt,)
                if cand not in tried:
                    tried.add(cand)
                    frontier.append(cand)
    while runs < schedules:
        res = run_scenario(scenario_factory(),
                           RandomPolicy(seed * 100003 + runs))
        runs += 1
        if not res.ok:
            failures.append(res)
            if stop_on_failure:
                break
    return ExploreResult(runs, failures)


def replay(scenario_factory: Callable[[], Scenario],
           decisions: Sequence[int]) -> RunResult:
    """Re-run a scenario under a recorded decision sequence (e.g. a
    failure's ``RunResult.decisions``)."""
    return run_scenario(scenario_factory(), PrefixPolicy(decisions))
