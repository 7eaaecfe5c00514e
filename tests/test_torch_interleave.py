"""The port's interleaving explorer against the JAX package's, and its
five scenarios over the port's engine, router, pool and bucketer.

Layers, as ``tests/test_interleave.py`` has them for the reference: the
explorer's own mechanics (a racy toy caught within a bounded budget, a
safe toy clean, deterministic replay, seed determinism, ABBA deadlock,
the timed-acquire timeout as a transition, the foreign-blocking
watchdog, patches restored), here each on the same toy built over each
package's own ``make_lock`` and explored by each package's explorer for
seeds 0, 1 and 7: equal run counts and equal first-failure decision
lists.  Then the port's scenarios on the current tree (60 schedules,
seed 0), the reverted drain caught within 400 schedules and replayed,
the fixed drain clean over the same budget, and the lock-factory hook
kept out of the engine's process-wide programs.

Every explorer test of the port lives in this file: one process may
install one explorer at a time.
"""

import json
import logging
import os
import queue
import subprocess
import sys
import threading
import time
import types

import pytest

from dmlc_tpu.analysis import interleave as jilv
from dmlc_tpu.concurrency import BufferPool as JBufferPool
from dmlc_tpu.concurrency import make_lock as jmake_lock
from dmlc_tpu_torch.analysis import interleave as pilv
from dmlc_tpu_torch.analysis import scenarios as psc
from dmlc_tpu_torch.concurrency import BufferPool as PBufferPool
from dmlc_tpu_torch.concurrency import make_lock as pmake_lock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = pilv.__name__.split(".")[0]
SEEDS = [0, 1, 7]

logging.getLogger(f"{PKG}.serving").setLevel(logging.ERROR)
logging.getLogger("dmlc_tpu.serving").setLevel(logging.ERROR)


@pytest.fixture(autouse=True, scope="module")
def _isolated_telemetry():
    """The scenarios record drain events, gauges and router decisions in
    the port's process-wide rings; leave none behind for the next file
    of this worker."""
    yield
    from dmlc_tpu_torch import telemetry
    from dmlc_tpu_torch.telemetry import tracecontext

    telemetry.reset_events()
    tracecontext.reset_decisions()


# ---- the toys, built over one package's explorer and make_lock ----------

def _toys(ilv, make_lock, buffer_pool):
    """The reference test's toy scenarios over ``ilv`` (an explorer
    module) and ``make_lock``/``buffer_pool`` of the same package."""

    class RacyCounter:
        """Lost-update bug: check-then-act with the lock dropped across
        the gap."""

        def __init__(self):
            self._lock = make_lock("_RacyCounter._lock")
            self.value = 0

        def racy_inc(self):
            with self._lock:
                v = self.value
            ilv.sched_point("gap")
            with self._lock:
                self.value = v + 1

        def safe_inc(self):
            with self._lock:
                self.value += 1

    class Racy(ilv.Scenario):
        name = "racy-counter"

        def setup(self):
            return RacyCounter()

        def bodies(self, c):
            return [("a", c.racy_inc), ("b", c.racy_inc)]

        def check(self, c):
            assert c.value == 2, f"lost update: value={c.value}"

    class Safe(Racy):
        def bodies(self, c):
            return [("a", c.safe_inc), ("b", c.safe_inc)]

    class Deadlock(ilv.Scenario):
        """The ABBA pair.  The reference test's toy takes its locks in
        ``with`` blocks; these take them by hand, the same acquires and
        releases, so that a deadlocked thread of the JAX explorer
        unwinds at once instead of waiting out its join timeout (a
        ``with`` exit parks it again there)."""

        name = "abba"

        def setup(self):
            return (make_lock("abba.A"), make_lock("abba.B"))

        def bodies(self, state):
            a, b = state

            def ab():
                a.acquire()
                ilv.sched_point()
                b.acquire()
                b.release()
                a.release()

            def ba():
                b.acquire()
                ilv.sched_point()
                a.acquire()
                a.release()
                b.release()

            return [("ab", ab), ("ba", ba)]

    class DeadlockWith(Deadlock):
        """The reference test's toy itself, with ``with`` blocks."""

        def bodies(self, state):
            a, b = state

            def ab():
                with a:
                    ilv.sched_point()
                    with b:
                        pass

            def ba():
                with b:
                    ilv.sched_point()
                    with a:
                        pass

            return [("ab", ab), ("ba", ba)]

    outcomes = set()

    class TimedAcquire(ilv.Scenario):
        name = "timed-acquire"

        def setup(self):
            pool = buffer_pool(object, capacity=1)
            held = pool.acquire()
            return pool, held

        def bodies(self, state):
            pool, held = state

            def taker():
                outcomes.add(pool.acquire(timeout=1.0) is None)

            def releaser():
                ilv.sched_point()
                pool.release(held)

            return [("take", taker), ("release", releaser)]

    class ForeignBlock(ilv.Scenario):
        name = "foreign-block"
        watchdog_s = 0.5

        def setup(self):
            return queue.Queue()

        def bodies(self, q):
            return [("blocker", lambda: q.get(timeout=30))]

    return types.SimpleNamespace(
        ilv=ilv, make_lock=make_lock, Racy=Racy, Safe=Safe,
        Deadlock=Deadlock, DeadlockWith=DeadlockWith,
        TimedAcquire=TimedAcquire, outcomes=outcomes,
        ForeignBlock=ForeignBlock)


J = _toys(jilv, jmake_lock, JBufferPool)
P = _toys(pilv, pmake_lock, PBufferPool)


def _same(jres, pres):
    """Equal run counts and equal failure decision lists."""
    assert pres.runs == jres.runs, (pres, jres)
    assert [f.decisions for f in pres.failures] == \
        [f.decisions for f in jres.failures]


# ---- the toys: detection, replay, determinism ---------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_racy_toy_caught_within_budget(seed):
    jres = jilv.explore(J.Racy, schedules=40, seed=seed)
    pres = pilv.explore(P.Racy, schedules=40, seed=seed)
    assert not pres.ok, "explorer missed the planted lost update"
    assert "lost update" in pres.failures[0].error
    _same(jres, pres)


@pytest.mark.parametrize("seed", SEEDS)
def test_safe_toy_clean_over_same_budget(seed):
    jres = jilv.explore(J.Safe, schedules=40, seed=seed)
    pres = pilv.explore(P.Safe, schedules=40, seed=seed)
    assert pres.ok, pres.failures
    _same(jres, pres)


@pytest.mark.parametrize("seed", SEEDS)
def test_failure_replays_deterministically(seed):
    f = pilv.explore(P.Racy, schedules=40, seed=seed).failures[0]
    # the stable first line: assertion introspection may append reprs
    head = f.error.splitlines()[0]
    for _ in range(3):
        rep = pilv.replay(P.Racy, f.decisions)
        assert not rep.ok and rep.error.splitlines()[0] == head
        assert rep.decisions[:len(f.decisions)] == f.decisions
    jrep = jilv.replay(J.Racy, f.decisions)
    assert jrep.error.splitlines()[0] == head
    assert jrep.decisions == rep.decisions and jrep.trace == rep.trace


@pytest.mark.parametrize("seed", SEEDS)
def test_explore_is_deterministic_for_fixed_seed(seed):
    a = pilv.explore(P.Racy, schedules=40, seed=seed, stop_on_failure=False)
    b = pilv.explore(P.Racy, schedules=40, seed=seed, stop_on_failure=False)
    _same(a, b)
    _same(jilv.explore(J.Racy, schedules=40, seed=seed,
                       stop_on_failure=False), a)


# ---- deadlock + timeout modeling ----------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_abba_deadlock_detected(seed):
    jres = jilv.explore(J.Deadlock, schedules=30, seed=seed)
    pres = pilv.explore(P.Deadlock, schedules=30, seed=seed)
    assert not pres.ok
    assert "deadlock" in pres.failures[0].error
    assert pres.failures[0].error == jres.failures[0].error
    _same(jres, pres)


def test_abba_in_with_blocks_detected_and_unwound():
    """The reference test's own toy: the same verdict and decisions as
    the hand-taken pair, and the deadlocked threads unwind through their
    ``with`` exits without waiting out the join timeout."""
    t0 = time.monotonic()
    res = pilv.explore(P.DeadlockWith, schedules=30, seed=0)
    assert time.monotonic() - t0 < 1.5
    assert not res.ok and "deadlock" in res.failures[0].error
    _same(pilv.explore(P.Deadlock, schedules=30, seed=0), res)


@pytest.mark.parametrize("seed", SEEDS)
def test_timed_acquire_timeout_is_a_schedulable_transition(seed):
    """Some schedule delivers the timeout (acquire returns None) though
    no real time passes; some schedule delivers the buffer."""
    J.outcomes.clear()
    P.outcomes.clear()
    jres = jilv.explore(J.TimedAcquire, schedules=60, seed=seed,
                        stop_on_failure=False)
    pres = pilv.explore(P.TimedAcquire, schedules=60, seed=seed,
                        stop_on_failure=False)
    assert pres.ok, pres.failures
    assert P.outcomes == {True, False} == J.outcomes, P.outcomes
    _same(jres, pres)


def test_foreign_blocking_trips_watchdog():
    """A controlled thread parking on a primitive the scheduler cannot
    see produces a clear watchdog error, not a wedged run."""
    pres = pilv.run_scenario(P.ForeignBlock(), pilv.PrefixPolicy())
    assert not pres.ok
    assert pres.error == (
        "watchdog: thread blocker left scheduler control (blocked on a "
        "foreign primitive or wedged) after ('blocker', 'ready/go')")


def test_patches_restored_after_scenario():
    cond_before = threading.Condition
    event_before = threading.Event
    sleep_before = time.sleep
    pilv.run_scenario(P.Racy(), pilv.PrefixPolicy())
    assert threading.Condition is cond_before
    assert threading.Event is event_before
    assert time.sleep is sleep_before
    # a lock built outside any scenario is a plain lock again
    assert not isinstance(pmake_lock("post.scenario"), pilv.SchedLock)
    from dmlc_tpu_torch import concurrency

    assert concurrency._lock_factory_hook is None


def test_a_second_install_is_refused():
    ctl = pilv.Controller(pilv.PrefixPolicy())
    with ctl.install():
        with pytest.raises(RuntimeError, match="already installed"):
            with pilv.Controller(pilv.PrefixPolicy()).install():
                pass
    assert pilv._active is None


# ---- the port's scenarios on the current tree ---------------------------

@pytest.mark.parametrize("cls", psc.SCENARIOS,
                         ids=[c.name for c in psc.SCENARIOS])
def test_port_scenarios_hold(cls):
    factory = ((lambda: cls("fixed", device="cpu"))
               if cls is psc.DrainRaceScenario else cls)
    res = pilv.explore(factory, schedules=60, seed=0)
    assert res.ok, res.failures[0].error


def test_reverted_drain_fix_is_caught_deterministically():
    res, rep = psc.catch_reverted_drain(schedules=400, seed=0,
                                        device="cpu")
    assert not res.ok, "explorer missed the reverted drain race"
    f = res.failures[0]
    assert "swept by a concluding drain" in f.error
    assert not rep.ok and rep.error == f.error
    assert rep.decisions == f.decisions


def test_shipped_drain_holds_over_same_budget():
    res = pilv.explore(
        lambda: psc.DrainRaceScenario("fixed", device="cpu"),
        schedules=400, seed=0)
    assert res.ok, res.failures[0].error
    assert res.runs == 400


def test_scenarios_take_the_card_unless_given_a_device(monkeypatch):
    """With no device named, the drain scenario, its model, both
    explorations and the runner resolve to the card, and raise naming
    ``device='cpu'`` where there is none (as every entry point of the
    port does)."""
    import torch

    from dmlc_tpu_torch.base import DMLCError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = (psc.DrainRaceScenario, psc.tiny_model,
             lambda: psc.run_all(1, verbose=False),
             lambda: psc.catch_reverted_drain(1),
             lambda: psc.main(["--schedules", "1"]))
    for call in calls:
        with pytest.raises(DMLCError, match="device='cpu'"):
            call()
    assert psc.DrainRaceScenario(device="cpu").device.type == "cpu"


def test_scenarios_runner_exits_by_verdict(monkeypatch, capsys):
    """``python -m <package>.analysis.scenarios``: 0 with the teeth
    and every scenario holding, 1 when a scenario fails."""
    assert psc.main(["--schedules", "24", "--device", "cpu"]) == 0
    assert "all scenarios clean" in capsys.readouterr().out
    monkeypatch.setattr(psc, "SCENARIOS", psc.SCENARIOS + (P.Racy,))
    assert psc.main(["--schedules", "24", "--device", "cpu"]) == 1
    assert "FAIL racy-counter: invariant violated: lost update" in \
        capsys.readouterr().out


# ---- the lock-factory hook stays out of the engine's programs -----------

_PROMPTS = ([1, 2, 3], [4, 5, 6, 7])

_PLAIN_ENGINE = """
import json, torch
from {pkg}.models.transformer import TransformerConfig, init_params
from {pkg}.serving.engine import InferenceEngine
cfg = TransformerConfig(vocab=32, d_model=8, n_heads=2, head_dim=4,
                        d_ff=16, n_layers=1, n_experts=1)
model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
eng = InferenceEngine(model, device="cpu", n_blocks=16, block_size=4,
                      max_active=2, queue_depth=4)
reqs = [eng.submit(p, max_new_tokens=8) for p in {prompts!r}]
eng.start()
assert all(r.wait(60) and r.error is None for r in reqs)
eng.close()
print(json.dumps([list(r.generated) for r in reqs]))
""".format(pkg=PKG, prompts=list(_PROMPTS))


def test_engine_after_a_scenario_serves_clean():
    """A scenario builds the process's first engine for its
    ``max_active``; a fresh engine of that key, outside the explorer,
    then serves two requests while another thread reads ``/compute``'s
    site ledger.  Nothing raises, and the tokens equal those of an
    engine in a process the explorer never entered (profiling off
    there: it changes no token)."""
    from dmlc_tpu_torch.serving import engine as peng
    from dmlc_tpu_torch.telemetry import compute

    env = dict(os.environ, PYTHONPATH=REPO, DMLC_COMPUTE_PROFILE="0")
    plain = subprocess.Popen([sys.executable, "-c", _PLAIN_ENGINE],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=env, cwd=REPO)
    try:
        # the scenario's engine must be the first of its decode key
        for key in list(peng._PROGRAMS):
            if key[-1] == 2:
                del peng._PROGRAMS[key]
        res = pilv.run_scenario(
            psc.DrainRaceScenario("fixed", device="cpu"),
            pilv.PrefixPolicy())
        assert res.ok, res.error
        assert any(key[-1] == 2 for key in peng._PROGRAMS)
        for site in peng._PROGRAMS.values():
            assert not isinstance(getattr(site, "_lock", None),
                                  pilv.SchedLock)

        eng = peng.InferenceEngine(psc.tiny_model("cpu"), device="cpu",
                                   n_blocks=16, block_size=4, max_active=2,
                                   queue_depth=4)
        reqs = [eng.submit(p, max_new_tokens=8) for p in _PROMPTS]
        stop = threading.Event()
        errors = []

        def reader():
            try:
                while not stop.is_set():
                    compute.report()
            except BaseException as e:  # noqa: BLE001 - the verdict
                errors.append(e)

        interval = sys.getswitchinterval()
        # switch often, so each side runs while the other holds a lock
        sys.setswitchinterval(1e-5)
        th = threading.Thread(target=reader, daemon=True)
        th.start()
        try:
            eng.start()
            done = [r.wait(60) for r in reqs]
        finally:
            stop.set()
            th.join(30)
            sys.setswitchinterval(interval)
            eng.close()
        assert done == [True, True]
        assert not errors, errors
        assert [r.error for r in reqs] == [None, None]
        out, err = plain.communicate(timeout=120)
    finally:
        if plain.poll() is None:
            plain.kill()
            plain.wait()
    assert plain.returncode == 0, err[-3000:]
    assert [list(r.generated) for r in reqs] == \
        json.loads(out.strip().splitlines()[-1])
