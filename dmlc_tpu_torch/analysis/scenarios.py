"""Interleaving scenarios for the known-hairy threaded machines (the port
of ``dmlc_tpu/analysis/scenarios.py``, over the port's own classes).

Each scenario drives the *real* production classes (their
``make_lock`` locks become scheduler-owned via the explorer's factory
hook) through a small multi-threaded situation with an invariant that
every schedule must preserve:

  * ``scheduler-drain``   — ``InferenceEngine.drain`` racing the crash
    path's backward move (``requeue_active``: active → waiting).
    :func:`drain_pre_pr13` reverts the seqlock fix so the explorer
    proves it would have caught the race.  The engine holds a tiny
    model (vocab 32, d_model 8, 2 heads of 4, d_ff 16, 1 layer) drawn
    from a seeded generator on the scenario's ``device`` (the card
    unless the caller names another); no forward runs, so no kernel
    launches, on any device.
  * ``router-sweep``      — ``Router`` circuit transitions
    (down/alive/draining) under concurrent placement and latency
    recording.
  * ``bufferpool``        — ``BufferPool`` blocked acquire vs release
    vs ``kill()`` wake: a killed pool never hands out a buffer, a
    waiter never hangs.
  * ``bucketer-join``     — ``GradientBucketer`` +
    ``CollectiveFuture`` on torch leaves: a mid-reduction collective
    failure must surface at the join with every future resolved and
    the bucketer immediately reusable (the all-or-nothing elastic
    contract).
  * ``dedupe-admission``  — the engine ``_DedupeTable`` claim /
    drop / finish admission race: one live owner per idempotency key,
    ever.

The port's engine admits through ``_Slots`` (a condition over its own
``make_lock``) where the reference's uses a ``BufferPool``, so the drain
scenario's serialization points, and with them its decision lists,
differ from the reference's; the verdicts are the same.

The classes under test are imported with this module, outside any
scenario, so that no module-level lock of theirs is built over a
scheduler-owned lock.  ``python -m dmlc_tpu_torch.analysis.scenarios``
runs every scenario (seeded, bounded), checks that the reverted drain
is caught and replays, and exits 1 on any failure.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from ..base import resolve_device
from ..concurrency import BufferPool, make_lock
from ..models.transformer import TransformerConfig, init_params
from ..parallel.overlap import CollectiveFuture, GradientBucketer
from ..serving.engine import InferenceEngine, _DedupeTable
from ..serving.router import Router
from ..serving.scheduler import AlreadyFinished, Request
from ..telemetry.requests import RequestLedger
from ..telemetry.slo import SLOMonitor
from .interleave import Scenario, explore, replay, sched_point

__all__ = ["SCENARIOS", "BucketerJoinScenario", "BufferPoolScenario",
           "DedupeAdmissionScenario", "DrainRaceScenario",
           "RouterSweepScenario", "catch_reverted_drain",
           "drain_pre_pr13", "main", "run_all", "tiny_config",
           "tiny_model"]


# ---------------------------------------------------------------------------
# scheduler-drain: the drain-vs-crash-requeue race
# ---------------------------------------------------------------------------

def tiny_config() -> TransformerConfig:
    """The drain scenario's model: the reference scenario's widths."""
    return TransformerConfig(vocab=32, d_model=8, n_heads=2, head_dim=4,
                             d_ff=16, n_layers=1, n_experts=1)


def tiny_model(device=None, cfg=None):
    """:func:`tiny_config` (or ``cfg``) with weights from a generator on
    ``device`` (the card unless given) seeded with 0."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    return init_params(cfg if cfg is not None else tiny_config(), gen,
                       device=dev)


def drain_pre_pr13(eng, timeout_s: float) -> bool:
    """``InferenceEngine.drain`` as it stood before the seqlock fix:
    the scan reads waiting → stepping → active in flow order but never
    re-reads the wait queue, so a backward move (crash requeue /
    self-preemption: active → waiting) completing entirely between the
    first and last read is invisible — the scan concludes "drained" and
    ``close()`` sweeps a recoverable request.  Kept so the interleaving
    explorer can demonstrate, on demand, that it reproduces the bug
    deterministically."""
    eng.begin_drain()
    deadline = time.monotonic() + timeout_s
    while (eng.scheduler.n_waiting or eng._step_seq % 2
           or eng.scheduler.n_active):
        if time.monotonic() > deadline:
            eng.close()
            return False
        time.sleep(0.02)
    eng.close()
    return True


class DrainRaceScenario(Scenario):
    """One active request; a drain scan races one crashed engine
    iteration that requeues the request (recompute-resume) and then
    completes it.  Invariant: the request finishes DONE — a concluding
    drain must never sweep a recoverable generation."""

    name = "scheduler-drain"
    max_ops = 4000

    def __init__(self, drain_impl: str = "fixed", device=None):
        self.drain_impl = drain_impl
        self.device = resolve_device(device)

    def setup(self):
        eng = InferenceEngine(
            tiny_model(self.device), device=self.device, n_blocks=16,
            block_size=4, max_active=2, queue_depth=4, admit_timeout_s=0.1,
            slo_monitor=SLOMonitor())
        eng.requests = RequestLedger(slo=eng.slo)
        req = eng.submit([1, 2, 3], max_new_tokens=4)
        # hand-run the prefill transition the engine thread would do:
        # the request becomes ACTIVE mid-generation with cached blocks
        got = eng.scheduler.next_prefill()
        assert got is req
        assert eng.cache.allocate(req.id, len(req.context_ids()))
        req.generated.append(7)
        eng.scheduler.activate(req)
        return {"eng": eng, "req": req, "drained": []}

    def bodies(self, state):
        eng, req = state["eng"], state["req"]

        def drainer():
            if self.drain_impl == "pr13":
                state["drained"].append(drain_pre_pr13(eng, 8.0))
            else:
                state["drained"].append(eng.drain(timeout_s=8.0))

        def engine():
            # one crashed iteration (the _loop except-path), then the
            # recompute-resume completing — a backward move (active ->
            # waiting) followed by a forward re-transit (waiting ->
            # pop window -> active) in ONE scan's lifetime.  Seq
            # increments mirror the real step()/crash flow: the crashed
            # step's finally runs before the except-path requeue; the
            # resume pop runs inside the next step's odd interval.
            eng._step_seq += 1
            sched_point("iteration")
            eng._step_seq += 1
            sched_point("crash-begin")
            eng.scheduler.requeue_active(req)
            sched_point("crash-end")
            eng._step_seq += 1
            sched_point("resume-begin")
            got = eng.scheduler.next_prefill()
            if got is not None:
                assert eng.cache.allocate(got.id, len(got.context_ids()))
                eng.scheduler.activate(got)
            eng._step_seq += 1
            sched_point("resume-end")
            if got is not None:
                try:
                    eng._finish(got)
                except AlreadyFinished:
                    pass

        return [("drain", drainer), ("engine", engine)]

    def check(self, state):
        req = state["req"]
        assert state["drained"] == [True], \
            f"drain did not conclude cleanly: {state['drained']}"
        assert req.state == "done" and req.error is None, (
            f"recoverable crash-requeued request swept by a concluding "
            f"drain: state={req.state!r} error={req.error!r}")


# ---------------------------------------------------------------------------
# router-sweep: circuit transitions under concurrent dispatch
# ---------------------------------------------------------------------------

class RouterSweepScenario(Scenario):
    """Health-sweep verdicts (down / alive / draining) racing
    placement and latency recording on a 2-replica Router."""

    name = "router-sweep"
    max_ops = 4000

    def setup(self):
        router = Router(["http://a:1", "http://b:1"],
                        start_health_thread=False,
                        hedge_after_p99_mult=2.0, hedge_min_samples=2)
        return {"router": router, "picked": []}

    def bodies(self, state):
        router = state["router"]
        rep0 = router.replicas[0]

        def down_then_alive():
            router._mark_down(rep0, "probe failed: test")
            sched_point()
            router._mark_alive(rep0, {"draining": False, "active": 1,
                                      "waiting": 0, "max_active": 4,
                                      "requests": {"live_requests": 1,
                                                   "live_waiting": 0}})

        def draining():
            router._mark_draining(router.replicas[1])
            sched_point()
            router._mark_alive(router.replicas[1], {"draining": False,
                                                    "requests": {}})

        def dispatcher():
            for _ in range(3):
                rep = router.pick()
                state["picked"].append(None if rep is None else rep.url)
                router._record_latency(0.05)
                router.retry_after_s()
                router.hedge_after_s()
                sched_point()
            router.stats()

        return [("down-alive", down_then_alive),
                ("draining", draining), ("dispatch", dispatcher)]

    def check(self, state):
        router = state["router"]
        c = router.counts()
        assert sum(c.values()) == 2, c
        for rep in router.replicas:
            if rep.state == "healthy":
                assert rep.fail_streak == 0, \
                    f"healthy replica kept fail_streak " \
                    f"{rep.fail_streak}"
        with router._lock:
            assert len(router._latencies) <= 512
        # a pick result names a known replica, whatever the schedule
        urls = {r.url for r in router.replicas}
        for u in state["picked"]:
            assert u is None or u in urls


# ---------------------------------------------------------------------------
# bufferpool: blocked acquire vs release vs kill-wake
# ---------------------------------------------------------------------------

class BufferPoolScenario(Scenario):
    """Capacity-1 pool, buffer held at start: a timed acquire races a
    release and a kill.  The waiter must always resolve (buffer or
    None), and a killed pool never hands out a buffer afterwards."""

    name = "bufferpool"
    max_ops = 2000

    def setup(self):
        pool = BufferPool(object, capacity=1)
        held = pool.acquire()
        assert held is not None
        return {"pool": pool, "held": held, "got": []}

    def bodies(self, state):
        pool = state["pool"]

        def acquirer():
            state["got"].append(pool.acquire(timeout=5.0))

        def releaser():
            sched_point()
            pool.release(state["held"])

        def killer():
            sched_point()
            pool.kill()

        return [("acquire", acquirer), ("release", releaser),
                ("kill", killer)]

    def check(self, state):
        pool, held = state["pool"], state["held"]
        assert len(state["got"]) == 1, "acquirer never resolved"
        got = state["got"][0]
        assert got is None or got is held, \
            "cap-1 pool handed out a second buffer"
        # post-kill the pool is poisoned for good
        assert pool.acquire(timeout=0) is None


# ---------------------------------------------------------------------------
# bucketer-join: collective failure transport + all-or-nothing join
# ---------------------------------------------------------------------------

class _ScriptedWorker:
    """Controlled stand-in for ``_CollectiveThread``: thunks queue
    under a scheduler-owned lock and a scenario thread drains them, so
    the worker's schedule is explored instead of riding a real
    ``queue.Queue`` the explorer cannot see into."""

    def __init__(self):
        self._lock = make_lock("_ScriptedWorker._lock")
        self.jobs: List = []
        self.taken = 0

    def submit(self, fn):
        fut = CollectiveFuture()
        with self._lock:
            self.jobs.append((fn, fut))
        return fut

    def next_job(self):
        with self._lock:
            if self.taken < len(self.jobs):
                job = self.jobs[self.taken]
                self.taken += 1
                return job
        return None

    def close(self):
        pass


class BucketerJoinScenario(Scenario):
    """Bucket 2 of 3 fails on the collective thread; the join on the
    training thread must re-raise it with every future resolved and
    the bucketer reusable for an immediately-following clean
    reduction (the elastic resize contract)."""

    name = "bucketer-join"
    max_ops = 4000

    def setup(self):
        bucketer = GradientBucketer(lambda buf: buf * 2.0,
                                    bucket_bytes_=16)  # 4 f32 elems
        worker = _ScriptedWorker()
        bucketer._worker = worker
        leaves = [torch.arange(6, dtype=torch.float32),
                  torch.arange(6, 12, dtype=torch.float32)]  # 3 buckets
        return {"bucketer": bucketer, "worker": worker,
                "leaves": leaves, "out": {}}

    def bodies(self, state):
        bucketer, worker = state["bucketer"], state["worker"]
        leaves = state["leaves"]

        def train():
            try:
                bucketer.reduce_leaves(leaves)
                state["out"]["first"] = "no-error"
            except RuntimeError as e:
                state["out"]["first"] = str(e)
            state["out"]["done"] = True
            # the bucketer must be reusable right after the failed join
            state["out"]["second"] = bucketer.reduce_leaves(leaves)

        def collective():
            failed = False
            while True:
                job = worker.next_job()
                if job is None:
                    if state["out"].get("second") is not None:
                        return
                    sched_point("idle")
                    continue
                fn, fut = job
                sched_point("pre-run")
                if worker.taken == 2 and not failed:
                    failed = True
                    fut.set_exception(RuntimeError("collective boom"))
                    continue
                try:
                    fut.set_result(fn())
                except BaseException as e:  # noqa: BLE001 - transport
                    fut.set_exception(e)

        return [("train", train), ("collective", collective)]

    def check(self, state):
        out = state["out"]
        assert out.get("first") == "collective boom", out.get("first")
        second = out.get("second")
        assert second is not None, "bucketer not reusable after failure"
        flat = torch.cat(state["leaves"]).numpy()
        got = np.concatenate([s.reshape(-1).numpy() for s in second])
        assert np.array_equal(got, flat * 2.0), \
            "post-failure reduction produced wrong values"


# ---------------------------------------------------------------------------
# dedupe-admission: one live owner per idempotency key
# ---------------------------------------------------------------------------

class DedupeAdmissionScenario(Scenario):
    """Two concurrent submits claim the same ``request_id`` while a
    failed-admission drop races them.  Whatever the schedule: claims
    resolve to ONE owner at a time, a drop only evicts its own
    request, and the live/done tables never both own the key."""

    name = "dedupe-admission"
    max_ops = 2000

    def setup(self):
        dt = _DedupeTable(4)
        r1 = Request([1], 2)
        r2 = Request([2], 2)
        return {"dt": dt, "r1": r1, "r2": r2, "won": {}}

    def bodies(self, state):
        dt, r1, r2 = state["dt"], state["r1"], state["r2"]

        def submit1():
            state["won"]["a"] = dt.claim("k", r1)

        def submit2():
            sched_point()
            state["won"]["b"] = dt.claim("k", r2)

        def dropper():
            sched_point()
            dt.drop("k", r1)  # r1's admission failed; only evicts r1

        def finisher():
            sched_point()
            owner = dt.get("k")
            if owner is not None:
                dt.finish("k", owner)

        return [("submit1", submit1), ("submit2", submit2),
                ("drop", dropper), ("finish", finisher)]

    def check(self, state):
        dt = state["dt"]
        a, b = state["won"].get("a"), state["won"].get("b")
        assert a is not None and b is not None
        # both claims resolved to a request that owned the key; if
        # they disagree, the first owner must have been dropped or
        # finished in between — never two concurrent live owners
        live = dt._live.get("k")
        done = dt._done.get("k")
        assert not (live is not None and done is not None), \
            "key owned by both the live table and the finished ring"
        owner = live or done
        assert owner in (None, a, b)
        if a is not b:
            # a second claim minted a fresh owner: legal only because
            # the drop evicted r1 first — r1 must no longer own the key
            assert state["r1"] is not live
        assert list(dt._order) == [k for k in dt._order
                                   if k in dt._done]


SCENARIOS = (DrainRaceScenario, RouterSweepScenario, BufferPoolScenario,
             BucketerJoinScenario, DedupeAdmissionScenario)


def run_all(schedules: int = 64, seed: int = 0, verbose: bool = True,
            device=None):
    """Explore every registered scenario; returns {name: ExploreResult}.
    The drain scenario's engine lives on ``device`` (the card unless
    given)."""
    device = resolve_device(device)
    out = {}
    for cls in SCENARIOS:
        factory = ((lambda: DrainRaceScenario("fixed", device=device))
                   if cls is DrainRaceScenario else cls)
        res = explore(factory, schedules=schedules, seed=seed)
        out[cls.name] = res
        if verbose:
            print(f"  {cls.name}: {res}")
    return out


def catch_reverted_drain(schedules: int = 400, seed: int = 0,
                         device=None):
    """The explorer's teeth: explore the reverted drain, which must fail
    with the sweep error, and replay the failure from its decisions.
    The engine lives on ``device`` (the card unless given).  Returns
    ``(ExploreResult, replayed RunResult or None)``."""
    device = resolve_device(device)
    factory = lambda: DrainRaceScenario("pr13", device=device)  # noqa: E731
    res = explore(factory, schedules=schedules, seed=seed)
    rep = replay(factory, res.failures[0].decisions) if res.failures \
        else None
    return res, rep


def main(argv=None) -> int:
    """Teeth, then every scenario on the current tree; 0 when both
    hold, 1 otherwise."""
    import argparse
    import logging

    ap = argparse.ArgumentParser(
        prog="python -m dmlc_tpu_torch.analysis.scenarios",
        description="explore the interleaving scenarios")
    ap.add_argument("--schedules", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the drain scenario's device (default: the card)")
    args = ap.parse_args(argv)
    # scenario threads drive circuit transitions thousands of times;
    # the router's (correct) state-change warnings would drown the
    # output
    logging.getLogger("dmlc_tpu_torch.serving").setLevel(logging.ERROR)
    t0 = time.monotonic()
    ok = True
    res, rep = catch_reverted_drain(args.schedules, args.seed, args.device)
    if res.ok:
        print(f"FAIL teeth: the reverted drain held over {res.runs} "
              f"schedules")
        ok = False
    else:
        f = res.failures[0]
        if "swept by a concluding drain" not in (f.error or ""):
            print(f"FAIL teeth: wrong failure: {f.error}")
            ok = False
        elif rep is None or rep.ok or rep.error != f.error:
            print(f"FAIL teeth: the failure did not replay: "
                  f"{None if rep is None else rep.error!r}")
            ok = False
        else:
            print(f"  teeth: reverted drain caught on run {res.runs} "
                  f"({len(f.decisions)} decisions), replays")
    for name, r in run_all(args.schedules, args.seed, verbose=False,
                           device=args.device).items():
        if r.ok:
            print(f"  scenario {name}: clean over {r.runs} schedules")
        else:
            f = r.failures[0]
            print(f"FAIL {name}: {f.error}\n  decisions={f.decisions}")
            ok = False
    print(f"{'all scenarios clean' if ok else 'scenarios FAILED'} "
          f"({time.monotonic() - t0:.1f} s, {args.schedules} schedules, "
          f"seed {args.seed})")
    return 0 if ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
