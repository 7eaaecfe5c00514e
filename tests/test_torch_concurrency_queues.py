"""The port's ``ConcurrentBlockingQueue`` and ``MultiThreadedIter``
against the JAX package's.

Seeded push/pop/size/kill sequences go through both queues, FIFO and
priority, bounded and not, and must give equal results in equal order;
blocked producers and consumers are woken by ``signal_for_kill`` in
both.  ``MultiThreadedIter`` maps the same source through the same work
at 1, 2 and 3 threads and must give the reference's multiset of
outputs, and a worker's exception must surface at ``next()`` with the
reference's type and cause.
"""

import threading

import numpy as np
import pytest

from dmlc_tpu import concurrency as jc
from dmlc_tpu_torch import concurrency as pc


def test_queue_classes_are_exported():
    for name in ("ConcurrentBlockingQueue", "MultiThreadedIter"):
        assert name in pc.__all__
        assert name in jc.__all__


def _ops(seed, n=400):
    """A seeded op script: push (item, priority), pop, size, and one
    kill two thirds of the way in."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        r = rng.random()
        if i == 2 * n // 3:
            ops.append(("kill",))
        elif r < 0.55:
            ops.append(("push", i, int(rng.integers(0, 4))))
        elif r < 0.9:
            ops.append(("pop",))
        else:
            ops.append(("size",))
    return ops


def _drive(mod, ops, max_size, priority):
    """Run ``ops`` on one package's queue without ever blocking: a pop
    on an empty live queue and a push on a full live one are skipped,
    as is everything once the queue reports failure."""
    q = mod.ConcurrentBlockingQueue(max_size=max_size, priority=priority)
    killed = False
    out = []
    for op in ops:
        if op[0] == "push":
            if not killed and max_size and q.size() >= max_size:
                out.append(("full",))
                continue
            out.append(("push", q.push(op[1], priority=op[2])))
        elif op[0] == "pop":
            if not killed and q.size() == 0:
                out.append(("empty",))
                continue
            out.append(("pop",) + tuple(q.pop()))
        elif op[0] == "size":
            out.append(("size", q.size()))
        else:
            q.signal_for_kill()
            killed = True
            out.append(("kill",))
    # drain what a killed queue still holds, then the failure
    while True:
        ok, item = q.pop()
        out.append(("drain", ok, item))
        if not ok:
            break
    return out


@pytest.mark.parametrize("priority", [False, True], ids=["fifo", "prio"])
@pytest.mark.parametrize("max_size", [0, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_op_sequences_equal_reference(seed, max_size, priority):
    ops = _ops(seed)
    got = _drive(pc, ops, max_size, priority)
    assert got == _drive(jc, ops, max_size, priority)
    pops = [o[2] for o in got if o[0] in ("pop", "drain") and o[1]]
    assert pops, "the script popped nothing"
    # after the kill every push fails
    k = got.index(("kill",))
    assert all(o == ("push", False) for o in got[k:] if o[0] == "push")


def test_priority_ties_pop_in_push_order():
    for mod in (pc, jc):
        q = mod.ConcurrentBlockingQueue(priority=True)
        for item, prio in (("a", 1), ("b", 3), ("c", 1), ("d", 3), ("e", 2)):
            q.push(item, priority=prio)
        assert [q.pop()[1] for _ in range(5)] == ["b", "d", "e", "a", "c"]


@pytest.mark.parametrize("side", ["consumer", "producer"])
def test_kill_wakes_blocked_waiters(side):
    """A consumer blocked on an empty queue and a producer blocked on a
    full one both return failure once the queue is killed."""
    results = {}
    for name, mod in (("port", pc), ("jax", jc)):
        q = mod.ConcurrentBlockingQueue(max_size=1)
        if side == "producer":
            assert q.push("x")
        out = []
        th = threading.Thread(
            target=lambda: out.append(q.pop() if side == "consumer"
                                      else q.push("y")), daemon=True)
        th.start()
        th.join(0.2)
        assert th.is_alive(), "the waiter did not block"
        q.signal_for_kill()
        th.join(10)
        assert not th.is_alive()
        results[name] = out
    assert results["port"] == results["jax"]
    assert results["port"] == ([(False, None)] if side == "consumer"
                               else [False])


def _source(n):
    it = iter(range(n))
    return lambda: next(it, None)


def _work(x):
    return x * x + 1


def _collect(it):
    out = []
    while True:
        ok, v = it.next()
        if not ok:
            return out
        out.append(v)


@pytest.mark.parametrize("threads", [1, 2, 3])
def test_multithreaded_iter_outputs_equal_reference(threads):
    got = _collect(pc.MultiThreadedIter(_source(200), _work,
                                        num_threads=threads,
                                        max_capacity=4))
    want = _collect(jc.MultiThreadedIter(_source(200), _work,
                                         num_threads=threads,
                                         max_capacity=4))
    assert sorted(got) == sorted(want) == [_work(i) for i in range(200)]


@pytest.mark.parametrize("threads", [1, 2, 3])
def test_multithreaded_iter_worker_error_at_next(threads):
    def bad(x):
        if x == 7:
            raise ValueError("bad item 7")
        return x

    errs = []
    for mod in (pc, jc):
        it = mod.MultiThreadedIter(_source(20), bad, num_threads=threads)
        with pytest.raises(RuntimeError) as ei:
            _collect(it)
        errs.append(ei.value)
        assert it.next() == (False, None)   # ended for good
    p, j = errs
    assert type(p).__name__ == type(j).__name__ == "DMLCError"
    assert type(p.__cause__) is type(j.__cause__) is ValueError
    assert str(p) == str(j)


def test_multithreaded_iter_destroy_ends_the_stream():
    for mod in (pc, jc):
        gate = threading.Event()

        def slow(x):
            gate.wait(10)
            return x

        it = mod.MultiThreadedIter(_source(100), slow, num_threads=2,
                                   max_capacity=2)
        it.destroy()
        assert it.next() == (False, None)
        gate.set()
