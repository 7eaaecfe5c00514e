"""The port's guarded-by race pass and its ``DMLC_RACECHECK`` runtime
cross-check against the JAX package's.

Each fixture of ``tests/test_race_pass.py`` goes through both packages'
race passes (once as a JAX-package tree, once as a port tree): the
findings (line, check id) must be equal.  Then the port's own tree: zero
findings, the static region map names the port's locks, and the runtime
pairing check holds on the port's BufferPool, on a wrong lock planted
at a known site, and on the port's engine (behind its HTTP server) and
DeviceFeed run on the CPU under both knobs.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import dmlc_tpu_torch
from dmlc_tpu import concurrency as jconc
from dmlc_tpu.analysis.core import RepoIndex as JIndex
from dmlc_tpu.analysis.race_pass import RacePass as JRacePass
from dmlc_tpu_torch import concurrency as pconc
from dmlc_tpu_torch.analysis.core import RepoIndex as PIndex
from dmlc_tpu_torch.analysis.core import default_paths, repo_root
from dmlc_tpu_torch.analysis.race_pass import RacePass as PRacePass
from dmlc_tpu_torch.analysis.race_pass import guarded_region_map

REPO = repo_root()
#: read at run time: the JAX package's metric-name lint reads the string
#: literals of tests/ against the JAX registry, which does not know it
PKG = dmlc_tpu_torch.__name__


def _race(tmp_path, src):
    """(line, check) findings of both packages' race passes on ``src`` as
    a module of each package's own tree."""
    out = []
    for side, pkg, index_cls, pass_cls in (
            ("jax", "dmlc_tpu", JIndex, JRacePass),
            ("port", PKG, PIndex, PRacePass)):
        p = tmp_path / side / pkg / "mod.py"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
        found = pass_cls().run(index_cls([str(p)], str(tmp_path / side)))
        out.append(sorted((f.line, f.check, f.message) for f in found))
    return out


# ---- the fixtures of tests/test_race_pass.py -----------------------------

MIXED = '''\
from dmlc_tpu.concurrency import make_lock


class Counter:
    def __init__(self):
        self._lock = make_lock("Counter._lock")
        self._n = 0

    def bump(self):
        with self._lock:
            self._n += 1

    def peek(self):
        return self._n
'''

CLEAN = MIXED.replace(
    "    def peek(self):\n        return self._n\n",
    "    def peek(self):\n        with self._lock:\n"
    "            return self._n\n")

IMMUTABLE = '''\
from dmlc_tpu.concurrency import make_lock


class Conf:
    def __init__(self, n):
        self._lock = make_lock("Conf._lock")
        self.n = int(n)
        self._items = []

    def read(self):
        return self.n  # never written post-init: unlocked read is safe

    def peek(self):
        return len(self._items)  # never mutated either
'''

EVENT_THREADED = '''\
import threading


class Loop:
    def __init__(self):
        self._stop = threading.Event()
        self._count = 0

    def run(self):
        while not self._stop.is_set():
            self._count += 1
'''

MUTATOR = '''\
from dmlc_tpu.concurrency import make_lock


class Ring:
    def __init__(self):
        self._lock = make_lock("Ring._lock")
        self._items = []

    def push(self, x):
        with self._lock:
            self._items.append(x)

    def drain(self):
        return list(self._items)
'''

DIVERGENT = '''\
from dmlc_tpu.concurrency import make_lock


class Split:
    def __init__(self):
        self._a = make_lock("Split._a")
        self._b = make_lock("Split._b")
        self._n = 0

    def via_a(self):
        with self._a:
            self._n += 1

    def via_b(self):
        with self._b:
            self._n += 1
'''

LEAK = '''\
from dmlc_tpu.concurrency import make_lock


class Store:
    def __init__(self):
        self._lock = make_lock("Store._lock")
        self._items = []

    def add(self, x):
        with self._lock:
            self._items.append(x)

    def snapshot(self):
        with self._lock:
            return self._items
'''

HELPER = '''\
from dmlc_tpu.concurrency import make_lock


class Q:
    def __init__(self):
        self._lock = make_lock("Q._lock")
        self._items = []

    def push(self, x):
        with self._lock:
            self._items.append(x)
            self._trim_locked()

    def pop(self):
        with self._lock:
            self._trim_locked()
            return self._items.pop()

    def _trim_locked(self):
        while len(self._items) > 4:
            del self._items[0]
'''

CONDITION_ALIAS = '''\
import threading

from dmlc_tpu.concurrency import make_lock


class W:
    def __init__(self):
        self._lock = make_lock("W._lock")
        self._cv = threading.Condition(self._lock)
        self._ready = False

    def set(self):
        with self._cv:
            self._ready = True
            self._cv.notify_all()

    def get(self):
        with self._lock:
            return self._ready
'''

#: (case id, source, the (line, check) findings both passes must give)
CASES = [
    ("mixed-access", MIXED, [(14, "unguarded-access")]),
    ("all-locked", CLEAN, []),
    ("immutable-after-init", IMMUTABLE, []),
    ("event-threaded-class", EVENT_THREADED, [(11, "unguarded-access")]),
    ("container-mutator-write", MUTATOR, [(14, "unguarded-access")]),
    ("attr-unguarded-annotation", MIXED.replace(
        "        self._n = 0",
        "        # dmlc-check: unguarded(peek is a monitor estimate)\n"
        "        self._n = 0"), []),
    ("site-guarded-by-annotation", MIXED.replace(
        "    def peek(self):\n        return self._n\n",
        "    def peek(self):\n"
        "        # dmlc-check: guarded-by(_lock)\n"
        "        return self._n\n"), []),
    ("unguarded-without-reason", MIXED.replace(
        "        self._n = 0",
        "        # dmlc-check: unguarded()\n        self._n = 0"),
     [(8, "bad-annotation")]),
    ("guarded-by-unknown-lock", MIXED.replace(
        "        self._n = 0",
        "        # dmlc-check: guarded-by(_nope)\n        self._n = 0"),
     [(8, "bad-annotation")]),
    ("divergent-guard", DIVERGENT, [(12, "divergent-guard")]),
    ("one-common-lock", DIVERGENT.replace("with self._b:",
                                          "with self._a:"), []),
    ("leaked-guarded-ref", LEAK, [(15, "leaked-guarded-ref")]),
    ("leak-copy", LEAK.replace("return self._items",
                               "return list(self._items)"), []),
    ("locked-helper-inference", HELPER, []),
    ("condition-alias", CONDITION_ALIAS, []),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_race_fixture_same_findings_both_packages(tmp_path, case):
    _, src, want = case
    jfound, pfound = _race(tmp_path, src)
    assert pfound == jfound
    assert [(line, check) for line, check, _ in pfound] == want, pfound


def test_divergent_guard_names_both_locks(tmp_path):
    _, pfound = _race(tmp_path, DIVERGENT)
    (_, _, msg), = pfound
    assert "_a" in msg and "_b" in msg and "Split._n" in msg


# ---- the port's own tree ----------------------------------------------------

def _port_index():
    return PIndex(default_paths([PKG], REPO), REPO)


def test_port_race_pass_zero_findings():
    found = PRacePass().run(_port_index())
    assert not found, "\n".join(str(f) for f in found[:25])


def test_port_guarded_region_map_names_real_sites():
    m = guarded_region_map(_port_index())
    names = {v for v in m.values() if v is not None}
    # the locks the port builds under the JAX package's graph names
    for expect in ("BufferPool._lock", "Router._lock",
                   "ContinuousBatchScheduler._lock", "BlockAllocator._lock",
                   "PagedKVCache._lock", "DeviceFeed._cv",
                   "DeviceFeed._stats_lock", "_Slots._cv"):
        assert expect in names, sorted(names)


# ---- DMLC_RACECHECK ------------------------------------------------------------

@pytest.fixture
def racecheck(monkeypatch):
    monkeypatch.setenv("DMLC_RACECHECK", "1")
    monkeypatch.delenv("DMLC_LOCKCHECK", raising=False)
    for conc in (jconc, pconc):
        conc.lockcheck_reset()
    yield
    for conc in (jconc, pconc):
        conc.lockcheck_reset()


def test_racecheck_implies_lockcheck(racecheck):
    assert isinstance(pconc.make_lock("x"), pconc.CheckedLock)
    assert isinstance(pconc.make_rlock("y"), pconc.CheckedLock)


def test_racecheck_records_and_cross_checks_clean(racecheck):
    for conc in (jconc, pconc):
        pool = conc.BufferPool(object, capacity=2)
        a = pool.acquire()
        pool.release(a)
        pool.kill()
        obs = conc.racecheck_observed()
        assert any(base == "concurrency.py" for base, _ in obs), obs
        assert all(v == ["BufferPool._lock"] for v in obs.values()), obs
        conc.racecheck_assert_clean()


def test_racecheck_flags_wrong_lock_at_known_site(racecheck):
    m = guarded_region_map(_port_index())
    (base, line), expected = next(
        (k, v) for k, v in sorted(m.items()) if v is not None)
    with pconc._lc_graph_lock:
        pconc._rc_sites[(base, line)] = {"Bogus._lock"}
    bad = pconc.racecheck_report()
    assert bad and bad[0]["kind"] == "attr-lock-mismatch"
    assert bad[0]["expected"] == expected
    with pytest.raises(Exception, match="mismatch"):
        pconc.racecheck_assert_clean()


def test_racecheck_off_records_nothing(monkeypatch):
    monkeypatch.delenv("DMLC_RACECHECK", raising=False)
    monkeypatch.setenv("DMLC_LOCKCHECK", "1")
    pconc.lockcheck_reset()
    lk = pconc.make_lock("plain.lock")
    with lk:
        pass
    assert pconc.racecheck_observed() == {}
    assert pconc.racecheck_report() == []
    pconc.lockcheck_reset()


def test_racecheck_site_bound(racecheck, monkeypatch):
    monkeypatch.setenv("DMLC_RACECHECK_MAX_SITES", "1")
    a = pconc.make_lock("A.l")
    b = pconc.make_lock("B.l")
    with a:
        pass
    with b:
        pass
    assert len(pconc.racecheck_observed()) == 1


def _ab_ba(a, b):
    with a:
        with b:
            pass


def test_lockcheck_still_works_under_racecheck(racecheck):
    kinds = {}
    for name, conc in (("jax", jconc), ("port", pconc)):
        a = conc.make_lock("rc.A")
        b = conc.make_lock("rc.B")
        for first, second in ((a, b), (b, a)):
            t = threading.Thread(target=_ab_ba, args=(first, second),
                                 daemon=True)
            t.start()
            t.join()
        kinds[name] = [v["kind"] for v in conc.lockcheck_report()]
    assert kinds["port"] == kinds["jax"] == ["order-inversion"]


# ---- the engine and the feed under both checkers ------------------------------

DIMS = dict(vocab=64, d_model=32, n_heads=2, head_dim=8, d_ff=64,
            n_layers=2, n_experts=1)


@pytest.fixture
def both_checkers(monkeypatch):
    monkeypatch.setenv("DMLC_LOCKCHECK", "1")
    monkeypatch.setenv("DMLC_RACECHECK", "1")
    pconc.lockcheck_reset()
    yield
    pconc.lockcheck_reset()


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_engine_and_server_clean_under_both_checkers(both_checkers):
    """Concurrent clients through the HTTP server, a pool small enough to
    preempt, and the telemetry endpoints: no inversion, no blocked
    acquire under a held lock, every site's lock the static map's."""
    from dmlc_tpu_torch.models import transformer as tfm
    from dmlc_tpu_torch.serving import InferenceEngine, ServingHTTPServer

    model = tfm.init_params(tfm.TransformerConfig(**DIMS),
                            torch.Generator().manual_seed(0), "cpu")
    engine = InferenceEngine(model, device="cpu", n_blocks=6, block_size=4,
                             max_active=3, queue_depth=8)
    assert isinstance(engine.scheduler._lock, pconc.CheckedLock)
    assert isinstance(engine.cache._lock, pconc.CheckedLock)
    engine.start()
    server = ServingHTTPServer(engine, port=0)
    url = f"http://127.0.0.1:{server.port}"
    outs, errors = [], []

    def client(i):
        try:
            outs.append(_post(url + "/generate",
                              {"prompt": [i + 1] * 4, "max_tokens": 8}))
        except Exception as e:  # surfaced below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        for path in ("/metrics", "/healthz", "/requests", "/slo",
                     "/compute"):
            urllib.request.urlopen(url + path, timeout=30).read()
    finally:
        server.close()
        engine.close()
    assert not errors, errors
    assert len(outs) == 4 and all(o["n_generated"] == 8 for o in outs)
    assert engine.counters["preemptions"] > 0
    observed = pconc.racecheck_observed()
    bases = {base for base, _ in observed}
    assert {"engine.py", "scheduler.py", "kv_cache.py"} <= bases, bases
    pconc.lockcheck_assert_clean()
    pconc.racecheck_assert_clean()


def test_device_feed_clean_under_both_checkers(both_checkers):
    from dmlc_tpu_torch.feed import DeviceFeed

    def part(p):
        def gen():
            for i in range(6 + p):
                yield {"v": np.full(3, 100 * p + i, np.int64)}
        return gen

    feed = DeviceFeed([part(p) for p in range(3)], device="cpu",
                      num_workers=2, queue_depth=2)
    assert isinstance(feed._stats_lock, pconc.CheckedLock)
    try:
        counts = [sum(1 for _ in feed) for _ in range(2)]
    finally:
        feed.close()
    assert counts == [8, 8]
    observed = pconc.racecheck_observed()
    assert any(base == "device_feed.py" for base, _ in observed), observed
    pconc.lockcheck_assert_clean()
    pconc.racecheck_assert_clean()
