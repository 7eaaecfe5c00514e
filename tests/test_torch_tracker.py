"""The port's tracker, client and host collectives against the JAX
package's: the wire protocol and overlay maps equal, gangs that mix JAX
and port clients under either package's tracker giving results bitwise
equal to an all-JAX gang (tree, ring, hier with and without leader
rings), the hier veto, recover, elastic generations renumbered as the
JAX tracker renumbers, and the aggregator's exposition byte-equal.

Workers are threads in this process, as in the JAX package's own
tracker tests; trackers bind 127.0.0.1 only."""

import json
import socket
import threading
import time

import numpy as np
import pytest

import dmlc_tpu.telemetry as jtel
import dmlc_tpu.telemetry.heartbeat as jhb
import dmlc_tpu.tracker as jtr
import dmlc_tpu.tracker.protocol as jproto
import dmlc_tpu_torch.telemetry as ptel
import dmlc_tpu_torch.telemetry.heartbeat as phb
import dmlc_tpu_torch.tracker as ptr
import dmlc_tpu_torch.tracker.protocol as pproto

DTYPES = (np.float32, np.float64, np.int32, np.int64)
OPS = ("sum", "max", "min")


# ---------------------------------------------------------------------------
# wire protocol and overlay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 34))
def test_link_maps_and_binomial_tree_equal_jax(n):
    assert pproto.link_maps(n) == jproto.link_maps(n)
    assert pproto.binomial_tree(n) == jproto.binomial_tree(n)


def test_frames_cross_both_ways_and_commands_parse_alike():
    a, b = socket.socketpair()
    try:
        pa, jb = pproto.FrameSocket(a), jproto.FrameSocket(b)
        pa.send_int(pproto.MAGIC)
        pa.send_str("héllo")
        pa.send_int(-7)
        assert jb.recv_int() == jproto.MAGIC == 0xFF99
        assert jb.recv_str() == "héllo" and jb.recv_int() == -7
        jb.send_str("x" * 70000)
        jb.send_int(1 << 30)
        assert pa.recv_str() == "x" * 70000
        assert pa.recv_int() == 1 << 30
        # a length outside the bound is refused on both sides alike
        jb.send_int(pproto.FrameSocket.MAX_STR + 1)
        with pytest.raises(ConnectionError, match="bad string frame"):
            pa.recv_str()
    finally:
        a.close()
        b.close()
    for cmd in ("start", "recover", "recover@3", "shutdown@0", "print",
                "recover@x", "metrics", "start@2", pproto.recover_cmd(5)):
        assert pproto.parse_worker_cmd(cmd) == jproto.parse_worker_cmd(cmd)


def test_importing_the_slice_starts_nothing():
    """Importing tracker/, parallel/, resilience/, the heartbeat and the
    examples starts no thread, opens no socket, builds and loads no
    library and touches no CUDA (a fresh interpreter)."""
    import subprocess
    import sys

    pkg = ptr.__name__.split(".")[0]
    code = (
        "import importlib, os, sys, threading, torch\n"
        f"mods = ['{pkg}.tracker', '{pkg}.tracker.launch', "
        f"'{pkg}.tracker.submit', '{pkg}.tracker.bootstrap', "
        f"'{pkg}.parallel.overlap', '{pkg}.resilience', "
        f"'{pkg}.telemetry.heartbeat', '{pkg}.native.shm_collective', "
        f"'{pkg}.examples.train_libsvm', '{pkg}.examples.train_csv', "
        f"'{pkg}.examples.allreduce_worker', "
        f"'{pkg}.examples.recover_worker']\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        f"shm = sys.modules['{pkg}.native.shm_collective']\n"
        "def kind(f):\n"
        "    try:\n"
        "        return os.readlink(f'/proc/self/fd/{f}')\n"
        "    except OSError:\n"
        "        return ''\n"
        "socks = [f for f in os.listdir('/proc/self/fd')\n"
        "         if kind(f).startswith('socket:')]\n"
        "print(threading.active_count(), len(socks), shm._tried, "
        "torch.cuda.is_initialized())\n")
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": root})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["1", "0", "False", "False"], r.stdout


# ---------------------------------------------------------------------------
# gangs
# ---------------------------------------------------------------------------

def _tracker(kind, n, **kw):
    mod = jtr if kind == "jax" else ptr
    t = mod.RabitTracker("127.0.0.1", n, **kw)
    t.start(n)
    return t


def _run_gang(tracker_kind, classes, fn):
    """One thread per entry of ``classes`` (the TrackerClient class each
    worker uses) against a fresh tracker; returns ``fn(client)`` per
    worker, keyed by the rank the tracker assigned."""
    n = len(classes)
    tracker = _tracker(tracker_kind, n)
    results, errors = {}, []

    def work(i, cls):
        try:
            c = cls("127.0.0.1", tracker.port, jobid=f"job{i}")
            c.start()
            results[c.rank] = fn(c)
            c.shutdown()
        except Exception as e:  # surfaced below
            errors.append((i, e))

    threads = [threading.Thread(target=work, args=(i, cls))
               for i, cls in enumerate(classes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    tracker.join(timeout=30)
    tracker.close()
    return results


def _mixed(n):
    return [ptr.TrackerClient if i % 2 == 0 else jtr.TrackerClient
            for i in range(n)]


def _payloads(rank):
    rng = np.random.default_rng(100 + rank)
    out = []
    for dt in DTYPES:
        for size in (1001, 3):
            if np.issubdtype(dt, np.integer):
                out.append(rng.integers(-1000, 1000, size).astype(dt))
            else:
                out.append(rng.standard_normal(size).astype(dt))
    return out


def _reduce_all(c):
    """Every dtype x op x size, plus an ``out=`` run per dtype."""
    res = []
    for arr in _payloads(c.rank):
        for op in OPS:
            res.append(c.allreduce(arr, op))
        buf = arr.copy()
        got = c.allreduce(buf, "sum", out=buf)
        assert np.shares_memory(got, buf)
        res.append(buf)
    return res


_JAX_REFERENCE = {}


def _jax_reference(n, algo):
    key = (n, algo)
    if key not in _JAX_REFERENCE:
        _JAX_REFERENCE[key] = _run_gang("jax", [jtr.TrackerClient] * n,
                                        _reduce_all)
    return _JAX_REFERENCE[key]


@pytest.mark.parametrize("tracker_kind", ["jax", "port"])
@pytest.mark.parametrize("algo,n,groups", [
    ("tree", 5, None), ("ring", 5, None), ("hier", 4, None),
    ("hier", 5, "2")])
def test_mixed_gang_bitwise_equal_to_jax_gang(monkeypatch, tracker_kind,
                                              algo, n, groups):
    """JAX and port clients alternate in one world; every rank's result
    for every dtype/op/size (and ``out=``) is bitwise equal to an
    all-JAX gang's.  hier is forced through DMLC_COLL_ALGO; with
    DMLC_COLL_HIER_GROUPS=2 the rank blocks are 'hosts', so shm runs
    inside each pair and the chunked ring across the group leaders
    (a ragged singleton group at n=5)."""
    monkeypatch.setenv("DMLC_COLL_ALGO", algo)
    if groups:
        monkeypatch.setenv("DMLC_COLL_HIER_GROUPS", groups)
    want = _jax_reference(n, algo + (groups or ""))
    got = _run_gang(tracker_kind, _mixed(n), _reduce_all)
    assert sorted(got) == sorted(want) == list(range(n))
    for rank in range(n):
        for g, w in zip(got[rank], want[rank]):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
    # ranks agree with each other too
    for rank in range(1, n):
        assert all(a.tobytes() == b.tobytes()
                   for a, b in zip(got[rank], got[0]))


def _span_algos(tel, since):
    spans, _ = tel.spans_since(since)
    return [s["args"]["algo"] for s in spans
            if s["name"] == "collective.allreduce"]


def test_mixed_gang_runs_hier_and_broadcasts(monkeypatch):
    """The ``collective.allreduce`` span carries the algorithm that ran:
    a 64 KB+ payload picks hier under ``auto`` in both packages'
    clients, and broadcast from rank 0 reaches every rank."""
    monkeypatch.delenv("DMLC_COLL_ALGO", raising=False)
    p0 = ptel.core.span_seq()

    def fn(c):
        x = np.full(1 << 15, c.rank + 1.0, np.float64)  # 256 KB
        s = c.allreduce_sum(x)
        b = c.broadcast(np.full(5, c.rank, np.int64), root=0)
        return s, b

    res = _run_gang("port", _mixed(4), fn)
    for s, b in res.values():
        assert np.all(s == 10.0) and np.all(b == 0)
    assert set(_span_algos(ptel, p0)) == {"hier"}


def test_hier_vetoes_to_ring_in_a_mixed_gang(monkeypatch):
    """A shm group that cannot be created (in either package's ranks)
    vetoes the whole gang to the flat ring: right results, no hang, the
    span says ``ring``."""
    import dmlc_tpu.native.shm_collective as jshm
    import dmlc_tpu_torch.native.shm_collective as pshm

    for mod in (jshm, pshm):
        def boom(*a, _err=mod.ShmGroupError, **k):
            raise _err("forced setup failure")

        monkeypatch.setattr(mod, "ShmCollective", boom)
    monkeypatch.setenv("DMLC_COLL_ALGO", "hier")
    p0 = ptel.core.span_seq()

    def fn(c):
        x = np.ones(1 << 17, np.float64) * (c.rank + 1)  # 1 MB: ring size
        return c.allreduce(x, "sum"), c.allreduce(x, "sum")

    res = _run_gang("jax", _mixed(3), fn)
    for first, second in res.values():
        np.testing.assert_array_equal(first, np.full(1 << 17, 6.0))
        np.testing.assert_array_equal(second, np.full(1 << 17, 6.0))
    assert set(_span_algos(ptel, p0)) == {"ring"}


def test_device_tensors_are_refused_host_tensors_accepted():
    import torch

    c = ptr.TrackerClient("127.0.0.1", 1)
    c.world_size = 1
    got = c.allreduce(torch.arange(4, dtype=torch.float64), "sum")
    assert isinstance(got, np.ndarray) and got.tolist() == [0, 1, 2, 3]
    meta = torch.empty(4, device="meta")
    with pytest.raises(TypeError, match="takes host arrays"):
        c.allreduce(meta, "sum")
    with pytest.raises(TypeError, match="takes host arrays"):
        c.broadcast(meta)
    with pytest.raises(TypeError, match="takes host arrays"):
        c.allreduce(np.zeros(4), "sum", out=meta)


@pytest.mark.parametrize("n", [2, 5])
def test_recover_relinks_mixed_world(n):
    """Every worker recovers at once under the port's tracker: ranks and
    links come back as they were and the allreduce still sums."""
    barrier = threading.Barrier(n)

    def fn(c):
        pre = float(c.allreduce_sum(np.asarray([c.rank + 1.0]))[0])
        old_rank, old_links = c.rank, sorted(c.links)
        barrier.wait(timeout=20)
        c.recover()
        post = float(c.allreduce_sum(np.asarray([c.rank + 1.0]))[0])
        return old_rank, c.rank, old_links, sorted(c.links), pre, post

    res = _run_gang("port", _mixed(n), fn)
    want = n * (n + 1) / 2.0
    for old_rank, rank, old_links, links, pre, post in res.values():
        assert rank == old_rank and links == old_links
        assert pre == want == post


def test_print_relay_and_job_walltime(caplog):
    import logging

    caplog.set_level(logging.INFO, logger=ptr.__name__)

    def fn(c):
        c.log(f"hello from rank {c.rank}")
        return c.rank

    _run_gang("port", _mixed(2), fn)
    msgs = [r.getMessage() for r in caplog.records]
    assert sum("hello from rank" in m for m in msgs) == 2
    assert any("@tracker" in m and "secs between start and finish" in m
               for m in msgs)


# ---------------------------------------------------------------------------
# elastic generations
# ---------------------------------------------------------------------------

MISS = 0.5
GRACE = 0.5


class _Worker(threading.Thread):
    """In-thread elastic worker with heartbeats on a side thread (the
    JAX package's elastic test harness)."""

    def __init__(self, cls, port, jobid, fn):
        super().__init__(daemon=True)
        self.cls, self.port, self.jobid, self.fn = cls, port, jobid, fn
        self.result = self.error = None
        self._halt = threading.Event()

    def _beats(self, c):
        while not self._halt.wait(0.1):
            try:
                c.send_metrics('{"counters": {}}')
            except OSError:
                return

    def run(self):
        try:
            c = self.cls("127.0.0.1", self.port, jobid=self.jobid).start()
            threading.Thread(target=self._beats, args=(c,),
                             daemon=True).start()
            self.result = self.fn(c)
        except BaseException as e:  # noqa: BLE001 - surfaced by the test
            self.error = e
        finally:
            self._halt.set()


def _shrink_then_grow(tracker_kind, classes):
    """Four ranks; rank 1 vanishes, the grace window evicts it and the
    survivors resize into [0, 3); then an operator grow to 4 admits a
    joiner.  Returns ({old_rank: (shrunk_rank, grown_rank)}, joiner
    rank, tracker generation)."""
    tracker = _tracker(tracker_kind, 4, miss_window_s=MISS, elastic=True,
                       elastic_grace_s=GRACE)
    barrier = threading.Barrier(4)
    shrunk = threading.Barrier(3)
    ready, grown = threading.Event(), threading.Event()

    def wait_resized(c, wr, step):
        for _ in range(300):
            try:
                step(c)
                time.sleep(0.05)
            except wr:
                return
        raise AssertionError("the world never changed")

    def fn(c):
        wr = ptr.WorldResized if isinstance(c, ptr.TrackerClient) \
            else jtr.WorldResized
        assert float(c.allreduce_sum(np.asarray([1.0]))[0]) == 4.0
        barrier.wait(timeout=20)
        old = c.rank
        if old == 1:
            c._links_down()  # preempted: no shutdown handshake
            return (old, None, None)
        wait_resized(c, wr, lambda c: c.allreduce_sum(np.ones(2)))
        c.resize()
        mid = c.rank
        assert c.world_size == 3
        assert float(c.allreduce_sum(np.asarray([c.rank + 1.0]))[0]) == 6.0
        shrunk.wait(timeout=20)
        ready.set()
        grown.wait(timeout=20)

        def beat(c):
            c.check_resized()
            c.send_metrics('{"counters": {}}')
        wait_resized(c, wr, beat)
        c.resize()
        assert c.world_size == 4
        assert float(c.allreduce_sum(np.asarray([c.rank + 1.0]))[0]) == 10.0
        c.shutdown()
        return (old, mid, c.rank)

    def joiner(c):
        assert c.world_size == 4
        assert float(c.allreduce_sum(np.asarray([c.rank + 1.0]))[0]) == 10.0
        c.shutdown()
        return c.rank

    workers = [_Worker(cls, tracker.port, f"el{i}", fn)
               for i, cls in enumerate(classes)]
    for w in workers:
        w.start()
    assert ready.wait(40), "the survivors never re-formed at world 3"
    tracker.request_resize(world=4, reason="test_grow")
    grown.set()
    j = _Worker(classes[0], tracker.port, "el-join", joiner)
    j.start()
    for w in workers + [j]:
        w.join(60)
    errors = [w.error for w in workers + [j] if w.error is not None]
    assert not errors, errors
    tracker.join(timeout=30)
    tracker.close()
    ranks = {w.result[0]: w.result[1:] for w in workers}
    return ranks, j.result, tracker.gen


def test_elastic_generations_renumber_as_jax():
    """The port's tracker renumbers a shrink and a grow exactly as the
    JAX tracker does, with JAX and port clients in the world."""
    want = _shrink_then_grow("jax", [jtr.TrackerClient] * 4)
    got = _shrink_then_grow("port", _mixed(4))
    assert got == want
    ranks, joiner_rank, gen = got
    assert ranks[1] == (None, None)
    assert sorted(v[0] for r, v in ranks.items() if r != 1) == [0, 1, 2]
    assert joiner_rank == 3 and gen == 2


def _http(url, doc=None):
    import urllib.error
    import urllib.request

    data = None if doc is None else json.dumps(doc).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=data, method="POST" if data else "GET"),
                timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_metrics_server_and_resize_endpoint():
    """The port tracker's HTTP surface: /metrics and /healthz, POST
    /resize validated as the JAX tracker validates it (400), refused by
    a non-elastic tracker (409); the unported endpoints are 404s."""
    for elastic in (True, False):
        t = ptr.RabitTracker("127.0.0.1", 2, metrics_port=0,
                             elastic=elastic)
        base = f"http://127.0.0.1:{t.metrics_port}"
        try:
            code, body = _http(base + "/metrics")
            assert code == 200 and b"dmlc_tracker_ranks_reporting 0" in body
            code, body = _http(base + "/healthz")
            health = json.loads(body)
            assert code == 200 and health["elastic"]["enabled"] is elastic
            assert health["dead_ranks"] == [] == list(health["clock_offsets"])
            assert _http(base + "/trace")[0] == 404
            assert _http(base + "/resize", {"world": 0})[0] == 400
            code, body = _http(base + "/resize", {"world": 3})
            if elastic:
                assert code == 200 and json.loads(body)["requested"] is True
            else:
                assert code == 409
        finally:
            t.close()


def test_stale_generation_frame_is_refused():
    """An array frame stamped with another generation is never folded:
    the port client raises WorldResized (JAX peer on the other end)."""
    a, b = socket.socketpair()
    try:
        pc = ptr.TrackerClient("127.0.0.1", 1)
        jc = jtr.TrackerClient("127.0.0.1", 1)
        pc.gen, jc.gen = 2, 1
        jc._send_array(jproto.FrameSocket(b), np.ones(3))
        with pytest.raises(ptr.WorldResized, match="stale-generation"):
            pc._recv_array(pproto.FrameSocket(a), np.ones(3))
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# heartbeats, aggregation, clock, postmortems
# ---------------------------------------------------------------------------

def _snapshots():
    def hist(vals):
        h = jtel.Histogram()
        for v in vals:
            h.observe(v)
        return h.summary()

    return {
        0: {"counters": {"feed": {"batches": 12, "bytes_to_device": 4096}},
            "gauges": {"feed": {"depth": 2}},
            "histograms": {"train": {"step_secs": hist([0.1, 0.12, 0.2])},
                           "feed": {"producer_stall_secs": hist([0.01])}}},
        1: {"counters": {"feed": {"batches": 11}, "tracker": {"x": "bad"}},
            "histograms": {"train": {"step_secs": hist([0.9, 1.1, 1.3])}},
            "junk": [1, 2]},
        3: {"counters": {"collective": {"overlap_buckets": 5}}},
    }


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.mark.parametrize("with_local", [False, True])
def test_aggregator_text_and_healthz_byte_equal(monkeypatch, with_local):
    clk_j, clk_p = _Clock(), _Clock()
    monkeypatch.setattr(jhb, "time", clk_j)
    monkeypatch.setattr(phb, "time", clk_p)
    local = (lambda: {"counters": {"resilience": {"task_restarts": 2}}}) \
        if with_local else None
    aggs = [mod.TelemetryAggregator(local_snapshot=local)
            for mod in (jhb, phb)]
    for rank, snap in _snapshots().items():
        for agg, clk in zip(aggs, (clk_j, clk_p)):
            clk.t += 0.25 * (rank + 1)
            agg.update(rank, json.loads(json.dumps(snap)))
    aggs[0].update_json(7, "not json")
    aggs[1].update_json(7, "not json")
    clk_j.t += 3.5
    clk_p.t += 3.5
    assert aggs[1].prometheus_text() == aggs[0].prometheus_text()
    assert json.dumps(aggs[1].healthz()) == json.dumps(aggs[0].healthz())
    assert aggs[1].healthz()["stragglers"] == [1]
    assert aggs[1].merged() == aggs[0].merged()


def test_heartbeat_sender_reaches_either_tracker():
    """The port's HeartbeatSender ships a beat (with its trace sub-doc and
    clock sample) that the JAX tracker and the port tracker both take:
    the rank reports on /metrics text and the clock offset lands."""
    for kind in ("jax", "port"):
        tracker = _tracker(kind, 1)
        c = ptr.TrackerClient("127.0.0.1", tracker.port, jobid="hb").start()
        ptel.inc("collective", "overlap_buckets")
        hb = ptel.HeartbeatSender(c, interval=60.0, auto_start=False)
        hb.send_once()
        hb.close()
        text = tracker.telemetry.prometheus_text()
        assert 'dmlc_collective_overlap_buckets{rank="0"}' in text
        assert "dmlc_tracker_ranks_reporting 1" in text
        health = tracker.telemetry.healthz()
        assert "0" in health["clock_offsets"]
        assert health["clock_offsets"]["0"]["rtt_s"] >= 0
        c.shutdown()
        tracker.join(timeout=20)
        tracker.close()


def test_clock_offset_and_estimator_equal_jax():
    from dmlc_tpu.telemetry import clock as jclock
    from dmlc_tpu_torch.telemetry import clock as pclock

    for ts in [(0.0, 1.5, 1.6, 0.2), (10.0, 9.0, 9.1, 10.3),
               (5.0, 5.0, 5.0, 5.0)]:
        assert pclock.offset_from_timestamps(*ts) == \
            jclock.offset_from_timestamps(*ts)
    je, pe = jclock.ClockOffsetEstimator(3), pclock.ClockOffsetEstimator(3)
    for r, off, rtt in [(0, 0.1, 0.02), (0, 0.2, 0.01), (1, -0.5, 0.3),
                        (0, 0.3, 0.05), (0, 0.4, 0.04), (0, 9, 0.06),
                        (1, 0.1, -1.0)]:
        je.update(r, off, rtt)
        pe.update(r, off, rtt)
    assert pe.snapshot() == je.snapshot()
    je.remap_ranks({1: 0})
    pe.remap_ranks({1: 0})
    assert pe.snapshot() == je.snapshot()


def test_clock_ping_against_both_trackers():
    for kind in ("jax", "port"):
        tracker = _tracker(kind, 1)
        c = ptr.TrackerClient("127.0.0.1", tracker.port).start()
        off, rtt = c.clock_ping()
        assert abs(off) < 1.0 and 0 <= rtt < 5.0
        c.shutdown()
        tracker.join(timeout=20)
        tracker.close()


def test_postmortem_dump_keys_equal_jax(tmp_path, monkeypatch):
    from dmlc_tpu.telemetry import postmortem as jpm
    from dmlc_tpu_torch.telemetry import postmortem as ppm

    monkeypatch.setenv("DMLC_TASK_ID", "3")
    monkeypatch.setattr(jpm, "_rank", None)  # no HeartbeatSender's rank
    monkeypatch.setattr(ppm, "_rank", None)
    with ptel.span("pm.open", stage="test"):
        pp = ppm.dump("test reason", directory=str(tmp_path / "p"))
    with jtel.span("pm.open", stage="test"):
        jp = jpm.dump("test reason", directory=str(tmp_path / "j"))
    pdoc, jdoc = (json.load(open(p)) for p in (pp, jp))
    assert sorted(pdoc) == sorted(jdoc)
    assert sorted(pdoc["telemetry"]) == sorted(jdoc["telemetry"])
    assert pdoc["rank"] == jdoc["rank"] == "3"
    assert pdoc["reason"] == "test reason"
    assert "pm.open" in [s["name"] for s in pdoc["open_spans"]]
    assert pp.split("/")[-1].startswith("postmortem-r3-pid")
    assert ppm.list_dumps(str(tmp_path / "p")) == [pp]
