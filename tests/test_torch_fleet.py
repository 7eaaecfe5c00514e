"""The port's fleet control plane against the JAX package's, on the CPU.

* The control law: one seeded script of utilizations, ``/slo`` documents
  and clock readings drives the reference ``Autoscaler`` and the port's,
  each over its own identical ``FakeRouter`` (the reference test's
  stand-in) and provider.  After every tick the decisions, ``report()``
  (the module clocks pinned), ``status()`` and the ``prometheus_text()``
  bytes are equal; so are the decision logs and the events, kind and
  fields in order.
* Each case of ``tests/test_fleet.py`` as a case of one parametrised
  test, run on both packages: the reference's assertions hold on each and
  the observables are equal.
* ``ResizeClient`` against the port's and the JAX package's elastic
  trackers: the same documents and the same refusals.
* The port's ``Autoscaler.status()`` fed into both packages'
  ``Watchdog.ingest_fleet``: the same flags.
* The port's autoscaler over the port's real ``Router`` and
  ``RouterHTTPServer`` in front of scripted replicas: ``/fleet``, strict
  ``/metrics`` with the fleet families, one incident from ``/incidents``.
* End to end: ``chip_smoke.fleet_phase`` on the CPU — two
  ``serving.serve --model tiny --device cpu`` replicas behind the port's
  router and autoscaler, the 2-rank linear job under the port's elastic
  tracker; spike, scale-up funded by preemption, tail, drain, regrow,
  loss parity to the numpy oracle, tenants, and the front door's
  documents.

Every test runs under a time limit of its own (``LIMIT_S``).
"""

import json
import os
import signal
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from dmlc_tpu import fleet as jfleet
from dmlc_tpu import telemetry as jtel
from dmlc_tpu.fleet import autoscaler as jauto
from dmlc_tpu.telemetry import anomaly as janomaly
from dmlc_tpu.telemetry import exporters as jexp
from dmlc_tpu.telemetry import tracecontext as jtc
from dmlc_tpu.tracker import RabitTracker as JaxTracker
from dmlc_tpu_torch import fleet as tfleet
from dmlc_tpu_torch import serving as tserving
from dmlc_tpu_torch import telemetry as ttel
from dmlc_tpu_torch.fleet import autoscaler as tauto
from dmlc_tpu_torch.serving import router as trouter
from dmlc_tpu_torch.telemetry import anomaly as tanomaly
from dmlc_tpu_torch.telemetry import exporters as texp
from dmlc_tpu_torch.telemetry import metric_names as tnames
from dmlc_tpu_torch.telemetry import tracecontext as ttc
from dmlc_tpu_torch.tracker import RabitTracker as PortTracker

ROOT = Path(__file__).resolve().parents[1]

P = {
    "jax": SimpleNamespace(f=jfleet, auto=jauto, tel=jtel, tc=jtc,
                           exp=jexp, anomaly=janomaly, Tracker=JaxTracker),
    "port": SimpleNamespace(f=tfleet, auto=tauto, tel=ttel, tc=ttc,
                            exp=texp, anomaly=tanomaly, Tracker=PortTracker),
}

#: seconds each test may take, by name (default ``LIMIT_DEFAULT_S``)
LIMIT_S = {"test_fleet_end_to_end_on_the_cpu": 420,
           "test_resize_client_against_both_trackers": 60,
           "test_autoscaler_over_the_ports_router_and_front_door": 90}
LIMIT_DEFAULT_S = 60


@pytest.fixture(autouse=True)
def time_limit(request):
    limit = LIMIT_S.get(request.node.originalname, LIMIT_DEFAULT_S)

    def expire(signum, frame):
        raise TimeoutError(f"{request.node.name}: over its {limit} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def clean_knobs(monkeypatch):
    for knob in list(os.environ):
        if knob.startswith(("DMLC_AUTOSCALE_", "DMLC_TENANT_",
                            "DMLC_TRACE_")):
            monkeypatch.delenv(knob)
    for pk in P.values():
        pk.tel.reset()
        pk.tel.reset_events()
        pk.tc.reset_decisions()


class FakeRouter:
    """Just enough Router for the control law (``tests/test_fleet.py``'s):
    a utilization dial and a recording registry."""

    def __init__(self, n=1, util=0.0):
        self.util = util
        self._urls = [f"http://seed-{i}:1" for i in range(n)]
        self.calls = []

    def utilization(self):
        return self.util

    def replica_views(self):
        return [{"url": u, "state": "healthy"} for u in self._urls]

    def add_replica(self, url):
        self.calls.append(("add", url))
        self._urls.append(url)

    def set_draining(self, url):
        self.calls.append(("drain", url))
        return url in self._urls

    def remove_replica(self, url):
        self.calls.append(("remove", url))
        if url in self._urls:
            self._urls.remove(url)
            return True
        return False


class RecordingResize:
    """Records each resize, also into ``order`` (shared with the
    transports) when given."""

    def __init__(self, order=None):
        self.calls = []
        self.order = order

    def resize(self, world, remove=None):
        self.calls.append(("resize", world, remove))
        if self.order is not None:
            self.order.append(self.calls[-1])
        return {"requested": True, "world_target": world}


def _mk(pk, router, capacity=8, **kw):
    """The reference test's controller over a counting CallbackProvider."""
    counter = [0]

    def acquire():
        counter[0] += 1
        return f"http://scaled-{counter[0]}:1"

    prov = pk.f.CallbackProvider(acquire, lambda url: None,
                                 capacity=capacity)
    kw.setdefault("interval_s", 0.01)
    kw.setdefault("high_water", 0.8)
    kw.setdefault("low_water", 0.3)
    kw.setdefault("hysteresis", 3)
    kw.setdefault("cooldown_s", 10.0)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("slo_poll", lambda url: {})
    return pk.f.Autoscaler(router, prov, **kw)


def _preempting(pk, rz, seq, full_world=3, min_world=1):
    def note(*call):
        seq.append(call)
        if rz.order is not None:
            rz.order.append(call)

    return pk.f.TrainingPreemptingProvider(
        rz, full_world=full_world,
        kill_rank=lambda r: note("kill", r),
        launch_replica=lambda r: (note("launch", r),
                                  f"http://freed-{r}:1")[1],
        stop_replica=lambda u: note("stop", u),
        relaunch_rank=lambda r: note("relaunch", r),
        min_world=min_world)


def _logs(pk):
    """The package's decision log and events, timestamps dropped."""
    drop = ("t", "mono", "seq")
    return ([{k: v for k, v in d.items() if k != "t"}
             for d in pk.tc.decision_log().tail(4096)],
            [{k: v for k, v in e.items() if k not in drop}
             for e in pk.tel.events_tail(4096)])


# ---------------------------------------------------------------------------
# the control law, tick by tick
# ---------------------------------------------------------------------------

def _script(seed):
    rng = np.random.default_rng(seed)
    conf = dict(hysteresis=int(rng.integers(1, 4)),
                cooldown_s=float(rng.choice([0.0, 2.5, 6.0])),
                min_replicas=int(rng.integers(1, 3)),
                high_water=0.8, low_water=0.3, interval_s=0.01)
    conf["max_replicas"] = conf["min_replicas"] + int(rng.integers(1, 3))
    # spells of low, middling and high load, so streaks build both ways
    levels = ([0.0, 0.1, 0.3], [0.5], [0.8, 0.95, 1.4])
    ticks, now = [], 0.0
    while len(ticks) < 80:
        spell = levels[int(rng.integers(3))]
        for _ in range(int(rng.integers(2, 7))):
            now += float(rng.choice([0.3, 1.0, 2.0, 4.0]))
            hot = bool(rng.random() < 0.08)
            ticks.append((float(rng.choice(spell)), hot, now))
    return conf, ticks, int(rng.integers(1, 4))


def _law_run(pk, monkeypatch, seed, provider_kind):
    conf, ticks, capacity = _script(seed)
    router = FakeRouter(n=conf["min_replicas"])
    state = {"hot": False}

    def slo_poll(url):
        return {"active": ["slo_ttft_p99"]} if state["hot"] else {}

    seq, rz = [], RecordingResize()
    if provider_kind == "callback":
        made = [0]

        def acquire():
            made[0] += 1
            return f"http://scaled-{made[0]}:1"

        prov = pk.f.CallbackProvider(acquire, lambda url: None,
                                     capacity=capacity)
    else:
        prov = _preempting(pk, rz, seq, full_world=capacity + 1)
    clock = [0.0]
    monkeypatch.setattr(pk.auto, "time", SimpleNamespace(
        monotonic=lambda: clock[0]))
    scaler = pk.f.Autoscaler(router, prov, slo_poll=slo_poll, **conf)
    out = []
    for util, hot, now in ticks:
        router.util, state["hot"], clock[0] = util, hot, now
        decision = scaler.tick(now=now)
        clock[0] = now + 0.5
        out.append([decision, scaler.report(), scaler.status(),
                    scaler.prometheus_text()])
    return out, router.calls, seq, rz.calls, _logs(pk)


@pytest.mark.parametrize("provider_kind", ["callback", "preempting"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_control_law_equals_jax_tick_by_tick(seed, provider_kind,
                                             monkeypatch):
    jax_run = _law_run(P["jax"], monkeypatch, seed, provider_kind)
    port_run = _law_run(P["port"], monkeypatch, seed, provider_kind)
    for i, (a, b) in enumerate(zip(jax_run[0], port_run[0])):
        assert a == b, f"tick {i}"
    assert port_run[1:] == jax_run[1:]
    decisions = [t[0] for t in port_run[0]]
    # every script moves the fleet both ways: the law is exercised
    assert {"scale_up", "scale_down", "hold"} <= set(decisions)
    assert port_run[4][0], "no decision recorded"


# ---------------------------------------------------------------------------
# tests/test_fleet.py, case by case on both packages
# ---------------------------------------------------------------------------

def autoscaler_config_validation(pk, mp):
    r = FakeRouter()
    out = []
    for kw in (dict(high_water=0.3, low_water=0.8),
               dict(min_replicas=3, max_replicas=2)):
        with pytest.raises(ValueError) as e:
            _mk(pk, r, **kw)
        out.append(str(e.value))
    return out


def hysteresis_cooldown_and_scale_cycle(pk, mp):
    r = FakeRouter(n=1, util=0.95)
    a = _mk(pk, r)
    out = [a.tick(now=0.0), a.tick(now=1.0), a.tick(now=2.0)]
    assert out == ["hold", "hold", "scale_up"]
    assert r.calls == [("add", "http://scaled-1:1")]
    out += [a.tick(now=3.0), a.tick(now=4.0)]
    assert out[-2:] == ["hold", "hold"]
    out.append(a.tick(now=13.0))
    assert out[-1] == "scale_up" and len(r._urls) == 3
    r.util = 0.1
    out += [a.tick(now=26.0), a.tick(now=27.0), a.tick(now=28.0)]
    assert out[-3:] == ["hold", "hold", "scale_down"]
    assert r.calls[-2:] == [("drain", "http://scaled-2:1"),
                            ("remove", "http://scaled-2:1")]
    assert r._urls == ["http://seed-0:1", "http://scaled-1:1"]
    rep = a.report()
    assert rep["counters"]["scale_ups"] == 2
    assert rep["counters"]["scale_downs"] == 1
    assert rep["owned"] == ["http://scaled-1:1"]
    return [out, r.calls, rep["counters"], rep["owned"]]


def scale_down_never_touches_unowned_or_min_replicas(pk, mp):
    r = FakeRouter(n=2, util=0.0)
    a = _mk(pk, r, hysteresis=1)
    out = [a.tick(now=float(i)) for i in range(5)]
    assert out == ["hold"] * 5 and r.calls == []
    r2 = FakeRouter(n=1, util=0.95)
    a2 = _mk(pk, r2, hysteresis=1, min_replicas=2, cooldown_s=1.0)
    out.append(a2.tick(now=0.0))
    assert out[-1] == "scale_up"
    r2.util = 0.0
    out.append(a2.tick(now=5.0))
    assert out[-1] == "hold" and len(r2._urls) == 2
    return [out, r2.calls]


def saturation_flags_once_and_clears_with_pressure(pk, mp):
    r = FakeRouter(n=1, util=0.95)
    a = _mk(pk, r, hysteresis=1, max_replicas=1, cooldown_s=0.0)
    out = [a.tick(now=0.0), a.tick(now=1.0)]
    assert out == ["saturated", "saturated"]
    rep = a.report()
    assert rep["saturated"] is True
    assert rep["counters"]["saturations"] == 1
    assert a.status()["saturated"] is True
    r.util = 0.5
    out.append(a.tick(now=2.0))
    assert out[-1] == "hold" and a.report()["saturated"] is False
    prov = pk.f.CallbackProvider(lambda: None, lambda u: None, capacity=0)
    a2 = pk.f.Autoscaler(FakeRouter(n=1, util=0.95), prov, hysteresis=1,
                         cooldown_s=0.0, high_water=0.8, low_water=0.3,
                         max_replicas=4, slo_poll=lambda url: {})
    out.append(a2.tick(now=0.0))
    assert out[-1] == "saturated"
    return [out, rep["counters"], a2.report()["counters"]]


def slo_burn_marks_fleet_hot_despite_low_utilization(pk, mp):
    polled = []

    def slo_poll(url):
        polled.append(url)
        return {"active": ["slo_ttft"]}

    r = FakeRouter(n=1, util=0.1)
    a = _mk(pk, r, hysteresis=1, slo_poll=slo_poll)
    out = a.tick(now=0.0)
    assert out == "scale_up" and polled == ["http://seed-0:1"]
    assert a.report()["slo_hot"] is True
    return [out, polled]


def report_status_and_prometheus_text(pk, mp):
    clock = [100.0]
    mp.setattr(pk.auto, "time", SimpleNamespace(monotonic=lambda: clock[0]))
    r = FakeRouter(n=1, util=0.95)
    a = _mk(pk, r, hysteresis=1)
    a.tick(now=99.0)
    rep = a.report()
    assert rep["replicas"] == 2 and rep["owned"] == ["http://scaled-1:1"]
    assert rep["config"]["hysteresis"] == 1
    assert rep["provider"] == {"kind": "callback", "capacity": 8,
                               "leased": 1}
    st = a.status()
    assert st["replicas"] == 2 and "owned" in st["detail"]
    text = a.prometheus_text()
    pk.exp.validate_exposition_text(text)
    for fam in ("dmlc_fleet_replicas 2", "dmlc_fleet_owned_replicas 1",
                "dmlc_fleet_ticks_total 1", "dmlc_fleet_scale_ups_total 1",
                "dmlc_fleet_saturated 0",
                "dmlc_fleet_cooldown_remaining_s 9.0"):
        assert fam in text, f"{fam} missing:\n{text}"
    return [rep, st, text]


def autoscaler_thread_lifecycle(pk, mp):
    r = FakeRouter(n=1, util=0.0)
    a = _mk(pk, r, interval_s=0.01)
    a.start()
    a.start()
    deadline = time.monotonic() + 10
    while a.report()["counters"]["ticks"] < 3:
        assert time.monotonic() < deadline, "the control loop never ticked"
        time.sleep(0.01)
    a.close()
    assert a.report()["counters"]["ticks"] >= 3
    assert a._thread is None
    names = [t.name for t in threading.enumerate()]
    assert "fleet-autoscaler" not in names
    return [r.calls, a.report()["last_decision"]]


def callback_provider_capacity_bound(pk, mp):
    made = []
    p = pk.f.CallbackProvider(
        lambda: (made.append(1), f"u{len(made)}")[1], lambda u: None,
        capacity=2)
    out = [p.acquire(), p.acquire(), p.acquire()]
    assert out == ["u1", "u2", None]
    p.release("u1")
    out.append(p.acquire())
    assert out[-1] == "u3"
    assert p.stats() == {"kind": "callback", "capacity": 2, "leased": 2}
    return [out, p.stats()]


def training_preemption_kills_then_resizes_then_launches(pk, mp):
    order = []
    rz, seq = RecordingResize(order), []
    p = _preempting(pk, rz, seq)
    url = p.acquire()
    assert url == "http://freed-2:1"
    assert seq == [("kill", 2), ("launch", 2)]
    assert rz.calls == [("resize", 2, [2])]
    # one timeline: kill, then the shrink naming the victim, then launch
    assert order == [("kill", 2), ("resize", 2, [2]), ("launch", 2)]
    url2 = p.acquire()
    assert url2 == "http://freed-1:1"
    assert p.stats()["training_world"] == 1
    assert p.acquire() is None
    out = [url, url2, list(seq), list(rz.calls)]
    seq.clear()
    rz.calls.clear()
    order.clear()
    p.release(url2)
    assert seq == [("stop", "http://freed-1:1"), ("relaunch", 1)]
    assert rz.calls == [("resize", 2, None)]
    assert order == [("stop", "http://freed-1:1"), ("relaunch", 1),
                     ("resize", 2, None)]
    with pytest.raises(KeyError):
        p.release("http://never-leased:1")
    st = p.stats()
    assert st["preemptions"] == 2 and st["restores"] == 1
    assert st["leases"] == {"http://freed-2:1": 2}
    return out + [seq, rz.calls, st]


def training_preemption_validates_worlds(pk, mp):
    rz, out = RecordingResize(), []
    for kw in (dict(full_world=0), dict(full_world=2, min_world=3),
               dict(full_world=2, min_world=0)):
        with pytest.raises(ValueError) as e:
            pk.f.TrainingPreemptingProvider(
                rz, kill_rank=None, launch_replica=None, stop_replica=None,
                relaunch_rank=None, **kw)
        out.append(str(e.value))
    return out


CASES = [
    autoscaler_config_validation,
    hysteresis_cooldown_and_scale_cycle,
    scale_down_never_touches_unowned_or_min_replicas,
    saturation_flags_once_and_clears_with_pressure,
    slo_burn_marks_fleet_hot_despite_low_utilization,
    report_status_and_prometheus_text,
    autoscaler_thread_lifecycle,
    callback_provider_capacity_bound,
    training_preemption_kills_then_resizes_then_launches,
    training_preemption_validates_worlds,
]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_reference_case_equal_on_both_packages(case, monkeypatch):
    got = {}
    for name, pk in P.items():
        with monkeypatch.context() as mp:
            got[name] = json.loads(json.dumps(
                {"obs": case(pk, mp), "logs": _logs(pk)}, default=str))
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# the resize client against both trackers
# ---------------------------------------------------------------------------

def _resize_docs(pk_tracker, client_cls):
    tracker = pk_tracker("127.0.0.1", 1, metrics_port=0, elastic=True)
    tracker.start(1)
    plain = pk_tracker("127.0.0.1", 1, metrics_port=0, elastic=False)
    plain.start(1)
    try:
        rc = client_cls(f"http://127.0.0.1:{tracker.metrics_port}")
        out = [rc.resize(2), rc.resize(2, remove=[1]), rc.resize(1, [0, 3]),
               rc.elastic_status()]
        for bad in ((0, None), (70000, None), (2, [-1])):
            with pytest.raises(urllib.error.HTTPError) as e:
                rc.resize(*bad)
            out.append(e.value.code)
        with pytest.raises(urllib.error.HTTPError) as e:
            client_cls(f"http://127.0.0.1:{plain.metrics_port}").resize(2)
        out.append(e.value.code)
        out.append(client_cls(
            f"http://127.0.0.1:{plain.metrics_port}").elastic_status())
        return out
    finally:
        tracker.close()
        plain.close()


def test_resize_client_against_both_trackers():
    docs = {(c, t): _resize_docs(P[t].Tracker, P[c].f.ResizeClient)
            for c in ("port", "jax") for t in ("port", "jax")}
    want = docs[("jax", "jax")]
    assert want[0]["requested"] is True and want[0]["world_target"] == 2
    assert want[1]["remove"] == [1] and want[2]["remove"] == [0, 3]
    assert want[3]["enabled"] is True
    assert want[4:7] == [400, 400, 400] and want[7] == 409
    for key, got in docs.items():
        assert got == want, key


# ---------------------------------------------------------------------------
# the watchdog's fleet ingest
# ---------------------------------------------------------------------------

def test_port_status_into_both_watchdogs_flags_equal():
    router = FakeRouter(n=1, util=0.95)
    scaler = _mk(P["port"], router, hysteresis=1, max_replicas=2,
                 cooldown_s=0.0)
    dogs = {n: P[n].anomaly.Watchdog(window=3) for n in P}
    seen = []
    for i, util in enumerate([0.95, 0.95, 0.95, 0.5, 0.95, 0.1, 0.95]):
        router.util = util
        scaler.tick(now=float(i))
        st = scaler.status()
        views = {}
        for n, wd in dogs.items():
            wd.ingest_fleet(0, st)
            wd.ingest_json(1, json.dumps({"fleet": st}))
            rep = wd.report()
            views[n] = {"ranks": {r: v["flags"]
                                  for r, v in rep["ranks"].items()},
                        "active": sorted((a["rank"], a["kind"])
                                         for a in rep["active"]),
                        "text": [ln for ln in wd.prometheus_text()
                                 .splitlines() if "fleet" in ln]}
        assert views["port"] == views["jax"], i
        seen.append(views["port"]["ranks"]["0"])
    assert ["fleet_saturated"] in seen and [] in seen
    counts = {n: P[n].tel.snapshot()["counters"]["anomaly"][
        "fleet_saturated_flags"] for n in P}
    assert counts["port"] == counts["jax"] >= 2


# ---------------------------------------------------------------------------
# over the port's real router and front door
# ---------------------------------------------------------------------------

class FakeReplica:
    """A scripted replica (``tests/test_router.py``'s): ``/healthz``
    reports ``waiting`` queued requests; ``/generate`` answers at once."""

    def __init__(self, name):
        self.name, self.waiting, self.hits = name, 0, 0
        fake = self

        class H(BaseHTTPRequestHandler):
            def _send(self, code, doc):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/slo":
                    self._send(200, {"active": []})
                    return
                self._send(200, {
                    "status": "ok", "active": 0, "waiting": fake.waiting,
                    "max_active": 4, "draining": False,
                    "requests": {"live_requests": fake.waiting,
                                 "live_waiting": fake.waiting}})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n))
                fake.hits += 1
                self._send(200, {"state": "done", "output_ids": [1, 2],
                                 "n_generated": 2, "served": fake.name,
                                 "ttft_s": 0.01,
                                 "request_id": doc.get("request_id")})

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read()
        return (json.loads(body)
                if r.headers.get("Content-Type") == "application/json"
                else body.decode())


def test_autoscaler_over_the_ports_router_and_front_door():
    a, b = FakeReplica("a"), FakeReplica("b")
    extra, seq, rz = [], [], RecordingResize()

    def launch(rank):
        seq.append(("launch", rank))
        extra.append(FakeReplica(f"scaled-{rank}"))
        return extra[-1].url

    provider = tfleet.TrainingPreemptingProvider(
        rz, full_world=2, kill_rank=lambda r: seq.append(("kill", r)),
        launch_replica=launch, stop_replica=lambda u: seq.append(("stop", u)),
        relaunch_rank=lambda r: seq.append(("relaunch", r)))
    router = trouter.Router([a.url, b.url], health_interval_s=3600,
                            retries=2, dispatch_timeout_s=5.0,
                            request_timeout_s=10.0,
                            start_health_thread=False)
    scaler = tfleet.Autoscaler(router, provider, hysteresis=2,
                               cooldown_s=1.0, high_water=0.7,
                               low_water=0.15, min_replicas=2,
                               max_replicas=3)
    srv = trouter.RouterHTTPServer(router, port=0,
                                   fleet_source=lambda: scaler)
    try:
        a.waiting = b.waiting = 4
        router.poll_once()
        assert router.utilization() == 1.0
        assert [scaler.tick(now=t) for t in (0.0, 0.5)] == ["hold",
                                                            "scale_up"]
        assert seq == [("kill", 1), ("launch", 1)]
        assert rz.calls == [("resize", 1, [1])]
        assert len(router.replica_views()) == 3
        # the scaled replica takes new work at once (least loaded)
        req = urllib.request.Request(
            srv.url + "/generate", data=json.dumps(
                {"prompt": [1, 2]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read())["served"] == "scaled-1"
        fleet = _get(srv.url + "/fleet")
        assert fleet["counters"]["scale_ups"] == 1
        assert fleet["provider"]["leases"] == {extra[0].url: 1}
        assert set(fleet["replica_availability"]) == {a.url, b.url,
                                                      extra[0].url}
        a.waiting = b.waiting = 0
        router.poll_once()
        assert [scaler.tick(now=t) for t in (2.0, 2.5)] == ["hold",
                                                            "scale_down"]
        assert seq[-2:] == [("stop", extra[0].url), ("relaunch", 1)]
        assert rz.calls[-1] == ("resize", 2, None)
        text = _get(srv.url + "/metrics")
        texp.validate_exposition_text(text)
        for needle in ("dmlc_fleet_replicas 2", "dmlc_fleet_owned_replicas 0",
                       "dmlc_fleet_scale_ups_total 1",
                       "dmlc_fleet_scale_downs_total 1",
                       "dmlc_fleet_ticks_total 4"):
            assert needle in text, needle
        dec = _get(srv.url + "/decisions")["decisions"]
        assert [d["kind"] for d in dec] == [
            "autoscale_verdict", "preempt_acquire", "preempt_kill_rank",
            "preempt_resize", "preempt_replica_added", "scale_up",
            "autoscale_verdict", "preempt_release", "preempt_relaunch_rank",
            "preempt_restore_resize", "scale_down"]
        incidents = _get(srv.url + "/incidents")["incidents"]
        assert len(incidents) == 1
        assert incidents[0]["decision_kinds"] == [d["kind"] for d in dec]
        assert incidents[0]["summary"]
    finally:
        scaler.close()
        srv.close()
        router.close()
        for x in [a, b] + extra:
            x.close()


def test_router_front_door_takes_a_burst_of_connects():
    """Every stream of a spike connecting at once: with the accept loop
    stopped, 64 connects all complete into the listen backlog (the
    5-entry default completes 6 and leaves the rest to time out or be
    reset)."""
    a = FakeReplica("a")
    router = trouter.Router([a.url], health_interval_s=3600,
                            start_health_thread=False)
    srv = trouter.RouterHTTPServer(router, port=0)
    socks = []
    try:
        srv._httpd.shutdown()   # the socket keeps listening, nobody accepts
        for _ in range(64):
            socks.append(socket.create_connection(
                ("127.0.0.1", srv.port), timeout=1.0))
        assert len(socks) == 64
    finally:
        for s in socks:
            s.close()
        srv.close()
        router.close()
        a.close()


def test_fleet_families_are_registered_metric_names():
    scaler = _mk(P["port"], FakeRouter(n=1, util=0.95), hysteresis=1)
    scaler.tick(now=0.0)
    families = {ln.split()[2] for ln in scaler.prometheus_text().splitlines()
                if ln.startswith("# TYPE")}
    assert len(families) == 12
    assert families <= set(tnames.METRIC_NAMES)


# ---------------------------------------------------------------------------
# end to end on the CPU: the chip smoke's fleet phase with a tiny model
# ---------------------------------------------------------------------------

def test_fleet_end_to_end_on_the_cpu(tmp_path):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    run = dict(model=("--model", "tiny", "--device", "cpu"), device="cpu",
               dir=str(tmp_path / "job"), log_dir=str(tmp_path / "logs"))
    line, launches = chip_smoke.fleet_phase("cpu", tserving, 512, run)
    assert launches == {"flash_fwd": 0, "paged_attention": 0}
    up, spike, tail, job = (line["scale_up"], line["spike"], line["tail"],
                            line["job"])
    assert up["tracker"]["world"] == 1 and up["verdict"]["high_streak"] == 2
    assert spike["served_by"]["C"] >= 1
    assert sum(spike["served_by"].values()) == 96
    assert tail["http_503"] == 0 and sum(tail["served_by"].values()) == 20
    assert job["worlds"] == [2, 1, 2] and job["exits"] == [-9, 0, 0]
    assert job["max_rel_loss_err"] <= 1e-6
    assert [r["remove"] for r in job["resizes"]] == [[1], None]
    assert line["tenants"]["paid"]["n_rejections_429"] == 0
    assert line["tenants"]["free"]["n_rejections_429"] >= 1
    assert line["exposition"]["incident"]["decision_kinds"][:6] == list(
        chip_smoke.FLEET_CHAIN)
    assert line["exit_codes"] == {"A": 0, "B": 0}
    assert not (tmp_path / "job").exists()
