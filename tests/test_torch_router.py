"""The port's fleet router against the JAX package's, on the CPU.

* Every scenario of ``tests/test_router.py`` runs on both routers through
  one scripted replica pair (``FakeReplica``, the reference test's
  stand-in: ok / die / slow / saturated / draining): the reference's
  assertions hold on each, and the observables are equal — statuses,
  response documents, ``Retry-After``, replica states, the request ids
  each replica saw, and the router counters' deltas, each read from its
  own package's registry (URLs are compared by replica name, ids the
  router minted as ``<minted>``).
* The sliver-of-deadline case without the reference test's race: the
  primary fails at once and the request's deadline is below the launch
  floor, so exactly one dispatch is launched and both routers answer the
  same 503.
* End to end: two of the port's ``serving.serve --device cpu`` replicas
  (a tiny f32 model, one thread each) as processes behind the port's
  ``serving.route`` with ``DMLC_TRACE_FLEET=1``:
  a replica SIGKILLed mid-load costs no client a failure and changes no
  greedy token, the restarted replica closes its circuit and serves
  again, a SIGTERM drain reaches clients with zero 503s, and the torn
  request is one trace with flow arrows.
* Interop: the port's router in front of a JAX replica and a port
  replica on the same weights (carried across by ``convert``), and the
  JAX router in front of port replicas; greedy tokens equal whichever
  replica serves.

Every subprocess is killed when its test ends, and every wait is a
bounded poll on state.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import jax

import dmlc_tpu_torch
from dmlc_tpu import telemetry as jtel
from dmlc_tpu.resilience import fault as jfault
from dmlc_tpu.serving import InferenceEngine as JaxEngine
from dmlc_tpu.serving import ServingHTTPServer as JaxServer
from dmlc_tpu.serving import router as jrouter
from dmlc_tpu.telemetry import exporters as jexp
from dmlc_tpu.telemetry import tracecontext as jtc
from dmlc_tpu.tracker import client as jclient
from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu_torch import telemetry as ttel
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.models.convert import params_from_jax
from dmlc_tpu_torch.resilience import fault as tfault
from dmlc_tpu_torch.serving import InferenceEngine, ServingHTTPServer
from dmlc_tpu_torch.serving import router as trouter
from dmlc_tpu_torch.telemetry import exporters as texp
from dmlc_tpu_torch.telemetry import tracecontext as ttc
from dmlc_tpu_torch.tracker import client as tclient

ROOT = Path(__file__).resolve().parents[1]
PKG = dmlc_tpu_torch.__name__

P = {
    "jax": SimpleNamespace(r=jrouter, tel=jtel, fault=jfault, exp=jexp,
                           client=jclient, tc=jtc),
    "port": SimpleNamespace(r=trouter, tel=ttel, fault=tfault, exp=texp,
                            client=tclient, tc=ttc),
}

#: replica URL -> name, for comparing observables across runs
NAMES = {}


class FakeReplica:
    """Scriptable replica endpoint (``tests/test_router.py``'s): ``mode``
    flips its behavior."""

    def __init__(self, name):
        self.name = name
        self.reset()
        self._lock = threading.Lock()
        fake = self

        class H(BaseHTTPRequestHandler):
            def _send(self, code, doc, headers=None):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path != "/healthz" or fake.mode == "die":
                    self.connection.close()
                    return
                self._send(200, {
                    "status": "ok", "active": 0,
                    "waiting": fake.waiting, "max_active": 4,
                    "draining": fake.draining,
                    "requests": {"live_requests": fake.waiting,
                                 "live_waiting": fake.waiting}})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n))
                with fake._lock:
                    fake.hits.append(doc.get("request_id"))
                if fake.mode == "die":
                    self.connection.close()
                    return
                if fake.mode == "slow":
                    time.sleep(fake.slow_s)
                if fake.mode == "s429":
                    self._send(429, {"error": "admission queue full"},
                               {"Retry-After": "1"})
                elif fake.mode == "s503drain":
                    self._send(503, {"error": "server draining"},
                               {"Retry-After": "5"})
                else:
                    self._send(200, {"state": "done",
                                     "output_ids": [1, 2, 3],
                                     "n_generated": 3,
                                     "served": fake.name,
                                     "ttft_s": 0.01,
                                     "request_id": doc.get("request_id")})

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        NAMES[self.url] = name
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def reset(self):
        self.mode = "ok"        # ok | die | slow | s429 | s503drain
        self.slow_s = 0.8
        self.draining = False
        self.waiting = 0
        self.hits = []          # request_ids seen on /generate

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture(scope="module")
def pair():
    a, b = FakeReplica("a"), FakeReplica("b")
    yield a, b
    a.close()
    b.close()


@contextmanager
def fleet(pk, a, b, **kw):
    """The reference test's ``fleet`` fixture, on package ``pk``."""
    args = dict(health_interval_s=0.05, probe_base_s=0.05, probe_max_s=0.5,
                retries=3, dispatch_timeout_s=5.0, request_timeout_s=10.0,
                start_health_thread=False)
    args.update(kw)
    r = pk.r.Router([a.url, b.url], **args)
    r.poll_once()
    try:
        yield r
    finally:
        r.close()


def _load(router, url, depth):
    """Pin a replica's polled queue depth (placement steering)."""
    with router._lock:
        for rep in router.replicas:
            if rep.url == url:
                rep.queue_depth = depth


def _rep(r, url):
    return next(x for x in r.replicas if x.url == url)


_HEX32 = re.compile(r"^[0-9a-f]{32}$")


def canon(x):
    """Observables with URLs by replica name and minted ids elided."""
    if isinstance(x, dict):
        return {canon(k): canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, str):
        if _HEX32.match(x):
            return "<minted>"
        for url, name in NAMES.items():
            x = x.replace(url, f"<{name}>")
        return x
    return x


_VIEW_KEYS = ("state", "inflight", "queue_depth", "live", "active",
              "waiting", "max_active", "dispatches", "failures",
              "fail_streak")


def views(r):
    return [{k: v[k] for k in ("url",) + _VIEW_KEYS}
            for v in r.replica_views()]


def verdict(res):
    """A route() result less what carries an exception's text."""
    code, doc, headers = res
    doc = dict(doc)
    if "last_error" in doc:
        doc["last_error"] = doc["last_error"] is not None
    return [code, doc, dict(headers)]


# ---------------------------------------------------------------------------
# the scenarios of tests/test_router.py, one function each: each holds the
# reference test's assertions and returns what it observed
# ---------------------------------------------------------------------------

def routes_least_loaded_and_carries_request_id(pk, a, b, mp):
    with fleet(pk, a, b) as r:
        _load(r, a.url, 5)
        res1 = r.route({"prompt": [1, 2], "max_tokens": 2})
        code, doc, _ = res1
        assert code == 200 and doc["served"] == "b"
        assert doc["served_by"] == b.url
        assert b.hits and isinstance(b.hits[-1], str) and b.hits[-1]
        assert doc["request_id"] == b.hits[-1]
        res2 = r.route({"prompt": [1], "request_id": "my-key"})
        assert res2[0] == 200 and res2[1]["request_id"] == "my-key"
        assert "my-key" in (a.hits + b.hits)
        return [verdict(res1), verdict(res2), views(r)]


def idle_live_waiting_zero_overrides_stale_iteration_depth(pk, a, b, mp):
    with fleet(pk, a, b) as r:
        rep = _rep(r, a.url)
        r._mark_alive(rep, {"active": 0, "waiting": 0, "max_active": 4,
                            "draining": False,
                            "requests": {"live_requests": 0,
                                         "live_waiting": 0,
                                         "decode_queue_depth": 3}})
        first = rep.queue_depth
        assert first == 0
        r._mark_alive(rep, {"active": 0, "waiting": 0, "max_active": 4,
                            "requests": {"decode_queue_depth": 3}})
        assert rep.queue_depth == 3
        return [first, rep.queue_depth, views(r)]


def health_poll_marks_down_and_circuit_reprobes(pk, a, b, mp):
    counters = lambda: pk.tel.counters_snapshot().get("router", {})  # noqa: E731
    with fleet(pk, a, b) as r:
        a.mode = "die"
        r.poll_once()
        states = {v["url"]: v["state"] for v in r.replica_views()}
        assert states[a.url] == pk.r.DOWN and states[b.url] == pk.r.HEALTHY
        down_total = counters().get("replica_down_total", 0)
        hits_before = len(a.hits)
        r.poll_once()
        assert counters().get("replica_down_total", 0) == down_total
        after_down = views(r)
        a.mode = "ok"
        time.sleep(0.08)
        r.poll_once()
        assert r.counts()[pk.r.HEALTHY] == 2
        assert len(a.hits) == hits_before
        return [states, after_down, views(r)]


def probe_backoff_grows_exponentially(pk, a, b, mp):
    with fleet(pk, a, b) as r:
        a.mode = "die"
        r.poll_once()
        rep = _rep(r, a.url)
        first = rep.next_probe_t - time.monotonic()
        time.sleep(0.08)
        r.poll_once()
        second = rep.next_probe_t - time.monotonic()
        assert second > first
        assert rep.fail_streak >= 2
        return [second > first, rep.fail_streak, views(r)]


def failover_on_dead_replica_is_client_invisible(pk, a, b, mp):
    with fleet(pk, a, b) as r:
        a.mode = "die"
        _load(r, b.url, 10)
        res = r.route({"prompt": [1], "request_id": "fo-1"})
        assert res[0] == 200 and res[1]["served"] == "b"
        assert a.hits[-1] == "fo-1" and b.hits[-1] == "fo-1"
        assert _rep(r, a.url).state == pk.r.DOWN
        return [verdict(res), views(r)]


def dispatch_timeout_retries_without_opening_circuit(pk, a, b, mp):
    with fleet(pk, a, b) as r:
        r.dispatch_timeout_s = 0.2
        a.mode = "slow"
        a.slow_s = 1.0
        _load(r, b.url, 10)
        res = r.route({"prompt": [1]})
        assert res[0] == 200 and res[1]["served"] == "b"
        assert _rep(r, a.url).state == pk.r.HEALTHY
        return [verdict(res), views(r)]


def no_new_dispatch_into_a_sliver_of_deadline(pk, a, b, mp):
    """The reference test races its attempt's timeout against the route
    loop's deadline check (both fire at the deadline).  Here the primary
    fails at once, inside a deadline below the launch floor: no retry may
    launch, so one dispatch and one deterministic verdict."""
    with fleet(pk, a, b) as r:
        assert r.request_timeout_s > 1.0
        a.mode = "die"
        _load(r, b.url, 10)                       # the primary goes to a
        r.request_timeout_s = 0.8                 # < _MIN_LAUNCH_WINDOW_S
        assert r.request_timeout_s < pk.r._MIN_LAUNCH_WINDOW_S
        res = r.route({"prompt": [1], "request_id": "sliver"})
        assert res[0] == 503, res
        assert res[1]["error"] == "no replica could serve the request"
        assert a.hits == ["sliver"] and b.hits == []
        return [verdict(res), views(r)]


def injected_dispatch_fault_drives_retry(pk, a, b, mp):
    with fleet(pk, a, b) as r:
        pk.fault.install_injector(f"router.dispatch@replica:{a.url}=error::1")
        try:
            _load(r, b.url, 10)
            res = r.route({"prompt": [1]})
            assert res[0] == 200 and res[1]["served"] == "b"
        finally:
            pk.fault.reset_injector()
        return [verdict(res), views(r)]


def client_errors_pass_through_without_retry(pk, a, b, mp):
    c = FakeReplica("c")

    def do_post_400(handler_self):
        body = json.dumps({"error": "bad request: boom"}).encode()
        handler_self.send_response(400)
        handler_self.send_header("Content-Length", str(len(body)))
        handler_self.end_headers()
        handler_self.wfile.write(body)

    c.httpd.RequestHandlerClass.do_POST = do_post_400
    r2 = pk.r.Router([c.url], retries=3, request_timeout_s=5.0,
                     start_health_thread=False)
    try:
        res = r2.route({"prompt": "bad"})
        assert res[0] == 400 and "bad request" in res[1]["error"]
        return [verdict(res), views(r2)]
    finally:
        r2.close()
        c.close()


def all_replicas_down_yields_503_with_retry_after(pk, a, b, mp):
    with fleet(pk, a, b) as r:
        a.mode = b.mode = "die"
        r.poll_once()
        assert r.counts()[pk.r.DOWN] == 2
        res = r.route({"prompt": [1]})
        assert res[0] == 503 and "Retry-After" in res[2]
        assert "no healthy replica" in res[1]["error"]
        return [verdict(res), views(r)]


def all_saturated_yields_429_with_aggregate_retry_after(pk, a, b, mp):
    with fleet(pk, a, b) as r:
        a.mode = b.mode = "s429"
        res = r.route({"prompt": [1]})
        assert res[0] == 429
        assert "saturated" in res[1]["error"]
        assert int(res[2]["Retry-After"]) >= 1
        assert a.hits and b.hits
        return [verdict(res), views(r)]


def retry_after_scales_with_aggregate_queue_depth(pk, a, b, mp):
    with fleet(pk, a, b) as r:
        for _ in range(4):
            r._record_latency(0.5)
        shallow = r.retry_after_s()
        _load(r, a.url, 300)
        _load(r, b.url, 300)
        with r._lock:
            for rep in r.replicas:
                rep.live = 300
        deep = r.retry_after_s()
        assert deep > shallow
        assert 1 <= shallow <= 60 and 1 <= deep <= 60
        return [shallow, deep]


def draining_replica_sheds_traffic(pk, a, b, mp):
    counters = lambda: pk.tel.counters_snapshot().get("router", {})  # noqa: E731
    with fleet(pk, a, b) as r:
        a.draining = True
        r.poll_once()
        assert r.counts() == {pk.r.HEALTHY: 1, pk.r.DOWN: 0,
                              pk.r.DRAINING: 1}
        out = []
        for _ in range(4):
            res = r.route({"prompt": [1]})
            assert res[0] == 200 and res[1]["served"] == "b"
            out.append(verdict(res))
        a.draining = False
        r.poll_once()
        a.mode = "s503drain"
        _load(r, b.url, 10)
        before = counters().get("drain_shifts", 0)
        res = r.route({"prompt": [1]})
        assert res[0] == 200 and res[1]["served"] == "b"
        assert counters()["drain_shifts"] == before + 1
        assert _rep(r, a.url).state == pk.r.DRAINING
        return [out, verdict(res), views(r)]


def hedge_fires_after_p99_mult_and_first_wins(pk, a, b, mp):
    with fleet(pk, a, b) as r:
        r.hedge_after_p99_mult = 3.0
        r.hedge_min_samples = 4
        assert r.hedge_after_s() is None
        warm = [verdict(r.route({"prompt": [1]})) for _ in range(6)]
        assert all(w[0] == 200 for w in warm)
        threshold = r.hedge_after_s()
        assert threshold is not None and threshold < 0.5
        a.mode = "slow"
        _load(r, a.url, 0)
        _load(r, b.url, 5)
        t0 = time.monotonic()
        res = r.route({"prompt": [1], "request_id": "hedge-1"})
        assert res[0] == 200 and res[1]["served"] == "b"
        assert time.monotonic() - t0 < a.slow_s
        assert a.hits[-1] == "hedge-1" and b.hits[-1] == "hedge-1"
        # the loser on a finishes later: its tokens are reaped off-thread
        _poll(lambda: pk.tel.counters_snapshot()["router"].get(
            "hedge_abandoned_tokens"), "the hedge loser reaped", 10.0)
        return [warm, verdict(res)]


def hedge_disabled_by_default(pk, a, b, mp):
    with fleet(pk, a, b) as r:
        assert r.hedge_after_p99_mult == 0.0
        for _ in range(20):
            r._record_latency(0.01)
        assert r.hedge_after_s() is None
        return [r.hedge_after_p99_mult, r.hedge_after_s()]


def _families(text):
    return sorted(set(re.findall(r"^# TYPE (\S+) ", text, re.M)))


def router_http_surface(pk, a, b, mp):
    with fleet(pk, a, b) as r:
        srv = pk.r.RouterHTTPServer(r, port=0)
        try:
            req = urllib.request.Request(
                srv.url + "/generate",
                data=json.dumps({"prompt": [1, 2]}).encode(),
                headers={"Content-Type": "application/json"})
            doc = json.loads(urllib.request.urlopen(req, timeout=10).read())
            assert doc["state"] == "done" and doc["served_by"] in (a.url,
                                                                   b.url)
            hz = json.loads(urllib.request.urlopen(
                srv.url + "/healthz", timeout=5).read())
            assert hz["status"] == "ok" and hz["healthy"] == 2
            assert len(hz["replicas"]) == 2
            reps = json.loads(urllib.request.urlopen(
                srv.url + "/replicas", timeout=5).read())
            assert {v["url"] for v in reps} == {a.url, b.url}
            codes = []
            for data in (b"{bad json",
                         json.dumps({"prompt": [1],
                                     "request_id": 7}).encode()):
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(urllib.request.Request(
                        srv.url + "/generate", data=data,
                        headers={"Content-Type": "application/json"}),
                        timeout=5)
                codes.append(e.value.code)
            assert codes == [400, 400]
            text = urllib.request.urlopen(
                srv.url + "/metrics", timeout=5).read().decode()
            pk.exp.validate_exposition_text(text)
            # the other package's checker takes it too
            (P["jax"] if pk is P["port"] else P["port"]
             ).exp.validate_exposition_text(text)
            for fam in ("dmlc_router_requests", "dmlc_router_dispatches",
                        "dmlc_router_replicas_healthy",
                        "dmlc_router_replica_health",
                        "dmlc_router_replica_queue_depth",
                        "dmlc_router_http_200"):
                assert fam in text, f"{fam} missing from router /metrics"
            assert f'replica="{a.url}"' in text
            keys = {k: (sorted(v) if isinstance(v, dict) else None)
                    for k, v in hz.items()}
            return [doc, hz["status"], hz["healthy"], keys,
                    [{k: v[k] for k in ("url",) + _VIEW_KEYS}
                     for v in reps], codes,
                    [ln for ln in text.splitlines()
                     if ln.startswith(("dmlc_router_replica_",
                                       "dmlc_router_http_200",
                                       "dmlc_router_http_400"))]]
        finally:
            srv.close()


def discover_replicas_from_tracker_job_map(pk, a, b, mp):
    def fake_hostmap(self):
        return {"gen": 0, "world": 3,
                "hosts": {"0": ["10.0.0.1", 4000],
                          "2": ["10.0.0.2", 4002],
                          "1": ["10.0.0.1", 4001]}}

    mp.setattr(pk.client.TrackerClient, "_query_hostmap", fake_hostmap)
    urls = pk.r.discover_replicas("10.0.0.9", 9091, 8901)
    assert urls == ["http://10.0.0.1:8901", "http://10.0.0.1:8902",
                    "http://10.0.0.2:8903"]
    return urls


def router_rejects_empty_or_duplicate_fleets(pk, a, b, mp):
    out = []
    for reps in ([], ["http://h:1", "http://h:1/"]):
        with pytest.raises(ValueError) as e:
            pk.r.Router(reps, start_health_thread=False)
        out.append(str(e.value))
    return out


def parse_tenant_weights_skips_malformed_entries(pk, a, b, mp):
    f = pk.r.parse_tenant_weights
    out = [f(None), f(""), f("paid=4, free=1"),
           f("paid=4,broken,=2,neg=-1,zero=0,free=nan3,ok=2"),
           f("x" * 65 + "=1,y=inf,z=1e3")]
    assert out[:4] == [{}, {}, {"paid": 4.0, "free": 1.0},
                       {"paid": 4.0, "ok": 2.0}]
    return out


def tenant_governor_accounting_only_by_default(pk, a, b, mp):
    g = pk.r.TenantGovernor(rate=0.0, burst_s=10.0)
    for _ in range(500):
        admitted, retry = g.admit("anyone")
        assert admitted and retry == 0.0
    by_name = {v["tenant"]: v for v in g.views()}
    assert by_name["anyone"]["requests"] == 500
    assert by_name["anyone"]["admitted"] == 500
    assert by_name["anyone"]["rejected"] == 0
    assert g.stats()["enforcing"] is False
    return g.stats()


def tenant_governor_weighted_rejection_and_honest_retry_after(pk, a, b,
                                                              mp):
    g = pk.r.TenantGovernor(rate=1.0, burst_s=2.0,
                            weights={"paid": 4.0, "free": 1.0})
    t0 = 1000.0
    n_ok = 0
    while g.admit("free", now=t0)[0]:
        n_ok += 1
    assert n_ok == 2
    seq = [g.admit("free", now=t0)]
    assert not seq[0][0]
    assert seq[0][1] == pytest.approx(1.0, abs=0.05)
    seq.append(g.admit("paid", now=t0))
    assert seq[-1][0]
    seq.append(g.admit("free", now=t0 + 0.5))
    assert not seq[-1][0] and seq[-1][1] == pytest.approx(0.5, abs=0.05)
    seq.append(g.admit("free", now=t0 + 1.6))
    assert seq[-1][0]
    by_name = {v["tenant"]: v for v in g.views()}
    assert by_name["free"]["rejected"] == 3
    assert by_name["paid"]["rejected"] == 0
    return [n_ok, seq, g.stats()]


def tenant_governor_retry_after_is_clamped(pk, a, b, mp):
    g = pk.r.TenantGovernor(rate=0.001, burst_s=1000.0, default_weight=1.0)
    while g.admit("slow", now=0.0)[0]:
        pass
    admitted, retry = g.admit("slow", now=0.0)
    assert not admitted and retry == 60.0
    return [admitted, retry, g.stats()]


def tenant_governor_overflow_folds_unknown_tenants(pk, a, b, mp):
    g = pk.r.TenantGovernor(rate=0.0, max_tenants=2, weights={"vip": 4.0})
    g.admit("t1")
    g.admit("t2")
    for i in range(10):
        g.admit(f"minted-{i}")
    g.admit("vip")
    by_name = {v["tenant"]: v for v in g.views()}
    assert set(by_name) == {"t1", "t2", pk.r.TenantGovernor.OVERFLOW, "vip"}
    assert by_name[pk.r.TenantGovernor.OVERFLOW]["requests"] == 10
    assert by_name["vip"]["weight"] == 4.0
    return g.stats()


def tenant_governor_prometheus_text_is_strict_and_labeled(pk, a, b, mp):
    g = pk.r.TenantGovernor(rate=1.0, burst_s=2.0, weights={"paid": 4.0})
    assert g.prometheus_text() == ""
    g.admit("paid", now=5.0)
    g.admit("free", now=5.0)
    g.observe_completion("paid", 7)
    text = g.prometheus_text()
    pk.exp.validate_exposition_text(text)
    assert 'dmlc_tenant_requests_total{tenant="paid"} 1' in text
    assert 'dmlc_tenant_tokens_generated_total{tenant="paid"} 7' in text
    assert 'dmlc_tenant_weight{tenant="paid"} 4.0' in text
    assert 'dmlc_tenant_weight{tenant="free"} 1.0' in text
    return text


def dynamic_registry_add_remove_and_draining(pk, a, b, mp):
    counters = lambda: pk.tel.counters_snapshot().get("router", {})  # noqa: E731
    c = FakeReplica("c")
    try:
        with fleet(pk, a, b) as r:
            rep = r.add_replica(c.url)
            assert rep.state == pk.r.HEALTHY
            assert len(r.replica_views()) == 3
            with pytest.raises(ValueError):
                r.add_replica(c.url + "/")
            assert r.set_draining(c.url)
            assert r.counts()[pk.r.DRAINING] == 1
            served = []
            for i in range(6):
                code, out, _ = r.route({"prompt": [1],
                                        "request_id": f"d{i}"})
                assert code == 200 and out["served"] in ("a", "b")
                served.append(out["served"])
            assert not c.hits
            mid = views(r)
            assert r.remove_replica(c.url)
            assert len(r.replica_views()) == 2
            assert not r.remove_replica(c.url)
            assert not r.set_draining("http://nowhere:1")
            cnt = counters()
            assert cnt.get("replicas_added", 0) >= 1
            assert cnt.get("replicas_removed", 0) >= 1
            return [served, mid, views(r), r.counts()]
    finally:
        c.close()


def utilization_tracks_live_load_over_capacity(pk, a, b, mp):
    with fleet(pk, a, b) as r:
        u = [r.utilization()]
        assert u[0] == 0.0
        a.waiting = 6
        r.poll_once()
        u.append(r.utilization())
        assert u[-1] == pytest.approx(6 / 8)
        b.mode = "die"
        r.poll_once()
        u.append(r.utilization())
        assert u[-1] == pytest.approx(6 / 4)
        return u


class _FakeFleetSource:
    """Stands in for a fleet autoscaler on the router's HTTP surface."""

    def report(self):
        return {"replicas": 2, "owned": [], "saturated": False}

    def prometheus_text(self):
        return ("# HELP dmlc_fleet_replicas replicas the router routes to\n"
                "# TYPE dmlc_fleet_replicas gauge\n"
                "dmlc_fleet_replicas 2\n")


def http_tenant_gate_and_fleet_endpoint(pk, a, b, mp):
    gov = pk.r.TenantGovernor(rate=1.0, burst_s=1.0,
                              weights={"paid": 100.0, "free": 1.0})
    r = pk.r.Router([a.url], health_interval_s=3600, retries=2,
                    dispatch_timeout_s=5.0, request_timeout_s=10.0,
                    tenants=gov, start_health_thread=False)
    r.poll_once()
    fleet_src = _FakeFleetSource()
    srv = pk.r.RouterHTTPServer(r, port=0, fleet_source=lambda: fleet_src)

    def post(doc):
        req = urllib.request.Request(
            srv.url + "/generate", data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req, timeout=10).read())

    try:
        obs = [post({"prompt": [1, 2], "tenant": "free"})]
        assert obs[0]["state"] == "done"
        with pytest.raises(urllib.error.HTTPError) as e:
            post({"prompt": [1, 2], "tenant": "free"})
        assert e.value.code == 429
        assert float(e.value.headers["Retry-After"]) >= 0.1
        body = json.loads(e.value.read())
        assert body["tenant"] == "free" and "over budget" in body["error"]
        obs += [e.value.code, body]
        for i in range(3):
            out = post({"prompt": [1], "tenant": "paid",
                        "request_id": f"p{i}"})
            assert out["state"] == "done"
            obs.append(out)
        for bad in (42, "", "x" * 65):
            with pytest.raises(urllib.error.HTTPError) as e:
                post({"prompt": [1], "tenant": bad})
            assert e.value.code == 400
            obs.append(json.loads(e.value.read()))
        by_name = {v["tenant"]: v for v in gov.views()}
        assert by_name["paid"]["tokens_generated"] == 9
        assert by_name["free"]["tokens_generated"] == 3
        fl = json.loads(urllib.request.urlopen(
            srv.url + "/fleet", timeout=5).read())
        assert fl.pop("replica_availability") == {a.url: None}
        assert fl == {"replicas": 2, "owned": [], "saturated": False}
        text = urllib.request.urlopen(
            srv.url + "/metrics", timeout=5).read().decode()
        pk.exp.validate_exposition_text(text)
        assert 'dmlc_tenant_rejected_total{tenant="free"} 1' in text
        assert "dmlc_fleet_replicas 2" in text
        decisions = json.loads(urllib.request.urlopen(
            srv.url + "/decisions", timeout=5).read())
        # the rejection's retry_after_s and the bucket levels follow the
        # clock between the two posts
        obs += [[{k: v for k, v in rec.items()
                  if k not in ("t", "retry_after_s")}
                 for rec in decisions["decisions"]],
                [{k: v for k, v in x.items() if k != "bucket_level"}
                 for x in gov.views()],
                [ln for ln in text.splitlines()
                 if ln.startswith(("dmlc_tenant_", "dmlc_fleet_"))
                 and not ln.startswith("dmlc_tenant_bucket_level")]]
        return obs
    finally:
        srv.close()
        r.close()


SCENARIOS = [
    routes_least_loaded_and_carries_request_id,
    idle_live_waiting_zero_overrides_stale_iteration_depth,
    health_poll_marks_down_and_circuit_reprobes,
    probe_backoff_grows_exponentially,
    failover_on_dead_replica_is_client_invisible,
    dispatch_timeout_retries_without_opening_circuit,
    no_new_dispatch_into_a_sliver_of_deadline,
    injected_dispatch_fault_drives_retry,
    client_errors_pass_through_without_retry,
    all_replicas_down_yields_503_with_retry_after,
    all_saturated_yields_429_with_aggregate_retry_after,
    retry_after_scales_with_aggregate_queue_depth,
    draining_replica_sheds_traffic,
    hedge_fires_after_p99_mult_and_first_wins,
    hedge_disabled_by_default,
    router_http_surface,
    discover_replicas_from_tracker_job_map,
    router_rejects_empty_or_duplicate_fleets,
    parse_tenant_weights_skips_malformed_entries,
    tenant_governor_accounting_only_by_default,
    tenant_governor_weighted_rejection_and_honest_retry_after,
    tenant_governor_retry_after_is_clamped,
    tenant_governor_overflow_folds_unknown_tenants,
    tenant_governor_prometheus_text_is_strict_and_labeled,
    dynamic_registry_add_remove_and_draining,
    utilization_tracks_live_load_over_capacity,
    http_tenant_gate_and_fleet_endpoint,
]


def _router_counters(pk):
    """The router's counters (durations' sums, which are timings, left
    out)."""
    return {k: v for k, v in pk.tel.counters_snapshot().get(
        "router", {}).items() if not k.endswith("_secs")}


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_equal_on_both_routers(scenario, pair, monkeypatch):
    monkeypatch.delenv("DMLC_TRACE_FLEET", raising=False)
    for knob in ("DMLC_TENANT_RATE", "DMLC_TENANT_WEIGHTS",
                 "DMLC_ROUTER_HEDGE_AFTER_P99_MULT", "DMLC_FAULT_SPEC"):
        monkeypatch.delenv(knob, raising=False)
    got = {}
    for name in ("jax", "port"):
        pk = P[name]
        for x in pair:
            x.reset()
        pk.tel.reset()
        pk.tc.reset_decisions()
        with monkeypatch.context() as mp:
            obs = scenario(pk, *pair, mp)
        got[name] = canon({"obs": obs,
                           "hits": [x.hits for x in pair],
                           "counters": _router_counters(pk)})
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# end to end: port replicas as processes behind the port's route.py
# ---------------------------------------------------------------------------

PROC_TIMEOUT_S = 240     # every process of the fleet is killed after this
E2E_ENV = {"OMP_NUM_THREADS": "1", "DMLC_TRACE_FLEET": "1",
           "DMLC_SERVE_KV_BLOCKS": "128", "DMLC_SERVE_KV_BLOCK_SIZE": "8",
           "DMLC_SERVE_MAX_ACTIVE": "4",
           "DMLC_ROUTER_HEALTH_INTERVAL_S": "0.2",
           "DMLC_ROUTER_PROBE_BASE_S": "0.2",
           "DMLC_ROUTER_PROBE_MAX_S": "1.0",
           "DMLC_ROUTER_PROBE_TIMEOUT_S": "2.0"}


class Proc:
    """One fleet process with its log; ``url`` is read from the log's
    first line (``--port 0`` picks a free port)."""

    def __init__(self, argv, log_path, word):
        self.log_path = log_path
        self.log = open(log_path, "w")
        self.p = subprocess.Popen(
            [sys.executable, "-m"] + argv, cwd=ROOT, stdout=self.log,
            stderr=subprocess.STDOUT,
            env={**os.environ, **E2E_ENV, "PYTHONPATH": str(ROOT)})
        deadline = time.monotonic() + 120
        self.url = None
        while self.url is None:
            m = re.search(rf"{word}.*?(http://[0-9.]+:[0-9]+)",
                          log_path.read_text())
            if m:
                self.url = m.group(1)
                break
            assert self.p.poll() is None, log_path.read_text()[-3000:]
            assert time.monotonic() < deadline, "process never listened"
            time.sleep(0.05)

    @property
    def port(self):
        return int(self.url.rsplit(":", 1)[1])

    def stop(self):
        if self.p.poll() is None:
            self.p.kill()
        self.p.wait(timeout=30)
        self.log.close()


def replica(tmp, name, port=0):
    return Proc([f"{PKG}.serving.serve", "--model", "tiny", "--device",
                 "cpu", "--seed", "0", "--port", str(port)],
                tmp / f"{name}.log", "serve:")


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        body = r.read()
        return (json.loads(body)
                if r.headers.get("Content-Type") == "application/json"
                else body.decode())


def _post(url, doc, timeout=120):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _poll(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while True:
        v = cond()
        if v:
            return v
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.02)


def _state(router_url, url):
    return next(v for v in _get(router_url + "/replicas")
                if v["url"] == url)


def _metric(text, name):
    m = re.search(rf"^{name} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def _load_run(url, prompts, tag, max_tokens, on_done=None):
    """One closed-loop stream per prompt pair; returns [(prompt index,
    status, doc)] in completion order."""
    out, lock = [], threading.Lock()

    def stream(s):
        for k in range(2):
            i = (2 * s + k) % len(prompts)
            code, doc = _post(url, {"prompt": prompts[i],
                                    "max_tokens": max_tokens,
                                    "request_id": f"{tag}-{s}-{k}"})
            with lock:
                out.append((i, code, doc))
                n = len(out)
            if on_done:
                on_done(n)

    threads = [threading.Thread(target=stream, args=(s,))
               for s in range(len(prompts) // 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=PROC_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """Two port replicas behind the port's router: direct answers, a
    SIGKILL mid-load, a restart on the same port, a SIGTERM drain."""
    tmp = tmp_path_factory.mktemp("fleet")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, int(n)).tolist()
               for n in rng.integers(3, 24, 12)]
    procs = {}
    res = {"prompts": prompts}
    try:
        procs["A"], procs["B"] = replica(tmp, "A"), replica(tmp, "B")
        A, B = procs["A"].url, procs["B"].url
        procs["R"] = Proc([f"{PKG}.serving.route", "--replicas",
                           f"{A},{B}", "--port", "0"], tmp / "router.log",
                          "dmlc-router:")
        R = procs["R"].url
        res["urls"] = {"A": A, "B": B, "R": R}
        _poll(lambda: _get(R + "/healthz")["healthy"] == 2, "2 healthy")
        # direct answers from A, one request at a time
        res["direct"] = [_post(A, {"prompt": p, "max_tokens": 24,
                                   "request_id": f"direct-{i}"})
                         for i, p in enumerate(prompts)]
        # SIGKILL B once it holds a dispatch and 2 requests have finished
        killed = threading.Event()

        def kill_b(n):
            if n >= 2 and not killed.is_set():
                _poll(lambda: _state(R, B)["inflight"] > 0,
                      "a dispatch on B", timeout=60)
                procs["B"].p.send_signal(signal.SIGKILL)
                res["t_kill"] = time.monotonic()
                killed.set()

        res["killed_run"] = _load_run(R, prompts, "kill", 24, kill_b)
        assert killed.is_set()
        procs["B"].stop()
        res["b_state_after_kill"] = _state(R, B)["state"]
        res["metrics_after_kill"] = _get(R + "/metrics")
        res["trace"] = _get(R + "/trace")
        res["timelines"] = {}
        for ev in res["trace"]:
            args = ev.get("args") or {}
            if (ev.get("name") == "router.dispatch"
                    and args.get("replica") == B
                    and args.get("outcome") == "transport"):
                tid = args["trace_id"]
                res["timelines"][tid] = _get(R + f"/trace/{tid}")
        # B back on its old port: the probe closes the circuit
        procs["B"] = replica(tmp, "B2", port=int(B.rsplit(":", 1)[1]))
        t0 = time.monotonic()
        _poll(lambda: _state(R, B)["state"] == "healthy", "B healthy",
              timeout=30)
        res["restart_to_healthy_s"] = time.monotonic() - t0
        served = []
        for burst in range(10):
            out = _load_run(R, prompts[:8], f"rec{burst}", 8)
            served += [doc.get("served_by") for _, _, doc in out]
            res.setdefault("recovery_codes", []).extend(
                code for _, code, _ in out)
            if B in served:
                break
        res["recovery_served"] = served
        # SIGTERM A during a load: it drains, B takes the new work
        drained = threading.Event()

        def term_a(n):
            if n >= 2 and not drained.is_set():
                procs["A"].p.send_signal(signal.SIGTERM)
                drained.set()

        res["drain_run"] = _load_run(R, prompts, "drain", 24, term_a)
        res["a_rc"] = procs["A"].p.wait(timeout=120)
        res["a_log"] = procs["A"].log_path.read_text()
        res["metrics_end"] = _get(R + "/metrics")
        procs["R"].p.send_signal(signal.SIGTERM)
        res["router_rc"] = procs["R"].p.wait(timeout=30)
        yield res
    finally:
        for p in procs.values():
            p.stop()


def test_kill_mid_load_is_client_invisible_with_equal_tokens(fleet_run):
    r = fleet_run
    assert all(code == 200 for code, _ in r["direct"])
    want = [doc["output_ids"] for _, doc in r["direct"]]
    run = r["killed_run"]
    assert len(run) == len(r["prompts"])
    assert all(code == 200 for _, code, _ in run), \
        [(code, doc) for _, code, doc in run if code != 200]
    for i, _, doc in run:
        assert doc["output_ids"] == want[i], (i, doc["served_by"])
    assert r["b_state_after_kill"] == "down"
    assert _metric(r["metrics_after_kill"],
                   "dmlc_router_failovers_total") >= 1
    texp.validate_exposition_text(r["metrics_after_kill"])


def test_torn_request_is_one_trace_with_flow_arrows(fleet_run):
    r = fleet_run
    A, B = r["urls"]["A"], r["urls"]["B"]
    assert r["timelines"], "no dispatch to B was torn"
    ok = []
    for tid, tl in r["timelines"].items():
        disp = {e["args"]["replica"]: e["args"]["outcome"]
                for e in tl["events"] if e["name"] == "router.dispatch"}
        serving_on_a = [e for e in tl["events"] if e["source"] == A
                        and str(e["cat"]).startswith("serving")]
        ok.append(disp.get(B) == "transport" and disp.get(A) == "ok"
                  and bool(serving_on_a)
                  and tl["summary"]["attempts"] >= 2)
    assert any(ok), r["timelines"]
    phs = {e.get("ph") for e in r["trace"]}
    assert {"s", "f"} <= phs
    labels = {e["args"]["name"] for e in r["trace"]
              if e.get("name") == "process_name"}
    assert {"router", f"replica {A}", f"replica {B}"} <= labels


def test_restarted_replica_closes_its_circuit_and_serves(fleet_run):
    r = fleet_run
    assert r["restart_to_healthy_s"] < 30
    assert all(code == 200 for code in r["recovery_codes"])
    assert r["urls"]["B"] in r["recovery_served"]
    assert _metric(r["metrics_end"], "dmlc_router_probe_recoveries") >= 1


def test_sigterm_drain_reaches_clients_with_zero_503(fleet_run):
    r = fleet_run
    want = [doc["output_ids"] for _, doc in r["direct"]]
    run = r["drain_run"]
    assert [code for _, code, _ in run] == [200] * len(run), run
    for i, _, doc in run:
        assert doc["output_ids"] == want[i]
    assert r["a_rc"] == 0 and "drained, exiting" in r["a_log"]
    assert r["router_rc"] == 0
    assert _metric(r["metrics_end"], "dmlc_router_http_503") == 0


# ---------------------------------------------------------------------------
# interop: one package's router in front of the other's replicas
# ---------------------------------------------------------------------------

DIMS = dict(vocab=64, d_model=32, n_heads=2, head_dim=8, d_ff=64,
            n_layers=2, n_experts=1)


@pytest.fixture(scope="module")
def weights():
    jcfg = jtfm.TransformerConfig(**DIMS, microbatches=1)
    params = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            ttfm.TransformerConfig(**DIMS), device="cpu")
    return params, jcfg, model


def _replica_server(kind, weights):
    params, jcfg, model = weights
    kw = dict(n_blocks=64, block_size=4, max_active=2)
    if kind == "jax":
        eng = JaxEngine(params, jcfg, **kw)
        eng.start()
        return eng, JaxServer(eng)
    eng = InferenceEngine(model, device="cpu", **kw)
    eng.start()
    return eng, ServingHTTPServer(eng)


INTEROP_PROMPTS = [[3, 9, 27, 17], [5, 1, 4], [60, 2, 33, 7, 7, 12],
                   [11], [8, 8, 8, 8, 8]]


@pytest.mark.parametrize("router_pkg,replicas", [
    ("port", ("jax", "port")),
    ("jax", ("port", "port")),
])
def test_router_over_the_other_packages_replicas(router_pkg, replicas,
                                                 weights, monkeypatch):
    monkeypatch.delenv("DMLC_TRACE_FLEET", raising=False)
    pk = P[router_pkg]
    pk.tel.reset()
    servers = [_replica_server(kind, weights) for kind in replicas]
    urls = [srv.url for _, srv in servers]
    r = pk.r.Router(urls, retries=3, dispatch_timeout_s=60.0,
                    request_timeout_s=120.0, start_health_thread=False)
    closed = set()
    try:
        r.poll_once()
        # the JAX engine's greedy answers are the reference
        jeng, jsrv = _replica_server("jax", weights)
        try:
            want = [_post(jsrv.url, {"prompt": p, "max_tokens": 12})[1]
                    ["output_ids"] for p in INTEROP_PROMPTS]
        finally:
            jsrv.close()
            jeng.close()
        served = []
        for k, p in enumerate(INTEROP_PROMPTS * 2):
            target = urls[k % 2]
            _load(r, urls[(k + 1) % 2], 100)     # steer onto ``target``
            _load(r, target, 0)
            if router_pkg == "jax" and k == len(INTEROP_PROMPTS):
                # a port replica leaves mid-run: the JAX router fails over
                servers[1][1].close()
                closed.add(1)
                _load(r, urls[1], 0)
                _load(r, urls[0], 100)
            code, doc, _ = r.route({"prompt": p, "max_tokens": 12})
            assert code == 200, doc
            assert doc["output_ids"] == want[k % len(INTEROP_PROMPTS)], k
            served.append(doc["served_by"])
        assert set(served) == set(urls)
        if closed:
            c = _router_counters(pk)
            assert c.get("failovers_total", 0) >= 1
            assert served[len(INTEROP_PROMPTS):] == \
                [urls[0]] * len(INTEROP_PROMPTS)
    finally:
        r.close()
        for i, (eng, srv) in enumerate(servers):
            if i not in closed:
                srv.close()
            eng.close()
