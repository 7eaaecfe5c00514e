"""The port's serving telemetry against the JAX package's, on the CPU.

* The engine, single-stepped on converted weights beside the JAX engine
  through forced preemption, with and without speculative decoding: the
  same request records (relative ids, prompt and generated counts,
  preemptions, resumes, outcomes), the same decode-iteration records,
  and per decode step the same ledger ``tokens``, ``flops``,
  ``tokens_per_step`` and accept rate (all exact: same integers, same
  float arithmetic in the same order).
* Dedupe and drain on both engines, driven the same way.
* The HTTP surface: every endpoint's document carries the JAX server's
  keys, ``/metrics`` passes the JAX package's exposition checker and
  holds only registered families, 503 + Retry-After while draining, and
  SIGTERM drains a server process.
* The wire format: the JAX load generator drives the port's server and
  the port's drives the JAX server.

Nothing here compares a sleep with a threshold; waits are bounded
polls on state.
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
from pathlib import Path

import numpy as np
import pytest

import jax

import dmlc_tpu_torch
from dmlc_tpu import telemetry as jtel
from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu.serving import EngineDraining as JaxDraining
from dmlc_tpu.serving import InferenceEngine as JaxEngine
from dmlc_tpu.serving import LoadGenerator as JaxLoadGenerator
from dmlc_tpu.serving import ServingHTTPServer as JaxServer
from dmlc_tpu.telemetry.exporters import validate_exposition_text
from dmlc_tpu_torch import telemetry as ttel
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.models.convert import params_from_jax
from dmlc_tpu_torch.telemetry.metric_names import METRIC_NAMES
from dmlc_tpu_torch.serving import (EngineDraining, InferenceEngine,
                                    LoadGenerator, ServingHTTPServer)

ROOT = Path(__file__).resolve().parents[1]
DIMS = dict(vocab=64, d_model=32, n_heads=2, head_dim=8, d_ff=64,
            n_layers=2, n_experts=1)
PACKAGES = ("jax", "port")


@pytest.fixture(scope="module")
def weights():
    jcfg = jtfm.TransformerConfig(**DIMS, microbatches=1)
    params = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            ttfm.TransformerConfig(**DIMS), device="cpu")
    return params, jcfg, model


def _reset_all():
    for tel in (jtel, ttel):
        tel.reset()
        tel.reset_steps()
        tel.declare_dtype(None)
        tel.reset_events()
        tel.slo.reset_slo()


@pytest.fixture(autouse=True)
def clean_registries(monkeypatch):
    for knob in ("DMLC_SLO_TTFT_P99_S", "DMLC_SLO_TBT_P99_S",
                 "DMLC_SLO_ERROR_RATE", "DMLC_TRACE_FLEET"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("DMLC_SERVE_PAGED_ATTN", "on")
    _reset_all()
    yield
    _reset_all()


def _engine(pkg, weights, **kw):
    params, jcfg, model = weights
    if pkg == "jax":
        return JaxEngine(params, jcfg, **kw)
    return InferenceEngine(model, device="cpu", **kw)


def _tel(pkg):
    return jtel if pkg == "jax" else ttel


def _single_step(engine, prompts, max_new):
    """Submit every prompt, then step the engine by hand until all are
    finished (deterministic: no engine thread)."""
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    for _ in range(2000):
        if all(r.state in ("done", "failed") for r in reqs):
            break
        engine.step()
    assert all(r.state == "done" for r in reqs), [r.error for r in reqs]
    return reqs


_REC_KEYS = ("state", "reason", "error", "n_prompt", "n_generated",
             "preemptions", "resumes")
_STEP_KEYS = ("tokens", "flops", "tokens_per_step", "spec_accept_rate")


@pytest.mark.parametrize("spec_k", [0, 3])
def test_ledgers_match_jax_engine_through_preemption(weights, monkeypatch,
                                                     spec_k):
    monkeypatch.setenv("DMLC_SERVE_SPEC_K", str(spec_k))
    monkeypatch.setenv("DMLC_SERVE_SPEC_MIN_CTX", "4")
    kw = dict(n_blocks=6, block_size=4, max_active=3, queue_depth=8)
    prompts = [[i + 1] * 4 for i in range(3)]
    out = {}
    for pkg in PACKAGES:
        eng = _engine(pkg, weights, **kw)
        reqs = _single_step(eng, prompts, 12)
        base = min(r.id for r in reqs)
        recs = sorted(eng.requests.records(), key=lambda r: r["seq"])
        out[pkg] = {
            "outputs": [list(r.generated) for r in reqs],
            "records": [dict({k: r[k] for k in _REC_KEYS},
                             id=r["id"] - base) for r in recs],
            "iterations": [{k: v for k, v in it.items() if k != "t_wall"}
                           for it in eng.requests.iterations(10_000)],
            "steps": [{k: r[k] for k in _STEP_KEYS}
                      for r in _tel(pkg).ledger().records()],
            "summary": eng.requests.summary(),
        }
        eng.close()
    want, got = out["jax"], out["port"]
    assert got["outputs"] == want["outputs"]
    assert got["records"] == want["records"]
    assert sum(r["preemptions"] for r in got["records"]) > 0
    assert got["iterations"] == want["iterations"]
    assert got["steps"] == want["steps"] and got["steps"]
    if spec_k:
        assert any(s["spec_accept_rate"] is not None for s in got["steps"])
    same = ("requests_done", "requests_failed", "fail_reasons",
            "preemptions", "preemption_rate", "resumes", "tokens_generated",
            "live_requests", "live_waiting", "kv_occupancy",
            "kv_waste_tokens", "decode_queue_depth", "iterations")
    assert {k: got["summary"][k] for k in same} == \
        {k: want["summary"][k] for k in same}
    assert set(got["summary"]) == set(want["summary"])
    # the TTFT identity holds on the port's records
    for r in eng.requests.records():
        assert r["ttft_s"] == pytest.approx(r["queue_s"] + r["prefill_s"],
                                            abs=1e-12)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_dedupe_returns_the_original_without_a_second_prefill(weights, pkg):
    tel = _tel(pkg)
    eng = _engine(pkg, weights, n_blocks=16, block_size=4, max_active=2,
                  queue_depth=1, admit_timeout_s=0.05)
    first = eng.submit([1, 2, 3], max_new_tokens=4, request_id="k1")
    assert eng.submit([1, 2, 3], max_new_tokens=4, request_id="k1") is first
    # the only queue slot is held: a new id is refused and unpublished
    with pytest.raises(Exception, match="admission queue full"):
        eng.submit([4, 5], max_new_tokens=4, request_id="k2")
    while first.state not in ("done", "failed"):
        eng.step()
    prefills = tel.counters_snapshot()["serving"]["prefill_tokens"]
    again = eng.submit([9, 9], max_new_tokens=4, request_id="k1")
    assert again is first and again.generated == first.generated
    assert tel.counters_snapshot()["serving"]["prefill_tokens"] == prefills
    assert tel.counters_snapshot()["serving"]["dedupe_hits"] == 2
    fresh = eng.submit([4, 5], max_new_tokens=4, request_id="k2")
    assert fresh.client_id == "k2" and fresh.state == "waiting"
    assert fresh.result()["request_id"] == "k2"
    eng.close()
    assert fresh.state == "failed"      # swept by close: reason shutdown
    assert eng.requests.summary()["fail_reasons"] == {"shutdown": 1}
    with pytest.raises(ValueError):
        eng.submit([1], request_id="")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_drain_finishes_inflight_and_refuses_new_work(weights, pkg):
    tel = _tel(pkg)
    draining = JaxDraining if pkg == "jax" else EngineDraining
    eng = _engine(pkg, weights, n_blocks=64, block_size=4, max_active=2)
    eng.start()
    try:
        r = eng.submit([1, 2, 3], max_new_tokens=40, request_id="live")
        eng.begin_drain()
        assert eng.draining and eng.stats()["draining"]
        with pytest.raises(draining):
            eng.submit([4], max_new_tokens=2)
        # a retry of admitted work still resolves while draining
        assert eng.submit([4], request_id="live") is r
        assert eng.drain(timeout_s=120) is True
    finally:
        eng.close()
    assert r.state == "done" and r.n_generated == 40
    kinds = [e["kind"] for e in tel.events_tail()]
    assert kinds[-2:] == ["serving_drain_begin", "serving_drain_end"]
    rep = eng.availability.report()
    assert rep["state"] == "draining" and rep["fractions"]["draining"] > 0
    assert tel.snapshot()["gauges"]["serving"]["draining"] == 1.0


# ---------------------------------------------------------------------------
# the HTTP surface
# ---------------------------------------------------------------------------

def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        body = r.read()
        ctype = r.headers.get("Content-Type")
    return (json.loads(body) if ctype == "application/json"
            else body.decode())


def _post(url, doc, headers=None):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _keys(doc):
    """Key skeleton of a JSON document: dict keys recursively, lists by
    their first element."""
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_keys(doc[0])] if doc else []
    return None


def _serve(pkg, weights, tel):
    slo = tel.SLOMonitor(ttft_p99_s=30.0, tbt_p99_s=30.0, error_rate=0.5)
    eng = _engine(pkg, weights, n_blocks=64, block_size=4, max_active=2,
                  slo_monitor=slo)
    eng.start()
    srv = (JaxServer if pkg == "jax" else ServingHTTPServer)(eng)
    return eng, srv


def test_endpoints_carry_the_jax_servers_keys(weights, monkeypatch):
    monkeypatch.setenv("DMLC_TRACE_FLEET", "1")
    docs = {}
    for pkg in PACKAGES:
        tel = _tel(pkg)
        eng, srv = _serve(pkg, weights, tel)
        try:
            code, gen, _ = _post(srv.url, {"prompt": [1, 2, 3],
                                           "max_tokens": 5,
                                           "request_id": "r-1",
                                           "tenant": "t0"})
            assert code == 200
            docs[pkg] = {"generate": gen}
            for path in ("/healthz", "/requests", "/slo", "/goodput",
                         "/trace", "/spans?since=0&limit=5", "/metrics"):
                docs[pkg][path] = _get(srv.url, path)
            assert _post(srv.url, {"prompt": "x"})[0] == 400
            eng.begin_drain()
            code, body, hdrs = _post(srv.url, {"prompt": [1],
                                               "max_tokens": 2})
            assert code == 503 and hdrs.get("Retry-After") == "5", body
            assert _post(srv.url, {"prompt": [7], "request_id": "r-1"}
                         )[1]["output_ids"] == gen["output_ids"]
        finally:
            srv.close()
            eng.close()
    want, got = docs["jax"], docs["port"]
    assert set(want["generate"]) == set(got["generate"])
    assert got["generate"]["trace_id"] == want["generate"]["trace_id"]
    assert set(want["/healthz"]) <= set(got["/healthz"])
    for path in ("/requests", "/slo", "/goodput", "/spans?since=0&limit=5"):
        assert _keys(got[path]) == _keys(want[path]), path
    assert set(got["/trace"]) == set(want["/trace"])
    assert {e["name"] for e in got["/trace"]["traceEvents"]} >= {
        "serving.queue", "serving.prefill", "serving.decode", "step"}
    text = got["/metrics"]
    assert validate_exposition_text(text) > 0
    families = set(re.findall(r"^# TYPE (\S+) ", text, re.M))
    assert families and families <= METRIC_NAMES, families - METRIC_NAMES
    # every family the JAX server shows for the same traffic that the port
    # can emit is there too (the JAX-only ones are compile and KV gauges)
    jax_families = set(re.findall(r"^# TYPE (\S+) ", want["/metrics"], re.M))
    for fam in ("dmlc_step_time_secs", "dmlc_step_mfu_pct",
                "dmlc_serving_ttft_secs", "dmlc_serving_tbt_secs",
                "dmlc_serving_queue_wait_secs", "dmlc_serving_http_200",
                "dmlc_slo_burn_rate", "dmlc_availability_fraction"):
        assert fam in families and fam in jax_families, fam


@pytest.mark.parametrize("client", ["jax_client_port_server",
                                    "port_client_jax_server"])
def test_load_generators_drive_either_server(weights, client, tmp_path):
    server_pkg = "port" if client.startswith("jax") else "jax"
    eng, srv = _serve(server_pkg, weights, _tel(server_pkg))
    make = JaxLoadGenerator if client.startswith("jax") else LoadGenerator
    try:
        gen = make(srv.url, n_streams=2, requests_per_stream=2,
                   prompt_len=(3, 8), max_tokens=4, vocab=DIMS["vocab"])
        summary = gen.run()
        doc = gen.emit_bench(str(tmp_path / "bench.json"), summary)
    finally:
        srv.close()
        eng.close()
    assert summary["n_requests_ok"] == 4 and not gen.failures
    assert summary["total_generated_tokens"] == 16
    assert summary["p99_ttft_s"] is not None
    for key in ("decode_step_p99_s", "tbt_p99_s", "server_ttft_p99_s",
                "decode_tokens_per_step"):
        assert doc[key] is not None, key


def _drain_run(drain_s, max_tokens):
    """A ``serve`` process with ``DMLC_SERVE_DRAIN_S=drain_s``: one
    request of ``max_tokens`` in flight when SIGTERM lands.  Returns the
    request's (status, doc) and the process's exit code and output."""
    pkg = dmlc_tpu_torch.__name__
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.serving.serve", "--model", "tiny",
         "--device", "cpu", "--port", "0"], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT),
             "DMLC_SERVE_DRAIN_S": str(drain_s)})
    try:
        line = proc.stdout.readline()
        m = re.search(r"http://[0-9.]+:[0-9]+", line)
        assert m, line
        url = m.group(0)
        result = {}

        def long_request():
            result["r"] = _post(url, {"prompt": [1, 2, 3],
                                      "max_tokens": max_tokens})

        t = threading.Thread(target=long_request)
        t.start()
        deadline = time.monotonic() + 120
        while _get(url, "/healthz")["active"] < 1:
            assert time.monotonic() < deadline, "the request never started"
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=300)
        assert not t.is_alive()
        code, doc, _ = result["r"]
        out, _ = proc.communicate(timeout=120)
        return code, doc, proc.returncode, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_sigterm_drains_a_server_process(tmp_path):
    """``serve`` arms SIGTERM: the in-flight request finishes, then the
    process exits 0 having drained.  The drain window is set to 240 s,
    inside the 300 s the test waits for the request: the test is of the
    drain, not of how fast this host generates 1500 tokens (a loaded
    host took 36-40 s, past the default 30 s window)."""
    code, doc, rc, out = _drain_run(240, 1500)
    assert code == 200 and doc["n_generated"] == 1500, doc
    assert rc == 0, out
    assert "drained, exiting" in out


def test_sigterm_drain_window_cuts_a_generation_off(tmp_path):
    """The other half of ``DMLC_SERVE_DRAIN_S``: a 1 s window cuts a
    1500-token generation off.  ``engine.drain`` returns False and
    ``close()`` fails the request with "engine shut down", which the
    server answers with a 503 carrying fewer than 1500 tokens; the
    process still exits 0 having drained."""
    code, doc, rc, out = _drain_run(1, 1500)
    assert code == 503, doc
    assert doc["error"] == "engine shut down"
    assert doc["n_generated"] < 1500, doc
    assert rc == 0, out
    assert "drained, exiting" in out
