"""Serving HTTP endpoint: POST /generate + the telemetry surface.

Port of ``dmlc_tpu/serving/server.py``: a ``ThreadingHTTPServer`` whose
handler threads submit into the engine's bounded admission queue and
park on the request until the continuous batcher finishes it.  Status
mapping is the reference's: 400 for a malformed body or bad content, 413
for a body too large or a request the KV pool could never hold, 429 +
Retry-After when no admission slot frees in time, 503 + Retry-After
while draining, 503 for an engine-side failure or a timed-out
generation.

Graceful drain (preemption notice): ``drain()`` — or SIGTERM once
``install_drain_handler()`` armed it — stops admitting, lets active
decodes finish within ``DMLC_SERVE_DRAIN_S``, then closes the listener;
in-flight generations are never dropped by the shutdown notice itself.

Endpoints:
  POST /generate   {"prompt": [int, ...], "max_tokens": int?,
                    "request_id": str?, "priority": int|class-name?,
                    "tenant": str?} → the request's result document
                   (``scheduler.Request.result``); ``request_id`` is the
                   idempotency key, and the ``X-DMLC-Trace`` header
                   carries the trace context (DMLC_TRACE_FLEET)
  GET  /metrics    Prometheus exposition: the registry (serving, feed,
                   checkpoint and the step ledger's ``step`` families)
                   plus the hand-rendered ``dmlc_slo_*``,
                   ``dmlc_compute_*`` (per site) and
                   ``dmlc_availability_*`` families
  GET  /healthz    ``{"status": "ok", **engine.stats()}``: queues, KV
                   pool, counters, launches, ledger + request summaries
  GET  /requests   request ledger document: summary percentiles
                   (TTFT = queue + prefill, TBT), live + recent
                   requests, decode-iteration ring
  GET  /slo        SLO burn-rate document; the GET forces an evaluation
  GET  /goodput    the availability ledger's report
  GET  /compute    the compute ledger (``telemetry.compute.report``):
                   sites, traces, recompiles, each site's counted cost,
                   card memory, decode phase shares, the step roofline
  GET  /trace      this replica's Chrome trace: engine threads, one row
                   per request, SLO violations as instant markers
  GET  /spans      incremental span export (``?since=N&limit=M`` →
                   spans + last_seq + anchor_epoch)

Every /generate response increments a per-status-code counter
(``dmlc_serving_http_<code>``); a POST to an unknown path counts as
``http_404``, a GET 404 is not counted.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .. import telemetry
from ..telemetry import tracecontext
from .engine import (AdmissionFull, EngineDraining, InferenceEngine,
                     RequestTooLarge)

__all__ = ["ServingHTTPServer", "MAX_BODY_BYTES"]

logger = logging.getLogger("dmlc_tpu_torch.serving")

MAX_BODY_BYTES = 1 << 20

#: the status codes /generate can answer with, each its own registered
#: counter family; anything else folds to http_other
_STATUS_COUNTERS = {200: "http_200", 400: "http_400", 404: "http_404",
                    413: "http_413", 429: "http_429", 503: "http_503"}


def _local_trace(engine: InferenceEngine) -> dict:
    """The replica's /trace document: the span ring (engine threads +
    per-request ledger rows) with SLO violations as instant markers on
    the same span timebase."""
    doc = telemetry.to_chrome_trace()
    anchor = telemetry.anchor_epoch()
    for m in engine.slo.trace_markers():
        doc["traceEvents"].append({
            "name": str(m["name"]), "cat": "slo", "ph": "i", "s": "g",
            "ts": round(max((float(m["t"]) - anchor) * 1e6, 0.0), 3),
            "pid": 0, "tid": 0,
        })
    return doc


def _spans_query(path: str) -> tuple:
    """``(since, limit)`` from ``/spans?since=N&limit=M`` (bad values
    read as 0)."""
    since = limit = 0
    _, _, qs = path.partition("?")
    for part in qs.split("&"):
        k, _, v = part.partition("=")
        try:
            if k == "since":
                since = int(v)
            elif k == "limit":
                limit = int(v)
        except ValueError:
            pass
    return since, limit


def _parse(body: bytes):
    doc = json.loads(body or b"{}")
    prompt = doc["prompt"]
    if (not isinstance(prompt, list)
            or not all(isinstance(t, int) for t in prompt)):
        raise ValueError("prompt must be a list of ints")
    max_tokens = doc.get("max_tokens")
    if max_tokens is not None:
        max_tokens = int(max_tokens)
    request_id = doc.get("request_id")
    if request_id is not None and not isinstance(request_id, str):
        raise ValueError("request_id must be a string")
    return prompt, max_tokens, request_id, doc.get("priority"), \
        doc.get("tenant")


class ServingHTTPServer:
    """HTTP front end over an :class:`InferenceEngine`, serving on a
    daemon thread from construction until :meth:`close`."""

    def __init__(self, engine: InferenceEngine, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 300.0):
        eng = engine
        wait_s = float(request_timeout_s)

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, ctype: str, body: bytes,
                      headers=None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, doc, headers=None) -> None:
                self._send(code, "application/json",
                           json.dumps(doc).encode(), headers)

            def _answer(self, code: int, doc, headers=None) -> None:
                """A /generate response, counted per status code."""
                telemetry.inc("serving",
                              _STATUS_COUNTERS.get(code, "http_other"))
                self._send_json(code, doc, headers)

            def do_GET(self):  # noqa: N802 - http.server API
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    text = (telemetry.to_prometheus_text()
                            + eng.slo.prometheus_text()
                            + telemetry.compute.prometheus_text()
                            + eng.availability.prometheus_text())
                    self._send(200,
                               "text/plain; version=0.0.4; charset=utf-8",
                               text.encode())
                elif path == "/healthz":
                    self._send_json(200, {"status": "ok", **eng.stats()})
                elif path == "/goodput":
                    self._send_json(200, eng.availability.report())
                elif path == "/compute":
                    self._send_json(200, telemetry.compute.report())
                elif path == "/requests":
                    self._send_json(200, eng.requests.report())
                elif path == "/slo":
                    eng.slo.evaluate()
                    self._send_json(200, eng.slo.report())
                elif path == "/trace":
                    self._send_json(200, _local_trace(eng))
                elif path == "/spans":
                    since, limit = _spans_query(self.path)
                    spans, last = telemetry.spans_since(
                        since, limit=limit or 4096)
                    self._send_json(200, {
                        "spans": spans, "last_seq": last,
                        "anchor_epoch": telemetry.anchor_epoch()})
                else:
                    self._send(404, "text/plain", b"not found\n")

            def do_POST(self):  # noqa: N802 - http.server API
                if self.path.split("?", 1)[0] != "/generate":
                    telemetry.inc("serving", "http_404")
                    self._send(404, "text/plain", b"not found\n")
                    return
                # the drain gate lives in eng.submit (EngineDraining →
                # 503): the dedupe lookup runs first, so a retry of
                # admitted work still resolves on a draining replica
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    if n > MAX_BODY_BYTES:
                        self._answer(413, {"error": "body too large"})
                        return
                    prompt, max_tokens, request_id, priority, tenant = \
                        _parse(self.rfile.read(n))
                except (KeyError, ValueError, TypeError) as e:
                    self._answer(400, {"error": f"bad request: {e}"})
                    return
                trace_id = None
                if tracecontext.enabled():
                    # the trace context rides X-DMLC-Trace; without one,
                    # derive it from the idempotency key so both ends agree
                    parsed = tracecontext.parse_header(
                        self.headers.get(tracecontext.TRACE_HEADER))
                    if parsed:
                        trace_id = parsed[0]
                    elif request_id:
                        trace_id = tracecontext.mint_trace_id(request_id)
                try:
                    req = eng.submit(prompt, max_new_tokens=max_tokens,
                                     request_id=request_id,
                                     priority=priority, tenant=tenant,
                                     trace_id=trace_id)
                except AdmissionFull as e:
                    self._answer(429, {"error": str(e)},
                                 {"Retry-After": "1"})
                    return
                except RequestTooLarge as e:
                    self._answer(413, {"error": str(e)})
                    return
                except EngineDraining as e:
                    self._answer(503, {"error": str(e)},
                                 {"Retry-After": "5"})
                    return
                except ValueError as e:
                    self._answer(400, {"error": str(e)})
                    return
                if not req.wait(wait_s):
                    self._answer(503, {"error": "generation timed out",
                                       "id": req.id})
                    return
                doc = req.result()
                if req.error:
                    if getattr(req, "rejected_busy", False):
                        # a duplicate parked on an original whose
                        # admission failed: the original's verdict
                        self._answer(429, doc, {"Retry-After": "1"})
                    else:
                        self._answer(503, doc)
                else:
                    self._answer(200, doc)

            def log_message(self, fmt, *args):
                logger.debug("serving http: " + fmt, *args)

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 128

        self._httpd = _Server((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self.engine = engine
        self._drain_done = threading.Event()
        # dmlc-check: unguarded(owner-thread close() latch; double shutdown is benign)
        self._closed = False
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="serving-http")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting (new /generate → 503 +
        Retry-After), finish active decodes within ``timeout_s``
        (``DMLC_SERVE_DRAIN_S``), then close the listener.  Returns
        whether the backlog drained cleanly."""
        active, waiting = self.engine.scheduler.counts()
        logger.info("serving drain: refusing new work, finishing %d "
                    "active / %d waiting", active, waiting)
        clean = self.engine.drain(timeout_s)
        self.close()
        return clean

    def install_drain_handler(self) -> None:
        """Arm SIGTERM as the drain trigger (main thread only: a signal
        module constraint).  ``wait_drained()`` then blocks until the
        drain completes (or ``DMLC_SERVE_DRAIN_S`` cuts it off)."""
        def run_drain():
            try:
                self.drain()
            finally:
                self._drain_done.set()

        def on_term(signum, frame):  # noqa: ARG001 - signal API
            # the handler must return fast; drain on a helper thread
            threading.Thread(target=run_drain, daemon=True,
                             name="serving-drain").start()

        signal.signal(signal.SIGTERM, on_term)

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until a signal-triggered drain has fully completed."""
        return self._drain_done.wait(timeout)

    def close(self) -> None:
        if self._closed:  # drain() and the caller's finally both close
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
