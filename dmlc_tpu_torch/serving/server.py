"""Serving HTTP endpoint: POST /generate and GET /healthz.

Port of the request path of ``dmlc_tpu/serving/server.py``: a
``ThreadingHTTPServer`` whose handler threads submit into the engine's
bounded admission queue and park on the request until the continuous
batcher finishes it.  Status mapping is the reference's: 400 for a
malformed body or bad content, 413 for a body too large or a request the
KV pool could never hold, 429 + Retry-After when no admission slot frees
in time, 503 for an engine-side failure or a timed-out generation.

Endpoints:
  POST /generate   {"prompt": [int, ...], "max_tokens": int?,
                    "priority": int|class-name?} → the request's result
                    document (``scheduler.Request.result``)
  GET  /healthz    ``{"status": "ok", **engine.stats()}``

The reference's telemetry endpoints (/metrics, /requests, /slo, /trace,
...) and the SIGTERM drain wait for a later slice.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .engine import AdmissionFull, InferenceEngine, RequestTooLarge

__all__ = ["ServingHTTPServer", "MAX_BODY_BYTES"]

logger = logging.getLogger("dmlc_tpu_torch.serving")

MAX_BODY_BYTES = 1 << 20


def _parse(body: bytes):
    doc = json.loads(body or b"{}")
    prompt = doc["prompt"]
    if (not isinstance(prompt, list)
            or not all(isinstance(t, int) for t in prompt)):
        raise ValueError("prompt must be a list of ints")
    max_tokens = doc.get("max_tokens")
    if max_tokens is not None:
        max_tokens = int(max_tokens)
    return prompt, max_tokens, doc.get("priority")


class ServingHTTPServer:
    """HTTP front end over an :class:`InferenceEngine`, serving on a
    daemon thread from construction until :meth:`close`."""

    def __init__(self, engine: InferenceEngine, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 300.0):
        eng = engine
        wait_s = float(request_timeout_s)

        class Handler(BaseHTTPRequestHandler):
            def _send_json(self, code: int, doc, headers=None) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.split("?", 1)[0] == "/healthz":
                    self._send_json(200, {"status": "ok", **eng.stats()})
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802 - http.server API
                if self.path.split("?", 1)[0] != "/generate":
                    self._send_json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    if n > MAX_BODY_BYTES:
                        self._send_json(413, {"error": "body too large"})
                        return
                    prompt, max_tokens, priority = _parse(self.rfile.read(n))
                except (KeyError, ValueError, TypeError) as e:
                    self._send_json(400, {"error": f"bad request: {e}"})
                    return
                try:
                    req = eng.submit(prompt, max_new_tokens=max_tokens,
                                     priority=priority)
                except AdmissionFull as e:
                    self._send_json(429, {"error": str(e)},
                                    {"Retry-After": "1"})
                    return
                except RequestTooLarge as e:
                    self._send_json(413, {"error": str(e)})
                    return
                except ValueError as e:
                    self._send_json(400, {"error": str(e)})
                    return
                if not req.wait(wait_s):
                    self._send_json(503, {"error": "generation timed out",
                                          "id": req.id})
                    return
                self._send_json(503 if req.error else 200, req.result())

            def log_message(self, fmt, *args):
                logger.debug("serving http: " + fmt, *args)

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 128

        self._httpd = _Server((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self.engine = engine
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="serving-http")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
