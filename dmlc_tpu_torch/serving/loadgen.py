"""Load generator: N concurrent request streams against a serving
endpoint (the port of ``dmlc_tpu/serving/loadgen.py``; the wire format
is the JAX package's, so either package's generator drives either
package's server).

Each stream is a closed-loop synthetic user: it POSTs a random-length
prompt to ``/generate``, waits for the completion document, and
immediately issues the next request.  429s — and 503s that carry a
``Retry-After`` header (drain / briefly headless endpoints; terminal
per-request 503s carry none and fail with their error body) — back
off for the server's ``Retry-After`` value and retry (counted, not
failed); requests that needed at least one retry before succeeding
are reported separately (``n_requests_retried_ok``).  Every logical
request carries a fresh ``request_id`` idempotency key, so a retry can
never double-generate.  With ``DMLC_TRACE_FLEET=1`` every attempt of a
logical request also carries the SAME ``X-DMLC-Trace`` trace id
(minted from that request_id; fresh span id per attempt), and the
summary reports the client-inclusive end-to-end latency
(``e2e_latency_p50_s``/``p99``) next to the server-side numbers.

The summary aggregates the *server-reported* per-request timings —
TTFT is measured where it is defined (submit → first token inside the
engine), not smeared by client-side HTTP overhead.  ``emit_bench``
joins it with the engine's own views, the decode step ledger
(``/healthz``) and the request ledger (``/requests``: queue wait, TBT
— the inter-token gap — percentiles, preemption rate, KV occupancy),
and the compute ledger (``/compute``: recompiles, memory peak, the
roofline verdict) into one JSON file.

**Multi-tenant mode**: pass ``tenants=[{"tenant": "paid", "streams":
4, "priority": "interactive"}, ...]`` and each stream carries its
tenant key and priority class on every request; the summary then adds
a per-tenant breakdown.

Run it from its own process against a server (``_cli``)::

    python -m dmlc_tpu_torch.serving.loadgen --url http://host:port \
        --streams 8 --prompt-len 17 511 --max-tokens 32 --vocab 32768
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Dict, List, Optional
from ..concurrency import make_lock
from ..telemetry import tracecontext
# one shared nearest-rank percentile for client AND server summaries,
# so the two can never drift onto different conventions
from ..telemetry.requests import percentile  # noqa: F401 - re-export

__all__ = ["LoadGenerator", "percentile"]


class LoadGenerator:
    """Drive ``n_streams`` concurrent users against a serving endpoint."""

    def __init__(self, url: str, *, n_streams: int = 8,
                 requests_per_stream: int = 4,
                 prompt_len: tuple = (8, 24), max_tokens: int = 16,
                 vocab: int = 128, seed: int = 0,
                 retry_429_s: float = 0.2, max_retries: int = 50,
                 tenants: Optional[List[Dict]] = None):
        self.url = url.rstrip("/")
        self.requests_per_stream = int(requests_per_stream)
        self.prompt_len = (int(prompt_len[0]), int(prompt_len[1]))
        self.max_tokens = int(max_tokens)
        self.vocab = int(vocab)
        self.seed = int(seed)
        self.retry_429_s = float(retry_429_s)
        self.max_retries = int(max_retries)
        # multi-tenant mode: each spec fans out into `streams` synthetic
        # users all carrying that tenant key (and optional priority);
        # without specs every stream is the anonymous default tenant
        self._specs: List[tuple] = []
        if tenants:
            for spec in tenants:
                tname = str(spec["tenant"])
                for _ in range(int(spec.get("streams", 1))):
                    self._specs.append((tname, spec.get("priority")))
        else:
            self._specs = [(None, None)] * int(n_streams)
        self.n_streams = len(self._specs)
        self.results: List[Dict] = []
        self.failures: List[Dict] = []
        self.rejections = 0
        self.backoffs_503 = 0
        self.retried_ok = 0
        self.rejections_by_tenant: Dict[str, int] = {}
        self._lock = make_lock("LoadGenerator._lock")

    # ---- one synthetic user --------------------------------------------
    def _post(self, doc: Dict,
              headers: Optional[Dict[str, str]] = None) -> Dict:
        body = json.dumps(doc).encode()
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        req = urllib.request.Request(
            self.url + "/generate", data=body, headers=hdrs)
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    def _backoff_s(self, e: "urllib.error.HTTPError") -> float:
        """Backoff before retrying a 429/503: the server's Retry-After
        header when it sent one (it computed that number from its own
        queue depth — it KNOWS), the fixed fallback otherwise, clamped
        so a confused server cannot park a stream for minutes."""
        ra = e.headers.get("Retry-After")
        if ra is not None:
            try:
                return min(max(float(ra), 0.0), 30.0)
            except ValueError:
                pass  # non-numeric Retry-After: fall back
        return self.retry_429_s

    def _stream(self, sid: int) -> None:
        rng = random.Random(self.seed * 1000 + sid)
        tenant, priority = self._specs[sid]
        for _ in range(self.requests_per_stream):
            n = rng.randint(*self.prompt_len)
            doc = {"prompt": [rng.randrange(self.vocab) for _ in range(n)],
                   "max_tokens": self.max_tokens,
                   # one idempotency key per LOGICAL request: retries
                   # reuse it, so a replica (or the router) that already
                   # accepted the work returns it instead of repeating it
                   "request_id": uuid.uuid4().hex}
            if tenant is not None:
                doc["tenant"] = tenant
            if priority is not None:
                doc["priority"] = priority
            # ONE trace identity per logical request, minted here at the
            # true origin and sent on every attempt: a client retry is
            # the same user journey, so its backoff + re-dispatch must
            # land inside the same fleet trace rather than minting a
            # fresh id per HTTP attempt.  The span id is fresh per
            # attempt (each hop is its own parent).
            trace_id = (tracecontext.mint_trace_id(doc["request_id"])
                        if tracecontext.enabled() else None)
            t0 = time.monotonic()
            out = None
            retried = False
            for _attempt in range(self.max_retries):
                headers = None
                if trace_id is not None:
                    headers = {tracecontext.TRACE_HEADER:
                               tracecontext.format_header(
                                   trace_id, tracecontext.new_span_id())}
                try:
                    out = self._post(doc, headers)
                    break
                except urllib.error.HTTPError as e:
                    retryable_503 = (
                        e.code == 503
                        and e.headers.get("Retry-After") is not None)
                    if e.code == 429 or retryable_503:
                        # backpressure (admission full) or a draining /
                        # briefly headless endpoint: honor Retry-After
                        # and try again — this is the server steering
                        # load, not a failure.  A 503 WITHOUT
                        # Retry-After is a terminal per-request verdict
                        # (engine failure, generation timeout): record
                        # its error body, do not amplify it with fresh
                        # generation attempts
                        retried = True
                        delay = self._backoff_s(e)
                        with self._lock:
                            if e.code == 429:
                                self.rejections += 1
                                if tenant is not None:
                                    self.rejections_by_tenant[tenant] = \
                                        self.rejections_by_tenant.get(
                                            tenant, 0) + 1
                            else:
                                self.backoffs_503 += 1
                        time.sleep(delay)
                        continue
                    out = {"error": f"HTTP {e.code}: "
                           f"{e.read()[:200].decode(errors='replace')}"}
                    break
                except (urllib.error.URLError, OSError) as e:
                    # a dead server / timed-out connection is a FAILED
                    # request, not a silently vanished stream
                    out = {"error": f"connection failed: {e!r}"}
                    break
            if out is None:
                out = {"error": "retry budget exhausted (429/503)"}
            out["stream"] = sid
            if tenant is not None:
                out["client_tenant"] = tenant
            if trace_id is not None:
                out.setdefault("trace_id", trace_id)
            # the TRUE end-to-end latency of the logical request: first
            # attempt through final outcome, backoffs and retries
            # included — what the user waited, not what one HTTP
            # round-trip took
            out["client_latency_s"] = time.monotonic() - t0
            with self._lock:
                if out.get("error"):
                    self.failures.append(out)
                else:
                    self.results.append(out)
                    if retried:
                        self.retried_ok += 1

    # ---- the run --------------------------------------------------------
    def run(self) -> Dict:
        t0 = time.monotonic()
        threads = [threading.Thread(target=self._stream, args=(i,),
                                    name=f"loadgen-{i}", daemon=True)
                   for i in range(self.n_streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        return self.summary(wall)

    def summary(self, wall_s: float) -> Dict:
        # one consistent snapshot: summary() may race live streams (a
        # caller polling mid-run), so every counter and both result
        # lists are copied under the same lock hold the streams use
        with self._lock:
            results = list(self.results)
            failures = list(self.failures)
            retried_ok = self.retried_ok
            rejections = self.rejections
            backoffs_503 = self.backoffs_503
            rej_by_tenant = dict(self.rejections_by_tenant)
        ttfts = [r["ttft_s"] for r in results
                 if r.get("ttft_s") is not None]
        tps = [r["decode_tokens_per_s"] for r in results
               if r.get("decode_tokens_per_s")]
        gen = sum(r.get("n_generated", 0) for r in results)
        # client-vs-server corroboration: the client clock covers HTTP
        # transport + handler queueing AROUND the server-side request
        # lifetime, so per request (client latency - server latency)
        # must be positive and small — a negative delta means the two
        # timing paths disagree about what a request is, and a large
        # one means the HTTP edge (not the engine) is the bottleneck
        deltas = [r["client_latency_s"] - r["latency_s"]
                  for r in results
                  if r.get("latency_s") is not None
                  and r.get("client_latency_s") is not None]
        e2e = [r["client_latency_s"] for r in results
               if r.get("client_latency_s") is not None]
        out = {
            "n_streams": self.n_streams,
            "n_requests_ok": len(results),
            "n_requests_failed": len(failures),
            # retried-then-succeeded ≠ failed: a request that rode out
            # backpressure/drain on retries still completed
            "n_requests_retried_ok": retried_ok,
            "n_rejections_429": rejections,
            "n_backoffs_503": backoffs_503,
            "wall_s": wall_s,
            "total_generated_tokens": gen,
            "aggregate_tokens_per_s": gen / max(wall_s, 1e-9),
            "p50_ttft_s": percentile(ttfts, 50),
            "p99_ttft_s": percentile(ttfts, 99),
            "tokens_per_s_per_user": (sum(tps) / len(tps)) if tps else None,
            "p50_latency_s": percentile(
                [r["latency_s"] for r in results
                 if r.get("latency_s") is not None], 50),
            # client-inclusive end-to-end percentiles over LOGICAL
            # requests (retries + backoff folded in): the number the
            # user actually experienced, reported alongside the
            # server-side latency rather than instead of it
            "e2e_latency_p50_s": percentile(e2e, 50),
            "e2e_latency_p99_s": percentile(e2e, 99),
            "preemptions": sum(r.get("preemptions", 0)
                               for r in results),
            "client_server_delta_p50_s": percentile(deltas, 50),
            "client_server_delta_p99_s": percentile(deltas, 99),
        }
        # per-tenant fairness breakdown (multi-tenant mode only): who
        # absorbed the 429s and whose latency held is the whole point
        # of the tenant governor, so it ships in the same summary (and
        # therefore in emit_bench's file) rather than a side channel
        names = sorted({t for t, _ in self._specs if t is not None}
                       | set(rej_by_tenant))
        if names:
            per: Dict[str, Dict] = {}
            for name in names:
                rs = [r for r in results
                      if r.get("client_tenant") == name]
                t_ttfts = [r["ttft_s"] for r in rs
                           if r.get("ttft_s") is not None]
                t_tps = [r["decode_tokens_per_s"] for r in rs
                         if r.get("decode_tokens_per_s")]
                per[name] = {
                    "n_requests_ok": len(rs),
                    "n_requests_failed": sum(
                        1 for f in failures
                        if f.get("client_tenant") == name),
                    "n_rejections_429": rej_by_tenant.get(name, 0),
                    "p50_ttft_s": percentile(t_ttfts, 50),
                    "p99_ttft_s": percentile(t_ttfts, 99),
                    "tokens_per_s_per_user": ((sum(t_tps) / len(t_tps))
                                              if t_tps else None),
                }
            out["tenants"] = per
        return out

    # ---- artifact -------------------------------------------------------
    def fetch_json(self, path: str, timeout: float = 30.0) -> Dict:
        with urllib.request.urlopen(self.url + path,
                                    timeout=timeout) as resp:
            return json.loads(resp.read())

    def _fetch_optional(self, path: str) -> Dict:
        """A newer-endpoint fetch that degrades to {} against an older
        replica (same policy as dmlc-top: the artifact loses the join
        keys, never the whole measured run)."""
        try:
            return self.fetch_json(path)
        except (urllib.error.HTTPError, urllib.error.URLError, OSError,
                ValueError):
            return {}

    def healthz(self) -> Dict:
        return self.fetch_json("/healthz")

    def emit_bench(self, path: str, summary: Dict,
                   extra: Optional[Dict] = None) -> Dict:
        """Join the client summary with the server-side views — the
        decode step ledger (/healthz) and the request ledger
        (/requests: queue-wait/TBT percentiles, preemption rate, KV
        occupancy), the active SLO violations (/slo) and the compute
        ledger (/compute) — and write them as one JSON line to
        ``path``; returns the document."""
        ledger = self.healthz().get("ledger", {}) or {}
        doc = dict(summary)
        doc["decode_mfu"] = ledger.get("mfu")
        doc["decode_step_p50_s"] = ledger.get("step_time_p50")
        doc["decode_step_p99_s"] = ledger.get("step_time_p99")
        doc["decode_goodput_tokens_per_s"] = ledger.get(
            "goodput_tokens_per_s")
        doc["decode_steps"] = ledger.get("steps")
        # committed tokens per batch row per step (> 1 only with
        # speculative decoding) and the draft acceptance rate behind it
        doc["decode_tokens_per_step"] = ledger.get("tokens_per_step")
        doc["spec_accept_rate"] = ledger.get("spec_accept_rate")
        reqs = self._fetch_optional("/requests").get("summary", {}) or {}
        doc["queue_wait_p50_s"] = reqs.get("queue_wait_p50_s")
        doc["queue_wait_p99_s"] = reqs.get("queue_wait_p99_s")
        doc["prefill_p99_s"] = reqs.get("prefill_p99_s")
        doc["server_ttft_p99_s"] = reqs.get("ttft_p99_s")
        doc["tbt_p50_s"] = reqs.get("tbt_p50_s")
        doc["tbt_p99_s"] = reqs.get("tbt_p99_s")
        doc["preemption_rate"] = reqs.get("preemption_rate")
        doc["kv_occupancy"] = reqs.get("kv_occupancy")
        doc["kv_waste_tokens"] = reqs.get("kv_waste_tokens")
        slo = self._fetch_optional("/slo")
        doc["slo_active"] = slo.get("active", [])
        # the compute ledger's headline keys: the decode roofline,
        # recompiles, the memory peak
        comp = self._fetch_optional("/compute")
        roof = comp.get("roofline", {}) or {}
        doc["decode_membw_util"] = (ledger.get("membw_util")
                                    if ledger.get("membw_util") is not None
                                    else roof.get("membw_util"))
        doc["decode_bound"] = (ledger.get("bound")
                               if ledger.get("bound") is not None
                               else roof.get("bound"))
        doc["recompiles"] = comp.get("recompiles_total")
        doc["hbm_peak_bytes"] = (comp.get("hbm", {}) or {}).get(
            "peak_bytes")
        if extra:
            doc.update(extra)
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        return doc


def _cli(argv: Optional[List[str]] = None) -> int:
    """``python -m dmlc_tpu_torch.serving.loadgen --url http://host:port ...``

    Drives the closed-loop streams from a DEDICATED process and prints
    the run summary as one JSON line.  Measurement methodology: an
    in-process client contends with the engine for the GIL and the
    cores, so every client thread's scheduling quantum lands in the
    server's decode-step tail — the measured phase of a bench must
    drive load from outside the server process (this entrypoint), the
    way a real load test drives from outside the server box."""
    import argparse

    p = argparse.ArgumentParser(prog="dmlc_tpu_torch.serving.loadgen")
    p.add_argument("--url", required=True)
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--requests-per-stream", type=int, default=4)
    p.add_argument("--prompt-len", type=int, nargs=2, default=(8, 24),
                   metavar=("MIN", "MAX"))
    p.add_argument("--max-tokens", type=int, default=16)
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    gen = LoadGenerator(
        args.url, n_streams=args.streams,
        requests_per_stream=args.requests_per_stream,
        prompt_len=tuple(args.prompt_len), max_tokens=args.max_tokens,
        vocab=args.vocab, seed=args.seed)
    summary = gen.run()
    summary["failures"] = gen.failures[:5]
    print(json.dumps(summary))
    return 0 if not gen.failures else 1


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    raise SystemExit(_cli())
