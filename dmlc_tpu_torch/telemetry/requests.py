"""Per-request serving ledger: where did each request's latency go? (the
port of ``dmlc_tpu/telemetry/requests.py``)

The step ledger (telemetry.steps) accounts for *decode iterations*; a
serving operator lives on the orthogonal axis — *requests*.  "TTFT p99
regressed" is unactionable until it decomposes into *queue wait* (an
admission/capacity problem) vs *prefill* (a compute problem), and
"tokens are slow" is unactionable without time-between-tokens (TBT)
and the preemption episodes that stretch it.  The
:class:`RequestLedger` records each request's full lifecycle —

    submit → admit → queue wait → prefill → first token
           → decode slices (per-token TBT) → preempt/resume episodes
           → finish / fail-with-reason

— with the defining identity that server-side TTFT is **exactly**
``queue_s + prefill_s`` (all three are derived from the same three
stamps: submit, prefill-begin, first-token), so the decomposition can
never drift from the headline number it explains.

Three surfaces, mirroring the StepLedger contract:

  * **bounded ring + incremental export** — finished requests get
    monotone seq ids; ``records_since(after_seq, limit)`` has the same
    torn-ship/resume semantics as ``StepLedger.records_since``.
  * **per-request trace rows** — each request's queue/prefill/decode
    slices are recorded as completed spans (``core.record_span``) on a
    synthetic per-request ``tid``, so the server's ``/trace`` renders
    one labeled row per request next to the engine's own threads.
  * **decode-iteration ring** — per-iteration batch composition
    (active/waiting/preempted), admission queue depth, and KV
    occupancy / partial-block waste — the load signal a router or
    autoscaler reads from ``/requests``.

Registry families driven here: ``dmlc_serving_queue_wait_secs`` and
``dmlc_serving_tbt_secs`` histograms, ``dmlc_serving_resumes`` and the
per-reason ``dmlc_serving_failed_<reason>`` counters.  SLO evaluation
(telemetry.slo) subscribes through the ``slo`` parameter: TTFT, TBT,
and request outcomes stream into its burn-rate windows as they happen.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..base import get_env
from . import core
from ..concurrency import make_lock

__all__ = ["RequestLedger", "FAIL_REASONS", "REQUEST_ROW_TID_BASE",
           "percentile"]

#: synthetic Chrome-trace tid base for per-request rows: far above any
#: OS thread ident, so request rows never collide with real threads
REQUEST_ROW_TID_BASE = 1 << 48

#: the closed set of failure-reason slugs (each is a registered
#: ``dmlc_serving_failed_<reason>`` counter family; free-form reasons
#: would mint unbounded metric names).  NB a client-side /generate
#: wait timeout is NOT a failure reason: the engine keeps decoding and
#: the request finishes normally — the client's 503 shows up in the
#: http_503 counter instead.
FAIL_REASONS = ("shutdown", "crash", "prefill", "nonfinite",
                "kv_exhausted", "other")

_ITER_RING = 512      # decode-iteration records kept for /requests
_TBT_RING = 4096      # recent TBT gaps kept for p50/p99


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile — THE percentile convention shared by
    the request ledger and the load generator (one definition, so the
    client and server percentiles the smoke compares can never drift
    onto different conventions; same convention as
    ``StepLedger.summary``)."""
    if not values:
        return None
    vs = sorted(values)
    return vs[min(int(q / 100.0 * len(vs)), len(vs) - 1)]


class _Live:
    """In-flight request state (perf_counter stamps; wall only for
    display).  Finalized into a plain-dict record at finish."""

    __slots__ = ("id", "submit_t", "submit_wall", "n_prompt", "max_new",
                 "state", "queue_s", "prefill_t0", "prefill_s", "ttft_s",
                 "first_token_t", "last_token_t", "decode_t0",
                 "n_generated", "decode_s", "tbt_sum", "tbt_max",
                 "n_tbt", "preemptions", "resumes", "trace_id")

    def __init__(self, req_id: int, n_prompt: int, max_new: Optional[int],
                 t: float, trace_id: Optional[str] = None):
        self.id = req_id
        self.trace_id = trace_id
        self.submit_t = t
        self.submit_wall = time.time()
        self.n_prompt = int(n_prompt)
        self.max_new = max_new
        self.state = "queued"
        self.queue_s: Optional[float] = None
        self.prefill_t0: Optional[float] = None
        self.prefill_s: Optional[float] = None
        self.ttft_s: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self.decode_t0: Optional[float] = None
        self.n_generated = 0
        self.decode_s = 0.0
        self.tbt_sum = 0.0
        self.tbt_max = 0.0
        self.n_tbt = 0
        self.preemptions = 0
        self.resumes = 0

    def view(self, now: Optional[float] = None) -> Dict:
        """JSON-able snapshot (live rows of /requests)."""
        out = {
            "id": self.id,
            "state": self.state,
            "submit_wall": self.submit_wall,
            "n_prompt": self.n_prompt,
            "queue_s": self.queue_s,
            "prefill_s": self.prefill_s,
            "ttft_s": self.ttft_s,
            "n_generated": self.n_generated,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
        }
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if now is not None:
            out["age_s"] = now - self.submit_t
        return out


class RequestLedger:
    """Bounded per-request lifecycle ledger for one serving engine.

    Thread-safety: the engine's single step thread drives the
    lifecycle transitions, but ``submit`` (HTTP handler threads) and
    the read views run concurrently — everything is lock-protected.
    Every ``on_*`` hook takes an optional explicit ``t``
    (``time.perf_counter`` timebase) so tests drive exact clocks.
    Unknown request ids are ignored (a race with shutdown sweeps must
    never raise out of the engine loop).
    """

    def __init__(self, capacity: Optional[int] = None, slo=None,
                 trace_rows: Optional[bool] = None):
        if capacity is None:
            capacity = get_env("DMLC_SERVE_REQUEST_LEDGER_MAX", 2048)
        if trace_rows is None:
            trace_rows = get_env("DMLC_SERVE_TRACE_REQUESTS", True)
        self.trace_rows = bool(trace_rows)
        self._slo = slo
        self._lock = make_lock("RequestLedger._lock")
        self._live: Dict[int, _Live] = {}
        self._done: deque = deque(maxlen=max(1, capacity))
        self._seq = 0
        self._iters: deque = deque(maxlen=_ITER_RING)
        self._iter_seq = 0
        self._tbt: deque = deque(maxlen=_TBT_RING)
        self._fail_reasons: Dict[str, int] = {}
        self._n_done = 0
        self._n_failed = 0
        self._preempt_total = 0

    # ---- lifecycle hooks (engine-driven) -------------------------------
    def on_submit(self, req_id: int, n_prompt: int,
                  max_new_tokens: Optional[int] = None,
                  t: Optional[float] = None,
                  trace_id: Optional[str] = None) -> None:
        """An admitted request enters the ledger; ``t`` should be the
        stamp taken at the top of the engine's submit path so queue
        wait includes the admission-slot wait.  ``trace_id`` (the
        ``X-DMLC-Trace`` context, DMLC_TRACE_FLEET) stamps every trace
        row and the finish record; a traced request additionally
        leaves an instant ``serving.admitted`` marker at once, so its
        presence on this replica is pullable before the first phase
        completes."""
        t = time.perf_counter() if t is None else t
        with self._lock:
            st = _Live(req_id, n_prompt, max_new_tokens, t,
                       trace_id=trace_id)
            self._live[req_id] = st
        if trace_id is not None:
            self._row(st, "serving.admitted", t, t,
                      args={"n_prompt": int(n_prompt)})

    def on_prefill_begin(self, req_id: int, t: Optional[float] = None,
                         resume: bool = False) -> None:
        t = time.perf_counter() if t is None else t
        with self._lock:
            st = self._live.get(req_id)
            if st is None:
                return
            st.prefill_t0 = t
            st.state = "prefill"
            if not resume and st.queue_s is None:
                st.queue_s = t - st.submit_t
        if not resume and st.queue_s is not None:
            core.observe_duration("serving", "queue_wait", st.queue_s)
            self._row(st, "serving.queue", st.submit_t, t)

    def on_first_token(self, req_id: int,
                       t: Optional[float] = None) -> None:
        """The TTFT moment: by construction ``ttft_s`` ==
        ``queue_s + prefill_s`` exactly (prefill is measured
        prefill-begin → first token, *including* the sample)."""
        t = time.perf_counter() if t is None else t
        with self._lock:
            st = self._live.get(req_id)
            if st is None or st.prefill_t0 is None:
                return
            st.prefill_s = t - st.prefill_t0
            st.ttft_s = t - st.submit_t
            st.first_token_t = st.last_token_t = st.decode_t0 = t
            st.n_generated = 1
            st.state = "active"
        self._row(st, "serving.prefill", st.prefill_t0, t,
                  args={"tokens": st.n_prompt})
        if self._slo is not None and st.ttft_s is not None:
            self._slo.observe_ttft(st.ttft_s, trace_id=st.trace_id)

    def on_prefill_end(self, req_id: int,
                       t: Optional[float] = None) -> None:
        """A preemption-resume prefill finished (no token is sampled —
        the resume's next token comes from the decode step)."""
        t = time.perf_counter() if t is None else t
        with self._lock:
            st = self._live.get(req_id)
            if st is None or st.prefill_t0 is None:
                return
            st.resumes += 1
            st.decode_t0 = t
            st.state = "active"
        core.inc("serving", "resumes")
        self._row(st, "serving.prefill", st.prefill_t0, t,
                  args={"resume": 1, "tokens":
                        st.n_prompt + max(st.n_generated - 1, 0)})

    def on_token(self, req_id: int, t: Optional[float] = None,
                 n: int = 1) -> None:
        """``n`` decode tokens landed at one instant (a speculative
        commit delivers its whole accepted prefix in one burst; plain
        decode passes n=1).  The gap since the previous burst is
        recorded ONCE as TBT — that gap is the stall a streaming user
        actually sees between deliveries, and across a preemption
        episode it spans evict + requeue + re-prefill, which is exactly
        why it is deliberately NOT excluded.  Zero-length intra-burst
        gaps are not observed: they would drag the TBT percentiles
        toward 0 without any user-visible latency behind them."""
        t = time.perf_counter() if t is None else t
        gap = None
        with self._lock:
            st = self._live.get(req_id)
            if st is None:
                return
            if st.last_token_t is not None:
                gap = t - st.last_token_t
                st.tbt_sum += gap
                st.tbt_max = max(st.tbt_max, gap)
                st.n_tbt += 1
                self._tbt.append(gap)
            st.last_token_t = t
            if st.decode_t0 is None:
                st.decode_t0 = t
            st.n_generated += n
            st.state = "active"
        if gap is not None:
            core.observe_duration("serving", "tbt", gap)
            if self._slo is not None:
                self._slo.observe_tbt(gap, trace_id=st.trace_id)

    def on_preempt(self, req_id: int, t: Optional[float] = None) -> None:
        t = time.perf_counter() if t is None else t
        with self._lock:
            st = self._live.get(req_id)
            if st is None:
                return
            st.preemptions += 1
            self._preempt_total += 1
            t0, st.decode_t0 = st.decode_t0, None
            if t0 is not None:
                st.decode_s += t - t0
            st.state = "preempted"
        if t0 is not None:
            self._row(st, "serving.decode", t0, t,
                      args={"tokens": st.n_generated, "preempted": 1})

    def on_finish(self, req_id: int, error: Optional[str] = None,
                  reason: Optional[str] = None,
                  t: Optional[float] = None) -> Optional[Dict]:
        """Terminal transition: move the live entry into the ring.
        ``reason`` must be one of :data:`FAIL_REASONS` (anything else
        is folded to ``"other"``); it drives the per-reason failure
        counters so admission pressure vs crash-guard failures are
        tellable apart without log scraping."""
        t = time.perf_counter() if t is None else t
        with self._lock:
            st = self._live.pop(req_id, None)
            if st is None:
                return None
            t0 = st.decode_t0
            if t0 is not None:
                st.decode_s += t - t0
            failed = error is not None
            if failed:
                slug = reason if reason in FAIL_REASONS else "other"
                self._fail_reasons[slug] = \
                    self._fail_reasons.get(slug, 0) + 1
                self._n_failed += 1
            else:
                slug = None
                self._n_done += 1
            self._seq += 1
            rec = {
                "seq": self._seq,
                "id": st.id,
                "state": "failed" if failed else "done",
                "reason": slug,
                "error": error,
                "submit_wall": st.submit_wall,
                "n_prompt": st.n_prompt,
                "n_generated": st.n_generated,
                "queue_s": st.queue_s,
                "prefill_s": st.prefill_s,
                "ttft_s": st.ttft_s,
                "decode_s": st.decode_s,
                "latency_s": t - st.submit_t,
                "tbt_mean_s": (st.tbt_sum / st.n_tbt) if st.n_tbt else None,
                "tbt_max_s": st.tbt_max if st.n_tbt else None,
                "preemptions": st.preemptions,
                "resumes": st.resumes,
            }
            if st.trace_id is not None:
                rec["trace_id"] = st.trace_id
            self._done.append(rec)
        if t0 is not None:
            self._row(st, "serving.decode", t0, t,
                      args={"tokens": st.n_generated})
        if failed:
            core.inc("serving", "failed_" + slug)
        if self._slo is not None:
            self._slo.observe_outcome(not failed, trace_id=st.trace_id)
        return rec

    def on_iteration(self, active: int, waiting: int, preempted: int = 0,
                     tokens: int = 0,
                     kv_stats: Optional[Dict] = None) -> None:
        """One decode iteration's batch composition + cache pressure —
        the load signal published on /requests."""
        rec = {
            "t_wall": time.time(),
            "active": int(active),
            "waiting": int(waiting),
            "preempted": int(preempted),
            "tokens": int(tokens),
        }
        if kv_stats:
            for src, dst in (("blocks_in_use", "kv_blocks_in_use"),
                             ("n_blocks", "kv_blocks_total"),
                             ("occupancy", "kv_occupancy"),
                             ("waste_tokens", "kv_waste_tokens"),
                             ("cached_tokens", "kv_cached_tokens")):
                if src in kv_stats:
                    rec[dst] = kv_stats[src]
        with self._lock:
            self._iter_seq += 1
            rec["seq"] = self._iter_seq
            self._iters.append(rec)

    # ---- trace rows -----------------------------------------------------
    def _row(self, st: _Live, name: str, t0: float, t1: float,
             args: Optional[Dict] = None) -> None:
        if not self.trace_rows:
            return
        a = {"req": st.id}
        if st.trace_id is not None:
            a["trace_id"] = st.trace_id
        if args:
            a.update(args)
        core.record_span(name, stage="serving", t0=t0, t1=t1,
                         tid=REQUEST_ROW_TID_BASE + st.id,
                         thread=f"req {st.id}", args=a)

    # ---- views ----------------------------------------------------------
    def live(self) -> List[Dict]:
        now = time.perf_counter()
        with self._lock:
            return [st.view(now) for st in self._live.values()]

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._done)

    def records_since(self, after_seq: int,
                      limit: Optional[int] = None) -> Tuple[list, int]:
        """Same incremental-ship contract as StepLedger.records_since."""
        with self._lock:
            out = [r for r in self._done if r["seq"] > after_seq]
            last = self._seq
        if limit is not None and len(out) > limit:
            out = out[:limit]
            last = out[-1]["seq"]
        return out, last

    def iterations(self, n: int = 32) -> List[Dict]:
        with self._lock:
            tail = list(self._iters)
        return tail[-n:]

    def summary(self) -> Dict:
        """Aggregate request-level health over the retained window —
        the keys the load generator's artifact joins."""
        with self._lock:
            recs = list(self._done)
            tbt = list(self._tbt)
            iters = list(self._iters)
            n_live = len(self._live)
            waiting = sum(1 for s in self._live.values()
                          if s.state in ("queued", "preempted"))
            out = {
                "requests_done": self._n_done,
                "requests_failed": self._n_failed,
                "fail_reasons": dict(self._fail_reasons),
                "preemptions": self._preempt_total,
            }
        ok = [r for r in recs if r["state"] == "done"]

        def pcts(key: str, field: str, scale_recs: List[Dict]) -> None:
            vals = [r[field] for r in scale_recs
                    if r.get(field) is not None]
            out[key + "_p50_s"] = percentile(vals, 50)
            out[key + "_p99_s"] = percentile(vals, 99)

        pcts("queue_wait", "queue_s", ok)
        pcts("prefill", "prefill_s", ok)
        pcts("ttft", "ttft_s", ok)
        out["tbt_p50_s"] = percentile(tbt, 50)
        out["tbt_p99_s"] = percentile(tbt, 99)
        finished = len(recs)
        out["preemption_rate"] = (
            sum(r["preemptions"] for r in recs) / finished
            if finished else 0.0)
        out["resumes"] = sum(r["resumes"] for r in recs)
        out["tokens_generated"] = sum(r["n_generated"] for r in recs)
        out["live_requests"] = n_live
        out["live_waiting"] = waiting
        if iters:
            last = iters[-1]
            out["kv_occupancy"] = last.get("kv_occupancy")
            out["kv_waste_tokens"] = last.get("kv_waste_tokens")
            out["decode_queue_depth"] = last.get("waiting")
            out["iterations"] = last["seq"]
        return out

    def report(self, recent: int = 64, iters: int = 32) -> Dict:
        """The ``/requests`` JSON document."""
        with self._lock:
            tail = list(self._done)[-recent:]
        return {
            "summary": self.summary(),
            "live": self.live(),
            "recent": tail,
            "iterations": self.iterations(iters),
        }

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self._done.clear()
            self._iters.clear()
            self._tbt.clear()
            self._fail_reasons.clear()
            self._seq = 0
            self._iter_seq = 0
            self._n_done = 0
            self._n_failed = 0
            self._preempt_total = 0
