"""Per-step performance ledger: where did each step's wall time go? (the
port of ``dmlc_tpu/telemetry/steps.py``)

One bounded record per step, with the JAX package's keys:

  * **wall decomposition** — ``step_begin()`` stamps a span cursor;
    ``step_end()`` classifies every span the step enclosed *on the
    stepping thread* (``feed.wait`` → feed-wait, ``checkpoint.*`` →
    checkpoint stall, ``collective.*`` → host-collective; the remainder
    is compute + dispatch).  Producer-side feed spans (parse/stage/
    place) run on other threads concurrently and deliberately do NOT
    count against the step — overlap is the point of the feed
    pipeline.  Collective spans on OTHER threads during the step window
    are summed separately as ``collective_overlapped_s``.
  * **between steps** — ``between_s`` is the stepping thread's time
    from the previous ``step_end`` to this ``step_begin`` (None on the
    first step, after an abandoned one, or when the previous step ran
    on another thread); the spans in that interval are classified as
    the step's own, giving ``between_prefill_s`` /
    ``n_between_prefills`` (``*.prefill``, ``*`` being the span's own
    stage: ``serving.prefill``) and ``between_idle_s`` (``*.idle``).
    Consecutive steps' ``between_s + wall_s`` tile the stepping
    thread's time: a serving engine's prefills and idle sleeps land
    between its decode steps.
  * **inside a decode step** — ``build_s`` sums the step's
    ``*.decode.build`` spans and ``device_wait_s`` its
    ``*.decode.wait`` spans (the host's first wait on the card).
  * **goodput / MFU** — each record carries tokens, bytes fed (counter
    delta of ``feed.bytes_to_device`` unless given), and model-declared
    FLOPs (``declare_flops_per_token``; ``models.transformer`` and the
    serving engine declare theirs), yielding tokens/s and FLOPs/s ÷
    peak.  Peak comes from ``DMLC_PEAK_FLOPS`` or the card-name table
    :data:`DEVICE_PEAKS` (:func:`detect_peaks`).

**The asynchronous device.**  PyTorch returns from a step once the host
has enqueued it, so a wall read on the host without waiting for the
card measures the enqueue, not the step.  On a CUDA card
``step_begin`` records an event on the current stream and ``step_end``
records the end event there, stamps ``host_issue_s`` (begin until the
wait starts), then waits on THAT event only (``Event.synchronize``):
never ``torch.cuda.synchronize()``, which would also wait for the
feed's placer stream and bill the next batch's copy to this step.
``wall_s`` is begin until the event completed; ``wall_s -
host_issue_s`` is how long the host waited for the card.  The span
between the two events on the device's timeline includes the card's
idle gaps (``event_span_s``), so it is not the card's busy time: busy
time and idle share come from ``torch.profiler``.  Without a card there
is no event and ``host_issue_s == wall_s``.  A step that waits on the
card itself before ``step_end`` (the serving engine reads its tokens)
marks the wait with a ``*.decode.wait`` span: its ``host_issue_s`` is
begin until the first such span starts, card or not.  A failed event record
raises; the ledger never falls back to an unsynchronised wall.

Every record also lands in the local registry (``step`` stage: time /
feed_wait / collective / compute histograms, goodput + MFU gauges), so
step health is scrapeable from /metrics with no new plumbing.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

from ..base import DMLCError, get_env
from ..concurrency import make_lock
from . import core

__all__ = [
    "StepLedger",
    "StepRecord",
    "ledger",
    "step_begin",
    "step_end",
    "declare_flops_per_token",
    "declare_peak_flops",
    "declare_dtype",
    "detect_peak_flops",
    "detect_peaks",
    "DEVICE_PEAKS",
    "reset_steps",
]

#: per-card peaks keyed by ``torch.cuda.get_device_name()``: dense peak
#: FLOP/s per compute dtype plus HBM bandwidth (NVIDIA's H100 SXM data
#: sheet).  bf16 is the tensor cores' dense rate.  f32 is the card's
#: non-tensor FP32 peak: right only while TF32 stays off, as the port
#: keeps it (``chip_smoke.py`` sets ``allow_tf32 = False``); with TF32
#: on, f32 matmuls run on the tensor cores at up to 495 TFLOP/s.  A
#: name not in the table gets no peak (MFU unreported rather than
#: wrong); no row is guessed for other H100 parts.
DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12,
                              "hbm_gbps": 3350.0},
}


def _canon_dtype(dtype: Optional[str]) -> str:
    d = str(dtype or "bf16").lower()
    if d in ("float32", "f32", "fp32"):
        return "f32"
    # f16 runs at the bf16 tensor-core rate; anything unknown gets the
    # bf16 column (the table's headline figure) rather than no peak
    return "bf16"


def _card_name() -> Optional[str]:
    """The CUDA card's name, or None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name()


def detect_peak_flops() -> Optional[float]:
    """Peak FLOP/s for MFU accounting: ``DMLC_PEAK_FLOPS`` wins (an
    operator statement about the hardware), else the card-name table's
    bf16 column, else None (MFU unreported rather than wrong)."""
    try:
        env = get_env("DMLC_PEAK_FLOPS", None, float)
    except DMLCError:
        return None  # an operator typo mutes MFU, never crashes a step
    if env is not None:
        return env if env > 0 else None
    peaks = DEVICE_PEAKS.get(_card_name())
    return peaks["bf16"] if peaks else None


# one-time measured CPU peaks (a machine without a card has no data
# sheet row): a small f32 GEMM for FLOP/s, a large buffer copy for
# memory bandwidth.  Cached forever — the number is a calibration, not
# a per-step measurement.
_cpu_cal_lock = make_lock("steps._cpu_cal_lock")
_cpu_cal: Optional[Tuple[float, float]] = None


def _calibrate_cpu() -> Tuple[float, float]:
    global _cpu_cal
    with _cpu_cal_lock:
        if _cpu_cal is not None:
            return _cpu_cal
        import numpy as np

        n = 256
        a = np.ones((n, n), np.float32)
        b = np.ones((n, n), np.float32)
        flops = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            a @ b
            dt = max(time.perf_counter() - t0, 1e-9)
            flops = max(flops, 2.0 * n ** 3 / dt)
        buf = np.ones(32 << 20, np.uint8)
        t0 = time.perf_counter()
        buf.copy()
        dt = max(time.perf_counter() - t0, 1e-9)
        bw = 2.0 * buf.nbytes / dt  # the copy reads AND writes
        _cpu_cal = (flops, bw)
        return _cpu_cal


def detect_peaks(dtype: Optional[str] = "bf16"
                 ) -> Tuple[Optional[float], Optional[float]]:
    """(peak FLOP/s in ``dtype``, peak HBM bytes/s) for the local card.

    Resolution per component: the env override wins
    (``DMLC_PEAK_FLOPS`` / ``DMLC_PEAK_HBM_GBPS`` — operator
    statements about the hardware), else the card-name table in the
    requested compute dtype, else — with no card at all — a one-time
    measured CPU calibration, else None (a card the table does not
    name: unreported beats wrong)."""
    dt = _canon_dtype(dtype)
    flops = bw = None
    try:
        env = get_env("DMLC_PEAK_FLOPS", None, float)
        if env is not None and env > 0:
            flops = env
    except DMLCError:
        pass
    try:
        env = get_env("DMLC_PEAK_HBM_GBPS", None, float)
        if env is not None and env > 0:
            bw = env * 1e9
    except DMLCError:
        pass
    if flops is not None and bw is not None:
        return flops, bw
    name = _card_name()
    peaks = DEVICE_PEAKS.get(name)
    if peaks is not None:
        if flops is None:
            flops = peaks.get(dt)
        if bw is None:
            bw = peaks["hbm_gbps"] * 1e9
    elif name is None:
        cal_flops, cal_bw = _calibrate_cpu()
        if flops is None:
            flops = cal_flops
        if bw is None:
            bw = cal_bw
    return flops, bw


class StepRecord(dict):
    """One step's ledger entry — a plain dict (JSON = wire format) with
    attribute sugar for the hot fields."""

    @property
    def wall_s(self) -> float:
        return self["wall_s"]


def _classify(rec: Dict) -> Optional[str]:
    """Span → wall-time bucket, for spans on the stepping thread."""
    name = rec.get("name", "")
    cat = rec.get("cat", "")
    if name == "feed.wait" or cat == "feed":
        return "feed"
    if cat == "collective" or name.startswith("collective."):
        return "collective"
    if cat == "checkpoint" or name.startswith("checkpoint."):
        return "checkpoint"
    if name == "pipeline.run":
        return "pipeline"
    # a serving loop's phases, named under their own stage
    # (``serving.decode.wait``): not a compile span of a prefill site
    return _PHASES.get(name[len(cat):]) if name.startswith(cat) else None


_PHASES = {".decode.wait": "wait", ".decode.build": "build",
           ".prefill": "prefill", ".idle": "idle"}


class StepLedger:
    """Bounded per-step record ring with incremental shipping.

    Thread-safe, but steps themselves are single-threaded by contract:
    one ``step_begin``/``step_end`` pair at a time per ledger (the
    training loop's natural shape).  Capacity: ``DMLC_STEP_LEDGER_MAX``
    (default 1024) — a week-long run keeps the newest window;
    ``records_since`` ships increments long before eviction.
    """

    def __init__(self, capacity: Optional[int] = None,
                 peak_flops: Optional[float] = None):
        if capacity is None:
            capacity = get_env("DMLC_STEP_LEDGER_MAX", 1024)
        self._lock = make_lock("StepLedger._lock")
        self._records: deque = deque(maxlen=max(1, capacity))
        # dmlc-check: unguarded(advanced by the single stepping thread only)
        self._seq = 0
        self._flops_per_token: Optional[float] = None
        self._peak = peak_flops
        self._peak_resolved = peak_flops is not None
        self._peak_declared = peak_flops is not None
        self._dtype: Optional[str] = None
        self._peak_bw: Optional[float] = None
        self._peak_bw_resolved = False
        # dmlc-check: unguarded(one step_begin/step_end pair at a time — class docstring)
        self._open: Optional[Dict] = None
        # the previous step_end's (perf_counter, span cursor, tid)
        # dmlc-check: unguarded(one step_begin/step_end pair at a time — class docstring)
        self._last_end: Optional[Tuple[float, int, int]] = None

    # ---- declarations ---------------------------------------------------
    def declare_flops_per_token(self, flops: float) -> None:
        """Model-declared executed FLOPs per token for one step
        (models.train_flops_per_token); lets ``step_end(tokens=N)``
        derive step FLOPs without every call site doing the math."""
        with self._lock:
            self._flops_per_token = float(flops)

    def declare_peak_flops(self, flops: Optional[float]) -> None:
        with self._lock:
            self._peak = flops
            self._peak_resolved = True
            self._peak_declared = True

    def declare_dtype(self, dtype: Optional[str]) -> None:
        """Declare the compute dtype the model actually runs in so MFU
        normalizes against THAT peak (an f32 model judged against the
        bf16 table column reports a wrong utilization).  Re-arms lazy
        peak resolution; an explicit ``declare_peak_flops`` still
        wins."""
        with self._lock:
            self._dtype = _canon_dtype(dtype) if dtype else None
            if not self._peak_declared:
                self._peak_resolved = False
            self._peak_bw_resolved = False

    def peak_flops(self) -> Optional[float]:
        with self._lock:
            if not self._peak_resolved:
                if self._dtype is not None:
                    self._peak, bw = detect_peaks(self._dtype)
                    self._peak_bw = bw
                    self._peak_bw_resolved = True
                else:
                    self._peak = detect_peak_flops()
                self._peak_resolved = True
            return self._peak

    def peak_membw(self) -> Optional[float]:
        """Peak HBM bytes/s (None when unresolvable — membw_util and
        the bound verdict stay unreported rather than wrong)."""
        with self._lock:
            if not self._peak_bw_resolved:
                _, self._peak_bw = detect_peaks(self._dtype or "bf16")
                self._peak_bw_resolved = True
            return self._peak_bw

    # ---- the step protocol ---------------------------------------------
    def step_begin(self) -> None:
        """Open a step: stamp the clock, the span cursor, and the feed
        byte counter, record the begin event on the current CUDA stream
        where there is a card, and enter the ``step`` span (it records
        at ``step_end``).  A dangling open step (caller skipped
        ``step_end``, e.g. a raised train step) is abandoned, not
        merged."""
        if self._open is not None:
            # abandoned step: close its span so the per-thread stack
            # cannot grow without bound under a retry loop
            try:
                self._open["span"].__exit__(None, None, None)
            except Exception:  # noqa: BLE001 - best effort unwind
                pass
            self._last_end = None
        n = self._seq + 1
        span = core.span("step", stage="step", args={"n": n})
        event = None
        if torch.cuda.is_available():
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        self._open = {
            "t0": time.perf_counter(),
            "ts0": core.now_ts(),
            "cursor": core.span_seq(),
            "bytes0": core.counter_value("feed", "bytes_to_device"),
            "tid": threading.get_ident(),
            "span": span,
            "event": event,
            "prev": self._last_end,
        }
        span.__enter__()

    def step_end(self, tokens: Optional[float] = None,
                 flops: Optional[float] = None,
                 bytes_fed: Optional[float] = None,
                 bytes_accessed: Optional[float] = None,
                 tokens_per_step: Optional[float] = None,
                 spec_accept_rate: Optional[float] = None
                 ) -> Optional[StepRecord]:
        """Close the open step and append its record; returns it (None
        when no step was open).  ``tokens``/``flops``/``bytes_fed``
        default to declared-FLOPs × tokens and the feed-counter delta.
        ``bytes_accessed`` (bytes the step moves, from the cost pass of
        its site, ``telemetry.compute``; the train step and the serving
        engine pass it) adds the bandwidth half of the roofline:
        ``membw_util`` and the ``bound`` verdict.
        ``tokens_per_step`` (committed tokens per batch row — > 1 only
        when speculative decoding lands drafts) and
        ``spec_accept_rate`` (accepted / proposed drafts in [0, 1])
        make the decode fast path's multiplier a first-class ledger
        figure.

        On a card the step closes on an end event recorded on the
        current stream: ``host_issue_s`` is stamped before the wait on
        that event alone, ``wall_s`` after it."""
        opened = self._open
        if opened is None:
            return None
        self._open = None
        begin = opened["event"]
        event_span = None
        if begin is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            t_issue = time.perf_counter()
            end.synchronize()
            event_span = begin.elapsed_time(end) / 1e3
        opened["span"].__exit__(None, None, None)
        t1 = time.perf_counter()
        if begin is None:
            t_issue = t1
        tid = opened["tid"]
        ts0, ts1 = opened["ts0"], core.now_ts()
        self._last_end = (t1, core.span_seq(), tid)
        wall = max(t1 - opened["t0"], 1e-9)

        prev = opened["prev"]
        if prev is not None and prev[2] != tid:
            prev = None
        # one read covers the interval since the previous step_end and
        # the step itself; the begin cursor splits them
        new_spans, _ = core.spans_since(
            opened["cursor"] if prev is None else prev[1])
        between = {"prefill": 0.0, "idle": 0.0, "n_prefill": 0}
        buckets = {"feed": 0.0, "collective": 0.0, "pipeline": 0.0,
                   "checkpoint": 0.0, "wait": 0.0, "build": 0.0,
                   "prefill": 0.0, "idle": 0.0}
        first_wait = None
        ivals = []
        own_ivals = []
        for rec in new_spans:
            if rec.get("name") == "step":
                continue
            kind = _classify(rec)
            if kind is None:
                continue
            if rec["seq"] <= opened["cursor"]:
                if rec.get("tid") == tid and kind in ("prefill", "idle"):
                    between[kind] += rec.get("dur", 0.0) / 1e6
                    between["n_prefill"] += kind == "prefill"
                continue
            if rec.get("tid") == tid:
                buckets[kind] += rec.get("dur", 0.0) / 1e6
                if kind == "wait" and (first_wait is None
                                       or rec["ts"] < first_wait):
                    first_wait = rec["ts"]
                if kind != "collective":
                    continue
                dest = own_ivals
            elif kind == "collective":
                # a collective on ANOTHER thread (the overlap path's
                # background worker) is a candidate for collective time
                # that hid under this step's compute — clip its extent
                # to the step window; intervals are union-merged below
                # so nested spans (collective.bucket wrapping the
                # client's collective.allreduce) bill each instant once
                dest = ivals
            else:
                continue
            lo = max(rec.get("ts", 0.0), ts0)
            hi = min(rec.get("ts", 0.0) + rec.get("dur", 0.0), ts1)
            if hi > lo:
                dest.append((lo, hi))

        def union(spans):
            merged = []
            for lo, hi in sorted(spans):
                if merged and lo <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], hi)
                else:
                    merged.append([lo, hi])
            return merged

        # overlapped = worker-thread collective time the stepping thread
        # did NOT spend blocked in a collective of its own: an instant
        # where both threads sit in a collective (the bucketer's join,
        # a degenerate all-exposed overlap) is exposed, not hidden —
        # otherwise a total loss of overlap still reports 'overlapped'
        overlapped = 0.0
        exposed_u = union(own_ivals)
        for lo, hi in union(ivals):
            cur = lo
            for elo, ehi in exposed_u:
                if ehi <= cur or elo >= hi:
                    continue
                if elo > cur:
                    overlapped += elo - cur
                cur = max(cur, ehi)
                if cur >= hi:
                    break
            if cur < hi:
                overlapped += hi - cur
        feed_s = min(buckets["feed"], wall)
        # same-thread checkpoint.save time inside the step is EXPOSED
        # checkpoint stall — the ROADMAP item 4 before/after metric
        # (async checkpointing's win is driving this to ~0)
        ckpt_s = min(buckets["checkpoint"], wall - feed_s)
        coll_s = min(buckets["collective"], wall - feed_s - ckpt_s)
        compute_s = max(wall - feed_s - ckpt_s - coll_s, 0.0)
        overlapped_s = min(overlapped / 1e6, wall)
        if first_wait is not None:
            t_issue = opened["t0"] + (first_wait - ts0) / 1e6
        host_issue = min(max(t_issue - opened["t0"], 0.0), wall)
        between_s = None if prev is None else max(opened["t0"] - prev[0],
                                                   0.0)

        if bytes_fed is None:
            bytes_fed = (core.counter_value("feed", "bytes_to_device")
                         - opened["bytes0"])
        with self._lock:
            if flops is None and tokens is not None \
                    and self._flops_per_token is not None:
                flops = self._flops_per_token * tokens
        goodput = tokens / wall if tokens else None
        # peak resolution may calibrate the CPU once: only pay it when
        # a figure actually needs normalizing
        peak = self.peak_flops() if flops else None
        mfu = (flops / wall / peak) if (flops and peak) else None
        peak_bw = self.peak_membw() if bytes_accessed else None
        membw_util = (bytes_accessed / wall / peak_bw) \
            if (bytes_accessed and peak_bw) else None
        bound = None
        if flops and bytes_accessed and peak and peak_bw:
            # roofline verdict: arithmetic intensity vs machine balance
            bound = "memory" if (flops / bytes_accessed) \
                < (peak / peak_bw) else "compute"

        with self._lock:
            self._seq += 1
            rec = StepRecord(
                seq=self._seq,
                t_wall=time.time(),
                wall_s=wall,
                host_issue_s=host_issue,
                event_span_s=event_span,
                feed_wait_s=feed_s,
                checkpoint_stall_s=ckpt_s,
                collective_s=coll_s,
                collective_overlapped_s=overlapped_s,
                compute_s=compute_s,
                pipeline_span_s=min(buckets["pipeline"], wall),
                bytes_fed=float(bytes_fed),
                tokens=float(tokens) if tokens is not None else None,
                flops=float(flops) if flops is not None else None,
                bytes_accessed=float(bytes_accessed)
                if bytes_accessed is not None else None,
                goodput_tokens_per_s=goodput,
                mfu=mfu,
                membw_util=membw_util,
                bound=bound,
                tokens_per_step=(float(tokens_per_step)
                                 if tokens_per_step is not None else None),
                spec_accept_rate=(float(spec_accept_rate)
                                  if spec_accept_rate is not None
                                  else None),
                build_s=min(buckets["build"], wall),
                device_wait_s=min(buckets["wait"], wall),
                between_s=between_s,
                between_prefill_s=None if between_s is None
                else min(between["prefill"], between_s),
                between_idle_s=None if between_s is None
                else min(between["idle"], between_s),
                n_between_prefills=None if between_s is None
                else between["n_prefill"],
            )
            self._records.append(rec)
        self._publish(rec)
        return rec

    def _publish(self, rec: StepRecord) -> None:
        """Mirror the record into the local registry so step health is
        on /metrics with no new wire format."""
        core.inc("step", "count")
        core.observe_duration("step", "time", rec["wall_s"])
        core.observe_duration("step", "feed_wait", rec["feed_wait_s"])
        if rec.get("checkpoint_stall_s"):
            core.observe_duration("step", "checkpoint_stall",
                                  rec["checkpoint_stall_s"])
        core.observe_duration("step", "collective", rec["collective_s"])
        if rec.get("collective_overlapped_s"):
            core.observe_duration("step", "collective_overlapped",
                                  rec["collective_overlapped_s"])
        core.observe_duration("step", "compute", rec["compute_s"])
        if rec["goodput_tokens_per_s"] is not None:
            core.set_gauge("step", "goodput_tokens_per_s",
                           rec["goodput_tokens_per_s"])
        if rec["mfu"] is not None:
            core.set_gauge("step", "mfu_pct", 100.0 * rec["mfu"])
        if rec.get("membw_util") is not None:
            core.set_gauge("step", "membw_util_pct",
                           100.0 * rec["membw_util"])
        if rec.get("bound") is not None:
            core.set_gauge("step", "memory_bound",
                           1.0 if rec["bound"] == "memory" else 0.0)
        if rec.get("tokens_per_step") is not None:
            core.set_gauge("step", "tokens_per_step",
                           rec["tokens_per_step"])
        if rec.get("spec_accept_rate") is not None:
            core.set_gauge("step", "spec_accept_rate_pct",
                           100.0 * rec["spec_accept_rate"])
        # feed the job-level goodput ledger (lazy: a no-op unless the
        # process opted in by creating one; goodput never imports steps)
        try:
            from . import goodput as _goodput
            _goodput.on_step(tokens=rec.get("tokens") or 0.0,
                             step_s=rec["wall_s"])
        except Exception:  # noqa: BLE001 - accounting must not fail steps
            pass

    # ---- views ----------------------------------------------------------
    def records(self) -> List[StepRecord]:
        with self._lock:
            return list(self._records)

    def records_since(self, after_seq: int,
                      limit: Optional[int] = None) -> Tuple[list, int]:
        """(new_records, last_seq): same incremental-ship contract as
        ``core.spans_since`` — when ``limit`` truncates, ``last_seq`` is
        the last RETURNED record's seq so the remainder ships next beat;
        otherwise it is the high-water mark including ring-evicted
        records."""
        with self._lock:
            out = [r for r in self._records if r["seq"] > after_seq]
            last = self._seq
        if limit is not None and len(out) > limit:
            out = out[:limit]
            last = out[-1]["seq"]
        return out, last

    def summary(self) -> Dict:
        """Ledger-derived run summary (the JAX package's bench keys):
        step-time percentiles over the retained window plus
        whole-window goodput (Σtokens / Σwall) and mean MFU."""
        recs = self.records()
        if not recs:
            return {}
        walls = sorted(r["wall_s"] for r in recs)

        def pct(q: float) -> float:
            return walls[min(int(q / 100.0 * len(walls)), len(walls) - 1)]

        wall_total = max(sum(walls), 1e-9)
        out = {
            "steps": len(recs),
            "step_time_p50": pct(50),
            "step_time_p99": pct(99),
            "feed_wait_fraction": (sum(r["feed_wait_s"] for r in recs)
                                   / wall_total),
            "checkpoint_stall_fraction": (
                sum(r.get("checkpoint_stall_s", 0.0) for r in recs)
                / wall_total),
            "collective_exposed_fraction": (
                sum(r["collective_s"] for r in recs) / wall_total),
            "collective_overlapped_fraction": (
                sum(r.get("collective_overlapped_s", 0.0) for r in recs)
                / wall_total),
        }
        toks = [r for r in recs if r["tokens"]]
        if toks:
            out["goodput_tokens_per_s"] = (
                sum(r["tokens"] for r in toks)
                / max(sum(r["wall_s"] for r in toks), 1e-9))
        # window MFU / bandwidth utilization: work-weighted aggregates,
        # Σwork / (Σwall × peak) — the standard whole-window definition.
        # A plain mean of per-step ratios over-weights ramp/drain steps
        # that pay fixed dispatch overhead while carrying little work.
        fl = [r for r in recs
              if r.get("flops") and r.get("mfu") is not None]
        peak = self.peak_flops()
        if fl and peak:
            out["mfu"] = (sum(r["flops"] for r in fl)
                          / max(sum(r["wall_s"] for r in fl), 1e-9)
                          / peak)
        else:
            mfus = [r["mfu"] for r in recs if r["mfu"] is not None]
            out["mfu"] = sum(mfus) / len(mfus) if mfus else None
        by = [r for r in recs if r.get("bytes_accessed")
              and r.get("membw_util") is not None]
        peak_bw = self.peak_membw()
        if by and peak_bw:
            out["membw_util"] = (
                sum(r["bytes_accessed"] for r in by)
                / max(sum(r["wall_s"] for r in by), 1e-9) / peak_bw)
        else:
            mbs = [r["membw_util"] for r in recs
                   if r.get("membw_util") is not None]
            out["membw_util"] = sum(mbs) / len(mbs) if mbs else None
        out["bound"] = next((r["bound"] for r in reversed(recs)
                             if r.get("bound") is not None), None)
        tps = [r["tokens_per_step"] for r in recs
               if r.get("tokens_per_step") is not None]
        out["tokens_per_step"] = sum(tps) / len(tps) if tps else None
        acc = [r["spec_accept_rate"] for r in recs
               if r.get("spec_accept_rate") is not None]
        out["spec_accept_rate"] = sum(acc) / len(acc) if acc else None
        return out

    def roofline_summary(self) -> Dict:
        """The roofline view /compute reports: resolved peaks + the
        window's utilization figures and latest bound verdict."""
        recs = self.records()
        with self._lock:
            dtype = self._dtype
        latest = next((r for r in reversed(recs)
                       if r.get("flops") and r.get("bytes_accessed")),
                      None)
        mfus = [r["mfu"] for r in recs if r.get("mfu") is not None]
        mbs = [r["membw_util"] for r in recs
               if r.get("membw_util") is not None]
        return {
            "dtype": dtype,
            "peak_flops": self.peak_flops(),
            "peak_membw_bytes_per_s": self.peak_membw(),
            "mfu": sum(mfus) / len(mfus) if mfus else None,
            "membw_util": sum(mbs) / len(mbs) if mbs else None,
            "intensity": (latest["flops"] / latest["bytes_accessed"])
            if latest else None,
            "bound": next((r["bound"] for r in reversed(recs)
                           if r.get("bound") is not None), None),
        }

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._seq = 0
            self._flops_per_token = None
            self._open = None
            self._last_end = None
            # drop RESOLVED-but-not-DECLARED peaks: a reset means a new
            # measurement context (tests repin DMLC_PEAK_* between
            # runs), and detection is cheap to redo — only an explicit
            # declare_peak_flops outlives a reset
            if not self._peak_declared:
                self._peak_resolved = False
            self._peak_bw_resolved = False


# ---------------------------------------------------------------------------
# process-global default ledger (the one the train step and engine use)
# ---------------------------------------------------------------------------

_default = StepLedger()


def ledger() -> StepLedger:
    return _default


def step_begin() -> None:
    _default.step_begin()


def step_end(tokens: Optional[float] = None, flops: Optional[float] = None,
             bytes_fed: Optional[float] = None,
             bytes_accessed: Optional[float] = None,
             tokens_per_step: Optional[float] = None,
             spec_accept_rate: Optional[float] = None
             ) -> Optional[StepRecord]:
    return _default.step_end(tokens=tokens, flops=flops,
                             bytes_fed=bytes_fed,
                             bytes_accessed=bytes_accessed,
                             tokens_per_step=tokens_per_step,
                             spec_accept_rate=spec_accept_rate)


def declare_flops_per_token(flops: float) -> None:
    _default.declare_flops_per_token(flops)


def declare_peak_flops(flops: Optional[float]) -> None:
    _default.declare_peak_flops(flops)


def declare_dtype(dtype: Optional[str]) -> None:
    _default.declare_dtype(dtype)


def reset_steps() -> None:
    """Clear the default ledger (test isolation)."""
    _default.reset()
