"""Cluster telemetry: worker heartbeats → tracker aggregation → /metrics
(the port of ``dmlc_tpu/telemetry/heartbeat.py``: same beat document,
same Prometheus text and /healthz keys).

Workers push periodic snapshots over the existing rendezvous connection
protocol (a ``metrics`` command session, the same short-session shape as
the tracker's ``print`` relay); the ``RabitTracker`` keeps the latest
snapshot per rank and serves a merged cluster view over a lightweight
HTTP endpoint:

    GET /metrics   Prometheus text: per-rank samples (``rank`` label)
                   plus cluster-merged families (``rank="all"``)
    GET /healthz   JSON: rank count, per-rank heartbeat age

and, where the tracker binds their sources, the merged /trace, the
watchdog's /anomalies and /compute, /goodput and /incidents
(:class:`TelemetryHTTPServer`).

Straggler flagging: for the configured histogram keys (feed stalls,
step time by default), a rank whose p90 exceeds a configurable multiple
of the cluster median is reported through ``logging.warning`` — once
per (rank, key) until the rank stops being a straggler.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ..base import get_env
from . import core, exporters
from .core import Histogram
from ..concurrency import make_lock

__all__ = [
    "DEFAULT_STRAGGLER_KEYS",
    "TelemetryAggregator",
    "TelemetryHTTPServer",
    "HeartbeatSender",
]

logger = logging.getLogger("dmlc_tpu_torch.tracker")

# (stage, histogram name) pairs checked for stragglers: a rank slow to
# FEED shows an inflated producer-side pipeline; a rank slow to STEP
# shows inflated consumer stall on its peers and step time on itself
DEFAULT_STRAGGLER_KEYS: Tuple[Tuple[str, str], ...] = (
    ("feed", "producer_stall_secs"),
    ("feed", "consumer_stall_secs"),
    ("input_split", "chunk_latency_secs"),
    ("train", "step_secs"),
)


def _sanitize(snap: Dict) -> Dict:
    """Shape-validate an incoming heartbeat: keep only well-formed
    counters/gauges (stage → name → number) and histogram summaries
    (stage → name → dict).  Everything else is dropped, so a skewed or
    hostile worker can never park a snapshot that later crashes
    merged()/check_stragglers()/prometheus_text() on other threads."""
    out: Dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for kind in ("counters", "gauges"):
        src = snap.get(kind)
        if not isinstance(src, dict):
            continue
        for stage, vals in src.items():
            if not isinstance(vals, dict):
                continue
            clean = {}
            for name, v in vals.items():
                try:
                    clean[str(name)] = float(v)
                except (TypeError, ValueError):
                    continue
            if clean:
                out[kind][str(stage)] = clean
    src = snap.get("histograms")
    if isinstance(src, dict):
        for stage, hs in src.items():
            if not isinstance(hs, dict):
                continue
            clean = {}
            for name, summ in hs.items():
                if not isinstance(summ, dict):
                    continue
                try:
                    # canonicalize through a Histogram round-trip: the
                    # stored summary is then ALWAYS a complete, numeric
                    # summary() dict, whatever the wire carried
                    clean[str(name)] = Histogram.from_dict(summ).summary()
                except (TypeError, ValueError, KeyError):
                    continue
            if clean:
                out["histograms"][str(stage)] = clean
    return out


def _build_info_line() -> str:
    """``dmlc_build_info`` gauge: constant 1 with version/platform
    labels — the standard Prometheus idiom for joining build metadata
    onto any alert expression."""
    import platform

    from .. import __version__

    plat = f"{platform.system()}-{platform.machine()}".lower()
    py = platform.python_version()
    esc = exporters.escape_label_value
    return (exporters.help_type_lines(
                "dmlc_build_info", "gauge",
                "constant 1 with build metadata labels")
            + f'dmlc_build_info{{version="{esc(__version__)}",'
              f'platform="{esc(plat)}",python="{esc(py)}"}} 1\n')


def _median(vals: List[float]) -> float:
    """Lower median: with an even rank count the smaller middle element
    is the baseline, so an inflated rank cannot drag the comparison
    point up and mask itself (the n=2 degenerate case: averaging the
    two would put the straggler at ~2x its own median forever)."""
    s = sorted(vals)
    return s[(len(s) - 1) // 2]


class TelemetryAggregator:
    """Per-rank snapshot store with merge + straggler detection.

    ``local_snapshot`` (a zero-arg callable returning a snapshot dict)
    adds the AGGREGATING process's own registry to the /metrics surface
    under ``rank="<local_label>"`` — the tracker uses it to publish
    launcher/tracker-side resilience counters (task restarts, declared
    worker deaths) that no worker heartbeat carries.  ``extra_health``
    (zero-arg callable returning a dict) is merged into /healthz;
    ``extra_text`` (zero-arg callable returning exposition text) is
    appended to /metrics — the anomaly watchdog publishes its
    ``dmlc_anomaly_active`` gauges through it."""

    def __init__(self, straggler_factor: float = 3.0,
                 straggler_keys=DEFAULT_STRAGGLER_KEYS,
                 log=logger, local_snapshot=None,
                 local_label: str = "tracker"):
        self.straggler_factor = float(straggler_factor)
        self.straggler_keys = tuple(straggler_keys)
        self._log = log
        self._local_snapshot = local_snapshot
        self._local_label = local_label
        self.extra_health = None
        self.extra_text = None
        self._lock = make_lock("TelemetryAggregator._lock")
        self._ranks: Dict[int, Dict] = {}      # rank -> snapshot dict
        # rank -> last heartbeat, on time.monotonic(): heartbeat AGE is a
        # duration, and measuring it on the wall clock let any backward
        # wall step (NTP correction, manual set) inflate every age at
        # once and mass-declare ranks dead through the failure detector
        self._seen: Dict[int, float] = {}
        self._flagged: set = set()             # (rank, stage, name) warned

    # ---- ingest ---------------------------------------------------------
    def update(self, rank: int, snap: Dict) -> None:
        if rank < 0:
            return  # heartbeat from an unassigned worker: nothing to key on
        with self._lock:
            self._ranks[rank] = _sanitize(snap)
            self._seen[rank] = time.monotonic()
        for w in self.check_stragglers():
            self._log.warning("%s", w)

    def update_json(self, rank: int, payload: str) -> None:
        """Parse-and-ingest; malformed heartbeats are dropped with a
        warning rather than poisoning the tracker accept loop — a worker
        on a skewed version (or garbage on the open tracker port) must
        never be able to kill the rendezvous thread."""
        try:
            snap = json.loads(payload)
            if not isinstance(snap, dict):
                raise TypeError(f"non-dict telemetry ({type(snap).__name__})")
            self.update(rank, snap)
        except Exception as e:  # noqa: BLE001 - see docstring
            self._log.warning("rank %d sent malformed telemetry: %r", rank, e)

    def touch(self, rank: int) -> None:
        """Reset ``rank``'s heartbeat clock without a snapshot — the
        tracker calls this when a replacement worker finishes brokering,
        so the failure detector does not re-flag the rank in the gap
        before its first heartbeat lands."""
        if rank < 0:
            return
        with self._lock:
            self._seen[rank] = time.monotonic()

    def remap_ranks(self, mapping: Dict[int, int]) -> None:
        """Atomically renumber the per-rank snapshot/heartbeat stores
        into a new generation's rank space (elastic world resize):
        entries for ranks absent from ``mapping`` are dropped.  Without
        this, a survivor's heartbeat age would be split between its old
        and new rank ids and the failure detector would declare phantom
        deaths after every resize."""
        with self._lock:
            self._ranks = {mapping[r]: s for r, s in self._ranks.items()
                           if r in mapping}
            self._seen = {mapping[r]: t for r, t in self._seen.items()
                          if r in mapping}
            self._flagged = {(mapping[r], s, n)
                             for (r, s, n) in self._flagged if r in mapping}

    # ---- views ----------------------------------------------------------
    def ranks(self) -> Dict[int, float]:
        """rank → heartbeat age in seconds (monotonic-clock based, so a
        wall-clock step can never inflate or deflate the ages)."""
        now = time.monotonic()
        with self._lock:
            return {r: now - t for r, t in self._seen.items()}

    def merged(self) -> Dict:
        """Cluster-wide snapshot: counters/gauges summed, histogram
        buckets merged (percentiles recomputed over the merged counts)."""
        with self._lock:
            snaps = dict(self._ranks)
        counters: Dict[str, Dict[str, float]] = {}
        gauges: Dict[str, Dict[str, float]] = {}
        hists: Dict[str, Dict[str, Histogram]] = {}
        for snap in snaps.values():
            for stage, vals in snap.get("counters", {}).items():
                dst = counters.setdefault(stage, {})
                for name, v in vals.items():
                    dst[name] = dst.get(name, 0.0) + float(v)
            for stage, vals in snap.get("gauges", {}).items():
                dst = gauges.setdefault(stage, {})
                for name, v in vals.items():
                    dst[name] = dst.get(name, 0.0) + float(v)
            for stage, hs in snap.get("histograms", {}).items():
                dsth = hists.setdefault(stage, {})
                for name, summ in hs.items():
                    try:
                        h = Histogram.from_dict(summ)
                    except (TypeError, ValueError, KeyError):
                        continue  # malformed summary: skip, don't crash
                    if name in dsth:
                        dsth[name].merge(h)
                    else:
                        dsth[name] = h
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {
                s: {n: h.summary() for n, h in hs.items()}
                for s, hs in hists.items()
            },
        }

    def prometheus_text(self) -> str:
        """Per-rank samples (rank label) + merged families (rank="all").

        Every snapshot is collected into ONE family table before
        rendering, so each family appears as a single group with one
        ``# HELP``/``# TYPE`` header — per-rank text concatenation
        would split families across groups, which strict exposition
        parsers reject."""
        with self._lock:
            snaps = dict(self._ranks)
        fams: Dict = {}
        for r, snap in sorted(snaps.items()):
            exporters.collect_prometheus(snap, labels={"rank": str(r)},
                                         out=fams)
        exporters.collect_prometheus(self.merged(),
                                     labels={"rank": "all"}, out=fams)
        if self._local_snapshot is not None:
            try:
                exporters.collect_prometheus(
                    _sanitize(self._local_snapshot()),
                    labels={"rank": self._local_label}, out=fams)
            except Exception as e:  # noqa: BLE001 - scrape must not 500
                self._log.warning("local telemetry snapshot failed: %r", e)
        parts = [exporters.render_prometheus(fams)]
        n = len(snaps)
        parts.append(exporters.help_type_lines(
            "dmlc_tracker_ranks_reporting", "gauge",
            "ranks with a telemetry snapshot on the tracker"))
        parts.append(f"dmlc_tracker_ranks_reporting {n}\n")
        parts.append(_build_info_line())
        # per-rank staleness as a first-class gauge: scrapers alert on
        # max(dmlc_heartbeat_age_seconds) without parsing /healthz JSON
        ages = self.ranks()
        if ages:
            parts.append(exporters.help_type_lines(
                "dmlc_heartbeat_age_seconds", "gauge",
                "seconds since each rank's last heartbeat"))
            for r, age in sorted(ages.items()):
                parts.append(
                    f'dmlc_heartbeat_age_seconds{{rank="{r}"}} {age:.3f}\n')
        if self.extra_text is not None:
            try:
                parts.append(self.extra_text())
            except Exception as e:  # noqa: BLE001 - scrape must not 500
                self._log.warning("extra metrics text failed: %r", e)
        return "".join(parts)

    def healthz(self) -> Dict:
        ages = self.ranks()
        with self._lock:  # _flagged mutates on the tracker accept thread
            flagged = sorted({r for (r, _s, _n) in self._flagged})
        out = {
            "status": "ok",
            "ranks_reporting": len(ages),
            "ranks": {str(r): round(age, 3) for r, age in sorted(ages.items())},
            "stragglers": flagged,
        }
        if self.extra_health is not None:
            try:
                out.update(self.extra_health())
            except Exception as e:  # noqa: BLE001 - health must not 500
                self._log.warning("extra_health failed: %r", e)
        return out

    # ---- straggler detection -------------------------------------------
    def check_stragglers(self) -> List[str]:
        """Compare each rank's p90 against the cluster median for the
        configured keys; returns (and records) fresh warnings."""
        with self._lock:
            snaps = dict(self._ranks)
        warnings: List[str] = []
        if len(snaps) < 2:
            return warnings
        for stage, name in self.straggler_keys:
            p90s = {}
            for rank, snap in snaps.items():
                summ = snap.get("histograms", {}).get(stage, {}).get(name)
                try:
                    if summ and summ.get("p90") is not None:
                        p90s[rank] = float(summ["p90"])
                except (TypeError, ValueError):
                    continue  # malformed summary: rank just has no data
            if len(p90s) < 2:
                continue
            med = _median(list(p90s.values()))
            if med <= 0:
                continue
            for rank, p90 in p90s.items():
                key = (rank, stage, name)
                with self._lock:  # healthz() reads _flagged concurrently
                    if p90 > self.straggler_factor * med:
                        fresh = key not in self._flagged
                        self._flagged.add(key)
                    else:
                        fresh = False
                        self._flagged.discard(key)
                if fresh:
                    warnings.append(
                        f"straggler: rank {rank} {stage}.{name} "
                        f"p90={p90:.4f}s vs cluster median {med:.4f}s "
                        f"(>{self.straggler_factor:g}x)")
        return warnings


class TelemetryHTTPServer:
    """Lightweight /metrics + /healthz (+ /trace, /anomalies, /compute,
    /goodput, /incidents, POST /resize) surface.

    ``trace_source`` (zero-arg callable returning a Chrome-trace dict,
    e.g. ``FlightRecorder.to_chrome_trace``) enables ``GET /trace``:
    the cluster-merged, clock-corrected timeline, downloadable straight
    into Perfetto / chrome://tracing.  ``anomaly_source`` (zero-arg
    callable returning a JSON-able dict, e.g. ``Watchdog.report``)
    enables ``GET /anomalies``: the live per-rank step-health and
    anomaly-flag document that ``dmlc top`` polls.  ``resize_handler``
    (a callable taking the parsed JSON body, returning a JSON-able
    dict) enables ``POST /resize`` — the elastic tracker's operator
    scale-up endpoint; a ``ValueError`` from the handler maps to 400, a
    ``RuntimeError`` (e.g. tracker not elastic) to 409.
    ``compute_source`` (zero-arg callable returning a JSON-able dict,
    e.g. ``Watchdog.compute_report``) enables ``GET /compute``: the
    cluster view of the per-rank compile/roofline/HBM ledgers shipped
    with heartbeats.  ``goodput_source`` (zero-arg callable, e.g.
    ``GoodputAggregator.report``) enables ``GET /goodput``: the cluster
    wall-clock decomposition; ``incidents_source`` (zero-arg callable,
    e.g. ``IncidentReporter.report``) enables ``GET /incidents``: the
    forensics join of badput episodes with decisions/events/anomalies.
    A source that raises is logged and answered with a 503; the server
    keeps serving."""

    def __init__(self, aggregator: TelemetryAggregator,
                 host: str = "127.0.0.1", port: int = 0,
                 trace_source=None, anomaly_source=None,
                 resize_handler=None, compute_source=None,
                 goodput_source=None, incidents_source=None):
        agg = aggregator
        # path -> (source, what a failed render is called in the 503)
        sources = {path: (src, what) for path, src, what in (
            ("/trace", trace_source, "trace"),
            ("/anomalies", anomaly_source, "anomaly"),
            ("/compute", compute_source, "compute"),
            ("/goodput", goodput_source, "goodput"),
            ("/incidents", incidents_source, "incidents"))
            if src is not None}

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - http.server API
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(200,
                               "text/plain; version=0.0.4; charset=utf-8",
                               agg.prometheus_text().encode())
                elif path == "/healthz":
                    self._send(200, "application/json",
                               json.dumps(agg.healthz()).encode())
                elif path in sources:
                    source, what = sources[path]
                    try:
                        body = json.dumps(source()).encode()
                    except Exception as e:  # noqa: BLE001 - no 500s
                        logger.warning("%s render failed: %r", path, e)
                        self._send(503, "text/plain",
                                   f"{what} render failed\n".encode())
                        return
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found\n")

            def do_POST(self):  # noqa: N802 - http.server API
                path = self.path.split("?", 1)[0]
                if path != "/resize" or resize_handler is None:
                    self._send(404, "text/plain", b"not found\n")
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    if n > (1 << 16):
                        raise ValueError("body too large")
                    doc = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(doc, dict):
                        raise ValueError("body must be a JSON object")
                    out = resize_handler(doc)
                except (ValueError, TypeError, json.JSONDecodeError) as e:
                    self._send(400, "application/json",
                               json.dumps({"error": str(e)}).encode())
                    return
                except RuntimeError as e:  # tracker not elastic
                    self._send(409, "application/json",
                               json.dumps({"error": str(e)}).encode())
                    return
                self._send(200, "application/json",
                           json.dumps(out).encode())

            def log_message(self, fmt, *args):  # quiet: scrapes are periodic
                logger.debug("telemetry http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="telemetry-http")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


class HeartbeatSender:
    """Worker-side periodic telemetry push over the tracker protocol.

    Each beat opens a short ``metrics`` session (same shape as the
    ``print`` relay) carrying the full local snapshot with histogram
    buckets, so the tracker can merge distributions across ranks.
    ``close()`` sends one final beat so short jobs still report.

    With ``ship_trace`` (default on; ``DMLC_TELEMETRY_SHIP_TRACE=0``
    disables) each beat also carries a ``trace`` sub-document: the
    spans AND step-ledger records recorded since the last successful
    ship (bounded per beat), this process's span-clock wall anchor, and
    a fresh NTP-style clock sample against the tracker
    (``TrackerClient.clock_ping``) — the worker half of the cluster
    flight recorder (telemetry.flight) and of the anomaly watchdog
    (telemetry.anomaly).
    Armed heartbeats also install the postmortem crash hooks when
    ``DMLC_POSTMORTEM_DIR`` is set: the heartbeat is the one object
    every instrumented worker constructs.

    Beat payloads are capped at ``DMLC_TELEMETRY_MAX_BEAT_BYTES``
    (default 256 KB): an over-budget beat drops its OLDEST trace spans
    (then oldest step records) until it fits, counting
    ``telemetry.beats_truncated`` — a span storm can never bloat a
    heartbeat past the tracker's frame limits.
    """

    MAX_SPANS_PER_BEAT = 2048
    MAX_STEPS_PER_BEAT = 512

    def __init__(self, client, interval: float = 5.0,
                 auto_start: bool = True, ship_trace: Optional[bool] = None):
        self._client = client
        self.interval = float(interval)
        if ship_trace is None:
            ship_trace = get_env("DMLC_TELEMETRY_SHIP_TRACE", True)
        self.ship_trace = bool(ship_trace)
        self.max_beat_bytes = get_env(
            "DMLC_TELEMETRY_MAX_BEAT_BYTES", 256 << 10)
        # the three ship cursors are beat-thread-confined: send_once
        # runs on the beat thread, and close()'s final flush only runs
        # after joining it
        # dmlc-check: unguarded(beat-thread-confined; close() flushes only after join)
        self._last_seq = 0
        # dmlc-check: unguarded(beat-thread-confined; close() flushes only after join)
        self._last_step_seq = 0
        # dmlc-check: unguarded(beat-thread-confined; close() flushes only after join)
        self._clock: Optional[Tuple[float, float]] = None  # (offset, rtt)
        self._stop = threading.Event()
        # dmlc-check: unguarded(start/close control-thread lifecycle)
        self._thread: Optional[threading.Thread] = None
        from . import postmortem

        postmortem.install()  # no-op unless DMLC_POSTMORTEM_DIR is set
        postmortem.set_rank(getattr(client, "rank", None))
        if auto_start:
            self.start()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="telemetry-heartbeat")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.send_once()
            except OSError as e:  # tracker gone mid-shutdown: stop quietly
                logger.debug("heartbeat send failed: %s", e)
                return

    def send_once(self) -> None:
        doc = exporters.export_json(include_buckets=True)
        # self-heal remediation status (resilience.selfheal): a few
        # scalar fields riding every beat once a guard has acted, so
        # the tracker watchdog can show WHAT the worker did about a
        # flagged step (the /anomalies `remediation` field)
        from ..resilience import selfheal

        sh = selfheal.status()
        if sh:
            doc["selfheal"] = sh
        # serving SLO status (telemetry.slo): a serving replica's
        # active violations + burn rates ride every beat, so the
        # tracker watchdog surfaces them on /anomalies next to the
        # step-health flags (training processes ship nothing here)
        from . import slo as slo_mod

        slo_doc = slo_mod.status()
        if slo_doc:
            doc["slo"] = slo_doc
        # compute ledger status (telemetry.compute): trace/recompile
        # totals, the recompile-storm verdict and the headline memory
        # gauges — the tracker watchdog's recompile_storm signal
        from . import compute as compute_mod

        compute_doc = compute_mod.status()
        if compute_doc:
            doc["compute"] = compute_doc
        # goodput ledger status (telemetry.goodput): the wall-clock
        # decomposition, cumulative per-bucket seconds re-shipped fully
        # every beat (self-correcting across drops/remaps), the recent
        # badput intervals, and the windowed effective-vs-in-step rates
        from . import goodput as goodput_mod

        goodput_doc = goodput_mod.status()
        if goodput_doc:
            doc["goodput"] = goodput_doc
        if self.ship_trace:
            doc["trace"] = self._trace_doc()
            payload = self._capped_payload(doc)
        else:
            payload = json.dumps(doc)
        self._client.send_metrics(payload)
        if self.ship_trace:
            # only a delivered beat advances the ship cursors: a torn
            # send re-ships the same spans/steps next beat (tracker
            # dedups by seq) instead of losing them
            self._last_seq = doc["trace"]["seq"]
            self._last_step_seq = doc["trace"]["step_seq"]

    def _trace_doc(self) -> Dict:
        from . import steps as steps_mod

        spans, last = core.spans_since(self._last_seq,
                                       limit=self.MAX_SPANS_PER_BEAT)
        step_recs, step_last = steps_mod.ledger().records_since(
            self._last_step_seq, limit=self.MAX_STEPS_PER_BEAT)
        clock = getattr(self._client, "clock_ping", None)
        if clock is not None:
            try:
                self._clock = clock()
            except (OSError, ValueError, KeyError) as e:
                logger.debug("clock ping failed: %s", e)  # keep last sample
        doc: Dict = {"anchor": core.anchor_epoch(), "seq": last,
                     "spans": spans, "steps": step_recs,
                     "step_seq": step_last}
        if self._clock is not None:
            doc["clock"] = {"offset_s": self._clock[0],
                            "rtt_s": self._clock[1]}
        return doc

    def _capped_payload(self, doc: Dict) -> str:
        """Serialize ``doc``, truncating the trace sub-doc oldest-first
        until the beat fits ``max_beat_bytes``.  Dropped spans/steps are
        gone (they would have been ring-evicted under the same storm);
        ``telemetry.beats_truncated`` counts the shrink events so the
        loss is visible on /metrics."""
        payload = json.dumps(doc)
        if self.max_beat_bytes <= 0 or len(payload) <= self.max_beat_bytes:
            return payload
        trace = doc["trace"]
        truncated = False
        while len(payload) > self.max_beat_bytes:
            if trace["spans"]:
                # halve from the OLD end: the newest spans are the ones
                # the flight recorder has not seen in any form yet
                trace["spans"] = trace["spans"][len(trace["spans"])
                                                // 2 + 1:]
            elif trace["steps"]:
                trace["steps"] = trace["steps"][len(trace["steps"])
                                                // 2 + 1:]
            else:
                break  # snapshot alone exceeds the cap: ship it anyway
            truncated = True
            payload = json.dumps(doc)
        if truncated:
            core.inc("telemetry", "beats_truncated")
        return payload

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self.send_once()  # final flush so short jobs report at all
        except OSError as e:
            logger.debug("final heartbeat failed: %s", e)
