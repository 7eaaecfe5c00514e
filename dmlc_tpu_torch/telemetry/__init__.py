"""dmlc_tpu_torch.telemetry: spans, histograms, exporters and the ledgers
(the port of ``dmlc_tpu/telemetry``, with its metric families, span
names, ``DMLC_*`` knobs and JSON keys, so dashboards and the load
generator read either package).

  * ``core``         counters / gauges / fixed-bucket histograms with
                     p50/p90/p99 summaries, plus a nested thread-aware
                     span tracer in a bounded ring buffer
  * ``events``       bounded structured event log
  * ``exporters``    Chrome trace-event JSON, Prometheus text exposition
                     (and its strict validator), JSON snapshot
  * ``steps``        per-step performance ledger: wall-time attribution
                     (feed-wait / checkpoint / collective / compute),
                     host issue beside the wall on a CUDA card, goodput
                     tokens/s and MFU per step
  * ``requests``     serving request ledger: per-request lifecycle
                     (queue / prefill / TTFT / TBT / preempt / finish)
  * ``slo``          declarative serving SLOs (DMLC_SLO_*) as
                     multi-window burn rates behind /slo
  * ``goodput``      the job goodput/badput ledger (every rank's wall
                     clock in one bucket per instant, shipped with
                     heartbeats), its tracker-side aggregator behind
                     /goodput, and the serving availability ledger
  * ``tracecontext`` the X-DMLC-Trace header helpers, the decision
                     audit log (``DecisionLog``, ``record_decision``)
                     and the router's fleet trace store
                     (``FleetTraceStore``)
  * ``heartbeat``    worker heartbeats over the rendezvous protocol,
                     the tracker-side aggregator (/metrics, /healthz,
                     straggler flags) and its HTTP server
  * ``clock``        NTP-style per-rank clock-offset estimation
  * ``flight``       the tracker's flight recorder: per-rank span
                     stores and the merged, clock-corrected /trace
  * ``anomaly``      the tracker's online watchdog over shipped step
                     records and status docs (/anomalies, /compute,
                     ``dmlc_anomaly_*``)
  * ``forensics``    incidents: badput episodes joined with decisions,
                     events and anomaly flags (/incidents)
  * ``metric_names`` the registry of every ``dmlc_*`` metric family
  * ``postmortem``   crash dumps (snapshot + open/last spans + event
                     tail) that the launcher collects after a failure

  * ``compute``      the site ledger (traces, hits, recompiles, storms),
                     each site's counted FLOPs and bytes (the step's
                     roofline), card memory samples and decode phase
                     shares, behind /compute (``profiled_site``)

Typical use::

    from dmlc_tpu_torch import telemetry

    telemetry.step_begin()
    ...train step...
    telemetry.step_end(tokens=batch * seq)
    telemetry.ledger().summary()["step_time_p99"]
"""

from . import (  # noqa: F401
    anomaly,
    clock,
    compute,
    core,
    events,
    exporters,
    flight,
    forensics,
    goodput,
    heartbeat,
    metric_names,
    postmortem,
    requests,
    slo,
    steps,
    tracecontext,
)
from .anomaly import Watchdog  # noqa: F401
from .clock import ClockOffsetEstimator, offset_from_timestamps  # noqa: F401
from .compute import profiled_site  # noqa: F401
from .core import (  # noqa: F401
    DEFAULT_BOUNDS,
    Histogram,
    anchor_epoch,
    annotate,
    counters_snapshot,
    inc,
    observe,
    observe_duration,
    open_spans,
    record_span,
    reset,
    set_gauge,
    snapshot,
    span,
    spans,
    spans_since,
    timed,
    trace,
)
from .events import (  # noqa: F401
    events_tail,
    record_event,
    reset_events,
)
from .flight import FlightRecorder  # noqa: F401
from .forensics import (  # noqa: F401
    IncidentReporter,
    build_incidents,
)
from .exporters import (  # noqa: F401
    export_json,
    to_chrome_trace,
    to_chrome_trace_json,
    to_prometheus_text,
)
from .goodput import (  # noqa: F401
    AvailabilityLedger,
    GoodputAggregator,
    GoodputLedger,
    reset_goodput,
)
from .heartbeat import (  # noqa: F401
    HeartbeatSender,
    TelemetryAggregator,
    TelemetryHTTPServer,
)
from .requests import RequestLedger  # noqa: F401
from .tracecontext import (  # noqa: F401
    DecisionLog,
    FleetTraceStore,
    decision_log,
    record_decision,
)
from .slo import SLOMonitor  # noqa: F401
from .steps import (  # noqa: F401
    StepLedger,
    declare_dtype,
    declare_flops_per_token,
    declare_peak_flops,
    detect_peak_flops,
    detect_peaks,
    ledger,
    reset_steps,
    step_begin,
    step_end,
)

__all__ = [
    "AvailabilityLedger",
    "ClockOffsetEstimator",
    "DEFAULT_BOUNDS",
    "DecisionLog",
    "FleetTraceStore",
    "FlightRecorder",
    "GoodputAggregator",
    "GoodputLedger",
    "HeartbeatSender",
    "Histogram",
    "IncidentReporter",
    "RequestLedger",
    "SLOMonitor",
    "StepLedger",
    "TelemetryAggregator",
    "TelemetryHTTPServer",
    "Watchdog",
    "anchor_epoch",
    "annotate",
    "build_incidents",
    "counters_snapshot",
    "decision_log",
    "declare_dtype",
    "declare_flops_per_token",
    "declare_peak_flops",
    "detect_peak_flops",
    "detect_peaks",
    "events_tail",
    "export_json",
    "inc",
    "ledger",
    "observe",
    "observe_duration",
    "offset_from_timestamps",
    "open_spans",
    "profiled_site",
    "record_decision",
    "record_event",
    "record_span",
    "reset",
    "reset_events",
    "reset_goodput",
    "reset_steps",
    "set_gauge",
    "snapshot",
    "span",
    "spans",
    "spans_since",
    "step_begin",
    "step_end",
    "timed",
    "to_chrome_trace",
    "to_chrome_trace_json",
    "to_prometheus_text",
    "trace",
]
