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
  * ``goodput``      the serving availability ledger
  * ``tracecontext`` the X-DMLC-Trace header helpers
  * ``heartbeat``    worker heartbeats over the rendezvous protocol,
                     the tracker-side aggregator (/metrics, /healthz,
                     straggler flags) and its HTTP server
  * ``clock``        NTP-style per-rank clock-offset estimation
  * ``postmortem``   crash dumps (snapshot + open/last spans + event
                     tail) that the launcher collects after a failure

Left for later (ROADMAP.md Queue 1 item 9): ``compute`` (cost analysis
and memory samples), the job goodput ledger, the anomaly watchdog, the
flight recorder, forensics, the decision log and the fleet trace store.

Typical use::

    from dmlc_tpu_torch import telemetry

    telemetry.step_begin()
    ...train step...
    telemetry.step_end(tokens=batch * seq)
    telemetry.ledger().summary()["step_time_p99"]
"""

from . import (  # noqa: F401
    clock,
    core,
    events,
    exporters,
    goodput,
    heartbeat,
    postmortem,
    requests,
    slo,
    steps,
    tracecontext,
)
from .clock import ClockOffsetEstimator, offset_from_timestamps  # noqa: F401
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
from .exporters import (  # noqa: F401
    export_json,
    to_chrome_trace,
    to_chrome_trace_json,
    to_prometheus_text,
)
from .goodput import AvailabilityLedger  # noqa: F401
from .heartbeat import (  # noqa: F401
    HeartbeatSender,
    TelemetryAggregator,
    TelemetryHTTPServer,
)
from .requests import RequestLedger  # noqa: F401
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
    "HeartbeatSender",
    "Histogram",
    "RequestLedger",
    "SLOMonitor",
    "StepLedger",
    "TelemetryAggregator",
    "TelemetryHTTPServer",
    "anchor_epoch",
    "annotate",
    "counters_snapshot",
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
    "record_event",
    "record_span",
    "reset",
    "reset_events",
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
