"""Telemetry exporters: Chrome trace-event JSON, Prometheus text, JSON (the
port of ``dmlc_tpu/telemetry/exporters.py``, rendering the same bytes
for the same snapshot).

  * ``to_chrome_trace()``    — trace-event JSON; load the file straight
    into Perfetto / chrome://tracing.  Spans become complete ("X")
    events; thread names ship as metadata ("M") events so the timeline
    is labeled per producer/consumer thread.
  * ``to_prometheus_text()`` — text exposition format (0.0.4): counters,
    gauges, and real histograms (cumulative ``_bucket{le=...}`` +
    ``_sum`` + ``_count``), optionally labeled.
    ``validate_exposition_text`` is the strict checker of that format.
  * ``export_json()``        — the structured snapshot, buckets stripped
    by default to keep it small.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

from . import core

__all__ = [
    "to_chrome_trace",
    "to_chrome_trace_json",
    "to_prometheus_text",
    "collect_prometheus",
    "render_prometheus",
    "escape_label_value",
    "help_type_lines",
    "validate_exposition_text",
    "export_json",
]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(prefix: str, stage: str, name: str) -> str:
    """Exposition-valid metric name: invalid chars collapse to ``_``.
    The ``prefix`` leads, so the result can never start with a digit."""
    return _NAME_RE.sub("_", f"{prefix}_{stage}_{name}")


def _label_name(name: str) -> str:
    """Exposition-valid label name (``[a-zA-Z_][a-zA-Z0-9_]*``)."""
    clean = _LABEL_RE.sub("_", str(name))
    if not clean or clean[0].isdigit():
        clean = "_" + clean
    return clean


def escape_label_value(value: str) -> str:
    """Escape a label value per the text exposition format (0.0.4):
    backslash, double-quote, and newline must be escaped or the sample
    line is unparseable — a hostname or jobid containing ``"`` would
    otherwise corrupt the whole scrape payload."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def help_type_lines(name: str, mtype: str, help_text: str) -> str:
    """``# HELP`` + ``# TYPE`` header pair for one family (HELP text
    gets its own escaping rules: backslash and newline only)."""
    esc = help_text.replace("\\", "\\\\").replace("\n", "\\n")
    return f"# HELP {name} {esc}\n# TYPE {name} {mtype}\n"


def _fmt_labels(labels: Optional[Dict[str, str]], extra: str = "") -> str:
    parts = [f'{_label_name(k)}="{escape_label_value(v)}"'
             for k, v in (labels or {}).items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_val(v: float) -> str:
    return repr(float(v))


def to_chrome_trace(span_list: Optional[List[Dict]] = None,
                    pid: int = 0) -> Dict:
    """Spans → Chrome trace-event dict ({"traceEvents": [...]}).  The
    ring's own export (no ``span_list``) adds a ``clock_anchor``
    metadata event whose ``epoch_ns`` is the wall-clock ns of ts 0, so
    ``ts * 1e3 + epoch_ns`` lines a span up with a ``torch.profiler``
    export of the same process."""
    anchored = span_list is None
    recs = core.spans() if anchored else span_list
    events: List[Dict] = []
    seen_threads = {}
    for r in recs:
        if r["tid"] not in seen_threads:
            seen_threads[r["tid"]] = r.get("thread", str(r["tid"]))
        ev = {
            "name": r["name"],
            "cat": r.get("cat", "dmlc"),
            "ph": "X",
            "ts": round(r["ts"], 3),
            "dur": round(r["dur"], 3),
            "pid": pid,
            "tid": r["tid"],
        }
        if "args" in r:
            ev["args"] = r["args"]
        events.append(ev)
    meta = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": tname}}
        for tid, tname in seen_threads.items()
    ]
    if anchored:
        meta.append({"name": "clock_anchor", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"epoch_ns": core.anchor_epoch_ns()}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def to_chrome_trace_json(span_list: Optional[List[Dict]] = None) -> str:
    return json.dumps(to_chrome_trace(span_list))


def _render_histogram(lines: List[str], mname: str, summ: Dict,
                      labels: Optional[Dict[str, str]]) -> None:
    bounds = summ.get("bounds")
    buckets = summ.get("buckets")
    if bounds and buckets:
        cum = 0
        for bound, c in zip(bounds, buckets[:-1]):
            cum += c
            le = 'le="' + repr(float(bound)) + '"'
            lines.append(f"{mname}_bucket{_fmt_labels(labels, le)} {cum}")
        inf = 'le="+Inf"'
        lines.append(
            f"{mname}_bucket{_fmt_labels(labels, inf)} {summ['count']}")
    lines.append(f"{mname}_sum{_fmt_labels(labels)} {_fmt_val(summ['sum'])}")
    lines.append(f"{mname}_count{_fmt_labels(labels)} {summ['count']}")


def collect_prometheus(snap: Dict, prefix: str = "dmlc",
                       labels: Optional[Dict[str, str]] = None,
                       out: Optional[Dict] = None) -> Dict:
    """Collect one snapshot's samples into a family table:
    ``{family_name: {"type", "help", "samples": [lines...]}}``.

    The text exposition format requires all lines of one family to form
    a single group — per-rank renderings therefore cannot simply be
    concatenated (each rank would open a new group for the same family).
    Callers collect every snapshot into ONE table (pass ``out``) and
    render it once with :func:`render_prometheus`, which emits each
    family's header and samples together.
    """
    families: Dict = out if out is not None else {}

    def samples(mname: str, mtype: str, stage: str, name: str):
        fam = families.get(mname)
        if fam is None:
            fam = families[mname] = {
                "type": mtype,
                "help": f"dmlc_tpu {mtype} {stage}.{name}",
                "samples": [],
            }
        return fam["samples"]

    # durations recorded via timed() exist as BOTH a flat counter and a
    # histogram under the same key; emitting both would declare one
    # family name twice (invalid exposition) — the histogram's _sum
    # already carries the flat total, so the counter is skipped
    hist_keys = {(stage, name)
                 for stage, hs in snap.get("histograms", {}).items()
                 for name in hs}
    for stage, vals in sorted(snap.get("counters", {}).items()):
        for name, v in sorted(vals.items()):
            if (stage, name) in hist_keys:
                continue
            mname = _metric_name(prefix, stage, name)
            if families.get(mname, {}).get("type", "counter") != "counter":
                continue  # another rank timed() this key: histogram wins
            samples(mname, "counter", stage, name).append(
                f"{mname}{_fmt_labels(labels)} {_fmt_val(v)}")
    for stage, vals in sorted(snap.get("gauges", {}).items()):
        for name, v in sorted(vals.items()):
            mname = _metric_name(prefix, stage, name)
            samples(mname, "gauge", stage, name).append(
                f"{mname}{_fmt_labels(labels)} {_fmt_val(v)}")
    for stage, hists in sorted(snap.get("histograms", {}).items()):
        for name, summ in sorted(hists.items()):
            mname = _metric_name(prefix, stage, name)
            fam = families.get(mname)
            if fam is not None and fam["type"] != "histogram":
                # the reverse collision order: an earlier snapshot
                # registered this key as a bare counter — histogram
                # wins here too, dropping the counter samples (their
                # total is the histogram's _sum)
                fam["type"] = "histogram"
                fam["help"] = f"dmlc_tpu histogram {stage}.{name}"
                fam["samples"] = []
            _render_histogram(samples(mname, "histogram", stage, name),
                              mname, summ, labels)
    return families


def render_prometheus(families: Dict, emit_type_lines: bool = True) -> str:
    """Family table → exposition text: one ``# HELP``/``# TYPE`` header
    pair per family, immediately followed by ALL of its samples."""
    lines: List[str] = []
    for mname, fam in families.items():
        if emit_type_lines:
            lines.append(help_type_lines(
                mname, fam["type"], fam["help"]).rstrip("\n"))
        lines.extend(fam["samples"])
    return "\n".join(lines) + "\n"


def to_prometheus_text(snap: Optional[Dict] = None, prefix: str = "dmlc",
                       labels: Optional[Dict[str, str]] = None,
                       emit_type_lines: bool = True) -> str:
    """Snapshot → Prometheus text exposition format.

    ``snap`` defaults to the live registry (with buckets).  ``labels``
    are attached to every sample — the tracker's aggregated surface uses
    ``{"rank": "<r>"}`` per worker.  Multi-snapshot surfaces (the
    tracker) should use :func:`collect_prometheus` +
    :func:`render_prometheus` so families stay grouped across ranks.
    """
    if snap is None:
        snap = core.snapshot(include_buckets=True)
    return render_prometheus(collect_prometheus(snap, prefix, labels),
                             emit_type_lines=emit_type_lines)


# strict exposition-format checker: one shared oracle for the unit
# tests AND the CI smoke (two drifting copies would let a conformance
# bug pass whichever checker happened to be looser)
_EXPO_COMMENT_RE = re.compile(
    r"^# (HELP|TYPE) ([a-zA-Z_:][a-zA-Z0-9_:]*) .+$")
_EXPO_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\\\|\\"|\\n)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\\\|\\"|\\n)*")*\})?'
    r" [-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN)$")
_EXPO_SUFFIXES = ("_bucket", "_sum", "_count")


def validate_exposition_text(text: str) -> int:
    """Validate ``text`` against the text exposition format (0.0.4),
    strictly: every line parses, HELP precedes TYPE, each family
    declares each header at most once, and ALL of a family's samples
    form one contiguous group.  Returns the sample count; raises
    ``ValueError`` naming the first violation."""
    typed, helped, closed = set(), set(), set()
    current = None
    n = 0
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            m = _EXPO_COMMENT_RE.match(line)
            if not m:
                raise ValueError(f"malformed comment line: {line!r}")
            which, fam = m.group(1), m.group(2)
            if which == "HELP":
                if fam in helped:
                    raise ValueError(f"duplicate HELP for {fam}")
                helped.add(fam)
            else:
                if fam in typed:
                    raise ValueError(f"duplicate TYPE for {fam}")
                if fam not in helped:
                    raise ValueError(f"TYPE {fam} without HELP")
                typed.add(fam)
            continue
        m = _EXPO_SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable sample line: {line!r}")
        name = m.group(1)
        fam = name
        for suf in _EXPO_SUFFIXES:
            if name.endswith(suf) and name[: -len(suf)] in typed:
                fam = name[: -len(suf)]
        if fam != current:
            if fam in closed:
                raise ValueError(f"family {fam} split across groups")
            if current is not None:
                closed.add(current)
            current = fam
        n += 1
    return n


def export_json(include_buckets: bool = False,
                include_spans: bool = False) -> Dict:
    """Structured snapshot for embedding (BENCH artifacts, heartbeats).

    Heartbeats set ``include_buckets=True`` so the tracker can merge
    bucket counts across ranks; bench embedding keeps the default to
    stay a compact one-line JSON.
    """
    out = core.snapshot(include_buckets=include_buckets)
    if include_spans:
        out["spans"] = core.spans()
    else:
        out["n_spans"] = len(core.spans())
    return out
