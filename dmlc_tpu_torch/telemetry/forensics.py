"""Incident forensics — postmortem timelines for badput episodes (the
port of ``dmlc_tpu/telemetry/forensics.py``: the same seeds, merge rule
and incident document).

The goodput ledger (goodput.py) names every second of badput; the
decision log (tracecontext.py) names every control-plane choice;
the event ring and the watchdog name what happened and what looked
wrong.  This module joins them: an **incident** is a wall-clock episode
seeded from badput intervals (the training plane) and/or decision
chains (the fleet plane — preemption / scale episodes), with every
decision, event, and anomaly flag that falls inside it attached in wall
order, rendered as a postmortem-style JSON document.

Served as ``GET /incidents`` on the tracker metrics server (full join:
goodput aggregator + decision log + events + watchdog; the JAX
package's router serves the fleet-plane view from decisions + events
alone), and as a ``dmlc-top`` pane.

No hard dependency on any source: every input is optional, so
``build_incidents`` works in any process that has *some* of the surfaces.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

__all__ = ["build_incidents", "IncidentReporter", "DECISION_EPISODE_KINDS"]

# Decision kinds that *seed* incidents (fleet-plane downtime/capacity
# episodes).  Other kinds are only attached when they fall inside an
# episode's window.
DECISION_EPISODE_KINDS = (
    "autoscale_verdict",
    "scale_up",
    "scale_down",
    "preempt_acquire",
    "preempt_kill_rank",
    "preempt_resize",
    "preempt_replica_added",
    "preempt_release",
    "preempt_relaunch_rank",
    "preempt_restore_resize",
)

# Chain kinds that await a causal successor: an incident seeded by one
# stays open past ``gap_s`` (up to ``chain_gap_s``) until its closer
# lands — a replica gang-launch can take tens of seconds between
# ``preempt_resize`` and ``preempt_replica_added``, and splitting the
# chain there would report half an episode.
_CHAIN_AWAITING = frozenset({
    "preempt_acquire",
    "preempt_kill_rank",
    "preempt_resize",
    "preempt_release",
    "preempt_relaunch_rank",
})


def build_incidents(*,
                    intervals: Optional[Sequence[Dict]] = None,
                    decisions: Optional[Sequence[Dict]] = None,
                    events: Optional[Sequence[Dict]] = None,
                    anomalies: Optional[Sequence[Dict]] = None,
                    gap_s: float = 5.0,
                    margin_s: float = 2.0,
                    chain_gap_s: float = 120.0,
                    limit: int = 32) -> List[Dict]:
    """Join badput intervals + decision chains into incident reports.

    ``intervals``: goodput badput intervals (``{bucket, t0, t1, dur_s,
    rank?}``, epoch seconds).  ``decisions``: decision-log records
    (``{kind, t, seq, ...}``).  ``events``: event-ring records
    (``{kind, t, ...}``).  ``anomalies``: flattened anomaly flags
    (``{kind, rank?, t?}``).  Seeds closer than ``gap_s`` merge into one
    incident — stretched to ``chain_gap_s`` while the newest merged
    decision is a :data:`_CHAIN_AWAITING` kind still waiting for its
    causal successor; attachments within ``margin_s`` of the window
    count.  Newest-first, capped at ``limit``.
    """
    seeds: List[Dict] = []
    for iv in intervals or ():
        t0, t1 = iv.get("t0"), iv.get("t1")
        if t0 is None or t1 is None or t1 <= t0:
            continue
        seeds.append({
            "t0": float(t0), "t1": float(t1),
            "kinds": {str(iv.get("bucket", "badput"))},
            "ranks": ({int(iv["rank"])} if iv.get("rank") is not None
                      else set()),
            "buckets": {str(iv.get("bucket", "badput")):
                        float(iv.get("dur_s", t1 - t0))},
            "awaiting": False, "dec": False,
        })
    for d in decisions or ():
        if d.get("kind") in DECISION_EPISODE_KINDS and d.get("t"):
            t = float(d["t"])
            seeds.append({"t0": t, "t1": t, "kinds": {str(d["kind"])},
                          "ranks": set(), "buckets": {},
                          "awaiting": d["kind"] in _CHAIN_AWAITING,
                          "dec": True})
    if not seeds:
        return []
    # Union-merge overlapping / near-adjacent seed windows.
    seeds.sort(key=lambda s: s["t0"])
    merged: List[Dict] = []
    for s in seeds:
        reach = chain_gap_s if (merged and merged[-1]["awaiting"]) \
            else gap_s
        if merged and s["t0"] <= merged[-1]["t1"] + reach:
            m = merged[-1]
            m["t1"] = max(m["t1"], s["t1"])
            m["kinds"].update(s["kinds"])
            m["ranks"].update(s["ranks"])
            for b, v in s["buckets"].items():
                m["buckets"][b] = m["buckets"].get(b, 0.0) + v
            if s["dec"]:
                m["awaiting"] = s["awaiting"]
        else:
            merged.append(s)
    merged = merged[-int(limit):]

    out: List[Dict] = []
    for i, m in enumerate(merged):
        lo, hi = m["t0"] - margin_s, m["t1"] + margin_s
        atts_d = [d for d in (decisions or ())
                  if d.get("t") is not None and lo <= d["t"] <= hi]
        atts_e = [e for e in (events or ())
                  if e.get("t") is not None and lo <= e["t"] <= hi]
        atts_a = [a for a in (anomalies or ())
                  if a.get("t") is None or lo <= a["t"] <= hi]
        timeline = sorted(
            [{"t": d["t"], "what": "decision", "kind": d.get("kind"),
              "seq": d.get("seq")} for d in atts_d]
            + [{"t": e["t"], "what": "event", "kind": e.get("kind"),
                "seq": e.get("seq")} for e in atts_e],
            key=lambda r: (r["t"], r.get("seq") or 0))
        badput_s = sum(m["buckets"].values())
        dec_kinds = [d.get("kind") for d in atts_d]
        summary_bits = []
        if m["buckets"]:
            top = max(m["buckets"], key=m["buckets"].get)
            summary_bits.append(
                f"{badput_s:.2f}s badput (worst: {top})")
        if dec_kinds:
            summary_bits.append(
                f"{len(dec_kinds)} decisions ({dec_kinds[0]}"
                + (f" .. {dec_kinds[-1]})" if len(dec_kinds) > 1 else ")"))
        if atts_a:
            summary_bits.append(
                f"{len(atts_a)} anomaly flags")
        out.append({
            "id": f"inc-{i}-{int(m['t0'])}",
            "t0": m["t0"],
            "t1": m["t1"],
            "duration_s": m["t1"] - m["t0"],
            "kinds": sorted(m["kinds"]),
            "ranks": sorted(m["ranks"]),
            "badput_s": badput_s,
            "buckets": m["buckets"],
            "decisions": [dict(d) for d in atts_d],
            "decision_kinds": dec_kinds,
            "events": [{"t": e.get("t"), "kind": e.get("kind")}
                       for e in atts_e],
            "anomalies": [{"kind": a.get("kind"), "rank": a.get("rank")}
                          for a in atts_a],
            "timeline": timeline,
            "summary": "; ".join(summary_bits) or "badput episode",
        })
    out.reverse()  # newest first
    return out


class IncidentReporter:
    """Bind the available sources once; ``report()`` renders on demand.

    Every source is an optional zero-arg callable so the reporter works
    in any process: the tracker passes the goodput aggregator's interval
    feed + watchdog flags; the router passes only decisions + events.
    """

    def __init__(self, *,
                 intervals_source=None,
                 decisions_source=None,
                 events_source=None,
                 anomalies_source=None,
                 gap_s: float = 5.0,
                 margin_s: float = 2.0,
                 chain_gap_s: float = 120.0):
        self.intervals_source = intervals_source
        self.decisions_source = decisions_source
        self.events_source = events_source
        self.anomalies_source = anomalies_source
        self.gap_s = gap_s
        self.margin_s = margin_s
        self.chain_gap_s = chain_gap_s

    @staticmethod
    def _pull(source) -> list:
        if source is None:
            return []
        try:
            return list(source() or [])
        except Exception:  # noqa: BLE001 - forensics never takes a server down
            return []

    def report(self, limit: int = 32) -> Dict:
        incidents = build_incidents(
            intervals=self._pull(self.intervals_source),
            decisions=self._pull(self.decisions_source),
            events=self._pull(self.events_source),
            anomalies=self._pull(self.anomalies_source),
            gap_s=self.gap_s,
            margin_s=self.margin_s,
            chain_gap_s=self.chain_gap_s,
            limit=limit,
        )
        return {"t": time.time(), "count": len(incidents),
                "incidents": incidents}


def watchdog_anomaly_records(watchdog_report: Dict) -> List[Dict]:
    """Flatten a ``Watchdog.report()`` doc's active flags into
    ``{kind, rank, t}`` records (``t`` = flagged-since, when known;
    flags without a timestamp attach to every incident as ambient
    context)."""
    out: List[Dict] = []
    for flag in (watchdog_report or {}).get("active", ()) or ():
        out.append({"kind": flag.get("kind"), "rank": flag.get("rank"),
                    "t": flag.get("since")})
    return out
