"""The harness: finds a cell's files by name, runs its driver, reads its
metrics and prints the one result line.

Everything that belongs to one configuration, traffic mix, driver or
metric is a file of its own, found by name:

    portbench/configs/<config>.json     sizes, source, engine settings
    portbench/traffic/<traffic>.json    the mix's parameters and driver
    portbench/workloads/<cell>.json     config, traffic, chips, rate,
                                        limits of the correctness check
    portbench/drivers/<driver>.py       run(run) -> fills the Run
    portbench/metrics/<metric>.py       read(run) -> value or None

Which metrics a run reports comes from ``BENCHMARK.json``: its
end-to-end metrics with ``--trace 0``, its per-layer ones with
``--trace 1``, each where its ``workloads`` list names the cell (or
everywhere without one).  A reader that finds nothing returns None and
its metric is left out of the line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "dmlc_tpu")


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = root / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = ROOT):
    """A driver or metric module by its file name (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    mod_name = "portbench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, trace: bool) -> List[dict]:
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key]
            if "workloads" not in m or cell in m["workloads"]]


@dataclasses.dataclass
class Run:
    """What one run measured; drivers fill it, metric readers read it."""

    cell: str
    cell_spec: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    attempted: int = 0
    failed: int = 0
    work: Dict[str, Any] = dataclasses.field(default_factory=dict)
    steps: List[dict] = dataclasses.field(default_factory=list)
    trace_summary: Optional[dict] = None
    checks: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    peak_bytes: Optional[int] = None

    def note(self, text: str) -> None:
        print(text, file=sys.stderr, flush=True)

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks.values())


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(cell: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, root: Path = ROOT) -> Run:
    """Run cell ``cell`` through its driver; no output."""
    cell_spec = load_json("workloads", cell, root)
    run = Run(cell=cell, cell_spec=cell_spec,
              cfg=load_json("configs", cell_spec["config"], root),
              traffic=load_json("traffic", cell_spec["traffic"], root),
              seed=int(seed), seconds=float(seconds), trace=bool(trace),
              device=device, t_start=t_start)
    load_module("drivers", run.traffic["driver"], root).run(run)
    return run


def result(run: Run, spec: dict, device_doc: dict,
           root: Path = ROOT) -> dict:
    """The result line's object; ``checks`` comes last."""
    metrics = {}
    for m in cell_metrics(spec, run.cell, run.trace):
        value = load_module("metrics", m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics,
           "device": dict(device_doc)}
    if run.trace and run.trace_summary:
        ts = run.trace_summary
        out["device"]["busy_s"] = ts["busy_s"]
        out["device"]["window_s"] = ts["window_s"]
        out["breakdown"] = {"device_ops": ts["device_ops"],
                            "idle_gaps": run.work.get("gap_names", [])}
    out["checks"] = run.checks
    return out


def main(argv=None) -> int:
    import argparse

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    # the host issues the program's work: keep its own CPU threads few
    torch.set_num_threads(2)
    with open(BENCHMARK) as f:
        spec = json.load(f)
    chips = int(load_json("workloads", args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: needs {chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    run = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    device_doc = {"platform": "gpu",
                  "kind": torch.cuda.get_device_name(0), "count": chips,
                  "memory_peak_bytes": int(run.peak_bytes or 0)}
    out = result(run, spec, device_doc)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
