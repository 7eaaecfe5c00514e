"""Metric-name contract pass (the port of
``dmlc_tpu/analysis/metrics_pass.py``).

Every metric family literal telemetry call sites can emit
(``telemetry.inc("stage", "name")`` -> ``dmlc_<stage>_<name>``), plus
every literal ``dmlc_*`` token anywhere (scrape assertions,
hand-rendered families), must be registered in the port's
``telemetry/metric_names.py`` — the "no renames, additive only"
promise, enforced.  The port's own non-metric tokens (its package name,
the symbols its C and CUDA libraries export) are known there too, in
``PORT_NON_METRIC_TOKENS``.  Check id: ``metric-name``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import List

from .core import PACKAGE, Finding, Pass, RepoIndex

# roots whose telemetry call sites define REAL metric families; tests
# register throwaway stages ("stage", "smoke") that are not contract
METRIC_ROOTS = (PACKAGE, "chip_smoke.py", "chip_stores.py")
_METRIC_FUNCS = {"inc", "set_gauge", "observe", "observe_duration",
                 "timed"}
_METRIC_TOKEN_RE = re.compile(r"dmlc_[a-z0-9]+(?:_[a-z0-9]+)*")
_METRIC_SUFFIXES = ("_bucket", "_sum", "_count", "_total")


def _registry():
    from ..telemetry import metric_names

    return metric_names


def _is_registered(token: str, known: set) -> bool:
    if token in known:
        return True
    for suf in _METRIC_SUFFIXES:
        if token.endswith(suf) and token[: -len(suf)] in known:
            return True
    return False


class MetricsPass(Pass):
    name = "metrics"
    checks = ("metric-name",)

    def run(self, index: RepoIndex) -> List[Finding]:
        reg = _registry()
        known = (set(reg.METRIC_NAMES) | set(reg.SPAN_ANNOTATIONS)
                 | set(reg.NON_METRIC_TOKENS)
                 | set(reg.PORT_NON_METRIC_TOKENS))
        registry_rel = os.path.join(PACKAGE, "telemetry",
                                    "metric_names.py")
        findings: List[Finding] = []
        for ctx in index.files:
            if ctx.rel == registry_rel:
                continue  # the registry trivially contains itself
            if ctx.tree is None:
                continue  # style pass reports the syntax error
            in_metric_root = any(
                ctx.rel == r or ctx.rel.startswith(r + os.sep)
                for r in METRIC_ROOTS)
            for node in ast.walk(ctx.tree):
                # derived families: telemetry.inc("stage", "name", ...)
                # with literal args resolve to dmlc_<stage>_<name>
                if in_metric_root and isinstance(node, ast.Call):
                    fn = node.func
                    fname = (fn.attr if isinstance(fn, ast.Attribute)
                             else fn.id if isinstance(fn, ast.Name)
                             else None)
                    args = node.args
                    if (fname in _METRIC_FUNCS and len(args) >= 2
                            and all(isinstance(a, ast.Constant)
                                    and isinstance(a.value, str)
                                    for a in args[:2])):
                        suffix = ("_secs" if fname in ("observe_duration",
                                                       "timed") else "")
                        name = (f"dmlc_{args[0].value}_"
                                f"{args[1].value}{suffix}")
                        if not _is_registered(name, known):
                            findings.append(Finding(
                                ctx.rel, node.lineno, "metric-name",
                                f"metric family {name!r} not in "
                                f"telemetry/metric_names.py (add it, or "
                                f"fix the typo'd stage/name)"))
                # literal names: scrape assertions, hand-rendered rows
                if (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)):
                    for token in _METRIC_TOKEN_RE.findall(node.value):
                        if not _is_registered(token, known):
                            findings.append(Finding(
                                ctx.rel, node.lineno, "metric-name",
                                f"dmlc_* token {token!r} not in "
                                f"telemetry/metric_names.py"))
        return findings
