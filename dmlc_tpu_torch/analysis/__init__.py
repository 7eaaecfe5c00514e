"""dmlc-check over the port: the repo-invariant static-analysis suite
(the port of ``dmlc_tpu/analysis/``, aimed at ``dmlc_tpu_torch/``).

A framework of AST passes that enforce *repo invariants*:

  * :mod:`style_pass`        unused imports, bare except, mutable
                             defaults, whitespace, line length
  * :mod:`metrics_pass`      every emittable ``dmlc_*`` family is
                             registered in telemetry/metric_names.py
  * :mod:`concurrency_pass`  blocking calls while holding a lock, the
                             static lock-acquisition graph (cycles =
                             potential deadlock pairs), non-daemon
                             threads nobody joins
  * :mod:`knob_pass`         every ``DMLC_*`` env read resolves against
                             config_registry.py; raw ``os.environ``
                             reads of DMLC keys must go through
                             base.get_env; PASS_ENVS and the README
                             knob table are complete
  * :mod:`contract_pass`     except clauses that could swallow the
                             typed exceptions that MUST propagate
                             (WorldResized/CorruptRecord/
                             EngineDraining/AlreadyFinished), sockets
                             without timeouts, fault_point site names
                             vs DMLC_FAULT_SPEC literals
  * :mod:`race_pass`         guarded-by classification: every mutable
                             attribute of a threaded class is locked,
                             immutable-after-init, or carries an
                             explicit ``guarded-by``/``unguarded``
                             annotation; mixed locked/unlocked access,
                             divergent guards, and leaked guarded
                             container refs are findings

Run with ``python -m dmlc_tpu_torch.analysis``.  Suppress a finding
with an inline ``# dmlc-check: disable=<check-id>[,<check-id>...]``
comment on the offending line (or the line above); suppressions are
counted in the runner summary so they stay visible.
"""

from .core import Finding, FileContext, RepoIndex, Pass, run_passes
from . import (concurrency_pass, contract_pass, knob_pass, metrics_pass,
               race_pass, style_pass)

ALL_PASSES = (
    style_pass.StylePass,
    metrics_pass.MetricsPass,
    concurrency_pass.ConcurrencyPass,
    knob_pass.KnobPass,
    contract_pass.ContractPass,
    race_pass.RacePass,
)

__all__ = ["ALL_PASSES", "Finding", "FileContext", "RepoIndex", "Pass",
           "run_passes"]
