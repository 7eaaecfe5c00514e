"""Self-healing training loop: non-finite/spike detection with a
skip → rollback-and-replay → abort escalation ladder (the port of
``dmlc_tpu/resilience/selfheal.py``: the same verdicts, knobs, counters,
events and status doc).

A :class:`SelfHealGuard` sits around the train step and classifies every
step's loss (and optionally its gradient norm):

  1. a poisoned step — non-finite loss/grad, or a loss spiking past the
     EWMA gate — is **skipped**: the trainer declines the update (the
     port's ``make_train_step(grad_norm=True)`` asks before
     ``optimizer.step()``, so the parameters and the optimizer's state
     are never touched) and moves to the next batch;
  2. ``DMLC_SELFHEAL_MAX_SKIPS`` *consecutive* skips mean the poison is
     not transient — the guard escalates to **rollback-and-replay**: the
     trainer restores the last COMMITTED checkpoint
     (checkpoint.CheckpointManager) and replays forward; records
     quarantined by the integrity layer (io.integrity) are skip-listed,
     so the replay deterministically routes *around* the poison;
  3. ``DMLC_SELFHEAL_MAX_ROLLBACKS`` rollbacks without recovery mean the
     job cannot heal — the guard **aborts** with a postmortem
     (telemetry.postmortem) that names the suspect (quarantined) spans.

Knobs (all env-tunable):

  ``DMLC_SELFHEAL_MAX_SKIPS``      consecutive skips before rollback
                                   (default 3)
  ``DMLC_SELFHEAL_MAX_ROLLBACKS``  rollbacks before abort (default 2)
  ``DMLC_SELFHEAL_SPIKE_FACTOR``   loss > factor * EWMA flags a spike
                                   (default 10; <= 1 disables the gate)
  ``DMLC_SELFHEAL_WARMUP``         finite steps before the spike gate
                                   arms (default 10)

Every action lands in the ``dmlc_selfheal_*`` counters, the structured
event ring, and the per-process status doc the heartbeat ships to the
tracker (the ``selfheal`` field of each beat), where the watchdog shows
the *remediation* next to the flag.

Chaos hook: an armed ``selfheal.loss=corrupt`` fault rule
(``DMLC_FAULT_SPEC``) forces the observed loss non-finite — how the
integrity smoke injects a poisoned step without touching model math.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

from .. import logging as log
from ..base import DMLCError, get_env
from ..concurrency import make_lock

__all__ = ["SelfHealGuard", "SelfHealAbort", "status", "reset_selfheal"]


#: observe() verdicts
OK = "ok"
SKIP = "skip"
ROLLBACK = "rollback"
ABORT = "abort"

_EWMA_ALPHA = 0.1

_status_lock = make_lock("selfheal._status_lock")
_status: Dict = {}


class SelfHealAbort(DMLCError):
    """Escalation exhausted: the job cannot heal itself."""


def status() -> Dict:
    """The process's latest self-heal status (shipped with heartbeats;
    empty until a guard acts)."""
    with _status_lock:
        return dict(_status)


def reset_selfheal() -> None:
    with _status_lock:
        _status.clear()


def _publish(**kv) -> None:
    with _status_lock:
        _status.update(kv, t=time.time())


class SelfHealGuard:
    """Classify each train step and drive the escalation ladder.

    The caller owns the mechanics (state revert, checkpoint restore,
    feed replay); the guard owns the policy — what a step's loss means
    and when to escalate.  ``observe`` is deterministic in its inputs,
    so replicated trainers whose losses agree (allreduced) reach the
    same verdict on every rank without coordination.
    """

    def __init__(self, *, max_skips: Optional[int] = None,
                 max_rollbacks: Optional[int] = None,
                 spike_factor: Optional[float] = None,
                 warmup: Optional[int] = None):
        self.max_skips = (get_env("DMLC_SELFHEAL_MAX_SKIPS", 3)
                          if max_skips is None else int(max_skips))
        self.max_rollbacks = (get_env("DMLC_SELFHEAL_MAX_ROLLBACKS", 2)
                              if max_rollbacks is None
                              else int(max_rollbacks))
        self.spike_factor = (get_env("DMLC_SELFHEAL_SPIKE_FACTOR", 10.0)
                             if spike_factor is None
                             else float(spike_factor))
        self.warmup = (get_env("DMLC_SELFHEAL_WARMUP", 10)
                       if warmup is None else int(warmup))
        self.ewma: Optional[float] = None
        self.finite_steps = 0
        self.consecutive_bad = 0
        self.skips = 0
        self.rollbacks = 0

    # ---- classification -------------------------------------------------
    def _classify(self, loss: float, grad_norm: Optional[float],
                  step: Optional[int]):
        """(kind, reason) for a poisoned step — kind 'nonfinite' or
        'spike' — or None when the step is healthy."""
        from . import maybe_corrupt

        # chaos hook: an armed 'selfheal.loss=corrupt' rule poisons the
        # observed loss, letting CI force the whole ladder end to end;
        # the step rides as predicate context so a spec can target one
        # exact step ('selfheal.loss@step:21=corrupt::3')
        if maybe_corrupt("selfheal.loss", b"\x00", step=step) != b"\x00":
            return "nonfinite", "injected non-finite loss"
        if not math.isfinite(loss):
            return "nonfinite", f"non-finite loss ({loss})"
        if grad_norm is not None and not math.isfinite(float(grad_norm)):
            return "nonfinite", f"non-finite grad norm ({grad_norm})"
        if (self.spike_factor > 1.0 and self.ewma is not None
                and self.finite_steps >= self.warmup
                and loss > self.spike_factor * max(self.ewma, 1e-12)):
            return "spike", (f"loss spike ({loss:.4g} > "
                             f"{self.spike_factor:g}x EWMA "
                             f"{self.ewma:.4g})")
        return None

    # ---- the ladder -----------------------------------------------------
    def observe(self, loss, grad_norm=None, step: Optional[int] = None
                ) -> str:
        """Classify one completed step; returns the action the trainer
        must take: ``ok`` (commit the step), ``skip`` (revert to the
        pre-step state, drop the batch), ``rollback`` (restore the last
        committed checkpoint and replay), ``abort`` (the guard already
        dumped a postmortem; stop the job)."""
        from .. import telemetry

        loss = float(loss)
        verdict = self._classify(loss, grad_norm, step)
        if verdict is None:
            self.ewma = (loss if self.ewma is None
                         else self.ewma + _EWMA_ALPHA * (loss - self.ewma))
            self.finite_steps += 1
            self.consecutive_bad = 0
            return OK
        kind, reason = verdict
        self.consecutive_bad += 1
        telemetry.inc("selfheal", "nonfinite_steps" if kind == "nonfinite"
                      else "spike_steps")
        if self.consecutive_bad <= self.max_skips:
            self.skips += 1
            telemetry.inc("selfheal", "skips")
            telemetry.record_event("selfheal_skip", reason=reason,
                                   step="" if step is None else str(step),
                                   consecutive=self.consecutive_bad)
            self._report(SKIP, reason, step)
            return SKIP
        if self.rollbacks < self.max_rollbacks:
            self.rollbacks += 1
            self.consecutive_bad = 0
            telemetry.inc("selfheal", "rollbacks")
            telemetry.record_event("selfheal_rollback", reason=reason,
                                   step="" if step is None else str(step),
                                   rollbacks=self.rollbacks)
            self._report(ROLLBACK, reason, step)
            return ROLLBACK
        telemetry.inc("selfheal", "aborts")
        telemetry.record_event("selfheal_abort", reason=reason,
                               step="" if step is None else str(step))
        self._report(ABORT, reason, step)
        self._dump_postmortem(reason, step)
        return ABORT

    def _report(self, action: str, reason: str,
                step: Optional[int]) -> None:
        log.warning(f"selfheal: {action} at step "
                       f"{'?' if step is None else step} — {reason} "
                       f"(skips={self.skips} "
                       f"rollbacks={self.rollbacks})")
        _publish(last_action=action, reason=reason,
                 step=step, skips=self.skips, rollbacks=self.rollbacks,
                 consecutive=self.consecutive_bad)

    def _dump_postmortem(self, reason: str, step: Optional[int]) -> None:
        """Abort postmortem naming the suspect spans: the quarantine
        skip-list is the best forensic lead on WHICH bytes poisoned the
        run."""
        from ..io.integrity import quarantined_spans
        from ..telemetry import postmortem, record_event

        spans = quarantined_spans()
        for src, b, e in spans[:32]:
            record_event("selfheal_suspect_span", source=src,
                         begin=b, end=e)
        postmortem.dump(
            f"selfheal abort at step {'?' if step is None else step}: "
            f"{reason}; {self.rollbacks} rollbacks exhausted; suspect "
            f"spans: "
            + (", ".join(f"{s}[{b}:{e}]" for s, b, e in spans[:8])
               or "none quarantined"))

    def raise_abort(self, step: Optional[int] = None) -> None:
        """The trainer's terminal path after an ``abort`` verdict."""
        from ..io.integrity import quarantined_spans

        raise SelfHealAbort(
            f"self-heal exhausted ({self.rollbacks} rollbacks, "
            f"{self.skips} skips) at step "
            f"{'?' if step is None else step}; suspect spans: "
            f"{quarantined_spans()[:8]}")
