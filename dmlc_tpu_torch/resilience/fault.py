"""Deterministic fault injection, driven by ``DMLC_FAULT_SPEC`` (the port
of ``dmlc_tpu/resilience/fault.py``: same grammar, same sites).

The chaos half of the resilience layer: tests arm faults through one
env var, and
instrumented sites fire them deterministically — no random coin flips,
so a failing chaos run reproduces byte-for-byte.

Spec grammar (semicolon-separated rules)::

    site[@key:value...]=action[:arg][:count]

  * ``site``    the instrumented point's name (``s3.request``,
                ``tracker.dial``, ``barrier.<name>``, ``storage.response``)
  * ``@key:value``  optional context predicates, matched against the
                ``fault_point(site, key=value)`` keyword context as
                strings (``@rank:1@attempt:0`` = only rank 1's first
                attempt)
  * ``action``  ``error``   raise :class:`FaultInjected` (a
                            ``ConnectionError``: dropped-connection
                            shape, classified transient by RetryPolicy)
                ``delay``   sleep ``arg`` seconds (default 0.1)
                ``kill``    ``os._exit(arg or 137)`` — die without
                            cleanup, the SIGKILL'd-host simulation
                ``corrupt`` flip bytes in data passed through
                            :func:`maybe_corrupt`
  * ``count``   firings before the rule disarms (default 1; ``*`` =
                unlimited)

Examples::

    DMLC_FAULT_SPEC='s3.request=error::2'            # two torn requests
    DMLC_FAULT_SPEC='barrier.chaos@rank:1@attempt:0=kill:137'
    DMLC_FAULT_SPEC='storage.response=corrupt;tracker.dial=delay:0.5:*'

The process-global injector re-reads the env var whenever it changes,
so ``monkeypatch.setenv`` works without explicit installation; when the
spec is empty every hook is a near-free string compare.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional
from ..concurrency import make_lock

__all__ = [
    "FaultInjected",
    "FaultInjector",
    "fault_point",
    "get_injector",
    "install_injector",
    "maybe_corrupt",
    "reset_injector",
]

logger = logging.getLogger("dmlc_tpu_torch.resilience")

ENV_VAR = "DMLC_FAULT_SPEC"

_ACTIONS = ("error", "delay", "kill", "corrupt")


class FaultInjected(ConnectionError):
    """Raised by an armed ``error`` rule: the dropped-connection shape,
    so retry classification and recovery paths treat it exactly like a
    real torn socket."""


class _Rule:
    __slots__ = ("site", "preds", "action", "arg", "remaining")

    def __init__(self, site: str, preds: Dict[str, str], action: str,
                 arg: str, remaining: int):
        self.site = site
        self.preds = preds
        self.action = action
        self.arg = arg
        self.remaining = remaining  # -1 = unlimited

    def matches(self, site: str, ctx: Dict) -> bool:
        if self.site != site or self.remaining == 0:
            return False
        return all(str(ctx.get(k)) == v for k, v in self.preds.items())


def _parse(spec: str) -> List[_Rule]:
    rules = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        lhs, sep, rhs = chunk.partition("=")
        if not sep or not lhs or not rhs:
            raise ValueError(f"bad fault rule {chunk!r}: want "
                             f"site[@k:v...]=action[:arg][:count]")
        site_parts = lhs.split("@")
        site = site_parts[0].strip()
        preds = {}
        for p in site_parts[1:]:
            k, psep, v = p.partition(":")
            if not psep:
                raise ValueError(f"bad fault predicate {p!r} in {chunk!r}: "
                                 f"want key:value")
            preds[k.strip()] = v.strip()
        action, _, rest = rhs.partition(":")
        action = action.strip()
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r} in {chunk!r} "
                             f"(choose from {_ACTIONS})")
        arg, _, count_s = rest.partition(":")
        count_s = count_s.strip()
        remaining = 1 if not count_s else -1 if count_s == "*" \
            else int(count_s)
        rules.append(_Rule(site, preds, action, arg.strip(), remaining))
    return rules


class FaultInjector:
    """Deterministic fault rules, matched in spec order.

    Thread-safe: the tracker accept loop, heartbeat threads, and worker
    task threads may all cross instrumented sites concurrently."""

    def __init__(self, spec: str = ""):
        self.spec = spec
        self._rules = _parse(spec)
        self._lock = make_lock("FaultInjector._lock")

    @classmethod
    def from_env(cls) -> "FaultInjector":
        from ..base import get_env

        return cls(get_env(ENV_VAR, ""))

    @property
    def enabled(self) -> bool:
        return bool(self._rules)

    def _take(self, site: str, ctx: Dict, actions) -> Optional[_Rule]:
        """First matching armed rule for ``site`` whose action is in
        ``actions``; decrements its budget."""
        with self._lock:
            for r in self._rules:
                if r.action in actions and r.matches(site, ctx):
                    if r.remaining > 0:
                        r.remaining -= 1
                    return r
        return None

    def fire(self, site: str, **ctx) -> None:
        """Trigger any armed error/delay/kill rule at ``site``."""
        r = self._take(site, ctx, ("error", "delay", "kill"))
        if r is None:
            return
        from .. import telemetry

        telemetry.inc("resilience", "faults_injected")
        telemetry.record_event("fault_injected", site=site,
                               action=r.action,
                               **{k: str(v) for k, v in ctx.items()})
        logger.warning("fault injection: %s at %s ctx=%s", r.action, site, ctx)
        if r.action == "delay":
            time.sleep(float(r.arg) if r.arg else 0.1)
        elif r.action == "error":
            raise FaultInjected(
                f"fault injected at {site}" + (f": {r.arg}" if r.arg else ""))
        elif r.action == "kill":
            # die the way a preempted host dies: no cleanup, no
            # shutdown handshake, no atexit — peers see a dropped link.
            # A real SIGKILL is unhookable, so the injector writes the
            # postmortem itself: this dump IS the simulated-preemption
            # flight record the chaos harness asserts on.
            telemetry.postmortem.dump(f"fault.kill at {site}")
            logging.shutdown()
            os._exit(int(r.arg) if r.arg else 137)

    def corrupt(self, site: str, data: bytes, **ctx) -> bytes:
        """Apply any armed ``corrupt`` rule at ``site`` to ``data``."""
        r = self._take(site, ctx, ("corrupt",))
        if r is None or not data:
            return data
        from .. import telemetry

        telemetry.inc("resilience", "faults_injected")
        logger.warning("fault injection: corrupt at %s (%d bytes)",
                       site, len(data))
        n = min(len(data), 8)
        return bytes(b ^ 0xA5 for b in data[:n]) + data[n:]


# ---------------------------------------------------------------------------
# process-global injector (env-tracked)
# ---------------------------------------------------------------------------

_lock = make_lock("fault._lock")
_injector: Optional[FaultInjector] = None
_pinned = False  # install_injector() wins over env tracking


def get_injector() -> FaultInjector:
    """The process injector; tracks ``DMLC_FAULT_SPEC`` changes unless a
    test pinned one via :func:`install_injector`."""
    global _injector
    with _lock:
        if not _pinned:
            from ..base import get_env

            spec = get_env(ENV_VAR, "")
            if _injector is None or _injector.spec != spec:
                _injector = FaultInjector(spec)
        assert _injector is not None
        return _injector


def install_injector(spec: str) -> FaultInjector:
    """Pin an injector for this process (tests); survives env changes
    until :func:`reset_injector`."""
    global _injector, _pinned
    with _lock:
        _injector = FaultInjector(spec)
        _pinned = True
        return _injector


def reset_injector() -> None:
    global _injector, _pinned
    with _lock:
        _injector = None
        _pinned = False


def fault_point(site: str, **ctx) -> None:
    """Instrumented-site hook: fires any armed error/delay/kill rule.
    Near-free when no spec is armed.  ``barrier.*`` sites additionally
    land in the structured event log — barrier entries are exactly the
    "where was everyone" markers a crash postmortem reads, and they are
    control-plane-rare by construction."""
    if site.startswith("barrier."):
        from .. import telemetry

        telemetry.record_event("barrier_enter", site=site,
                               **{k: str(v) for k, v in ctx.items()})
    inj = get_injector()
    if inj.enabled:
        inj.fire(site, **ctx)


def maybe_corrupt(site: str, data: bytes, **ctx) -> bytes:
    """Instrumented-payload hook: applies any armed corrupt rule."""
    inj = get_injector()
    if inj.enabled:
        return inj.corrupt(site, data, **ctx)
    return data
