"""Unified retry/backoff policy (exponential + jitter + deadline; the
port of ``dmlc_tpu/resilience/retry.py``).

One :class:`RetryPolicy` gives every call site the same backoff shape,
error classification and telemetry counters, with per-call-site attempt
counts tunable through their env vars (``DMLC_CLIENT_RETRIES``, ...).

Classification contract (``default_retryable``):

  * an explicit ``transient`` attribute on the exception wins;
  * a ``status`` attribute (an HTTP code) is retryable iff it is in
    :data:`TRANSIENT_HTTP`;
  * connection-shaped OS errors (``ConnectionError``, timeouts,
    ``urllib.error.URLError``) are retryable;
  * path-shaped OS errors (``FileNotFoundError``, ``PermissionError``,
    ...) and everything else are permanent.

Callers must only route idempotent operations through blind retry; a
call site with recovery work between attempts uses only this module's
backoff/classification pieces (:meth:`RetryPolicy.sleep_for`).
"""

from __future__ import annotations

import random
import time
import urllib.error
from typing import Callable, Optional

__all__ = ["TRANSIENT_HTTP", "RetryPolicy", "default_retryable"]

#: HTTP statuses worth a blind resend of an idempotent request.
TRANSIENT_HTTP = {408, 429, 500, 502, 503, 504}

# OSError subclasses that describe the *path*, not the transport: a
# retry cannot make a missing file appear or a permission materialize
_PERMANENT_OS = (FileNotFoundError, PermissionError, IsADirectoryError,
                 NotADirectoryError, FileExistsError)


def default_retryable(exc: BaseException) -> bool:
    """True when ``exc`` describes a condition a retry can fix."""
    explicit = getattr(exc, "transient", None)
    if explicit is not None:
        return bool(explicit)
    status = getattr(exc, "status", None)
    if status is not None:
        return status in TRANSIENT_HTTP
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in TRANSIENT_HTTP
    if isinstance(exc, _PERMANENT_OS):
        return False
    # ConnectionError, socket.timeout (== TimeoutError), DNS failures
    # (URLError wraps them), and the rest of the OSError family are
    # transport conditions: retryable
    return isinstance(exc, (OSError, urllib.error.URLError))


def _env_float(name: Optional[str], default: float) -> float:
    if not name:
        return default
    from ..base import get_env

    return get_env(name, float(default))


class RetryPolicy:
    """Exponential backoff + jitter + deadline + error classification.

    ``attempts`` bounds total tries (1 = no retry).  Delay before retry
    ``i`` (0-based) is ``min(base_s * multiplier**i, max_s)`` plus up to
    ``jitter`` of itself (decorrelates gang-wide retry storms: 64
    workers hitting the same 503 must not resend in lockstep).
    ``deadline_s`` bounds the whole call including sleeps.  Every retry
    increments the ``resilience.retries`` telemetry counter (plus a
    per-``name`` counter), so /metrics shows retry pressure per backend.
    """

    def __init__(self, attempts: int = 4, base_s: float = 0.25,
                 multiplier: float = 2.0, max_s: float = 30.0,
                 jitter: float = 0.1, deadline_s: Optional[float] = None,
                 retryable: Optional[Callable[[BaseException], bool]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 name: Optional[str] = None):
        self.attempts = max(1, int(attempts))
        self.base_s = float(base_s)
        self.multiplier = float(multiplier)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self.deadline_s = deadline_s
        self.name = name
        self._retryable = retryable or default_retryable
        self._sleep = sleep

    @classmethod
    def from_env(cls, retries_env: str = "DMLC_RETRY_ATTEMPTS",
                 default_attempts: int = 4,
                 base_env: Optional[str] = None,
                 default_base: float = 0.25,
                 name: Optional[str] = None,
                 **kwargs) -> "RetryPolicy":
        """Build a policy from env knobs.  ``retries_env`` keeps each
        call site's historical variable (``DMLC_S3_RETRIES``, ...);
        the shared shape knobs apply everywhere:

          DMLC_RETRY_MAX_S       backoff ceiling (default 30)
          DMLC_RETRY_DEADLINE_S  overall deadline (default: none)
        """
        from ..base import get_env

        attempts = get_env(retries_env, int(default_attempts))
        base = _env_float(base_env, default_base)
        max_s = _env_float("DMLC_RETRY_MAX_S", kwargs.pop("max_s", 30.0))
        kwargs.setdefault("deadline_s",
                          get_env("DMLC_RETRY_DEADLINE_S", None, float))
        return cls(attempts=attempts, base_s=base, max_s=max_s,
                   name=name, **kwargs)

    # ---- pieces (for call sites that keep a custom loop) ---------------
    def is_retryable(self, exc: BaseException) -> bool:
        return self._retryable(exc)

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based), jittered."""
        d = min(self.base_s * (self.multiplier ** attempt), self.max_s)
        if self.jitter > 0:
            d += random.random() * self.jitter * d
        return d

    def sleep_for(self, attempt: int,
                  error: Optional[BaseException] = None) -> None:
        """Count one retry and sleep its backoff — the building block
        for call sites with recovery work between attempts (the GCS
        committed-range probe)."""
        self._count_retry(error)
        self._sleep(self.delay(attempt))

    def _count_retry(self, error: Optional[BaseException]) -> None:
        from .. import telemetry

        telemetry.inc("resilience", "retries")
        if self.name:
            telemetry.inc("resilience", f"retries_{self.name}")
        if error is not None:
            telemetry.inc("resilience", "retryable_errors")
        telemetry.record_event(
            "retry", policy=self.name or "anonymous",
            error=repr(error) if error is not None else None)

    # ---- the loop -------------------------------------------------------
    def call(self, fn: Callable, on_retry: Optional[Callable] = None):
        """Run ``fn()`` with retry.  Non-retryable errors raise
        immediately; retryable ones raise once attempts or the deadline
        are exhausted (the LAST error, with its context intact).
        ``on_retry(exc, attempt)`` runs before each backoff sleep."""
        start = time.monotonic()
        for i in range(self.attempts):
            try:
                return fn()
            except Exception as e:
                if not self._retryable(e) or i + 1 >= self.attempts:
                    raise
                d = self.delay(i)
                if self.deadline_s is not None and \
                        time.monotonic() - start + d > self.deadline_s:
                    raise
                self._count_retry(e)
                if on_retry is not None:
                    on_retry(e, i)
                self._sleep(d)
        raise RuntimeError("unreachable: retry loop fell through")
