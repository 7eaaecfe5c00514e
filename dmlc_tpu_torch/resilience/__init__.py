"""dmlc_tpu_torch.resilience: unified retry/backoff + deterministic fault
injection (the port of ``dmlc_tpu/resilience``, same knobs and counters).

  * ``retry``  — :class:`RetryPolicy`: exponential backoff with jitter,
                 an overall deadline, and retryable-error classification
                 (transient HTTP codes, connection errors, explicit
                 ``transient`` markers on an exception).  The tracker
                 client's dials ride it.  Every retry increments the
                 ``resilience`` telemetry counters.
  * ``fault``  — :class:`FaultInjector`: env/config-driven deterministic
                 fault injection (``DMLC_FAULT_SPEC``).  Instrumented
                 sites call :func:`fault_point` (drop a connection,
                 delay a response, kill the process at a named barrier)
                 or :func:`maybe_corrupt` (corrupt a storage response).
                 Free when unset.

Not ported yet: ``selfheal`` (the self-healing training loop's
``SelfHealGuard``, ROADMAP.md Queue 1 item 8).

Typical use::

    from dmlc_tpu_torch.resilience import RetryPolicy, fault_point

    policy = RetryPolicy.from_env(retries_env="DMLC_CLIENT_RETRIES")
    sock = policy.call(lambda: dial(...))

    fault_point("barrier.epoch_end", rank=rank, attempt=attempt)
"""

from .fault import (  # noqa: F401
    FaultInjected,
    FaultInjector,
    fault_point,
    get_injector,
    install_injector,
    maybe_corrupt,
    reset_injector,
)
from .retry import (  # noqa: F401
    TRANSIENT_HTTP,
    RetryPolicy,
    default_retryable,
)

__all__ = [
    "FaultInjected",
    "FaultInjector",
    "RetryPolicy",
    "TRANSIENT_HTTP",
    "default_retryable",
    "fault_point",
    "get_injector",
    "install_injector",
    "maybe_corrupt",
    "reset_injector",
]
