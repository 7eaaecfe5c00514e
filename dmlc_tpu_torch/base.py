"""Error type, ``check`` and typed environment access (the port's own copy
of the names it needs from ``dmlc_tpu/base.py``), and the port's device
rule."""

from __future__ import annotations

import os
from typing import Optional, Type, TypeVar

import torch

__all__ = ["DMLCError", "ParamError", "check", "get_env", "resolve_device"]


class DMLCError(RuntimeError):
    """Exception for all fatal checks (analog of ``dmlc::Error``).

    ``status`` carries a machine-readable code (an HTTP status from the
    filesystem backends, which map a 404 to ``FileNotFoundError``);
    ``transient`` marks a condition a retry can fix (None: derive it from
    ``status``).  ``resilience.default_retryable`` reads both."""

    def __init__(self, *args, status: Optional[int] = None,
                 transient: Optional[bool] = None):
        super().__init__(*args)
        self.status = status
        self.transient = transient


class ParamError(ValueError, DMLCError):
    """An invalid parameter value (analog of ``dmlc::ParamError``)."""


def check(cond, msg="") -> None:
    """Analog of ``CHECK(cond) << msg``: raise :class:`DMLCError` unless
    ``cond`` holds; ``msg`` is a string or a callable that makes one."""
    if not cond:
        raise DMLCError(f"Check failed: {msg() if callable(msg) else msg}")


_T = TypeVar("_T")

_BOOL_TRUE = {"1", "true", "yes", "on"}
_BOOL_FALSE = {"0", "false", "no", "off"}


def get_env(key: str, default: _T, ty: Optional[Type[_T]] = None) -> _T:
    """Typed environment lookup; the type is inferred from ``default``
    unless ``ty`` is given.  An empty value counts as unset for every
    non-str type."""
    val = os.environ.get(key)
    if val is None:
        return default
    ty = ty or type(default)
    if val == "" and ty is not str:
        return default
    if ty is bool:
        low = val.strip().lower()
        if low in _BOOL_TRUE:
            return True  # type: ignore[return-value]
        if low in _BOOL_FALSE:
            return False  # type: ignore[return-value]
        raise DMLCError(f"cannot parse env {key}={val!r} as bool")
    try:
        return ty(val)  # type: ignore[call-arg]
    except (TypeError, ValueError) as exc:
        raise DMLCError(
            f"cannot parse env {key}={val!r} as {ty.__name__}") from exc


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the current CUDA card; raises when no
    card is present rather than carrying on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise DMLCError("no CUDA device: the port runs on the GPU; pass "
                            "device='cpu' to run the plain versions on the "
                            "CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
