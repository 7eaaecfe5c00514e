"""What the metric readers share: the card's peaks, the traced
kernels' seconds by name, and a roofline share."""

from __future__ import annotations

from typing import Iterable, Optional

from . import yardstick


def peak(run) -> Optional[dict]:
    """The card's published peaks, or None off a known card."""
    import torch

    if run.device.type != "cuda":
        return None
    return yardstick.peaks(torch.cuda.get_device_name(run.device))


def kernel_seconds(run, names: Iterable[str]) -> float:
    """Device seconds of the traced kernels whose name holds any of
    ``names``."""
    names = tuple(names)
    ts = run.trace_summary or {}
    return sum(s for n, s in ts.get("kernels", ())
               if any(k in n for k in names))


def roofline(run, bound: float, names: Iterable[str]) -> Optional[float]:
    """``bound`` seconds of the work the traced window needed, over the
    traced seconds of the kernels that did it, in percent; None where
    no such kernel ran."""
    secs = kernel_seconds(run, names)
    if secs <= 0 or bound <= 0:
        return None
    return 100.0 * bound / secs


def idle_percent(run) -> Optional[float]:
    ts = run.trace_summary
    if not ts or ts["window_s"] <= 0 or ts["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ts["busy_s"] / ts["window_s"])


def served(run) -> list:
    return run.work.get("requests", [])


def decode_shapes(run, key: str = "shapes") -> list:
    return [x for op, x in run.work.get(key, ()) if op == "decode"]


def prefill_shapes(run, key: str = "shapes") -> list:
    return [x for op, x in run.work.get(key, ()) if op == "prefill"]
