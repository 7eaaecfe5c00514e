"""Small shared utilities: Split, HashCombine, timer (the port's copy of
``dmlc_tpu/common.py``; reference include/dmlc/common.h:20-45 and
include/dmlc/timer.h:23-49).
"""

from __future__ import annotations

import time
from typing import List

__all__ = ["split", "hash_combine", "get_time"]


def split(s: str, delim: str) -> List[str]:
    """Split string by a single-char delimiter, dropping empty trailing field
    the way ``std::getline`` loops do (common.h:20-35)."""
    if s == "":
        return []
    out = s.split(delim)
    # std::getline-based splitting yields no trailing empty token for "a,b,"
    if out and out[-1] == "" and s.endswith(delim):
        out.pop()
    return out


def hash_combine(seed: int, value: int) -> int:
    """Boost-style hash combine (common.h:39-45), 64-bit wrap."""
    mask = 0xFFFFFFFFFFFFFFFF
    return (seed ^ (value + 0x9E3779B9 + ((seed << 6) & mask)
                    + (seed >> 2))) & mask


def get_time() -> float:
    """Seconds from a monotonic high-resolution clock (timer.h:23-49)."""
    return time.perf_counter()
