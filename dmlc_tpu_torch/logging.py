"""glog-style leveled logging with a pluggable sink.

The port of ``dmlc_tpu/logging.py``: dmlc-core's include/dmlc/logging.h:104-155
(LOG(severity) macros) and the ``CustomLogMessage`` pluggable sink
(logging.h:233-252). Severity FATAL raises
:class:`dmlc_tpu_torch.base.DMLCError` (the ``DMLC_LOG_FATAL_THROW=1``
behavior dmlc-core defaults to for library use) — but only AFTER the
formatted line reaches the sink/stderr, so the last words of a dying rank
are in its log, not just in a traceback some launcher may have swallowed.

Lines carry date, time, thread name, and (when ``DMLC_TASK_ID`` or
``DMLC_RANK`` is set — read once) a rank prefix, so interleaved multi-rank
output stays attributable:

    [2026-08-03 14:02:11] r3 INFO Thread-2: feed: 120 MB to device
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional

from .base import DMLCError, get_env
from .concurrency import make_lock

__all__ = ["log", "info", "warning", "error", "fatal", "set_log_sink", "set_verbosity"]

_LEVELS = {"DEBUG": 0, "INFO": 1, "WARNING": 2, "ERROR": 3, "FATAL": 4}
_lock = make_lock("logging._lock")
_sink: Optional[Callable[[str], None]] = None
_verbosity = 1  # default: INFO and above
_rank_prefix: Optional[str] = None  # lazy: env read once at first format


def set_log_sink(sink: Optional[Callable[[str], None]]) -> None:
    """Install a custom sink receiving fully-formatted lines (analog of
    ``CustomLogMessage::Log``, logging.h:233-252). ``None`` restores stderr."""
    global _sink
    _sink = sink


def set_verbosity(level: str) -> None:
    global _verbosity
    _verbosity = _LEVELS[level.upper()]


def _get_rank_prefix() -> str:
    """Rank tag from DMLC_TASK_ID / DMLC_RANK, resolved once — worker env
    is fixed at launch, and the hot path must not hit os.environ per line."""
    global _rank_prefix
    if _rank_prefix is None:
        rank = get_env("DMLC_TASK_ID", "") or get_env("DMLC_RANK", "")
        _rank_prefix = f"r{rank} " if rank not in ("", "NULL") else ""
    return _rank_prefix


def _reset_rank_prefix_cache() -> None:
    """Drop the cached rank prefix (test hook; workers never need this)."""
    global _rank_prefix
    _rank_prefix = None


def _format(level: str, msg: str) -> str:
    ts = time.strftime("%Y-%m-%d %H:%M:%S")
    thread = threading.current_thread().name
    return f"[{ts}] {_get_rank_prefix()}{level} {thread}: {msg}"


def _emit(line: str) -> None:
    with _lock:
        if _sink is not None:
            _sink(line)
        else:
            print(line, file=sys.stderr, flush=True)


def log(level: str, msg: str) -> None:
    level = level.upper()
    if level != "FATAL" and _LEVELS[level] < _verbosity:
        return
    # FATAL always emits (glog semantics: FATAL cannot be suppressed) and
    # emits BEFORE raising — a FATAL that only surfaced as an exception
    # never reached the installed sink at all
    _emit(_format(level, msg))
    if level == "FATAL":
        # a FATAL is this process's last words: when DMLC_POSTMORTEM_DIR
        # is configured, dump the flight record (snapshot + open spans +
        # event tail) before the raise unwinds anything (no-op + never
        # raises otherwise — dying must not become hanging)
        from .telemetry import postmortem

        postmortem.dump(f"FATAL: {msg}")
        raise DMLCError(msg)


def info(msg: str) -> None:
    log("INFO", msg)


def warning(msg: str) -> None:
    log("WARNING", msg)


def error(msg: str) -> None:
    log("ERROR", msg)


def fatal(msg: str) -> None:
    """Logs the line, then raises DMLCError (DMLC_LOG_FATAL_THROW
    behavior, base.h:20-22)."""
    log("FATAL", msg)
