"""Crash postmortems: dump a dying rank's last seconds to disk (the port
of ``dmlc_tpu/telemetry/postmortem.py``: same file names and keys, so the
launcher of either package reads the other's dumps).

When a rank dies, its telemetry dies with it — the tracker keeps the
survivors' view, but the most interesting rank in a failure is the one
that stopped heartbeating.  This module writes that rank's black box to
``DMLC_POSTMORTEM_DIR`` at death: the full telemetry snapshot, the
spans every thread was INSIDE (open spans), the last-N finished spans,
and the structured event tail (telemetry.events) — enough to see what
the rank was doing, for how long, and what control-plane transitions
led up to it.

Hooked in four places (``install()`` wires the first three; the fault
injector calls :func:`dump` directly):

  * fatal signals the process can still run Python under (SIGTERM,
    SIGQUIT, SIGABRT): dump, then re-deliver with the default handler
    so the exit status stays signal-shaped;
  * hard faults (SIGSEGV et al) via ``faulthandler.enable`` into a
    per-pid file in the same directory (no Python can run, so the
    native tracebacks are the best available);
  * unhandled exceptions via a chained ``sys.excepthook``;
  * ``FaultInjector``'s ``kill`` action dumps before ``os._exit`` —
    a REAL SIGKILL is unhookable, so the injector's dump is what makes
    the simulated preemption observable (and what the chaos smoke
    asserts on).

Everything is best-effort and raise-free: a postmortem path must never
turn a dying process into a hung one.  The launcher scans the directory
after a failed task and logs what the dead rank left behind
(``tracker.launch.collect_postmortems``).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
from typing import Dict, List, Optional

from ..base import get_env
from . import core, events
from ..concurrency import make_lock

__all__ = ["ENV_DIR", "postmortem_dir", "dump", "install",
           "list_dumps", "set_rank", "uninstall"]

ENV_DIR = "DMLC_POSTMORTEM_DIR"

# signals we can still run Python under; SIGKILL is unhookable by design
DEFAULT_SIGNALS = ("SIGTERM", "SIGQUIT", "SIGABRT")

_lock = make_lock("postmortem._lock")
_installed_dir: Optional[str] = None
_faulthandler_file = None
_prev_excepthook = None
_dump_count = 0
_rank: Optional[int] = None  # rendezvous rank, set by HeartbeatSender


def set_rank(rank) -> None:
    """Record this process's RENDEZVOUS rank for dump attribution.

    The env fallback (DMLC_TASK_ID) is the launcher's task id, which the
    tracker's locality-sorted rank assignment does not promise to match
    — a postmortem tagged with the wrong rank sends the reader to the
    wrong machine.  HeartbeatSender calls this once the rank is known."""
    global _rank
    if rank is not None and int(rank) >= 0:
        _rank = int(rank)


def postmortem_dir(directory: Optional[str] = None) -> Optional[str]:
    """Resolve the dump directory: explicit arg > installed dir > env."""
    return directory or _installed_dir or get_env(ENV_DIR, "") or None


def _identity() -> Dict:
    if _rank is not None:
        rank: Optional[str] = str(_rank)
    else:
        rank = get_env("DMLC_TASK_ID", "") or get_env("DMLC_RANK", "")
        if rank in ("", "NULL"):
            rank = None
    return {
        "pid": os.getpid(),
        "rank": rank,
        "attempt": get_env("DMLC_NUM_ATTEMPT", None, str),
        "role": get_env("DMLC_ROLE", None, str),
        "argv": list(sys.argv),
    }


def dump(reason: str, directory: Optional[str] = None,
         last_spans: int = 256, last_events: int = 256) -> Optional[str]:
    """Write one postmortem JSON file; returns its path, or None when no
    directory is configured or the write failed (never raises — this
    runs on crash paths)."""
    global _dump_count
    d = postmortem_dir(directory)
    if not d:
        return None
    try:
        os.makedirs(d, exist_ok=True)
        with _lock:
            _dump_count += 1
            n = _dump_count
        ident = _identity()
        tag = f"r{ident['rank']}" if ident["rank"] is not None else "rX"
        path = os.path.join(
            d, f"postmortem-{tag}-pid{os.getpid()}-{n}.json")
        doc = {
            "reason": str(reason),
            "time": time.time(),
            "anchor_epoch": core.anchor_epoch(),
            **ident,
            "open_spans": core.open_spans(),
            "spans": core.spans()[-last_spans:],
            "events": events.events_tail(last_events),
            "telemetry": core.snapshot(include_buckets=False),
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # readers never see a torn dump
        return path
    except Exception:  # noqa: BLE001 - crash path: swallow, see docstring
        return None


def _on_signal(signum, frame):
    dump(f"signal {signal.Signals(signum).name}")
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)  # die with the real signal status


def _on_uncaught(exc_type, exc, tb):
    dump(f"unhandled {exc_type.__name__}: {exc}")
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def install(directory: Optional[str] = None) -> bool:
    """Arm the crash hooks when a postmortem directory is configured.

    Idempotent; returns True when armed.  Signal handlers only install
    from the main thread (the interpreter's rule) — elsewhere the
    faulthandler/excepthook halves still arm.
    """
    global _installed_dir, _faulthandler_file, _prev_excepthook
    d = postmortem_dir(directory)
    if not d:
        return False
    with _lock:
        if _installed_dir is not None:
            return True
        _installed_dir = d
    try:
        os.makedirs(d, exist_ok=True)
        import faulthandler

        _faulthandler_file = open(
            os.path.join(d, f"faulthandler-pid{os.getpid()}.log"), "w")
        faulthandler.enable(file=_faulthandler_file)
    except Exception:  # noqa: BLE001 - hooks are best-effort
        pass
    for name in DEFAULT_SIGNALS:
        signum = getattr(signal, name, None)
        if signum is None:
            continue
        try:
            signal.signal(signum, _on_signal)
        except (ValueError, OSError):  # non-main thread / exotic platform
            pass
    _prev_excepthook = sys.excepthook
    sys.excepthook = _on_uncaught
    return True


def uninstall() -> None:
    """Disarm (test isolation): restore excepthook, close faulthandler,
    reset signal handlers to default, forget the recorded rank."""
    global _installed_dir, _faulthandler_file, _prev_excepthook, _rank
    _rank = None
    with _lock:
        if _installed_dir is None:
            return
        _installed_dir = None
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
    try:
        import faulthandler

        faulthandler.disable()
    except Exception:  # noqa: BLE001
        pass
    if _faulthandler_file is not None:
        try:
            _faulthandler_file.close()
        except OSError:
            pass
        _faulthandler_file = None
    for name in DEFAULT_SIGNALS:
        signum = getattr(signal, name, None)
        if signum is None:
            continue
        try:
            if signal.getsignal(signum) is _on_signal:
                signal.signal(signum, signal.SIG_DFL)
        except (ValueError, OSError):
            pass


def list_dumps(directory: Optional[str] = None) -> List[str]:
    """Postmortem JSON files in the directory, oldest first."""
    d = postmortem_dir(directory)
    if not d or not os.path.isdir(d):
        return []
    paths = [os.path.join(d, f) for f in os.listdir(d)
             if f.startswith("postmortem-") and f.endswith(".json")]
    return sorted(paths, key=lambda p: (os.path.getmtime(p), p))
