"""The traced run's device timeline, from ``torch.profiler``.

A ``Trace`` records the device's activities (kernels, copies, fills)
between ``start()`` and ``stop()`` and reads the raw events once: the
device's busy seconds (the union of its activities' intervals), each
kernel by name, and the operations that took most device time.  Tracing
host ops costs the host more than the step it watches (the train step
issues ~10,000 aten calls), so ``host=True`` is for a separate short
slice that only names the idle gaps: each gap by the innermost host op
that the thread launching the next device activity was inside.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
_LAUNCH = {"cuda_runtime", "cuda_driver"}
_GAPS_NAMED = 5000      # the longest gaps whose host op is looked up
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def _kind(e) -> str:
    """An event's activity type; older builds of the profiler lack
    ``activity_type``, so it is worked out from the device and name."""
    f = getattr(e, "activity_type", None)
    if f is not None:
        return f()
    from torch.autograd import DeviceType

    ua = getattr(e, "is_user_annotation", None)
    annotation = bool(ua()) if ua is not None else False
    if e.device_type() == DeviceType.CUDA:
        return "gpu_user_annotation" if annotation else "kernel"
    if _RUNTIME.match(e.name()):
        return "cuda_runtime"
    return "user_annotation" if annotation else "cpu_op"


def short_name(name: str) -> str:
    """A kernel's name without its namespaces' noise, template arguments
    and parameters."""
    name = re.sub(r"^void ", "", name)
    name = name.replace("(anonymous namespace)::", "")
    for sep in ("<", "("):
        i = name.find(sep)
        if i > 0:
            name = name[:i]
    return name[:96]


def _top(d: Dict[str, float]) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


class Trace:
    def __init__(self, host: bool = False):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
        kw = {}
        if host or not acts:
            acts.append(ProfilerActivity.CPU)
            try:
                kw["experimental_config"] = \
                    torch._C._profiler._ExperimentalConfig(
                        profile_all_threads=True)
            except (AttributeError, TypeError):
                pass
        self._prof = profile(activities=acts, **kw)
        self.t0 = self.t1 = None
        self.wall0_ns = self.wall1_ns = None

    def start(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.start()
        self.wall0_ns = time.time_ns()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.wall1_ns = time.time_ns()
        self._prof.stop()

    def _events(self):
        lo, hi = self.wall0_ns, self.wall1_ns
        dev: List[Tuple[int, int, str, int]] = []
        launch_tid: Dict[int, int] = {}
        host = defaultdict(list)
        for e in self._prof.profiler.kineto_results.events():
            kind = _kind(e)
            if kind in _DEVICE:
                s = e.start_ns()
                t = s + e.duration_ns()
                s, t = max(s, lo), min(t, hi)
                if t > s:
                    dev.append((s, t, e.name(), e.correlation_id()))
            elif kind in _LAUNCH:
                launch_tid[e.correlation_id()] = e.start_thread_id()
            elif kind in ("cpu_op", "user_annotation"):
                s = e.start_ns()
                host[e.start_thread_id()].append(
                    (s, s + e.duration_ns(), e.name()))
        dev.sort()
        return dev, launch_tid, host

    @staticmethod
    def _gaps(dev, lo: int, hi: int):
        """``(busy ns, [(gap ns, gap start, correlation id of the
        activity after it)])``."""
        busy, gaps = 0, []
        cur_s = cur_t = None
        prev_end = lo
        for s, t, _, corr in dev:
            if cur_t is None or s > cur_t:
                if cur_t is not None:
                    busy += cur_t - cur_s
                if s > prev_end:
                    gaps.append((s - prev_end, prev_end, corr))
                cur_s, cur_t = s, t
            else:
                cur_t = max(cur_t, t)
            prev_end = max(prev_end, t)
        if cur_t is not None:
            busy += cur_t - cur_s
        if hi > prev_end:
            gaps.append((hi - prev_end, prev_end, None))
        return busy, gaps

    def summarize(self) -> Dict:
        """``kernels`` ([(short name, seconds)] of every device activity
        in the window), ``busy_s``, ``window_s``, ``device_ops`` (the 10
        largest, [name, seconds]) and, with host ops traced,
        ``idle_gaps`` (the 10 largest sums of gap seconds by host op)."""
        dev, launch_tid, host = self._events()
        lo, hi = self.wall0_ns, self.wall1_ns
        per_name = defaultdict(float)
        kernels = []
        for s, t, name, _ in dev:
            n = short_name(name)
            per_name[n] += (t - s) / 1e9
            kernels.append((n, (t - s) / 1e9))
        busy, gaps = self._gaps(dev, lo, hi)
        out = {"kernels": kernels, "busy_s": busy / 1e9,
               "window_s": (hi - lo) / 1e9, "device_ops": _top(per_name)}
        if host:
            for ops in host.values():
                ops.sort()
            starts = {tid: [o[0] for o in ops] for tid, ops in host.items()}
            named = defaultdict(float)
            gaps.sort(reverse=True)
            for length, begin, corr in gaps[:_GAPS_NAMED]:
                named[self._host_op(host, starts, launch_tid.get(corr),
                                    begin + length // 2)] += length / 1e9
            for length, _, _ in gaps[_GAPS_NAMED:]:
                named["(shorter gaps)"] += length / 1e9
            out["idle_gaps"] = _top(named)
        return out

    @staticmethod
    def _host_op(host, starts, tid: Optional[int], at: int) -> str:
        """The innermost host op of thread ``tid`` running at ``at``."""
        if tid is None:
            return "(no launch follows)"
        if tid not in host:
            return "(launching thread not traced)"
        ops, st = host[tid], starts[tid]
        i = bisect.bisect_right(st, at) - 1
        for j in range(i, max(-1, i - 400), -1):
            s, t, name = ops[j]
            if t >= at:
                return name
        return "(between host ops)"
