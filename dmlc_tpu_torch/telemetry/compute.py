"""Compute observability: the site ledger, counted cost and roofline,
device memory, phases.

Port of ``dmlc_tpu/telemetry/compute.py``, with its public names,
documents, gauges and Prometheus families.  The step ledger
(``telemetry.steps``) and the request ledger decompose a step into
feed / collective / device residual and a request into queue / prefill
/ decode; this module opens the residual along four axes:

  * **site ledger** — :func:`profiled_site` wraps every entry point the
    port owns that the reference wraps in ``profiled_jit`` (the train
    step, the serving programs, the feed's expander).  The port has no
    jit, so a *trace* is the first call of a (shape, dtype) signature:
    its wall is booked as the site's compile time and a
    ``compile:<site>`` span.  In eager PyTorch that wall is what a first
    use costs: the build or load of the CUDA kernels, the caching
    allocator's growth, cuBLAS's first choice of algorithm, and the
    cost pass below.  Cache hits, traces past the first (recompiles),
    the signature that caused each, and signature churn inside a
    sliding window (a *recompile storm*, the tracker watchdog's
    ``recompile_storm`` kind) follow the reference.
  * **cost/roofline ledger** — in place of XLA's cost analysis, the
    trace runs under a counting ``TorchDispatchMode`` that sees every
    aten and custom op the call dispatches, its backward included:
    FLOPs from ``torch.utils.flop_counter``'s formulas (matmul-class
    work, what the peak rates count) and from the formulas the port's
    custom ops register (:func:`register_flops`), bytes as each op's
    tensor inputs plus outputs (views count nothing; an indexed op
    counts its indices, values and result, not the tensor it indexes).
    Under ``torch.inference_mode()`` composite ops reach the mode whole:
    einsum and matmul count as one op by formula, the others run their
    decomposition under the mode.
    A kernel launched outside the dispatcher reports its own cost
    (:func:`add_kernel_cost`).  With the per-dtype peaks
    (:func:`telemetry.steps.detect_peaks`) that gives each step ``mfu``,
    ``membw_util`` and a ``bound=compute|memory`` verdict.  The cost is
    the trace's and is reused by every call of its signature.
  * **device memory accounting** — per-card live/peak/limit/headroom
    from the caching allocator's statistics and ``mem_get_info``'s
    total (read once a card), with the reference's host-RSS fallback
    where there is no card.
  * **phase decomposition** — host-measured spans for the host-side
    decode phases (KV gather, sampling) and an analytic split of the
    device residual across attention / MLP / unembed, exported as
    per-phase time shares.

``DMLC_COMPUTE_PROFILE=1`` (default) costs a signature and one dict
lookup a call; ``=0`` makes :func:`profiled_site` return the function
itself.  Deep per-phase tracing (``torch.profiler.record_function``
scopes) sits behind ``DMLC_COMPUTE_TRACE_PHASES=1``.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..base import DMLCError, get_env
from ..concurrency import make_lock
from . import core

__all__ = [
    "PHASES", "profiled_site", "enabled", "phases_enabled", "sites",
    "register_flops", "counting", "add_kernel_cost",
    "roofline", "sample_hbm", "phase", "phase_estimate", "phase_shares",
    "recompiles_total", "status", "report", "prometheus_text",
    "reset_compute",
]

logger = logging.getLogger("dmlc_tpu_torch.telemetry")

# the fixed decode-phase vocabulary: gather + sampling are measured on
# the host (they ARE host work), attention/mlp/unembed split the
# device residual analytically from the model's FLOP breakdown
PHASES = ("gather", "attention", "mlp", "unembed", "sampling")


def enabled() -> bool:
    """Site/cost/HBM ledgers on (the dark-cheap default)."""
    return bool(get_env("DMLC_COMPUTE_PROFILE", True))


def phases_enabled() -> bool:
    """Deep device-phase tracing (profiler scopes) requested."""
    return bool(get_env("DMLC_COMPUTE_TRACE_PHASES", False))


# ---------------------------------------------------------------------------
# cost counting
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops that move no bytes of their own: views the schema does not mark as
# such, allocation without a fill, reads of a scalar the host asked for
_NO_TRAFFIC = {_aten._unsafe_view, _aten._reshape_alias, _aten.empty,
               _aten.empty_like, _aten.empty_strided, _aten.new_empty,
               _aten.new_empty_strided, _aten._local_scalar_dense}
# indexed reads (result = the values read): indices + values + result
_INDEXED_READS = {_aten.index, _aten.index_select, _aten.gather,
                  _aten.embedding, _aten.take}
# indexed writes, keyed to the argument holding the written values:
# indices + values read + values written, never the whole destination
_INDEXED_WRITES = {_aten.index_put: 2, _aten.index_put_: 2,
                   _aten._index_put_impl_: 2, _aten.scatter: 3,
                   _aten.scatter_: 3, _aten.scatter_add: 3,
                   _aten.scatter_add_: 3, _aten.index_add: 3,
                   _aten.index_add_: 3, _aten.index_copy: 3,
                   _aten.index_copy_: 3}

# custom ops' executed FLOPs, by schema name: fn(args, kwargs, out)
_CUSTOM_FLOPS: Dict[str, Callable] = {}


def register_flops(op_name: str, fn: Callable) -> None:
    """Register ``fn(args, kwargs, out) -> FLOPs`` for the custom op
    ``op_name`` (``"namespace::name"``), which the dispatch mode sees
    as one op: the kernels it launches are not dispatched."""
    _CUSTOM_FLOPS[op_name] = fn


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensor_bytes(x) -> int:
    """Bytes of the tensors in an op's arguments or outputs (tensors,
    nested in lists, tuples and dicts)."""
    if isinstance(x, torch.Tensor):
        return _nbytes(x)
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_tensor_bytes(v) for v in x.values())
    return 0


def _einsum_flops(args, kwargs, out) -> float:
    """A two-operand einsum's products: 2 x the product of every index's
    size when an index is summed, else none (elementwise)."""
    eq, ops = args[0].replace(" ", ""), args[1]
    lhs, rhs = eq.split("->")
    terms = lhs.split(",")
    sizes = {}
    for term, op in zip(terms, ops):
        sizes.update(zip(term, op.shape))
    if not set(sizes) - set(rhs):
        return 0.0
    n = 2.0
    for v in sizes.values():
        n *= v
    return n


def _matmul_flops(args, kwargs, out) -> float:
    a = args[0]
    return 2.0 * max(out.numel(), 1) * a.shape[-1]


# composite matmul-class ops counted whole, by formula: decomposing them
# under the mode (their bmm/mm) costs several times the op itself
_WHOLE = {_aten.einsum: _einsum_flops, _aten.matmul: _matmul_flops}


def _counted_whole(func, args) -> bool:
    """Whether a composite op is counted as one op (a two-operand einsum
    without an ellipsis, a matmul) rather than decomposed."""
    packet = func._overloadpacket
    if packet is _aten.matmul:
        return True
    return (packet is _aten.einsum and len(args[1]) == 2
            and "." not in args[0])


def _op_flops(func, args, kwargs, out) -> float:
    packet = func._overloadpacket
    fn = flop_registry.get(packet)
    if fn is not None:
        return float(fn(*args, **kwargs, out_val=out))
    fn = _WHOLE.get(packet) or _CUSTOM_FLOPS.get(func._schema.name)
    return float(fn(args, kwargs, out)) if fn is not None else 0.0


def _op_bytes(func, args, kwargs, out) -> int:
    packet = func._overloadpacket
    if func.is_view or packet in _NO_TRAFFIC:
        return 0
    if packet in _INDEXED_READS:
        idx = _tensor_bytes(args[1:]) + _tensor_bytes(kwargs)
        return idx + 2 * _tensor_bytes(out)
    at = _INDEXED_WRITES.get(packet)
    if at is not None:
        # args[0] is the destination; what is written is the values
        vals = args[at] if len(args) > at else kwargs.get("src", 0)
        rest = [a for i, a in enumerate(args[1:], 1) if i != at]
        return (_tensor_bytes(rest) + _tensor_bytes(kwargs)
                + 2 * _tensor_bytes(vals))
    if packet is _aten.copy_:
        # reads the source, writes the destination (a view's elements)
        return _nbytes(args[0]) + _tensor_bytes(args[1])
    return _tensor_bytes((args, kwargs)) + _tensor_bytes(out)


_composites: Dict[Any, bool] = {}


def _composite(func) -> bool:
    """Whether ``func`` runs as its CompositeImplicitAutograd
    decomposition on a dense CPU or CUDA tensor (no kernel of its own
    for either backend)."""
    got = _composites.get(func)
    if got is None:
        has = torch._C._dispatch_has_kernel_for_dispatch_key
        name = func.name()
        got = _composites[func] = (
            has(name, "CompositeImplicitAutograd")
            and not has(name, "CPU") and not has(name, "CUDA"))
    return got


_active = threading.local()


class _CostMode(TorchDispatchMode):
    """Counts the FLOPs and bytes of every op dispatched under it.  The
    op runs first, exactly as it would without the mode; a failure of
    the count is kept in ``failed`` and never raised."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.failed: Optional[BaseException] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func) and not _counted_whole(func, args):
            # under inference mode a composite op (to, softmax, reshape)
            # reaches the mode whole; its decomposition is the kernel
            # that would run, so run it under the mode and count the ops
            # it is made of
            with self:
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        if self.failed is None:
            try:
                self.flops += _op_flops(func, args, kwargs, out)
                self.bytes += _op_bytes(func, args, kwargs, out)
            except Exception as e:  # noqa: BLE001 - never breaks a call
                self.failed = e
        return out

    def run(self, fn, args, kwargs):
        prev = getattr(_active, "mode", None)
        _active.mode = self
        try:
            with self:
                return fn(*args, **kwargs)
        finally:
            _active.mode = prev

    def cost(self) -> Optional[Dict]:
        if self.failed is not None:
            return None
        return {"flops": self.flops, "bytes_accessed": self.bytes}


def counting() -> bool:
    """Whether a cost pass runs on this thread (a kernel launched
    outside the dispatcher then reports its cost)."""
    return getattr(_active, "mode", None) is not None


def add_kernel_cost(flops: float, nbytes: float) -> None:
    """Book a kernel the dispatch mode cannot see (a ctypes launch) on
    this thread's cost pass; a no-op outside one."""
    mode = getattr(_active, "mode", None)
    if mode is not None:
        mode.flops += float(flops)
        mode.bytes += float(nbytes)


# ---------------------------------------------------------------------------
# site ledger
# ---------------------------------------------------------------------------

_lock = make_lock("compute._lock")
_sites: Dict[str, "_ProfiledSite"] = {}

# str(dtype) per leaf per call is the signature's hot cost; dtypes are a
# tiny closed set, so memoize the conversion
_dtype_strs: Dict = {}


def _dtype_str(dt) -> str:
    s = _dtype_strs.get(dt)
    if s is None:
        s = _dtype_strs[dt] = str(dt).replace("torch.", "")
    return s


def _leaf_sig(x) -> Tuple:
    """A tensor keys on (shape, dtype, device type); any other leaf on
    its value (eager PyTorch has no traced scalars: a Python number can
    change what runs)."""
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), _dtype_str(x.dtype), x.device.type)
    return ("v", x)


def _sig_text(key) -> str:
    """Compact human-readable signature: what a recompile is
    attributed to in spans, logs and /compute."""
    parts = []
    for item in key:
        kind, body = item[0], item[1]
        if kind == "static":
            parts.append(f"static:{body!r:.40}")
        elif kind == "module":
            parts.append(f"{body[0]}[{len(body[1])} tensors]")
        else:
            parts.append(",".join(
                "x".join(map(str, leaf[1])) + ":" + leaf[2]
                if leaf[0] == "t" else f"{leaf[1]!r:.20}"
                for leaf in body) or "()")
    return ";".join(parts)


class _ProfiledSite:
    """An entry point with a site ledger attached.

    Each call keys on the signature of its positional arguments (see
    :func:`profiled_site`); a signature seen before is a hit and calls
    the function directly, a fresh one is a trace and runs it once
    under the cost pass.  A failed cost pass (an op the counter cannot
    read) is counted in ``aot_fallbacks`` (the reference's key) and
    leaves the signature without a cost; so is an argument that cannot
    key a signature, whose call then runs uncounted.  Neither changes
    what runs or raises."""

    def __init__(self, fn, *, site: str, static_argnums=(),
                 max_signatures: Optional[int] = None):
        self._fn = fn
        self.site = str(site)
        self._static = tuple(int(i) for i in static_argnums)
        self._max_sigs = max_signatures
        self._lock = make_lock("_ProfiledSite._lock")
        self._cache: Dict[Any, Optional[Dict]] = {}
        self.traces = 0
        self.hits = 0
        self.recompiles = 0
        self.aot_fallbacks = 0
        self.compile_secs_total = 0.0
        self.last_cost: Optional[Dict] = None
        self.last_signature: Optional[str] = None
        self._trace_times: deque = deque(maxlen=256)
        # memo for the REPEATED module argument (the model every serving
        # call passes), held weakly so a site never keeps a model alive;
        # a module's parameter shapes do not change without it being
        # rebuilt
        self._module_sigs: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        with _lock:
            _sites[self.site] = self

    # -- signature ------------------------------------------------------
    def _signature(self, args) -> Tuple:
        parts = []
        for i, a in enumerate(args):
            if i in self._static:
                parts.append(("static", a))
            elif isinstance(a, torch.nn.Module):
                with self._lock:
                    part = self._module_sigs.get(a)
                if part is None:
                    part = ("module", (type(a).__name__, tuple(
                        (name,) + _leaf_sig(t) for name, t in
                        a.state_dict(keep_vars=True).items())))
                    with self._lock:
                        self._module_sigs[a] = part
                parts.append(part)
            elif isinstance(a, (torch.Tensor, int, float, str, type(None))):
                parts.append(("args", (_leaf_sig(a),)))
            else:   # a container: its leaves and its structure
                leaves, spec = tree_flatten(a)
                parts.append(("args", tuple(_leaf_sig(x) for x in leaves),
                              str(spec)))
        return tuple(parts)

    # -- trace (cache miss) ---------------------------------------------
    def _trace(self, key, args, kwargs):
        with self._lock:
            if (self._max_sigs is not None
                    and len(self._cache) >= self._max_sigs):
                raise DMLCError(
                    f"site {self.site!r} hit its signature cap: "
                    f"{len(self._cache)} distinct signatures (new: "
                    f"{_sig_text(key)}) — every novel signature is a "
                    f"first use and a cost pass; bucket the inputs or "
                    f"raise the cap")
        sig = _sig_text(key)
        mode = _CostMode()
        t0 = time.perf_counter()
        out = mode.run(self._fn, args, kwargs)
        t1 = time.perf_counter()
        cost = mode.cost()
        with self._lock:
            if key in self._cache:   # another thread traced it meanwhile
                self.hits += 1
                self.last_cost = self._cache[key]
                return out
            if cost is None:
                self.aot_fallbacks += 1
            self.traces += 1
            n_traces = self.traces
            n_recompiles = self.recompiles = self.traces - 1
            self._trace_times.append((time.time(), sig))
            self.compile_secs_total += t1 - t0
            self.last_signature = sig
            self.last_cost = cost
            self._cache[key] = cost
        if cost is None:
            core.inc("compute", "aot_fallbacks")
            logger.warning("compute: cost pass at site %s failed: %r",
                           self.site, mode.failed)
        core.observe_duration("compute", "compile", t1 - t0)
        core.record_span(f"compile:{self.site}", stage="compute",
                         t0=t0, t1=t1,
                         args={"site": self.site, "signature": sig,
                               "trace": n_traces})
        if n_recompiles:
            logger.info("compute: recompile #%d at site %s for "
                        "signature %s (%.3fs)", n_recompiles,
                        self.site, sig, t1 - t0)
        return out

    # -- dispatch --------------------------------------------------------
    def __call__(self, *args, **kwargs):
        try:
            key = self._signature(args)
            hash(key)  # unhashable static args surface HERE, not below
        except TypeError:
            with self._lock:
                self.aot_fallbacks += 1
            core.inc("compute", "aot_fallbacks")
            return self._fn(*args, **kwargs)
        with self._lock:
            hit = key in self._cache
            if hit:
                self.hits += 1
                self.last_cost = self._cache[key]
        if hit:
            return self._fn(*args, **kwargs)
        return self._trace(key, args, kwargs)

    # -- views -----------------------------------------------------------
    def stats(self) -> Dict:
        with self._lock:
            return {
                "traces": self.traces,
                "hits": self.hits,
                "recompiles": self.recompiles,
                "aot_fallbacks": self.aot_fallbacks,
                "compile_secs_total": round(self.compile_secs_total, 6),
                "signatures": len(self._cache),
                "last_signature": self.last_signature,
                "last_cost": dict(self.last_cost)
                if self.last_cost else None,
            }

    def recent_traces(self, window_s: float) -> int:
        now = time.time()
        with self._lock:
            return sum(1 for t, _ in self._trace_times
                       if now - t <= window_s)

    def reregister(self) -> None:
        """Re-enter the site registry after a test-time
        :func:`reset_compute` orphaned a long-lived wrapper (the
        serving engine caches its programs process-wide)."""
        with _lock:
            _sites.setdefault(self.site, self)


def profiled_site(fn, *, site: str, static_argnums=(),
                  max_signatures: Optional[int] = None):
    """``fn`` with a site ledger attached (the reference's
    ``profiled_jit``).

    The signature is the (shape, dtype, device) of every tensor in the
    positional arguments (nested in lists and tuples too) and the value
    of every other one; an ``nn.Module`` or dict argument keys on its
    tensors' names, shapes and dtypes, memoised by identity; arguments
    at ``static_argnums`` key on their whole value, which must be
    hashable.  Keyword arguments pass through and key nothing: they are
    for what leaves the cost alone (the train step's ``accept``).  A
    site past ``max_signatures`` distinct signatures raises
    :class:`DMLCError` on the next new one.

    With ``DMLC_COMPUTE_PROFILE=0`` this returns ``fn`` itself: no
    wrapper, no registry entry, no per-call cost."""
    if not enabled():
        return fn
    return _ProfiledSite(fn, site=site, static_argnums=static_argnums,
                         max_signatures=max_signatures)


def sites() -> Dict[str, _ProfiledSite]:
    with _lock:
        return dict(_sites)


def recompiles_total() -> int:
    return sum(ps.stats()["recompiles"] for ps in sites().values())


# ---------------------------------------------------------------------------
# recompile storms
# ---------------------------------------------------------------------------

def _storm_params() -> Tuple[float, int]:
    return (get_env("DMLC_COMPUTE_STORM_WINDOW_S", 60.0),
            get_env("DMLC_COMPUTE_STORM_TRACES", 4))


def _storm_doc() -> Dict:
    """Sites whose trace rate inside the sliding window crossed the
    storm threshold.  Counted on *traces* (not recompiles) so a cold
    site churning through fresh signatures trips just as loudly as a
    warm one re-tracing."""
    window_s, threshold = _storm_params()
    hot = []
    for site, ps in sorted(sites().items()):
        n = ps.recent_traces(window_s)
        if n >= threshold:
            hot.append({"site": site, "traces_in_window": n})
    return {"active": bool(hot), "window_s": window_s,
            "threshold": threshold, "sites": hot}


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def roofline(flops: Optional[float], bytes_accessed: Optional[float],
             wall_s: float, peak_flops: Optional[float],
             peak_bw: Optional[float]) -> Dict:
    """Analytic roofline verdict for one measured interval.

    ``bound`` compares the work's arithmetic intensity (FLOPs per byte
    moved) against the machine balance (peak FLOP/s per peak byte/s):
    below the balance point it cannot saturate the ALUs however well it
    is scheduled — it is memory-bound."""
    out: Dict[str, Optional[float]] = {
        "flops": flops, "bytes_accessed": bytes_accessed,
        "intensity": None, "mfu": None, "membw_util": None,
        "bound": None,
    }
    if wall_s <= 0:
        return out
    if flops and bytes_accessed:
        out["intensity"] = flops / bytes_accessed
    if flops and peak_flops:
        out["mfu"] = flops / wall_s / peak_flops
    if bytes_accessed and peak_bw:
        out["membw_util"] = bytes_accessed / wall_s / peak_bw
    if out["intensity"] is not None and peak_flops and peak_bw:
        balance = peak_flops / peak_bw
        out["bound"] = "memory" if out["intensity"] < balance \
            else "compute"
    return out


# ---------------------------------------------------------------------------
# device memory (HBM) accounting
# ---------------------------------------------------------------------------

_hbm_lock = make_lock("compute._hbm_lock")
_last_hbm: Optional[Dict] = None


def _host_rss() -> Dict:
    """Host fallback where there is no card: the process's live/peak
    RSS against total system memory — a proxy, flagged as such
    (``source=host_rss``), but enough that the gauges and the /compute
    schema never go dark on a dev box."""
    live = peak = limit = None
    try:
        import resource

        # ru_maxrss is KiB on linux
        peak = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                     ) * 1024.0
    except (ImportError, OSError):  # non-posix
        pass
    try:
        with open("/proc/self/statm") as f:
            import os as _os

            live = float(f.read().split()[1]) * _os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):  # non-linux
        live = peak
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    limit = float(line.split()[1]) * 1024.0
                    break
    except (OSError, ValueError, IndexError):  # non-linux
        pass
    return {"available": False, "source": "host_rss", "devices": [],
            "live_bytes": live, "peak_bytes": peak,
            "limit_bytes": limit,
            "headroom_bytes": (limit - live)
            if (limit is not None and live is not None) else None}


@functools.lru_cache(maxsize=None)
def _card_total(index: int) -> float:
    """Card ``index``'s memory as ``mem_get_info`` reports it, read once:
    the total never changes, and ``cudaMemGetInfo`` is a driver call
    whose time after a train step varies by orders of magnitude (the
    ``memory_sample`` timings of ``chip_smoke.py``'s train phase), host
    time outside the step ledger's wall."""
    return float(torch.cuda.mem_get_info(index)[1])


def _device_doc() -> Optional[Dict]:
    """The cards' memory from the caching allocator: live is
    ``allocated_bytes.all.current``, peak ``allocated_bytes.all.peak``
    (read from the nested statistics, which skip the flat view's
    copy), the limit ``mem_get_info``'s total; None without a card."""
    if not torch.cuda.is_available():
        return None
    per_dev = []
    for i in range(torch.cuda.device_count()):
        alloc = torch.cuda.memory_stats_as_nested_dict(i).get(
            "allocated_bytes", {}).get("all", {})
        live = float(alloc.get("current", 0))
        peak = float(alloc.get("peak", live))
        limit = _card_total(i)
        per_dev.append({"id": i, "kind": torch.cuda.get_device_name(i),
                        "live_bytes": live, "peak_bytes": peak,
                        "limit_bytes": limit,
                        "headroom_bytes": limit - live})
    if not per_dev:
        return None
    return {"available": True, "source": "device", "devices": per_dev,
            "live_bytes": sum(d["live_bytes"] for d in per_dev),
            "peak_bytes": max(d["peak_bytes"] for d in per_dev),
            "limit_bytes": sum(d["limit_bytes"] for d in per_dev),
            "headroom_bytes": min(d["headroom_bytes"] for d in per_dev)}


def sample_hbm(publish: bool = True) -> Dict:
    """One device-memory sample across local cards (live/peak/limit/
    headroom).

    Returns the device view where there is a card, the host-RSS proxy
    otherwise; optionally publishes the aggregate gauges (sum live, max
    per-card peak, min per-card headroom — the conservative reading for
    an admission decision)."""
    global _last_hbm
    doc = _device_doc() or _host_rss()
    if publish:
        if doc.get("live_bytes") is not None:
            core.set_gauge("compute", "hbm_live_bytes",
                           float(doc["live_bytes"]))
        if doc.get("peak_bytes") is not None:
            core.set_gauge("compute", "hbm_peak_bytes",
                           float(doc["peak_bytes"]))
        if doc.get("headroom_bytes") is not None:
            core.set_gauge("compute", "hbm_headroom_bytes",
                           float(doc["headroom_bytes"]))
    with _hbm_lock:
        _last_hbm = doc
    return doc


# ---------------------------------------------------------------------------
# phase decomposition
# ---------------------------------------------------------------------------

_phase_lock = make_lock("compute._phase_lock")
_phase_secs: Dict[str, float] = {p: 0.0 for p in PHASES}


def _add_phase(name: str, secs: float) -> None:
    if secs <= 0:
        return
    with _phase_lock:
        if name in _phase_secs:
            _phase_secs[name] += secs
    core.set_gauge("compute", f"phase_{name}_share",
                   phase_shares().get(name, 0.0))


@contextlib.contextmanager
def phase(name: str, span: Optional[str] = None):
    """Host-measured phase scope (gather / sampling / ...).

    Always accounts wall time into the phase-share estimate (two clock
    reads); additionally opens a profiler scope (``core.annotate``)
    when deep tracing is on, so the phase shows up as a named region in
    captured profiles.  ``span`` names a ``serving`` span that wraps
    the same code (the engine's ``serving.decode.sample``): it is
    opened in the annotation's place, with or without the ledger, so
    one span and one profiler range serve both."""
    if span is not None:
        ctx = core.span(span, stage="serving", profile=True)
    elif enabled() and phases_enabled():
        ctx = core.annotate(name)
    else:
        ctx = contextlib.nullcontext()
    if not enabled():
        with ctx:
            yield
        return
    t0 = time.perf_counter()
    try:
        with ctx:
            yield
    finally:
        _add_phase(name, time.perf_counter() - t0)


def phase_estimate(shares: Dict[str, float], secs: float) -> None:
    """Split a device-residual interval across phases analytically.

    The device work of a decode step is not split by phase without a
    profiler capture, but the model's FLOP breakdown (attention vs. MLP
    vs. unembed) is exact, so the residual wall time is apportioned by
    it.  The result is an *estimate* and is labeled as one on
    /compute."""
    if not enabled() or secs <= 0 or not shares:
        return
    total = sum(v for v in shares.values() if v and v > 0)
    if total <= 0:
        return
    with _phase_lock:
        for name, v in shares.items():
            if name in _phase_secs and v and v > 0:
                _phase_secs[name] += secs * (v / total)
    for name in shares:
        if name in _phase_secs:
            core.set_gauge("compute", f"phase_{name}_share",
                           phase_shares().get(name, 0.0))


def phase_shares() -> Dict[str, float]:
    """Normalized per-phase time shares (empty before any sample)."""
    with _phase_lock:
        total = sum(_phase_secs.values())
        if total <= 0:
            return {}
        return {p: s / total for p, s in _phase_secs.items()}


# ---------------------------------------------------------------------------
# views: heartbeat status, /compute document, prometheus text
# ---------------------------------------------------------------------------

def status() -> Dict:
    """Small-scalar compute doc shipped with heartbeats (the watchdog's
    ``recompile_storm`` signal plus the headline gauges); empty when
    the profile is off or no site was ever called."""
    if not enabled():
        return {}
    site_map = {s: ps.stats() for s, ps in sites().items()}
    if not site_map:
        return {}
    storm = _storm_doc()
    with _hbm_lock:
        hbm = _last_hbm
    out = {
        "traces": sum(st["traces"] for st in site_map.values()),
        "hits": sum(st["hits"] for st in site_map.values()),
        "recompiles": sum(st["recompiles"] for st in site_map.values()),
        "storm": storm,
    }
    if hbm:
        out["hbm_peak_bytes"] = hbm.get("peak_bytes")
        out["hbm_headroom_bytes"] = hbm.get("headroom_bytes")
    return out


def _step_roofline() -> Dict:
    """The step ledger's roofline view (peaks + latest verdict)."""
    from . import steps

    return steps.ledger().roofline_summary()


def report() -> Dict:
    """The ``GET /compute`` document."""
    site_map = {s: ps.stats() for s, ps in sorted(sites().items())}
    with _hbm_lock:
        hbm = _last_hbm
    return {
        "enabled": enabled(),
        "deep_phase_tracing": phases_enabled(),
        "sites": site_map,
        "traces_total": sum(s["traces"] for s in site_map.values()),
        "cache_hits_total": sum(s["hits"] for s in site_map.values()),
        "recompiles_total": sum(s["recompiles"]
                                for s in site_map.values()),
        "aot_fallbacks_total": sum(s["aot_fallbacks"]
                                   for s in site_map.values()),
        "storm": _storm_doc(),
        "hbm": hbm if hbm is not None else sample_hbm(),
        "phases": {"shares": phase_shares(),
                   "estimated": ("attention", "mlp", "unembed"),
                   "measured": ("gather", "sampling")},
        "roofline": _step_roofline(),
    }


def prometheus_text() -> str:
    """Per-site ledger families as labeled exposition text (the core
    registry cannot label, so these are hand-rendered the same way the
    slo/availability surfaces are)."""
    site_map = {s: ps.stats() for s, ps in sorted(sites().items())}
    if not site_map:
        return ""
    fams = (
        ("dmlc_compute_recompiles_total", "counter",
         "traces beyond a site's first (new signatures), per site",
         "recompiles"),
        ("dmlc_compute_traces_total", "counter",
         "traces (first calls of a signature) per site", "traces"),
        ("dmlc_compute_cache_hits_total", "counter",
         "calls of an already traced signature per site", "hits"),
    )
    lines = []
    for fam, typ, help_txt, key in fams:
        lines.append(f"# HELP {fam} {help_txt}")
        lines.append(f"# TYPE {fam} {typ}")
        for site, st in site_map.items():
            lines.append(f'{fam}{{site="{site}"}} {st[key]}')
    return "\n".join(lines) + "\n"


def reset_compute() -> None:
    """Forget every ledger (tests / fresh bench runs)."""
    global _last_hbm
    with _lock:
        _sites.clear()
    with _hbm_lock:
        _last_hbm = None
    with _phase_lock:
        for p in PHASES:
            _phase_secs[p] = 0.0
