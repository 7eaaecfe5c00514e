"""Overlap-by-design gradient reduction (the port of
``dmlc_tpu/parallel/overlap.py``): a bucketed allreduce that hides under
the work still to come instead of sitting serially after it.  Two
halves, as in the reference:

* **Device path** — :class:`DeviceBucketer`, the counterpart of
  ``bucketed_psum_mean``: a mesh train step's (dp, sp) gradient
  reduction as one ``all_reduce`` a bucket, each issued during the
  backward as soon as its gradients are accumulated (see the class).
* **Host path** — :class:`GradientBucketer`, below.

Slice the gradient payload into fixed-size buckets
(``DMLC_COLL_BUCKET_MB``) filled in *reverse-topological* order
(backward produces the last layers' gradients first) and hand each full
bucket to a single background collective thread (the tracker host
collective: tree/ring/hier per ``DMLC_COLL_ALGO``).  Bucket k's
allreduce overlaps bucket k+1's transfer and packing on the training
thread; the join runs before the optimizer update.  The per-bucket
collective spans run on the worker thread, which is how the step ledger
(telemetry.steps) tells *overlapped* collective time from *exposed*.

Leaves may be tensors on the card.  Their buckets are pinned host
memory; the training thread enqueues each leaf's copy, and a bucket is
handed to the collective thread only after an event recorded behind its
copies has been synchronised — the fold never reads a bucket the copy
engine is still writing.  Reduced values go back to each leaf's device.

Elastic safety: exceptions raised on the collective thread (including
:class:`~dmlc_tpu_torch.tracker.client.WorldResized` from a mid-bucket
world shrink) are transported through :class:`CollectiveFuture` and
re-raised at the join on the training thread; no result is produced
unless *every* bucket succeeded, so a failed step leaves no bucket
half-reduced — the inputs are untouched and the bucketer is immediately
reusable after ``TrackerClient.resize()``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..concurrency import make_lock

__all__ = [
    "CollectiveFuture",
    "DeviceBucketer",
    "GradientBucketer",
    "bucket_bytes",
    "plan_buckets",
    "reverse_topological",
]


def bucket_bytes() -> int:
    """Gradient bucket size (``DMLC_COLL_BUCKET_MB``, default 4 MB —
    large enough that each bucket clears the ring/hier cutover
    (DMLC_COLL_RING_MIN_BYTES, 1 MB), small enough that several buckets
    are in flight per step)."""
    from ..base import get_env

    mb = get_env("DMLC_COLL_BUCKET_MB", 4.0)
    return max(1, int(mb * (1 << 20)))


def reverse_topological(n: int) -> List[int]:
    """Leaf visit order that fills buckets with the gradients backward
    produces FIRST: flatten order follows the forward graph, so its
    reverse approximates backward completion order (unembed/late blocks
    before the embedding)."""
    return list(range(n))[::-1]


class CollectiveFuture:
    """Result-or-exception transport from the background collective
    thread to the training thread.  ``result()`` re-raises whatever the
    collective raised — the defined path for ``WorldResized`` (and any
    other error) off the worker thread."""

    __slots__ = ("_ev", "_res", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        # dmlc-check: unguarded(written before _ev.set(); read after wait())
        self._res = None
        # dmlc-check: unguarded(written before _ev.set(); read after wait())
        self._exc: Optional[BaseException] = None

    def set_result(self, res) -> None:
        self._res = res
        self._ev.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def exception(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("collective future not done")
        return self._exc

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("collective future not done")
        if self._exc is not None:
            raise self._exc
        return self._res


class _CollectiveThread:
    """One daemon worker draining a FIFO of collective thunks.

    A single thread by design: the host collective's peer links are a
    serial byte stream, so concurrent ops would interleave frames.
    FIFO order also keeps the gang uniform — every rank's bucketer
    issues buckets in the same (deterministic) order."""

    def __init__(self, name: str = "dmlc-coll-overlap"):
        self._q: "queue.Queue" = queue.Queue()
        self._name = name
        self._thread: Optional[threading.Thread] = None
        self._lock = make_lock("_CollectiveThread._lock")

    def submit(self, fn: Callable[[], object]) -> CollectiveFuture:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True)
                self._thread.start()
        fut = CollectiveFuture()
        self._q.put((fn, fut))
        return fut

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, fut = item
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 - transported
                fut.set_exception(e)

    def close(self) -> None:
        with self._lock:
            th, self._thread = self._thread, None
        if th is not None and th.is_alive():
            self._q.put(None)
            th.join(timeout=5)


class GradientBucketer:
    """Flatten gradients into fixed-size buckets and allreduce each on
    a background thread while later gradients are still being packed
    (host path of the overlap design; see the module docstring).

    ``allreduce`` is any callable mapping a flat contiguous 1-D ndarray
    (a view of a host bucket) to its reduced counterpart — in production
    ``lambda a: client.allreduce_sum(a, out=a)``: the bucketer owns
    every bucket buffer it hands over, so reducing IN PLACE is safe and
    keeps the steady-state exchange allocation-free.  All leaves are
    accumulated in ``dtype`` (float32 by default, matching the sync
    path's wire dtype).

    The reduction is *bit-identical* to reducing the concatenated flat
    payload in one call whenever the underlying collective folds ranks
    in a bucket-size-independent order (the tree, shm and hier paths
    fold rank 0..w-1 elementwise; the ring's slice ownership makes the
    fp *order* bucket-dependent, so exact equality there holds for
    order-insensitive values — max/min always, sums of integers
    exactly representable in the dtype).

    Thread contract: one ``reduce_*`` call at a time; while a reduction
    is in flight every collective on the shared client must go through
    this bucketer (the worker owns the peer links until the join
    returns).
    """

    def __init__(self, allreduce: Callable[[np.ndarray], np.ndarray],
                 bucket_bytes_: Optional[int] = None, dtype=np.float32):
        self._allreduce = allreduce
        self._dtype = np.dtype(dtype)
        self._tdtype = torch.from_numpy(np.empty(0, self._dtype)).dtype
        nbytes = bucket_bytes_ or bucket_bytes()
        self._bucket_elems = max(1, nbytes // self._dtype.itemsize)
        self._worker = _CollectiveThread()
        # dmlc-check: unguarded(best-effort early-stop flag; the join is authoritative)
        self._failed: Optional[BaseException] = None
        self._timings: List[Tuple[int, float]] = []
        self._tlock = make_lock("GradientBucketer._tlock")

    @property
    def bucket_elems(self) -> int:
        return self._bucket_elems

    def last_timings(self) -> List[Tuple[int, float]]:
        """(bytes, seconds) per bucket of the most recent reduction —
        the per-bucket overlap timing block the collective bench
        records."""
        with self._tlock:
            return list(self._timings)

    def _submit(self, buf: np.ndarray) -> CollectiveFuture:
        from .. import telemetry

        def run():
            t0 = time.perf_counter()
            # the bucket span makes the worker's time visible to the
            # step ledger's overlapped-collective accounting even when
            # the callable emits no span of its own; the ledger merges
            # intervals, so the nested collective.allreduce span the
            # tracker client opens inside does not double-bill
            with telemetry.span("collective.bucket", stage="collective",
                                args={"bytes": int(buf.nbytes)}):
                out = self._allreduce(buf)
            dt = time.perf_counter() - t0
            with self._tlock:
                self._timings.append((int(buf.nbytes), dt))
            telemetry.inc("collective", "overlap_buckets")
            telemetry.observe_duration("collective", "overlap_bucket",
                                       dt)
            return out

        def guarded():
            if self._failed is not None:
                # a bucket of this reduction already failed, so none of
                # its results is used: a queued bucket does not start a
                # collective of its own (against a dead peer each would
                # wait out a setup or shm timeout)
                raise self._failed
            try:
                return run()
            except BaseException as e:  # noqa: BLE001 - flag + transport
                self._failed = self._failed or e
                raise

        return self._worker.submit(guarded)

    def _new_bucket(self, pinned: bool) -> Tuple[torch.Tensor, np.ndarray]:
        t = torch.empty(self._bucket_elems, dtype=self._tdtype,
                        pin_memory=pinned)
        return t, t.numpy()

    def reduce_leaves(self, leaves: Sequence) -> List:
        """Reduce ``leaves`` (tensors on any device, or array-likes) in
        the order GIVEN; returns the reduced leaves in the same order, in
        the bucketer's accumulation dtype: a tensor on the leaf's device
        for a tensor leaf, an ndarray otherwise.

        A CUDA leaf is cast on its device and copied into a pinned host
        bucket on this thread; a bucket reaches the collective thread
        only once the copies into it have completed (an event recorded
        behind them, synchronised).  All-or-nothing: if any bucket's
        collective raises, the exception is re-raised here after the
        worker drained, nothing is returned, and the input leaves are
        untouched."""
        from .. import telemetry

        self._failed = None
        with self._tlock:
            self._timings = []
        cuda = [isinstance(lf, torch.Tensor) and lf.is_cuda for lf in leaves]
        pinned = any(cuda)
        shapes = []
        devices = []
        futures: List[CollectiveFuture] = []
        buf_t, buf = self._new_bucket(pinned)
        fill = 0

        def flush(n: int) -> None:
            if pinned:
                # the non_blocking copies into this bucket must have
                # landed before another thread reads it
                ev = torch.cuda.Event()
                ev.record()
                ev.synchronize()
            futures.append(self._submit(buf[:n]))

        for leaf, on_card in zip(leaves, cuda):
            if self._failed is not None:
                break  # a bucket already failed: stop packing, join
            if isinstance(leaf, torch.Tensor):
                shapes.append(tuple(leaf.shape))
                devices.append(leaf.device)
                a = leaf.detach().reshape(-1).to(self._tdtype)
                if not on_card:
                    a = a.numpy()
            else:
                a = np.asarray(leaf, dtype=self._dtype).reshape(-1)
                shapes.append(np.shape(leaf))
                devices.append(None)
            pos = 0
            size = a.numel() if on_card else a.size
            while pos < size:
                take = min(size - pos, self._bucket_elems - fill)
                if on_card:
                    buf_t[fill:fill + take].copy_(a[pos:pos + take],
                                                  non_blocking=True)
                else:
                    buf[fill:fill + take] = a[pos:pos + take]
                fill += take
                pos += take
                if fill == self._bucket_elems:
                    flush(fill)
                    buf_t, buf = self._new_bucket(pinned)
                    fill = 0
        if fill and self._failed is None:
            flush(fill)

        # the join is the EXPOSED share of the collective: whatever did
        # not hide under packing/transfer is paid here, on the stepping
        # thread, under a collective-stage span the ledger classifies
        err: Optional[BaseException] = None
        reduced: List[np.ndarray] = []
        with telemetry.span("collective.join", stage="collective",
                            args={"buckets": len(futures)}):
            for fut in futures:
                try:
                    reduced.append(fut.result())
                except BaseException as e:  # noqa: BLE001 - drain all
                    err = err or e
        if err is not None:
            # every future resolved (the worker is idle and reusable);
            # no output was produced, so no gradient is half-reduced
            raise err
        if self._failed is not None:  # paranoia: break without a future
            raise self._failed

        out: List = []
        cat = iter(reduced)
        cur = next(cat, np.empty(0, self._dtype))
        pos = 0
        for shape, dev in zip(shapes, devices):
            n = int(np.prod(shape)) if shape else 1
            if n == 0:
                flatleaf = np.empty(0, self._dtype)
            else:
                pieces = []
                while n > 0:
                    if pos == cur.size:
                        cur = next(cat)
                        pos = 0
                    take = min(n, cur.size - pos)
                    pieces.append(cur[pos:pos + take])
                    pos += take
                    n -= take
                flatleaf = pieces[0] if len(pieces) == 1 \
                    else np.concatenate(pieces)
            if dev is None:
                out.append(np.asarray(flatleaf).reshape(shape))
            else:
                # a blocking copy: the bucket buffers are reused by the
                # next reduction
                out.append(torch.from_numpy(np.array(flatleaf))
                           .reshape(shape).to(dev))
        return out

    def reduce_tree(self, tree):
        """Reduce a gradient pytree (dicts, lists and tuples of leaves,
        flattened by ``torch.utils._pytree``: dicts in insertion order):
        leaves are packed reverse-topologically (early-backward
        gradients fill the first buckets) and the reduced tree comes
        back in the original structure."""
        leaves, spec = pytree.tree_flatten(tree)
        order = reverse_topological(len(leaves))
        reduced = self.reduce_leaves([leaves[i] for i in order])
        restored: List = [None] * len(leaves)
        for slot, red in zip(order, reduced):
            restored[slot] = red
        return pytree.tree_unflatten(restored, spec)

    def close(self) -> None:
        self._worker.close()


def plan_buckets(leaves: Sequence[torch.Tensor],
                 bucket_bytes_: Optional[int] = None) -> List[List[int]]:
    """The reference's bucket fill (``bucketed_psum_mean``): ``leaves`` in
    the order given, a bucket closed before a leaf that would take it
    past ``bucket_bytes_`` (default :func:`bucket_bytes`) or that changes
    the dtype; a leaf larger than the cap is a bucket of its own.
    Returns each bucket's leaf indices."""
    cap = bucket_bytes_ or bucket_bytes()
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i, leaf in enumerate(leaves):
        nb = leaf.numel() * leaf.element_size()
        if cur and (cur_bytes + nb > cap or leaf.dtype != cur_dtype):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
        cur_dtype = leaf.dtype
    if cur:
        buckets.append(cur)
    return buckets


class DeviceBucketer:
    """The mean of a mesh model's gradients over ``axis`` (the (dp, sp)
    plane), one ``all_reduce`` a bucket issued during the backward: the
    device half of the overlap design (``bucketed_psum_mean``).

    ``params`` come in reverse-topological order (the backward finishes
    the first ones first) and :func:`plan_buckets` fills the buckets.  A
    hook on each parameter (``register_post_accumulate_grad_hook``)
    counts the bucket's gradients in; once a bucket is whole, and every
    earlier bucket launched, its gradients are concatenated and handed
    to ``all_reduce(async_op=True)`` over the axis's group.  So every
    rank launches its buckets in one order, whatever order its hooks
    fire in, and the group's collectives pair up.  The hooks act only
    inside ``with bucketer:`` around the backward; leaving it launches
    what is left (a gradient that never arrived counts as zeros), waits
    on every bucket in order (the ``collective.join`` span, the exposed
    share), divides each sum by the group's size — psum, then divide,
    as the reference — and writes the means back to ``p.grad``.

    Telemetry under the host bucketer's names: ``collective``
    ``overlap_buckets`` a bucket, and each bucket's ``all_reduce_calls``
    / ``all_reduce_bytes``.  ``launched_in_backward`` is how many of the
    last step's buckets launched before the backward returned."""

    def __init__(self, params: Sequence[torch.Tensor], axis, mesh,
                 bucket_bytes_: Optional[int] = None):
        self.params = list(params)
        self.axis = axis
        self.mesh = mesh
        self.buckets = plan_buckets(self.params, bucket_bytes_)
        self._bucket_of = {id(self.params[i]): b
                           for b, idxs in enumerate(self.buckets)
                           for i in idxs}
        self._armed = False
        self._pending: List[int] = []
        self._launched: List[tuple] = []
        self.launched_in_backward = 0
        for p in self.params:
            p.register_post_accumulate_grad_hook(self._ready)

    def __enter__(self) -> "DeviceBucketer":
        self._pending = [len(b) for b in self.buckets]
        self._launched = []
        self._armed = True
        return self

    def _ready(self, p: torch.Tensor) -> None:
        if not self._armed:
            return
        self._pending[self._bucket_of[id(p)]] -= 1
        while (len(self._launched) < len(self.buckets)
               and self._pending[len(self._launched)] == 0):
            self._launch()

    def _launch(self) -> None:
        import torch.distributed as dist

        from .. import telemetry
        from .collectives import _note

        idxs = self.buckets[len(self._launched)]
        flat = torch.cat([self.params[i].grad.reshape(-1)
                          if self.params[i].grad is not None
                          else self.params[i].new_zeros(
                              self.params[i].numel()) for i in idxs])
        group = self.mesh.group(self.axis)
        work = None
        if group is not None:
            _note("all_reduce", flat, self.axis)
            work = dist.all_reduce(flat, group=group, async_op=True)
        telemetry.inc("collective", "overlap_buckets")
        self._launched.append((idxs, flat, work))

    def __exit__(self, exc_type, exc, tb) -> None:
        from .. import telemetry

        self._armed = False
        if exc_type is not None:
            for _, _, work in self._launched:
                if work is not None:
                    work.wait()
            return
        self.launched_in_backward = len(self._launched)
        while len(self._launched) < len(self.buckets):
            self._launch()
        n = self.mesh.axis_size(self.axis)
        with telemetry.span("collective.join", stage="collective",
                            args={"buckets": len(self._launched)}):
            for idxs, flat, work in self._launched:
                if work is not None:
                    work.wait()
                    flat.div_(n)
                sizes = [self.params[i].numel() for i in idxs]
                for i, part in zip(idxs, flat.split(sizes)):
                    p = self.params[i]
                    if p.grad is None:
                        p.grad = part.view_as(p).clone()
                    else:
                        p.grad.copy_(part.view_as(p))
