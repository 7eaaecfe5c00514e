"""The device feed: RecordIO and sparse-text partitions into batches on
the card (the port of ``dmlc_tpu/feed/device_feed.py``).

Layout: partition ``p`` of ``num_parts`` fills rows ``[p·B, (p+1)·B)``
of one tensor on the device, the JAX package's global layout
(``num_parts`` plays the mesh's data partitions, dp·sp).  Batches have
static shapes (padded or truncated).

Pipeline, per epoch:

* ``num_workers`` (``DMLC_FEED_WORKERS``) parser threads: worker ``w``
  owns partitions ``p ≡ w (mod W)``, so each partition's batch order is
  kept, and writes every batch straight into its slice of a staging
  buffer;
* staging buffers are pinned host tensors in a ``BufferPool`` of
  ``queue_depth`` (``DMLC_FEED_DEPTH``), built once and reused across
  epochs;
* a placer thread copies each complete buffer to the card with
  ``non_blocking`` copies on a CUDA stream of the feed's own, live
  partitions only (a drained partition's rows are zeroed on the card, no
  padding crosses the link), runs the optional on-card transform after
  the copies, and records an event;
* the staging buffer goes back to the pool only once that event has
  completed; the consumer's stream waits on the event, and every tensor
  handed out is ``record_stream``-ed on the consumer's stream, so the
  caching allocator does not reuse its memory while the step still reads
  it.

On the CPU (``device="cpu"``, the tests) placement copies out of the
staging buffer, since a CPU "device" tensor would otherwise alias memory
the pool recycles.

Every batch carries ``parts_alive``, a host float32 tensor ``[num_parts]``:
1.0 where the partition contributed rows, 0.0 where a drained partition
was zeroed.

Telemetry, as the JAX feed records it: ``feed.parse`` and ``feed.stage``
spans on the parser workers, ``feed.assemble`` and ``feed.place`` on the
placer, the ``feed.batches`` and ``feed.bytes_to_device`` counters, and
``feed.wait`` on the consumer's thread around its wait for a batch.  The
step ledger bills only spans on the stepping thread, so ``feed.wait`` is
a step's feed-wait share while the producers' spans overlap it.
``stats()`` keeps the feed's own totals beside them.

Across processes (``world=(rank, world_size)``) a feed reads its global
partitions of the byte-range split; :meth:`DeviceFeed.resize` rebuilds
them in place for a new world (the elastic trainer's repartition).  With
``DMLC_FEED_AUTOTUNE=1`` the feed re-sizes its workers and depth at each
epoch boundary from the step ledger's feed-wait share
(:class:`~.autotune.FeedAutotuner`, the ``feed.autotune_*`` gauges).

Batch-borrowing contract: a partition iterator's yielded dict is read
only between the yield and the next ``next()`` on that iterator (it is
copied into staging at once), so iterators reuse one output buffer.

Host work on the partition iterators runs in the C++ core (``native``)
with the GIL released, so the parser workers overlap: the RecordIO chunk
scan and packs (``feed.spans``), the CSR pack of :func:`pack_rowblock`,
and :func:`libsvm_feed`'s fused LibSVM tokenize-and-pack.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from queue import Empty, Full, Queue
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from .. import logging as log
from .. import native, telemetry
from ..base import check, get_env, resolve_device
from ..concurrency import BufferPool, make_lock, make_rlock
from . import spans as _spans

__all__ = ["DeviceFeed", "libsvm_feed", "pack_rowblock",
           "pack_rowblock_plain", "recordio_feed", "recordio_packed_feed"]

_POLL_S = 0.1
_LOG_EVERY = 10 << 20   # bytes between throughput log lines


def _batch_arrays(batch_size: int, max_nnz: int) -> Dict[str, np.ndarray]:
    return {"label": np.zeros(batch_size, np.float32),
            "value": np.zeros((batch_size, max_nnz), np.float32),
            "index": np.zeros((batch_size, max_nnz), np.int32),
            "mask": np.zeros((batch_size, max_nnz), np.float32)}


def pack_rowblock(blk, batch_size: int, max_nnz: int, num_col: int = 0,
                  out: Optional[Dict[str, np.ndarray]] = None):
    """RowBlock (CSR) to a fixed-shape batch {label [B], value [B, K],
    index [B, K], mask [B, K]} (float32/int32): rows padded (mask 0) or
    truncated to ``K = max_nnz``, masked cells written as zero; with
    ``num_col > 0`` indices are clamped to ``[0, num_col)`` so a gather
    into a ``[num_col]`` weight stays in bounds.

    ``out`` (those keys) is filled in place and returned.  The pack is
    one native call (``dmlc_pad_pack_csr``) into an ``out`` of exactly
    those dtypes and shapes; an ``out`` of other dtypes (legal: the
    values are cast on assignment) or shapes is packed by
    :func:`pack_rowblock_plain`, which casts, or refuses a shape that
    does not broadcast."""
    if out is None:
        out = _batch_arrays(batch_size, max_nnz)
    b = min(batch_size, blk.size)
    expect = (("label", np.float32, (batch_size,)),
              ("value", np.float32, (batch_size, max_nnz)),
              ("index", np.int32, (batch_size, max_nnz)),
              ("mask", np.float32, (batch_size, max_nnz)))
    if all(out[k].flags["C_CONTIGUOUS"] and out[k].dtype == dt
           and out[k].shape == shp for k, dt, shp in expect):
        native.pad_pack_csr(blk.label[:b], blk.offset[: b + 1], blk.index,
                            blk.value, b, batch_size, max_nnz, num_col, out)
        return out
    return pack_rowblock_plain(blk, batch_size, max_nnz, num_col, out)


def pack_rowblock_plain(blk, batch_size: int, max_nnz: int,
                        num_col: int = 0,
                        out: Optional[Dict[str, np.ndarray]] = None):
    """The plain version of :func:`pack_rowblock`: one broadcast numpy
    gather, bit-identical to the native pack."""
    if out is None:
        out = _batch_arrays(batch_size, max_nnz)
    label, value = out["label"], out["value"]
    index, mask = out["index"], out["mask"]
    b = min(batch_size, blk.size)
    label[b:] = 0
    label[:b] = blk.label[:b]
    src_val = np.asarray(blk.value)
    src_idx = np.asarray(blk.index)
    if b == 0 or src_val.size == 0:
        value[:] = 0
        index[:] = 0
        mask[:] = 0
        return out
    # each cell reads offset[row] + column, masked past the row's length
    offsets = np.asarray(blk.offset[: b + 1], np.int64)
    lens = np.diff(offsets)
    ar = np.arange(max_nnz, dtype=np.int64)
    sel = ar[None, :] < lens[:, None]                        # [b, K]
    src = np.minimum(offsets[:-1, None] + ar[None, :], src_val.size - 1)
    value[b:] = 0
    # masked cells are written zero, not multiplied by zero: the clamped
    # gather reads other rows' values, and NaN/Inf * 0 is NaN
    value[:b] = np.where(sel, src_val[src], np.float32(0))
    index[b:] = 0
    index[:b] = src_idx[src]
    index[:b] *= sel
    mask[b:] = 0
    mask[:b] = sel
    if num_col > 0:
        np.minimum(index, num_col - 1, out=index)
    return out


class _ProducerError:
    """Wraps a producer-thread exception for re-raise on the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _StagingBuf:
    """One pooled global host batch: per key a tensor ``(num_parts ·
    per_part_dim0, *rest)`` (pinned when the feed places on a card) and a
    numpy view of it for the parser workers; ``event`` marks the end of
    the last copies that read it."""

    __slots__ = ("tensors", "arrays", "event", "nbytes")

    def __init__(self, template: Dict[str, np.ndarray], n_parts: int,
                 pin: bool):
        self.tensors = {
            k: torch.empty((n_parts * v.shape[0],) + v.shape[1:],
                           dtype=torch.from_numpy(v[:0]).dtype,
                           pin_memory=pin)
            for k, v in template.items()}
        self.arrays = {k: t.numpy() for k, t in self.tensors.items()}
        self.event = None
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in self.tensors.values())


class _Slot:
    """A staging buffer bound to one step: complete once every parser
    worker has checked its partitions in."""

    __slots__ = ("step", "sbuf", "alive", "workers_left", "done")

    def __init__(self, step: int, sbuf: _StagingBuf, n_parts: int,
                 n_workers: int):
        self.step = step
        self.sbuf = sbuf
        self.alive = np.zeros(n_parts, bool)
        self.workers_left = n_workers
        self.done = False


class _Making:
    """Placeholder of a slot a worker is taking a buffer for."""

    done = False


_MAKING = _Making()


def _runs(alive: np.ndarray):
    """``(first, last + 1, live)`` for each run of equal ``alive``."""
    out, start = [], 0
    for p in range(1, len(alive) + 1):
        if p == len(alive) or alive[p] != alive[start]:
            out.append((start, p, bool(alive[start])))
            start = p
    return out


class DeviceFeed:
    """Per-partition host batches assembled into one batch on the device.

    ``part_sources``: one iterator FACTORY per partition (fresh iterators
    every epoch, so the feed serves many epochs; plain iterators make a
    one-epoch feed), each yielding dicts of equal-shaped numpy arrays.
    Or ``source_builder(part_index, num_parts) -> factory`` with
    ``world=(rank, world_size)``: this process then reads global
    partitions ``rank·n + p`` of ``world_size·n``, which the input
    split's byte-range contract makes deterministic for any world size.

    ``device`` is the card unless the caller names another (``"cpu"``);
    with no card it raises.  :meth:`stats` holds plain counters.
    """

    def __init__(self, part_sources=None, *, device=None,
                 num_parts: Optional[int] = None,
                 queue_depth: Optional[int] = None, num_workers: int = 0,
                 source_builder=None, world=None):
        if queue_depth is not None:
            check(queue_depth >= 1,
                  f"queue_depth must be >= 1, got {queue_depth}")
        self.device = resolve_device(device)
        if num_parts is None:
            num_parts = len(part_sources) if part_sources is not None else 1
        check(num_parts >= 1, f"num_parts must be >= 1, got {num_parts}")
        self._n_parts = num_parts
        self._source_builder = source_builder
        # dmlc-check: unguarded(consumer-thread epoch/resize state; close() joins first)
        self._world = (self._check_world(world) if world is not None
                       else (0, 1))
        if part_sources is None:
            check(source_builder is not None,
                  "DeviceFeed needs part_sources or a source_builder")
            part_sources = self._build_sources()
        check(len(part_sources) == num_parts,
              f"need {num_parts} partition sources, got {len(part_sources)}")
        # dmlc-check: unguarded(consumer-thread epoch/resize state; close() joins first)
        self._multi_epoch = all(callable(s) for s in part_sources)
        # dmlc-check: unguarded(consumer-thread epoch/resize state; close() joins first)
        self._sources = part_sources
        # dmlc-check: unguarded(consumer-thread epoch state)
        self._epochs_started = 0
        # dmlc-check: unguarded(autotuned between epochs before Thread.start publishes)
        self._depth = (queue_depth if queue_depth is not None
                       else max(1, get_env("DMLC_FEED_DEPTH", 2)))
        # dmlc-check: unguarded(autotuned between epochs before Thread.start publishes)
        self._workers = max(1, min(num_parts, num_workers or get_env(
            "DMLC_FEED_WORKERS", min(4, os.cpu_count() or 2))))
        # ledger-driven auto-tuning (DMLC_FEED_AUTOTUNE=1): the controller
        # watches the step ledger's feed-wait fraction and re-sizes
        # workers/depth within bounds at every epoch boundary (worker →
        # partition assignment is w mod W, so W may only change between
        # epochs without breaking per-partition batch order).  The signal
        # is the TRAINING STEP's feed wait, so enable it for the one feed
        # the ledgered loop consumes
        self._autotuner = None
        if get_env("DMLC_FEED_AUTOTUNE", False):
            from .autotune import FeedAutotuner

            wmax = get_env("DMLC_FEED_WORKERS_MAX", 0) or \
                (os.cpu_count() or 2)
            self._autotuner = FeedAutotuner(
                workers=self._workers, depth=self._depth,
                min_workers=max(1, get_env("DMLC_FEED_WORKERS_MIN", 1)),
                max_workers=max(1, min(num_parts, wmax)),
                max_depth=max(self._depth,
                              get_env("DMLC_FEED_DEPTH_MAX", 4)))
            # dmlc-check: unguarded(consumer-thread epoch-boundary cursor)
            self._ledger_seen_seq = 0
        self._on_card = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._on_card
                        else None)
        # on-card transform after placement (the packed transport's
        # expander), run on the placer thread and the feed's stream
        self._transform = None
        # dmlc-check: unguarded(thread-safe Queue; rebound between epochs pre-start)
        self._queue: Queue = Queue(maxsize=self._depth)
        # dmlc-check: unguarded(rebuilt between epochs; each iterator read by its one owning worker)
        self._part_iters: list = []
        # dmlc-check: unguarded(per-cell owner-worker reads; mutated under _cv)
        self._part_done = [False] * num_parts
        # dmlc-check: unguarded(mutation under _cv; epoch reset pre-start)
        self._n_dead = 0
        # dmlc-check: unguarded(write-once under _cv; read only after _checkin_slot saw it locked)
        self._template: Optional[Dict[str, np.ndarray]] = None
        # dmlc-check: unguarded(thread-safe BufferPool; rebound between epochs pre-start)
        self._pool: Optional[BufferPool] = None
        # every staging buffer built; the next epoch's pool reuses them
        self._built: List[_StagingBuf] = []
        self._spare: List[_StagingBuf] = []
        # dmlc-check: unguarded(accesses under _cv; rebound between epochs pre-start)
        self._pending: Dict[int, _Slot] = {}
        self._cv = threading.Condition(make_rlock("DeviceFeed._cv"))
        # dmlc-check: unguarded(under _cv; cancel polls are stale-tolerant)
        self._error: Optional[BaseException] = None
        # dmlc-check: unguarded(set/read under _cv; epoch reset pre-start)
        self._empty_epoch = False
        # dmlc-check: unguarded(consumer-thread lifecycle; joined before rebinding)
        self._thread: Optional[threading.Thread] = None  # placer
        # dmlc-check: unguarded(consumer-thread lifecycle; joined before rebinding)
        self._parsers: List[threading.Thread] = []
        self._stop = threading.Event()
        self._closing = threading.Event()   # close() was called
        # dmlc-check: unguarded(placer-thread-confined)
        self._last_log = 0
        # dmlc-check: unguarded(placer-thread-confined)
        self._t0 = 0.0
        self._stats_lock = make_lock("DeviceFeed._stats_lock")
        self._stats = {"batches": 0, "bytes_to_device": 0,
                       "staging_buffers_built": 0, "parse_s": 0.0,
                       "stage_s": 0.0, "place_s": 0.0, "wait_s": 0.0}

    # ---- counters -------------------------------------------------------
    def _add(self, key: str, value) -> None:
        with self._stats_lock:
            self._stats[key] += value

    def stats(self) -> Dict[str, float]:
        """Batches and live bytes placed, staging buffers built, and the
        seconds spent parsing (partition iterators), staging (copies into
        the staging buffer), placing (issuing the copies and the
        transform) and in the consumer's wait for a batch."""
        with self._stats_lock:
            return dict(self._stats)

    # ---- parser workers -------------------------------------------------
    def _fail(self, exc: BaseException) -> None:
        with self._cv:
            if self._error is None:
                self._error = exc
            self._cv.notify_all()
        self._stop.set()
        if self._pool is not None:
            self._pool.kill()

    def _parse_part(self, p: int):
        """The next batch of partition ``p`` (None once drained); the
        first batch ever seen sets the feed's template."""
        if self._part_done[p]:
            return None
        t0 = time.perf_counter()
        with telemetry.span("feed.parse", stage="feed", args={"part": p}):
            batch = next(self._part_iters[p], None)
        self._add("parse_s", time.perf_counter() - t0)
        if batch is None:
            with self._cv:
                self._part_done[p] = True
                self._n_dead += 1
                if self._n_dead == self._n_parts:
                    self._cv.notify_all()
            return None
        if self._template is None:
            with self._cv:
                if self._template is None:
                    self._template = {k: np.zeros_like(v)
                                      for k, v in batch.items()}
                    self._cv.notify_all()
        return batch

    def _checkin_slot(self, step: int) -> Optional[_Slot]:
        """The staging slot of ``step``.  The first worker to arrive takes
        a buffer from the pool for it while the others wait on the
        condition.  None on stop, error or an empty epoch."""
        with self._cv:
            while True:
                if self._error is not None or self._stop.is_set():
                    return None
                if self._template is None:
                    # nothing parsed yet anywhere: another worker is about
                    # to set the template, or the whole epoch is empty
                    if self._n_dead == self._n_parts:
                        self._empty_epoch = True
                        self._cv.notify_all()
                        return None
                else:
                    slot = self._pending.get(step)
                    if slot is None:
                        self._pending[step] = _MAKING
                        break
                    if slot is not _MAKING:
                        return slot
                self._cv.wait(_POLL_S)
        # stage stall: parsing ran ahead of the transfer pipeline and
        # waits for a staging buffer to come back from the placer
        t0 = time.perf_counter()
        try:
            while True:
                sbuf = self._pool.acquire(timeout=_POLL_S)
                if sbuf is not None:
                    break
                if self._stop.is_set() or self._error is not None:
                    return None
        finally:
            telemetry.observe_duration("feed", "stage_stall",
                                       time.perf_counter() - t0)
        with self._cv:
            slot = self._pending[step] = _Slot(step, sbuf, self._n_parts,
                                               self._workers)
            self._cv.notify_all()
        return slot

    def _write_part(self, slot: _Slot, p: int, batch) -> None:
        if batch is None:
            return  # drained: placement zeroes its rows on the device
        t0 = time.perf_counter()
        with telemetry.span("feed.stage", stage="feed", args={"part": p}):
            for k, t in self._template.items():
                d0 = t.shape[0]
                dst = slot.sbuf.arrays[k][p * d0:(p + 1) * d0]
                src = batch[k]
                check(dst.shape == src.shape and dst.dtype == src.dtype,
                      f"partition {p} batch key '{k}' is "
                      f"{src.shape}/{src.dtype}, expected "
                      f"{dst.shape}/{dst.dtype}")
                np.copyto(dst, src)
        slot.alive[p] = True
        self._add("stage_s", time.perf_counter() - t0)

    def _parser_worker(self, w: int) -> None:
        my_parts = list(range(w, self._n_parts, self._workers))
        step = 0
        try:
            while not self._stop.is_set():
                # parse first, then stage: the slot (and the staging
                # shapes) exist only once some batch set the template
                produced = {p: self._parse_part(p) for p in my_parts}
                slot = self._checkin_slot(step)
                if slot is None:
                    return
                for p in my_parts:
                    self._write_part(slot, p, produced[p])
                with self._cv:
                    slot.workers_left -= 1
                    if slot.workers_left == 0:
                        slot.done = True
                        self._cv.notify_all()
                step += 1
        except BaseException as e:  # noqa: BLE001 - surfaced to the consumer
            self._fail(e)

    # ---- staging pool ---------------------------------------------------
    def _make_staging(self) -> _StagingBuf:
        """A staging buffer for the pool: one left from an earlier epoch
        (after its last copies have landed) or a new one."""
        with self._cv:
            sbuf = self._spare.pop() if self._spare else None
        if sbuf is not None:
            if sbuf.event is not None:
                sbuf.event.synchronize()
            return sbuf
        sbuf = _StagingBuf(self._template, self._n_parts, self._on_card)
        with self._cv:
            self._built.append(sbuf)
            staged = sum(b.nbytes for b in self._built)
        self._add("staging_buffers_built", 1)
        telemetry.set_gauge("feed", "staging_pool_bytes", staged)
        return sbuf

    # ---- placer ---------------------------------------------------------
    def _place(self, slot: _Slot) -> Dict[str, torch.Tensor]:
        """The staging buffer's live partitions on the device; drained
        partitions' rows zeroed there."""
        out = {}
        for k, t in self._template.items():
            d0 = t.shape[0]
            src = slot.sbuf.tensors[k]
            if self._on_card:
                dst = torch.empty(src.shape, dtype=src.dtype,
                                  device=self.device)
                for a, b, live in _runs(slot.alive):
                    if live:
                        dst[a * d0:b * d0].copy_(src[a * d0:b * d0],
                                                 non_blocking=True)
                    else:
                        dst[a * d0:b * d0].zero_()
            else:
                dst = src.clone()
                for a, b, live in _runs(slot.alive):
                    if not live:
                        dst[a * d0:b * d0].zero_()
            out[k] = dst
        return out

    def _wait_copies(self, event) -> bool:
        """Poll until ``event`` completes; False when the feed is closed
        first."""
        while not event.query():
            if self._closing.is_set():
                return False
            time.sleep(0.0002)
        return True

    def _put(self, item) -> bool:
        """Queue ``item`` for the consumer; False when the feed is closed
        while the queue is full."""
        while True:
            try:
                self._queue.put(item, timeout=_POLL_S)
                return True
            except Full:
                if self._closing.is_set():
                    return False

    def _place_loop(self) -> None:
        if self._on_card:
            torch.cuda.set_device(self.device)
        self._t0 = time.perf_counter()
        step = 0
        try:
            while True:
                # "assembly" = waiting for the parser workers to complete
                # this step's staging buffer
                with telemetry.span("feed.assemble", stage="feed"), \
                        telemetry.timed("feed", "assemble"), self._cv:
                    while not (self._error is not None or self._empty_epoch
                               or (step in self._pending
                                   and self._pending[step].done)):
                        if self._stop.is_set():
                            return
                        self._cv.wait(_POLL_S)
                    if self._error is not None:
                        raise self._error
                    slot = (None if self._empty_epoch
                            else self._pending.pop(step))
                if slot is None or not slot.alive.any():
                    # every partition drained: end of epoch
                    self._stop.set()
                    if self._pool is not None:
                        self._pool.kill()  # wake workers parked ahead
                    self._put(None)
                    return
                t0 = time.perf_counter()
                event = None
                with telemetry.span("feed.place", stage="feed"), \
                        telemetry.annotate("dmlc_feed_batch"), \
                        telemetry.timed("feed", "device_put"):
                    if self._on_card:
                        with torch.cuda.stream(self._stream):
                            dev = self._place(slot)
                            if self._transform is not None:
                                dev = self._transform(dev)
                            event = torch.cuda.Event()
                            event.record(self._stream)
                        slot.sbuf.event = event
                    else:
                        dev = self._place(slot)
                        if self._transform is not None:
                            dev = self._transform(dev)
                dev["parts_alive"] = torch.from_numpy(
                    slot.alive.astype(np.float32))
                self._add("place_s", time.perf_counter() - t0)
                # live bytes only: a drained partition crosses no link
                nbytes = slot.sbuf.nbytes // self._n_parts * int(
                    slot.alive.sum())
                with self._stats_lock:
                    self._stats["batches"] += 1
                    self._stats["bytes_to_device"] += nbytes
                    fed = self._stats["bytes_to_device"]
                telemetry.inc("feed", "batches")
                telemetry.inc("feed", "bytes_to_device", nbytes)
                if fed - self._last_log >= _LOG_EVERY:
                    dt = time.perf_counter() - self._t0
                    log.info(f"feed: {fed / 1e6:.0f} MB to device, "
                             f"{fed / 1e6 / dt:.2f} MB/sec")
                    self._last_log = fed
                # a full queue means the consumer is the bottleneck
                with telemetry.timed("feed", "producer_stall"):
                    if not self._put((dev, event)):
                        return
                # the copies must land before the buffer is recycled
                if event is not None and not self._wait_copies(event):
                    return
                self._pool.release(slot.sbuf)
                step += 1
        except BaseException as e:  # noqa: BLE001 - surfaced to the consumer
            self._fail(e)
            self._put(_ProducerError(e))

    # ---- consumer -------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        threads = ([self._thread] if self._thread else []) + self._parsers
        for t in threads:
            # a pipeline that already delivered its end-of-epoch marker
            # may not have exited yet
            t.join(timeout=2.0)
            if t.is_alive():
                raise RuntimeError(
                    "previous DeviceFeed epoch still in flight: exhaust the "
                    "iterator or close() before starting a new epoch")
        self._thread = None
        self._parsers = []
        if self._epochs_started > 0 and not self._multi_epoch:
            raise RuntimeError(
                "DeviceFeed built from plain iterators is single-epoch: pass "
                "iterator factories (callables) for multi-epoch use")
        self._epochs_started += 1
        self._apply_autotune()
        self._part_iters = [s() if callable(s) else s for s in self._sources]
        self._part_done = [False] * self._n_parts
        self._n_dead = 0
        self._pending = {}
        self._error = None
        self._empty_epoch = False
        self._queue = Queue(maxsize=self._depth)
        self._stop.clear()
        self._closing.clear()
        with self._cv:
            self._spare = list(self._built)
        self._pool = BufferPool(self._make_staging, capacity=self._depth)
        self._parsers = [threading.Thread(target=self._parser_worker,
                                          args=(w,), daemon=True)
                         for w in range(self._workers)]
        for t in self._parsers:
            t.start()
        self._thread = threading.Thread(target=self._place_loop, daemon=True)
        self._thread.start()
        placer = self._thread
        consumer = (torch.cuda.current_stream(self.device) if self._on_card
                    else None)
        while True:
            # an empty queue means the producer is the bottleneck; this
            # span is the step ledger's feed-wait (consumer thread only)
            with telemetry.span("feed.wait", stage="feed"), \
                    telemetry.timed("feed", "consumer_stall"):
                t0 = time.perf_counter()
                while True:
                    try:
                        item = self._queue.get(timeout=_POLL_S)
                        break
                    except Empty:
                        if not placer.is_alive() and self._queue.empty():
                            raise RuntimeError(
                                "DeviceFeed placer stopped without ending "
                                "the epoch (the feed was closed)")
                self._add("wait_s", time.perf_counter() - t0)
            if item is None:
                return
            if isinstance(item, _ProducerError):
                raise item.exc
            batch, event = item
            if event is not None:
                consumer.wait_event(event)
                for v in batch.values():
                    if v.is_cuda:
                        v.record_stream(consumer)
            yield batch

    def close(self) -> None:
        """Stop the epoch in flight and join every thread."""
        self._closing.set()
        self._stop.set()
        if self._pool is not None:
            self._pool.kill()
        with self._cv:
            self._cv.notify_all()
        threads = ([self._thread] if self._thread else []) + self._parsers
        deadline = time.monotonic() + 5.0
        while (any(t.is_alive() for t in threads)
               and time.monotonic() < deadline):
            while not self._queue.empty():
                try:
                    self._queue.get_nowait()
                except Empty:
                    break
            for t in threads:
                t.join(timeout=0.05)
        if not any(t.is_alive() for t in threads):
            self._thread = None
            self._parsers = []
            # the partition iterators' splits hold prefetch threads of
            # their own: closing a generator runs its cleanup now
            for it in self._part_iters:
                if hasattr(it, "close"):
                    it.close()
            self._part_iters = []
        else:
            # _thread stays set, so __iter__ refuses a second pipeline
            log.warning("DeviceFeed.close(): pipeline thread still alive "
                        "after 5s (likely a hung copy to the device); "
                        "leaking a daemon thread")

    # ---- ledger-driven auto-tuning --------------------------------------
    def _apply_autotune(self) -> None:
        """Epoch-boundary controller step: feed the step ledger's recent
        feed-wait fraction to the FeedAutotuner and apply its (workers,
        depth) decision before the pipeline threads start.  A worker
        count change re-maps partitions (w mod W) for the fresh epoch
        only; a depth change re-sizes the staging pool, which is rebuilt
        every epoch (from the buffers already built)."""
        if self._autotuner is None:
            return
        recs, last = telemetry.ledger().records_since(self._ledger_seen_seq)
        walls = sum(r["wall_s"] for r in recs)
        if len(recs) < self._autotuner.window or walls <= 0:
            # too thin to decide: the seen-seq stays, so short epochs
            # (fewer steps than the window) pool their evidence
            telemetry.set_gauge("feed", "autotune_workers", self._workers)
            telemetry.set_gauge("feed", "autotune_depth", self._depth)
            return
        self._ledger_seen_seq = last
        fw = sum(r["feed_wait_s"] for r in recs) / walls
        workers, depth = self._autotuner.observe(fw)
        workers = max(1, min(self._n_parts, workers))
        if workers != self._workers or depth != self._depth:
            log.info(f"feed autotune: feed-wait {fw:.2f} over {len(recs)} "
                     f"steps -> workers {self._workers}->{workers}, "
                     f"depth {self._depth}->{depth}")
            telemetry.inc("feed", "autotune_adjustments")
            self._workers = workers
            self._depth = depth
        telemetry.set_gauge("feed", "autotune_workers", self._workers)
        telemetry.set_gauge("feed", "autotune_depth", self._depth)

    # ---- partitions across processes ------------------------------------
    @staticmethod
    def _check_world(world) -> tuple:
        rank, wsize = world
        check(wsize >= 1 and 0 <= rank < wsize,
              f"world must be (rank, world_size) with 0 <= rank < "
              f"world_size, got {world}")
        return (int(rank), int(wsize))

    def _build_sources(self) -> list:
        rank, wsize = self._world
        total = wsize * self._n_parts
        return [self._source_builder(rank * self._n_parts + lp, total)
                for lp in range(self._n_parts)]

    @property
    def world(self) -> tuple:
        return self._world

    def resize(self, world) -> None:
        """Elastic repartition: rebuild the per-partition iterators for a
        new ``(rank, world_size)`` in place.

        The in-flight epoch is abandoned (on a resize the trainer
        restores from the last checkpoint anyway); the next iteration
        starts a FRESH epoch whose partitions tile the dataset exactly
        once under the new byte-range split.  The local layout (batch
        shapes, staging buffers, the stream) is untouched: only the
        global partition ids change."""
        check(self._source_builder is not None,
              "this feed was built from explicit part_sources; elastic "
              "resize needs a source_builder (the recordio_/libsvm_ "
              "feed factories provide one)")
        world = self._check_world(world)
        old = self._world
        self.close()
        self._world = world
        self._sources = self._build_sources()
        self._multi_epoch = True
        telemetry.inc("feed", "resizes")
        telemetry.record_event("feed_resized", old_world=list(old),
                               world=list(world),
                               local_parts=self._n_parts)


# ---------------------------------------------------------------------------
# Sparse text feeds
# ---------------------------------------------------------------------------

def _classic_part_iter(uri: str, fmt: str, batch_size: int, max_nnz: int,
                       part: int, n_parts: int):
    """One partition through ``create_row_iter`` (the parser, or the
    ``#cachefile`` page cache), its blocks re-sliced into fixed batches by
    :func:`pack_rowblock` into one borrowed batch dict."""
    from ..data import create_row_iter

    it = create_row_iter(uri, part, n_parts, fmt)
    try:
        ncol = it.num_col()
        out = None
        for blk in it:
            for lo in range(0, blk.size, batch_size):
                sub = blk.slice(lo, min(lo + batch_size, blk.size))
                out = pack_rowblock(sub, batch_size, max_nnz, ncol, out=out)
                yield out
    finally:
        if hasattr(it, "close"):
            it.close()


def _fused_part_iter(uri: str, batch_size: int, max_nnz: int, part: int,
                     n_parts: int):
    """One LibSVM partition through the fused native route: one
    ``dmlc_parse_libsvm_into`` call per (chunk window, batch) tokenizes
    the text and writes the padded rows of one borrowed batch dict in
    place, no intermediate CSR.  Indices are not clamped: the classic
    route clamps to the partition's largest index + 1, which no parsed
    index exceeds, so the routes give the same batches."""
    from ..io import input_split

    split = input_split.create(uri, part, n_parts, "text")
    try:
        out = _batch_arrays(batch_size, max_nnz)
        r = 0
        while True:
            chunk = split.next_chunk()
            if chunk is None:
                break
            start, n = 0, len(chunk)
            while start < n:
                with telemetry.span("feed.parse_native", stage="feed"), \
                        telemetry.timed("feed", "parse_native"):
                    r, start = native.parse_libsvm_into(chunk, start, r,
                                                        max_nnz, 0, out)
                if r == batch_size:
                    yield out
                    r = 0
            chunk = None
        if r:  # the epoch's short last batch, zero-padded
            for v in out.values():
                v[r:] = 0
            yield out
    finally:
        split.close()


def libsvm_feed(uri: str, *, batch_size: int, max_nnz: int,
                fmt: str = "libsvm", num_parts: int = 1, device=None,
                queue_depth: Optional[int] = None, world=None) -> DeviceFeed:
    """Sparse text (LibSVM, CSV, libfm) as padded CSR batches {label
    [num_parts · B], value / index / mask [num_parts · B, max_nnz]},
    ``B = batch_size`` rows of each partition.

    ``fmt="libsvm"`` on a URI without a ``#cachefile`` (and no
    ``format=`` other than libsvm) takes the fused native route: the
    text is tokenized straight into the batch, with the GIL released so
    ``DMLC_FEED_WORKERS`` partition threads overlap.  Every other URI or
    ``fmt`` (``"csv"``, ``"libfm"``, ``"auto"``) takes the classic
    route: ``create_row_iter`` (the parsers, the ``#cachefile`` page
    cache) and :func:`pack_rowblock`.  On LibSVM text both give the same
    batches.  With ``world=(rank, world_size)`` this process reads global
    partitions ``rank·num_parts + p`` of ``world_size·num_parts``."""
    from ..io.uri import URISpec

    spec = URISpec(uri, 0, 1)
    if (fmt == "libsvm" and spec.cache_file is None
            and spec.args.get("format", "libsvm") == "libsvm"):
        part_iter = functools.partial(_fused_part_iter, uri, batch_size,
                                      max_nnz)
    else:
        part_iter = functools.partial(_classic_part_iter, uri, fmt,
                                      batch_size, max_nnz)
    return DeviceFeed(device=device, num_parts=num_parts,
                      queue_depth=queue_depth,
                      source_builder=_builder(part_iter), world=world)


# ---------------------------------------------------------------------------
# RecordIO feeds
# ---------------------------------------------------------------------------

def _packed_part_iter(uri: str, part: int, n_parts: int, buf_bytes: int,
                      max_records: int, guard_bytes: int = 0):
    """One partition as packed batches: {data [buf_bytes + guard_bytes]
    uint8, offsets [max_records + 1] int32, count [1] int32}, payloads
    back to back in ``data[:buf_bytes]``, zero after (the guard region
    keeps the expander's windows in bounds).  One borrowed batch dict
    serves the epoch."""
    from ..io import input_split

    split = input_split.create(uri, part, n_parts, "recordio")
    try:
        data = np.empty(buf_bytes + guard_bytes, np.uint8)
        pack_dst = data[:buf_bytes]
        offsets = np.empty(max_records + 1, np.int32)
        count_arr = np.empty(1, np.int32)
        ends = np.empty(max_records, np.int64)
        count = 0
        pos = 0

        def emit():
            nonlocal count, pos
            data[pos:] = 0  # the tail and the guard only
            np.minimum(ends[:count], buf_bytes, out=ends[:count])
            offsets[0] = 0
            offsets[1: count + 1] = ends[:count]
            offsets[count + 1:] = offsets[count]
            count_arr[0] = count
            count = 0
            pos = 0
            return {"data": data, "offsets": offsets, "count": count_arr}

        while True:
            mv = split.next_chunk()
            if mv is None:
                break
            sp = _spans.chunk_spans(mv, source=uri,
                                    base=split.last_chunk_begin)
            if (sp[:, 2] % 2 == 0).all():
                # direct payloads: pack straight from the chunk
                src = mv
                offs = sp[:, 0].astype(np.int64)
                lens = sp[:, 1].astype(np.int64)
            else:  # an escaped-magic record: flatten, then pack
                views = _spans.chunk_record_views(mv, sp)
                lens = np.fromiter((v.size for v in views), np.int64,
                                   count=len(views))
                src = (np.concatenate(views) if views
                       else np.empty(0, np.uint8))
                offs = np.zeros(len(views), np.int64)
                if len(views) > 1:
                    np.cumsum(lens[:-1], out=offs[1:])
                del views
            i = 0
            n_spans = len(lens)
            while i < n_spans:
                consumed, pos, full = native.pack_spans(
                    src, offs[i:], lens[i:], pack_dst, pos,
                    max_records - count, count == 0, ends[count:])
                count += consumed
                i += consumed
                if full:
                    yield emit()
            src = mv = None
        if count:
            yield emit()
    finally:
        split.close()


def recordio_packed_feed(uri: str, *, buf_bytes: int,
                         max_records: int = 4096, num_parts: int = 1,
                         device=None, queue_depth: Optional[int] = None,
                         world=None) -> DeviceFeed:
    """RecordIO shards as packed batches, no per-record padding: {data
    [num_parts · buf_bytes] uint8, offsets [num_parts · (max_records+1)]
    int32, count [num_parts] int32}, each partition's payloads back to
    back in its ``buf_bytes`` with its record offsets.  Records larger
    than ``buf_bytes`` are truncated."""
    def part_iter(part: int, n_parts: int):
        return _packed_part_iter(uri, part, n_parts, buf_bytes, max_records)

    return DeviceFeed(device=device, num_parts=num_parts,
                      queue_depth=queue_depth,
                      source_builder=_builder(part_iter), world=world)


def _builder(part_iter):
    return lambda p, n: functools.partial(part_iter, p, n)


def _make_padded_expander(n_parts: int, batch_records: int, max_bytes: int,
                          stride: int):
    """The packed transport's expansion on the device: the packed staging
    layout ({data, offsets}) becomes the padded {data [n_parts·B,
    max_bytes], length} contract after the bytes crossed the link: row
    ``r`` is the window ``starts[r] + arange(max_bytes)`` of ``data``
    (the guard region after each partition's block keeps every window in
    bounds), zeroed past the record's length.  The expansion is the
    compute ledger's site ``feed.expand`` (:1222-1224)."""
    cache: Dict[torch.device, tuple] = {}

    def expand(data: torch.Tensor, offsets: torch.Tensor):
        dev = data.device
        if dev not in cache:
            cache[dev] = (torch.arange(n_parts, device=dev) * stride,
                          torch.arange(max_bytes, device=dev))
        base, cols = cache[dev]
        offs = offsets.view(n_parts, batch_records + 1).long()
        starts = (offs[:, :-1] + base[:, None]).reshape(-1)
        lens = torch.clamp(offs[:, 1:] - offs[:, :-1],
                           max=max_bytes).reshape(-1)
        rows = data[starts[:, None] + cols[None, :]]
        rows.mul_(cols[None, :] < lens[:, None])
        return rows, lens.to(torch.int32)

    site = telemetry.compute.profiled_site(expand, site="feed.expand")

    def transform(batch):
        rows, length = site(batch["data"], batch["offsets"])
        return {"data": rows, "length": length}

    return transform


def recordio_feed(uri: str, *, batch_records: int, max_bytes: int,
                  num_parts: int = 1, device=None,
                  queue_depth: Optional[int] = None, world=None,
                  pack_bytes: Optional[int] = None) -> DeviceFeed:
    """RecordIO shards as {data [num_parts · B, max_bytes] uint8, length
    [num_parts · B] int32}, ``B = batch_records`` rows of each partition,
    records zero-padded or truncated to ``max_bytes``; the epoch's last
    short batch of a partition is zero-padded (length 0).

    ``pack_bytes`` selects the packed transport: each partition stages its
    records back to back in ``pack_bytes`` (plus offsets) and the card
    expands the batch to the same padded contract after the copy, so the
    link carries payload, not padding.  A batch then holds up to
    ``batch_records`` rows of a partition (whatever fills ``pack_bytes``;
    the rest have length 0)."""
    from ..io import input_split

    if pack_bytes is not None:
        # the packed buffer must hold any record the padded contract
        # delivers, or a record would lose bytes the padded route keeps
        check(pack_bytes >= max_bytes,
              f"pack_bytes ({pack_bytes}) must be >= max_bytes ({max_bytes}) "
              "so no record is truncated below the padded contract")

        def part_iter_packed(part: int, n_parts: int):
            return _packed_part_iter(uri, part, n_parts, pack_bytes,
                                     batch_records, guard_bytes=max_bytes)

        feed = DeviceFeed(device=device, num_parts=num_parts,
                          queue_depth=queue_depth,
                          source_builder=_builder(part_iter_packed),
                          world=world)
        feed._transform = _make_padded_expander(
            num_parts, batch_records, max_bytes, pack_bytes + max_bytes)
        return feed

    def part_iter(part: int, n_parts: int):
        split = input_split.create(uri, part, n_parts, "recordio")
        try:
            # one borrowed batch buffer per iterator, filled chunk by chunk
            data = np.empty((batch_records, max_bytes), np.uint8)
            length = np.empty(batch_records, np.int32)
            batch = {"data": data, "length": length}
            # bounds the gather's transient index array to ~16 MB
            group_cap = max(1, (16 << 20) // max(max_bytes, 1))
            r = 0
            while True:
                mv = split.next_chunk()
                if mv is None:
                    break
                sp = _spans.chunk_spans(mv, source=uri,
                                        base=split.last_chunk_begin)
                i, n_spans = 0, sp.shape[0]
                while i < n_spans:
                    g = min(n_spans - i, batch_records - r, group_cap)
                    _spans.gather_rows_into(mv, sp, i, i + g, max_bytes,
                                            data[r:], length[r:])
                    i += g
                    r += g
                    if r == batch_records:
                        yield batch
                        r = 0
                mv = None
            if r:
                data[r:] = 0
                length[r:] = 0
                yield batch
        finally:
            split.close()

    return DeviceFeed(device=device, num_parts=num_parts,
                      queue_depth=queue_depth,
                      source_builder=_builder(part_iter), world=world)
