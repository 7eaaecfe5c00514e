"""Double-buffered background prefetch wrapper over an InputSplitBase (the
port of ``dmlc_tpu/io/threaded_input_split.py``).

Rebuild of reference src/io/threaded_input_split.h:23-101: a producer thread
pulls chunks via the base split while the consumer extracts records from the
previous chunk — capacity 2 (double buffering), applied by default by the
factory (src/io.cc:108-113).

Telemetry: per-chunk load latency is recorded by the base split
(``input_split.chunk_latency_secs`` histogram); this wrapper adds
``input_split.producer_idle_secs`` — time the producer thread spends NOT
loading (blocked on prefetch capacity), i.e. how far ahead of the
consumer the storage path could run.
"""

from __future__ import annotations

import time
from typing import Optional

from .. import telemetry
from ..concurrency import ThreadedIter
from .input_split import ChunkCursor, InputSplit, InputSplitBase, _release

__all__ = ["ThreadedInputSplit"]


class ThreadedInputSplit(InputSplit):
    def __init__(self, base: InputSplitBase, max_capacity: int = 2):
        self._base = base
        self._cap = max_capacity
        self._chunk: Optional[ChunkCursor] = None
        self._served_mv: Optional[memoryview] = None
        self.last_chunk_begin: Optional[int] = None  # of the chunk most
        # recently served by next_chunk (integrity quarantine keys);
        # rides the cursor through the prefetch queue, so prefetch depth
        # never skews it
        self._last_produce_end: Optional[float] = None
        self._iter: ThreadedIter = ThreadedIter(
            self._produce, self._rewind, max_capacity=max_capacity
        )

    def _produce(self, recycled):
        # runs on the producer thread; recycled cursors return their
        # buffers to the base pool here, so pool access stays single-thread
        t0 = time.perf_counter()
        if self._last_produce_end is not None:
            telemetry.observe_duration("input_split", "producer_idle",
                                       t0 - self._last_produce_end)
        if recycled is not None:
            self._base.recycle_chunk(recycled)
        cur = self._base._load_cursor()
        self._last_produce_end = time.perf_counter()
        return cur

    def _rewind(self) -> None:
        self._last_produce_end = None  # the rewind gap is not idle time
        self._base.before_first()

    # ---- InputSplit interface ------------------------------------------
    def next_record(self) -> Optional[memoryview]:
        base = self._base
        while True:
            if self._chunk is not None:
                rec = base.extract_next_record(self._chunk)
                if rec is not None:
                    # the base's batched record counter; only this
                    # (consumer) thread touches it on the threaded path
                    base._rec_count += 1
                    if base._rec_count >= 4096:
                        base._flush_record_count()
                    return rec
                self._iter.recycle(self._chunk)
                self._chunk = None
            ok, cur = self._iter.next()
            if not ok:
                base._flush_record_count()
                return None
            self._chunk = cur

    def _release_served(self) -> None:
        # the previous chunk's view expires (io.h NextChunk), so its
        # mapping can close once no caller holds a view of its own
        if self._served_mv is not None:
            _release(self._served_mv)
            self._served_mv = None

    def next_chunk(self) -> Optional[memoryview]:
        self._release_served()
        if self._chunk is not None:
            self._iter.recycle(self._chunk)
            self._chunk = None
        ok, cur = self._iter.next()
        if not ok:
            return None
        self._chunk = cur
        self.last_chunk_begin = cur.gbegin
        self._served_mv = memoryview(cur.data)[cur.pos: cur.end]
        return self._served_mv

    def before_first(self) -> None:
        self._release_served()
        self._iter.before_first()
        self._chunk = None

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        # must quiesce the producer before mutating the base split
        self._iter.destroy()
        self._base.reset_partition(part_index, num_parts)
        self._chunk = None
        self._last_produce_end = None
        self._iter = ThreadedIter(self._produce, self._rewind, max_capacity=self._cap)

    def hint_chunk_size(self, chunk_size: int) -> None:
        self._base.hint_chunk_size(chunk_size)

    def get_total_size(self) -> int:
        return self._base.get_total_size()

    def close(self) -> None:
        self._release_served()
        self._iter.destroy()
        if self._chunk is not None:
            self._chunk.release()
            self._chunk = None
        self._base.close()
