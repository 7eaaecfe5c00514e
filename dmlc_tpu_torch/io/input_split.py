"""Partitioned record ingestion: the input splits (the port of
``dmlc_tpu/io/input_split.py``; reference src/io/input_split_base.cc,
line_split.cc, recordio_split.cc, indexed_recordio_split.cc,
single_file_split.h and the factory in src/io.cc:63-119).

Semantics kept exactly, since they define which records each partition
reads for any ``num_parts``:

  - the file list is one logical byte range through prefix sums
    (input_split_base.cc:13-28);
  - ``reset_partition(rank, nsplit)``: nstep = ceil(total / nsplit)
    rounded up to ``align_bytes``; each boundary then moves to the next
    record start, except when it falls exactly on a file boundary
    (input_split_base.cc:30-64);
  - a chunk ends at the last record start in its window and grows
    geometrically when a window holds none (input_split_base.cc:211-258);
  - URI expansion: ';'-separated lists, directory listings (optionally
    recursive; hidden '.'/'_' files skipped), regex match within a
    directory.

Local files are served as views into their ``mmap`` (a record that
crosses a file seam is copied into one chunk); a source whose
filesystem gives no local path takes the copy path: pooled chunk
buffers filled by ``readinto`` with the partial record carried between
chunks.  The RecordIO scans run in the host C++
core (``native``): the last-head search that cuts every chunk, one fused
scan-and-verify per chunk for record extraction, and the shuffled
batch's span gather.  Line records are the exact line bytes (no
newline).

``create`` is the JAX package's factory: ``text``, ``recordio``,
``indexed_recordio`` and ``stdin``, a ``#cachefile`` URI wrapped in
``CachedInputSplit``, and otherwise the split wrapped in a prefetch
thread (``ThreadedInputSplit``) unless ``threaded=False``.
"""

from __future__ import annotations

import logging
import mmap
import os
import re
import sys
import time
from bisect import bisect_right
from typing import List, Optional, Tuple

import numpy as np

from .. import native, telemetry
from ..base import DMLCError, check
from .filesys import FileInfo, FileSystem, UnsupportedListing
from .recordio import (CRC_BIT, HEAD_CFLAGS, KMAGIC, _MAGIC_BYTES, _U32,
                       decode_flag, decode_length, find_next_record_head,
                       stored_crc)
from .stream import SeekStream
from .uri import URI, URISpec

_logger = logging.getLogger("dmlc_tpu_torch.io")

__all__ = ["InputSplit", "InputSplitBase", "LineSplitter",
           "RecordIOSplitter", "IndexedRecordIOSplitter", "SingleFileSplit",
           "create"]

# 8 MiB default chunk (kBufferSize = 2<<20 uint32 words,
# input_split_base.h:39-40)
DEFAULT_CHUNK_BYTES = (2 << 20) * 4

_SKIPPED = object()  # sentinel: the policy dropped a corrupt record


class ChunkCursor:
    """A loaded chunk and an extraction cursor (input_split_base.h:74-95):
    ``data`` (an ``mmap``, a pooled bytearray on the copy path, or bytes
    for a seam-crossing chunk) holds the chunk at ``[start, end)``;
    ``gbegin`` is the offset of ``start`` in the split's logical byte
    space, the key of quarantined spans; ``spans`` caches the native
    span table of a RecordIO chunk."""

    __slots__ = ("data", "start", "pos", "end", "mv", "spans", "span_i",
                 "gbegin")

    def __init__(self, data, end: Optional[int] = None, start: int = 0,
                 gbegin: Optional[int] = None):
        self.data = data
        self.start = start
        self.pos = start
        self.end = len(data) if end is None else end
        self.mv: Optional[memoryview] = None
        self.spans = None
        self.span_i = 0
        self.gbegin = gbegin

    def release(self) -> None:
        if self.mv is not None:
            _release(self.mv)
            self.mv = None


def _release(mv: memoryview) -> None:
    """Release a view this split exported.  One a caller has exported
    again (``np.frombuffer``) and still holds stays alive with that
    caller; the mapping then closes when the last such view goes."""
    try:
        mv.release()
    except BufferError:
        pass


class InputSplit:
    """Public interface (reference include/dmlc/io.h:135-282)."""

    def next_record(self) -> Optional[memoryview]:
        raise NotImplementedError

    def next_chunk(self) -> Optional[memoryview]:
        raise NotImplementedError

    def before_first(self) -> None:
        raise NotImplementedError

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        raise NotImplementedError

    def hint_chunk_size(self, chunk_size: int) -> None:
        pass

    def get_total_size(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __iter__(self):
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


class InputSplitBase(InputSplit):
    """Byte-range partitioning over a list of files: chunks served as
    views into their mappings, or through pooled copies where a file has
    no local path."""

    _GROW = "grow"      # sentinel: no record head fits the window
    _STITCH = "stitch"  # sentinel: the pending record crosses a file seam

    def __init__(self, filesys: FileSystem, uri: str, align_bytes: int,
                 recurse_directories: bool = False):
        self._filesys = filesys
        self._align = align_bytes
        self._source_uri = uri   # quarantine source label
        self.last_chunk_begin: Optional[int] = None
        self._files: List[FileInfo] = []
        self._init_input_file_info(uri, recurse_directories)
        self._file_offset = [0]
        for f in self._files:
            check(f.size % align_bytes == 0,
                  lambda f=f: f"file {f.path.name} does not align by "
                              f"{align_bytes} bytes")
            self._file_offset.append(self._file_offset[-1] + f.size)
        self._chunk_bytes = DEFAULT_CHUNK_BYTES
        # the smallest chunk that can hold a record head (magic + lrec)
        self._chunk_bytes_min = max(self._align * 2, 8)
        self._local_paths = [filesys.local_path(f.path) for f in self._files]
        self._mmap_ok = all(p is not None for p in self._local_paths)
        self._maps: List[Optional[mmap.mmap]] = [None] * len(self._files)
        self._np_maps: dict = {}
        self._fs: Optional[SeekStream] = None
        self._file_ptr = 0
        self._offset_begin = 0
        self._offset_end = 0
        self._offset_curr = 0
        self._overflow = b""
        self._pending: Optional[ChunkCursor] = None
        self._served: Optional[ChunkCursor] = None
        self._served_mv: Optional[memoryview] = None
        self._rec_count = 0  # flushed to telemetry in batches
        # free-list of full-size chunk buffers on the copy path (the
        # reference recycles chunks through ThreadedIter); never resized,
        # so a stale record view sees reused bytes, as in the reference
        self._pool: List[bytearray] = []

    # ---- chunk buffer pool (copy path) ---------------------------------
    def _take_buf(self, size: int) -> bytearray:
        # sizes must match: hint_chunk_size may have changed the chunk
        # size, and a short buffer would read as a partition tail
        if self._pool and len(self._pool[-1]) == size:
            return self._pool.pop()
        return bytearray(size)

    def recycle_chunk(self, chunk) -> None:
        """Return a consumed chunk's buffer for reuse (its records
        expire, io.h NextRecord).  Views into a mapping have no buffer to
        recycle."""
        if isinstance(chunk, ChunkCursor):
            chunk.release()
            buf = chunk.data
        else:
            buf = chunk
        if isinstance(buf, bytearray) and len(buf) == self._chunk_bytes \
                and len(self._pool) < 4:
            self._pool.append(buf)

    # ---- the mappings --------------------------------------------------
    def _get_map(self, i: int) -> mmap.mmap:
        mm = self._maps[i]
        if mm is None:
            fd = os.open(self._local_paths[i], os.O_RDONLY)
            try:
                mm = mmap.mmap(fd, 0, access=mmap.ACCESS_READ)
            finally:
                os.close(fd)  # the mapping outlives the descriptor
            self._maps[i] = mm
        return mm

    def _np_map(self, i: int) -> np.ndarray:
        """A uint8 numpy view over file ``i``'s mapping (cached)."""
        arr = self._np_maps.get(i)
        if arr is None:
            arr = self._np_maps[i] = np.frombuffer(self._get_map(i),
                                                   np.uint8)
        return arr

    def _mmap_try_window(self, curr: int, size: int):
        """One window at ``curr``: a ChunkCursor view into the file's
        mapping, _GROW (no record head fits in ``size``), or _STITCH (the
        pending record crosses a file seam)."""
        end_part = self._offset_end
        fi = bisect_right(self._file_offset, curr) - 1
        fbase = self._file_offset[fi]
        in_file_end = min(self._file_offset[fi + 1], end_part)
        mm = self._get_map(fi)
        window_end = min(curr + size, in_file_end)
        lo, hi = curr - fbase, window_end - fbase
        if window_end == end_part:
            cut = hi  # the partition end is record-aligned
        else:
            cut = self.find_last_record_begin(mm, lo, hi)
        if cut > lo:
            self._offset_curr = fbase + cut
            return ChunkCursor(mm, start=lo, end=cut, gbegin=curr)
        return self._GROW if window_end < in_file_end else self._STITCH

    def _load_cursor_mmap(self) -> Optional[ChunkCursor]:
        """One chunk as a view into the current file's mapping: at most
        ``_chunk_bytes``, cut back to the last record head, grown in place
        when a record is larger than the window."""
        curr = self._offset_curr
        if self._offset_begin >= self._offset_end or curr >= self._offset_end:
            return None
        size = self._chunk_bytes
        while True:
            cur = self._mmap_try_window(curr, size)
            if cur is self._GROW:
                size *= 2
                continue
            if cur is self._STITCH:
                return self._load_cursor_stitch(curr)
            return cur

    def _gather_into(self, out, at: int, begin: int, end: int) -> None:
        """Copy [begin, end) of the logical byte space into out[at:]."""
        pos = begin
        while pos < end:
            fj = bisect_right(self._file_offset, pos) - 1
            base = self._file_offset[fj]
            take = min(self._file_offset[fj + 1], end) - pos
            out[at: at + take] = self._get_map(fj)[pos - base:
                                                   pos - base + take]
            pos += take
            at += take

    def _gather(self, begin: int, end: int) -> bytearray:
        """Copy [begin, end) of the logical byte space out of the maps."""
        out = bytearray(end - begin)
        self._gather_into(out, 0, begin, end)
        return out

    def _load_cursor_stitch(self, curr: int) -> Optional[ChunkCursor]:
        """A seam-crossing chunk: bytes assembled across files, cut at
        the last record head."""
        end_part = self._offset_end
        size = max(self._chunk_bytes, self._chunk_bytes_min)
        while True:
            take_end = min(curr + size, end_part)
            buf = self._gather(curr, take_end)
            total = len(buf)
            cut = total if take_end == end_part \
                else self.find_last_record_begin(buf, 0, total)
            if cut > 0:
                self._offset_curr = curr + cut
                return ChunkCursor(bytes(buf[:cut]), gbegin=curr)
            if take_end == end_part:
                return None
            size *= 2

    # ---- URI expansion (input_split_base.cc:96-175) ----------------------
    def _convert_to_uris(self, uri: str) -> List[URI]:
        out: List[URI] = []
        for item in uri.split(";"):
            if not item:
                continue
            path = URI(item)
            pos = path.name.rfind("/")
            if pos < 0 or pos + 1 == len(path.name):
                out.append(path)
                continue
            dir_uri = URI(path.protocol + path.host + path.name[:pos])
            try:
                dfiles = self._filesys.list_directory(dir_uri)
            except (OSError, UnsupportedListing):
                # no listing on this backend (plain HTTP) or an unlistable
                # parent: the literal path, read by ranged reads.  A real
                # listing failure (credentials, transport) raises a plain
                # DMLCError and propagates
                out.append(path)
                continue
            target = path.name.rstrip("/")
            exact = [f for f in dfiles if f.path.name.rstrip("/") == target]
            if exact:
                out.append(exact[0].path)
                continue
            try:
                pattern = re.compile(path.name)
            except re.error as exc:
                raise DMLCError(f"bad regex {path.name!r}: {exc}") from exc
            matched = False
            for f in dfiles:
                if f.type != "file" or f.size == 0:
                    continue
                if pattern.fullmatch(f.path.name.rstrip("/")):
                    out.append(f.path)
                    matched = True
            if not matched:
                out.append(path)  # let get_path_info report the error
        return out

    def _init_input_file_info(self, uri: str, recurse: bool) -> None:
        for path in self._convert_to_uris(uri):
            try:
                info = self._filesys.get_path_info(path)
            except OSError:
                continue  # unmatched; the final check reports it
            if info.type == "directory":
                dfiles = (self._filesys.list_directory_recursive(info.path)
                          if recurse
                          else self._filesys.list_directory(info.path))
                # '.'/'_' basenames (writer temps, _SUCCESS markers) are
                # not data (the Hadoop convention the JAX package keeps)
                skipped = []
                for f in dfiles:
                    if f.size == 0 or f.type != "file":
                        continue
                    base = f.path.name.rpartition("/")[2]
                    if base.startswith((".", "_")):
                        skipped.append(base)
                    else:
                        self._files.append(f)
                if skipped:
                    _logger.info("input_split: directory %s: skipped %d "
                                 "hidden file(s): %s", info.path.str_uri(),
                                 len(skipped), ", ".join(skipped[:5]))
            elif info.size != 0:
                self._files.append(info)
        check(self._files,
              f"Cannot find any files that match the URI pattern {uri}")

    # ---- subclass hooks ------------------------------------------------
    def seek_record_begin(self, fs: SeekStream) -> int:
        """Bytes to skip from the stream position to the next record
        start (the copy path)."""
        raise NotImplementedError

    def find_last_record_begin(self, buf, begin: int, end: int) -> int:
        """The offset of the last record start in buf[begin:end), or
        ``begin`` when there is none."""
        raise NotImplementedError

    def seek_record_begin_mm(self, mm, off: int, end: int) -> int:
        """Bytes to skip from ``off`` to the next record start in
        mm[:end]."""
        raise NotImplementedError

    def extract_next_record(self, chunk: ChunkCursor
                            ) -> Optional[memoryview]:
        raise NotImplementedError

    # ---- partitioning (input_split_base.cc:30-64) ----------------------
    def _seek_local(self, fi: int, local: int) -> int:
        """Bytes from ``local`` in file ``fi`` to its next record start."""
        if self._mmap_ok:
            return self.seek_record_begin_mm(self._get_map(fi), local,
                                             self._files[fi].size)
        fs = self._filesys.open_for_read(self._files[fi].path)
        try:
            fs.seek(local)
            return self.seek_record_begin(fs)
        finally:
            fs.close()

    def _advance_boundary(self, off: int) -> int:
        """A partition boundary moved to the next record start, unless it
        falls exactly on a file boundary."""
        if off >= self._file_offset[-1]:
            return self._file_offset[-1]
        fi = bisect_right(self._file_offset, off) - 1
        if off == self._file_offset[fi]:
            return off
        return off + self._seek_local(fi, off - self._file_offset[fi])

    def partition_spans(self, num_parts: int) -> List[Tuple[int, int]]:
        """Record-aligned byte spans ``[(begin, end), ...]`` of every
        partition under ``num_parts``: a pure function of the files and
        ``num_parts`` that tiles the byte space exactly, so processes of
        any world size agree on it without talking."""
        check(num_parts >= 1, f"num_parts must be >= 1, got {num_parts}")
        ntotal, nstep = self._file_offset[-1], self._nstep(num_parts)
        cuts = [self._advance_boundary(min(nstep * i, ntotal))
                for i in range(num_parts + 1)]
        return list(zip(cuts[:-1], cuts[1:]))

    def _nstep(self, nsplit: int) -> int:
        """Bytes a partition spans before its boundaries move to record
        starts: ceil(total / nsplit) rounded up to the alignment."""
        nstep = (self._file_offset[-1] + nsplit - 1) // nsplit
        return ((nstep + self._align - 1) // self._align) * self._align

    def reset_partition(self, rank: int, nsplit: int) -> None:
        ntotal, nstep = self._file_offset[-1], self._nstep(nsplit)
        self._offset_begin = min(nstep * rank, ntotal)
        self._offset_end = min(nstep * (rank + 1), ntotal)
        self._offset_curr = self._offset_begin
        if self._offset_begin == self._offset_end:
            return
        if self._fs is not None:
            self._fs.close()
            self._fs = None
        self._offset_end = self._advance_boundary(self._offset_end)
        self._offset_begin = self._advance_boundary(self._offset_begin)
        self.before_first()

    def before_first(self) -> None:
        self._release_served()
        if self._pending is not None:
            self.recycle_chunk(self._pending)
            self._pending = None
        if self._offset_begin >= self._offset_end:
            return
        if not self._mmap_ok:
            fp = bisect_right(self._file_offset, self._offset_begin) - 1
            if self._file_ptr != fp or self._fs is None:
                if self._fs is not None:
                    self._fs.close()
                self._file_ptr = fp
                self._fs = self._filesys.open_for_read(self._files[fp].path)
            self._fs.seek(self._offset_begin - self._file_offset[fp])
        self._offset_curr = self._offset_begin
        self._overflow = b""

    def _release_served(self) -> None:
        if self._served_mv is not None:
            _release(self._served_mv)
            self._served_mv = None
        if self._served is not None:
            self.recycle_chunk(self._served)
            self._served = None

    # ---- the copy path (input_split_base.cc:177-239) -------------------
    def _read_into(self, mv: memoryview, start: int) -> int:
        """Fill mv[start:] from the partition, across file seams; fewer
        bytes only at the partition end."""
        if self._offset_begin >= self._offset_end:
            return 0
        size = min(len(mv) - start, self._offset_end - self._offset_curr)
        done = 0
        while done < size:
            n = self._fs.readinto(mv[start + done: start + size])
            self._offset_curr += n
            done += n
            if n == 0:
                check(self._offset_curr
                      == self._file_offset[self._file_ptr + 1],
                      "file offset not calculated correctly")
                if self._file_ptr + 1 >= len(self._files):
                    break
                self._file_ptr += 1
                self._fs.close()
                self._fs = self._filesys.open_for_read(
                    self._files[self._file_ptr].path)
        return done

    def _read_cursor(self, max_size: int):
        """One chunk with the overflow carry: None at the end, _GROW when
        the carried overflow alone fills ``max_size``, else a cursor over
        a pooled buffer whose ``end`` is the chunk's end."""
        if max_size <= len(self._overflow):
            return self._GROW
        olen = len(self._overflow)
        # the overflow was consumed from the stream already: this chunk's
        # global begin sits olen bytes behind the cursor
        gbegin = self._offset_curr - olen
        buf = self._take_buf(max_size)
        buf[:olen] = self._overflow
        total = olen + self._read_into(memoryview(buf), olen)
        self._overflow = b""
        if total == 0:
            self.recycle_chunk(buf)
            return None
        if total != max_size:  # the partition's tail is one chunk
            return ChunkCursor(buf, end=total, gbegin=gbegin)
        cut = self.find_last_record_begin(buf, 0, total)
        self._overflow = bytes(memoryview(buf)[cut:total])
        if cut == 0:  # no record head in the whole buffer
            self.recycle_chunk(buf)
            return self._GROW
        return ChunkCursor(buf, end=cut, gbegin=gbegin)

    def _load_cursor(self) -> Optional[ChunkCursor]:
        """Chunk::Load with geometric growth (input_split_base.cc:241-258),
        counted and timed as the JAX split's ``input_split`` metrics."""
        t0 = time.perf_counter()
        if self._mmap_ok:
            cur = self._load_cursor_mmap()
        else:
            size = self._chunk_bytes
            while True:
                cur = self._read_cursor(size)
                if cur is not self._GROW:
                    break
                size *= 2
        if cur is not None:
            telemetry.inc("input_split", "chunks")
            telemetry.inc("input_split", "bytes", cur.end - cur.start)
            telemetry.observe_duration("input_split", "chunk_latency",
                                       time.perf_counter() - t0)
        return cur

    def _load_chunk(self) -> Optional[bytes]:
        cur = self._load_cursor()
        if cur is None:
            return None
        data = bytes(memoryview(cur.data)[cur.start: cur.end])
        self.recycle_chunk(cur)
        return data

    # ---- public interface ----------------------------------------------
    def next_chunk(self) -> Optional[memoryview]:
        """The next chunk as a view; the previous chunk's view is
        released (its records expire, io.h NextChunk)."""
        self._release_served()
        cur = self._load_cursor()
        if cur is None:
            return None
        self._served = cur
        self.last_chunk_begin = cur.gbegin
        self._served_mv = memoryview(cur.data)[cur.start: cur.end]
        return self._served_mv

    def next_record(self) -> Optional[memoryview]:
        while True:
            if self._pending is not None:
                rec = self.extract_next_record(self._pending)
                if rec is not None:
                    self._rec_count += 1
                    if self._rec_count >= 4096:  # batched: the hot loop
                        self._flush_record_count()
                    return rec
                self.recycle_chunk(self._pending)
                self._pending = None
            cur = self._load_cursor()
            if cur is None:
                self._flush_record_count()
                return None
            self._pending = cur

    def _flush_record_count(self) -> None:
        if self._rec_count:
            telemetry.inc("input_split", "records", self._rec_count)
            self._rec_count = 0

    def hint_chunk_size(self, chunk_size: int) -> None:
        chunk_size = ((chunk_size + self._align - 1)
                      // self._align) * self._align
        self._chunk_bytes = max(chunk_size, self._chunk_bytes_min)

    def get_total_size(self) -> int:
        return self._file_offset[-1]

    def close(self) -> None:
        """Release the views this split exported, then close the maps.  A
        caller that still holds a view of its own keeps that mapping open
        until the view goes (``BufferError`` is the mapping refusing to
        close under it)."""
        self._flush_record_count()
        if self._pending is not None:
            self._pending.release()
            self._pending = None
        self._release_served()
        if self._fs is not None:
            self._fs.close()
            self._fs = None
        self._np_maps.clear()  # numpy views pin the mappings
        for i, mm in enumerate(self._maps):
            if mm is not None:
                try:
                    mm.close()
                except BufferError:
                    pass  # an outside view holds it; the GC unmaps it
                self._maps[i] = None


class LineSplitter(InputSplitBase):
    """Text records delimited by \\n / \\r (src/io/line_split.cc)."""

    def __init__(self, filesys, uri, part_index=0, num_parts=1):
        super().__init__(filesys, uri, align_bytes=1)
        self.reset_partition(part_index, num_parts)

    def seek_record_begin(self, fs: SeekStream) -> int:
        # to the first EOL, then past the EOL run (line_split.cc:9-26)
        nstep = 0
        while True:
            c = fs.read(1)
            if not c:
                return nstep
            nstep += 1
            if c in (b"\n", b"\r"):
                break
        while True:
            c = fs.read(1)
            if not c:
                return nstep
            if c not in (b"\n", b"\r"):
                break
            nstep += 1
        return nstep

    def find_last_record_begin(self, buf, begin: int, end: int) -> int:
        # the last EOL + 1, or begin (line_split.cc:27-34)
        last = max(buf.rfind(b"\n", begin, end), buf.rfind(b"\r", begin, end))
        return last + 1 if last >= begin else begin

    def seek_record_begin_mm(self, mm, off: int, end: int) -> int:
        n = mm.find(b"\n", off, end)
        r = mm.find(b"\r", off, end)
        if n < 0 and r < 0:
            return end - off
        p = (min(n, r) if (n >= 0 and r >= 0) else max(n, r)) + 1
        while p < end and mm[p] in (10, 13):
            p += 1
        return p - off

    def extract_next_record(self, chunk: ChunkCursor
                            ) -> Optional[memoryview]:
        if chunk.pos >= chunk.end:
            return None
        data = chunk.data
        n = data.find(b"\n", chunk.pos, chunk.end)
        r = data.find(b"\r", chunk.pos, chunk.end)
        eol = r if n < 0 else n if r < 0 else min(n, r)
        if eol < 0:
            eol = chunk.end
        if chunk.mv is None:
            chunk.mv = memoryview(data)
        rec = chunk.mv[chunk.pos: eol]
        # past the EOL run (line_split.cc:41-44)
        p = eol
        while p < chunk.end and data[p] in (10, 13):
            p += 1
        chunk.pos = p
        return rec


class RecordIOSplitter(InputSplitBase):
    """RecordIO records; a boundary is the magic followed by a head
    cflag, 0/1 plain or 4/5 checksummed (src/io/recordio_split.cc)."""

    def __init__(self, filesys, uri, part_index=0, num_parts=1,
                 recurse_directories=False):
        super().__init__(filesys, uri, align_bytes=4,
                         recurse_directories=recurse_directories)
        self.reset_partition(part_index, num_parts)

    def seek_record_begin(self, fs: SeekStream) -> int:
        # u32 walk from a 4-aligned position (recordio_split.cc:9-25)
        nstep = 0
        while True:
            v = fs.read(4)
            if not v:
                return nstep
            nstep += 4
            if v == _MAGIC_BYTES:
                lrec = fs.read(4)
                check(len(lrec) == 4, "invalid recordio format")
                nstep += 4
                if decode_flag(_U32.unpack(lrec)[0]) in HEAD_CFLAGS:
                    break
        return nstep - 8

    def find_last_record_begin(self, buf, begin: int, end: int) -> int:
        # backward u32 scan (recordio_split.cc:26-42), in the native core
        if end - begin < 8:
            return begin
        check((end - begin) % 4 == 0, "unaligned recordio chunk")
        with memoryview(buf) as mv:
            return begin + native.recordio_find_last(mv[begin:end], KMAGIC)

    def seek_record_begin_mm(self, mm, off: int, end: int) -> int:
        # an aligned magic whose lrec has a head cflag; after a non-head
        # cell the scan resumes past its lrec word (recordio_split.cc:9-25)
        pos = off
        while True:
            idx = mm.find(_MAGIC_BYTES, pos, end)
            if idx < 0:
                return end - off
            if (idx - off) % 4 != 0:
                pos = idx + 1
                continue
            check(idx + 8 <= end, "invalid recordio format")
            if decode_flag(_U32.unpack_from(mm, idx + 4)[0]) in HEAD_CFLAGS:
                return idx - off
            pos = idx + 8

    def _gpos(self, chunk: ChunkCursor, pos: int) -> Optional[int]:
        return None if chunk.gbegin is None else \
            chunk.gbegin + (pos - chunk.start)

    def _corrupt_at(self, chunk: ChunkCursor, begin: int, what: str) -> None:
        from .integrity import handle_corrupt

        handle_corrupt(what, source=self._source_uri,
                       begin=self._gpos(chunk, begin),
                       end=self._gpos(chunk, min(chunk.pos, chunk.end)))

    def _resync_chunk(self, chunk: ChunkCursor, frm: int) -> None:
        if chunk.mv is None:
            chunk.mv = memoryview(chunk.data)
        frm = min(chunk.end, frm + 4)
        rel = (frm - chunk.start) % 4
        if rel:
            frm += 4 - rel
        end = chunk.end - (chunk.end - chunk.start) % 4
        chunk.pos = (find_next_record_head(chunk.mv, frm, end)
                     if frm < end else chunk.end)
        if chunk.pos == end:
            chunk.pos = chunk.end

    def extract_next_record(self, chunk: ChunkCursor
                            ) -> Optional[memoryview]:
        """The next record: a clean chunk is scanned once by the native
        fused scan-and-verify (checksummed payloads are never re-read)
        and served from its span table; a chunk with any typed reject is
        walked record by record, which applies the integrity policy with
        the resync and quarantine keys of the JAX split."""
        from .integrity import should_drop

        while True:
            if chunk.pos >= chunk.end:
                return None
            if chunk.spans is None and chunk.pos == chunk.start:
                if chunk.mv is None:
                    chunk.mv = memoryview(chunk.data)
                sp = native.recordio_spans(chunk.mv[chunk.start: chunk.end],
                                           KMAGIC, verify=True)
                if sp.size and bool((sp[:, 2] >= 8).any()):
                    chunk.spans = ()  # corrupt: the record walk
                else:
                    lst = sp.tolist()
                    if chunk.start:
                        for t in lst:
                            t[0] += chunk.start
                    chunk.spans = lst
            sp = chunk.spans
            if sp is None or sp == ():
                rec = self._extract(chunk)
                if rec is _SKIPPED:
                    continue
                return rec
            i = chunk.span_i
            if i >= len(sp):
                chunk.pos = chunk.end
                return None
            off, length, flag = sp[i]
            chunk.span_i = i + 1
            if flag in (0, 2):
                # a complete record (a checksummed one verified in the
                # scan that made this table)
                chunk.pos = off + ((length + 3) & ~3)
                head = off - (12 if flag == 2 else 8)
                if should_drop(self._source_uri, self._gpos(chunk, head)):
                    continue
                return chunk.mv[off: off + length]
            # a multi-segment record (1 plain / 3 checksummed): the walk
            # over its region reassembles it
            sub = ChunkCursor(chunk.data, start=off, end=off + length,
                              gbegin=self._gpos(chunk, off))
            sub.spans = ()
            chunk.pos = off + length
            if should_drop(self._source_uri, self._gpos(chunk, off)):
                continue
            rec = self._extract(sub)
            sub.release()
            if rec is _SKIPPED or rec is None:
                continue
            return rec

    def _extract(self, chunk: ChunkCursor):
        """One record from ``chunk.pos`` by the header walk
        (recordio_split.cc:44-82 and the checksummed variant): the record,
        None at the chunk end, or _SKIPPED when the policy dropped one."""
        from .integrity import crc32c, should_drop

        if chunk.pos >= chunk.end:
            return None
        data = chunk.data
        if chunk.mv is None:
            chunk.mv = memoryview(data)
        mv = chunk.mv
        begin = chunk.pos
        if begin + 8 > chunk.end:
            chunk.pos = chunk.end
            self._corrupt_at(chunk, begin, "truncated header")
            return _SKIPPED
        # positions move BEFORE each report, so the reported span covers
        # the poisoned extent
        if mv[begin: begin + 4] != _MAGIC_BYTES:
            self._resync_chunk(chunk, begin)
            self._corrupt_at(chunk, begin, "bad magic")
            return _SKIPPED
        head_flag = decode_flag(_U32.unpack_from(data, begin + 4)[0])
        if head_flag not in HEAD_CFLAGS:
            self._resync_chunk(chunk, begin)
            self._corrupt_at(chunk, begin, f"cflag {head_flag} at head")
            return _SKIPPED
        checked = head_flag >= CRC_BIT
        parts = []
        bad = None
        first = True
        while True:
            pos = chunk.pos
            if pos + 8 > chunk.end or (
                    not first and mv[pos: pos + 4] != _MAGIC_BYTES):
                self._resync_chunk(chunk, pos)
                self._corrupt_at(chunk, begin, "torn record tail")
                return _SKIPPED
            lrec = _U32.unpack_from(data, pos + 4)[0]
            cflag = decode_flag(lrec)
            clen = decode_length(lrec)
            if not first and (cflag & 3 not in (2, 3)
                              or (cflag >= CRC_BIT) != checked):
                if cflag in HEAD_CFLAGS:
                    chunk.pos = pos  # the next record's head: keep it
                else:
                    self._resync_chunk(chunk, pos)
                self._corrupt_at(chunk, begin, "missing end segment")
                return _SKIPPED
            start = pos + 8
            want = None
            if checked:
                if start + 4 > chunk.end:
                    chunk.pos = chunk.end
                    self._corrupt_at(chunk, begin, "truncated crc word")
                    return _SKIPPED
                want = _U32.unpack_from(data, start)[0]
                start += 4
            nxt = start + (((clen + 3) >> 2) << 2)
            if nxt > chunk.end or start + clen > chunk.end:
                chunk.pos = chunk.end
                self._corrupt_at(chunk, begin, "truncated payload")
                return _SKIPPED
            chunk.pos = nxt
            seg = mv[start: start + clen]
            if checked and stored_crc(crc32c(seg)) != want:
                bad = bad or "crc32c mismatch"
            if first and cflag & 3 == 0:
                if bad is not None:
                    self._corrupt_at(chunk, begin, bad)
                    return _SKIPPED
                if should_drop(self._source_uri, self._gpos(chunk, begin)):
                    return _SKIPPED
                return seg
            if not first:
                parts.append(_MAGIC_BYTES)
            parts.append(bytes(seg))
            if cflag & 3 == 3:
                break
            first = False
        if bad is not None:
            self._corrupt_at(chunk, begin, bad)
            return _SKIPPED
        if should_drop(self._source_uri, self._gpos(chunk, begin)):
            return _SKIPPED
        return memoryview(b"".join(parts))


class IndexedRecordIOSplitter(RecordIOSplitter):
    """Record-granular partitioning driven by an index file, with optional
    per-epoch shuffled batched reads (src/io/indexed_recordio_split.cc).

    Index file: lines of ``<index> <offset>``; offsets are sorted and
    turned into (offset, length) pairs (ReadIndexFile, :43-61).  Shuffling
    re-permutes the partition's records every epoch (BeforeFirst,
    :220-232); a shuffled batch of one mapped file is one native gather.
    """

    KRAND_MAGIC = 111  # indexed_recordio_split.h:79

    def __init__(self, filesys, uri, index_uri, part_index=0, num_parts=1,
                 batch_size=256, shuffle=False, seed=0):
        # the base machinery without RecordIOSplitter's byte-range reset
        InputSplitBase.__init__(self, filesys, uri, align_bytes=4)
        self._shuffle = shuffle
        self._batch_size = batch_size
        import random as _random

        self._rng = _random.Random(self.KRAND_MAGIC + seed)
        self._index: List[Tuple[int, int]] = []
        self._read_index_file(index_uri)
        self._index_begin = 0
        self._index_end = 0
        self._current_index = 0
        self._n_overflow = 0
        self._permutation: List[int] = []
        self.reset_partition(part_index, num_parts)

    def _read_index_file(self, index_uri: str) -> None:
        expanded = self._convert_to_uris(index_uri)
        check(len(expanded) == 1,
              "IndexedRecordIOSplitter does not support multiple index files")
        fs = self._filesys.open_for_read(expanded[0])
        parts = []
        while True:
            b = fs.read(1 << 20)
            if not b:
                break
            parts.append(b)
        fs.close()
        offsets = []
        for line in b"".join(parts).decode("utf-8").split("\n"):
            toks = line.split()
            if len(toks) >= 2:
                offsets.append(int(toks[1]))
        offsets.sort()
        check(offsets, "empty index file")
        total = self._file_offset[-1]
        for j in range(len(offsets) - 1):
            self._index.append((offsets[j], offsets[j + 1] - offsets[j]))
        self._index.append((offsets[-1], total - offsets[-1]))
        # [N, 2] (offset, length) for the shuffled batch's span math
        self._index_np = np.asarray(self._index, dtype=np.int64)

    def reset_partition(self, rank: int, nsplit: int) -> None:
        # record-granular (indexed_recordio_split.cc:12-41)
        ntotal = len(self._index)
        nstep = (ntotal + nsplit - 1) // nsplit
        if rank * nstep >= ntotal:
            # an empty partition: no cursor of the previous one survives
            self._offset_begin = self._offset_end = 0
            self._index_begin = self._index_end = 0
            self._current_index = 0
            self._n_overflow = 0
            self._permutation = []
            self._pending = None
            return
        self._index_begin = rank * nstep
        self._offset_begin = self._index[self._index_begin][0]
        if (rank + 1) * nstep < ntotal:
            self._index_end = (rank + 1) * nstep
            self._offset_end = self._index[self._index_end][0]
        else:
            self._offset_end = self._file_offset[-1]
            self._index_end = ntotal
        self._offset_curr = self._offset_begin
        if self._fs is not None:
            self._fs.close()
            self._fs = None
        self._file_ptr = bisect_right(self._file_offset,
                                      self._offset_begin) - 1
        self._current_index = self._index_begin
        self._n_overflow = 0
        self.before_first()

    def before_first(self) -> None:
        if self._shuffle:
            self._permutation = list(range(self._index_begin,
                                           self._index_end))
            self._rng.shuffle(self._permutation)
            self._current_index = 0
        else:
            self._current_index = self._index_begin
        self._n_overflow = 0
        super().before_first()

    def _seek_to_offset(self, offset: int) -> None:
        fp = bisect_right(self._file_offset, offset) - 1
        if fp != self._file_ptr or self._fs is None:
            if self._fs is not None:
                self._fs.close()
            self._file_ptr = fp
            self._fs = self._filesys.open_for_read(self._files[fp].path)
        self._fs.seek(offset - self._file_offset[fp])
        self._offset_curr = offset

    def _read_exact_span(self, nbytes: int) -> bytes:
        out = bytearray()
        while len(out) < nbytes:
            data = self._fs.read(nbytes - len(out))
            self._offset_curr += len(data)
            if not data:
                if self._file_ptr + 1 >= len(self._files):
                    break
                self._file_ptr += 1
                self._fs.close()
                self._fs = self._filesys.open_for_read(
                    self._files[self._file_ptr].path)
                continue
            out += data
        return bytes(out)

    def _span_bytes(self, off: int, length: int):
        """[off, off + length) of the logical byte space: a gather from
        the maps, or a seek and read on the copy path."""
        if self._mmap_ok:
            self._offset_curr = off + length
            return self._gather(off, off + length)
        self._seek_to_offset(off)
        return self._read_exact_span(length)

    def next_batch_bytes(self, n_records: int):
        """One batch of whole records (NextBatchEx, :158-211)."""
        if self._shuffle:
            n = self._n_overflow or n_records
            take = self._permutation[self._current_index:
                                     self._current_index + n]
            if not take:
                return None
            self._current_index += len(take)
            self._n_overflow = n - len(take)
            if self._mmap_ok:
                span_np = self._index_np[np.asarray(take, dtype=np.int64)]
                offs, lens = span_np[:, 0], span_np[:, 1]
                self._offset_curr = int(offs[-1] + lens[-1])
                if len(self._files) == 1:
                    # one native call: the source is read in ascending
                    # offset order and written in batch order, so the
                    # permutation survives byte for byte
                    return memoryview(native.gather_spans(self._np_map(0),
                                                          offs, lens))
                views = []
                for off, ln in ((int(o), int(l)) for o, l in span_np):
                    fj = bisect_right(self._file_offset, off) - 1
                    base = self._file_offset[fj]
                    if off + ln <= self._file_offset[fj + 1]:
                        views.append(self._np_map(fj)[off - base:
                                                      off - base + ln])
                    else:  # a record across a file seam
                        tmp = np.empty(ln, np.uint8)
                        self._gather_into(memoryview(tmp), 0, off, off + ln)
                        views.append(tmp)
                out = (np.concatenate(views) if len(views) > 1
                       else views[0].copy())
                return memoryview(out)
            spans = [self._index[j] for j in take]
            out = bytearray(sum(ln for _, ln in spans))
            at = 0
            for off, ln in spans:
                self._seek_to_offset(off)
                out[at: at + ln] = self._read_exact_span(ln)
                at += ln
            return out
        if self._n_overflow == 0:
            last = min(self._current_index + n_records, self._index_end)
            self._n_overflow = self._current_index + n_records - last
        else:
            last = min(self._current_index + self._n_overflow,
                       self._index_end)
            self._n_overflow = self._current_index + self._n_overflow - last
        if last == self._current_index:
            return None
        begin_off = self._index[self._current_index][0]
        end_off = (self._index[last][0] if last < len(self._index)
                   else self._file_offset[-1])
        self._current_index = last
        return self._span_bytes(begin_off, end_off - begin_off)

    def next_chunk(self) -> Optional[memoryview]:
        data = self.next_batch_bytes(self._batch_size)
        return None if data is None else memoryview(data)

    def next_record(self) -> Optional[memoryview]:
        while True:
            if self._pending is not None:
                rec = self.extract_next_record(self._pending)
                if rec is not None:
                    self._rec_count += 1
                    if self._rec_count >= 4096:
                        self._flush_record_count()
                    return rec
                self._pending = None
            data = self.next_batch_bytes(self._batch_size)
            if data is None:
                self._flush_record_count()
                return None
            self._pending = ChunkCursor(data)


class SingleFileSplit(InputSplit):
    """stdin or one file of text, unpartitioned
    (src/io/single_file_split.h:27-174)."""

    def __init__(self, path: str):
        self._path = path
        self._use_stdin = path == "stdin"
        self._f = sys.stdin.buffer if self._use_stdin else open(path, "rb")
        self._buf = b""
        self._eof = False

    def next_record(self) -> Optional[memoryview]:
        while True:
            n = self._buf.find(b"\n")
            r = self._buf.find(b"\r")
            eol = (min(x for x in (n, r) if x >= 0)
                   if (n >= 0 or r >= 0) else -1)
            if eol >= 0:
                rec = self._buf[:eol]
                p = eol
                while p < len(self._buf) and self._buf[p] in (10, 13):
                    p += 1
                # the EOL run may go on past what is buffered
                if p == len(self._buf) and not self._eof:
                    data = self._f.read(1 << 16)
                    if data:
                        self._buf += data
                        continue
                    self._eof = True
                self._buf = self._buf[p:]
                return memoryview(rec)
            if self._eof:
                if self._buf:
                    rec, self._buf = self._buf, b""
                    return memoryview(rec)
                return None
            data = self._f.read(1 << 16)
            if not data:
                self._eof = True
            else:
                self._buf += data

    def next_chunk(self) -> Optional[memoryview]:
        # chunks until the read comes back empty (single_file_split.h)
        if self._buf:
            out, self._buf = self._buf, b""
            return memoryview(out)
        if self._eof:
            return None
        out = self._f.read(1 << 22)
        if not out:
            self._eof = True
            return None
        return memoryview(out)

    def before_first(self) -> None:
        check(not self._use_stdin, "stdin split cannot rewind")
        self._f.seek(0)
        self._buf = b""
        self._eof = False

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        check(num_parts == 1, "SingleFileSplit does not support partitioning")
        self.before_first()

    def get_total_size(self) -> int:
        return 0 if self._use_stdin else os.path.getsize(self._path)

    def close(self) -> None:
        if not self._use_stdin:
            self._f.close()


def create(uri: str, part_index: int = 0, num_parts: int = 1,
           type: str = "text", index_uri: Optional[str] = None,
           shuffle: bool = False, seed: int = 0, batch_size: int = 256,
           recurse_directories: bool = False,
           threaded: bool = True) -> InputSplit:
    """InputSplit factory (src/io.cc:63-119): dispatch by ``type``
    (``text``, ``recordio``, ``indexed_recordio``), the ``stdin`` URI,
    and the ``#cachefile`` sugar (``CachedInputSplit``); any other split
    is wrapped in a prefetch thread unless ``threaded=False``."""
    spec = URISpec(uri, part_index, num_parts)
    if spec.uri == "stdin":
        return SingleFileSplit("stdin")
    check(part_index < num_parts, "invalid part_index for InputSplit.create")
    fs = FileSystem.get_instance(URI(spec.uri))
    if type == "text":
        split: InputSplitBase = LineSplitter(fs, spec.uri, part_index,
                                             num_parts)
    elif type == "recordio":
        split = RecordIOSplitter(fs, spec.uri, part_index, num_parts,
                                 recurse_directories)
    elif type == "indexed_recordio":
        check(index_uri is not None,
              "need an index file to use indexed_recordio")
        index_spec = URISpec(index_uri, part_index, num_parts)
        return IndexedRecordIOSplitter(fs, spec.uri, index_spec.uri,
                                       part_index, num_parts, batch_size,
                                       shuffle, seed)
    else:
        raise DMLCError(f"unknown input split type {type!r}")
    if spec.cache_file is not None:
        from .cached_input_split import CachedInputSplit

        return CachedInputSplit(split, spec.cache_file)
    if threaded:
        from .threaded_input_split import ThreadedInputSplit

        return ThreadedInputSplit(split)
    return split
