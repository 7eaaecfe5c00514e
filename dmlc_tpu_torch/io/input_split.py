"""Partitioned record ingestion: the byte-range input split (the port of
``dmlc_tpu/io/input_split.py``; reference src/io/input_split_base.cc,
recordio_split.cc and the factory in src/io.cc:63-119).

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
  - URI expansion: ';'-separated lists, directory listings (hidden
    '.'/'_' files skipped), regex match within a directory.

The port serves local files only, as views into their ``mmap`` (the JAX
package's zero-copy path); a record that crosses a file seam is copied
into one chunk.  The split types other than ``"recordio"`` and the
threaded and cached wrappers are later work (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import logging
import mmap
import os
import re
from bisect import bisect_right
from typing import List, Optional, Tuple

from ..base import DMLCError, check
from .filesys import FileInfo, FileSystem
from .recordio import (CRC_BIT, HEAD_CFLAGS, _MAGIC_BYTES, _U32, decode_flag,
                       decode_length, find_next_record_head, stored_crc)
from .uri import URI, URISpec

_logger = logging.getLogger("dmlc_tpu_torch.io")

__all__ = ["InputSplit", "InputSplitBase", "RecordIOSplitter", "create"]

# 8 MiB default chunk (kBufferSize = 2<<20 uint32 words,
# input_split_base.h:39-40)
DEFAULT_CHUNK_BYTES = (2 << 20) * 4

_SKIPPED = object()  # sentinel: the policy dropped a corrupt record


class ChunkCursor:
    """A loaded chunk and an extraction cursor (input_split_base.h:74-95):
    ``data`` (an ``mmap``, or bytes for a seam-crossing chunk) holds the
    chunk at ``[start, end)``; ``gbegin`` is the offset of ``start`` in
    the split's logical byte space, the key of quarantined spans."""

    __slots__ = ("data", "start", "pos", "end", "mv", "gbegin")

    def __init__(self, data, end: Optional[int] = None, start: int = 0,
                 gbegin: Optional[int] = None):
        self.data = data
        self.start = start
        self.pos = start
        self.end = len(data) if end is None else end
        self.mv: Optional[memoryview] = None
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
    """Byte-range partitioning over a list of local files, chunks served
    as views into their mappings."""

    _GROW = "grow"      # sentinel: no record head fits the window
    _STITCH = "stitch"  # sentinel: the pending record crosses a file seam

    def __init__(self, filesys: FileSystem, uri: str, align_bytes: int):
        self._filesys = filesys
        self._align = align_bytes
        self._source_uri = uri   # quarantine source label
        self.last_chunk_begin: Optional[int] = None
        self._files: List[FileInfo] = []
        self._init_input_file_info(uri)
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
        check(all(p is not None for p in self._local_paths),
              f"{uri}: the port's input split reads local files only")
        self._maps: List[Optional[mmap.mmap]] = [None] * len(self._files)
        self._offset_begin = 0
        self._offset_end = 0
        self._offset_curr = 0
        self._pending: Optional[ChunkCursor] = None
        self._served: Optional[ChunkCursor] = None
        self._served_mv: Optional[memoryview] = None

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

    def _gather(self, begin: int, end: int) -> bytearray:
        """Copy [begin, end) of the logical byte space out of the maps."""
        out = bytearray(end - begin)
        at, pos = 0, begin
        while pos < end:
            fj = bisect_right(self._file_offset, pos) - 1
            base = self._file_offset[fj]
            take = min(self._file_offset[fj + 1], end) - pos
            out[at: at + take] = self._get_map(fj)[pos - base:
                                                   pos - base + take]
            pos += take
            at += take
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

    def _load_cursor(self) -> Optional[ChunkCursor]:
        """Chunk::Load with geometric growth (input_split_base.cc:241-258):
        at most ``_chunk_bytes``, cut back to the last record head."""
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
            except OSError:
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

    def _init_input_file_info(self, uri: str) -> None:
        for path in self._convert_to_uris(uri):
            try:
                info = self._filesys.get_path_info(path)
            except OSError:
                continue  # unmatched; the final check reports it
            if info.type == "directory":
                dfiles = self._filesys.list_directory(info.path)
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
    def _advance_boundary(self, off: int) -> int:
        """A partition boundary moved to the next record start, unless it
        falls exactly on a file boundary."""
        if off >= self._file_offset[-1]:
            return self._file_offset[-1]
        fi = bisect_right(self._file_offset, off) - 1
        if off == self._file_offset[fi]:
            return off
        return off + self.seek_record_begin_mm(
            self._get_map(fi), off - self._file_offset[fi],
            self._files[fi].size)

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
        self._offset_end = self._advance_boundary(self._offset_end)
        self._offset_begin = self._advance_boundary(self._offset_begin)
        self.before_first()

    def before_first(self) -> None:
        self._offset_curr = self._offset_begin
        self._pending = None
        self._release_served()

    def _release_served(self) -> None:
        if self._served_mv is not None:
            _release(self._served_mv)
            self._served_mv = None
        if self._served is not None:
            self._served.release()
            self._served = None

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
                    return rec
                self._pending = None
            cur = self._load_cursor()
            if cur is None:
                return None
            self._pending = cur

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
        if self._pending is not None:
            self._pending.release()
            self._pending = None
        self._release_served()
        for i, mm in enumerate(self._maps):
            if mm is not None:
                try:
                    mm.close()
                except BufferError:
                    pass  # an outside view holds it; the GC unmaps it
                self._maps[i] = None


class RecordIOSplitter(InputSplitBase):
    """RecordIO records; a boundary is the magic followed by a head
    cflag, 0/1 plain or 4/5 checksummed (src/io/recordio_split.cc)."""

    def __init__(self, filesys, uri, part_index=0, num_parts=1):
        super().__init__(filesys, uri, align_bytes=4)
        self.reset_partition(part_index, num_parts)

    def find_last_record_begin(self, buf, begin: int, end: int) -> int:
        # backward u32 scan (recordio_split.cc:26-42)
        if end - begin < 8:
            return begin
        check((end - begin) % 4 == 0, "unaligned recordio chunk")
        hi = end - 4  # a head needs its magic at idx and lrec at idx+4
        while True:
            idx = buf.rfind(_MAGIC_BYTES, begin, hi)
            if idx <= begin:
                return begin
            if (idx - begin) % 4 == 0:
                if decode_flag(_U32.unpack_from(buf, idx + 4)[0]) \
                        in HEAD_CFLAGS:
                    return idx
            hi = idx + 3  # next candidate strictly below idx

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
        while True:
            rec = self._extract(chunk)
            if rec is not _SKIPPED:
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


def create(uri: str, part_index: int = 0, num_parts: int = 1,
           type: str = "recordio") -> InputSplitBase:
    """InputSplit factory (src/io.cc:63-119) for the ``"recordio"`` type.
    Unlike the JAX package's factory, the split is not wrapped in a
    prefetch thread: the device feed's parser workers read it."""
    spec = URISpec(uri, part_index, num_parts)
    check(part_index < num_parts, "invalid part_index for InputSplit.create")
    if type != "recordio":
        raise DMLCError(f"input split type {type!r} is not ported to "
                        "dmlc_tpu_torch yet (ROADMAP.md, Queue 1: the other "
                        "splitters); the port reads 'recordio'")
    if spec.cache_file is not None:
        raise DMLCError("#cachefile URIs are not ported to dmlc_tpu_torch "
                        "yet (ROADMAP.md, Queue 1: the other splitters)")
    path = URI(spec.uri)
    return RecordIOSplitter(FileSystem.get_instance(path), spec.uri,
                            part_index, num_parts)
