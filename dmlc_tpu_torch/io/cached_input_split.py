"""Cache-on-first-pass wrapper: stream chunks to a local cache file while
serving them; later epochs replay from the cache (the port of
``dmlc_tpu/io/cached_input_split.py``; its cache files are byte-equal to
the JAX package's and each package replays the other's).

Rebuild of reference src/io/cached_input_split.h:63-189. Selected by the
``#cachefile`` URI sugar (src/io.cc:109-113). ``reset_partition`` is
unsupported, matching the reference (:87-89).

Cache layout (versioned): new files open with the 8-byte header
``dmlcCC01`` and frame every chunk as ``u64 size + raw bytes + u32
CRC32C`` — the same CRC32C the RecordIO record variant uses, so a bit
rotting on the local cache disk is detected instead of silently served
for every later epoch.  A pre-existing cache that fails verification is
counted (``dmlc_io_cache_integrity_failures``), discarded, and rebuilt
from the base split — the epoch is re-parsed, never failed.  Legacy
caches (u64 size + bytes, no header) still replay, unverified.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

from .. import logging as log
from .. import telemetry
from ..base import DMLCError
from ..concurrency import ThreadedIter
from .input_split import ChunkCursor, InputSplit, InputSplitBase
from .integrity import crc32c

__all__ = ["CachedInputSplit"]

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_CACHE_MAGIC = b"dmlcCC01"


class CachedInputSplit(InputSplit):
    def __init__(self, base: InputSplitBase, cache_file: str):
        self._base = base
        self._cache_path = cache_file
        self._chunk: Optional[ChunkCursor] = None
        self._checked = False  # replaying a crc-stamped cache
        if os.path.exists(self._cache_path) and self._verify_cache():
            # a completed, verified cache from an earlier run: replay
            self._writer = None
            self._cache_f = open(self._cache_path, "rb")
            self._checked = self._read_header(self._cache_f)
            self._iter = ThreadedIter(self._read_cache_chunk, self._reopen_cache, 2)
        else:
            self._cache_f = None
            self._writer = open(self._cache_path + ".tmp", "wb")
            self._writer.write(_CACHE_MAGIC)
            self._iter = ThreadedIter(self._produce_and_cache, None, 2)

    # ---- integrity -------------------------------------------------------
    @staticmethod
    def _read_header(f) -> bool:
        """True (and positioned past it) when ``f`` opens with the
        crc-stamped header; False (rewound) for a legacy cache."""
        head = f.read(len(_CACHE_MAGIC))
        if head == _CACHE_MAGIC:
            return True
        f.seek(0)
        return False

    def _verify_cache(self) -> bool:
        """One sequential pass over a pre-existing cache, verifying
        every chunk's CRC32C footer (legacy caches verify structure
        only).  On mismatch: count, warn, delete — the caller rebuilds
        from the base split instead of failing the epoch."""
        try:
            with open(self._cache_path, "rb") as f:
                checked = self._read_header(f)
                while True:
                    hdr = f.read(8)
                    if len(hdr) == 0:
                        return True
                    if len(hdr) < 8:
                        raise DMLCError("torn chunk header")
                    (n,) = _U64.unpack(hdr)
                    data = f.read(n)
                    if len(data) != n:
                        raise DMLCError("torn chunk payload")
                    if checked:
                        crcb = f.read(4)
                        if len(crcb) < 4:
                            raise DMLCError("torn crc footer")
                        if _U32.unpack(crcb)[0] != crc32c(data):
                            raise DMLCError("crc32c mismatch")
        except (OSError, DMLCError) as e:
            telemetry.inc("io_cache", "integrity_failures")
            telemetry.record_event("cache_integrity_failure",
                                   path=self._cache_path, error=str(e))
            log.warning(f"epoch cache {self._cache_path} failed integrity "
                        f"verification ({e}); discarding and re-parsing "
                        f"from the source")
            try:
                os.remove(self._cache_path)
            except OSError:
                pass
            return False

    # ---- first pass: read base, tee to cache (cached_input_split.h:63-86)
    def _produce_and_cache(self, recycled):
        data = self._base._load_chunk()
        if data is None:
            # finalize on EOF so a single-epoch run still produces the cache
            # (reference finalizes on destruction)
            self._finish_cache()
            return None
        self._writer.write(_U64.pack(len(data)))
        self._writer.write(data)
        self._writer.write(_U32.pack(crc32c(data)))
        return data

    def _finish_cache(self) -> None:
        if self._writer is not None:
            self._writer.close()
            os.replace(self._cache_path + ".tmp", self._cache_path)
            self._writer = None
            self._base.close()

    # ---- replay pass ---------------------------------------------------
    def _reopen_cache(self) -> None:
        self._cache_f.seek(len(_CACHE_MAGIC) if self._checked else 0)

    def _read_cache_chunk(self, recycled):
        hdr = self._cache_f.read(8)
        if len(hdr) < 8:
            return None
        (n,) = _U64.unpack(hdr)
        data = self._cache_f.read(n)
        if len(data) != n:
            raise DMLCError(f"corrupt cache file {self._cache_path}")
        if self._checked:
            crcb = self._cache_f.read(4)
            if len(crcb) < 4 or _U32.unpack(crcb)[0] != crc32c(data):
                # the cache verified at open and rotted mid-run: count
                # it and fail THIS read loudly — a fresh split re-parses
                telemetry.inc("io_cache", "integrity_failures")
                raise DMLCError(
                    f"cache file {self._cache_path} failed its CRC32C "
                    f"footer mid-replay (disk corruption after the "
                    f"open-time verification)")
        return data

    # ---- InputSplit interface ------------------------------------------
    def next_record(self) -> Optional[memoryview]:
        while True:
            if self._chunk is not None:
                rec = self._base.extract_next_record(self._chunk)
                if rec is not None:
                    return rec
                self._chunk = None
            ok, data = self._iter.next()
            if not ok:
                return None
            self._chunk = ChunkCursor(data)

    def next_chunk(self) -> Optional[memoryview]:
        self._chunk = None
        ok, data = self._iter.next()
        return memoryview(data) if ok else None

    def before_first(self) -> None:
        # drain the first pass (completing the cache), then switch to replay
        if self._cache_f is None:
            while True:
                ok, _ = self._iter.next()
                if not ok:
                    break
            self._iter.destroy()
            self._finish_cache()  # no-op if the producer already finalized
            self._cache_f = open(self._cache_path, "rb")
            self._checked = self._read_header(self._cache_f)
            self._iter = ThreadedIter(self._read_cache_chunk, self._reopen_cache, 2)
        else:
            self._iter.before_first()
        self._chunk = None

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        raise DMLCError(
            "CachedInputSplit does not support reset_partition "
            "(cached_input_split.h:87-89)"
        )

    def hint_chunk_size(self, chunk_size: int) -> None:
        self._base.hint_chunk_size(chunk_size)

    def get_total_size(self) -> int:
        return self._base.get_total_size()

    def close(self) -> None:
        self._iter.destroy()
        if self._writer is not None:
            # first pass never reached EOF: the partial cache is unusable
            self._writer.close()
            self._writer = None
            tmp = self._cache_path + ".tmp"
            if os.path.exists(tmp):
                os.remove(tmp)
        if self._cache_f is not None:
            self._cache_f.close()
        self._base.close()
