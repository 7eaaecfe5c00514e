"""RowBlock iterators: eager in-memory and disk-cached page streaming (the
port of ``dmlc_tpu/data/row_iter.py``; the two packages' cache files are
byte-equal and each reads the other's).

Rebuild of reference src/data/basic_row_iter.h (eager parse into one
container, MB/s logging every 10MB) and src/data/disk_row_iter.h (parse once
into 64MB pages serialized to a cache file, then stream pages per epoch).
Factory behavior mirrors data.cc:87-107: ``#cachefile`` URI sugar selects
disk caching.
"""

from __future__ import annotations

import os
from typing import Optional

from .. import logging as log
from ..base import check
from ..concurrency import ThreadedIter
from ..io.stream import FileStream
from ..io.uri import URISpec
from .parser import MetricLogger, Parser, create_parser
from .row_block import RowBlock, RowBlockContainer

__all__ = ["RowBlockIter", "BasicRowIter", "DiskRowIter", "create_row_iter"]

KPAGE_SIZE = 64 << 20  # disk_row_iter.h:32



class RowBlockIter:
    """DataIter of RowBlocks (data.h:229-260)."""

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self) -> Optional[RowBlock]:
        raise NotImplementedError

    def num_col(self) -> int:
        raise NotImplementedError

    def __iter__(self):
        self.before_first()
        while True:
            blk = self.next()
            if blk is None:
                return
            yield blk


class BasicRowIter(RowBlockIter):
    """Eagerly parses the whole dataset into one in-memory block
    (basic_row_iter.h:62-82)."""

    def __init__(self, parser: Parser):
        self._container = RowBlockContainer()
        metric = MetricLogger(log.info)
        for group_block in parser.__iter__():
            self._container.push_arrays(
                labels=group_block.label,
                offsets=group_block.offset,
                index=group_block.index,
                value=group_block.value,
                weight=group_block.weight,
                field=group_block.field,
            )
            metric.update(parser.bytes_read())
        if hasattr(parser, "close"):
            parser.close()
        self._block = self._container.get_block() if self._container.size else None
        self._served = False

    def before_first(self) -> None:
        self._served = False

    def next(self) -> Optional[RowBlock]:
        if self._served or self._block is None:
            return None
        self._served = True
        return self._block

    def num_col(self) -> int:
        return self._container.max_index + 1


class DiskRowIter(RowBlockIter):
    """Parse once into page-sized containers serialized to a cache file,
    then stream pages from disk every epoch (disk_row_iter.h:95-141)."""

    def __init__(self, parser: Parser, cache_file: str, page_bytes: int = KPAGE_SIZE):
        self._cache_path = cache_file
        self._num_col = 0
        if not self._try_load_cache():
            self._build_cache(parser, page_bytes)
            check(self._try_load_cache(), f"failed to build cache {cache_file}")
        self._iter: Optional[ThreadedIter] = None
        self._f = None

    def _meta_path(self) -> str:
        return self._cache_path + ".meta"

    def _try_load_cache(self) -> bool:
        if not (os.path.exists(self._cache_path) and os.path.exists(self._meta_path())):
            return False
        with open(self._meta_path(), "r", encoding="utf-8") as f:
            self._num_col = int(f.read().strip())
        return True

    def _build_cache(self, parser: Parser, page_bytes: int) -> None:
        metric = MetricLogger(log.info)
        max_index = 0
        with open(self._cache_path + ".tmp", "wb") as raw:
            strm = FileStream(raw, own=False)
            page = RowBlockContainer()
            for block in parser.__iter__():
                page.push_arrays(
                    labels=block.label,
                    offsets=block.offset,
                    index=block.index,
                    value=block.value,
                    weight=block.weight,
                    field=block.field,
                )
                max_index = max(max_index, page.max_index)
                if page.mem_cost_bytes() >= page_bytes:
                    page.save(strm)
                    page = RowBlockContainer()
                metric.update(parser.bytes_read())
            if page.size:
                page.save(strm)
        os.replace(self._cache_path + ".tmp", self._cache_path)
        with open(self._meta_path(), "w", encoding="utf-8") as f:
            f.write(str(max_index + 1))
        if hasattr(parser, "close"):
            parser.close()

    def _open_iter(self) -> None:
        if self._f is not None:
            self._f.close()
        self._f = open(self._cache_path, "rb")
        strm = FileStream(self._f, own=False)

        def produce(recycled):
            c = recycled if recycled is not None else RowBlockContainer()
            if not c.load(strm):
                return None
            return c

        def rewind():
            self._f.seek(0)

        if self._iter is not None:
            self._iter.destroy()
        self._iter = ThreadedIter(produce, rewind, max_capacity=2)

    def before_first(self) -> None:
        if self._iter is None:
            self._open_iter()
        else:
            self._iter.before_first()
        self._pending_recycle = None

    def next(self) -> Optional[RowBlock]:
        if self._iter is None:
            self._open_iter()
        ok, container = self._iter.next()
        if not ok:
            return None
        blk = container.get_block()
        self._iter.recycle(container)
        return blk

    def num_col(self) -> int:
        return self._num_col

    def close(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
        if self._f is not None:
            self._f.close()


def create_row_iter(
    uri: str,
    part_index: int = 0,
    num_parts: int = 1,
    type: str = "auto",
    **extra_args,
) -> RowBlockIter:
    """RowBlockIter factory (data.cc:87-107): #cachefile selects DiskRowIter."""
    spec = URISpec(uri, part_index, num_parts)
    if spec.cache_file:
        # a completed cache makes the source optional (lazy parser creation;
        # improves on the reference, which constructs the parser eagerly)
        if os.path.exists(spec.cache_file) and os.path.exists(spec.cache_file + ".meta"):
            return DiskRowIter(
                _LazyParser(uri, part_index, num_parts, type, extra_args),
                spec.cache_file)
        parser = create_parser(uri, part_index, num_parts, type, **extra_args)
        return DiskRowIter(parser, spec.cache_file)
    parser = create_parser(uri, part_index, num_parts, type, **extra_args)
    return BasicRowIter(parser)


class _LazyParser(Parser):
    """Placeholder parser for cache-hit DiskRowIter; only materializes if the
    cache turns out to be unreadable."""

    def __init__(self, uri, part_index, num_parts, type, extra_args):
        self._spec = (uri, part_index, num_parts, type, extra_args)
        self._real: Optional[Parser] = None

    def _materialize(self) -> Parser:
        if self._real is None:
            uri, part_index, num_parts, type, extra_args = self._spec
            self._real = create_parser(uri, part_index, num_parts, type, **extra_args)
        return self._real

    def parse_next(self):
        return self._materialize().parse_next()

    def before_first(self):
        return self._materialize().before_first()

    def bytes_read(self):
        return 0 if self._real is None else self._real.bytes_read()
