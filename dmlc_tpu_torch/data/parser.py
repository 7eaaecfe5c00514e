"""Parser interfaces: streaming RowBlock producers over InputSplits (the
port of ``dmlc_tpu/data/parser.py``).

Rebuild of reference src/data/parser.h:23-126 (ParserImpl / ThreadedParser)
and src/data/text_parser.h (TextParserBase: pull a chunk via
InputSplit.next_chunk and parse it; the native core fans a chunk out over
C++ threads at line boundaries, the reference's OpenMP parse, and a
background thread overlaps parsing with IO).  The parse counters and the
parse timer are the JAX package's ``parser`` metrics, in the port's
``telemetry``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .. import telemetry
from ..base import DMLCError, get_env
from ..common import get_time
from ..concurrency import ThreadedIter
from ..io import input_split as isplit
from ..io.uri import URISpec
from ..registry import Registry
from .row_block import RowBlockContainer

__all__ = [
    "Parser",
    "TextParserBase",
    "ThreadedParser",
    "register_parser",
    "create_parser",
    "MetricLogger",
]


def effective_nthread(requested: Optional[int]) -> int:
    """Parse-thread policy (text_parser.h:30-35 behavior: bounded by half
    the cores); DMLC_TPU_PARSE_NTHREAD overrides, requested caps."""
    import os

    env = get_env("DMLC_TPU_PARSE_NTHREAD", 0)
    if env:
        return max(1, env)
    cap = max(1, (os.cpu_count() or 2) // 2)
    if requested is None:
        return min(4, cap)
    return max(1, min(requested, cap))


class Parser:
    """One-pass streaming iterator of RowBlocks (parser.h:23-50)."""

    def parse_next(self) -> Optional[List[RowBlockContainer]]:
        """Produce the next group of containers, or None at end."""
        raise NotImplementedError

    def before_first(self) -> None:
        raise NotImplementedError

    def bytes_read(self) -> int:
        raise NotImplementedError

    def __iter__(self):
        """Iterate RowBlocks (flattening container groups)."""
        while True:
            group = self.parse_next()
            if group is None:
                return
            for c in group:
                if c.size:
                    yield c.get_block()


class TextParserBase(Parser):
    """Chunk-pull + parse loop (text_parser.h:30-118). Subclasses implement
    ``parse_chunk(data, out: RowBlockContainer)`` where ``data`` is any
    bytes-like (the hot path hands the chunk memoryview straight to the
    native parser, which fans it out over C++ threads at line boundaries —
    the reference's OpenMP parallel parse, text_parser.h:89-118).
    """

    def __init__(self, source: isplit.InputSplit, nthread: Optional[int] = None):
        self._source = source
        self._bytes_read = 0
        self._nthread = effective_nthread(nthread)

    def parse_chunk(self, data, out: RowBlockContainer) -> None:
        raise NotImplementedError

    def parse_next(self) -> Optional[List[RowBlockContainer]]:
        chunk = self._source.next_chunk()
        if chunk is None:
            return None
        self._bytes_read += len(chunk)
        out = RowBlockContainer()
        with telemetry.timed("parser", "parse"):
            self.parse_chunk(chunk, out)
        telemetry.inc("parser", "bytes", len(chunk))
        telemetry.inc("parser", "blocks")
        telemetry.inc("parser", "rows", out.size)
        return [out]

    def before_first(self) -> None:
        self._source.before_first()
        self._bytes_read = 0

    def bytes_read(self) -> int:
        return self._bytes_read

    def close(self) -> None:
        if hasattr(self._source, "close"):
            self._source.close()


class ThreadedParser(Parser):
    """Background-thread prefetch wrapper (parser.h:75-126, capacity 8)."""

    def __init__(self, base: Parser, max_capacity: int = 8):
        self._base = base
        self._iter = ThreadedIter(
            lambda recycled: base.parse_next(),
            base.before_first,
            max_capacity=max_capacity,
        )

    def parse_next(self) -> Optional[List[RowBlockContainer]]:
        ok, group = self._iter.next()
        return group if ok else None

    def before_first(self) -> None:
        self._iter.before_first()

    def bytes_read(self) -> int:
        return self._base.bytes_read()

    def close(self) -> None:
        self._iter.destroy()
        if hasattr(self._base, "close"):
            self._base.close()


# ---- registry + factory (data.cc:62-107,150-158) -----------------------

PARSER_REGISTRY = Registry.get("data_parser")


def register_parser(name: str):
    """DMLC_REGISTER_DATA_PARSER analog (data.h:330-333). The factory
    signature is ``(uri, args: dict, part_index, num_parts) -> Parser``."""
    return PARSER_REGISTRY.register(name)


def create_parser(
    uri: str,
    part_index: int = 0,
    num_parts: int = 1,
    type: str = "auto",
    threaded: bool = True,
    nthread: Optional[int] = None,
    **extra_args,
) -> Parser:
    """Parser factory (data.cc:62-84): URI query args are parser params;
    ``type='auto'`` resolves via ``format=`` arg, defaulting to libsvm."""
    spec = URISpec(uri, part_index, num_parts)
    args = dict(spec.args)
    args.update({k: str(v) for k, v in extra_args.items()})
    if nthread is not None:
        args["nthread"] = str(nthread)
    if type == "auto":
        type = args.get("format", "libsvm")
    entry = PARSER_REGISTRY.find(type)
    if entry is None:
        raise DMLCError(
            f"unknown data format {type!r}; known: {PARSER_REGISTRY.list_all_names()}"
        )
    parser = entry.body(spec.uri, args, part_index, num_parts)
    if threaded:
        return ThreadedParser(parser)
    return parser


class MetricLogger:
    """MB/s progress logging every 10MB (basic_row_iter.h:68-75 behavior,
    kept as a compat feature per SURVEY.md §5)."""

    def __init__(self, log_fn: Callable[[str], None], interval_mb: float = 10.0):
        self._log = log_fn
        self._interval = interval_mb * (1 << 20)
        self._next_mark = self._interval
        self._start = get_time()

    def update(self, bytes_read: int) -> None:
        if bytes_read >= self._next_mark:
            elapsed = max(get_time() - self._start, 1e-9)
            mb = bytes_read / (1 << 20)
            self._log(f"{mb:.0f} MB read, {mb / elapsed:.2f} MB/sec")
            self._next_mark += self._interval
