"""The port's host native core, in C++: CRC-32C (``csrc/crc32c.cc``) and
the text parsers, the RecordIO chunk scan and the feed's packs
(``csrc/dmlc_native.cc``, a copy of the JAX package's native core).

Both sources build with ``g++ -pthread`` at first use into one library
under ``build/dmlc_tpu_torch/`` at the root of the checkout, named by a
hash of the sources and the flags (as ``ops/_build.py`` names the CUDA
libraries), and load with ``ctypes.CDLL``, which releases the GIL for
the length of every call: multi-threaded parses (``nthread > 1``) and
the feed's parser threads overlap.  Every entry point takes any
C-contiguous bytes-like object (bytes, bytearray, memoryviews of an
``mmap``) without a copy.

A failed build raises: no route falls back to Python.  The plain
versions (``io.integrity._crc32c_py``, ``feed.spans``'s ``*_plain``
functions, the parsers' ``parse_chunk_plain``, ``pack_rowblock_plain``)
stay beside their callers for the tests to hold these against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Union

import numpy as np

from ..base import DMLCError

__all__ = ["crc32c", "crc32c_table", "crc32c_hardware", "library_path",
           "parse_libsvm", "parse_libfm", "parse_csv", "recordio_spans",
           "recordio_find_last", "pad_pack_rows", "pad_pack_csr",
           "parse_libsvm_into", "gather_spans", "pack_spans"]

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = (CSRC / "crc32c.cc", CSRC / "dmlc_native.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dmlc_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_ABI = 6

_lock = threading.Lock()
_lib = None


def library_path(sources: Sequence[Path] = SOURCES,
                 libs: Sequence[str] = ()) -> Path:
    """The library built from ``sources`` (and the headers among them)
    with ``CXX_FLAGS`` and ``libs``, named after the last source and a
    hash of every file and flag."""
    h = hashlib.sha256()
    for s in sources:
        h.update(s.read_bytes())
    h.update(" ".join([*CXX_FLAGS, *libs]).encode())
    return BUILD_DIR / f"{sources[-1].stem}-{h.hexdigest()[:16]}.so"


def _build(sources: Union[Path, Sequence[Path]], lib: Path,
           libs: Sequence[str] = ()) -> None:
    """Compile under a per-process name and rename into place, so a
    concurrent builder never loads a half-written library."""
    srcs = [sources] if isinstance(sources, Path) else list(sources)
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    names = ", ".join(s.name for s in srcs)
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, *map(str, srcs), "-o",
                              str(tmp), *libs], capture_output=True,
                             text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise DMLCError(f"g++ could not build {names}: {exc}") from exc
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise DMLCError(f"g++ failed on {names} "
                        f"(exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)


def _bind(lib) -> None:
    c = ctypes
    p, lg, i = c.c_void_p, c.c_long, c.c_int
    plong, pint = c.POINTER(c.c_long), c.POINTER(c.c_int)
    sigs = {
        "dmlc_crc32c": (c.c_uint32, [p, lg, c.c_uint32]),
        "dmlc_crc32c_table": (c.c_uint32, [p, lg, c.c_uint32]),
        "dmlc_crc32c_hw": (i, []),
        "dmlc_native_abi_version": (i, []),
        "dmlc_parse_libsvm": (lg, [p, lg, p, p, p, p, p, lg, lg, i, plong,
                                   plong, pint]),
        "dmlc_parse_libfm": (lg, [p, lg, p, p, p, p, p, p, lg, lg, i, plong,
                                  plong, pint]),
        "dmlc_parse_csv": (lg, [p, lg, c.c_char, i, p, lg, plong, plong]),
        "dmlc_recordio_spans": (lg, [p, lg, c.c_uint32, p, lg, plong]),
        "dmlc_recordio_spans_verify": (lg, [p, lg, c.c_uint32, i, p, lg,
                                            plong]),
        "dmlc_recordio_find_last": (lg, [p, lg, c.c_uint32]),
        "dmlc_gather_spans": (lg, [p, lg, p, p, p, p, p, lg]),
        "dmlc_pack_spans": (lg, [p, lg, p, lg, lg, p, p, lg, lg, i, p, plong,
                                 pint]),
        "dmlc_pad_pack_rows": (lg, [p, lg, p, lg, c.c_uint32, lg, p, p]),
        "dmlc_pad_pack_csr": (lg, [p, p, p, p, lg, lg, lg, lg, lg, p, p, p,
                                   p]),
        "dmlc_parse_libsvm_into": (lg, [p, lg, lg, lg, lg, lg, lg, p, p, p,
                                        p, plong, plong]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(SOURCES, path)
            lib = ctypes.CDLL(str(path))
            _bind(lib)
            abi = lib.dmlc_native_abi_version()
            if abi != _ABI:
                raise DMLCError(f"{path.name}: native ABI {abi}, the "
                                f"bindings expect {_ABI}")
            _lib = lib
        return _lib


def _bytes_view(data) -> np.ndarray:
    """A uint8 numpy view over any C-contiguous bytes-like, no copy (the
    view keeps the buffer alive for the length of the call)."""
    mv = memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    return np.frombuffer(mv, np.uint8)


def _count(data, arr: np.ndarray, byte: int) -> int:
    """Occurrences of ``byte``: ``.count`` where the object has it,
    numpy otherwise (a memoryview has no ``.count``)."""
    if isinstance(data, (bytes, bytearray)):
        return data.count(bytes((byte,)))
    return int(np.count_nonzero(arr == byte))


# ---- CRC-32C ---------------------------------------------------------------

def crc32c(data, value: int = 0) -> int:
    """CRC-32C of ``data`` (any bytes-like) chained from ``value``."""
    a = _bytes_view(data)
    return int(_load().dmlc_crc32c(a.ctypes.data, a.size,
                                   value & 0xFFFFFFFF))


def crc32c_table(data, value: int = 0) -> int:
    """The same value through the slicing-by-8 table route alone."""
    a = _bytes_view(data)
    return int(_load().dmlc_crc32c_table(a.ctypes.data, a.size,
                                         value & 0xFFFFFFFF))


def crc32c_hardware() -> bool:
    """Whether :func:`crc32c` takes the SSE4.2 instruction route here."""
    return bool(_load().dmlc_crc32c_hw())


# ---- text parsers ----------------------------------------------------------

def _parse_sparse(data, nthread: int, fields: bool) -> dict:
    lib = _load()
    arr = _bytes_view(data)
    ptr, n = arr.ctypes.data, arr.size
    max_rows = _count(data, arr, 10) + 2
    # one feature at most per separator-delimited token
    max_nnz = _count(data, arr, 32) + _count(data, arr, 9) + max_rows + 1
    what = "LibFM" if fields else "LibSVM"
    while True:
        labels = np.empty(max_rows, np.float32)
        weights = np.empty(max_rows, np.float32)
        offsets = np.empty(max_rows + 1, np.uint64)
        index = np.empty(max_nnz, np.uint32)
        value = np.empty(max_nnz, np.float32)
        n_rows, n_nnz, has_w = ctypes.c_long(), ctypes.c_long(), \
            ctypes.c_int()
        if fields:
            fld = np.empty(max_nnz, np.uint32)
            ret = lib.dmlc_parse_libfm(
                ptr, n, labels.ctypes.data, weights.ctypes.data,
                offsets.ctypes.data, fld.ctypes.data, index.ctypes.data,
                value.ctypes.data, max_rows, max_nnz, nthread,
                ctypes.byref(n_rows), ctypes.byref(n_nnz),
                ctypes.byref(has_w))
        else:
            ret = lib.dmlc_parse_libsvm(
                ptr, n, labels.ctypes.data, weights.ctypes.data,
                offsets.ctypes.data, index.ctypes.data, value.ctypes.data,
                max_rows, max_nnz, nthread, ctypes.byref(n_rows),
                ctypes.byref(n_nnz), ctypes.byref(has_w))
        if ret == -1:
            max_rows *= 2
            max_nnz *= 2
            continue
        if ret != 0:
            raise ValueError(f"malformed {what} input (code {ret})")
        r, z = n_rows.value, n_nnz.value
        out = {"labels": labels[:r],
               "weights": weights[:r] if has_w.value else None,
               "offsets": offsets[:r + 1], "index": index[:z],
               "value": value[:z]}
        if fields:
            out["fields"] = fld[:z]
        return out


def parse_libsvm(data, nthread: int = 1) -> dict:
    """A LibSVM chunk (``label[:weight] idx[:val] ...`` per line) as
    arrays {labels, weights (None when no row has one), offsets, index,
    value}.  Raises ValueError on malformed input."""
    return _parse_sparse(data, nthread, False)


def parse_libfm(data, nthread: int = 1) -> dict:
    """A LibFM chunk (``label[:weight] field:idx:val ...``): the arrays of
    :func:`parse_libsvm` plus ``fields``."""
    return _parse_sparse(data, nthread, True)


def parse_csv(data, delim: bytes = b",", nthread: int = 1) -> np.ndarray:
    """A numeric CSV chunk as ``[rows, cols]`` float32.  Raises
    ValueError on a non-numeric cell or ragged rows.  The number scanner
    skips blanks, so a whitespace delimiter is the caller's to refuse."""
    if delim in (b" ", b"\t", b"\r") or len(delim) != 1:
        raise ValueError(f"the native CSV parser takes a one-byte "
                         f"non-blank delimiter, not {delim!r}")
    lib = _load()
    arr = _bytes_view(data)
    max_vals = arr.size // 2 + 16
    out = np.empty(max_vals, np.float32)
    n_rows, n_cols = ctypes.c_long(), ctypes.c_long()
    ret = lib.dmlc_parse_csv(arr.ctypes.data, arr.size, delim, nthread,
                             out.ctypes.data, max_vals, ctypes.byref(n_rows),
                             ctypes.byref(n_cols))
    if ret == -2:
        raise ValueError("CSV: non-numeric cell")
    if ret == -3:
        raise ValueError("CSV has inconsistent column counts")
    if ret != 0:
        raise ValueError(f"CSV parse failed (code {ret})")
    r, ncol = n_rows.value, n_cols.value
    return out[: r * ncol].reshape(r, ncol)


# ---- RecordIO scan and packs -----------------------------------------------

def recordio_spans(data, magic: int, verify: bool = True) -> np.ndarray:
    """The ``[n, 3]`` uint64 span table ``(offset, len, flag)`` of a
    record-aligned chunk: flags 0/1 plain (direct payload / escaped
    multi-segment region), 2/3 checksummed.

    ``verify=True`` is the fused single pass: checksummed segments are
    CRC32C-verified inline and corruption comes back as typed reject
    triples (flag >= 8, span ``[begin, resync point)``): 8 bad magic,
    9 truncated payload, 10 torn multi-segment record, 11 missing end
    segment, 12 bad head cflag, 13 crc32c mismatch, 14 torn sub-word
    tail.  ``verify=False`` is the strict scan: ValueError unless the
    chunk is a clean sequence of records."""
    lib = _load()
    arr = _bytes_view(data)
    ptr, n = arr.ctypes.data, arr.size
    # grown on -1: n // 12 (all empty records) over-allocates ordinary
    # chunks by orders of magnitude
    max_spans = min(max(n // 12 + 2, 16), 1 << 14)
    while True:
        out = np.empty((max_spans, 3), np.uint64)
        n_spans = ctypes.c_long()
        if verify:
            ret = lib.dmlc_recordio_spans_verify(
                ptr, n, magic, 1, out.ctypes.data, max_spans,
                ctypes.byref(n_spans))
        else:
            ret = lib.dmlc_recordio_spans(ptr, n, magic, out.ctypes.data,
                                          max_spans, ctypes.byref(n_spans))
        if ret == -1:
            max_spans *= 2
            continue
        if ret != 0:
            raise ValueError(f"invalid RecordIO chunk (code {ret})")
        return out[: n_spans.value]


def recordio_find_last(data, magic: int) -> int:
    """Offset of the last record head (a 4-aligned magic followed by a
    head cflag) after offset 0 in ``data``, or 0 when there is none."""
    arr = _bytes_view(data)
    return int(_load().dmlc_recordio_find_last(arr.ctypes.data, arr.size,
                                               magic))


def pad_pack_rows(src, spans: np.ndarray, magic: int, max_bytes: int,
                  out_rows: np.ndarray, out_lens: np.ndarray) -> None:
    """The records of ``spans`` (``[g, 3]`` good triples of ``src``) as
    zero-padded ``[g, max_bytes]`` uint8 rows in ``out_rows`` and int32
    lengths in ``out_lens`` (both C-contiguous), escaped-magic regions
    reassembled in place."""
    _check_out(out_rows, np.uint8, "out_rows")
    _check_out(out_lens, np.int32, "out_lens")
    if spans.ndim != 2 or spans.shape[1] != 3:
        raise ValueError(f"spans must be [g, 3], got {spans.shape}")
    g = spans.shape[0]
    if out_rows.shape[0] < g or out_rows.shape[1:] != (max_bytes,) \
            or out_lens.shape[0] < g:
        raise ValueError("pad_pack_rows: output too small for the spans")
    a = _bytes_view(src)
    spans = np.ascontiguousarray(spans, np.uint64)
    ret = _load().dmlc_pad_pack_rows(
        a.ctypes.data, a.size, spans.ctypes.data, g, magic, max_bytes,
        out_rows.ctypes.data, out_lens.ctypes.data)
    if ret != 0:
        raise ValueError("pad_pack_rows: span out of bounds for source")


def _check_out(arr: np.ndarray, dtype, what: str) -> None:
    if arr.dtype != dtype or not arr.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{what} must be C-contiguous {np.dtype(dtype)}, "
                         f"got {arr.dtype}")


def pad_pack_csr(labels, offsets, index, value, b: int, batch_size: int,
                 max_nnz: int, num_col: int, out: dict) -> None:
    """CSR rows ``[0, b)`` into the padded batch ``out`` ({label [B],
    value [B, K], index [B, K], mask [B, K]}, float32/int32, C-contiguous,
    checked), in place: the native ``pack_rowblock``."""
    for k, dt, shp in (("label", np.float32, (batch_size,)),
                       ("value", np.float32, (batch_size, max_nnz)),
                       ("index", np.int32, (batch_size, max_nnz)),
                       ("mask", np.float32, (batch_size, max_nnz))):
        _check_out(out[k], dt, k)
        if out[k].shape != shp:
            raise ValueError(f"{k} is {out[k].shape}, expected {shp}")
    labels = np.ascontiguousarray(labels, np.float32)
    offsets = np.ascontiguousarray(offsets, np.uint64)
    index = np.ascontiguousarray(index, np.uint32)
    value = np.ascontiguousarray(value, np.float32)
    if labels.size < b or offsets.size < b + 1:
        raise ValueError("pad_pack_csr: fewer rows than b")
    if b and index.size < value.size:
        raise ValueError("pad_pack_csr: fewer indices than values")
    _load().dmlc_pad_pack_csr(
        labels.ctypes.data, offsets.ctypes.data, index.ctypes.data,
        value.ctypes.data, value.size, b, batch_size, max_nnz, num_col,
        out["label"].ctypes.data, out["value"].ctypes.data,
        out["index"].ctypes.data, out["mask"].ctypes.data)


def parse_libsvm_into(data, start: int, row_base: int, max_nnz: int,
                      num_col: int, out: dict):
    """Fused LibSVM tokenize and pad-pack: lines of ``data`` from byte
    ``start`` become padded rows of the batch ``out`` (as
    :func:`pad_pack_csr`'s) at rows ``[row_base, B)``, no intermediate
    CSR.  Returns ``(rows_filled, consumed_offset)``; the offset is a
    line boundary to re-enter at.  Raises ValueError on malformed
    input."""
    batch_rows = out["label"].size
    for k, dt in (("label", np.float32), ("value", np.float32),
                  ("index", np.int32), ("mask", np.float32)):
        _check_out(out[k], dt, k)
        if out[k].shape[:1] != (batch_rows,) or (
                k != "label" and out[k].shape[1:] != (max_nnz,)):
            raise ValueError(f"{k} is {out[k].shape} for {batch_rows} rows "
                             f"of {max_nnz}")
    a = _bytes_view(data)
    if not (0 <= start <= a.size and 0 <= row_base <= batch_rows):
        raise ValueError(f"parse_libsvm_into: start {start} or row_base "
                         f"{row_base} out of range")
    rows, consumed = ctypes.c_long(), ctypes.c_long()
    ret = _load().dmlc_parse_libsvm_into(
        a.ctypes.data, a.size, start, row_base, batch_rows, max_nnz, num_col,
        out["label"].ctypes.data, out["value"].ctypes.data,
        out["index"].ctypes.data, out["mask"].ctypes.data,
        ctypes.byref(rows), ctypes.byref(consumed))
    if ret != 0:
        raise ValueError(f"malformed LibSVM input (code {ret})")
    return int(rows.value), int(consumed.value)


def gather_spans(src, offs: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Record spans of ``src`` packed into one uint8 array in the given
    (shuffled) order, the source touched in ascending offset order for
    page locality."""
    a = _bytes_view(src)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    dst_off = np.empty(len(lens), np.int64)
    if len(lens):
        np.cumsum(lens[:-1], out=dst_off[1:])
        dst_off[0] = 0
    total = int(lens.sum()) if len(lens) else 0
    order = np.argsort(offs, kind="stable").astype(np.int64)
    dst = np.empty(total, np.uint8)
    got = _load().dmlc_gather_spans(
        a.ctypes.data, a.size, dst.ctypes.data, offs.ctypes.data,
        lens.ctypes.data, dst_off.ctypes.data, order.ctypes.data, len(lens))
    if got != total:
        raise ValueError("gather_spans: span out of bounds for source")
    return dst


def pack_spans(src, offs: np.ndarray, lens: np.ndarray, dst: np.ndarray,
               dst_pos: int, slots: int, allow_truncate: bool,
               ends_out: np.ndarray):
    """Whole record spans of ``src`` appended to the packed buffer ``dst``
    from ``dst_pos`` until it fills (bytes or ``slots`` records);
    ``ends_out[:consumed]`` gets each record's end offset.  A span that
    would overflow waits for the next batch, except in an empty batch
    (``allow_truncate``), where it is packed truncated.  Returns
    ``(consumed, new_pos, full)``."""
    _check_out(dst, np.uint8, "dst")
    _check_out(ends_out, np.int64, "ends_out")
    n = len(lens)
    if len(offs) != n or not 0 <= dst_pos <= dst.size:
        raise ValueError("pack_spans: offs/lens lengths differ or dst_pos "
                         "is outside dst")
    if ends_out.size < min(n, slots):
        raise ValueError("pack_spans: ends_out shorter than the slots")
    a = _bytes_view(src)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    out_pos, out_full = ctypes.c_long(), ctypes.c_int()
    consumed = _load().dmlc_pack_spans(
        a.ctypes.data, a.size, dst.ctypes.data, dst.size, dst_pos,
        offs.ctypes.data, lens.ctypes.data, n, slots,
        1 if allow_truncate else 0, ends_out.ctypes.data,
        ctypes.byref(out_pos), ctypes.byref(out_full))
    if consumed < 0:
        raise ValueError("pack_spans: span out of bounds for source")
    return int(consumed), int(out_pos.value), bool(out_full.value)
