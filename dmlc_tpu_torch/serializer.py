"""Typed binary serialization, wire-compatible with the reference (the
port's copy of ``dmlc_tpu/serializer.py``).

Rebuild of reference include/dmlc/serializer.h:36-380. The wire format is:
  - POD scalars: little-endian raw bytes (PODHandler memcpy fast path)
  - numpy arrays / POD vectors: uint64 length + contiguous raw data
    (serializer.h:105-120)
  - strings: uint64 length + utf-8 bytes (serializer.h:155-170)
  - lists of composites: uint64 length + each element (serializer.h:130-145)
  - dicts (map<K,V>): uint64 length + (key, value) pairs (CollectionHandler,
    serializer.h:328+)
  - objects with save(stream)/load(stream): delegated (has_saveload detection,
    serializer.h:241-374)

This keeps checkpoints byte-compatible with ``dmlc::Stream::Write<T>`` for the
common composite types, so a model saved by a reference-linked binary loads
here and vice versa.

Python has no static types, so serialization is driven by a small type-spec
language instead of template recursion:

    spec := scalar | "str" | "bytes" | ("vec", spec) | ("map", kspec, vspec)
            | ("pair", spec, spec) | "obj"
    scalar := "i8"|"u8"|"i16"|"u16"|"i32"|"u32"|"i64"|"u64"|"f32"|"f64"|"bool"

numpy arrays serialize through :func:`write_array` / :func:`read_array` with
the same uint64-length + raw-data layout.
"""

from __future__ import annotations

from typing import Any, Tuple, Union

import numpy as np

from .base import DMLCError, check
from .io.stream import Stream

__all__ = ["write", "read", "write_array", "read_array", "write_string", "read_string"]

_SCALAR_FMT = {
    "i8": "b", "u8": "B", "i16": "h", "u16": "H",
    "i32": "i", "u32": "I", "i64": "q", "u64": "Q",
    "f32": "f", "f64": "d", "bool": "?",
}

_NP_DTYPE = {
    "i8": np.int8, "u8": np.uint8, "i16": np.int16, "u16": np.uint16,
    "i32": np.int32, "u32": np.uint32, "i64": np.int64, "u64": np.uint64,
    "f32": np.float32, "f64": np.float64,
}

Spec = Union[str, Tuple]


def write_string(strm: Stream, s: Union[str, bytes]) -> None:
    data = s.encode("utf-8") if isinstance(s, str) else s
    strm.write_scalar("Q", len(data))
    strm.write(data)


def read_string(strm: Stream, as_bytes: bool = False) -> Union[str, bytes]:
    n = strm.read_scalar("Q")
    data = strm.read_exact(n)
    return data if as_bytes else data.decode("utf-8")


def write_array(strm: Stream, arr: np.ndarray) -> None:
    """uint64 element count + raw little-endian data (PODVectorHandler,
    serializer.h:105-120)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    strm.write_scalar("Q", arr.size)
    strm.write(arr.tobytes())


def read_array(strm: Stream, dtype) -> np.ndarray:
    n = strm.read_scalar("Q")
    dt = np.dtype(dtype)
    data = strm.read_exact(n * dt.itemsize)
    return np.frombuffer(data, dtype=dt).copy()


def write(strm: Stream, value: Any, spec: Spec) -> None:
    """Serialize ``value`` per ``spec`` (Handler<T>::Write dispatch,
    serializer.h:241-260)."""
    if isinstance(spec, str):
        if spec in _SCALAR_FMT:
            strm.write_scalar(_SCALAR_FMT[spec], value)
            return
        if spec == "str":
            write_string(strm, value)
            return
        if spec == "bytes":
            write_string(strm, value)
            return
        if spec == "obj":
            value.save(strm)
            return
        raise DMLCError(f"unknown serializer spec {spec!r}")
    tag = spec[0]
    if tag == "vec":
        elem = spec[1]
        if isinstance(elem, str) and elem in _NP_DTYPE:
            write_array(strm, np.asarray(value, dtype=_NP_DTYPE[elem]))
        else:
            strm.write_scalar("Q", len(value))
            for v in value:
                write(strm, v, elem)
        return
    if tag == "pair":
        write(strm, value[0], spec[1])
        write(strm, value[1], spec[2])
        return
    if tag == "map":
        strm.write_scalar("Q", len(value))
        for k, v in value.items():
            write(strm, k, spec[1])
            write(strm, v, spec[2])
        return
    raise DMLCError(f"unknown serializer spec {spec!r}")


def read(strm: Stream, spec: Spec, factory=None) -> Any:
    """Deserialize per ``spec``. For spec=="obj" pass ``factory`` returning a
    fresh object with a ``load(stream)`` method."""
    if isinstance(spec, str):
        if spec in _SCALAR_FMT:
            return strm.read_scalar(_SCALAR_FMT[spec])
        if spec == "str":
            return read_string(strm)
        if spec == "bytes":
            return read_string(strm, as_bytes=True)
        if spec == "obj":
            check(factory is not None, "read('obj') requires a factory")
            obj = factory()
            obj.load(strm)
            return obj
        raise DMLCError(f"unknown serializer spec {spec!r}")
    tag = spec[0]
    if tag == "vec":
        elem = spec[1]
        if isinstance(elem, str) and elem in _NP_DTYPE:
            return read_array(strm, _NP_DTYPE[elem])
        n = strm.read_scalar("Q")
        return [read(strm, elem, factory) for _ in range(n)]
    if tag == "pair":
        return (read(strm, spec[1], factory), read(strm, spec[2], factory))
    if tag == "map":
        n = strm.read_scalar("Q")
        out = {}
        for _ in range(n):
            k = read(strm, spec[1], factory)
            v = read(strm, spec[2], factory)
            out[k] = v
        return out
    raise DMLCError(f"unknown serializer spec {spec!r}")
