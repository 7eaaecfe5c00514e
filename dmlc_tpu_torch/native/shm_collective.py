"""ctypes binding for the same-host shm collective group
(``csrc/dmlc_collective.cc``: ``dmlc_shm_coll_*``, a byte-equal copy of
the JAX package's ``cpp/dmlc_collective.cc``) — the intra-host leg of
the hierarchical host allreduce in ``tracker/client.py``.

The library builds at first use with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread -lrt`` into ``build/dmlc_tpu_torch/dmlc_collective-<hash>.so``
(named by a hash of the sources and flags, compiled under a per-process
name and renamed into place, so N same-host ranks racing the first
build each load a complete library).  The same library carries the
``DmlcComm`` C ABI and the KV parameter server for C consumers
(:func:`library_path`, :func:`build`, ``csrc/dmlc_collective.h``).

As in the JAX package, the hier algorithm degrades to the flat ring
when the build or the segment mapping fails (a warning names the
cause, and the gang-wide veto keeps every rank on one algorithm).

Calls release the GIL for their duration (plain ctypes), so a
reduce-scatter on the background collective thread genuinely overlaps
Python-side work on the training thread.
"""

from __future__ import annotations

import ctypes
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from ..base import DMLCError
from ..concurrency import make_lock
from . import CSRC
from . import _build as _build_native
from . import library_path as _native_library_path

__all__ = ["DTYPE_CODES", "OP_CODES", "ShmCollective", "ShmGroupError",
           "available", "build", "library_path", "supports_dtype"]

SOURCE = CSRC / "dmlc_collective.cc"
HEADER = CSRC / "dmlc_collective.h"
# -lrt: shm_open lives in librt on glibc < 2.34 (a no-op stub after)
LIBS = ["-lrt"]

logger = logging.getLogger("dmlc_tpu_torch.native")

_lib = None
_lib_lock = make_lock("shm_collective._lib_lock")
_tried = False

#: numpy dtype -> dmlc_collective.h dtype code (DMLC_F32..DMLC_I64)
DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
}

#: op name -> dmlc_collective.h op code (DMLC_SUM/MAX/MIN)
OP_CODES = {"sum": 0, "max": 1, "min": 2}


def library_path() -> Path:
    return _native_library_path((HEADER, SOURCE), LIBS)


def build() -> Path:
    """The built library's path, compiling it first if needed; raises
    :class:`DMLCError` with the compiler's output when g++ fails."""
    path = library_path()
    if not path.exists():
        _build_native(SOURCE, path, LIBS)
    return path


def _load():
    global _lib, _tried
    with _lib_lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (DMLCError, OSError) as e:
            logger.warning("dmlc_collective unavailable, hier allreduce "
                           "will fall back to the flat ring: %s", e)
            return None
        c = ctypes
        lib.dmlc_shm_coll_create.restype = c.c_void_p
        lib.dmlc_shm_coll_create.argtypes = [c.c_char_p, c.c_int, c.c_int,
                                             c.c_long]
        lib.dmlc_shm_coll_reduce_scatter.restype = c.c_int
        lib.dmlc_shm_coll_reduce_scatter.argtypes = [
            c.c_void_p, c.c_void_p, c.c_long, c.c_int, c.c_int]
        lib.dmlc_shm_coll_allgather.restype = c.c_int
        lib.dmlc_shm_coll_allgather.argtypes = [
            c.c_void_p, c.c_void_p, c.c_long, c.c_int]
        lib.dmlc_shm_coll_broadcast.restype = c.c_int
        lib.dmlc_shm_coll_broadcast.argtypes = [
            c.c_void_p, c.c_void_p, c.c_long, c.c_int]
        lib.dmlc_shm_coll_allreduce.restype = c.c_int
        lib.dmlc_shm_coll_allreduce.argtypes = [
            c.c_void_p, c.c_void_p, c.c_long, c.c_int, c.c_int]
        lib.dmlc_shm_coll_abort.restype = None
        lib.dmlc_shm_coll_abort.argtypes = [c.c_void_p]
        lib.dmlc_shm_coll_destroy.restype = None
        lib.dmlc_shm_coll_destroy.argtypes = [c.c_void_p]
        lib.dmlc_shm_coll_last_error.restype = c.c_char_p
        lib.dmlc_shm_coll_last_error.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def supports_dtype(dtype) -> bool:
    return np.dtype(dtype) in DTYPE_CODES


class ShmGroupError(RuntimeError):
    """A shm group collective failed (timeout, abort, divergent gang)."""


class ShmCollective:
    """One process's handle on a same-host shm collective group.

    ``name`` must be agreed by every member out of band (the hier path
    derives it from tracker port + world generation + group leader);
    ``rank`` is the dense intra-group rank, with rank 0 creating the
    segment.  Construction is collective — it blocks until the whole
    group attached (``DMLC_COLL_SHM_JOIN_TIMEOUT_S``) and raises
    :class:`ShmGroupError` on failure, after which the caller falls
    back to TCP paths.  The segment layout is the C source's, so port
    and JAX processes can share one group.
    """

    def __init__(self, name: str, rank: int, world: int,
                 chunk_kb: int = 0):
        self._lib = _load()
        self._handle = None
        if self._lib is None:
            raise ShmGroupError("native collective library unavailable")
        self.rank, self.world = rank, world
        h = self._lib.dmlc_shm_coll_create(
            name.encode(), int(rank), int(world), int(chunk_kb))
        if not h:
            err = self._lib.dmlc_shm_coll_last_error(None)
            raise ShmGroupError(
                f"shm group create failed: {err.decode(errors='replace')}")
        self._handle = h

    def _check(self, rc: int, what: str) -> None:
        if rc == 0:
            return
        err = self._lib.dmlc_shm_coll_last_error(self._handle)
        raise ShmGroupError(
            f"shm {what} failed (rc {rc}): {err.decode(errors='replace')}")

    @staticmethod
    def _codes(arr: np.ndarray, op: Optional[str]):
        dt = DTYPE_CODES.get(arr.dtype)
        if dt is None:
            raise ShmGroupError(f"unsupported dtype {arr.dtype}")
        if op is None:
            return dt, None
        return dt, OP_CODES[op]

    @staticmethod
    def _flat(arr: np.ndarray) -> None:
        if not isinstance(arr, np.ndarray) or arr.ndim != 1 \
                or not arr.flags.c_contiguous:
            raise ValueError("shm collectives take a C-contiguous 1-D "
                             "numpy array")

    def reduce_scatter(self, arr: np.ndarray, op: str = "sum") -> None:
        """In-place: this rank's per-chunk slice becomes the fold of
        every member's values; the rest of ``arr`` is untouched."""
        self._flat(arr)
        dt, opc = self._codes(arr, op)
        self._check(self._lib.dmlc_shm_coll_reduce_scatter(
            self._handle, arr.ctypes.data, arr.size, dt, opc),
            "reduce_scatter")

    def allgather(self, arr: np.ndarray) -> None:
        """In-place gather of the per-chunk slices reduce_scatter left
        resident — RS followed by AG is a full allreduce."""
        self._flat(arr)
        dt, _ = self._codes(arr, None)
        self._check(self._lib.dmlc_shm_coll_allgather(
            self._handle, arr.ctypes.data, arr.size, dt), "allgather")

    def broadcast(self, arr: np.ndarray, root: int = 0) -> None:
        if not isinstance(arr, np.ndarray) or not arr.flags.c_contiguous:
            raise ValueError("shm broadcast takes a C-contiguous numpy "
                             "array")
        self._check(self._lib.dmlc_shm_coll_broadcast(
            self._handle, arr.ctypes.data, arr.nbytes, int(root)),
            "broadcast")

    def allreduce(self, arr: np.ndarray, op: str = "sum") -> None:
        self._flat(arr)
        dt, opc = self._codes(arr, op)
        self._check(self._lib.dmlc_shm_coll_allreduce(
            self._handle, arr.ctypes.data, arr.size, dt, opc), "allreduce")

    def abort(self) -> None:
        """Poison the group: members blocked in a collective wake with
        an error instead of spinning to the timeout (the shm half of
        the elastic WorldResized cascade)."""
        if self._handle is not None:
            self._lib.dmlc_shm_coll_abort(self._handle)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dmlc_shm_coll_destroy(self._handle)
            self._handle = None

    def __del__(self):  # best-effort unmap
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
