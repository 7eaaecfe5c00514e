"""The port's host native core: CRC-32C in C++ (``csrc/crc32c.cc``).

The source builds with ``g++`` at first use into ``build/dmlc_tpu_torch/``
at the root of the checkout, named by a hash of the source and the flags
(as ``ops/_build.py`` names the CUDA libraries), and is loaded with
``ctypes``, which releases the GIL for the length of a call.  A failed
build raises: there is no quiet fallback to the Python table loop,
which ``io.integrity._crc32c_py`` keeps as the plain version the tests
hold this one against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..base import DMLCError

__all__ = ["crc32c", "crc32c_table", "crc32c_hardware", "library_path"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dmlc_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def library_path(source: Path = CSRC / "crc32c.cc") -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def _build(source: Path, lib: Path) -> None:
    """Compile under a per-process name and rename into place, so a
    concurrent builder never loads a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, str(source), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise DMLCError(f"g++ could not build {source.name}: {exc}") from exc
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise DMLCError(f"g++ failed on {source.name} "
                        f"(exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(CSRC / "crc32c.cc", path)
            lib = ctypes.CDLL(str(path))
            for name in ("dmlc_crc32c", "dmlc_crc32c_table"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_long,
                               ctypes.c_uint32]
                fn.restype = ctypes.c_uint32
            lib.dmlc_crc32c_hw.argtypes = []
            lib.dmlc_crc32c_hw.restype = ctypes.c_int
            _lib = lib
        return _lib


def _bytes_view(data) -> np.ndarray:
    """A uint8 numpy view over any C-contiguous bytes-like, no copy (the
    view keeps the buffer alive for the length of the call)."""
    mv = memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    return np.frombuffer(mv, np.uint8)


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
