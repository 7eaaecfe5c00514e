"""Build the port's CUDA kernels with ``nvcc`` and bind them through ctypes.

Each ``csrc/*.cu`` file compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes).  Sources may include the shared headers ``csrc/*.cuh``.
Libraries go into ``build/dmlc_tpu_torch/`` at the root of the checkout,
named by a hash of the source, every header beside it and the flags, so
an edited kernel or header rebuilds and an unchanged one is loaded as it
is.  Nothing builds at import: the first launch of a kernel builds its
library, and :func:`build_all` builds every source at once, one ``nvcc``
process per file, all started together.

Every C entry point takes its pointers and the CUDA stream as
``c_void_p``, returns ``cudaGetLastError()`` after the launch, and the
wrapper raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

from ..base import DMLCError

__all__ = ["Kernel", "build_all", "rows_aligned", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dmlc_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise DMLCError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                    "CUDA kernels build only where the CUDA toolkit is")


def library_path(source: Path) -> Path:
    """The library built from ``source``, keyed by its bytes, the bytes
    of every ``*.cuh`` header in its directory and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def rows_aligned(x) -> bool:
    """Every row (last dim) of tensor ``x`` starts on 16 bytes, as the
    kernels' 16-byte vector loads and copies need."""
    el = x.element_size()
    return x.data_ptr() % 16 == 0 and all(st * el % 16 == 0
                                          for st in x.stride()[:-1])


def _build(sources: Sequence[Path]) -> None:
    """Compile every source whose library is missing, all at once.
    Caller holds ``_lock``.  Each output is written under a per-process
    name and renamed into place, so a concurrent builder never loads a
    half-written library."""
    todo = [(s, library_path(s)) for s in sources
            if not library_path(s).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, lib in todo:
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs.append((src, lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors: List[str] = []
    for src, lib, tmp, proc in procs:
        out, err = proc.communicate()
        lib.with_suffix(".log").write_text(out + err)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} "
                          f"(exit {proc.returncode}):\n{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if errors:
        raise DMLCError("\n".join(errors))


def _load(source: Path) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            _build([source])
            lib = _libs[source] = ctypes.CDLL(str(library_path(source)))
        return lib


def build_all(sources: Optional[Iterable[Path]] = None) -> float:
    """Build (if needed) and load every kernel source; returns seconds."""
    t0 = time.perf_counter()
    srcs = sorted(sources if sources is not None else CSRC.glob("*.cu"))
    with _lock:
        _build(srcs)
    for s in srcs:
        _load(s)
    return time.perf_counter() - t0


class Kernel:
    """One C entry point of one ``.cu`` file, loaded at first launch.

    ``launches`` counts the successful launches made through
    :meth:`launch` and nothing else, so a run can show which kernels its
    path went through (set it to 0 before the run, read it after)."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None

    def load(self):
        if self._fn is None:
            lib = _load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.dmlc_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err = err
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self.load()(*args)
        if rc != 0:
            raise DMLCError(f"{self.symbol} failed: CUDA error {rc} "
                            f"({self._err(rc).decode()})")
        self.launches += 1
