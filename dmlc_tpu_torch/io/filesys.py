"""Virtual filesystem: FileInfo, the FileSystem interface and protocol
dispatch (the port of ``dmlc_tpu/io/filesys.py``; reference
src/io/filesys.h:54-125 and src/io.cc:31-60).

The port reads local files only (``file://`` and plain paths).  The
remote protocols the JAX package serves (gs, s3, hdfs, azure, http) are
registered as stubs that raise, so a job pointed at one fails at once
with a message that says where they stand.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..base import DMLCError
from .stream import SeekStream, Stream
from .uri import URI

__all__ = ["FileInfo", "FileSystem", "register_filesystem"]


@dataclass
class FileInfo:
    """path + size + type (filesys.h:54-72)."""

    path: URI = field(default_factory=lambda: URI(""))
    size: int = 0
    type: str = "file"  # 'file' | 'directory'


class FileSystem(abc.ABC):
    """Abstract filesystem (filesys.h:75-125)."""

    @abc.abstractmethod
    def get_path_info(self, path: URI) -> FileInfo: ...

    @abc.abstractmethod
    def list_directory(self, path: URI) -> List[FileInfo]: ...

    def list_directory_recursive(self, path: URI) -> List[FileInfo]:
        """Every file under ``path`` (filesys.h:96-108), through
        :meth:`list_directory`."""
        out: List[FileInfo] = []
        stack = [path]
        while stack:
            for info in self.list_directory(stack.pop()):
                if info.type == "directory":
                    stack.append(info.path)
                else:
                    out.append(info)
        return out

    @abc.abstractmethod
    def open(self, path: URI, mode: str,
             allow_null: bool = False) -> Optional[Stream]: ...

    @abc.abstractmethod
    def open_for_read(self, path: URI,
                      allow_null: bool = False) -> Optional[SeekStream]: ...

    def local_path(self, path: URI) -> Optional[str]:
        """OS path for mmap-capable backends, else None."""
        return None

    _registry: Dict[str, Callable[[URI], "FileSystem"]] = {}
    _instances: Dict[str, "FileSystem"] = {}

    @staticmethod
    def get_instance(path: URI) -> "FileSystem":
        key = path.protocol + path.host
        inst = FileSystem._instances.get(key)
        if inst is not None:
            return inst
        factory = FileSystem._registry.get(path.protocol)
        if factory is None:
            raise DMLCError(
                f"unknown filesystem protocol {path.protocol!r}; registered: "
                f"{sorted(FileSystem._registry)}")
        inst = factory(path)
        FileSystem._instances[key] = inst
        return inst


def register_filesystem(protocol: str,
                        factory: Callable[[URI], FileSystem]) -> None:
    """Register a protocol (e.g. 'gs://') -> FileSystem factory."""
    FileSystem._registry[protocol] = factory


def _not_ported(proto: str) -> Callable[[URI], FileSystem]:
    def factory(_uri: URI) -> FileSystem:
        raise DMLCError(
            f"the {proto} filesystem is not ported to dmlc_tpu_torch yet "
            "(ROADMAP.md, Queue 1: remote filesystems); copy the data to a "
            "local path")

    return factory


def _init_builtin() -> None:
    from .local_filesys import LocalFileSystem

    register_filesystem("file://", lambda _uri: LocalFileSystem())
    for proto in ("gs://", "s3://", "hdfs://", "azure://", "http://",
                  "https://"):
        register_filesystem(proto, _not_ported(proto))


_init_builtin()
