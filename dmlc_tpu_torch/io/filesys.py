"""Virtual filesystem: FileInfo, the FileSystem interface and protocol
dispatch (the port of ``dmlc_tpu/io/filesys.py``; reference
src/io/filesys.h:54-125 and src/io.cc:31-60).

``file://`` and plain paths are local; ``http://``/``https://`` read
through ranged GETs, ``s3://`` speaks SigV4 REST, ``gs://`` the GCS JSON
API, ``azure://`` the Blob REST API and ``hdfs://`` WebHDFS, all on the
standard library (see their modules).  The dispatch stays pluggable
through :func:`register_filesystem`.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..base import DMLCError
from .stream import SeekStream, Stream
from .uri import URI

__all__ = ["FileInfo", "FileSystem", "UnsupportedListing",
           "register_filesystem"]


class UnsupportedListing(DMLCError):
    """A backend that cannot list directories by design (plain HTTP):
    URI expansion takes the literal path.  A listing that fails for a
    real reason (credentials, transport) raises a plain DMLCError or
    OSError, which propagates."""


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


def _unsupported_protocol(proto: str, guidance: str):
    """The factory of a protocol whose backend failed to import: the
    dispatch fails with guidance (the reference's "compile with
    DMLC_USE_X=1" FATALs, src/io.cc:31-60)."""

    def factory(_uri: URI) -> FileSystem:
        raise DMLCError(f"{proto} filesystem is not built into "
                        f"dmlc_tpu_torch: {guidance}")

    return factory


def _init_builtin() -> None:
    from .local_filesys import LocalFileSystem

    register_filesystem("file://", lambda _uri: LocalFileSystem())
    try:
        from .http_filesys import HTTPFileSystem

        register_filesystem("http://", lambda _uri: HTTPFileSystem())
        register_filesystem("https://", lambda _uri: HTTPFileSystem())
    except ImportError:
        pass
    try:
        from .gcs_filesys import GCSFileSystem

        register_filesystem("gs://", lambda _uri: GCSFileSystem())
    except ImportError:
        pass
    try:
        from .hdfs_filesys import WebHDFSFileSystem

        register_filesystem("hdfs://", WebHDFSFileSystem)
    except ImportError:
        register_filesystem("hdfs://", _unsupported_protocol(
            "hdfs://", "the WebHDFS backend failed to import; plug in a "
            "backend via register_filesystem('hdfs://', ...)"))
    try:
        from .s3_filesys import S3FileSystem

        register_filesystem("s3://", lambda _uri: S3FileSystem())
    except ImportError:
        register_filesystem("s3://", _unsupported_protocol(
            "s3://", "the S3 backend failed to import; plug in a backend "
            "via register_filesystem('s3://', ...)"))
    try:
        from .azure_filesys import AzureFileSystem

        register_filesystem("azure://", lambda _uri: AzureFileSystem())
    except ImportError:
        register_filesystem("azure://", _unsupported_protocol(
            "azure://", "the Azure backend failed to import; plug in a "
            "backend via register_filesystem('azure://', ...)"))


_init_builtin()
