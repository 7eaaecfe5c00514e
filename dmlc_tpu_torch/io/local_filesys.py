"""Local filesystem backend (the port of ``dmlc_tpu/io/local_filesys.py``;
reference src/io/local_filesys.{h,cc}): stat/listdir listing,
file-object streams and the stdin/stdout special paths."""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from ..base import DMLCError
from .filesys import FileInfo, FileSystem
from .stream import FileStream, SeekStream, Stream
from .uri import URI

__all__ = ["LocalFileSystem"]


class LocalFileSystem(FileSystem):
    def get_path_info(self, path: URI) -> FileInfo:
        st = os.stat(path.name)
        return FileInfo(path=path, size=st.st_size,
                        type="directory" if os.path.isdir(path.name)
                        else "file")

    def list_directory(self, path: URI) -> List[FileInfo]:
        out: List[FileInfo] = []
        for entry in sorted(os.listdir(path.name)):
            full = os.path.join(path.name, entry)
            st = os.stat(full)
            out.append(FileInfo(path=URI(path.protocol + path.host + full),
                                size=st.st_size,
                                type="directory" if os.path.isdir(full)
                                else "file"))
        return out

    def open(self, path: URI, mode: str,
             allow_null: bool = False) -> Optional[Stream]:
        if path.name == "stdin":
            return FileStream(sys.stdin.buffer, own=False)
        if path.name == "stdout":
            return FileStream(sys.stdout.buffer, own=False)
        binmode = mode if "b" in mode else mode + "b"
        try:
            f = open(path.name, binmode)
        except OSError as exc:
            if allow_null:
                return None
            raise DMLCError(f"LocalFileSystem.open {path.name!r}: {exc}") \
                from exc
        return FileStream(f)

    def open_for_read(self, path: URI,
                      allow_null: bool = False) -> Optional[SeekStream]:
        return self.open(path, "r", allow_null=allow_null)

    def local_path(self, path: URI) -> Optional[str]:
        if path.name in ("stdin", "stdout"):
            return None
        return path.name
