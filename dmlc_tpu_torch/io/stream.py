"""Stream / SeekStream and the in-memory and file streams (the port of
``dmlc_tpu/io/stream.py``).

Reference include/dmlc/io.h:29-126 (Stream, SeekStream, Serializable)
and include/dmlc/memory_io.h.  ``Stream.create(uri, mode)`` dispatches
through the filesystem layer (src/io.cc:121-133).
"""

from __future__ import annotations

import abc
import io as _pyio
import struct
from typing import Optional, Union

from ..base import DMLCError, check

__all__ = [
    "Stream",
    "SeekStream",
    "MemoryFixedSizeStream",
    "MemoryBytesStream",
    "FileStream",
    "Serializable",
]


class Stream(abc.ABC):
    """Abstract byte stream (io.h:29-86)."""

    @abc.abstractmethod
    def read(self, size: int) -> bytes:
        """Read up to ``size`` bytes; b'' at EOF."""

    @abc.abstractmethod
    def write(self, data: bytes) -> int:
        """Write all bytes; returns count written."""

    def readinto(self, mv: memoryview) -> int:
        """Read up to len(mv) bytes into ``mv``; returns count (0 at EOF).
        Falls back to read()+copy; file streams fill in place."""
        data = self.read(len(mv))
        n = len(data)
        mv[:n] = data
        return n

    def close(self) -> None:
        pass

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def create(uri: str, mode: str = "r",
               allow_null: bool = False) -> Optional["Stream"]:
        from .filesys import FileSystem
        from .uri import URI

        u = URI(uri)
        return FileSystem.get_instance(u).open(u, mode, allow_null=allow_null)

    @staticmethod
    def create_for_read(uri: str,
                        allow_null: bool = False) -> Optional["SeekStream"]:
        """Analog of ``SeekStream::CreateForRead`` (io.h:107)."""
        from .filesys import FileSystem
        from .uri import URI

        u = URI(uri)
        return FileSystem.get_instance(u).open_for_read(
            u, allow_null=allow_null)

    def read_exact(self, size: int) -> bytes:
        buf = bytearray()
        while len(buf) < size:
            chunk = self.read(size - len(buf))
            if not chunk:
                raise DMLCError(
                    f"Stream.read_exact: wanted {size} bytes, got {len(buf)} "
                    "(truncated stream)")
            buf.extend(chunk)
        return bytes(buf)

    def write_scalar(self, fmt: str, value) -> None:
        self.write(struct.pack("<" + fmt, value))

    def read_scalar(self, fmt: str):
        size = struct.calcsize("<" + fmt)
        return struct.unpack("<" + fmt, self.read_exact(size))[0]

    def as_file(self, mode: str = "rb", *, buffering: int = -1,
                encoding: Optional[str] = None, close_stream: bool = False):
        """This Stream as a standard Python file object ('rb'/'wb' a
        buffered binary file, 'r'/'w' a utf-8 text file unless
        ``encoding``).  The wrapper does not own the Stream unless
        ``close_stream=True`` (the reference's istream/ostream adapters,
        io.h:297-440)."""
        binary = mode in ("rb", "wb")
        check(mode in ("r", "rb", "w", "wb"),
              f"as_file: unsupported mode {mode!r}")
        check(buffering != 0,
              "as_file: unbuffered (buffering=0) is not supported — "
              "write through the Stream directly for unbuffered IO")
        writing = mode in ("w", "wb")
        raw = _StreamRawIO(self, writing=writing, close_stream=close_stream)
        bufsize = buffering if buffering > 0 else _pyio.DEFAULT_BUFFER_SIZE
        buffered = (_pyio.BufferedWriter(raw, bufsize) if writing
                    else _pyio.BufferedReader(raw, bufsize))
        if binary:
            return buffered
        return _pyio.TextIOWrapper(buffered, encoding=encoding or "utf-8")


class _StreamRawIO(_pyio.RawIOBase):
    """RawIOBase shim over a Stream, behind :meth:`Stream.as_file`."""

    def __init__(self, stream: "Stream", *, writing: bool,
                 close_stream: bool):
        self._stream = stream
        self._writing = writing
        self._close_stream = close_stream

    def readable(self) -> bool:
        return not self._writing

    def writable(self) -> bool:
        return self._writing

    def seekable(self) -> bool:
        return not self._writing and isinstance(self._stream, SeekStream)

    def readinto(self, b) -> int:
        return self._stream.readinto(memoryview(b).cast("B"))

    def write(self, b) -> int:
        return self._stream.write(bytes(b))

    def seek(self, pos: int, whence: int = 0) -> int:
        if not self.seekable():
            raise _pyio.UnsupportedOperation("seek")
        s = self._stream
        if whence == 1:
            pos += s.tell()
        elif whence == 2:
            raise _pyio.UnsupportedOperation(
                "as_file: SEEK_END over a Stream (no size query)")
        s.seek(pos)
        return s.tell()

    def tell(self) -> int:
        if not self.seekable():
            raise _pyio.UnsupportedOperation("tell")
        return self._stream.tell()

    def close(self) -> None:
        if not self.closed and self._close_stream:
            self._stream.close()
        super().close()


class SeekStream(Stream):
    """Stream with random access (io.h:89-109)."""

    @abc.abstractmethod
    def seek(self, pos: int) -> None: ...

    @abc.abstractmethod
    def tell(self) -> int: ...

    def at_end(self) -> bool:
        return False


class Serializable(abc.ABC):
    """Objects that round-trip through a Stream (io.h:112-126)."""

    @abc.abstractmethod
    def save(self, stream: Stream) -> None: ...

    @abc.abstractmethod
    def load(self, stream: Stream) -> None: ...


class MemoryFixedSizeStream(SeekStream):
    """Fixed-capacity stream over a caller buffer (memory_io.h:21-63);
    writes past capacity raise."""

    def __init__(self, buf: Union[bytearray, memoryview]):
        self._buf = memoryview(buf)
        self._pos = 0

    def read(self, size: int) -> bytes:
        n = min(size, len(self._buf) - self._pos)
        out = bytes(self._buf[self._pos: self._pos + n])
        self._pos += n
        return out

    def write(self, data: bytes) -> int:
        n = len(data)
        check(self._pos + n <= len(self._buf), "MemoryFixedSizeStream overflow")
        self._buf[self._pos: self._pos + n] = data
        self._pos += n
        return n

    def seek(self, pos: int) -> None:
        check(0 <= pos <= len(self._buf), "seek out of range")
        self._pos = pos

    def tell(self) -> int:
        return self._pos

    def at_end(self) -> bool:
        return self._pos == len(self._buf)


class MemoryBytesStream(SeekStream):
    """Growable in-memory stream (MemoryStringStream, memory_io.h:66-105);
    ``getvalue()`` returns the bytes written."""

    def __init__(self, initial: bytes = b""):
        self._io = _pyio.BytesIO(initial)

    def read(self, size: int) -> bytes:
        return self._io.read(size)

    def write(self, data: bytes) -> int:
        return self._io.write(data)

    def seek(self, pos: int) -> None:
        self._io.seek(pos)

    def tell(self) -> int:
        return self._io.tell()

    def getvalue(self) -> bytes:
        return self._io.getvalue()

    def at_end(self) -> bool:
        pos = self._io.tell()
        end = self._io.seek(0, 2)
        self._io.seek(pos)
        return pos == end


class FileStream(SeekStream):
    """SeekStream over a local file object (src/io/local_filesys.cc)."""

    def __init__(self, fileobj, own: bool = True):
        self._f = fileobj
        self._own = own

    def read(self, size: int) -> bytes:
        return self._f.read(size)

    def readinto(self, mv: memoryview) -> int:
        n = self._f.readinto(mv)
        return 0 if n is None else n

    def write(self, data) -> int:
        return self._f.write(data)

    def seek(self, pos: int) -> None:
        self._f.seek(pos)

    def tell(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        if self._own and self._f is not None:
            self._f.close()
            self._f = None

    def at_end(self) -> bool:
        pos = self._f.tell()
        end = self._f.seek(0, 2)
        self._f.seek(pos)
        return pos == end
