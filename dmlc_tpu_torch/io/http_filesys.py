"""HTTP(S) read-only filesystem: ranged-GET streaming with retry (the port
of ``dmlc_tpu/io/http_filesys.py``).

The reference's plain-HTTP read path (HttpReadStream in
src/io/s3_filesys.cc:533 and the CURLReadStreamBase ranged-GET and
retry-on-disconnect structure, s3_filesys.cc:295-446) on urllib.
Read-only: stat by HEAD, no listing, no writes.  The S3, GCS, Azure and
WebHDFS read streams subclass :class:`HttpReadStream` and replace only
its ``_fill``.
"""

from __future__ import annotations

import urllib.error
import urllib.request
from typing import List, Optional

from ..base import DMLCError, check, get_env
from ..resilience import RetryPolicy, fault_point, maybe_corrupt
from .filesys import FileInfo, FileSystem, UnsupportedListing
from .stream import SeekStream, Stream
from .uri import URI

__all__ = ["HTTPFileSystem", "HttpReadStream"]

#: 1 = every ranged fill is fetched twice and the two compared byte for
#: byte, so a response corrupted in flight is caught and fetched again.
#: Off by default: it doubles read traffic.
ENV_VERIFY_READS = "DMLC_INTEGRITY_VERIFY_READS"
ENV_READ_RETRIES = "DMLC_INTEGRITY_READ_RETRIES"


def _short(url: str) -> str:
    return url.split("?")[0]


class HttpReadStream(SeekStream):
    """SeekStream over ranged HTTP GETs with buffered fills and retry.

    ``headers`` is a dict or a zero-argument callable returning one; a
    callable is resolved again on every request, so an auth token can
    refresh mid-stream."""

    def __init__(self, url: str, size: Optional[int] = None,
                 headers=None, buffer_bytes: int = 1 << 20):
        self._url = url
        self._headers = headers if callable(headers) else dict(headers or {})
        self._size = self._head_size() if size is None else size
        self._pos = 0
        self._buf = b""
        self._buf_start = 0
        self._buffer_bytes = buffer_bytes

    def _resolve_headers(self) -> dict:
        return dict(self._headers()) if callable(self._headers) \
            else dict(self._headers)

    def _head_size(self) -> int:
        req = urllib.request.Request(self._url, method="HEAD",
                                     headers=self._resolve_headers())
        with urllib.request.urlopen(req, timeout=60) as r:
            length = r.headers.get("Content-Length")
            check(length is not None, f"no Content-Length from {self._url}")
            return int(length)

    def _fill(self, start: int, size: int) -> bytes:
        """Ranged GET of ``[start, start + size)`` under a RetryPolicy
        (attempts from ``DMLC_HTTP_RETRIES``); a 4xx is not retried."""
        end = min(start + size, self._size) - 1
        if end < start:
            return b""

        def attempt():
            fault_point("http.request", url=_short(self._url))
            headers = self._resolve_headers()
            headers["Range"] = f"bytes={start}-{end}"
            req = urllib.request.Request(self._url, headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    body = r.read()
                    if r.status == 206:
                        return body
                    # a server ignoring Range answers 200 with the whole
                    # body: fine only when that is the span asked for
                    if r.status == 200 and start == 0 \
                            and len(body) == end - start + 1:
                        return body
                    raise DMLCError(
                        f"server ignored Range request (HTTP {r.status}, "
                        f"{len(body)} bytes for span {start}-{end})")
            except urllib.error.HTTPError as e:
                raise DMLCError(
                    f"HTTP {e.code} reading {_short(self._url)}",
                    status=e.code,
                    transient=None if 400 <= e.code < 500 else True) from e
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                # a transport failure is a transient DMLCError: retried,
                # and after the last attempt callers catch one type
                raise DMLCError(f"HTTP read {_short(self._url)} failed: {e}",
                                transient=True) from e

        policy = RetryPolicy.from_env(retries_env="DMLC_HTTP_RETRIES",
                                      default_attempts=3, name="http")
        return policy.call(attempt)

    def _verified_fill(self, start: int, size: int) -> bytes:
        """One ranged fill through the integrity layer (every backend's
        reads come here).

        An armed ``storage.response=corrupt`` fault flips bytes of the
        response.  With ``DMLC_INTEGRITY_VERIFY_READS=1`` each fill is
        fetched twice and compared byte for byte; a mismatch is counted
        (``integrity/read_verify_failures``, a ``read_verify_failure``
        event) and the pair fetched again, up to
        ``DMLC_INTEGRITY_READ_RETRIES`` times, so a corrupted response is
        caught and healed, never served.  Persistent disagreement
        raises.  The fault site sees each fetch's role, ``fetch=read``
        (the first of a pair) or ``fetch=confirm``, so a rule can select
        one (``storage.response@fetch:read=corrupt::2``); a rule without
        the predicate fires on both, as in the JAX package."""
        out = maybe_corrupt("storage.response", self._fill(start, size),
                            fetch="read")
        if not get_env(ENV_VERIFY_READS, False) or not out:
            return out
        retries = max(1, get_env(ENV_READ_RETRIES, 4))
        for attempt in range(retries):
            confirm = maybe_corrupt("storage.response",
                                    self._fill(start, size), fetch="confirm")
            if out == confirm:
                return out
            from .. import telemetry

            telemetry.inc("integrity", "read_verify_failures")
            telemetry.record_event(
                "read_verify_failure", url=_short(self._url), start=start,
                size=len(out), attempt=attempt)
            if attempt + 1 < retries:   # no comparison follows the last
                out = maybe_corrupt("storage.response",
                                    self._fill(start, size), fetch="read")
        raise DMLCError(
            f"ranged read {_short(self._url)} [{start}, {start + size}) "
            f"failed double-read verification {retries} times — "
            "persistent response corruption")

    def read(self, size: int) -> bytes:
        if self._pos >= self._size:
            return b""
        size = min(size, self._size - self._pos)
        off = self._pos - self._buf_start
        if not (0 <= off < len(self._buf)):
            self._buf_start = self._pos
            self._buf = self._verified_fill(self._pos,
                                            max(size, self._buffer_bytes))
            off = 0
        out = self._buf[off: off + size]
        if len(out) < size:   # the request runs past the buffered window
            out += self._verified_fill(self._pos + len(out),
                                       size - len(out))
        self._pos += len(out)
        return out

    def write(self, data: bytes) -> int:
        raise DMLCError("HttpReadStream is read-only")

    def seek(self, pos: int) -> None:
        check(0 <= pos <= self._size, "seek out of range")
        self._pos = pos

    def tell(self) -> int:
        return self._pos

    def at_end(self) -> bool:
        return self._pos >= self._size


class HTTPFileSystem(FileSystem):
    """Read-only http(s):// backend."""

    def get_path_info(self, path: URI) -> FileInfo:
        return FileInfo(path=path, size=HttpReadStream(path.str_uri())._size,
                        type="file")

    def list_directory(self, path: URI) -> List[FileInfo]:
        raise UnsupportedListing("HTTP filesystem does not support listing")

    def open(self, path: URI, mode: str, allow_null: bool = False
             ) -> Optional[Stream]:
        check(mode in ("r", "rb"), "HTTP filesystem is read-only")
        return self.open_for_read(path, allow_null)

    def open_for_read(self, path: URI, allow_null: bool = False
                      ) -> Optional[SeekStream]:
        try:
            return HttpReadStream(path.str_uri())
        except Exception:
            if allow_null:
                return None
            raise
