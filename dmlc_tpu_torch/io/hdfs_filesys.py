"""HDFS over the WebHDFS REST API (the port of
``dmlc_tpu/io/hdfs_filesys.py``).

The reference wraps libhdfs through JNI (src/io/hdfs_filesys.{h,cc});
this backend speaks the namenode's own HTTP gateway instead, on urllib:
stat (GETFILESTATUS), listing (LISTSTATUS), ranged streaming reads
(OPEN with offset and length, following the namenode's 307 to a
datanode) and buffered writes (CREATE, then APPEND for each chunk).
Each namenode host gets one FileSystem from the dispatch.

Endpoint: ``DMLC_WEBHDFS_ENDPOINT`` (an emulator or a gateway, http or
https), else ``http://<uri host>:<DMLC_WEBHDFS_PORT>`` (default 9870):
a port in the URI is the RPC port, not HTTP.  ``DMLC_HDFS_USER`` (else
``USER``) goes out as ``user.name``; simple auth only, so a Kerberos
cluster answers 401 (reach it through an authenticating gateway such as
Knox or HttpFS).  ``DMLC_HDFS_WRITE_BUFFER_MB`` (default 64) is the
chunk size, ``DMLC_HDFS_RETRIES`` the attempts an idempotent request
gets.

Durability: a write goes to a hidden ``.<name>.tmp.<pid>.<nonce>``
sibling and is RENAMEd into place at close, so no reader sees a torn
file and directory scans skip the temp (Hadoop's hidden-file rule).
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import List, Optional

from ..base import DMLCError, check, get_env
from ..concurrency import make_lock
from ..resilience import RetryPolicy, fault_point
from .filesys import FileInfo, FileSystem
from .http_filesys import HttpReadStream
from .stream import SeekStream, Stream
from .uri import URI

__all__ = ["WebHDFSFileSystem", "WebHdfsReadStream", "WebHdfsWriteStream"]

_DEFAULT_HTTP_PORT = "9870"   # Hadoop 3's namenode HTTP port (2.x: 50070)


def _endpoint(uri: URI) -> str:
    env = get_env("DMLC_WEBHDFS_ENDPOINT", "")
    if env:
        return env if "://" in env else f"http://{env}"
    host = uri.host.split(":", 1)[0]
    check(bool(host), "hdfs:// URI has no namenode host and "
                      "DMLC_WEBHDFS_ENDPOINT is unset")
    return f"http://{host}:{get_env('DMLC_WEBHDFS_PORT', _DEFAULT_HTTP_PORT)}"


def _user_params() -> dict:
    user = get_env("DMLC_HDFS_USER", "") or os.environ.get("USER")
    return {"user.name": user} if user else {}


def _op_url(base: str, path: str, op: str, **params) -> str:
    q = {"op": op, **_user_params(), **params}
    return (f"{base}/webhdfs/v1{urllib.parse.quote(path)}?"
            + urllib.parse.urlencode(q))


def _request(url: str, method: str, data: Optional[bytes] = None,
             ok=(200, 201), retry: bool = False) -> object:
    """One WebHDFS call, following the namenode's 307 redirect by hand
    (urllib follows redirects of GET and HEAD only).

    ``retry=True`` retries the whole redirect dance under a RetryPolicy
    (``DMLC_HDFS_RETRIES``): only for idempotent operations (stat, list,
    reads, DELETE).  An APPEND resent blindly would commit its chunk
    twice, and a RENAME resent after a lost reply would read as
    'destination exists'."""

    def attempt(start_url=url):
        fault_point("hdfs.request", method=method,
                    url=start_url.split("?")[0])
        u = start_url
        for _hop in range(4):
            req = urllib.request.Request(u, data=data, method=method)
            if data is not None:
                req.add_header("Content-Type", "application/octet-stream")
            try:
                resp = urllib.request.urlopen(req, timeout=60)
            except urllib.error.HTTPError as e:
                if e.code == 307 and e.headers.get("Location"):
                    u = e.headers["Location"]
                    continue
                if e.code in ok:   # a DELETE of an absent path
                    return e
                hint = (" (the cluster requires authentication: this "
                        "backend speaks simple auth only; point "
                        "DMLC_WEBHDFS_ENDPOINT at an authenticating gateway "
                        "such as Knox or HttpFS)") if e.code == 401 else ""
                raise DMLCError(
                    f"WebHDFS {method} {u.split('?')[0]} failed: "
                    f"HTTP {e.code} {e.read()[:300]!r}{hint}",
                    status=e.code) from e
            except urllib.error.URLError as e:   # namenode gone, timeouts
                raise DMLCError(f"WebHDFS {method} {u.split('?')[0]} "
                                f"failed: {e.reason}", transient=True) from e
            if resp.status == 307 and resp.headers.get("Location"):
                u = resp.headers["Location"]
                continue
            check(resp.status in ok,
                  f"WebHDFS {method}: unexpected HTTP {resp.status}")
            return resp
        raise DMLCError(f"WebHDFS {method}: redirect loop at "
                        f"{u.split('?')[0]}")

    if not retry:
        return attempt()
    return RetryPolicy.from_env(retries_env="DMLC_HDFS_RETRIES",
                                default_attempts=4,
                                name="hdfs").call(attempt)


def _probe_redirect(url: str, method: str) -> Optional[str]:
    """The bodyless first hop of a WebHDFS write: the namenode answers
    307 with the datanode's Location before any payload (a body sent to
    it breaks the pipe past a socket buffer).  None when a gateway
    handled the request inline, committing zero bytes."""
    req = urllib.request.Request(url, method=method)
    try:
        resp = urllib.request.urlopen(req, timeout=60)
    except urllib.error.HTTPError as e:
        if e.code == 307 and e.headers.get("Location"):
            return e.headers["Location"]
        raise DMLCError(f"WebHDFS {method} {url.split('?')[0]} failed: "
                        f"HTTP {e.code} {e.read()[:300]!r}",
                        status=e.code) from e
    if resp.status == 307 and resp.headers.get("Location"):
        return resp.headers["Location"]
    return None


def _write_op(url: str, method: str, body: bytes, ok) -> None:
    """The two-step write: probe, then send the payload to the datanode
    named, or inline (``data=true``, HttpFS's way) when none was."""
    loc = _probe_redirect(url, method)
    if loc is None:
        loc = f"{url}{'&' if '?' in url else '?'}data=true"
        if method == "PUT":   # the probe's empty CREATE is replaced
            loc += "&overwrite=true"
    _request(loc, method, data=body, ok=ok)


class WebHdfsReadStream(HttpReadStream):
    """SeekStream over OPEN windows: the byte range goes as query
    parameters (and a 307 to a datanode) instead of a Range header."""

    def __init__(self, base: str, path: str, size: int,
                 buffer_bytes: int = 1 << 20):
        self._base = base
        self._path = path
        super().__init__(url="", size=size, buffer_bytes=buffer_bytes)

    def _fill(self, start: int, size: int) -> bytes:
        size = min(size, self._size - start)
        if size <= 0:
            return b""
        resp = _request(_op_url(self._base, self._path, "OPEN",
                                offset=start, length=size), "GET",
                        retry=True)
        body = resp.read()
        check(len(body) == size, f"WebHDFS OPEN returned {len(body)} bytes "
              f"for span {start}+{size}")
        return body


_nonce_lock = make_lock("hdfs_filesys._nonce_lock")
_nonce = [0]


def _next_nonce() -> int:
    with _nonce_lock:
        _nonce[0] += 1
        return _nonce[0]


class WebHdfsWriteStream(Stream):
    """Buffered writer: CREATE with the first chunk, APPEND the rest, all
    to a hidden temp RENAMEd to the destination at close.

    An existing destination is first RENAMEd aside to a hidden
    ``.<name>.old.<pid>.<n>``, the temp renamed into place, and the
    backup deleted: each step is atomic on the namenode, so a crash
    leaves the old version live or recoverable at the backup, never a
    torn file (WebHDFS has no atomic swap; a reader can find the
    destination absent between the renames).  A failed chunk poisons
    the stream: ``close()`` deletes the temp and publishes nothing."""

    def __init__(self, base: str, path: str):
        mb = get_env("DMLC_HDFS_WRITE_BUFFER_MB", 64)
        self._chunk = max(mb << 20, 1 << 20)
        self._base = base
        self._path = path
        d, _, name = path.rpartition("/")
        self._tmp = f"{d}/.{name}.tmp.{os.getpid()}.{_next_nonce()}"
        self._buf = bytearray()
        self._created = False
        self._closed = False
        self._failed = False

    def read(self, size: int) -> bytes:
        raise DMLCError("WebHdfsWriteStream is write-only")

    def write(self, data: bytes) -> int:
        check(not self._closed, "write on closed WebHdfsWriteStream")
        check(not self._failed, "write on failed WebHdfsWriteStream")
        self._buf += data
        while len(self._buf) >= self._chunk:
            self._flush(self._chunk)
        return len(data)

    def _flush(self, n: int) -> None:
        body = bytes(self._buf[:n])
        del self._buf[:n]
        try:
            if not self._created:
                _write_op(_op_url(self._base, self._tmp, "CREATE",
                                  overwrite="true"), "PUT", body,
                          ok=(200, 201))
                self._created = True
            else:
                _write_op(_op_url(self._base, self._tmp, "APPEND"), "POST",
                          body, ok=(200,))
        except Exception:
            self._failed = True
            raise

    def _delete(self, path: str) -> None:
        try:
            _request(_op_url(self._base, path, "DELETE"), "DELETE",
                     ok=(200, 404), retry=True)
        except DMLCError:
            pass   # best effort; the dot prefix keeps it out of scans

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._failed:
            self._delete(self._tmp)
            return   # the original flush error stands
        try:
            if self._buf or not self._created:   # an empty file too
                self._flush(len(self._buf))
            # a fresh destination commits in one RENAME; WebHDFS refuses
            # ({"boolean": false}) an existing one, which is backed up
            if not self._rename_to(self._tmp, self._path):
                d, _, name = self._path.rpartition("/")
                backup = f"{d}/.{name}.old.{os.getpid()}.{_next_nonce()}"
                check(self._rename_to(self._path, backup),
                      f"WebHDFS RENAME {self._path} -> {backup} (backup "
                      "of the old version) refused by namenode")
                if not self._rename_to(self._tmp, self._path):
                    # put the old version back before failing
                    self._rename_to(backup, self._path)
                    check(False, f"WebHDFS RENAME {self._tmp} -> "
                          f"{self._path} refused by namenode after moving "
                          "the old version aside")
                self._delete(backup)
        except Exception:
            self._delete(self._tmp)
            raise

    def _rename_to(self, src: str, dst: str) -> bool:
        resp = _request(_op_url(self._base, src, "RENAME", destination=dst),
                        "PUT", ok=(200,))
        return bool(json.loads(resp.read()).get("boolean"))


class WebHDFSFileSystem(FileSystem):
    """hdfs://namenode/path backend over WebHDFS."""

    def __init__(self, uri: URI):
        self._base = _endpoint(uri)
        self._host = uri.host

    @staticmethod
    def _info(path: URI, st: dict) -> FileInfo:
        kind = "directory" if st.get("type") == "DIRECTORY" else "file"
        return FileInfo(path=path, size=int(st.get("length", 0)), type=kind)

    def get_path_info(self, path: URI) -> FileInfo:
        try:
            resp = _request(_op_url(self._base, path.name, "GETFILESTATUS"),
                            "GET", retry=True)
        except DMLCError as e:
            if e.status == 404:
                raise FileNotFoundError(path.str_uri()) from e
            raise
        return self._info(path, json.loads(resp.read())["FileStatus"])

    def list_directory(self, path: URI) -> List[FileInfo]:
        resp = _request(_op_url(self._base, path.name, "LISTSTATUS"), "GET",
                        retry=True)
        base = path.name.rstrip("/")
        out = []
        for st in json.loads(resp.read())["FileStatuses"]["FileStatus"]:
            # the suffix is empty when LISTSTATUS names a plain file
            child = f"{base}/{st['pathSuffix']}" if st.get("pathSuffix") \
                else path.name
            out.append(self._info(URI(f"hdfs://{self._host}{child}"), st))
        return out

    def open(self, path: URI, mode: str, allow_null: bool = False
             ) -> Optional[Stream]:
        if mode in ("w", "wb"):
            return WebHdfsWriteStream(self._base, path.name)
        check(mode in ("r", "rb"), f"unsupported mode {mode!r}")
        return self.open_for_read(path, allow_null)

    def open_for_read(self, path: URI, allow_null: bool = False
                      ) -> Optional[SeekStream]:
        try:
            return WebHdfsReadStream(self._base, path.name,
                                     self.get_path_info(path).size)
        except Exception:
            if allow_null:
                return None
            raise
