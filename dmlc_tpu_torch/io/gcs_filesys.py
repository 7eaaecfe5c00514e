"""GCS filesystem over the JSON API (the port of
``dmlc_tpu/io/gcs_filesys.py``).

The structure of the reference's S3 client (src/io/s3_filesys.cc):
ranged-GET streaming reads with retry (s3_filesys.cc:295-446, here
:class:`HttpReadStream`), buffered writes committed on close (the
multipart Init/Upload/Finish cycle, s3_filesys.cc:551-680, here one
resumable-upload session), stat and listing through the objects API,
and ``DMLC_GCS_WRITE_BUFFER_MB`` (default 64) for the chunk size.

Auth: a Bearer token from ``GCS_OAUTH_TOKEN``, else from a provider
installed with :func:`set_token_provider` (a metadata-server client).
``STORAGE_EMULATOR_HOST`` points every request at an emulator, as it
does Google's own clients.  ``DMLC_GCS_RETRIES`` and
``DMLC_GCS_RETRY_BASE_S`` shape the retry policy.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, List, Optional

from ..base import DMLCError, check, get_env
from ..resilience import RetryPolicy, fault_point
from ..resilience.retry import TRANSIENT_HTTP
from .filesys import FileInfo, FileSystem
from .http_filesys import HttpReadStream
from .stream import SeekStream, Stream
from .uri import URI

__all__ = ["GCSError", "GCSFileSystem", "GCSWriteStream",
           "set_token_provider"]

_token_provider: Optional[Callable[[], Optional[str]]] = None


def set_token_provider(fn: Optional[Callable[[], Optional[str]]]) -> None:
    """Install a callable returning an OAuth2 access token (or None)."""
    global _token_provider
    _token_provider = fn


def _endpoint() -> str:
    emu = os.environ.get("STORAGE_EMULATOR_HOST")
    if emu:
        return emu if "://" in emu else f"http://{emu}"
    return "https://storage.googleapis.com"


def _auth_headers() -> dict:
    token = os.environ.get("GCS_OAUTH_TOKEN")
    if token is None and _token_provider is not None:
        token = _token_provider()
    return {"Authorization": f"Bearer {token}"} if token else {}


class GCSError(DMLCError):
    """A GCS API failure; ``transient`` marks a retryable one."""

    def __init__(self, msg: str, *, code: Optional[int] = None,
                 transient: bool = False):
        super().__init__(msg, status=code, transient=transient)

    @property
    def code(self) -> Optional[int]:
        """``status`` under the reference's other name."""
        return self.status


def _policy(retry: bool = True) -> RetryPolicy:
    """The GCS retry policy.  ``retry=False`` is one attempt, for the
    resumable chunk PUTs, which recover through the committed-range
    probe instead: a blind resend could commit a chunk twice."""
    if not retry:
        return RetryPolicy(attempts=1, name="gcs")
    return RetryPolicy.from_env(retries_env="DMLC_GCS_RETRIES",
                                default_attempts=5,
                                base_env="DMLC_GCS_RETRY_BASE_S",
                                name="gcs")


def _api(url: str, *, method: str = "GET", data: Optional[bytes] = None,
         headers: Optional[dict] = None, ok=(200,), retry: bool = True):
    """One API call, retried with backoff on 5xx, 429 and timeouts."""
    short_url = url.split("?")[0]

    def attempt():
        fault_point("gcs.request", method=method, url=short_url)
        req = urllib.request.Request(url, data=data, method=method,
                                     headers={**_auth_headers(),
                                              **(headers or {})})
        try:
            resp = urllib.request.urlopen(req, timeout=60)
        except urllib.error.HTTPError as e:
            if e.code in ok:
                return e   # 308 resume-incomplete is an answer
            raise GCSError(
                f"GCS {method} {short_url} failed: HTTP {e.code} "
                f"{e.read()[:200]!r}", code=e.code,
                transient=e.code in TRANSIENT_HTTP) from e
        except urllib.error.URLError as e:   # DNS, refused, timeouts
            raise GCSError(f"GCS {method} {short_url} failed: {e.reason}",
                           transient=True) from e
        check(resp.status in ok,
              f"GCS {method}: unexpected HTTP {resp.status}")
        return resp

    return _policy(retry).call(attempt)


class GCSWriteStream(Stream):
    """Buffered resumable upload, committed on close: the session opens
    here, each full chunk goes up from ``write()``, and ``close()`` sends
    the rest with the total size.  An exception inside a ``with`` block
    aborts instead (the session is deleted; nothing becomes visible)."""

    def __init__(self, bucket: str, obj: str):
        mb = get_env("DMLC_GCS_WRITE_BUFFER_MB", 64)
        # resumable chunks are multiples of 256 KiB (the API's rule)
        self._chunk = max(mb << 20, 256 << 10)
        self._buf = bytearray()
        self._offset = 0   # bytes the session has committed
        self._closed = False
        name = urllib.parse.quote(obj, safe="")
        url = (f"{_endpoint()}/upload/storage/v1/b/{bucket}/o"
               f"?uploadType=resumable&name={name}")
        resp = _api(url, method="POST", data=b"",
                    headers={"Content-Type": "application/json",
                             "X-Upload-Content-Type":
                                 "application/octet-stream"})
        self._session = resp.headers.get("Location")
        check(self._session, "GCS resumable upload: no session URI")

    def read(self, size: int) -> bytes:
        raise DMLCError("GCSWriteStream is write-only")

    def write(self, data: bytes) -> int:
        check(not self._closed, "write on closed GCSWriteStream")
        self._buf += data
        while len(self._buf) >= self._chunk:
            self._put_chunk(final=False)
        return len(data)

    def _query_committed(self) -> Optional[int]:
        """The bytes the session has committed (the 308 Range probe), or
        None once the object is finalized."""
        resp = _api(self._session, method="PUT", data=b"",
                    headers={"Content-Range": "bytes */*"},
                    ok=(308, 200, 201))
        status = getattr(resp, "status", None) or resp.code
        if status in (200, 201):
            return None
        rng = resp.headers.get("Range")   # "bytes=0-<last>" or absent
        return int(rng.rsplit("-", 1)[1]) + 1 if rng else 0

    def _put_range(self, body: bytes, total_str: str, ok) -> None:
        """A PUT that recovers an interrupted chunk: after a transient
        failure it asks the session what it committed and resends only
        the rest, so no byte is committed twice or lost.  Its own loop
        (the probe runs between attempts) on the policy's backoff,
        classification and counters."""
        policy = _policy()
        start = self._offset
        for i in range(policy.attempts):
            crange = (f"bytes {start}-{start + len(body) - 1}/{total_str}"
                      if body else f"bytes */{total_str}")
            try:
                _api(self._session, method="PUT", data=body,
                     headers={"Content-Range": crange}, ok=ok, retry=False)
                self._offset = start + len(body)
                return
            except GCSError as e:
                if not policy.is_retryable(e) or i + 1 >= policy.attempts:
                    raise
                policy.sleep_for(i, error=e)
                committed = self._query_committed()
                if committed is None:   # the final PUT landed after all
                    self._offset = start + len(body)
                    return
                skip = committed - start
                if skip > 0:
                    body = body[skip:]
                    start = committed

    def _put_chunk(self, final: bool) -> None:
        if final:
            body = bytes(self._buf)
            self._buf = bytearray()
            self._put_range(body, str(self._offset + len(body)),
                            ok=(200, 201))
        else:
            body = bytes(self._buf[: self._chunk])
            del self._buf[: self._chunk]
            self._put_range(body, "*", ok=(308,))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._put_chunk(final=True)

    def abort(self) -> None:
        """Cancel the upload: DELETE the session (the abort of the
        reference's S3 writer, s3_filesys.cc:583-590); nothing becomes
        visible."""
        if self._closed:
            return
        self._closed = True
        self._buf = bytearray()
        try:
            _api(self._session, method="DELETE", data=b"",
                 ok=(200, 204, 404, 499))
        except GCSError:
            pass   # abandoning the session is best effort

    def __exit__(self, exc_type, exc, tb) -> None:
        # an exception mid-write must not commit a truncated object
        if exc_type is not None:
            self.abort()
        else:
            self.close()


class GCSFileSystem(FileSystem):
    """gs://bucket/object backend."""

    def _object_url(self, path: URI) -> str:
        name = urllib.parse.quote(path.name.lstrip("/"), safe="")
        return f"{_endpoint()}/storage/v1/b/{path.host}/o/{name}"

    def _media_url(self, path: URI) -> str:
        name = urllib.parse.quote(path.name.lstrip("/"), safe="")
        return (f"{_endpoint()}/download/storage/v1/b/{path.host}/o/{name}"
                "?alt=media")

    def get_path_info(self, path: URI) -> FileInfo:
        try:
            resp = _api(self._object_url(path))
        except DMLCError as e:
            if e.status == 404:
                # no real directories: a prefix with objects under it is
                # one (so an input split can shard a directory)
                if self.list_directory(path):
                    return FileInfo(path=path, size=0, type="directory")
                raise FileNotFoundError(path.str_uri()) from e
            raise
        meta = json.loads(resp.read())
        return FileInfo(path=path, size=int(meta.get("size", 0)), type="file")

    def list_directory(self, path: URI) -> List[FileInfo]:
        prefix = path.name.lstrip("/")
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        out: List[FileInfo] = []
        page: Optional[str] = None
        while True:
            q = {"prefix": prefix, "delimiter": "/"}
            if page:
                q["pageToken"] = page
            url = (f"{_endpoint()}/storage/v1/b/{path.host}/o?"
                   + urllib.parse.urlencode(q))
            data = json.loads(_api(url).read())
            for item in data.get("items", []):
                out.append(FileInfo(
                    path=URI(f"gs://{path.host}/{item['name']}"),
                    size=int(item.get("size", 0)), type="file"))
            for pre in data.get("prefixes", []):
                out.append(FileInfo(
                    path=URI(f"gs://{path.host}/{pre.rstrip('/')}"),
                    size=0, type="directory"))
            page = data.get("nextPageToken")
            if not page:
                return out

    def open(self, path: URI, mode: str, allow_null: bool = False
             ) -> Optional[Stream]:
        if mode in ("w", "wb"):
            return GCSWriteStream(path.host, path.name.lstrip("/"))
        check(mode in ("r", "rb"), f"unsupported mode {mode!r}")
        return self.open_for_read(path, allow_null)

    def open_for_read(self, path: URI, allow_null: bool = False
                      ) -> Optional[SeekStream]:
        try:
            # the size from one HEAD of the media URL; the headers are a
            # callable, so a token refreshes per request
            return HttpReadStream(self._media_url(path), size=None,
                                  headers=_auth_headers)
        except Exception:
            if allow_null:
                return None
            raise
