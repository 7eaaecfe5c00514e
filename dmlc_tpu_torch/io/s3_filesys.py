"""Amazon S3 backend: SigV4 over urllib (the port of
``dmlc_tpu/io/s3_filesys.py``).

The reference's libcurl client (src/io/s3_filesys.cc) in its roles:
stat (HEAD), listing (ListObjectsV2 with a delimiter, s3_filesys.cc:801),
ranged streaming reads (s3_filesys.cc:295-446) and buffered multipart
writes (Init → one PUT a part → CompleteMultipartUpload,
s3_filesys.cc:551-799), signed with SigV4 (the reference signs V2).

Environment, as the reference's (s3_filesys.cc:891-894):
``AWS_ACCESS_KEY_ID``, ``AWS_SECRET_ACCESS_KEY``, ``AWS_SESSION_TOKEN``
(optional), ``AWS_REGION`` (default us-east-1) and
``DMLC_S3_WRITE_BUFFER_MB`` (default 64, the part size); besides,
``DMLC_S3_ENDPOINT`` addresses a custom endpoint path-style (minio, an
emulator), ``DMLC_S3_RETRIES`` the attempts a request gets.  Without
``DMLC_S3_ENDPOINT`` requests go virtual-host style to
``https://<bucket>.s3.<region>.amazonaws.com``.  With no key set the
requests go unsigned (public buckets).

An object becomes visible only at CompleteMultipartUpload (or its one
PUT when it fits a part); a failed upload is aborted rather than left
as billed orphan parts.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import time
import urllib.parse
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

from ..base import DMLCError, check, get_env
from .filesys import FileInfo, FileSystem
from .http_filesys import HttpReadStream
from .rest import rest_request
from .stream import SeekStream, Stream
from .uri import URI

__all__ = ["S3FileSystem", "S3ReadStream", "S3WriteStream", "sign_request"]

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _region() -> str:
    return os.environ.get("AWS_REGION") \
        or os.environ.get("AWS_DEFAULT_REGION") or "us-east-1"


def _endpoint_for(bucket: str) -> Tuple[str, str]:
    """(base URL, path prefix) of a bucket: path-style under a custom
    endpoint, virtual-host style on AWS."""
    env = get_env("DMLC_S3_ENDPOINT", "")
    if env:
        return (env if "://" in env else f"http://{env}"), f"/{bucket}"
    return f"https://{bucket}.s3.{_region()}.amazonaws.com", ""


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


def sign_request(method: str, url: str, headers: dict,
                 payload_hash: str = _EMPTY_SHA256) -> dict:
    """The SigV4 headers of one request: a new dict with ``host``,
    ``x-amz-date``, ``x-amz-content-sha256`` and ``Authorization``.

    A caller's ``x-amz-date`` is kept (an emulator countersigns with the
    client's timestamp).  Without ``AWS_ACCESS_KEY_ID`` the request goes
    unsigned."""
    out = dict(headers)
    u = urllib.parse.urlparse(url)
    low = {k.lower(): str(v).strip() for k, v in out.items()}
    low["host"] = u.netloc
    low["x-amz-content-sha256"] = payload_hash
    out["x-amz-content-sha256"] = payload_hash
    keyid = os.environ.get("AWS_ACCESS_KEY_ID")
    secret = os.environ.get("AWS_SECRET_ACCESS_KEY")
    if not keyid or not secret:
        return out
    if "x-amz-date" not in low:
        amzdate = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        low["x-amz-date"] = out["x-amz-date"] = amzdate
    token = os.environ.get("AWS_SESSION_TOKEN")
    if token and "x-amz-security-token" not in low:
        low["x-amz-security-token"] = out["x-amz-security-token"] = token
    amzdate = low["x-amz-date"]
    datestamp = amzdate[:8]
    region = _region()
    # every header sent is signed
    signed_names = sorted(low)
    canon_headers = "".join(f"{k}:{low[k]}\n" for k in signed_names)
    signed_headers = ";".join(signed_names)
    canon_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}"
        for k, vals in sorted(urllib.parse.parse_qs(
            u.query, keep_blank_values=True).items())
        for v in sorted(vals))
    # the path arrives percent-encoded once, as S3 canonicalizes it
    canonical = "\n".join([method, u.path or "/", canon_query,
                           canon_headers, signed_headers, payload_hash])
    scope = f"{datestamp}/{region}/s3/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amzdate, scope,
        hashlib.sha256(canonical.encode("utf-8")).hexdigest()])
    key = _hmac(_hmac(_hmac(_hmac(
        ("AWS4" + secret).encode("utf-8"), datestamp),
        region), "s3"), "aws4_request")
    sig = hmac.new(key, to_sign.encode("utf-8"), hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={keyid}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={sig}")
    return out


def _sign(method: str, url: str, headers: dict,
          data: Optional[bytes]) -> dict:
    """The per-attempt signer: a fresh ``x-amz-date`` each try."""
    payload_hash = hashlib.sha256(data).hexdigest() if data \
        else _EMPTY_SHA256
    return sign_request(method, url, headers, payload_hash)


def _request(url: str, method: str = "GET", data: Optional[bytes] = None,
             headers: Optional[dict] = None, ok=(200, 201, 204, 206)):
    """Every request of this backend is idempotent (GET, HEAD, a whole
    PUT, a part PUT under its number, Complete with the same list), so
    the shared blind resend is safe."""
    return rest_request("S3", url, method, data, headers, ok,
                        sign=_sign, retries_env="DMLC_S3_RETRIES")


class S3ReadStream(HttpReadStream):
    """Ranged reads, each fill signed on its own (the date must be fresh
    and the Range header is signed)."""

    def _fill(self, start: int, size: int) -> bytes:
        end = min(start + size, self._size) - 1
        if end < start:
            return b""
        resp = _request(self._url, "GET",
                        headers={"Range": f"bytes={start}-{end}"},
                        ok=(200, 206))
        body = resp.read()
        if resp.status == 200 and len(body) > end - start + 1:
            body = body[start: end + 1]   # the server ignored Range
        return body


class S3WriteStream(Stream):
    """Buffered multipart writer, committed at close.

    Parts of ``DMLC_S3_WRITE_BUFFER_MB`` (at least S3's 5 MiB) go up from
    ``write()``; ``close()`` completes the upload.  An object that fits
    one part goes up as one PUT.  A failure aborts the upload and
    poisons the stream: a later ``close()`` publishes nothing."""

    def __init__(self, url: str):
        mb = get_env("DMLC_S3_WRITE_BUFFER_MB", 64)
        self._part = max(mb << 20, 5 << 20)
        self._url = url
        self._buf = bytearray()
        self._upload_id: Optional[str] = None
        self._etags: List[str] = []
        self._total = 0   # bytes committed as parts
        self._closed = False
        self._failed = False

    def read(self, size: int) -> bytes:
        raise DMLCError("S3WriteStream is write-only")

    def write(self, data: bytes) -> int:
        check(not self._closed, "write on closed S3WriteStream")
        check(not self._failed, "write on failed S3WriteStream")
        self._buf += data
        while len(self._buf) >= self._part:
            self._put_part(self._part)
        return len(data)

    def _put_part(self, n: int) -> None:
        # any failure here (the init, a part, a reply without an ETag)
        # loses bytes the object cannot get back: poison and abort, so
        # the close() of a with-block publishes no truncated object
        try:
            if self._upload_id is None:
                resp = _request(f"{self._url}?uploads=", "POST", data=b"")
                uid = ET.fromstring(resp.read()).findtext("{*}UploadId")
                # set only once valid: _abort() must not DELETE an empty id
                check(bool(uid), "S3 InitiateMultipartUpload: no UploadId")
                self._upload_id = uid
            body = bytes(self._buf[:n])
            del self._buf[:n]
            resp = _request(
                f"{self._url}?partNumber={len(self._etags) + 1}"
                f"&uploadId={urllib.parse.quote(self._upload_id)}",
                "PUT", data=body)
            etag = resp.headers.get("ETag", "")
            check(bool(etag), "S3 UploadPart: no ETag in response")
            self._etags.append(etag)
            self._total += len(body)
        except Exception:
            self._failed = True
            self._abort()
            raise

    def _abort(self) -> None:
        if self._upload_id is None:
            return
        uid, self._upload_id = self._upload_id, None
        try:
            _request(f"{self._url}?uploadId={urllib.parse.quote(uid)}",
                     "DELETE", ok=(200, 204, 404))
        except DMLCError:
            pass   # best effort; the bucket's lifecycle rule is the backstop

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._failed:
            return   # aborted already; the original error stands
        if self._upload_id is None:
            _request(self._url, "PUT", data=bytes(self._buf),
                     headers={"Content-Type": "application/octet-stream"},
                     ok=(200,))
            return
        try:
            if self._buf:
                self._put_part(len(self._buf))
            xml = ("<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{i + 1}</PartNumber>"
                f"<ETag>{etag}</ETag></Part>"
                for i, etag in enumerate(self._etags))
                + "</CompleteMultipartUpload>")
            try:
                _request(f"{self._url}?uploadId="
                         f"{urllib.parse.quote(self._upload_id)}",
                         "POST", data=xml.encode("utf-8"),
                         headers={"Content-Type": "application/xml"},
                         ok=(200,))
            except DMLCError as e:
                # a retried Complete answering 404 NoSuchUpload may mean
                # the first attempt committed and lost its reply (the
                # commit deletes the upload id): the object at our size
                # is success
                if e.status != 404 or not self._object_committed():
                    raise
        except Exception:
            self._failed = True
            self._abort()
            raise

    def _object_committed(self) -> bool:
        """Whether the destination holds the bytes of our parts."""
        try:
            resp = _request(self._url, "HEAD")
        except DMLCError:
            return False
        return int(resp.headers.get("Content-Length", -1)) == self._total


class S3FileSystem(FileSystem):
    """s3://bucket/key backend."""

    def _object_url(self, path: URI) -> str:
        base, prefix = _endpoint_for(path.host)
        return f"{base}{prefix}/{urllib.parse.quote(path.name.lstrip('/'))}"

    def _bucket_url(self, bucket: str) -> str:
        base, prefix = _endpoint_for(bucket)
        return f"{base}{prefix}"

    def get_path_info(self, path: URI) -> FileInfo:
        try:
            resp = _request(self._object_url(path), "HEAD")
        except DMLCError as e:
            if e.status in (403, 404):
                # a miss answers 403 without s3:ListBucket; a prefix with
                # objects under it is a directory
                if self.list_directory(path):
                    return FileInfo(path=path, size=0, type="directory")
                raise FileNotFoundError(path.str_uri()) from e
            raise
        return FileInfo(path=path,
                        size=int(resp.headers.get("Content-Length", 0)),
                        type="file")

    def list_directory(self, path: URI) -> List[FileInfo]:
        """ListObjectsV2 with a '/' delimiter (the reference's
        ListObjects, s3_filesys.cc:801-888): Contents are files,
        CommonPrefixes directories."""
        prefix = path.name.lstrip("/")
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        out: List[FileInfo] = []
        token = ""
        while True:
            q = {"list-type": "2", "prefix": prefix, "delimiter": "/"}
            if token:
                q["continuation-token"] = token
            # quote_via=quote: a space goes out as %20 ('+' would sign as
            # a literal plus)
            url = (f"{self._bucket_url(path.host)}?"
                   + urllib.parse.urlencode(q, quote_via=urllib.parse.quote))
            root = ET.fromstring(_request(url).read())
            # {*}: S3 namespaces its XML, emulators often do not
            for obj in root.findall(".//{*}Contents"):
                key = obj.findtext("{*}Key") or ""
                if key.endswith("/"):
                    continue   # zero-byte "folder" placeholders
                out.append(FileInfo(
                    path=URI(f"s3://{path.host}/{key}"),
                    size=int(obj.findtext("{*}Size") or 0), type="file"))
            for pre in root.findall(".//{*}CommonPrefixes"):
                key = (pre.findtext("{*}Prefix") or "").rstrip("/")
                out.append(FileInfo(path=URI(f"s3://{path.host}/{key}"),
                                    size=0, type="directory"))
            token = root.findtext("{*}NextContinuationToken") or ""
            if not token:
                return out

    def open(self, path: URI, mode: str, allow_null: bool = False
             ) -> Optional[Stream]:
        if mode in ("w", "wb"):
            return S3WriteStream(self._object_url(path))
        check(mode in ("r", "rb"), f"unsupported mode {mode!r}")
        return self.open_for_read(path, allow_null)

    def open_for_read(self, path: URI, allow_null: bool = False
                      ) -> Optional[SeekStream]:
        try:
            return S3ReadStream(self._object_url(path),
                                self.get_path_info(path).size)
        except Exception:
            if allow_null:
                return None
            raise
