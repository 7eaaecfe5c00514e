"""Azure Blob Storage backend over the Blob service REST API (the port of
``dmlc_tpu/io/azure_filesys.py``).

The reference (src/io/azure_filesys.cc:31-92) links the casablanca SDK
and lists directories only, with the account and key from
``AZURE_STORAGE_ACCOUNT`` / ``AZURE_STORAGE_ACCESS_KEY``.  This backend
keeps that environment and speaks REST on urllib and hmac: listing,
stat, ranged streaming reads and block-blob writes, so azure:// URIs
work wherever a Stream or an input split does.

Auth: Shared Key (HMAC-SHA256 over the canonical request, x-ms-version
2020-10-02), or a SAS token from ``AZURE_STORAGE_SAS_TOKEN`` appended
to every URL unsigned; anonymous without either.
``DMLC_AZURE_ENDPOINT`` replaces the account endpoint (an emulator),
``DMLC_AZURE_BLOCK_MB`` (default 64) is the block size and
``DMLC_AZURE_RETRIES`` the attempts a request gets.  URIs are
``azure://container/path``, the account from the environment.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import urllib.parse
import xml.etree.ElementTree as ET
from email.utils import formatdate
from typing import List, Optional

from ..base import DMLCError, check, get_env
from .filesys import FileInfo, FileSystem
from .http_filesys import HttpReadStream
from .rest import rest_request
from .stream import SeekStream, Stream
from .uri import URI

__all__ = ["AzureFileSystem", "AzureReadStream", "AzureWriteStream",
           "sign_request"]

_API_VERSION = "2020-10-02"


def _account() -> str:
    acct = os.environ.get("AZURE_STORAGE_ACCOUNT")
    check(bool(acct), "azure:// needs AZURE_STORAGE_ACCOUNT set "
                      "(the reference's env contract, azure_filesys.cc:35)")
    return acct


def _endpoint() -> str:
    env = get_env("DMLC_AZURE_ENDPOINT", "")
    if env:
        return env if "://" in env else f"http://{env}"
    return f"https://{_account()}.blob.core.windows.net"


def _sas_token() -> str:
    return os.environ.get("AZURE_STORAGE_SAS_TOKEN", "").lstrip("?")


def _with_sas(url: str) -> str:
    sas = _sas_token()
    if not sas:
        return url
    return url + ("&" if "?" in url else "?") + sas


def sign_request(method: str, url: str, headers: dict,
                 content_length: int = 0) -> dict:
    """The Shared Key headers of one request: a new dict with
    ``x-ms-date``, ``x-ms-version`` and ``Authorization`` (none under a
    SAS token or without a key)."""
    key_b64 = os.environ.get("AZURE_STORAGE_ACCESS_KEY")
    out = dict(headers)
    if _sas_token() or not key_b64:
        return out
    # canonicalization ignores case; urllib capitalizes wire headers
    # ('X-ms-date'), so index by lower case and keep the caller's keys
    low = {k.lower(): v for k, v in out.items()}
    if "x-ms-date" not in low:
        low["x-ms-date"] = out["x-ms-date"] = formatdate(usegmt=True)
    if "x-ms-version" not in low:
        low["x-ms-version"] = out["x-ms-version"] = _API_VERSION
    u = urllib.parse.urlparse(url)
    xms = sorted((k, v.strip()) for k, v in low.items()
                 if k.startswith("x-ms-"))
    canon_headers = "".join(f"{k}:{v}\n" for k, v in xms)
    canon_res = f"/{_account()}{u.path}"
    # keep_blank_values: 'prefix=' at a container root signs 'prefix:'
    for k, vals in sorted(urllib.parse.parse_qs(
            u.query, keep_blank_values=True).items()):
        canon_res += f"\n{k.lower()}:{','.join(sorted(vals))}"
    # 11 header slots: encoding, language, length, md5, type, date,
    # if-modified-since, if-match, if-none-match, if-unmodified, range
    length = str(content_length) if content_length else ""
    slots = ["", "", length, "", low.get("content-type", ""), "",
             "", "", "", "", low.get("range", "")]
    string_to_sign = "\n".join([method, *slots, canon_headers + canon_res])
    mac = hmac.new(base64.b64decode(key_b64),
                   string_to_sign.encode("utf-8"), hashlib.sha256)
    out["Authorization"] = (f"SharedKey {_account()}:"
                            f"{base64.b64encode(mac.digest()).decode()}")
    return out


def _sign(method: str, url: str, headers: dict,
          data: Optional[bytes]) -> dict:
    """The per-attempt signer: a fresh ``x-ms-date`` each try."""
    return sign_request(method, url, headers,
                        content_length=len(data) if data else 0)


def _request(url: str, method: str = "GET", data: Optional[bytes] = None,
             headers: Optional[dict] = None, ok=(200, 201, 206)):
    """Every request of this backend is idempotent (GET, HEAD, Put Blob,
    Put Block under its id, Put Block List), so the blind resend is
    safe."""
    return rest_request("Azure", _with_sas(url), method, data, headers,
                        ok, sign=_sign, retries_env="DMLC_AZURE_RETRIES")


class AzureReadStream(HttpReadStream):
    """Ranged reads, each fill signed on its own (the Range header is
    signed)."""

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


class AzureWriteStream(Stream):
    """Buffered block-blob writer, committed at close.

    A blob that fits one block (``DMLC_AZURE_BLOCK_MB``) goes up as one
    Put Blob; a larger one is staged block by block from ``write()``
    under deterministic ids and committed by one Put Block List in
    ``close()``.  Either way it becomes visible only at close.  A failed
    block poisons the stream: a later ``close()`` commits nothing."""

    def __init__(self, url: str):
        mb = get_env("DMLC_AZURE_BLOCK_MB", 64)
        self._block = max(mb << 20, 1 << 20)
        self._url = url
        self._buf = bytearray()
        self._block_ids: List[str] = []
        # uncommitted blocks are scoped per blob: a random prefix keeps
        # two writers of one blob apart, while a retried block keeps its
        # id within this stream
        self._id_prefix = os.urandom(6).hex()
        self._closed = False
        self._failed = False

    def read(self, size: int) -> bytes:
        raise DMLCError("AzureWriteStream is write-only")

    def write(self, data: bytes) -> int:
        check(not self._closed, "write on closed AzureWriteStream")
        check(not self._failed, "write on failed AzureWriteStream")
        self._buf += data
        while len(self._buf) >= self._block:
            self._stage_block(self._block)
        return len(data)

    def _stage_block(self, n: int) -> None:
        # equal-length ids, unique within the blob
        raw = f"{self._id_prefix}{len(self._block_ids):010d}".encode()
        bid = base64.b64encode(raw).decode()
        body = bytes(self._buf[:n])
        del self._buf[:n]
        try:
            _request(f"{self._url}?comp=block&blockid="
                     + urllib.parse.quote(bid), "PUT", data=body,
                     headers={"Content-Type": "application/octet-stream"},
                     ok=(201,))
        except Exception:
            # a lost block leaves a hole: no close() may commit the list
            # (the staged blocks stay invisible; the service drops them
            # after 7 days)
            self._failed = True
            raise
        self._block_ids.append(bid)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._failed:
            return   # nothing was committed; the original error stands
        if not self._block_ids:
            _request(self._url, "PUT", data=bytes(self._buf),
                     headers={"x-ms-blob-type": "BlockBlob",
                              "Content-Type": "application/octet-stream"},
                     ok=(201,))
            return
        if self._buf:
            self._stage_block(len(self._buf))
        xml = ("<?xml version='1.0' encoding='utf-8'?><BlockList>"
               + "".join(f"<Latest>{b}</Latest>" for b in self._block_ids)
               + "</BlockList>")
        _request(f"{self._url}?comp=blocklist", "PUT",
                 data=xml.encode("utf-8"),
                 headers={"Content-Type": "application/xml"}, ok=(201,))


class AzureFileSystem(FileSystem):
    """azure://container/blob backend."""

    def _blob_url(self, path: URI) -> str:
        name = urllib.parse.quote(path.name.lstrip("/"))
        return f"{_endpoint()}/{path.host}/{name}"

    def get_path_info(self, path: URI) -> FileInfo:
        try:
            resp = _request(self._blob_url(path), "HEAD")
        except DMLCError as e:
            if e.status == 404:
                if self.list_directory(path):
                    return FileInfo(path=path, size=0, type="directory")
                raise FileNotFoundError(path.str_uri()) from e
            raise
        return FileInfo(path=path,
                        size=int(resp.headers.get("Content-Length", 0)),
                        type="file")

    def list_directory(self, path: URI) -> List[FileInfo]:
        """List Blobs with a delimiter (the reference's one operation,
        azure_filesys.cc:47-92)."""
        prefix = path.name.lstrip("/")
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        out: List[FileInfo] = []
        marker = ""
        while True:
            q = {"restype": "container", "comp": "list",
                 "prefix": prefix, "delimiter": "/"}
            if marker:
                q["marker"] = marker
            url = f"{_endpoint()}/{path.host}?" + urllib.parse.urlencode(q)
            root = ET.fromstring(_request(url).read())
            for blob in root.iter("Blob"):
                size = blob.findtext("Properties/Content-Length") or "0"
                out.append(FileInfo(
                    path=URI(f"azure://{path.host}/{blob.findtext('Name')}"),
                    size=int(size), type="file"))
            for pre in root.iter("BlobPrefix"):
                name = (pre.findtext("Name") or "").rstrip("/")
                out.append(FileInfo(path=URI(f"azure://{path.host}/{name}"),
                                    size=0, type="directory"))
            marker = root.findtext("NextMarker") or ""
            if not marker:
                return out

    def open(self, path: URI, mode: str, allow_null: bool = False
             ) -> Optional[Stream]:
        if mode in ("w", "wb"):
            return AzureWriteStream(self._blob_url(path))
        check(mode in ("r", "rb"), f"unsupported mode {mode!r}")
        return self.open_for_read(path, allow_null)

    def open_for_read(self, path: URI, allow_null: bool = False
                      ) -> Optional[SeekStream]:
        try:
            return AzureReadStream(self._blob_url(path),
                                   self.get_path_info(path).size)
        except Exception:
            if allow_null:
                return None
            raise
