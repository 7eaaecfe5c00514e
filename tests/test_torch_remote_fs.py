"""The port's remote filesystems (S3, GCS, Azure, WebHDFS, HTTP) against
the JAX package's own emulators, imported from its tests as its
checkpoint tests import them.  The S3 and Azure emulators countersign
every request with the JAX package's ``sign_request``, so a request the
port's client gets through carries the reference's signature.  Each case
of ``tests/test_s3.py``, ``tests/test_gcs_http.py`` and
``tests/test_hdfs_azure.py`` has a counterpart here, as do the verified
read and REST retry cases of ``tests/test_resilience.py``; besides, the
two packages sign alike at a fixed date, their input splits read equal
records per partition from each store, a 404 is never retried while a
503 or a torn connection is, and an http:// shard is read as its literal
path."""

import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from dmlc_tpu.io import input_split as jax_split
from dmlc_tpu.io import recordio as jax_recordio
from dmlc_tpu.io import s3_filesys as jax_s3
from dmlc_tpu.io import azure_filesys as jax_azure
from dmlc_tpu.io.filesys import FileSystem as JaxFileSystem
from dmlc_tpu.io.stream import Stream as JaxStream
from dmlc_tpu_torch import telemetry
from dmlc_tpu_torch.base import DMLCError
from dmlc_tpu_torch.io import (azure_filesys, gcs_filesys, hdfs_filesys,
                               http_filesys, input_split, s3_filesys)
from dmlc_tpu_torch.io.filesys import FileSystem, UnsupportedListing
from dmlc_tpu_torch.io.recordio import RecordIOWriter
from dmlc_tpu_torch.io.stream import Stream
from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.resilience import (default_retryable, install_injector,
                                       reset_injector)
from tests.test_gcs_http import _FakeGCS
from tests.test_hdfs_azure import _FakeAzure, _FakeNameNode
from tests.test_s3 import _FakeS3


def _drop_instances():
    """Both packages' cached remote FileSystems (WebHDFS keeps its
    endpoint from construction)."""
    for fs in (FileSystem, JaxFileSystem):
        for key in [k for k in fs._instances if k != "file://"]:
            del fs._instances[key]


def _serve(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DMLC_FAULT_SPEC", raising=False)
    monkeypatch.setenv("DMLC_RETRY_MAX_S", "0.01")
    reset_injector()
    _drop_instances()
    yield
    reset_injector()
    _drop_instances()


def _stop(srv):
    srv.shutdown()
    srv.server_close()


@pytest.fixture
def s3(monkeypatch):
    _FakeS3.store.clear()
    _FakeS3.uploads.clear()
    del _FakeS3.aborted[:]
    _FakeS3.fail_next_part[0] = _FakeS3.fail_next_init[0] = False
    srv = _serve(_FakeS3)
    monkeypatch.setenv("DMLC_S3_ENDPOINT", f"127.0.0.1:{srv.server_port}")
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIATEST")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test-secret-key")
    monkeypatch.setenv("AWS_REGION", "us-test-1")
    monkeypatch.delenv("AWS_SESSION_TOKEN", raising=False)
    yield srv
    _stop(srv)
    _FakeS3.store.clear()


@pytest.fixture
def gcs(monkeypatch):
    _FakeGCS.store.clear()
    _FakeGCS.sessions.clear()
    _FakeGCS.fail_each_put = False
    _FakeGCS._failed_once.clear()
    srv = _serve(_FakeGCS)
    monkeypatch.setenv("STORAGE_EMULATOR_HOST", f"127.0.0.1:{srv.server_port}")
    monkeypatch.setenv("DMLC_GCS_RETRY_BASE_S", "0.01")
    monkeypatch.delenv("GCS_OAUTH_TOKEN", raising=False)
    yield srv
    _stop(srv)
    _FakeGCS.store.clear()


@pytest.fixture
def hdfs(monkeypatch):
    _FakeNameNode.store.clear()
    _FakeNameNode.fail_next_append[0] = False
    srv = _serve(_FakeNameNode)
    monkeypatch.setenv("DMLC_WEBHDFS_ENDPOINT", f"127.0.0.1:{srv.server_port}")
    yield srv
    _stop(srv)
    _FakeNameNode.store.clear()


@pytest.fixture
def azure(monkeypatch):
    _FakeAzure.store.clear()
    _FakeAzure.blocks.clear()
    _FakeAzure.fail_next_block[0] = False
    srv = _serve(_FakeAzure)
    monkeypatch.setenv("DMLC_AZURE_ENDPOINT", f"127.0.0.1:{srv.server_port}")
    monkeypatch.setenv("AZURE_STORAGE_ACCOUNT", "testacct")
    monkeypatch.setenv("AZURE_STORAGE_ACCESS_KEY",
                       "c2VjcmV0LWtleS1mb3ItdGVzdHM=")
    monkeypatch.delenv("AZURE_STORAGE_SAS_TOKEN", raising=False)
    yield srv
    _stop(srv)
    _FakeAzure.store.clear()
    _FakeAzure.blocks.clear()


def _payload(seed, n):
    return bytes(np.random.default_rng(seed).integers(0, 256, n,
                                                      dtype=np.uint8))


def _small_parts(monkeypatch):
    """1 MiB S3 parts (the writer's floor is S3's 5 MiB)."""
    orig = s3_filesys.S3WriteStream.__init__

    def patched(self, url):
        orig(self, url)
        self._part = 1 << 20

    monkeypatch.setattr(s3_filesys.S3WriteStream, "__init__", patched)


def _port_lines(uri, nparts=3):
    got = []
    for part in range(nparts):
        sp = input_split.create(uri, part, nparts, "text")
        got += [bytes(r).decode() for r in sp]
        sp.close()
    return got


# ---------------------------------------------------------------------------
# S3 (tests/test_s3.py)
# ---------------------------------------------------------------------------

def test_s3_write_read_roundtrip(s3):
    payload = _payload(4, 180_000)
    with Stream.create("s3://bkt/dir/obj.bin", "w") as s:
        s.write(payload[:90_000])
        s.write(payload[90_000:])
    strm = Stream.create_for_read("s3://bkt/dir/obj.bin")
    assert strm.read(len(payload) + 1) == payload
    strm.seek(123_000)
    assert strm.read(64) == payload[123_000:123_064]
    # the JAX package reads what the port wrote
    assert JaxStream.create_for_read("s3://bkt/dir/obj.bin").read(
        len(payload) + 1) == payload


def test_s3_multipart_upload(s3, monkeypatch):
    payload = _payload(5, 2_750_000)
    _small_parts(monkeypatch)
    s = Stream.create("s3://bkt/big/model.bin", "w")
    for lo in range(0, len(payload), 600_000):
        s.write(payload[lo: lo + 600_000])
    fs = FileSystem.get_instance(URI("s3://bkt/big"))
    with pytest.raises(FileNotFoundError):
        fs.get_path_info(URI("s3://bkt/big/model.bin"))
    assert len(next(iter(_FakeS3.uploads.values()))["parts"]) == 2
    s.close()
    assert Stream.create_for_read("s3://bkt/big/model.bin").read(
        len(payload) + 1) == payload
    assert not _FakeS3.uploads   # the commit consumed the session


def test_s3_failed_upload_is_aborted(s3, monkeypatch):
    _small_parts(monkeypatch)
    monkeypatch.setenv("DMLC_S3_RETRIES", "1")
    s = Stream.create("s3://bkt/fail/x.bin", "w")
    s.write(b"a" * (1 << 20))
    _FakeS3.fail_next_part[0] = True
    with pytest.raises(DMLCError):
        s.write(b"b" * (1 << 20))
    s.close()   # poisoned: publishes nothing, raises nothing
    assert _FakeS3.aborted and not _FakeS3.uploads
    with pytest.raises(FileNotFoundError):
        FileSystem.get_instance(URI("s3://bkt/fail")).get_path_info(
            URI("s3://bkt/fail/x.bin"))


def test_s3_failed_init_poisons_stream(s3, monkeypatch):
    _small_parts(monkeypatch)
    monkeypatch.setenv("DMLC_S3_RETRIES", "1")
    _FakeS3.fail_next_init[0] = True
    s = Stream.create("s3://bkt/noinit/x.bin", "w")
    with pytest.raises(DMLCError):
        s.write(b"c" * (1 << 20))
    s.close()   # must not PUT the partial buffer as a whole object
    with pytest.raises(FileNotFoundError):
        FileSystem.get_instance(URI("s3://bkt/noinit")).get_path_info(
            URI("s3://bkt/noinit/x.bin"))


def test_s3_signature_rejected_without_key(s3, monkeypatch):
    with Stream.create("s3://bkt/sec/y.bin", "w") as s:
        s.write(b"payload")
    monkeypatch.delenv("AWS_SECRET_ACCESS_KEY")
    with pytest.raises(DMLCError, match="403"):
        Stream.create_for_read("s3://bkt/sec/y.bin").read(7)


def test_s3_stat_and_list(s3):
    for name, data in [("d/a.bin", b"xx"), ("d/b.bin", b"yyy"),
                       ("d/sub/c.bin", b"z")]:
        with Stream.create(f"s3://bkt/{name}", "w") as s:
            s.write(data)
    fs = FileSystem.get_instance(URI("s3://bkt/d"))
    names = {e.path.name: (e.type, e.size)
             for e in fs.list_directory(URI("s3://bkt/d"))}
    assert names == {"/d/a.bin": ("file", 2), "/d/b.bin": ("file", 3),
                     "/d/sub": ("directory", 0)}
    assert sum(e.size for e in fs.list_directory_recursive(
        URI("s3://bkt/d"))) == 6
    assert fs.get_path_info(URI("s3://bkt/d/a.bin")).size == 2
    assert fs.get_path_info(URI("s3://bkt/d")).type == "directory"
    with pytest.raises(FileNotFoundError):
        fs.get_path_info(URI("s3://bkt/nope"))


def test_inputsplit_over_s3(s3):
    lines = [f"s3-{i}" for i in range(140)]
    with Stream.create("s3://bkt/ds/t.txt", "w") as s:
        s.write(("\n".join(lines) + "\n").encode())
    assert sorted(_port_lines("s3://bkt/ds/t.txt")) == sorted(lines)


SIGN_URLS = ["http://127.0.0.1:9000/bkt/dir/obj.bin",
             "http://127.0.0.1:9000/bkt/a%20b/c%2Bd.bin?partNumber=3"
             "&uploadId=up-1",
             "http://127.0.0.1:9000/bkt?list-type=2&prefix=d%2F&delimiter=%2F",
             "https://bkt.s3.us-test-1.amazonaws.com/k?uploads="]


@pytest.mark.parametrize("token", [None, "session-token"])
@pytest.mark.parametrize("url", SIGN_URLS)
def test_s3_sign_request_equals_reference(monkeypatch, url, token):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIATEST")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test-secret-key")
    monkeypatch.setenv("AWS_REGION", "us-test-1")
    if token:
        monkeypatch.setenv("AWS_SESSION_TOKEN", token)
    else:
        monkeypatch.delenv("AWS_SESSION_TOKEN", raising=False)
    hdrs = {"x-amz-date": "20261018T120000Z", "Range": "bytes=0-99",
            "Content-Type": "application/octet-stream"}
    for method, digest in (("GET", s3_filesys._EMPTY_SHA256),
                           ("PUT", "ab" * 32)):
        got = s3_filesys.sign_request(method, url, hdrs, digest)
        assert got == jax_s3.sign_request(method, url, hdrs, digest)
        assert got["Authorization"].startswith("AWS4-HMAC-SHA256 ")


# ---------------------------------------------------------------------------
# GCS and HTTP (tests/test_gcs_http.py)
# ---------------------------------------------------------------------------

def test_gcs_write_read_roundtrip(gcs, monkeypatch):
    payload = _payload(0, 300_000)
    monkeypatch.setenv("DMLC_GCS_WRITE_BUFFER_MB", "1")
    with Stream.create("gs://bkt/dir/blob.bin", "w") as s:
        for lo in range(0, len(payload), 70_000):
            s.write(payload[lo: lo + 70_000])
    strm = Stream.create_for_read("gs://bkt/dir/blob.bin")
    assert strm.read(len(payload) + 10) == payload
    strm.seek(100_000)
    assert strm.read(16) == payload[100_000:100_016]


def test_gcs_stat_and_list(gcs):
    with Stream.create("gs://bkt/dir/a.txt", "w") as s:
        s.write(b"hello")
    with Stream.create("gs://bkt/dir/sub/b.txt", "w") as s:
        s.write(b"world!")
    fs = FileSystem.get_instance(URI("gs://bkt/dir"))
    assert fs.get_path_info(URI("gs://bkt/dir/a.txt")).size == 5
    names = {e.path.name.lstrip("/"): e.type
             for e in fs.list_directory(URI("gs://bkt/dir"))}
    assert names == {"dir/a.txt": "file", "dir/sub": "directory"}
    assert sum(e.size for e in fs.list_directory_recursive(
        URI("gs://bkt/dir"))) == 11
    assert fs.get_path_info(URI("gs://bkt/dir")).type == "directory"
    with pytest.raises(FileNotFoundError):
        fs.get_path_info(URI("gs://bkt/absent"))


def test_inputsplit_over_gcs(gcs):
    lines = [f"{i} line-{i}" for i in range(200)]
    with Stream.create("gs://bkt/data/part.txt", "w") as s:
        s.write(("\n".join(lines) + "\n").encode())
    assert sorted(_port_lines("gs://bkt/data/part.txt")) == sorted(lines)


def test_inputsplit_over_gcs_directory(gcs):
    lines = []
    for f in range(3):
        chunk = [f"f{f}-{i}" for i in range(40)]
        lines += chunk
        with Stream.create(f"gs://bkt/shards/f{f}.txt", "w") as s:
            s.write(("\n".join(chunk) + "\n").encode())
    assert sorted(_port_lines("gs://bkt/shards", 2)) == sorted(lines)


def _media_url(srv, name):
    return (f"http://127.0.0.1:{srv.server_port}/download/storage/v1/b/bkt/"
            f"o/{name}?alt=media")


def test_http_read_stream(gcs):
    with Stream.create("gs://bkt/raw.bin", "w") as s:
        s.write(b"0123456789" * 1000)
    strm = Stream.create_for_read(_media_url(gcs, "raw.bin"))
    assert strm.read(10) == b"0123456789"
    strm.seek(9995)
    assert strm.read(100) == b"56789"
    fs = FileSystem.get_instance(URI(_media_url(gcs, "raw.bin")))
    assert fs.get_path_info(URI(_media_url(gcs, "raw.bin"))).size == 10_000
    with pytest.raises(UnsupportedListing):
        fs.list_directory(URI(_media_url(gcs, "raw.bin")))
    with pytest.raises(DMLCError, match="read-only"):
        Stream.create(_media_url(gcs, "raw.bin"), "w")


def test_gcs_write_retries_through_injected_500s(gcs, monkeypatch):
    payload = _payload(7, 5 * 70_000)
    monkeypatch.setenv("DMLC_GCS_WRITE_BUFFER_MB", "1")
    _FakeGCS.fail_each_put = True
    try:
        with Stream.create("gs://bkt/faulty/blob.bin", "w") as s:
            for lo in range(0, len(payload), 70_000):
                s.write(payload[lo: lo + 70_000])
    finally:
        _FakeGCS.fail_each_put = False
    assert _FakeGCS.store[("bkt", "faulty/blob.bin")] == payload
    assert _FakeGCS._failed_once   # the emulator did fail PUTs


def test_gcs_abort_deletes_session_and_commits_nothing(gcs):
    s = gcs_filesys.GCSWriteStream("bkt", "aborted/blob.bin")
    s.write(b"partial data that must never become visible")
    before = len(_FakeGCS.sessions)
    s.abort()
    assert ("bkt", "aborted/blob.bin") not in _FakeGCS.store
    assert len(_FakeGCS.sessions) == before - 1
    s.close()   # a no-op after abort, not a commit
    assert ("bkt", "aborted/blob.bin") not in _FakeGCS.store


def test_gcs_exception_in_with_block_aborts(gcs):
    with pytest.raises(RuntimeError):
        with Stream.create("gs://bkt/ctx/blob.bin", "w") as s:
            s.write(b"doomed bytes")
            raise RuntimeError("simulated trainer crash")
    assert ("bkt", "ctx/blob.bin") not in _FakeGCS.store


def test_gcs_read_api_retries_transient_500(gcs, monkeypatch):
    with Stream.create("gs://bkt/retry/read.bin", "w") as s:
        s.write(b"abcdef")
    real = urllib.request.urlopen
    state = {"failed": False}

    def flaky(req, timeout=None):
        if not state["failed"] and "retry%2Fread.bin" in req.full_url:
            state["failed"] = True
            raise urllib.error.HTTPError(req.full_url, 503, "flaky", {}, None)
        return real(req, timeout=timeout)

    monkeypatch.setattr(urllib.request, "urlopen", flaky)
    info = FileSystem.get_instance(URI("gs://bkt")).get_path_info(
        URI("gs://bkt/retry/read.bin"))
    assert state["failed"] and info.size == 6


def test_gcs_token_headers_resolve_per_request(gcs, monkeypatch):
    """A token provider is asked on every ranged fill: a token can
    refresh mid-stream."""
    with Stream.create("gs://bkt/tok.bin", "w") as s:
        s.write(b"x" * (3 << 20))
    asked = []
    gcs_filesys.set_token_provider(lambda: asked.append(1) or "tok")
    try:
        strm = Stream.create_for_read("gs://bkt/tok.bin")
        for _ in range(3):
            assert len(strm.read(1 << 20)) == 1 << 20
    finally:
        gcs_filesys.set_token_provider(None)
    assert len(asked) >= 4   # the HEAD and three 1 MiB fills
    monkeypatch.setenv("GCS_OAUTH_TOKEN", "env-token")
    assert gcs_filesys._auth_headers() == {
        "Authorization": "Bearer env-token"}


# ---------------------------------------------------------------------------
# WebHDFS (tests/test_hdfs_azure.py)
# ---------------------------------------------------------------------------

def test_hdfs_write_read_roundtrip(hdfs, monkeypatch):
    payload = _payload(1, 200_000)
    monkeypatch.setenv("DMLC_HDFS_WRITE_BUFFER_MB", "1")
    with Stream.create("hdfs://nn/data/blob.bin", "w") as s:
        for lo in range(0, len(payload), 60_000):
            s.write(payload[lo: lo + 60_000])
    strm = Stream.create_for_read("hdfs://nn/data/blob.bin")
    assert strm.read(len(payload) + 1) == payload
    strm.seek(123_456)
    assert strm.read(16) == payload[123_456:123_472]


def test_hdfs_write_is_invisible_until_close(hdfs, monkeypatch):
    fs = FileSystem.get_instance(URI("hdfs://nn/torn"))
    monkeypatch.setenv("DMLC_HDFS_WRITE_BUFFER_MB", "1")
    s = Stream.create("hdfs://nn/torn/out.bin", "w")
    s.write(b"x" * (2 << 20))   # a CREATE flush mid-write
    with pytest.raises(FileNotFoundError):
        fs.get_path_info(URI("hdfs://nn/torn/out.bin"))
    s.close()
    assert fs.get_path_info(URI("hdfs://nn/torn/out.bin")).size == 2 << 20
    assert [e.path.name for e in fs.list_directory(
        URI("hdfs://nn/torn"))] == ["/torn/out.bin"]


def test_hdfs_failed_flush_poisons_stream(hdfs, monkeypatch):
    monkeypatch.setenv("DMLC_HDFS_WRITE_BUFFER_MB", "1")
    s = Stream.create("hdfs://nn/poison/f.bin", "w")
    s.write(b"a" * (1 << 20))
    _FakeNameNode.fail_next_append[0] = True
    with pytest.raises(DMLCError):
        s.write(b"b" * (1 << 20))
    s.close()   # publishes nothing, raises nothing
    with pytest.raises(FileNotFoundError):
        FileSystem.get_instance(URI("hdfs://nn/poison")).get_path_info(
            URI("hdfs://nn/poison/f.bin"))
    assert not [p for p in _FakeNameNode.store if ".tmp." in p]


def test_hdfs_overwrite_existing_destination(hdfs):
    for payload in (b"first version", b"second, longer version!"):
        with Stream.create("hdfs://nn/ow/f.bin", "w") as s:
            s.write(payload)
        assert Stream.create_for_read("hdfs://nn/ow/f.bin").read(100) \
            == payload
    assert sorted(_FakeNameNode.store) == ["/ow/f.bin"]   # no backup left


def test_hdfs_stat_and_list(hdfs):
    with Stream.create("hdfs://nn/dir/a.txt", "w") as s:
        s.write(b"hello")
    with Stream.create("hdfs://nn/dir/sub/b.txt", "w") as s:
        s.write(b"world!")
    fs = FileSystem.get_instance(URI("hdfs://nn/dir"))
    assert fs.get_path_info(URI("hdfs://nn/dir/a.txt")).size == 5
    assert fs.get_path_info(URI("hdfs://nn/dir")).type == "directory"
    names = {e.path.name: e.type
             for e in fs.list_directory(URI("hdfs://nn/dir"))}
    assert names == {"/dir/a.txt": "file", "/dir/sub": "directory"}
    assert sum(e.size for e in fs.list_directory_recursive(
        URI("hdfs://nn/dir"))) == 11
    with pytest.raises(FileNotFoundError):
        fs.get_path_info(URI("hdfs://nn/absent"))


def test_inputsplit_over_hdfs(hdfs):
    lines = [f"{i} row-{i}" for i in range(150)]
    with Stream.create("hdfs://nn/ds/part.txt", "w") as s:
        s.write(("\n".join(lines) + "\n").encode())
    assert sorted(_port_lines("hdfs://nn/ds/part.txt")) == sorted(lines)


def test_inputsplit_directory_skips_hidden_files(hdfs):
    lines = [f"r{i}" for i in range(40)]
    with Stream.create("hdfs://nn/hid/part-0.txt", "w") as s:
        s.write(("\n".join(lines) + "\n").encode())
    _FakeNameNode.store["/hid/.part-1.txt.tmp.999.1"] = \
        bytearray(b"torn partial\n")
    _FakeNameNode.store["/hid/_SUCCESS"] = bytearray(b"marker\n")
    assert sorted(_port_lines("hdfs://nn/hid", 1)) == sorted(lines)


def test_hdfs_endpoint_from_the_uri(monkeypatch):
    monkeypatch.delenv("DMLC_WEBHDFS_ENDPOINT", raising=False)
    monkeypatch.setenv("DMLC_WEBHDFS_PORT", "50070")
    assert hdfs_filesys._endpoint(URI("hdfs://nn.example:8020/x")) == \
        "http://nn.example:50070"
    monkeypatch.setenv("DMLC_HDFS_USER", "trainer")
    assert "user.name=trainer" in hdfs_filesys._op_url(
        "http://h:1", "/a b", "OPEN")


# ---------------------------------------------------------------------------
# Azure (tests/test_hdfs_azure.py)
# ---------------------------------------------------------------------------

def test_azure_failed_block_poisons_stream(azure, monkeypatch):
    monkeypatch.setenv("DMLC_AZURE_BLOCK_MB", "1")
    monkeypatch.setenv("DMLC_AZURE_RETRIES", "1")
    s = Stream.create("azure://cont/poison/b.bin", "w")
    s.write(b"a" * (1 << 20))
    _FakeAzure.fail_next_block[0] = True
    with pytest.raises(DMLCError):
        s.write(b"b" * (1 << 20))
    s.close()   # commits no block list with a hole
    with pytest.raises(FileNotFoundError):
        FileSystem.get_instance(URI("azure://cont/poison")).get_path_info(
            URI("azure://cont/poison/b.bin"))


def test_azure_write_read_roundtrip(azure):
    payload = _payload(2, 150_000)
    with Stream.create("azure://cont/dir/blob.bin", "w") as s:
        s.write(payload[:70_000])
        s.write(payload[70_000:])
    strm = Stream.create_for_read("azure://cont/dir/blob.bin")
    assert strm.read(len(payload) + 1) == payload
    strm.seek(99_000)
    assert strm.read(32) == payload[99_000:99_032]


def test_azure_block_upload_large_object(azure, monkeypatch):
    payload = _payload(3, 2_500_000)
    monkeypatch.setenv("DMLC_AZURE_BLOCK_MB", "1")
    s = Stream.create("azure://cont/big/blob.bin", "w")
    for lo in range(0, len(payload), 700_000):
        s.write(payload[lo: lo + 700_000])
    with pytest.raises(FileNotFoundError):
        FileSystem.get_instance(URI("azure://cont/big")).get_path_info(
            URI("azure://cont/big/blob.bin"))
    s.close()
    assert Stream.create_for_read("azure://cont/big/blob.bin").read(
        len(payload) + 1) == payload
    assert not _FakeAzure.blocks


def test_azure_signature_rejected_without_key(azure, monkeypatch):
    with Stream.create("azure://cont/x.bin", "w") as s:
        s.write(b"data")
    monkeypatch.delenv("AZURE_STORAGE_ACCESS_KEY")
    with pytest.raises(DMLCError, match="403"):
        Stream.create_for_read("azure://cont/x.bin").read(4)


def test_azure_list_directory(azure):
    for name, data in [("d/a.bin", b"xx"), ("d/b.bin", b"yyy"),
                       ("d/sub/c.bin", b"z")]:
        with Stream.create(f"azure://cont/{name}", "w") as s:
            s.write(data)
    fs = FileSystem.get_instance(URI("azure://cont/d"))
    names = {e.path.name: (e.type, e.size)
             for e in fs.list_directory(URI("azure://cont/d"))}
    assert names == {"/d/a.bin": ("file", 2), "/d/b.bin": ("file", 3),
                     "/d/sub": ("directory", 0)}
    assert sum(e.size for e in fs.list_directory_recursive(
        URI("azure://cont/d"))) == 6
    assert fs.get_path_info(URI("azure://cont/d/a.bin")).size == 2
    assert fs.get_path_info(URI("azure://cont/d")).type == "directory"
    with pytest.raises(FileNotFoundError):
        fs.get_path_info(URI("azure://cont/nope"))


def test_inputsplit_over_azure(azure):
    lines = [f"az-{i}" for i in range(120)]
    with Stream.create("azure://cont/ds/t.txt", "w") as s:
        s.write(("\n".join(lines) + "\n").encode())
    assert sorted(_port_lines("azure://cont/ds/t.txt", 2)) == sorted(lines)


@pytest.mark.parametrize("url", [
    "http://127.0.0.1:10000/cont/dir/blob.bin",
    "http://127.0.0.1:10000/cont?restype=container&comp=list&prefix="
    "&delimiter=%2F",
    "http://127.0.0.1:10000/cont/a%20b.bin?comp=block&blockid=QUJD"])
def test_azure_sign_request_equals_reference(monkeypatch, url):
    monkeypatch.setenv("AZURE_STORAGE_ACCOUNT", "testacct")
    monkeypatch.setenv("AZURE_STORAGE_ACCESS_KEY",
                       "c2VjcmV0LWtleS1mb3ItdGVzdHM=")
    monkeypatch.delenv("AZURE_STORAGE_SAS_TOKEN", raising=False)
    hdrs = {"x-ms-date": "Sun, 18 Oct 2026 12:00:00 GMT",
            "Range": "bytes=0-9", "Content-Type": "application/xml"}
    for method, n in (("GET", 0), ("PUT", 4096)):
        got = azure_filesys.sign_request(method, url, hdrs, n)
        assert got == jax_azure.sign_request(method, url, hdrs, n)
        assert got["Authorization"].startswith("SharedKey testacct:")
    monkeypatch.setenv("AZURE_STORAGE_SAS_TOKEN", "?sv=1&sig=x")
    assert "Authorization" not in azure_filesys.sign_request("GET", url,
                                                             hdrs)
    assert azure_filesys._with_sas(url).endswith("sv=1&sig=x")


# ---------------------------------------------------------------------------
# REST retries and verified reads (tests/test_resilience.py)
# ---------------------------------------------------------------------------

def test_rest_request_retries_injected_faults(monkeypatch):
    from dmlc_tpu_torch.io import rest

    class FakeResp:
        status = 200

    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda req, timeout=None: FakeResp())
    monkeypatch.setenv("DMLC_FAULT_SPEC", "svc.request=error::2")
    telemetry.reset()
    resp = rest.rest_request("SVC", "http://x/y", "GET",
                             retries_env="DMLC_TEST_RETRIES")
    assert resp.status == 200
    counters = telemetry.counters_snapshot()["resilience"]
    assert counters["retries_svc"] == 2
    assert counters["faults_injected"] == 2


def test_rest_request_gives_up_on_permanent(monkeypatch):
    from dmlc_tpu_torch.io import rest

    calls = []

    def deny(req, timeout=None):
        calls.append(1)
        raise urllib.error.HTTPError(req.full_url, 403, "denied", {}, None)

    monkeypatch.setattr(urllib.request, "urlopen", deny)
    with pytest.raises(DMLCError) as ei:
        rest.rest_request("SVC", "http://x/y", "GET")
    assert ei.value.status == 403
    assert len(calls) == 1


class _Fixed(http_filesys.HttpReadStream):
    """A read stream over bytes in memory: ``fill`` makes each fill."""

    def __init__(self, size, fill):
        self._fill_fn = fill
        super().__init__("http://x", size=size)

    def _fill(self, start, size):
        return self._fill_fn(start, min(size, self._size - start))


def test_storage_response_corruption_hits_reads():
    payload = b"A" * 64
    assert _Fixed(64, lambda a, n: payload[a:a + n]).read(64) == payload
    install_injector("storage.response=corrupt")
    assert _Fixed(64, lambda a, n: payload[a:a + n]).read(64) != payload


def test_verified_read_catches_and_heals_injected_corruption(monkeypatch):
    payload = bytes(range(256)) * 4
    monkeypatch.setenv("DMLC_INTEGRITY_VERIFY_READS", "1")
    install_injector("storage.response=corrupt::1")
    before = telemetry.counters_snapshot().get("integrity", {}).get(
        "read_verify_failures", 0)
    out = _Fixed(len(payload), lambda a, n: payload[a:a + n]).read(
        len(payload))
    after = telemetry.counters_snapshot().get("integrity", {}).get(
        "read_verify_failures", 0)
    assert out == payload and after == before + 1


def _jax_fixed(size, fill):
    from dmlc_tpu.io.http_filesys import HttpReadStream as JaxStreamBase

    class Fixed(JaxStreamBase):
        def __init__(self):
            super().__init__("http://x", size=size)

        def _fill(self, start, n):
            return fill(start, min(n, size - start))

    return Fixed()


def _verify_failures(tele):
    return tele.counters_snapshot().get("integrity", {}).get(
        "read_verify_failures", 0)


@pytest.mark.parametrize("spec,healed,fails", [
    # an unselected rule's two firings corrupt both fetches of the first
    # pair alike: the compare passes them, in both packages
    ("storage.response=corrupt::2", False, 0),
    ("storage.response=corrupt::1", True, 1),
])
def test_verified_read_under_a_shared_spec_equals_jax(monkeypatch, spec,
                                                      healed, fails):
    from dmlc_tpu import telemetry as jax_telemetry
    from dmlc_tpu.resilience import install_injector as jax_install
    from dmlc_tpu.resilience import reset_injector as jax_reset

    payload = bytes(range(256)) * 4
    monkeypatch.setenv("DMLC_INTEGRITY_VERIFY_READS", "1")
    out = {}
    for name, tele, install, reset, make in (
            ("port", telemetry, install_injector, reset_injector, _Fixed),
            ("jax", jax_telemetry, jax_install, jax_reset,
             lambda n, f: _jax_fixed(n, f))):
        before = _verify_failures(tele)
        install(spec)
        try:
            got = make(len(payload), lambda a, n: payload[a:a + n]).read(
                len(payload))
        finally:
            reset()
        out[name] = (got, _verify_failures(tele) - before)
    assert out["port"] == out["jax"]
    assert (out["port"][0] == payload) == healed
    assert out["port"][1] == fails


def test_verified_read_rule_on_the_first_fetch_heals_each(monkeypatch):
    """``@fetch:read`` corrupts the first fetch of a pair only: each
    corrupted response is caught by its own compare and healed."""
    payload = bytes(range(256)) * 4
    monkeypatch.setenv("DMLC_INTEGRITY_VERIFY_READS", "1")
    install_injector("storage.response@fetch:read=corrupt::2")
    before = _verify_failures(telemetry)
    got = _Fixed(len(payload), lambda a, n: payload[a:a + n]).read(
        len(payload))
    assert got == payload and _verify_failures(telemetry) - before == 2
    install_injector("storage.response@fetch:confirm=corrupt::1")
    before = _verify_failures(telemetry)
    got = _Fixed(len(payload), lambda a, n: payload[a:a + n]).read(
        len(payload))
    assert got == payload and _verify_failures(telemetry) - before == 1


def test_verified_read_persistent_corruption_raises(monkeypatch):
    monkeypatch.setenv("DMLC_INTEGRITY_VERIFY_READS", "1")
    monkeypatch.setenv("DMLC_INTEGRITY_READ_RETRIES", "3")
    with pytest.raises(DMLCError, match="double-read"):
        _Fixed(64, lambda a, n: os.urandom(n)).read(64)


def test_verification_off_by_default_single_fetch(monkeypatch):
    monkeypatch.delenv("DMLC_INTEGRITY_VERIFY_READS", raising=False)
    calls = []

    def fill(a, n):
        calls.append((a, n))
        return b"A" * n

    assert _Fixed(64, fill).read(64) == b"A" * 64
    assert len(calls) == 1


def _s3_stream_with_parts(monkeypatch, complete, head_len):
    log = []

    class Resp:
        def __init__(self, headers=None,
                     body=b"<x><UploadId>u1</UploadId></x>"):
            self.headers = headers or {}
            self._body = body

        def read(self):
            return self._body

    def fake_request(url, method="GET", data=None, headers=None, ok=()):
        log.append((method, url.split("?")[-1][:20]))
        if "?uploads=" in url:
            return Resp()
        if "partNumber=" in url:
            return Resp(headers={"ETag": f"e{len(log)}"})
        if method == "POST" and "uploadId=" in url:
            return complete()
        if method == "HEAD":
            return Resp(headers={"Content-Length": str(head_len)})
        if method == "DELETE":
            log.append(("ABORT", ""))
            return Resp()
        raise AssertionError(f"unexpected {method} {url}")

    monkeypatch.setattr(s3_filesys, "_request", fake_request)
    s = s3_filesys.S3WriteStream("http://bucket/key")
    s._part = 4
    s.write(b"abcdefgh")   # two parts
    return s, log


def _no_such_upload():
    raise DMLCError("NoSuchUpload", status=404)


def test_s3_complete_404_after_committed_object_is_success(monkeypatch):
    s, log = _s3_stream_with_parts(monkeypatch, _no_such_upload, head_len=8)
    s.close()   # HEAD says the 8 bytes are there
    assert ("ABORT", "") not in log


def test_s3_complete_404_with_missing_object_still_fails(monkeypatch):
    s, log = _s3_stream_with_parts(monkeypatch, _no_such_upload, head_len=3)
    with pytest.raises(DMLCError, match="NoSuchUpload"):
        s.close()
    assert ("ABORT", "") in log


def test_hdfs_overwrite_backs_up_old_version(monkeypatch):
    from urllib.parse import unquote

    ops = []

    class Resp:
        def __init__(self, body):
            self._body = body

        def read(self):
            return self._body

    def fake_request(url, method, data=None, ok=(), retry=False):
        q = dict(p.split("=", 1) for p in url.split("?", 1)[1].split("&")
                 if "=" in p)
        path = unquote(url.split("?")[0].split("/webhdfs/v1", 1)[1])
        ops.append((q["op"], path, unquote(q.get("destination", ""))))
        if q["op"] == "RENAME":
            exists = not any(o == "RENAME" and d.startswith("/d/.f.old")
                             for o, _p, d in ops[:-1])
            ok_ = not (unquote(q["destination"]) == "/d/f" and exists)
            return Resp(json.dumps({"boolean": ok_}).encode())
        return Resp(b"{}")

    monkeypatch.setattr(hdfs_filesys, "_request", fake_request)
    monkeypatch.setattr(hdfs_filesys, "_write_op",
                        lambda url, method, body, ok: None)
    s = hdfs_filesys.WebHdfsWriteStream("http://nn:9870", "/d/f")
    s.write(b"new contents")
    s.close()
    renames = [(p, d) for o, p, d in ops if o == "RENAME"]
    assert renames[0][1] == "/d/f"
    assert renames[1][0] == "/d/f" and renames[1][1].startswith("/d/.f.old")
    assert renames[2][1] == "/d/f" and renames[2][0].startswith("/d/.f.tmp")
    assert any(p.startswith("/d/.f.old") for o, p, _d in ops
               if o == "DELETE")


# ---------------------------------------------------------------------------
# the repairs: DMLCError's status/transient, UnsupportedListing
# ---------------------------------------------------------------------------

def test_dmlc_error_carries_status_and_transient():
    assert not default_retryable(DMLCError("x", status=404))
    assert default_retryable(DMLCError("x", status=503))
    assert default_retryable(DMLCError("x", transient=True))
    assert not default_retryable(DMLCError("x", status=503, transient=False))
    err = DMLCError("a", "b")
    assert err.args == ("a", "b") and err.status is None \
        and err.transient is None


def _call(backend, url):
    """One request of ``backend``'s own loop at ``url``."""
    if backend == "s3":
        return s3_filesys._request(url)
    if backend == "azure":
        return azure_filesys._request(url)
    if backend == "gcs":
        return gcs_filesys._api(url)
    if backend == "hdfs":
        return hdfs_filesys._request(url, "GET", retry=True)
    return _FixedUrl(url)._fill(0, 4)


class _FixedUrl(http_filesys.HttpReadStream):
    def __init__(self, url):
        super().__init__(url, size=4)


RETRIES_ENV = {"s3": "DMLC_S3_RETRIES", "azure": "DMLC_AZURE_RETRIES",
               "gcs": "DMLC_GCS_RETRIES", "hdfs": "DMLC_HDFS_RETRIES",
               "http": "DMLC_HTTP_RETRIES"}


def _failing_urlopen(monkeypatch, fail, times):
    """urlopen raising ``fail(url)`` on the first ``times`` calls, then
    answering 200 with 4 bytes; returns the list of URLs asked."""
    calls = []

    class Resp:
        status = 200
        code = 200
        headers = {"Content-Length": "4"}

        def read(self):
            return b"abcd"

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def fake(req, timeout=None):
        calls.append(req.full_url)
        if len(calls) <= times:
            raise fail(req.full_url)
        return Resp()

    monkeypatch.setattr(urllib.request, "urlopen", fake)
    return calls


@pytest.mark.parametrize("backend", sorted(RETRIES_ENV))
def test_404_is_not_retried(monkeypatch, backend):
    monkeypatch.setenv(RETRIES_ENV[backend], "4")
    calls = _failing_urlopen(
        monkeypatch, lambda u: urllib.error.HTTPError(u, 404, "gone", {},
                                                      None), 10)
    with pytest.raises(DMLCError) as ei:
        _call(backend, "http://127.0.0.1:1/webhdfs/v1/b/k?op=OPEN")
    assert ei.value.status == 404 and not default_retryable(ei.value)
    assert len(calls) == 1


TORN = {"503": lambda u: urllib.error.HTTPError(u, 503, "busy", {}, None),
        "torn": lambda u: urllib.error.URLError(
            ConnectionResetError("connection reset by peer"))}


@pytest.mark.parametrize("kind", sorted(TORN))
@pytest.mark.parametrize("backend", sorted(RETRIES_ENV))
def test_503_and_torn_connection_are_retried(monkeypatch, backend, kind):
    monkeypatch.setenv(RETRIES_ENV[backend], "3")
    url = "http://127.0.0.1:1/webhdfs/v1/b/k?op=OPEN"
    calls = _failing_urlopen(monkeypatch, TORN[kind], 2)
    resp = _call(backend, url)
    assert (resp if backend == "http" else resp.read()) == b"abcd"
    assert len(calls) == 3
    calls = _failing_urlopen(monkeypatch, TORN[kind], 10)
    with pytest.raises(DMLCError) as ei:
        _call(backend, url)
    assert default_retryable(ei.value)
    assert len(calls) == 3   # DMLC_*_RETRIES attempts, then the raise


def test_http_shard_uri_is_read_as_its_literal_path(gcs):
    """An http:// shard cannot be listed; URI expansion takes the path
    as given, and both packages' splits read the same records."""
    lines = [f"web-{i}" for i in range(90)]
    with Stream.create("gs://bkt/web.txt", "w") as s:
        s.write(("\n".join(lines) + "\n").encode())
    url = _media_url(gcs, "web.txt")
    sp = input_split.create(url, 0, 1, "text", threaded=False)
    jsp = jax_split.create(url, 0, 1, "text", threaded=False)
    assert [f.path.str_uri() for f in sp._files] == \
        [f.path.str_uri() for f in jsp._files]
    assert len(sp._files) == 1 and sp._files[0].size > 0
    sp.close()
    jsp.close()
    for nparts in (1, 3):
        for part in range(nparts):
            want = jax_split.create(url, part, nparts, "text")
            got = input_split.create(url, part, nparts, "text")
            assert [bytes(r) for r in got] == [bytes(r) for r in want]
            want.close()
            got.close()


# ---------------------------------------------------------------------------
# both packages' input splits over each store
# ---------------------------------------------------------------------------

STORES = {"s3": "s3://bkt/ds", "gcs": "gs://bkt/ds",
          "azure": "azure://cont/ds", "hdfs": "hdfs://nn/ds"}


def _write_records(base):
    """A RecordIO shard and a text shard under ``base``, through the
    port's writers; the records and the lines."""
    rng = np.random.default_rng(11)
    recs = [bytes(rng.integers(0, 256, int(rng.integers(1, 900)),
                               dtype=np.uint8)) for _ in range(300)]
    with Stream.create(f"{base}/r.rec", "w") as s:
        w = RecordIOWriter(s)
        for r in recs:
            w.write_record(r)
    lines = [f"{i},{'x' * int(rng.integers(0, 60))}" for i in range(400)]
    with Stream.create(f"{base}/t.txt", "w") as s:
        s.write(("\n".join(lines) + "\n").encode())
    return recs, lines


@pytest.mark.parametrize("store", sorted(STORES))
def test_split_records_per_partition_equal_jax(request, store):
    request.getfixturevalue(store)
    base = STORES[store]
    recs, lines = _write_records(base)
    # the JAX package's reader reads the port's shard record for record
    strm = JaxStream.create_for_read(f"{base}/r.rec")
    assert [bytes(r) for r in jax_recordio.RecordIOReader(strm)] == recs
    for uri, fmt in ((f"{base}/r.rec", "recordio"),
                     (f"{base}/t.txt", "text"), (base, "text")):
        for nparts in (1, 3):
            got_all = []
            for part in range(nparts):
                want = jax_split.create(uri, part, nparts, fmt)
                got = input_split.create(uri, part, nparts, fmt)
                got_recs = [bytes(r) for r in got]
                assert got_recs == [bytes(r) for r in want], (uri, part)
                got_all += got_recs
                want.close()
                got.close()
            if fmt == "recordio":
                assert got_all == recs
            elif uri.endswith(".txt"):
                assert [r.decode() for r in got_all] == lines
