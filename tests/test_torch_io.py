"""Parity of the port's IO layer with the JAX package on the same bytes:
RecordIO files byte-identical both ways, input-split partitions in the
same order, CRC-32C (native and plain) equal, the corruption policy."""

import struct

import numpy as np
import pytest

from dmlc_tpu.io import input_split as jax_split
from dmlc_tpu.io import integrity as jax_integrity
from dmlc_tpu.io.recordio import RecordIOReader as JaxReader
from dmlc_tpu.io.recordio import RecordIOWriter as JaxWriter
from dmlc_tpu.io.stream import Stream as JaxStream
from dmlc_tpu_torch import native
from dmlc_tpu_torch.io import input_split, integrity
from dmlc_tpu_torch.io.recordio import (KMAGIC, RecordIOChunkReader,
                                        RecordIOReader, RecordIOWriter)
from dmlc_tpu_torch.io.stream import Stream

MAGIC = struct.pack("<I", KMAGIC)


def _records(seed, n=120):
    """Random records, with empty ones and ones holding the magic at
    aligned and unaligned offsets."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 11 == 3:
            out.append(b"A" * (4 * (i % 5)) + MAGIC + b"B" * (4 + i % 9))
        elif i % 13 == 5:
            out.append(b"xy" + MAGIC + b"z" * (i % 7))    # unaligned magic
        elif i % 17 == 6:
            out.append(b"")
        elif i % 19 == 7:
            out.append(MAGIC * 3)
        else:
            out.append(rng.integers(0, 256, int(rng.integers(1, 400)),
                                    dtype=np.uint8).tobytes())
    return out


def _write(writer_cls, stream_cls, path, recs, checksum):
    with stream_cls.create(str(path), "w") as s:
        w = writer_cls(s, checksum=checksum)
        for r in recs:
            w.write_record(r)


@pytest.mark.parametrize("checksum", [False, True])
def test_recordio_files_byte_identical(tmp_path, checksum):
    recs = _records(1)
    _write(JaxWriter, JaxStream, tmp_path / "jax.rec", recs, checksum)
    _write(RecordIOWriter, Stream, tmp_path / "port.rec", recs, checksum)
    assert (tmp_path / "jax.rec").read_bytes() == \
        (tmp_path / "port.rec").read_bytes()


@pytest.mark.parametrize("checksum", [False, True])
def test_each_package_reads_the_others_files(tmp_path, checksum):
    recs = _records(2)
    _write(JaxWriter, JaxStream, tmp_path / "jax.rec", recs, checksum)
    _write(RecordIOWriter, Stream, tmp_path / "port.rec", recs, checksum)
    with Stream.create(str(tmp_path / "jax.rec"), "r") as s:
        assert list(RecordIOReader(s)) == recs
    with JaxStream.create(str(tmp_path / "port.rec"), "r") as s:
        assert list(JaxReader(s)) == recs
    data = (tmp_path / "jax.rec").read_bytes()
    assert [bytes(r) for r in RecordIOChunkReader(data)] == recs


def _split_records(mod, uri, part, n):
    kw = {"threaded": False} if mod is jax_split else {}
    split = mod.create(uri, part, n, "recordio", **kw)
    try:
        return [bytes(r) for r in split]
    finally:
        split.close()


@pytest.mark.parametrize("layout", ["file", "dir"])
@pytest.mark.parametrize("n_parts", [1, 3, 8])
def test_input_split_partitions_match(tmp_path, layout, n_parts):
    recs = _records(3, n=300)
    if layout == "file":
        _write(JaxWriter, JaxStream, tmp_path / "one.rec", recs, False)
        uri = str(tmp_path / "one.rec")
    else:
        d = tmp_path / "shards"
        d.mkdir()
        for i, lo in enumerate((0, 90, 200)):
            hi = (90, 200, 300)[i]
            _write(JaxWriter, JaxStream, d / f"part-{i}.rec", recs[lo:hi],
                   i == 1)
        uri = str(d)
    seen = []
    for p in range(n_parts):
        want = _split_records(jax_split, uri, p, n_parts)
        got = _split_records(input_split, uri, p, n_parts)
        assert got == want, f"partition {p}/{n_parts}"
        seen += got
    assert seen == recs


def test_partition_spans_and_chunks_match(tmp_path):
    recs = _records(4, n=400)
    _write(JaxWriter, JaxStream, tmp_path / "a.rec", recs, True)
    uri = str(tmp_path / "a.rec")
    js = jax_split.create(uri, 0, 1, "recordio", threaded=False)
    ps = input_split.create(uri, 0, 1, "recordio", threaded=False)
    try:
        for n in (1, 2, 5, 16):
            assert ps.partition_spans(n) == js.partition_spans(n)
        js.hint_chunk_size(4096)
        ps.hint_chunk_size(4096)
        while True:
            a, b = js.next_chunk(), ps.next_chunk()
            if a is None or b is None:
                assert a is None and b is None
                break
            assert bytes(a) == bytes(b)
            assert js.last_chunk_begin == ps.last_chunk_begin
    finally:
        js.close()
        ps.close()


def test_crc32c_matches_jax(monkeypatch):
    rng = np.random.default_rng(5)
    sizes = [0, 1, 3, 8, 9, 255, 4096, 24575, 24576, 24577, 73731,
             (1 << 20) - 1, 1 << 20]
    chain_port = chain_ref = 0
    for n in sizes:
        buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = jax_integrity.crc32c(buf)
        assert native.crc32c(buf) == want, n
        assert native.crc32c_table(buf) == want, n
        assert integrity.crc32c(memoryview(buf)) == want, n
        if n <= 4096:
            assert integrity._crc32c_py(buf) == want, n
        chain_port = native.crc32c(buf, chain_port)
        chain_ref = jax_integrity.crc32c(buf, chain_ref)
        assert chain_port == chain_ref
        cut = n // 3
        assert native.crc32c(buf[cut:], native.crc32c(buf[:cut])) == want


def test_native_build_failure_raises(tmp_path, monkeypatch):
    from dmlc_tpu_torch.base import DMLCError

    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    with pytest.raises(DMLCError, match="g\\+\\+ failed"):
        native._build(bad, tmp_path / "broken.so")


def _corrupt_file(tmp_path, checksum=True):
    recs = [bytes([i]) * (20 + i) for i in range(12)]
    path = tmp_path / "c.rec"
    _write(RecordIOWriter, Stream, path, recs, checksum)
    raw = bytearray(path.read_bytes())
    # flip a payload byte of record 5 (header 12 bytes with the crc word)
    off = sum(12 + ((len(r) + 3) & ~3) for r in recs[:5]) + 12 + 3
    raw[off] ^= 0xFF
    path.write_bytes(bytes(raw))
    return str(path), recs


@pytest.mark.parametrize("reader", ["stream", "split", "chunk"])
@pytest.mark.parametrize("policy", ["raise", "skip", "quarantine"])
def test_corruption_policy_matches_jax(tmp_path, monkeypatch, reader,
                                       policy):
    uri, recs = _corrupt_file(tmp_path)
    monkeypatch.setenv("DMLC_INTEGRITY_POLICY", policy)
    integrity.reset_quarantine()
    jax_integrity.reset_quarantine()

    def read(io_mod, split_mod, reader_cls, chunk_cls):
        if reader == "stream":
            with io_mod.create(uri, "r") as s:
                return [bytes(r) for r in reader_cls(s, source=uri)]
        if reader == "chunk":
            with open(uri, "rb") as fh:
                data = fh.read()
            return [bytes(r) for r in chunk_cls(data, source=uri)]
        return _split_records(split_mod, uri, 0, 1)

    from dmlc_tpu.io.recordio import RecordIOChunkReader as JaxChunk

    outcomes = []
    for args in ((JaxStream, jax_split, JaxReader, JaxChunk),
                 (Stream, input_split, RecordIOReader, RecordIOChunkReader)):
        try:
            outcomes.append(read(*args))
        except Exception as e:  # noqa: BLE001 - compared by type name
            outcomes.append(type(e).__name__)
    assert outcomes[0] == outcomes[1]
    if policy == "raise":
        assert outcomes[1] == "CorruptRecord"
    else:
        assert outcomes[1] == recs[:5] + recs[6:]
    if policy == "quarantine":
        assert [s[1:] for s in integrity.quarantined_spans(uri)] == \
            [s[1:] for s in jax_integrity.quarantined_spans(uri)]
    integrity.reset_quarantine()
    jax_integrity.reset_quarantine()


def test_remote_protocols_raise_naming_the_roadmap():
    """The remote protocols, stubs that named the roadmap until the
    remote filesystems were ported, dispatch to their backends; a
    protocol whose backend fails to import raises naming the way to plug
    one in."""
    from dmlc_tpu_torch.base import DMLCError
    from dmlc_tpu_torch.io import filesys
    from dmlc_tpu_torch.io.uri import URI

    for uri, name in (("gs://bucket/x.rec", "GCSFileSystem"),
                      ("s3://b/x", "S3FileSystem"),
                      ("hdfs://nn/x", "WebHDFSFileSystem"),
                      ("azure://c/x", "AzureFileSystem"),
                      ("https://host/x", "HTTPFileSystem")):
        u = URI(uri)
        assert type(filesys.FileSystem.get_instance(u)).__name__ == name
        del filesys.FileSystem._instances[u.protocol + u.host]
    stub = filesys._unsupported_protocol(
        "s3://", "plug in a backend via register_filesystem('s3://', ...)")
    with pytest.raises(DMLCError, match="register_filesystem"):
        stub(URI("s3://b/x"))
