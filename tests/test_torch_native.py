"""The port's host C++ core (its ``native`` module) against the JAX
package's on the same seeded inputs, byte for byte:
the RecordIO scan on every corruption shape, the strict scan, the
last-head search, the packs and the span gather, and the three text
parsers at 1, 2 and 7 threads.  The port's plain versions (``feed.spans``)
against the JAX package's Python walkers, the integrity policy routed the
same way on both packages, and the native build's failure modes."""

import ctypes
import struct

import numpy as np
import pytest

import dmlc_tpu.native as jax_native
from dmlc_tpu.feed.device_feed import _chunk_spans as jax_chunk_spans
from dmlc_tpu.feed.device_feed import _py_chunk_spans as jax_py_spans
from dmlc_tpu.io import integrity as jax_integrity
from dmlc_tpu_torch import native
from dmlc_tpu_torch.base import DMLCError
from dmlc_tpu_torch.feed import spans
from dmlc_tpu_torch.io import integrity
from dmlc_tpu_torch.io.recordio import KMAGIC, RecordIOWriter
from dmlc_tpu_torch.io.stream import MemoryBytesStream

MAGIC = struct.pack("<I", KMAGIC)


@pytest.fixture(autouse=True)
def _clean_quarantine():
    integrity.reset_quarantine()
    jax_integrity.reset_quarantine()
    yield
    integrity.reset_quarantine()
    jax_integrity.reset_quarantine()


def _write_records(recs, checksum):
    s = MemoryBytesStream()
    w = RecordIOWriter(s, checksum=checksum)
    for r in recs:
        w.write_record(r)
    return bytearray(s.getvalue())


def _base_records(checksum):
    """Escaped-magic (multi-segment) records, empty ones, random ones."""
    rng = np.random.default_rng(11)
    recs = []
    for i in range(24):
        if i % 7 == 3:
            recs.append(b"P" * (4 * (i % 3)) + MAGIC + b"Q" * (4 + 4 * (i % 2)))
        elif i % 5 == 2:
            recs.append(b"")
        else:
            recs.append(bytes(rng.integers(0, 256, 5 + i * 3,
                                           dtype=np.uint8)))
    return _write_records(recs, checksum)


def _corruption_cases():
    """(name, chunk) for every shape the scanners classify."""
    cases = []
    for ck in (False, True):
        tag = "crc" if ck else "plain"
        clean = _base_records(ck)
        cases.append((f"clean-{tag}", bytes(clean)))
        b = bytearray(clean)
        b[0:4] = b"\xde\xad\xbe\xef"
        cases.append((f"bad-magic-{tag}", bytes(b)))
        cases.append((f"truncated-{tag}", bytes(clean[: len(clean) - 6])))
        cases.append((f"stray-word-{tag}", bytes(clean) + MAGIC))
        b = bytearray(clean)
        lrec = struct.unpack_from("<I", b, 4)[0]
        struct.pack_into("<I", b, 4, (lrec & ((1 << 29) - 1)) | (2 << 29))
        cases.append((f"head-cflag-{tag}", bytes(b)))
    ckbuf = bytes(_base_records(True))
    sp = spans.scan_chunk_plain(memoryview(ckbuf))
    single = next(i for i in range(sp.shape[0])
                  if sp[i, 2] == 2 and sp[i, 1] > 0)
    b = bytearray(ckbuf)
    b[int(sp[single, 0])] ^= 0xFF
    cases.append(("crc-flip-single", bytes(b)))
    multi = next(i for i in range(sp.shape[0]) if sp[i, 2] == 3)
    b = bytearray(ckbuf)
    b[int(sp[multi, 0]) + 12] ^= 0xFF
    cases.append(("crc-flip-multiseg", bytes(b)))
    cases.append(("torn-multiseg", ckbuf[: int(sp[multi, 0]) + 16]))
    return cases


CASES = _corruption_cases()


@pytest.mark.parametrize("name,chunk", CASES, ids=[c[0] for c in CASES])
def test_scan_matches_jax_on_every_shape(name, chunk):
    """Native against the JAX native scanner and the plain walker against
    the JAX Python walker: four identical triple tables."""
    mv = memoryview(chunk)
    got = spans.scan_chunk(mv)
    assert got.dtype == np.uint64
    for want in (jax_native.recordio_spans(mv, KMAGIC, verify=True),
                 jax_py_spans(mv), spans.scan_chunk_plain(mv)):
        assert got.shape == want.shape, name
        assert (got == want).all(), (name, got.tolist(), want.tolist())
    assert (got[:, 2] >= 8).any() == (not name.startswith("clean")), name


@pytest.mark.parametrize("checksum", [False, True])
def test_strict_scan_and_find_last_match_jax(checksum):
    clean = bytes(_base_records(checksum))
    want = jax_native.recordio_spans(clean, KMAGIC, verify=False)
    got = native.recordio_spans(clean, KMAGIC, verify=False)
    assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="invalid RecordIO chunk"):
        native.recordio_spans(clean[:-6], KMAGIC, verify=False)
    for cut in range(0, len(clean) + 1, 4):
        assert native.recordio_find_last(clean[:cut], KMAGIC) == \
            jax_native.recordio_find_last(clean[:cut], KMAGIC), cut


@pytest.mark.parametrize("policy", ["raise", "skip", "quarantine"])
@pytest.mark.parametrize("name,chunk",
                         [c for c in CASES if not c[0].startswith("clean")],
                         ids=[c[0] for c in CASES
                              if not c[0].startswith("clean")])
def test_policy_routing_matches_jax(monkeypatch, policy, name, chunk):
    """The port's ``chunk_spans`` (native scan) and the JAX feed's keep the
    same spans, raise the same way and quarantine the same keys."""
    monkeypatch.setenv("DMLC_INTEGRITY_POLICY", policy)
    src = f"t-{name}"
    if policy == "raise":
        with pytest.raises(integrity.CorruptRecord):
            spans.chunk_spans(memoryview(chunk), source=src, base=0)
        with pytest.raises(jax_integrity.CorruptRecord):
            jax_chunk_spans(memoryview(chunk), source=src, base=0)
        return
    got = spans.chunk_spans(memoryview(chunk), source=src, base=0)
    want = jax_chunk_spans(memoryview(chunk), source=src, base=0)
    assert (got[:, 2] < 8).all()
    assert got.tobytes() == want.tobytes(), name
    assert integrity.quarantined_spans(src) == \
        jax_integrity.quarantined_spans(src)
    assert bool(integrity.quarantined_spans(src)) == (policy == "quarantine")


def test_quarantine_replay_drops_silently(monkeypatch):
    """A crc-corrupt record under quarantine: the first pass reports and
    quarantines it, the replay drops it through the skip-list without a
    second report."""
    from dmlc_tpu_torch import telemetry

    monkeypatch.setenv("DMLC_INTEGRITY_POLICY", "quarantine")
    chunk = dict(CASES)["crc-flip-single"]
    sp1 = spans.chunk_spans(memoryview(chunk), source="replay", base=0)
    assert integrity.quarantined_spans("replay")
    before = telemetry.counters_snapshot().get("integrity", {})
    sp2 = spans.chunk_spans(memoryview(chunk), source="replay", base=0)
    after = telemetry.counters_snapshot().get("integrity", {})
    assert (sp1 == sp2).all()
    assert after.get("skiplist_drops", 0) - before.get("skiplist_drops", 0) \
        >= 1
    assert after.get("corrupt_records", 0) == before.get("corrupt_records", 0)


@pytest.mark.parametrize("max_bytes", [8, 64])
def test_pad_pack_rows_matches_jax_and_plain(max_bytes):
    chunk = bytes(_base_records(True))
    mv = memoryview(chunk)
    sp = spans.chunk_spans(mv)
    g = sp.shape[0]
    outs = []
    for fill, fn in ((7, spans.gather_rows_into),
                     (9, spans.gather_rows_into_plain)):
        rows = np.full((g + 3, max_bytes), fill, np.uint8)
        lens = np.full(g + 3, -1, np.int32)
        fn(mv, sp, 2, g, max_bytes, rows[1:], lens[1:])
        outs.append((rows[1:g - 1].copy(), lens[1:g - 1].copy()))
    rows_j = np.full((g - 2, max_bytes), 5, np.uint8)
    lens_j = np.full(g - 2, -3, np.int32)
    jax_native.pad_pack_rows(mv, sp[2:g], KMAGIC, max_bytes, rows_j, lens_j)
    for rows, lens in outs:
        assert rows.tobytes() == rows_j.tobytes()
        assert lens.tobytes() == lens_j.tobytes()


def _pack_case(rng, n, cap):
    src = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    lens = rng.integers(0, 300, n).astype(np.int64)
    offs = np.array([rng.integers(0, 4096 - ln + 1) for ln in lens],
                    np.int64)
    return src, offs, lens


@pytest.mark.parametrize("dst_pos,slots,allow", [
    (0, 64, True), (100, 64, False), (0, 3, True), (900, 64, True),
    (900, 64, False), (0, 0, True)])
def test_pack_spans_matches_jax_and_plain(dst_pos, slots, allow):
    rng = np.random.default_rng(dst_pos + slots)
    src, offs, lens = _pack_case(rng, 12, 1000)
    lens[0] = 500 if dst_pos == 900 else lens[0]   # overflow at the head
    results = []
    for fn in (native.pack_spans, spans.pack_spans_plain,
               jax_native.pack_spans):
        dst = np.full(1000, 0xAB, np.uint8)
        ends = np.full(64, -1, np.int64)
        res = fn(src, offs, lens, dst, dst_pos, slots, allow, ends)
        results.append((res, dst.tobytes(), ends.tobytes()))
    assert results[0] == results[1] == results[2]


def test_gather_spans_matches_jax():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 256, 1 << 14, dtype=np.uint8)
    lens = rng.integers(0, 200, 50).astype(np.int64)
    offs = np.array([rng.integers(0, src.size - ln) for ln in lens])
    got = native.gather_spans(src, offs, lens)
    assert got.tobytes() == jax_native.gather_spans(src, offs,
                                                    lens).tobytes()
    assert got.tobytes() == b"".join(src[o:o + n].tobytes()
                                     for o, n in zip(offs, lens))
    with pytest.raises(ValueError, match="out of bounds"):
        native.gather_spans(src, np.array([src.size - 2]), np.array([5]))


def _libsvm_text(seed, rows=300, digits=9):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        k = int(rng.integers(0, 12))
        idx = np.sort(rng.choice(1 << 20, k, replace=False))
        toks = []
        for j in idx:
            v = rng.standard_normal() * 10 ** int(rng.integers(-3, 4))
            toks.append(f"{j}" if rng.random() < 0.1 else f"{j}:{v:.{digits}g}")
        head = f"{int(rng.integers(0, 2))}"
        if i % 50 == 7:
            head += f":{rng.random():.5f}"   # an instance weight
        lines.append(" ".join([head] + toks))
        if i % 97 == 5:
            lines.append("   ")              # a blank line
    return ("\n".join(lines) + "\n").encode()


def _libfm_text(seed, rows=300):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(rows):
        k = int(rng.integers(1, 8))
        toks = [f"{int(rng.integers(0, 40))}:{int(rng.integers(0, 1 << 16))}:"
                f"{rng.standard_normal():.7g}" for _ in range(k)]
        lines.append(" ".join([f"{int(rng.integers(0, 2))}"] + toks))
    return ("\n".join(lines) + "\n").encode()


def _csv_text(seed, rows=300, cols=29):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((rows, cols)) * 3
    vals[:, 0] = rng.integers(0, 2, rows)
    return "".join(",".join(f"{v:.9g}" for v in r) + "\n"
                   for r in vals).encode()


@pytest.mark.parametrize("nthread", [1, 2, 7])
@pytest.mark.parametrize("fmt", ["libsvm", "libfm", "csv"])
def test_parsers_match_jax_native(fmt, nthread):
    """Byte-exact against the JAX native parsers, and the same blocks at
    every thread count."""
    if fmt == "csv":
        data = _csv_text(1)
        got = native.parse_csv(memoryview(data), b",", nthread)
        want = jax_native.parse_csv(data, b",", nthread)
        assert got.shape == want.shape == (300, 29)
        assert got.tobytes() == want.tobytes()
        assert got.tobytes() == native.parse_csv(data, b",", 1).tobytes()
        return
    data = _libsvm_text(2) if fmt == "libsvm" else _libfm_text(2)
    fn = native.parse_libsvm if fmt == "libsvm" else native.parse_libfm
    jfn = jax_native.parse_libsvm if fmt == "libsvm" \
        else jax_native.parse_libfm
    got, want, one = fn(memoryview(data), nthread), jfn(data, nthread), \
        fn(data, 1)
    assert sorted(got) == sorted(want)
    for k in got:
        if want[k] is None:
            assert got[k] is None and one[k] is None, k
            continue
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
        assert got[k].tobytes() == one[k].tobytes(), k


@pytest.mark.parametrize("bad", [b"1 3:x\n", b"abc 1:2\n", b"1 :3\n"])
def test_malformed_text_raises_on_both(bad):
    for fn in (native.parse_libsvm, native.parse_libfm):
        with pytest.raises(ValueError, match="malformed"):
            fn(b"1 1:1:1\n" + bad)
    with pytest.raises(ValueError, match="non-numeric"):
        native.parse_csv(b"1,2\n3,x\n")
    with pytest.raises(ValueError, match="inconsistent"):
        native.parse_csv(b"1,2\n3,4,5\n")
    with pytest.raises(ValueError, match="one-byte"):
        native.parse_csv(b"1 2\n", b" ")


@pytest.mark.parametrize("max_nnz,num_col", [(4, 0), (16, 0), (3, 5000)])
def test_parse_libsvm_into_matches_jax(max_nnz, num_col):
    data = _libsvm_text(4, rows=80)
    outs = []
    for fn in (native.parse_libsvm_into, jax_native.parse_libsvm_into):
        b = 16
        out = {"label": np.full(b, 3, np.float32),
               "value": np.full((b, max_nnz), 3, np.float32),
               "index": np.full((b, max_nnz), 3, np.int32),
               "mask": np.full((b, max_nnz), 3, np.float32)}
        steps, start, r = [], 0, 5
        while start < len(data):
            r, start = fn(data, start, r, max_nnz, num_col, out)
            steps.append((r, start, b"".join(v.tobytes()
                                             for v in out.values())))
            r = 0 if r == b else r
        outs.append(steps)
    assert outs[0] == outs[1]


def test_pad_pack_csr_matches_jax():
    rng = np.random.default_rng(9)
    lens = rng.integers(0, 9, 20)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.uint64)
    nnz = int(offsets[-1])
    index = rng.integers(0, 100, nnz).astype(np.uint32)
    value = rng.standard_normal(nnz).astype(np.float32)
    value[3] = np.nan
    labels = rng.integers(0, 2, 20).astype(np.float32)
    for b, bs, k, ncol in ((20, 24, 4, 0), (12, 16, 9, 50), (0, 4, 3, 7)):
        outs = []
        for fn in (native.pad_pack_csr, jax_native.pad_pack_csr):
            out = {"label": np.full(bs, 7, np.float32),
                   "value": np.full((bs, k), 7, np.float32),
                   "index": np.full((bs, k), 7, np.int32),
                   "mask": np.full((bs, k), 7, np.float32)}
            fn(labels[:b], offsets[:b + 1], index, value, b, bs, k, ncol, out)
            outs.append(b"".join(v.tobytes() for v in out.values()))
        assert outs[0] == outs[1], (b, bs, k, ncol)
    with pytest.raises(ValueError, match="expected"):
        native.pad_pack_csr(labels, offsets, index, value, 4, 4, 3, 0,
                            {"label": np.empty(4, np.float32),
                             "value": np.empty((4, 2), np.float32),
                             "index": np.empty((4, 3), np.int32),
                             "mask": np.empty((4, 3), np.float32)})


def test_library_releases_the_gil_and_builds_both_sources():
    """``ctypes.CDLL`` (not ``PyDLL``) drops the GIL for every call, so
    parses on the feed's parser threads overlap; one library holds both
    sources."""
    lib = native._load()
    assert type(lib) is ctypes.CDLL
    assert native.library_path().name.startswith("dmlc_native-")
    assert native.crc32c(b"123456789") == 0xE3069283


def test_missing_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """With no library and a compiler that fails, the scan raises; the
    feed's span path does not reach for the plain walker."""
    def broken(sources, lib):
        raise DMLCError("g++ failed on dmlc_native.cc (exit 1)")

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setattr(native, "_build", broken)
    monkeypatch.setattr(native, "_lib", None)
    chunk = memoryview(bytes(_base_records(False)))
    with pytest.raises(DMLCError, match="g\\+\\+ failed"):
        spans.chunk_spans(chunk)
    with pytest.raises(DMLCError, match="g\\+\\+ failed"):
        native.parse_libsvm(b"1 2:3\n")
