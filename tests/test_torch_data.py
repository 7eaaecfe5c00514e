"""The port's sparse text path against the JAX package's on the same seeded
inputs: the parsers' plain routes bit-exact against the JAX Python routes
and the native routes within 1 ulp of them, the input splits partition by
partition (text at 1/3/8 parts on the mmap and copy paths, indexed
RecordIO with and without shuffle, the shuffled sub-splits, ``#cachefile``
over two epochs with the cache files byte-equal both ways, stdin through a
pipe), ``create_row_iter`` per format with ``DiskRowIter`` caches read
across the packages, ``pack_rowblock`` on both routes, and ``libsvm_feed``
batch by batch against the JAX feed on the 8-device CPU mesh over two
epochs on the fused and classic routes."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import dmlc_tpu.native as jax_native_mod
from dmlc_tpu import data as jax_data
from dmlc_tpu.data import text_parsers as jax_tp
from dmlc_tpu.feed import libsvm_feed as jax_libsvm_feed
from dmlc_tpu.feed.device_feed import pack_rowblock as jax_pack_rowblock
from dmlc_tpu.io import input_split as jax_split
from dmlc_tpu.io import input_split_shuffle as jax_shuffle
from dmlc_tpu.io.stream import MemoryBytesStream as JaxMemStream
from dmlc_tpu.parallel import build_mesh
from dmlc_tpu_torch import common, data, param, registry, serializer
from dmlc_tpu_torch.base import DMLCError, ParamError
from dmlc_tpu_torch.data import text_parsers as tp
from dmlc_tpu_torch.feed import libsvm_feed, pack_rowblock, \
    pack_rowblock_plain
from dmlc_tpu_torch.io import input_split, input_split_shuffle
from dmlc_tpu_torch.io.filesys import register_filesystem
from dmlc_tpu_torch.io.local_filesys import LocalFileSystem
from dmlc_tpu_torch.io.recordio import RecordIOWriter
from dmlc_tpu_torch.io.stream import MemoryBytesStream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PARTS = 8


class _CopyOnlyFileSystem(LocalFileSystem):
    """Local files with no local path: the splits take the copy path."""

    def local_path(self, path):
        return None


COPY = "nommap://"
register_filesystem(COPY, lambda _uri: _CopyOnlyFileSystem())


@pytest.fixture
def jax_python_route(monkeypatch):
    """The JAX package's Python routes, chosen as its own tests choose
    them: the native library switched off for the test."""
    monkeypatch.setenv("DMLC_TPU_DISABLE_NATIVE", "1")
    monkeypatch.setattr(jax_native_mod, "_tried", False)
    monkeypatch.setattr(jax_native_mod, "_lib", None)


def _libsvm_text(seed, rows=400, digits=9, weights=True):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        k = int(rng.integers(0, 14))
        idx = np.sort(rng.choice(1 << 20, k, replace=False))
        toks = []
        for j in idx:
            v = rng.standard_normal() * 10.0 ** int(rng.integers(-3, 4))
            toks.append(f"{j}" if rng.random() < 0.1 else f"{j}:{v:.{digits}g}")
        head = f"{int(rng.integers(0, 2))}"
        if weights and i % 60 == 7:
            head += f":{rng.random():.6f}"
        lines.append(" ".join([head] + toks))
        if i % 97 == 5:
            lines.append("")
    return "\n".join(lines) + "\n"


def _libfm_text(seed, rows=300):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(rows):
        toks = [f"{int(rng.integers(0, 40))}:{int(rng.integers(0, 1 << 16))}:"
                f"{rng.standard_normal() * 100:.9g}"
                for _ in range(int(rng.integers(1, 8)))]
        lines.append(" ".join([f"{int(rng.integers(0, 2))}"] + toks))
    return "\n".join(lines) + "\n"


def _csv_text(seed, rows=300, cols=29, delim=","):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((rows, cols)) * 37.0
    vals[:, 0] = rng.integers(0, 2, rows)
    return "".join(delim.join(f"{v:.10g}" for v in r) + "\n" for r in vals)


TEXTS = {"libsvm": _libsvm_text, "libfm": _libfm_text, "csv": _csv_text}


def _parser_pair(fmt, args=None):
    """(port parser class instance, JAX one), no source attached."""
    if fmt == "csv":
        return (tp.CSVParser(None, dict(args or {"label_column": "0"})),
                jax_tp.CSVParser(None, dict(args or {"label_column": "0"})))
    name = {"libsvm": "LibSVMParser", "libfm": "LibFMParser"}[fmt]
    return getattr(tp, name)(None), getattr(jax_tp, name)(None)


def _block_arrays(c):
    blk = c.get_block()
    out = {"offset": blk.offset, "label": blk.label, "index": blk.index}
    for k in ("value", "weight", "field"):
        out[k] = getattr(blk, k)
    return out


def _assert_blocks_equal(a, b, ulp=0):
    assert sorted(a) == sorted(b)
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
            continue
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if ulp and a[k].dtype == np.float32:
            diff = np.abs(a[k].view(np.int32).astype(np.int64)
                          - b[k].view(np.int32).astype(np.int64))
            assert diff.max(initial=0) <= ulp, (k, diff.max())
        else:
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("fmt", ["libsvm", "libfm", "csv", "csv_tab"])
def test_plain_route_bit_exact_against_jax_python(fmt, jax_python_route):
    args = {"label_column": "0", "delimiter": "\t"} if fmt == "csv_tab" \
        else None
    base = "csv" if fmt.startswith("csv") else fmt
    text = (_csv_text(5, delim="\t") if fmt == "csv_tab"
            else TEXTS[base](5)).encode()
    port, jax = _parser_pair(base, args)
    a, b = data.RowBlockContainer(), jax_data.RowBlockContainer()
    port.parse_chunk_plain(memoryview(text), a)
    jax.parse_chunk(text, b)    # the Python route: native switched off
    _assert_blocks_equal(_block_arrays(a), _block_arrays(b))
    if fmt == "csv_tab":
        # a blank delimiter is beyond the native scanner: parse_chunk
        # takes the plain version
        c = data.RowBlockContainer()
        port.parse_chunk(text, c)
        _assert_blocks_equal(_block_arrays(a), _block_arrays(c))


@pytest.mark.parametrize("fmt", ["libsvm", "libfm", "csv"])
def test_native_route_within_one_ulp_of_plain(fmt):
    """The native number scan is not correctly rounded: it may differ from
    ``float()`` then float32 in the last bit, never more."""
    text = (_libsvm_text(6, weights=False) if fmt == "libsvm"
            else TEXTS[fmt](6)).encode()
    port, _ = _parser_pair(fmt)
    a, b = data.RowBlockContainer(), data.RowBlockContainer()
    port.parse_chunk(text, a)
    port.parse_chunk_plain(text, b)
    _assert_blocks_equal(_block_arrays(a), _block_arrays(b), ulp=1)


def test_partial_weights_differ_between_routes_as_in_jax(jax_python_route):
    """Where only some rows carry ``label:weight``, the native route keeps
    the weights (1.0 for the rows without) and the plain route drops them,
    in both packages alike."""
    text = b"1:0.5 3:1\n0 4:2\n"
    port, jax = _parser_pair("libsvm")
    a, b = data.RowBlockContainer(), data.RowBlockContainer()
    port.parse_chunk(text, a)
    port.parse_chunk_plain(text, b)
    assert a.get_block().weight.tolist() == [0.5, 1.0]
    assert b.get_block().weight is None
    j = jax_data.RowBlockContainer()
    jax.parse_chunk(text, j)    # the JAX Python route
    assert j.get_block().weight is None


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_bytes(text.encode() if isinstance(text, str) else text)
    return str(p)


def _records(split):
    try:
        return [bytes(r) for r in split]
    finally:
        split.close()


@pytest.fixture
def text_dir(tmp_path):
    d = tmp_path / "txt"
    d.mkdir()
    body = _libsvm_text(8, rows=600).replace("\n", "\r\n", 40)
    for i, lo in enumerate((0, 9000, 21000)):
        chunk = body[lo:(9000, 21000, None)[i]]
        (d / f"part-{i}.txt").write_text(chunk)
    (d / "_SUCCESS").write_text("")
    return str(d)


@pytest.mark.parametrize("mmap_path", [True, False])
@pytest.mark.parametrize("n_parts", [1, 3, 8])
def test_line_splitter_partitions_match_jax(text_dir, n_parts, mmap_path):
    uri = text_dir if mmap_path else COPY + text_dir
    seen = []
    for p in range(n_parts):
        want = _records(jax_split.create(text_dir, p, n_parts, "text",
                                         threaded=False))
        got = _records(input_split.create(uri, p, n_parts, "text"))
        assert got == want, (p, n_parts)
        raw = input_split.create(uri, p, n_parts, "text", threaded=False)
        assert raw._mmap_ok is mmap_path
        raw.hint_chunk_size(700)   # many chunks: the overflow carry
        assert _records(raw) == want
        seen += got
    assert len(seen) >= 600


def _rec_file(tmp_path, n=120, seed=4):
    rng = np.random.default_rng(seed)
    recs = [rng.integers(0, 256, int(rng.integers(0, 90)),
                         dtype=np.uint8).tobytes() for _ in range(n)]
    path = str(tmp_path / "d.rec")
    s = MemoryBytesStream()
    w = RecordIOWriter(s)
    offs = []
    for r in recs:
        offs.append(len(s.getvalue()))
        w.write_record(r)
    with open(path, "wb") as f:
        f.write(s.getvalue())
    idx = str(tmp_path / "d.idx")
    with open(idx, "w") as f:
        f.write("".join(f"{i}\t{o}\n" for i, o in enumerate(offs)))
    return path, idx, recs


@pytest.mark.parametrize("mmap_path", [True, False])
@pytest.mark.parametrize("shuffle", [False, True])
def test_indexed_recordio_matches_jax(tmp_path, shuffle, mmap_path):
    path, idx, recs = _rec_file(tmp_path)
    pre = "" if mmap_path else COPY
    seen = []
    for p in range(3):
        kw = dict(type="indexed_recordio", shuffle=shuffle, seed=3,
                  batch_size=7)
        js = jax_split.create(path, p, 3, index_uri=idx, **kw)
        ps = input_split.create(pre + path, p, 3, index_uri=pre + idx, **kw)
        assert ps._mmap_ok is mmap_path
        try:
            for epoch in range(2):
                a = [bytes(r) for r in iter(js.next_record, None)]
                b = [bytes(r) for r in iter(ps.next_record, None)]
                assert a == b, (p, epoch)
                if epoch == 0:
                    seen += b
                js.before_first()
                ps.before_first()
            ca = [bytes(c) for c in iter(js.next_chunk, None)]
            cb = [bytes(c) for c in iter(ps.next_chunk, None)]
            assert ca == cb and ca
        finally:
            js.close()
            ps.close()
    assert sorted(seen) == sorted(recs)


def test_shuffled_sub_splits_match_jax(text_dir):
    for p in range(2):
        a = jax_shuffle.create_shuffled(text_dir, p, 2, "text",
                                        num_shuffle_parts=3, shuffle_seed=5)
        b = input_split_shuffle.create_shuffled(text_dir, p, 2, "text",
                                                num_shuffle_parts=3,
                                                shuffle_seed=5)
        try:
            for _ in range(3):   # a fresh visit order every epoch
                assert [bytes(r) for r in iter(b.next_record, None)] == \
                    [bytes(r) for r in iter(a.next_record, None)]
                a.before_first()
                b.before_first()
        finally:
            a.close()
            b.close()


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_cachefile_epochs_and_files_match_jax(tmp_path, reader):
    """First epoch through the base split, second from the cache; the two
    packages write the same cache bytes, and each replays the other's."""
    src = _write(tmp_path, "a.txt", _libsvm_text(9, rows=500))
    runs = {}
    for who, mod in (("port", input_split), ("jax", jax_split)):
        cache = str(tmp_path / f"{who}.cache")
        s = mod.create(f"{src}#{cache}", 0, 1, "text")
        s.hint_chunk_size(2048)
        e1 = [bytes(r) for r in iter(s.next_record, None)]
        s.before_first()
        e2 = [bytes(r) for r in iter(s.next_record, None)]
        s.close()
        runs[who] = (e1, e2, open(cache, "rb").read())
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == runs["port"][1]
    # the other package's cache replays
    other = "jax" if reader == "port" else "port"
    cache = str(tmp_path / f"{reader}-reads-{other}.cache")
    shutil.copy(str(tmp_path / f"{other}.cache"), cache)
    mod = input_split if reader == "port" else jax_split
    s = mod.create(f"{src}#{cache}", 0, 1, "text")
    try:
        assert [bytes(r) for r in iter(s.next_record, None)] == runs[other][0]
    finally:
        s.close()


def test_stdin_split_through_a_pipe(tmp_path):
    text = _libsvm_text(10, rows=200).replace("\n", "\r\n", 20)
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "from {pkg}.io import input_split; "
            "s = input_split.create('stdin'); "
            "print(repr([bytes(r) for r in s]))")
    outs = []
    for pkg in (data.__name__.split(".")[0], jax_data.__name__.split(".")[0]):
        res = subprocess.run(
            [sys.executable, "-c", code.format(root=ROOT, pkg=pkg)],
            input=text.encode(), capture_output=True, timeout=120,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert res.returncode == 0, res.stderr.decode()[-2000:]
        outs.append(res.stdout)
    assert outs[0] == outs[1]
    assert eval(outs[0].decode()) == [ln.encode() for ln in
                                      text.replace("\r", "\n").split("\n")
                                      if ln]


def test_split_types_refused_and_stdin_rewind():
    with pytest.raises(DMLCError, match="unknown input split type"):
        input_split.create(__file__, 0, 1, "parquet")
    with pytest.raises(DMLCError, match="need an index file"):
        input_split.create(__file__, 0, 1, "indexed_recordio")
    s = input_split.SingleFileSplit("stdin")
    with pytest.raises(DMLCError, match="cannot rewind"):
        s.before_first()


def _row_iter_blocks(it):
    out = [{k: (None if v is None else np.asarray(v).copy())
            for k, v in (("offset", b.offset), ("label", b.label),
                         ("index", b.index), ("value", b.value),
                         ("weight", b.weight), ("field", b.field))}
           for b in it]
    return out, it.num_col()


@pytest.fixture
def text_files(tmp_path):
    return {"libsvm": _write(tmp_path, "a.libsvm", _libsvm_text(11)),
            "libfm": _write(tmp_path, "a.libfm", _libfm_text(11)),
            "csv": _write(tmp_path, "a.csv", _csv_text(11))}


@pytest.mark.parametrize("n_parts", [1, 3])
@pytest.mark.parametrize("fmt", ["libsvm", "csv", "libfm", "auto",
                                 "auto_csv"])
def test_create_row_iter_matches_jax(text_files, fmt, n_parts):
    uri = text_files["csv" if fmt == "auto_csv" else
                     "libsvm" if fmt == "auto" else fmt]
    kind = "auto" if fmt.startswith("auto") else fmt
    if fmt in ("csv", "auto_csv"):
        uri += "?format=csv&label_column=0"
    for p in range(n_parts):
        a, ca = _row_iter_blocks(data.create_row_iter(uri, p, n_parts, kind))
        b, cb = _row_iter_blocks(jax_data.create_row_iter(uri, p, n_parts,
                                                          kind))
        assert ca == cb and len(a) == len(b), (p, ca, cb)
        for x, y in zip(a, b):
            _assert_blocks_equal(x, y)


@pytest.mark.parametrize("fmt", ["libsvm", "libfm"])
def test_disk_row_iter_cache_both_ways(tmp_path, text_files, fmt):
    """The page caches are byte-equal, and each package streams the
    other's cache with the source removed."""
    res = {}
    for who, mod in (("port", data), ("jax", jax_data)):
        d = tmp_path / who
        d.mkdir()
        src = str(d / "src.txt")
        shutil.copy(text_files[fmt], src)
        cache = str(d / "rows.cache")
        it = mod.create_row_iter(f"{src}#{cache}", 0, 1, fmt)
        e1 = _row_iter_blocks(it)
        e2 = _row_iter_blocks(it)
        it.close()
        res[who] = (src, cache, e1, e2)
    for a, b in zip(res["port"][2][0] + res["port"][3][0],
                    res["jax"][2][0] + res["jax"][3][0]):
        _assert_blocks_equal(a, b)
    with open(res["port"][1], "rb") as f, open(res["jax"][1], "rb") as g:
        assert f.read() == g.read()
    for reader, writer in (("port", "jax"), ("jax", "port")):
        src, cache = res[reader][0], res[reader][1]
        for ext in ("", ".meta"):
            shutil.copy(res[writer][1] + ext, cache + ext)
        if os.path.exists(src):
            os.remove(src)
        mod = data if reader == "port" else jax_data
        it = mod.create_row_iter(f"{src}#{cache}", 0, 1, fmt)
        blocks, ncol = _row_iter_blocks(it)
        it.close()
        assert ncol == res[writer][2][1]
        for a, b in zip(blocks, res[writer][2][0]):
            _assert_blocks_equal(a, b)


def test_row_block_container_save_load_both_ways():
    c = data.RowBlockContainer()
    c.push(1.0, [3, 7], [0.5, 2.0], weight=2.0, field=[1, 2])
    c.push(0.0, [1], [1.5], weight=0.5, field=[4])
    s = MemoryBytesStream()
    c.save(s)
    j = jax_data.RowBlockContainer()
    j.push(1.0, [3, 7], [0.5, 2.0], weight=2.0, field=[1, 2])
    j.push(0.0, [1], [1.5], weight=0.5, field=[4])
    js = JaxMemStream()
    j.save(js)
    assert s.getvalue() == js.getvalue()
    back = data.RowBlockContainer()
    assert back.load(MemoryBytesStream(js.getvalue()))
    _assert_blocks_equal(_block_arrays(back), _block_arrays(j))
    assert (back.max_index, back.max_field) == (7, 4)
    assert not back.load(MemoryBytesStream(b""))


def _rowblock_cases():
    c = data.RowBlockContainer()
    c.push_arrays(labels=np.array([1.0, 0.0, 1.0], np.float32),
                  offsets=np.array([0, 2, 2, 7], np.uint64),
                  index=np.array([0, 3, 1, 2, 4, 9, 5], np.uint32),
                  value=np.array([1, 2, 3, 4, 5, 6, 7], np.float32))
    blk = c.get_block()
    empty = data.RowBlockContainer()
    empty.push_arrays(labels=np.empty(0, np.float32),
                      offsets=np.array([0], np.uint64),
                      index=np.empty(0, np.uint32),
                      value=np.empty(0, np.float32))
    nan = data.RowBlockContainer()
    nan.push_arrays(labels=np.array([1.0, 0.0], np.float32),
                    offsets=np.array([0, 1, 2], np.uint64),
                    index=np.array([0, 1], np.uint32),
                    value=np.array([np.nan, np.inf], np.float32))
    bad = data.RowBlock(offset=np.array([2, 1, 3], np.uint64),
                        label=np.array([1.0, 0.0], np.float32),
                        index=np.array([0, 1, 2], np.uint32),
                        value=np.array([5, 6, 7], np.float32))
    return [(blk, dict(batch_size=4, max_nnz=3, num_col=6)),
            (blk, dict(batch_size=2, max_nnz=8, num_col=0)),
            (blk.slice(1, 3), dict(batch_size=4, max_nnz=2, num_col=10)),
            (empty.get_block(), dict(batch_size=3, max_nnz=2, num_col=4)),
            (nan.get_block(), dict(batch_size=3, max_nnz=3, num_col=0)),
            (bad, dict(batch_size=3, max_nnz=2, num_col=0))]


@pytest.mark.parametrize("case", range(6))
def test_pack_rowblock_both_routes_match_jax(case):
    blk, kw = _rowblock_cases()[case]
    jblk = jax_data.RowBlock(offset=blk.offset, label=blk.label,
                             index=blk.index, value=blk.value)
    want = jax_pack_rowblock(jblk, **kw)
    for got in (pack_rowblock(blk, **kw), pack_rowblock_plain(blk, **kw)):
        for k in ("label", "value", "index", "mask"):
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), (k, kw)
            masked = got["mask"] == 0.0
            assert (got["value"][masked] == 0.0).all()


def test_pack_rowblock_foreign_out_and_bad_shape():
    blk, _ = _rowblock_cases()[0]
    out64 = {"label": np.empty(4, np.float64),
             "value": np.empty((4, 2), np.float64),
             "index": np.empty((4, 2), np.int64),
             "mask": np.empty((4, 2), np.float64)}
    got = pack_rowblock(blk, 4, 2, 5, out=out64)
    ref = pack_rowblock(blk, 4, 2, 5)
    for k in ref:
        assert got[k] is out64[k]
        np.testing.assert_array_equal(got[k], ref[k].astype(got[k].dtype))
    small = {k: np.empty(v.shape, v.dtype) for k, v in ref.items()}
    with pytest.raises(ValueError):
        pack_rowblock(blk, 64, 8, out=small)


@pytest.fixture(scope="module")
def mesh():
    return build_mesh(8, dp=4, sp=2, tp=1, pp=1, ep=1)


def _epochs(feed, n=2):
    out = []
    try:
        for _ in range(n):
            out.append([{k: np.array(v) for k, v in b.items()} for b in feed])
    finally:
        if hasattr(feed, "close"):
            feed.close()
    return out


def _assert_same(jax_epochs, port_epochs):
    assert len(jax_epochs) == len(port_epochs)
    for e, (je, pe) in enumerate(zip(jax_epochs, port_epochs)):
        assert len(je) == len(pe), f"epoch {e}: {len(je)} vs {len(pe)}"
        for i, (jb, pb) in enumerate(zip(je, pe)):
            assert sorted(jb) == sorted(pb), (e, i)
            for k in jb:
                assert jb[k].dtype == pb[k].dtype, (e, i, k)
                np.testing.assert_array_equal(jb[k], pb[k],
                                              err_msg=f"{e}/{i}/{k}")


@pytest.fixture(scope="module")
def feed_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sparse")
    # float-exact values: every parse route gives the same bits
    rng = np.random.default_rng(12)
    lines = []
    for i in range(611):
        k = int(rng.integers(0, 9))
        idx = np.sort(rng.choice(5000, k, replace=False))
        toks = [f"{j}:{int(rng.integers(-64, 64)) / 8}" for j in idx]
        lines.append(" ".join([f"{i % 2}"] + toks))
    svm = d / "f.libsvm"
    svm.write_text("\n".join(lines) + "\n")
    csv = d / "f.csv"
    csv.write_text("".join(
        ",".join(str(int(v) / 4) for v in rng.integers(-40, 40, 6)) + "\n"
        for _ in range(333)))
    fm = d / "f.libfm"
    fm.write_text("".join(
        f"{i % 2} " + " ".join(f"{int(rng.integers(0, 9))}:"
                               f"{int(rng.integers(0, 999))}:1.5"
                               for _ in range(3)) + "\n" for i in range(222)))
    return {"libsvm": str(svm), "csv": str(csv) + "?format=csv&label_column=0",
            "libfm": str(fm)}


@pytest.mark.parametrize("fmt", ["libsvm", "auto", "csv", "libfm"])
def test_libsvm_feed_matches_jax(feed_files, mesh, fmt):
    """Batch by batch over two epochs, the epoch tail included (short
    partitions drain first, the last batch of each is zero-padded):
    LibSVM on the fused route (``libsvm``) and the classic one
    (``auto``), CSV and libfm on the classic one."""
    uri = feed_files["libsvm" if fmt == "auto" else fmt]
    want = _epochs(jax_libsvm_feed(uri, mesh, batch_size=16, max_nnz=5,
                                   fmt=fmt))
    got = _epochs(libsvm_feed(uri, batch_size=16, max_nnz=5, fmt=fmt,
                              num_parts=N_PARTS, device="cpu"))
    if fmt in ("libsvm", "auto"):
        assert any(0 < b["parts_alive"].sum() < N_PARTS for b in got[0])
        fused = _epochs(libsvm_feed(uri, batch_size=16, max_nnz=5,
                                    num_parts=N_PARTS, device="cpu"), 1)
        _assert_same(fused, got[:1])
    _assert_same(want, got)


def test_libsvm_feed_world_and_device(feed_files):
    """Every row once across a world of 3 processes; no card and no
    device named: a raise."""
    labels = []
    for rank in range(3):
        feed = libsvm_feed(feed_files["libsvm"], batch_size=8, max_nnz=9,
                           num_parts=2, device="cpu", world=(rank, 3))
        for b in _epochs(feed, 1)[0]:
            live = b["mask"].sum(1) > 0
            labels.append(int(live.sum()))
    rows = open(feed_files["libsvm"]).read().splitlines()
    assert sum(labels) == sum(1 for r in rows if len(r.split()) > 1)
    if not torch.cuda.is_available():
        with pytest.raises(DMLCError, match="no CUDA device"):
            libsvm_feed(feed_files["libsvm"], batch_size=8, max_nnz=9)


def test_host_utilities_match_jax():
    from dmlc_tpu import common as jcommon
    from dmlc_tpu import serializer as jser
    from dmlc_tpu.param import Parameter as JParameter, field as jfield

    for s, d in (("a,b,", ","), ("", ","), ("x", ","), (",,a", ",")):
        assert common.split(s, d) == jcommon.split(s, d)
    assert common.hash_combine(12345, 678) == jcommon.hash_combine(12345, 678)

    class P(param.Parameter):
        n = param.field(int, 3).set_range(0, 10)
        mode = param.field(str, "a").add_enum("a").add_enum("b")

    class JP(JParameter):
        n = jfield(int, 3).set_range(0, 10)
        mode = jfield(str, "a").add_enum("a").add_enum("b")

    assert P(n="0x7").to_dict() == JP(n="0x7").to_dict()
    assert P.doc_string() == JP.doc_string()
    with pytest.raises(ParamError, match="out of range"):
        P(n=11)
    reg = registry.Registry.get("test_torch_data_kind")
    reg.register("x", lambda: 5)
    reg.add_alias("x", "y")
    assert reg.create("y") == 5
    value = {"k": [1.5, 2.5], "z": []}
    s, js = MemoryBytesStream(), JaxMemStream()
    serializer.write(s, value, ("map", "str", ("vec", "f64")))
    jser.write(js, value, ("map", "str", ("vec", "f64")))
    assert s.getvalue() == js.getvalue()
    back = serializer.read(MemoryBytesStream(s.getvalue()),
                           ("map", "str", ("vec", "f64")))
    assert {k: list(v) for k, v in back.items()} == value
