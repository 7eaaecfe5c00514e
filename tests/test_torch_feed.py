"""The port's device feed on the CPU against the JAX feed on the 8-device
virtual mesh (dp=4, sp=2: 8 partitions), batch by batch over two epochs
on three routes, and the port's own pipeline contracts."""

import struct
import threading

import numpy as np
import pytest
import torch

from dmlc_tpu.feed import recordio_feed as jax_recordio_feed
from dmlc_tpu.feed import recordio_packed_feed as jax_packed_feed
from dmlc_tpu.io.recordio import KMAGIC
from dmlc_tpu.io.recordio import RecordIOWriter as JaxWriter
from dmlc_tpu.io.stream import Stream as JaxStream
from dmlc_tpu.parallel import build_mesh
from dmlc_tpu_torch.feed import DeviceFeed, recordio_feed, \
    recordio_packed_feed

N_PARTS = 8


@pytest.fixture(scope="module")
def mesh():
    return build_mesh(8, dp=4, sp=2, tp=1, pp=1, ep=1)


def _recs(seed, n):
    """The inputs of the JAX feed tests: escaped-magic records, records
    longer than max_bytes, empty ones, random lengths."""
    rng = np.random.default_rng(seed)
    magic = struct.pack("<I", KMAGIC)
    out = []
    for i in range(n):
        if i % 10 == 3:
            out.append(b"A" * (4 * (i % 5)) + magic + b"B" * (4 + 4 * (i % 3)))
        elif i % 17 == 5:
            out.append(rng.integers(0, 256, 100, dtype=np.uint8).tobytes())
        elif i % 13 == 6:
            out.append(b"")
        else:
            out.append(rng.integers(0, 256, 8 + i % 40,
                                    dtype=np.uint8).tobytes())
    return out


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = tmp_path_factory.mktemp("feed") / "data.rec"
    recs = _recs(7, 203)
    with JaxStream.create(str(path), "w") as s:
        w = JaxWriter(s)
        for r in recs:
            w.write_record(r)
    return str(path), recs


def _epochs(feed, n=2):
    """``n`` epochs of host copies of every batch."""
    out = []
    try:
        for _ in range(n):
            out.append([{k: np.array(v) for k, v in b.items()}
                        for b in feed])
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
                                              err_msg=f"epoch {e} batch {i} {k}")


def test_padded_feed_matches_jax(shard, mesh):
    uri, _ = shard
    want = _epochs(jax_recordio_feed(uri, mesh, batch_records=4,
                                     max_bytes=64))
    got = _epochs(recordio_feed(uri, batch_records=4, max_bytes=64,
                                num_parts=N_PARTS, device="cpu"))
    # the epoch tail: some partitions drained before others
    assert any(0 < b["parts_alive"].sum() < N_PARTS for b in got[0])
    _assert_same(want, got)


def test_packed_transport_matches_jax(shard, mesh):
    uri, _ = shard
    want = _epochs(jax_recordio_feed(uri, mesh, batch_records=4,
                                     max_bytes=64, pack_bytes=160))
    got = _epochs(recordio_feed(uri, batch_records=4, max_bytes=64,
                                num_parts=N_PARTS, device="cpu",
                                pack_bytes=160))
    _assert_same(want, got)


def test_packed_feed_matches_jax(shard, mesh):
    uri, _ = shard
    want = _epochs(jax_packed_feed(uri, mesh, buf_bytes=256,
                                   max_records=8))
    got = _epochs(recordio_packed_feed(uri, buf_bytes=256, max_records=8,
                                       num_parts=N_PARTS, device="cpu"))
    _assert_same(want, got)


def test_packed_transport_equals_padded_rows(shard):
    """Every record reaches the consumer byte-exact, truncated to
    max_bytes, on both padded routes."""
    uri, recs = shard
    for kw in ({}, {"pack_bytes": 200}):
        feed = recordio_feed(uri, batch_records=4, max_bytes=64,
                             num_parts=1, device="cpu", **kw)
        rows = []
        for b in _epochs(feed, 1)[0]:
            rows += [bytes(r[:n]) for r, n in zip(b["data"], b["length"])]
        # trailing zero-length rows belong to the empty records and the
        # padding of short batches: compare the records in order
        got = iter(rows)
        for want in recs:
            row = next(got)
            while want and not row:
                row = next(got)
            assert row == want[:64]


def test_producer_error_surfaces_on_consumer():
    def good():
        for _ in range(50):
            yield {"x": np.zeros(2, np.float32)}

    def bad():
        yield {"x": np.ones(2, np.float32)}
        raise ValueError("partition 1 broke")

    feed = DeviceFeed([good, bad], device="cpu", num_workers=2)
    try:
        with pytest.raises(ValueError, match="partition 1 broke"):
            for _ in feed:
                pass
    finally:
        feed.close()
    assert feed._thread is None and feed._parsers == []


def test_close_joins_every_thread(shard, monkeypatch):
    uri, _ = shard
    monkeypatch.setenv("DMLC_FEED_WORKERS", "3")
    before = set(threading.enumerate())
    feed = recordio_feed(uri, batch_records=2, max_bytes=64,
                         num_parts=N_PARTS, device="cpu", queue_depth=2)
    it = iter(feed)
    next(it)
    assert len(feed._parsers) == 3
    feed.close()
    assert not [t for t in set(threading.enumerate()) - before
                if t.is_alive()]


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_partition_order_under_workers(workers):
    def part(p):
        def gen():
            for i in range(5 + p):
                yield {"v": np.full(3, 100 * p + i, np.int64)}
        return gen

    feed = DeviceFeed([part(p) for p in range(6)], device="cpu",
                      num_workers=workers, queue_depth=2)
    batches = _epochs(feed, 2)
    for epoch in batches:
        assert len(epoch) == 10
        for step, b in enumerate(epoch):
            for p in range(6):
                row = b["v"][3 * p:3 * (p + 1)]
                if step < 5 + p:
                    assert b["parts_alive"][p] == 1.0
                    assert (row == 100 * p + step).all()
                else:
                    assert b["parts_alive"][p] == 0.0
                    assert (row == 0).all()


def test_no_aliasing_after_the_pool_recycles():
    """Batches held past many pool recycles keep their values: placement
    copies out of the staging buffers."""
    def part(p):
        def gen():
            for i in range(40):
                yield {"v": np.full(16, p * 1000 + i, np.int32)}
        return gen

    feed = DeviceFeed([part(p) for p in range(3)], device="cpu",
                      queue_depth=2, num_workers=2)
    try:
        held = list(feed)   # the tensors themselves, no copies
    finally:
        feed.close()
    assert feed.stats()["staging_buffers_built"] <= 2
    for i, b in enumerate(held):
        for p in range(3):
            assert (b["v"][p * 16:(p + 1) * 16] == p * 1000 + i).all()


def test_staging_buffers_reused_across_epochs():
    def part():
        for i in range(10):
            yield {"v": np.full(4, i, np.float32)}

    feed = DeviceFeed([part, part], device="cpu", queue_depth=3)
    _epochs(feed, 3)
    assert feed.stats()["staging_buffers_built"] <= 3
    assert feed.stats()["batches"] == 30


def test_world_covers_every_record_once(shard):
    uri, recs = shard
    seen = []
    for rank in range(3):
        feed = recordio_feed(uri, batch_records=4, max_bytes=128,
                             num_parts=2, device="cpu", world=(rank, 3))
        assert feed.world == (rank, 3)
        for b in _epochs(feed, 1)[0]:
            seen += [bytes(r[:n]) for r, n in zip(b["data"], b["length"])
                     if n > 0]
    assert sorted(seen) == sorted(r for r in recs if r)


def test_feed_without_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from dmlc_tpu_torch.base import DMLCError

    with pytest.raises(DMLCError, match="no CUDA device"):
        DeviceFeed([lambda: iter(())])
