"""The device feed on a card: batches placed through pinned staging, the
feed's own stream and its events, held byte-exact against the same feed
on the CPU over whole epochs (RecordIO on its three routes, LibSVM on
the fused and classic routes) while the consumer's stream is kept busy
(a missing stream wait or ``record_stream`` shows as a batch that is
right only sometimes).  Marked ``cuda``: skips without a card.  The
module imports no jax, so it runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_feed_card.py
"""

import numpy as np
import pytest
import torch

from dmlc_tpu_torch.feed import recordio_feed, recordio_packed_feed
from dmlc_tpu_torch.io.recordio import RecordIOWriter
from dmlc_tpu_torch.io.stream import Stream


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the feed places on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    rng = np.random.default_rng(3)
    path = str(tmp_path_factory.mktemp("card") / "d.rec")
    with Stream.create(path, "w") as s:
        w = RecordIOWriter(s)
        for i in range(1500):
            n = int(rng.integers(0, 3000)) if i % 7 else 4096
            w.write_record(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    return path


def _host_epoch(make):
    feed = make("cpu")
    try:
        return [{k: v.clone() for k, v in b.items()} for b in feed]
    finally:
        feed.close()


def _busy(x):
    """Work on the consumer's stream between batches, as a train step."""
    for _ in range(4):
        x = x @ x
        x = x / x.norm()
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("route", ["padded", "packed_transport", "packed"])
def test_card_batches_byte_exact_over_epochs(card, shard, depth, route):
    def make(device):
        kw = dict(num_parts=4, device=device, queue_depth=depth)
        if route == "packed":
            return recordio_packed_feed(shard, buf_bytes=64 << 10,
                                        max_records=48, **kw)
        extra = {"pack_bytes": 48 * 2048} if route == "packed_transport" \
            else {}
        return recordio_feed(shard, batch_records=48, max_bytes=2048,
                             **kw, **extra)

    want = _host_epoch(make)
    feed = make(card)
    x = torch.randn(1024, 1024, device=card)
    try:
        for epoch in range(2):
            held = []
            for b in feed:
                x = _busy(x)
                held.append(b)   # kept past later batches and recycles
            torch.cuda.synchronize()
            assert len(held) == len(want), epoch
            for i, (got, ref) in enumerate(zip(held, want)):
                for k, v in ref.items():
                    assert torch.equal(got[k].cpu(), v), (epoch, i, k)
                    if k != "parts_alive":
                        assert got[k].is_cuda, k
    finally:
        feed.close()
    st = feed.stats()
    assert st["staging_buffers_built"] <= depth
    assert st["batches"] == 2 * len(want)


@pytest.mark.cuda
def test_card_staging_is_pinned(card, shard):
    feed = recordio_feed(shard, batch_records=8, max_bytes=512, num_parts=2,
                         device=card)
    try:
        next(iter(feed))
        assert all(t.is_pinned() for b in feed._built
                   for t in b.tensors.values())
    finally:
        feed.close()


@pytest.fixture(scope="module")
def sparse_text(tmp_path_factory):
    rng = np.random.default_rng(4)
    path = tmp_path_factory.mktemp("sparse") / "d.libsvm"
    lines = []
    for i in range(3001):
        idx = np.sort(rng.choice(1 << 20, int(rng.integers(0, 40)),
                                 replace=False))
        lines.append(" ".join([str(i % 2)] + [
            f"{j}:{rng.standard_normal():.7g}" for j in idx]))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["libsvm", "auto"])   # fused, classic
def test_card_libsvm_feed_byte_exact_over_epochs(card, sparse_text, fmt):
    from dmlc_tpu_torch.feed import libsvm_feed

    def make(device):
        return libsvm_feed(sparse_text, batch_size=64, max_nnz=39, fmt=fmt,
                           num_parts=4, device=device)

    want = _host_epoch(make)
    feed = make(card)
    x = torch.randn(1024, 1024, device=card)
    try:
        for epoch in range(2):
            held = []
            for b in feed:
                x = _busy(x)
                held.append(b)
            torch.cuda.synchronize()
            assert len(held) == len(want), epoch
            for i, (got, ref) in enumerate(zip(held, want)):
                for k, v in ref.items():
                    assert torch.equal(got[k].cpu(), v), (epoch, i, k)
    finally:
        feed.close()
