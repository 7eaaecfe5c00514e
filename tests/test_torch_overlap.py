"""The port's GradientBucketer (host half of ``parallel/overlap.py``) on CPU
tensors against the JAX package's bucketer on the same numpy leaves:
bucket boundaries, per-bucket timings, reduced values, pytree order,
and the all-or-nothing rule when a bucket's collective raises."""

import threading

import numpy as np
import pytest
import torch

from dmlc_tpu.parallel import overlap as jov
from dmlc_tpu_torch.parallel import overlap as pov


def _leaves(seed):
    rng = np.random.default_rng(seed)
    shapes = [(7, 3), (0,), (), (41,), (2, 2, 5), (1,), (64,), (3, 0, 2)]
    return [rng.standard_normal(s) for s in shapes]


class _Recorder:
    """A stand-in collective: records each bucket's element count and
    returns a deterministic function of it."""

    def __init__(self, fail_at=None):
        self.sizes = []
        self.fail_at = fail_at
        self.lock = threading.Lock()

    def __call__(self, a):
        with self.lock:
            self.sizes.append(int(a.size))
            k = len(self.sizes)
        if k == self.fail_at:
            raise ConnectionError(f"bucket {k} lost its peer")
        np.multiply(a, 3, out=a)
        a += k
        return a


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bucket", [16, 40, 1 << 12])
def test_buckets_and_results_equal_jax(dtype, bucket):
    leaves = _leaves(0)
    jrec, prec = _Recorder(), _Recorder()
    jb = jov.GradientBucketer(jrec, bucket_bytes_=bucket, dtype=dtype)
    pb = pov.GradientBucketer(prec, bucket_bytes_=bucket, dtype=dtype)
    try:
        want = jb.reduce_leaves(leaves)
        got = pb.reduce_leaves([torch.from_numpy(lf) for lf in leaves])
        assert prec.sizes == jrec.sizes
        assert pb.bucket_elems == jb.bucket_elems
        assert len(pb.last_timings()) == len(jb.last_timings()) \
            == len(jrec.sizes)
        assert [b for b, _ in pb.last_timings()] == \
            [b for b, _ in jb.last_timings()]
        for g, w, lf in zip(got, want, leaves):
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            assert tuple(g.shape) == np.shape(lf) == w.shape
            assert g.numpy().dtype == np.dtype(dtype)
            assert g.numpy().tobytes() == w.tobytes()
        # numpy leaves come back as ndarrays, as in the JAX package
        got_np = pb.reduce_leaves(leaves)
        assert all(isinstance(g, np.ndarray) and g.tobytes() == w.tobytes()
                   for g, w in zip(got_np, jb.reduce_leaves(leaves)))
    finally:
        jb.close()
        pb.close()


def test_reduce_tree_restores_structure_as_jax():
    rng = np.random.default_rng(1)
    tree = {"a": [rng.standard_normal(5), rng.standard_normal((2, 3))],
            "b": rng.standard_normal(9),
            "c": (rng.standard_normal(4),)}
    jrec, prec = _Recorder(), _Recorder()
    jb = jov.GradientBucketer(jrec, bucket_bytes_=24)
    pb = pov.GradientBucketer(prec, bucket_bytes_=24)
    try:
        want = jb.reduce_tree(tree)
        ptree = {"a": [torch.from_numpy(x) for x in tree["a"]],
                 "b": torch.from_numpy(tree["b"]),
                 "c": (torch.from_numpy(tree["c"][0]),)}
        got = pb.reduce_tree(ptree)
    finally:
        jb.close()
        pb.close()
    assert prec.sizes == jrec.sizes
    assert isinstance(got["c"], tuple) and len(got["a"]) == 2
    for g, w in [(got["a"][0], want["a"][0]), (got["a"][1], want["a"][1]),
                 (got["b"], want["b"]), (got["c"][0], want["c"][0])]:
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("fail_at", [1, 3])
def test_collective_error_reraised_at_join_leaves_untouched(fail_at):
    leaves = [torch.from_numpy(lf.astype(np.float32))
              for lf in _leaves(2)]
    before = [lf.clone() for lf in leaves]
    rec = _Recorder(fail_at=fail_at)
    pb = pov.GradientBucketer(rec, bucket_bytes_=64)
    try:
        with pytest.raises(ConnectionError, match="lost its peer"):
            pb.reduce_leaves(leaves)
        for lf, b in zip(leaves, before):
            assert torch.equal(lf, b)
        # the worker drained and stays usable after the failure
        rec.fail_at = None
        got = pb.reduce_leaves(leaves)
        assert len(got) == len(leaves)
    finally:
        pb.close()


def test_future_and_helpers_equal_jax(monkeypatch):
    assert pov.reverse_topological(5) == jov.reverse_topological(5)
    assert pov.bucket_bytes() == jov.bucket_bytes() == 4 << 20
    monkeypatch.setenv("DMLC_COLL_BUCKET_MB", "0.5")
    assert pov.bucket_bytes() == jov.bucket_bytes() == 1 << 19
    f = pov.CollectiveFuture()
    assert not f.done()
    with pytest.raises(TimeoutError):
        f.result(timeout=0.01)
    f.set_exception(ValueError("x"))
    assert f.done() and isinstance(f.exception(), ValueError)
    with pytest.raises(ValueError):
        f.result()


def test_bucket_spans_feed_the_step_ledger():
    """The buckets' spans (collective thread) and the join's (training
    thread) are the port's step ledger's collective time: four 20 ms
    buckets in series, nearly all of it paid inside the join."""
    import time

    from dmlc_tpu_torch import telemetry

    def slow(a):
        time.sleep(0.02)
        return a

    pb = pov.GradientBucketer(slow, bucket_bytes_=64)
    try:
        telemetry.step_begin()
        pb.reduce_leaves([torch.ones(64) for _ in range(4)])
        rec = telemetry.step_end()
    finally:
        pb.close()
    assert rec["collective_s"] + rec["collective_overlapped_s"] >= 0.075
    assert 0.05 < rec["collective_s"] <= rec["wall_s"]
