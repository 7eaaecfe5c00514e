"""The port's host collectives with tensors on a card: CUDA leaves through
the GradientBucketer (pinned buckets, an event synchronised before the
collective thread reads one) equal to the same leaves on the CPU while
the card is kept busy, a CUDA tensor refused by the client, and a
two-worker ``train_libsvm`` on the card whose ranks end on one weight
and whose per-rank epoch losses are those of the same job on the CPU.
Marked ``cuda``: skips without a card.  The module imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_tracker_card.py
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dmlc_tpu_torch.parallel.overlap import GradientBucketer
from dmlc_tpu_torch.tracker import TrackerClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = TrackerClient.__module__.split(".")[0]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the leaves live on the card")
    return torch.device("cuda")


def _slow_sum(a):
    """A stand-in collective that reads the bucket late: a bucket handed
    over before its copy landed would show as a wrong sum."""
    return a * 2 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bucket", [4096, 1 << 20])
def test_cuda_leaves_equal_cpu_leaves(card, dtype, bucket):
    rng = np.random.default_rng(0)
    shapes = [(1024, 33), (7,), (), (0,), (512, 512), (3, 5, 7)]
    host = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    b = GradientBucketer(_slow_sum, bucket_bytes_=bucket, dtype=dtype)
    try:
        want = b.reduce_leaves([torch.from_numpy(h) for h in host])
        for _ in range(3):
            x = torch.randn(2048, 2048, device=card)
            leaves = [torch.from_numpy(h).to(card) for h in host]
            for _ in range(8):  # keep the card's stream busy
                x = x @ x
                x = x / x.norm()
            got = b.reduce_leaves(leaves)
            for g, w, lf in zip(got, want, leaves):
                assert g.device == lf.device and g.shape == w.shape
                assert torch.equal(g.cpu(), w)
    finally:
        b.close()


@pytest.mark.cuda
def test_client_refuses_a_cuda_tensor(card):
    c = TrackerClient("127.0.0.1", 1)
    c.world_size = 2
    with pytest.raises(TypeError, match="takes host arrays"):
        c.allreduce(torch.ones(4, device=card), "sum")


def _train_libsvm(data, *extra):
    """{rank: final-line doc} of a 2-worker ``train_libsvm`` job."""
    env = os.environ.copy()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", f"{PORT}.tracker.submit", "--cluster",
         "local", "--num-workers", "2", "--max-attempts", "1",
         "--host-ip", "127.0.0.1", "--", sys.executable, "-m",
         f"{PORT}.examples.train_libsvm", str(data), "2", *extra],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    finals = {int(m.group(1)): json.loads(m.group(2)) for m in
              re.finditer(r"final rank (\d+): (\{.*\})", r.stderr)}
    assert sorted(finals) == [0, 1]
    return finals


@pytest.mark.cuda
def test_two_worker_train_libsvm_on_the_card(card, tmp_path):
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(4000):
        idx = np.sort(rng.choice(1 << 12, 20, replace=False))
        val = rng.random(20)
        y = int(val[idx < 2048].sum() > val[idx >= 2048].sum())
        lines.append(f"{y} " + " ".join(f"{j}:{v:.3f}"
                                        for j, v in zip(idx, val)))
    data = tmp_path / "t.libsvm"
    data.write_text("\n".join(lines) + "\n")
    finals = _train_libsvm(data)
    assert finals[0]["sha256"] == finals[1]["sha256"]
    assert finals[0]["losses"][1] < finals[0]["losses"][0]
    # 4096 f64 = 32 KB: under the hier cutover, so the tree
    assert finals[0]["allreduce_algos"] == {"tree": 2 * finals[0]["steps"]}
    # the same job on the CPU: each rank's unrounded epoch losses agree,
    # so the card's gradient (gather, index backward) is the CPU's
    plain = _train_libsvm(data, "--device", "cpu")
    for r in (0, 1):
        np.testing.assert_allclose(finals[r]["losses"], plain[r]["losses"],
                                   rtol=1e-5, atol=0)
