"""Distributed logistic-regression SGD on a LibSVM file (the port of
``examples/train_libsvm.py``): every layer of the framework at once.

  python -m dmlc_tpu_torch.tracker.submit --cluster local --num-workers N \
      -- python -m dmlc_tpu_torch.examples.train_libsvm <uri> [epochs] \
      [--device cpu]

Each worker: rendezvous via the tracker (rank/world), reads InputSplit
partition rank/world of the file through ``create_row_iter``, computes
logistic-loss gradients with torch on the card (``--device cpu`` for the
plain CPU run), and averages them with the tracker client's host
allreduce (f64 on the host; ``auto`` picks tree/ring/hier by size).
The log lines are the JAX example's; the last line per rank
(``final rank ...``) adds a SHA-256 of the final weight, the algorithm
counts of the gradient allreduces and their timing, for a caller that
checks the ranks agree.
"""

import argparse
import hashlib
import json
import time

import numpy as np

BATCH = 256
MAX_NNZ = 64


def parse_args(argv, prog, extra=()):
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("uri")
    p.add_argument("epochs", nargs="?", type=int, default=3)
    for name in extra:
        p.add_argument(name, nargs="?", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for "
                        "the plain CPU run)")
    return p.parse_args(argv)


def allreduce_report(telemetry, cursor, nbytes):
    """(new cursor, {algo: count}, [ms]) over the ``collective.allreduce``
    spans recorded since ``cursor`` whose payload is ``nbytes``."""
    spans, last = telemetry.spans_since(cursor)
    algos, ms = {}, []
    for s in spans:
        args = s.get("args") or {}
        if s["name"] == "collective.allreduce" and args.get("bytes") == nbytes:
            algos[args["algo"]] = algos.get(args["algo"], 0) + 1
            ms.append(s["dur"] / 1e3)
    return last, algos, ms


def final_line(client, rank, w, losses, algos, ms, steps, epoch_s,
               step_s):
    """The per-rank diagnostic the JAX example does not print: the final
    weight's SHA-256, the unrounded epoch losses, the gradient
    allreduces' algorithms and times, and the step times."""
    import torch

    digest = hashlib.sha256(
        w.detach().to("cpu", torch.float32).numpy().tobytes()).hexdigest()
    ms = np.asarray(ms, np.float64)
    step_ms = np.asarray(step_s, np.float64) * 1e3
    doc = {"sha256": digest, "losses": losses, "allreduce_algos": algos,
           "steps": steps, "epoch_s": epoch_s,
           "allreduce_ms_p50": float(np.percentile(ms, 50)) if ms.size
           else None,
           "allreduce_ms_p99": float(np.percentile(ms, 99)) if ms.size
           else None,
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "allreduce_share": float(ms.sum() / step_ms.sum())}
    client.log(f"final rank {rank}: {json.dumps(doc)}")


def to_device(batch, device):
    """A packed batch's arrays as tensors on ``device``; indices as int64,
    once (the gather and its backward take them)."""
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(
                v, np.int64 if k == "index" else None)).to(device)
            for k, v in batch.items()}


def run_sgd(client, grad_step, batches, zero, n_steps, lr, epochs,
            num_col, device, epoch_line):
    """The examples' shared loop: ``n_steps`` steps an epoch (zero-mask
    batches past this rank's own), each averaging the f64 gradient over
    the host allreduce; ``epoch_line(epoch, mean_loss)`` is the JAX
    example's log line.  Ends with :func:`final_line`."""
    import torch

    from .. import telemetry

    world = client.world_size
    w = torch.zeros(num_col, dtype=torch.float32, device=device)
    cursor = telemetry.core.span_seq()
    algos, ms, epoch_s, step_s, losses = {}, [], [], [], []
    for epoch in range(epochs):
        total = 0.0
        t_epoch = time.perf_counter()
        for i in range(n_steps):
            t_step = time.perf_counter()
            b = batches[i] if i < len(batches) else zero
            loss, g = grad_step(w, b["value"], b["index"], b["mask"],
                                b["label"])
            g_sum = client.allreduce_sum(g.to(torch.float64).cpu().numpy())
            w = w - lr * torch.from_numpy(g_sum / world).to(
                device=device, dtype=torch.float32)
            total += float(loss)
            step_s.append(time.perf_counter() - t_step)
        epoch_s.append(time.perf_counter() - t_epoch)
        losses.append(total / max(len(batches), 1))
        client.log(epoch_line(epoch, losses[-1]))
        cursor, got, got_ms = allreduce_report(telemetry, cursor,
                                               num_col * 8)
        for k, v in got.items():
            algos[k] = algos.get(k, 0) + v
        ms += got_ms
    final_line(client, client.rank, w, losses, algos, ms, n_steps,
               epoch_s, step_s)


def main(argv=None):
    args = parse_args(argv, "train_libsvm")

    import torch

    from ..base import resolve_device
    from ..data import create_row_iter
    from ..feed.device_feed import pack_rowblock
    from ..tracker.client import TrackerClient

    device = resolve_device(args.device)
    client = TrackerClient()
    client.start()
    rank, world = client.rank, client.world_size

    it = create_row_iter(args.uri, rank, world, "libsvm")
    # feature-count must agree across workers for the weight vector
    num_col = int(client.allreduce(
        np.array([it.num_col()], np.int64), op="max")[0])
    num_col = max(num_col, 1)

    def grad_step(w, value, index, mask, label):
        w = w.detach().requires_grad_(True)
        x = value * mask  # [B, K]
        logits = torch.sum(x * w[index], dim=1)
        p = torch.sigmoid(logits)
        eps = 1e-7
        loss = -torch.mean(label * torch.log(p + eps)
                           + (1 - label) * torch.log(1 - p + eps))
        loss.backward()
        return loss.detach(), w.grad

    # pack this partition's rows once; byte-range partitions are NOT
    # row-balanced, so workers agree on a global step count and pad with
    # zero-mask batches — otherwise allreduce calls desynchronize
    batches = []
    for blk in it:
        for lo in range(0, blk.size, BATCH):
            sub = blk.slice(lo, min(lo + BATCH, blk.size))
            batches.append(to_device(pack_rowblock(sub, BATCH, MAX_NNZ,
                                                   num_col), device))
    n_steps = int(client.allreduce(
        np.array([len(batches)], np.int64), op="max")[0])
    zero = to_device({"label": np.zeros(BATCH, np.float32),
                      "value": np.zeros((BATCH, MAX_NNZ), np.float32),
                      "index": np.zeros((BATCH, MAX_NNZ), np.int32),
                      "mask": np.zeros((BATCH, MAX_NNZ), np.float32)},
                     device)

    def epoch_line(epoch, loss):
        return (f"rank {rank}: epoch {epoch} loss {loss:.4f} "
                f"({len(batches)}/{n_steps} local batches)")

    run_sgd(client, grad_step, batches, zero, n_steps, 0.5, args.epochs,
            num_col, device, epoch_line)
    client.shutdown()


if __name__ == "__main__":
    main()
