"""Distributed linear-regression SGD on a CSV file (the port of
``examples/train_csv.py``).

  python -m dmlc_tpu_torch.tracker.submit --cluster local --num-workers N \
      -- python -m dmlc_tpu_torch.examples.train_csv <uri> [epochs] \
      [label_column] [--device cpu]

Each worker reads InputSplit partition rank/world of the CSV through the
parser registry (format=csv, the native multi-threaded chunk parse),
computes squared-loss gradients with torch on the card (``--device cpu``
for the plain CPU run), and averages them with the tracker client's host
allreduce.  The log lines are the JAX example's, plus the last
``final rank ...`` line of ``train_libsvm``.
"""

import numpy as np

from .train_libsvm import BATCH, parse_args, run_sgd, to_device


def main(argv=None):
    args = parse_args(argv, "train_csv", extra=("label_column",))

    import torch

    from ..base import resolve_device
    from ..data import create_row_iter
    from ..feed.device_feed import pack_rowblock
    from ..tracker.client import TrackerClient

    device = resolve_device(args.device)
    client = TrackerClient()
    client.start()
    rank, world = client.rank, client.world_size

    it = create_row_iter(
        f"{args.uri}?format=csv&label_column={args.label_column}",
        rank, world, "auto")
    num_col = int(client.allreduce(
        np.array([it.num_col()], np.int64), op="max")[0])
    num_col = max(num_col, 1)

    def grad_step(w, value, index, mask, label):
        w = w.detach().requires_grad_(True)
        pred = torch.sum(value * mask * w[index], dim=1)
        loss = torch.mean(torch.square(pred - label))
        loss.backward()
        return loss.detach(), w.grad

    batches = []
    for blk in it:
        for lo in range(0, blk.size, BATCH):
            sub = blk.slice(lo, min(lo + BATCH, blk.size))
            batches.append(to_device(pack_rowblock(sub, BATCH, num_col,
                                                   num_col), device))
    n_steps = int(client.allreduce(
        np.array([len(batches)], np.int64), op="max")[0])
    # explicit shapes: a rank with an EMPTY partition still needs padding
    # batches to stay in lockstep with the allreduce
    zero = to_device({"label": np.zeros(BATCH, np.float32),
                      "value": np.zeros((BATCH, num_col), np.float32),
                      "index": np.zeros((BATCH, num_col), np.int32),
                      "mask": np.zeros((BATCH, num_col), np.float32)},
                     device)

    def epoch_line(epoch, mse):
        return f"rank {rank}: epoch {epoch} mse {mse:.4f}"

    run_sgd(client, grad_step, batches, zero, n_steps, 0.1, args.epochs,
            num_col, device, epoch_line)
    client.shutdown()


if __name__ == "__main__":
    main()
