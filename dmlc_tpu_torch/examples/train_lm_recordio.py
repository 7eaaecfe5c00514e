"""Train the transformer LM from RecordIO token shards: the data spine of
the port in one module (the port of ``examples/train_lm_recordio.py``,
its non-elastic loop) — input split → device feed → model → checkpoint
and resume.

    python -m dmlc_tpu_torch.examples.train_lm_recordio --make-data out.rec
    python -m dmlc_tpu_torch.examples.train_lm_recordio out.rec [steps] \\
        [ckpt_dir] [--device cpu]

Each record holds SEQ + 1 little-endian int32 token ids (arithmetic
sequences mod VOCAB from ``make_data``).  The feed places batches on the
card (``--device cpu`` runs the plain versions on the CPU); the loop
drops an epoch's last short batch, and with a checkpoint directory it
resumes from the newest committed step — params, AdamW moments and
count, and the stream position (batches consumed), fast-forwarding a
fresh feed to it — and saves every 20 steps and at the end.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

SEQ = 128
VOCAB = 512
PER_PART = 8           # records per batch
SAVE_EVERY = 20
LR = 3e-4


def make_data(path: str, n_records: int = 2048, seed: int = 0,
              seq: int = SEQ, vocab: int = VOCAB) -> None:
    """``n_records`` records of ``seq + 1`` int32 tokens, an arithmetic
    sequence mod ``vocab`` each (the JAX example's ``make_data``: the
    same numbers for the same seed)."""
    from ..io.recordio import RecordIOWriter
    from ..io.stream import Stream

    rng = np.random.default_rng(seed)
    with Stream.create(path, "w") as s:
        w = RecordIOWriter(s)
        for _ in range(n_records):
            start, step = rng.integers(0, vocab), rng.integers(1, 7)
            ids = (start + step * np.arange(seq + 1)) % vocab
            w.write_record(ids.astype(np.int32).tobytes())


def example_config(device: torch.device):
    """The JAX example's model: bf16 on the card, float32 on the CPU."""
    from ..models.transformer import TransformerConfig

    return TransformerConfig(
        vocab=VOCAB, d_model=256, n_heads=4, head_dim=64, d_ff=512,
        n_layers=4, n_experts=1,
        dtype="bfloat16" if device.type == "cuda" else "float32", remat=True)


def batch_tokens(batch) -> tuple:
    """``data [B, (T+1)·4] uint8`` → ``(ids, labels) [B, T]`` int32: the
    bytes read as little-endian int32 on the device, as
    ``bitcast_convert_type`` in the JAX example."""
    toks = batch["data"].view(torch.int32)
    return toks[:, :-1], toks[:, 1:]


def train_state(model, optimizer, consumed: int):
    """The checkpointed tree, on the host: the train state and the stream
    position."""
    from ..models.convert import train_state_to_jax

    tree = train_state_to_jax(model, optimizer)
    tree["stream"] = np.asarray([consumed], np.int64)
    return tree


def restore(manager, model, optimizer):
    """``(step, stream position)`` of the newest committed checkpoint,
    loaded into ``model``/``optimizer``; ``(None, None)`` without one.
    A checkpoint without the stream leaf restores with position None."""
    from ..checkpoint import MissingLeaf
    from ..models.convert import train_state_from_jax, train_state_to_jax

    template = train_state_to_jax(model, optimizer, device="meta")
    try:
        step, tree = manager.restore_latest(
            dict(template, stream=np.zeros(1, np.int64)))
        pos = None if step is None else int(tree["stream"][0])
    except MissingLeaf:
        step, tree = manager.restore_latest(template)
        pos = None
    if step is not None:
        train_state_from_jax(tree, model, optimizer)
    return step, pos


def run(uri: str, steps: int, ckpt_dir: Optional[str] = None, *,
        device=None, model=None) -> List[float]:
    """Train ``steps`` new steps from the shards at ``uri``; returns their
    losses.  ``model`` is trained in place when given, else built by
    ``init_params`` from seed 0 in :func:`example_config`.  With
    ``ckpt_dir``, resume from its newest committed step and save every
    SAVE_EVERY steps and at the end."""
    from ..base import DMLCError, resolve_device
    from ..checkpoint import CheckpointManager
    from ..feed import recordio_feed
    from ..models.transformer import adamw, init_params, make_train_step

    device = resolve_device(device)
    if model is None:
        model = init_params(example_config(device),
                            torch.Generator(device).manual_seed(0), device)
    optimizer = adamw(model.parameters(), LR)
    step_fn = make_train_step(model, optimizer)
    manager = start_at = pos = None
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir, max_to_keep=2)
        start_at, pos = restore(manager, model, optimizer)
        if start_at is not None:
            print(f"resumed from step {start_at}", flush=True)
    base = start_at or 0
    # the feed is deterministic: replaying the persisted stream position
    # puts it where the saved run was (the step count where there is none)
    skip = base if pos is None else pos
    feed = recordio_feed(uri, batch_records=PER_PART,
                         max_bytes=(SEQ + 1) * 4, device=device)
    losses: List[float] = []
    consumed = 0
    done = 0
    full_in_epoch = 0
    try:
        it = iter(feed)
        while done < steps:
            batch = next(it, None)
            if batch is None:
                if full_in_epoch == 0:
                    raise DMLCError(f"{uri} holds no full batch of "
                                    f"{PER_PART} records")
                it = iter(feed)  # next epoch
                full_in_epoch = 0
                continue
            # the epoch's last short batch has all-zero rows: dropped
            # before the fast-forward, so only trained batches count
            if bool((batch["length"] == 0).any()):
                continue
            full_in_epoch += 1
            consumed += 1
            if skip > 0:
                skip -= 1
                continue
            ids, labels = batch_tokens(batch)
            loss = float(step_fn(ids, labels))
            losses.append(loss)
            done += 1
            if done % 10 == 0 or done == 1:
                print(f"step {base + done}: loss {loss:.4f}", flush=True)
            if manager is not None and done % SAVE_EVERY == 0:
                manager.save(base + done,
                             train_state(model, optimizer, consumed))
    finally:
        feed.close()
    if manager is not None and done % SAVE_EVERY != 0:
        manager.save(base + done, train_state(model, optimizer, consumed))
    st = feed.stats()
    print(f"final loss {losses[-1] if losses else float('nan'):.4f}; feed "
          f"moved {st['bytes_to_device'] / 1e6:.1f} MB in "
          f"{st['batches']} batches", flush=True)
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dmlc_tpu_torch.examples.train_lm_recordio",
        description="Train the example LM from RecordIO token shards.")
    ap.add_argument("--make-data", metavar="OUT",
                    help="write a synthetic shard to OUT and exit")
    ap.add_argument("uri", nargs="?", help="RecordIO shards to train on")
    ap.add_argument("steps", nargs="?", type=int, default=30)
    ap.add_argument("ckpt_dir", nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="the card unless given ('cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    if args.make_data:
        make_data(args.make_data)
        print(f"wrote 2048 records to {args.make_data}")
        return 0
    if not args.uri:
        ap.error("give the shards to train on, or --make-data OUT")
    run(args.uri, args.steps, args.ckpt_dir, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
