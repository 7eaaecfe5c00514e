"""Train the transformer LM from RecordIO token shards: the data spine of
the port in one module (the port of ``examples/train_lm_recordio.py``,
its non-elastic loop) — input split → device feed → model → checkpoint
and resume, with the self-healing guard (``resilience.selfheal``) on
every step.

    python -m dmlc_tpu_torch.examples.train_lm_recordio --make-data out.rec
    python -m dmlc_tpu_torch.examples.train_lm_recordio out.rec [steps] \\
        [ckpt_dir] [--device cpu]

Each record holds SEQ + 1 little-endian int32 token ids (arithmetic
sequences mod VOCAB from ``make_data``).  The feed places batches on the
card (``--device cpu`` runs the plain versions on the CPU); the loop
drops an epoch's last short batch, and with a checkpoint directory it
resumes from the newest committed step — params, AdamW moments and
count, and the stream position (batches consumed), fast-forwarding a
fresh feed to it — and saves every 20 steps and at the end.  A
non-finite or spiking step is skipped, repeated ones roll back to the
last commit and replay the stream position saved with it
(``DMLC_SELFHEAL_*`` knobs; ``DMLC_FAULT_SPEC='selfheal.loss@step:21=
corrupt::3'`` injects poisoned steps).
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
    losses (after a self-heal rollback, the replayed steps' losses in
    place of the rolled-back ones).  ``model`` is trained in place when
    given, else built by ``init_params`` from seed 0 in
    :func:`example_config`.  With ``ckpt_dir``, resume from its newest
    committed step and save every SAVE_EVERY steps and at the end.

    Every step's loss and gradient norm pass through a
    :class:`~dmlc_tpu_torch.resilience.SelfHealGuard` before the update
    is applied: a poisoned step is skipped (its update declined, its
    batch dropped), ``DMLC_SELFHEAL_MAX_SKIPS`` consecutive skips roll
    back to the newest committed checkpoint and replay the stream from
    the position snapshotted at that commit (quarantined spans
    skip-listed by the readers), and exhausted rollbacks abort with a
    postmortem (:class:`SelfHealAbort`).  Without ``ckpt_dir`` the
    ladder is skip → abort."""
    from ..base import DMLCError, resolve_device
    from ..checkpoint import CheckpointManager
    from ..feed import recordio_feed
    from ..models.convert import train_state_from_jax, train_state_to_jax
    from ..models.transformer import adamw, init_params, make_train_step
    from ..resilience import SelfHealGuard

    device = resolve_device(device)
    if model is None:
        model = init_params(example_config(device),
                            torch.Generator(device).manual_seed(0), device)
    optimizer = adamw(model.parameters(), LR)
    step_fn = make_train_step(model, optimizer, grad_norm=True)
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
    # without a checkpoint there is nothing to roll back to
    guard = SelfHealGuard(**({} if manager is not None
                             else {"max_rollbacks": 0}))
    # the rollback target before the first commit: the state training
    # started from, a host copy (the update is in place, so no reference
    # can stand in for it), dropped at the first commit
    genesis = ((train_state_to_jax(model, optimizer), skip)
               if manager is not None else None)
    # batches consumed at each commit (step -> count): a skip consumes a
    # batch without a step, so a rollback replays this, not the step
    ckpt_consumed = {}

    def rollback_and_replay(base: int):
        """``(done, skip, base)`` after restoring the newest committed
        checkpoint (the genesis state before the first): the new step
        count, the batches a fresh stream must fast-forward, the base."""
        restored_step, stream_pos = restore(manager, model, optimizer)
        feed.close()  # abandon the in-flight epoch
        if restored_step is None:
            if genesis is None:
                raise DMLCError("selfheal: no committed checkpoint and no "
                                "genesis state to roll back to")
            train_state_from_jax(genesis[0], model, optimizer)
            print("selfheal: no committed checkpoint; rolling back to "
                  "the genesis state", flush=True)
            return 0, genesis[1], base
        base = min(base, restored_step)
        replay = ckpt_consumed.get(restored_step)
        if replay is None:
            replay = restored_step if stream_pos is None else stream_pos
        print(f"selfheal: rolled back to committed step {restored_step}; "
              f"replaying {replay} batches", flush=True)
        return restored_step - base, replay, base

    losses: List[float] = []
    consumed = 0
    done = 0
    full_in_epoch = 0
    verdict = [None]

    def accept(loss, gnorm) -> bool:
        # asked between the gradients and the update: only "ok" applies it
        verdict[0] = guard.observe(float(loss), grad_norm=float(gnorm),
                                   step=done + 1)
        return verdict[0] == "ok"

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
            loss, _ = step_fn(ids, labels, accept=accept)
            if verdict[0] == "skip":
                continue
            if verdict[0] == "rollback":
                # the reference enters the goodput ledger's
                # rollback_replay state here (ROADMAP.md Queue 1 item 9)
                done, skip, base = rollback_and_replay(base)
                del losses[done:]
                it = iter(feed)
                consumed = full_in_epoch = 0  # the replay re-counts
                continue
            if verdict[0] == "abort":
                guard.raise_abort(done + 1)
            loss = float(loss)
            losses.append(loss)
            done += 1
            if done % 10 == 0 or done == 1:
                print(f"step {base + done}: loss {loss:.4f}", flush=True)
            if manager is not None and done % SAVE_EVERY == 0:
                ckpt_consumed[base + done] = consumed
                manager.save(base + done,
                             train_state(model, optimizer, consumed))
                genesis = None  # a committed checkpoint outranks it
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
