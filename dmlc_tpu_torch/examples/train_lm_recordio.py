"""Train the transformer LM from RecordIO token shards: the data spine of
the port in one module (the port of ``examples/train_lm_recordio.py``) —
input split → device feed → model → checkpoint and resume, with the
self-healing guard (``resilience.selfheal``) on every step, and an
elastic mode that survives a resize of the world.

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

Elastic mode (``DMLC_ELASTIC=1`` under an elastic tracker, a checkpoint
directory required): each process joins the tracker's world, reads its
``(rank, world)`` partition of the shards, averages gradients over the
host collective (``parallel.overlap.GradientBucketer``), and survives
the world resizing mid-run — a collective interrupted by a lost or added
peer raises WorldResized; the loop re-enters rendezvous (possibly under
a new rank), repartitions the feed in place, makes rank 0's newest
committed checkpoint authoritative by broadcast, and trains on without
a process restart.  Every rank's wall clock is decomposed into the
goodput ledger's buckets (``telemetry.goodput``), shipped with the
heartbeats to the tracker's ``/goodput``.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
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


def train_state(model, optimizer, consumed: Optional[int] = None):
    """The checkpointed tree, on the host: the train state and, outside
    elastic mode, the stream position (elastic checkpoints carry no
    ``stream`` leaf: an elastic restore repartitions the stream)."""
    from ..models.convert import train_state_to_jax

    tree = train_state_to_jax(model, optimizer)
    if consumed is not None:
        tree["stream"] = np.asarray([consumed], np.int64)
    return tree


def restore(manager, model, optimizer, with_stream: bool = True):
    """``(step, stream position)`` of the newest committed checkpoint,
    loaded into ``model``/``optimizer``; ``(None, None)`` without one.
    A checkpoint without the stream leaf restores with position None.
    ``with_stream=False`` skips the probe: elastic checkpoints never
    carry the leaf, and the probe would read every shard before the miss
    shows."""
    from ..checkpoint import MissingLeaf
    from ..models.convert import train_state_from_jax, train_state_to_jax

    template = train_state_to_jax(model, optimizer, device="meta")
    pos = None
    if not with_stream:
        step, tree = manager.restore_latest(template)
    else:
        try:
            step, tree = manager.restore_latest(
                dict(template, stream=np.zeros(1, np.int64)))
            pos = None if step is None else int(tree["stream"][0])
        except MissingLeaf:
            step, tree = manager.restore_latest(template)
    if step is not None:
        train_state_from_jax(tree, model, optimizer)
    return step, pos


_BCAST_ELEMS = 1 << 27   # float64 elements per state broadcast (1 GiB)


def _elastic_enabled() -> bool:
    from ..base import get_env

    return get_env("DMLC_ELASTIC", False) \
        and bool(get_env("DMLC_TRACKER_URI", ""))


class _ElasticTrainer:
    """The elastic half of the loop: tracker membership, host-collective
    gradient averaging, and the WorldResized recovery protocol (the JAX
    example's ``_ElasticTrainer``)."""

    def __init__(self, manager, model, optimizer):
        from ..base import get_env
        from ..parallel.overlap import GradientBucketer
        from ..telemetry import HeartbeatSender
        from ..tracker.client import TrackerClient

        self.client = TrackerClient().start()
        self.hb = HeartbeatSender(self.client, interval=1.0)
        self.manager = manager
        self.model = model
        self.optimizer = optimizer
        # overlapped gradient reduction (DMLC_COLL_OVERLAP=0 opts out):
        # buckets allreduce on a background thread while later leaves
        # are still copied off the card and packed; a WorldResized
        # raised on that thread re-raises at the join, inside the
        # recovery path.  In place (out=a) on the buckets the bucketer
        # owns
        self.bucketer = (
            GradientBucketer(lambda a: self.client.allreduce_sum(a, out=a))
            if get_env("DMLC_COLL_OVERLAP", True) else None)
        # the newest broadcast's bytes and seconds (restore on rank 0)
        self.last_sync: Optional[dict] = None

    @property
    def world(self):
        return (self.client.rank, self.client.world_size)

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.model.parameters()]

    def allreduce_grads(self, loss: float):
        """Average the gradients in ``p.grad`` (and the loss) over the
        elastic world through the host collective and write them back
        into ``p.grad`` in each parameter's dtype; returns ``(loss,
        gnorm)``, the global norm of the AVERAGED gradients in float64
        (so every rank reaches the same self-heal verdict).  Raises
        WorldResized on a membership change, with ``p.grad`` untouched."""
        w = float(self.client.world_size)
        grads = self._grads()
        if self.bucketer is not None:
            red_loss, red = self.bucketer.reduce_tree(
                (np.asarray([loss], np.float32), grads))
            gnorm = math.sqrt(sum(
                float(torch.sum(torch.square(r.double() / w))) for r in red))
            avg = [(r / w).to(g.dtype) for r, g in zip(red, grads)]
            loss = float(red_loss[0]) / w
        else:
            flat = np.concatenate(
                [g.detach().float().cpu().numpy().ravel() for g in grads]
                + [np.asarray([loss], np.float32)])
            total = self.client.allreduce_sum(flat)
            total /= w
            gnorm = float(np.sqrt(np.sum(np.square(total[:-1]),
                                         dtype=np.float64)))
            avg, pos = [], 0
            for g in grads:
                n = g.numel()
                avg.append(torch.from_numpy(total[pos:pos + n]).reshape(
                    g.shape).to(g.device, g.dtype))
                pos += n
            loss = float(total[-1])
        with torch.no_grad():
            for p, a in zip(self.model.parameters(), avg):
                if p.grad is None:
                    p.grad = a
                else:
                    p.grad.copy_(a)
        return loss, gnorm

    def _state_leaves(self, device):
        """The train state as ``train_state_to_jax``'s tree: its leaves in
        a fixed order (params, AdamW count, both moments) and spec."""
        from torch.utils import _pytree as pytree

        from ..models.convert import train_state_to_jax

        return pytree.tree_flatten(
            train_state_to_jax(self.model, self.optimizer, device=device))

    def _broadcast_state(self, done: int) -> int:
        """Make rank 0's (params, AdamW state, step) authoritative
        everywhere — the shared tail of resync and rollback.  Rank 0
        restores the newest COMMITTED checkpoint when there is one (its
        own memory otherwise) and broadcasts the state flattened in
        float64 with ``done`` last.  Returns the step."""
        from torch.utils import _pytree as pytree

        from ..models.convert import train_state_from_jax

        t0 = time.perf_counter()
        if self.client.rank == 0:
            step, _ = restore(self.manager, self.model, self.optimizer,
                              with_stream=False)
            if step is not None:
                done = step
        t_restore = time.perf_counter() - t0
        dev = next(self.model.parameters()).device
        shapes, spec = self._state_leaves("meta")
        n = sum(x.numel() for x in shapes)
        # shapes/dtypes are uniform.  The broadcast is a sum to which
        # every other rank adds -0.0, IEEE's exact additive identity (x +
        # -0.0 == x bit for bit, signed zeros included): rank 0's bits
        # arrive unchanged over the host collective's fastest path (the
        # shm group on one host), where the tree broadcast moves ~150
        # MB/s and a 5.8 GB state took 26-53 s
        flat = np.full(n + 1, -0.0)
        if self.client.rank == 0:
            leaves, _ = self._state_leaves(dev)
            pos = 0
            for x in leaves:
                k = x.numel()
                flat[pos:pos + k] = x.reshape(-1).double().cpu().numpy()
                pos += k
            flat[-1] = float(done)
        t1 = time.perf_counter()
        # a frame's length is an int32: pieces under 2 GiB, in place
        for lo in range(0, flat.size, _BCAST_ELEMS):
            piece = flat[lo:lo + _BCAST_ELEMS]
            self.client.allreduce_sum(piece, out=piece)
        t_bcast = time.perf_counter() - t1
        # every leaf is float32, bf16 or the int32 count, each exact in
        # float32: the narrowing on the host loses nothing
        out, pos = [], 0
        for x in shapes:
            k = x.numel()
            out.append(torch.from_numpy(flat[pos:pos + k].astype(np.float32))
                       .to(dev).reshape(x.shape).to(x.dtype))
            pos += k
        train_state_from_jax(pytree.tree_unflatten(out, spec), self.model,
                             self.optimizer)
        self.last_sync = {"bytes": int(flat.nbytes), "restore_s": t_restore,
                          "broadcast_s": t_bcast}
        print(f"state sync: {flat.nbytes} B broadcast in {t_bcast:.3f} s; "
              f"restore {t_restore:.3f} s (rank {self.client.rank})",
              flush=True)
        return int(flat[-1])

    def resync(self, feed, done: int) -> int:
        """WorldResized recovery: re-enter rendezvous, repartition the
        feed, then make rank 0's state authoritative everywhere.

        The interrupted step's allreduce may have completed on some
        ranks and not others, so replicas are one step apart until the
        broadcast realigns them.  May itself raise WorldResized
        (another resize mid-recovery); callers loop."""
        self.client.resize()
        feed.resize(self.world)
        done = self._broadcast_state(done)
        print(f"resized into rank {self.client.rank}/"
              f"{self.client.world_size} (gen {self.client.gen}); "
              f"resynced at step {done}", flush=True)
        return done

    def rollback(self, feed, done: int) -> int:
        """Self-heal rollback-and-replay: the restore/broadcast of resync
        with membership unchanged — only the state rolls back (and the
        data stream restarts; quarantined spans are skip-listed out by
        the readers).  The guard's verdict is deterministic on the
        allreduced loss, so every rank calls this on the same step."""
        feed.close()  # abandon the in-flight epoch before re-iterating
        done = self._broadcast_state(done)
        print(f"selfheal: rolled back to committed step {done} "
              f"(rank {self.client.rank})", flush=True)
        return done

    def close(self):
        if self.bucketer is not None:
            self.bucketer.close()
        self.hb.close()
        self.client.shutdown()


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
    ladder is skip → abort.

    Elastic mode (``DMLC_ELASTIC=1`` under a tracker, ``ckpt_dir``
    required): the process joins the tracker's world, reads partition
    ``(rank, world)`` of the shards, averages gradients over the host
    collective, and survives a resize in place — a collective that a
    lost or added peer interrupts raises WorldResized, and the loop
    re-enters rendezvous, repartitions the feed, restores the newest
    committed checkpoint on rank 0 and broadcasts it.  ``steps`` is then
    the absolute step to reach, and the losses are those of the steps
    this process trained, by step.

    The loop drives the step ledger itself: each step opens before the
    batch pull, so the feed's wait is billed to the step's feed-wait
    share, and ends after an applied update."""
    from .. import telemetry
    from ..base import DMLCError, resolve_device
    from ..checkpoint import CheckpointManager
    from ..feed import recordio_feed
    from ..models.convert import train_state_from_jax, train_state_to_jax
    from ..models.transformer import (adamw, init_params, make_train_step,
                                      train_flops_per_token)
    from ..resilience import SelfHealGuard
    from ..telemetry import goodput as goodput_ledger
    from ..tracker.client import WorldResized

    device = resolve_device(device)
    elastic = _elastic_enabled()
    if model is None:
        model = init_params(example_config(device),
                            torch.Generator(device).manual_seed(0), device)
    cfg = model.cfg
    optimizer = adamw(model.parameters(), LR)
    manager = start_at = pos = None
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir, max_to_keep=2)
        # params AND AdamW's moments and count travel together
        start_at, pos = restore(manager, model, optimizer,
                                with_stream=not elastic)
        if start_at is not None:
            print(f"resumed from step {start_at}", flush=True)

    trainer = None
    if elastic:
        if manager is None:
            raise DMLCError("elastic mode needs a checkpoint dir (a resize "
                            "restores from it)")
        trainer = _ElasticTrainer(manager, model, optimizer)
    # ledger=False: this loop drives the step ledger ITSELF so the batch
    # pull lands inside the step window — feed.wait is then billed to
    # the step's feed-wait share.  An elastic step's norm is that of the
    # AVERAGED gradients (the trainer's), so the local one is not taken
    step_fn = make_train_step(model, optimizer, ledger=False,
                              grad_norm=trainer is None)
    feed = recordio_feed(uri, batch_records=PER_PART,
                         max_bytes=(SEQ + 1) * 4, device=device,
                         world=trainer.world if trainer else None)
    telemetry.declare_flops_per_token(train_flops_per_token(cfg, SEQ))
    telemetry.declare_dtype(cfg.dtype)
    done = 0
    # non-elastic: done counts NEW steps; saves are numbered base + done
    base = start_at or 0
    # the feed is deterministic: replaying the persisted stream position
    # puts it where the saved run was (the step count where there is none)
    skip = base if pos is None else pos
    if elastic and start_at:
        # elastic restores are repartition points, not replays: done is
        # the ABSOLUTE step, so base is 0 (the reference keeps base at
        # start_at here and numbers every later step and save start_at
        # too high), and the stream restarts
        done = start_at
        base = skip = 0
    # without a checkpoint there is nothing to roll back to
    guard = SelfHealGuard(**({} if manager is not None
                             else {"max_rollbacks": 0}))
    # the rollback target before the first commit: the state training
    # started from, a host copy (the update is in place, so no reference
    # can stand in for it), dropped at the first commit; never captured
    # in elastic mode, whose rollback restores through the trainer
    genesis = ((train_state_to_jax(model, optimizer), skip)
               if trainer is None and manager is not None else None)

    # job-level goodput accounting: explicit enter() hooks mark what the
    # spans cannot see — the elastic recovery window (WorldResized raise
    # -> resync settled) and the self-heal rollback + replay.  The resize
    # path RE-ENTERS the interval it was in before the raise (e.g. a
    # feed wait), else the recovery leaks into idle/unattributed
    goodput_ledger.ledger()  # opt this process into goodput heartbeats
    resize_active = False    # a resize episode is open
    resize_prev = None       # override to restore when it settles
    rollback_until = None    # replaying until done reaches this step
    rollback_prev = None
    # done-value at the current stream's batch 0: "replay to step A" =
    # fast-forward (A - stream_base) batches of a fresh stream.  A
    # non-elastic stream starts at step 0; an elastic stream restarts at
    # each resync (the partitioning changed), so its base is that step
    stream_base = done if elastic else 0
    # exact stream position: batches consumed from the current
    # partitioning's sequence (a skip consumes a batch without advancing
    # `done`); `stream_gen` names the partitioning (bumped at each
    # elastic resync); `ckpt_consumed` snapshots the position at every
    # commit so a rollback replays the exact count
    consumed = 0
    stream_gen = 0
    ckpt_consumed = {}  # absolute committed step -> (stream_gen, consumed)

    def rollback_and_replay(done: int, base: int, stream_base: int):
        """``(done, skip, base, stream_base)`` after restoring the newest
        committed checkpoint (the genesis state before the first): the
        new step count, the batches a fresh stream must fast-forward (the
        position snapshotted at commit, else the step arithmetic), the
        base and the stream's base."""
        if trainer is not None:
            done = trainer.rollback(feed, done)
            snap = ckpt_consumed.get(done)
            if snap is not None and snap[0] == stream_gen:
                print(f"selfheal: replaying {snap[1]} batches", flush=True)
                return done, snap[1], base, stream_base
            if done >= stream_base:
                print(f"selfheal: replaying {done - stream_base} batches",
                      flush=True)
                return done, done - stream_base, base, stream_base
            # the restored state predates this stream (an older committed
            # step survived a resize): restart the stream at it
            return done, 0, base, done
        restored_step, stream_pos = restore(manager, model, optimizer)
        feed.close()  # abandon the in-flight epoch
        if restored_step is None:
            if genesis is None:
                raise DMLCError("selfheal: no committed checkpoint and no "
                                "genesis state to roll back to")
            train_state_from_jax(genesis[0], model, optimizer)
            print("selfheal: no committed checkpoint; rolling back to "
                  "the genesis state", flush=True)
            return 0, genesis[1], base, 0
        base = min(base, restored_step)
        snap = ckpt_consumed.get(restored_step)
        if snap is not None and snap[0] == stream_gen:
            replay = snap[1]
        elif stream_pos is not None:
            replay = stream_pos
        else:
            replay = restored_step  # a checkpoint without the position
        print(f"selfheal: rolled back to committed step {restored_step}; "
              f"replaying {replay} batches", flush=True)
        return restored_step - base, replay, base, 0

    losses = {}  # absolute step -> loss; a replay overwrites
    full_in_epoch = 0
    need_resync = False
    need_sync = trainer is not None
    loss = float("nan")
    it = iter(feed)
    try:
        while done < steps:
            # the step opens BEFORE the batch pull so the feed's consumer
            # wait (the feed.wait span) is billed to this step's
            # feed-wait share; skipped and tail batches abandon the open
            # step (the next step_begin unwinds it) and are never recorded
            telemetry.step_begin()
            try:
                if trainer is not None:
                    if need_resync:
                        done = trainer.resync(feed, done)
                        it = iter(feed)
                        stream_base = done  # repartitioned: fresh stream
                        stream_gen += 1    # old positions are incomparable
                        consumed = full_in_epoch = 0
                        # a resize landing mid-rollback-replay voids the
                        # replay plan: a leftover skip would drop
                        # never-trained batches from the fresh stream
                        skip = 0
                        need_resync = need_sync = False
                        if resize_active:
                            # generation settled: re-enter the pre-resize
                            # interval.  A voided rollback replay does NOT
                            # resume (skip was just reset): its episode
                            # ends with the resize
                            if resize_prev == "rollback_replay":
                                rollback_until = None
                                resize_prev = rollback_prev
                            goodput_ledger.enter(resize_prev)
                            resize_active = False
                    elif need_sync:
                        # the first broadcast of a process that starts or
                        # joins a world: a joiner meets the survivors'
                        # resync broadcast in the same collective
                        done = trainer._broadcast_state(done)
                        stream_base = done
                        need_sync = False
                    trainer.client.check_resized()
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
                verdict = []

                def accept(loss, gnorm) -> bool:
                    # asked between the gradients and the update (torch
                    # updates in place, so the guard decides first).  An
                    # elastic step averages the loss and gradients over
                    # the world first: every rank then sees one loss and
                    # norm and reaches one verdict.  A WorldResized
                    # raised here leaves the update unapplied
                    if trainer is not None:
                        loss, gnorm = trainer.allreduce_grads(float(loss))
                    verdict.append((float(loss), guard.observe(
                        float(loss), grad_norm=float(gnorm),
                        step=done + 1)))
                    return verdict[0][1] == "ok"

                with telemetry.annotate("train_step"):
                    step_fn(ids, labels, accept=accept)
                loss, action = verdict[0]
                if action == "skip":
                    continue
                if action == "rollback":
                    # rollback_replay covers the restore AND the
                    # re-executed steps: the override stays up until
                    # `done` regains this step
                    if rollback_until is None:
                        rollback_prev = goodput_ledger.enter(
                            "rollback_replay")
                    rollback_until = max(rollback_until or 0, done)
                    done, skip, base, stream_base = rollback_and_replay(
                        done, base, stream_base)
                    it = iter(feed)
                    consumed = full_in_epoch = 0  # the replay re-counts
                    continue
                if action == "abort":
                    guard.raise_abort(done + 1)
            except WorldResized:
                # recovery runs at the top of the next iteration (the
                # resync broadcast can itself hit another resize, and it
                # must run under this same handler)
                prev = goodput_ledger.enter("resize")
                if not resize_active:
                    # only the FIRST raise of an episode captures the
                    # pre-resize interval (a resize landing mid-resync
                    # re-raises here with the override already "resize")
                    resize_prev = prev
                    resize_active = True
                need_resync = True
                continue
            telemetry.step_end(tokens=float(ids.numel()))
            done += 1
            losses[base + done] = loss
            if rollback_until is not None and done >= rollback_until:
                # the replay caught back up: the lost work is repaid
                goodput_ledger.enter(rollback_prev)
                rollback_until = None
            if done % 10 == 0 or done == 1:
                print(f"step {base + done}: loss {loss:.4f}", flush=True)
            if manager is not None and done % SAVE_EVERY == 0:
                # every rank snapshots the stream position at the commit
                # (a later rollback replays exactly this count)
                ckpt_consumed[base + done] = (stream_gen, consumed)
                if trainer is None or trainer.client.rank == 0:
                    manager.save(base + done, train_state(
                        model, optimizer,
                        consumed if trainer is None else None))
                    genesis = None  # a committed checkpoint outranks it
        if manager is not None and done % SAVE_EVERY != 0 \
                and (trainer is None or trainer.client.rank == 0):
            manager.save(base + done, train_state(
                model, optimizer, consumed if trainer is None else None))
    finally:
        feed.close()
    if trainer is not None:
        trainer.close()
    st = feed.stats()
    print(f"final loss {loss:.4f}; feed moved "
          f"{st['bytes_to_device'] / 1e6:.1f} MB in "
          f"{st['batches']} batches", flush=True)
    led = telemetry.ledger().summary()
    if led:
        mfu = led.get("mfu")
        print(f"ledger: step p50 {led['step_time_p50'] * 1e3:.1f} ms, "
              f"p99 {led['step_time_p99'] * 1e3:.1f} ms, feed-wait "
              f"{led['feed_wait_fraction'] * 100:.0f}%, collective "
              f"exposed {led['collective_exposed_fraction'] * 100:.0f}%"
              f" / overlapped "
              f"{led['collective_overlapped_fraction'] * 100:.0f}%, "
              f"goodput {led.get('goodput_tokens_per_s', 0):,.0f} tok/s"
              + (f", MFU {mfu * 100:.1f}%" if mfu is not None else ""),
              flush=True)
    return [losses[k] for k in sorted(losses)]


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
