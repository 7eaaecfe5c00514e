"""Paged KV cache: block-granular storage for decode contexts.

Port of ``dmlc_tpu/serving/kv_cache.py`` (``BlockAllocator`` :51,
``PagedKVCache`` :137-528).  The bookkeeping is the same: a fixed pool of
``block_size``-token blocks handed out by a free-list allocator, and a
block table per sequence mapping its logical positions to physical
blocks.  Pool layout is the reference's, layer-major:

    k_pool / v_pool : [n_layers, n_blocks, block_size, n_heads, head_dim]

The data plane differs: the reference keeps a host (numpy) mirror plus a
device twin it re-uploads block by block (:427-478); here the pools live
ONLY on the device.  A prefill writes its K/V into them with an in-place
indexed assignment (:meth:`write`).  On the paged decode path the step
scatters its window in place inside the model's forward, and the cache
then only advances the committed lengths (:meth:`advance_many`); on the
gather path (``DMLC_SERVE_PAGED_ATTN=off``) :meth:`gather` builds the
dense view on the device with one indexed read per pool and the engine
writes every row's committed prefix back with one indexed assignment
per pool (the reference's ``write_many``, :462-478).  Each data-plane
call is split in two: the bookkeeping that yields host-side addresses
(:meth:`reserve`, :meth:`reserve_many`, :meth:`gather_plan`) and the
device work on them (:meth:`scatter`, :meth:`dense`), so a sharded
engine's follower ranks replay the controller's addresses on pools of
their own.

On a mesh (``mesh=``, sharded serving over ``torch.distributed``) the
pools hold this rank's heads, ``n_heads / tp`` of them, of its pp
stage's layers, ``n_layers / pp`` of them in the stage's local order
(local layer i is global layer ``s·L/P + i``); sp and ep replicate them.
:func:`kv_partition_spec` / :meth:`shard_gathered` follow the
reference's (:121-133, :573-590) on every mesh: a gathered view's batch
splits over dp, its heads over tp (the pools hold them split already),
nothing over pp, sp or ep.

Thread-safety: bookkeeping is lock-protected; the data plane assumes the
engine's single step thread.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..base import DMLCError, resolve_device
from ..concurrency import make_lock
from ..parallel.mesh import AXIS_DP, AXIS_PP, AXIS_TP

__all__ = ["BlockAllocator", "PagedKVCache", "kv_partition_spec"]


class BlockAllocator:
    """Free-list allocator over ``n_blocks`` fixed-size blocks.

    ``alloc_many`` is all-or-nothing and ``free`` validates the whole
    list before moving any block; a double free raises."""

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._in_use: set = set()
        self._lock = make_lock("BlockAllocator._lock")

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def n_in_use(self) -> int:
        with self._lock:
            return len(self._in_use)

    def alloc_many(self, n: int) -> Optional[List[int]]:
        """``n`` block ids, or None (and no state change) if fewer than
        ``n`` are free."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        with self._lock:
            if n > len(self._free):
                return None
            got = [self._free.pop() for _ in range(n)]
            self._in_use.update(got)
            return got

    def free(self, blocks: Sequence[int]) -> None:
        blocks = list(blocks)
        with self._lock:
            bad = [b for b in blocks if b not in self._in_use]
            if bad:
                raise DMLCError(f"double free / foreign blocks {bad} "
                                f"(in_use={len(self._in_use)})")
            for b in blocks:
                self._in_use.discard(b)
                self._free.append(b)


class _SeqEntry:
    __slots__ = ("blocks", "length")

    def __init__(self) -> None:
        self.blocks: List[int] = []
        self.length = 0


def kv_partition_spec(mesh) -> Optional[Tuple[Tuple[int, str], ...]]:
    """The placement of a gathered ``[L, B, T, H, D]`` view over ``mesh``
    (:121-133), as ``PARAM_SPECS`` writes one: ``(dimension, axis)``
    pairs, the batch over dp and the heads over tp, every other
    dimension replicated (pp, sp and ep place nothing).  None when the
    mesh offers neither (dp and tp both 1)."""
    dp = mesh.shape.get(AXIS_DP, 1)
    tp = mesh.shape.get(AXIS_TP, 1)
    if dp <= 1 and tp <= 1:
        return None
    return tuple((dim, axis) for dim, axis, n in ((1, AXIS_DP, dp),
                                                 (3, AXIS_TP, tp)) if n > 1)


class PagedKVCache:
    """Block-paged K/V pools on ``device`` for a set of live sequences:
    the card unless the caller names another device (``device="cpu"``
    for the plain versions; with a mesh, the mesh's device); with no
    card and no device it raises.  ``n_layers`` and ``n_heads`` are the
    model's; on a ``mesh`` the pools hold this rank's ``n_heads / tp``
    heads of its pp stage's ``n_layers / pp`` layers (the attribute
    ``n_layers`` is then the local count)."""

    def __init__(self, n_layers: int, n_heads: int, head_dim: int, *,
                 n_blocks: int = 256, block_size: int = 16,
                 dtype: torch.dtype = torch.float32, device=None,
                 mesh=None):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)

        def local(n: int, axis: str, what: str) -> int:
            parts = 1 if mesh is None else mesh.axis_size(axis)
            if int(n) % parts:
                raise DMLCError(f"{what}={n} does not split over "
                                f"{axis}={parts}")
            return int(n) // parts

        self.n_layers = local(n_layers, AXIS_PP, "n_layers")
        self.n_heads = local(n_heads, AXIS_TP, "n_heads")
        shape = (self.n_layers, self.n_blocks, self.block_size, self.n_heads,
                 int(head_dim))
        # dmlc-check: unguarded(data plane is single-step-thread by contract — class docstring)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        # dmlc-check: unguarded(data plane is single-step-thread by contract — class docstring)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self._alloc = BlockAllocator(self.n_blocks)
        self._seqs: Dict[int, _SeqEntry] = {}
        self._cached_tokens = 0
        self._lock = make_lock("PagedKVCache._lock")

    # ---- capacity arithmetic -------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.block_size)

    def can_reserve(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= self._alloc.n_free

    def fits_at_all(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= self.n_blocks

    # ---- sequence lifecycle --------------------------------------------
    def allocate(self, seq_id: int, n_tokens: int) -> bool:
        """Register ``seq_id`` with capacity for ``n_tokens``; False (and
        no state change) when the free list cannot cover it."""
        with self._lock:
            if seq_id in self._seqs:
                raise DMLCError(f"sequence {seq_id} already allocated")
            got = self._alloc.alloc_many(self.blocks_for(n_tokens))
            if got is None:
                return False
            ent = _SeqEntry()
            ent.blocks = got
            self._seqs[seq_id] = ent
        return True

    def extend(self, seq_id: int, n_tokens: int = 1) -> bool:
        """Ensure capacity for ``n_tokens`` more tokens; False when the
        pool is exhausted (the caller evicts and retries)."""
        with self._lock:
            ent = self._seq(seq_id)
            need = self.blocks_for(ent.length + n_tokens) - len(ent.blocks)
            if need <= 0:
                return True
            got = self._alloc.alloc_many(need)
            if got is None:
                return False
            ent.blocks.extend(got)
        return True

    def extend_many(self, seq_ids: Sequence[int], n_tokens: int = 1) -> bool:
        """Reserve ``n_tokens`` more per sequence for a whole decode batch,
        all or nothing; False means no state changed."""
        with self._lock:
            ents = [self._seq(s) for s in seq_ids]
            needs = [self.blocks_for(e.length + n_tokens) - len(e.blocks)
                     for e in ents]
            total = sum(n for n in needs if n > 0)
            if total > self._alloc.n_free:
                return False
            for ent, need in zip(ents, needs):
                if need > 0:
                    ent.blocks.extend(self._alloc.alloc_many(need))
        return True

    def free(self, seq_id: int) -> None:
        """Return the sequence's blocks (freeing an unknown seq is a
        no-op, so finish and preempt paths never double-free)."""
        with self._lock:
            ent = self._seqs.pop(seq_id, None)
            if ent is None:
                return
            self._cached_tokens -= ent.length
            self._alloc.free(ent.blocks)

    def length(self, seq_id: int) -> int:
        with self._lock:
            return self._seq(seq_id).length

    def block_table(self, seq_id: int) -> List[int]:
        with self._lock:
            return list(self._seq(seq_id).blocks)

    def live_sequences(self) -> List[int]:
        with self._lock:
            return list(self._seqs)

    def _seq(self, seq_id: int) -> _SeqEntry:
        ent = self._seqs.get(seq_id)
        if ent is None:
            raise DMLCError(f"unknown sequence {seq_id}")
        return ent

    def _reserve(self, seq_id: int, n_tokens: int, start: Optional[int]
                 ) -> Tuple[List[int], int]:
        """Advance ``seq_id``'s length over ``n_tokens`` written at
        ``start`` (default: the current length); returns (blocks, start).
        Writing past the reservation raises rather than growing."""
        with self._lock:
            ent = self._seq(seq_id)
            pos = ent.length if start is None else int(start)
            end = pos + n_tokens
            if self.blocks_for(end) > len(ent.blocks):
                raise DMLCError(
                    f"write past reservation: seq {seq_id} end={end} "
                    f"blocks={len(ent.blocks)}x{self.block_size}")
            new_len = max(ent.length, end)
            self._cached_tokens += new_len - ent.length
            ent.length = new_len
            return list(ent.blocks), pos

    def _addresses(self, blocks: List[int], pos: int, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        p = torch.arange(pos, pos + n)
        blk = torch.tensor(blocks, dtype=torch.long)[p // self.block_size]
        return blk, p % self.block_size

    # ---- data plane -----------------------------------------------------
    def reserve(self, seq_id: int, n_tokens: int,
                start: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Commit ``n_tokens`` of ``seq_id`` at ``start`` (default: its
        length) in the bookkeeping and return where they go: ``(block,
        slot)`` host int64 tensors of ``n_tokens`` entries for
        :meth:`scatter`."""
        blocks, pos = self._reserve(seq_id, n_tokens, start)
        return self._addresses(blocks, pos, n_tokens)

    def reserve_many(self, counts: Sequence[Tuple[int, int]]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`reserve` of ``n`` tokens at the current length of each
        ``(seq_id, n)``, the addresses concatenated in that order."""
        blks, slots = [], []
        for seq_id, n in counts:
            blk, slot = self.reserve(seq_id, n)
            blks.append(blk)
            slots.append(slot)
        if not blks:
            return (torch.zeros(0, dtype=torch.long),
                    torch.zeros(0, dtype=torch.long))
        return torch.cat(blks), torch.cat(slots)

    def scatter(self, blk: torch.Tensor, slot: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor) -> None:
        """Write ``k/v [L, N, H, D]`` (on the cache's device) at the
        ``N`` addresses, one in-place indexed assignment per pool."""
        blk, slot = blk.to(self.device), slot.to(self.device)
        self.k_pool[:, blk, slot] = k.to(self.k_pool.dtype)
        self.v_pool[:, blk, slot] = v.to(self.v_pool.dtype)

    def write(self, seq_id: int, k: torch.Tensor, v: torch.Tensor,
              start: Optional[int] = None) -> None:
        """Write ``k/v [L, T, H, D]`` (on the cache's device) at token
        offset ``start`` with one in-place indexed assignment per pool."""
        self.scatter(*self.reserve(seq_id, k.shape[1], start), k, v)

    def advance_many(self, counts: Sequence[Tuple[int, int]]) -> None:
        """Commit ``n`` tokens per ``(seq_id, n)`` whose K/V the decode
        step already scattered into the pools: bookkeeping only."""
        for seq_id, n in counts:
            self._reserve(seq_id, n, None)

    def block_tables(self, seq_ids: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(tables [B, W] int32, lengths [B] int32)`` on the host;
        ``W`` is the largest owned-block count, rows padded with block 0
        (the mask keeps padded entries unreachable)."""
        with self._lock:
            ents = [self._seq(s) for s in seq_ids]
            tables = [list(e.blocks) for e in ents]
            lens = [e.length for e in ents]
        w = max((len(t) for t in tables), default=0) or 1
        out = torch.zeros((len(tables), w), dtype=torch.int32)
        for i, t in enumerate(tables):
            out[i, :len(t)] = torch.tensor(t, dtype=torch.int32)
        return out, torch.tensor(lens, dtype=torch.int32)

    def block_tables_array(self, seq_ids: Sequence[int]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`block_tables` on the cache's device."""
        tables, lengths = self.block_tables(seq_ids)
        return tables.to(self.device), lengths.to(self.device)

    def gather_plan(self, seq_ids: Sequence[int], *,
                    pad_len: Optional[int] = None,
                    pad_batch: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The host side of :meth:`gather`: ``(idx [B, nb] int64, valid
        [B, nb] bool, lengths [B] int32)``, each row's first blocks and
        which of them it uses; ``nb`` whole blocks make the view's ``T``
        (see :meth:`gather` for ``pad_len`` and ``pad_batch``)."""
        with self._lock:
            ents = [self._seq(s) for s in seq_ids]
            tables = [list(e.blocks) for e in ents]
            lens = [e.length for e in ents]
        bs = self.block_size
        need = max(self.blocks_for(max(lens, default=0)) * bs, bs)
        if pad_len is not None:
            # an explicit pad_len pins the view's shape; widening it
            # silently would defeat that, so insufficiency is loud
            if pad_len % bs:
                raise ValueError(f"pad_len {pad_len} not a multiple of "
                                 f"block_size {bs}")
            if pad_len < need:
                raise ValueError(f"pad_len {pad_len} < required {need}")
            need = pad_len
        b = max(pad_batch or 0, len(seq_ids))
        nb = need // bs
        idx = torch.zeros((b, nb), dtype=torch.long)
        valid = torch.zeros((b, nb), dtype=torch.bool)
        for i, (table, n) in enumerate(zip(tables, lens)):
            used = self.blocks_for(n)
            idx[i, :used] = torch.tensor(table[:used], dtype=torch.long)
            valid[i, :used] = True
        lengths = torch.zeros(b, dtype=torch.int32)
        lengths[:len(lens)] = torch.tensor(lens, dtype=torch.int32)
        return idx, valid, lengths

    def dense(self, idx: torch.Tensor, valid: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device side of :meth:`gather`: k/v ``[L, B, nb·block_size,
        H, D]``, one indexed read per pool, blocks past a row's use
        zeroed."""
        idx, valid = idx.to(self.device), valid.to(self.device)
        b, nb = idx.shape

        def view(pool: torch.Tensor) -> torch.Tensor:
            out = pool[:, idx]                       # [L, B, nb, bs, H, D]
            out.masked_fill_(~valid[None, :, :, None, None, None], 0)
            return out.reshape(self.n_layers, b, nb * self.block_size,
                               *pool.shape[3:])

        return view(self.k_pool), view(self.v_pool)

    def gather(self, seq_ids: Sequence[int], *, pad_len: Optional[int] = None,
               pad_batch: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Dense padded view for a decode batch (:530-571), on the pools'
        device: ``(k, v, lengths)`` with k/v ``[L, B, T, H, D]`` and
        lengths ``[B] int32``.  ``T`` is ``pad_len`` or the longest
        length rounded up to a whole block (one block at least); ``B``
        is ``pad_batch`` or ``len(seq_ids)``, extra rows zero with
        length 0.  Whole blocks are copied by one indexed read per pool,
        so slots in [length, T) hold whatever their block holds; blocks
        past a row's length are zero."""
        idx, valid, lengths = self.gather_plan(seq_ids, pad_len=pad_len,
                                               pad_batch=pad_batch)
        k, v = self.dense(idx, valid)
        return k, v, lengths.to(self.device)

    def shard_gathered(self, k: torch.Tensor, v: torch.Tensor):
        """This rank's part of a gathered view over the cache's mesh
        (:573-593): the view's rows for its dp coordinate, when the batch
        divides dp; otherwise (the reference's fallback, :587-589), and
        with no mesh or a mesh :func:`kv_partition_spec` gives no
        placement, the view whole.  The heads and, on a pp mesh, the
        layers are this rank's already: the pools hold its heads of its
        stage's layers."""
        if self.mesh is None or kv_partition_spec(self.mesh) is None:
            return k, v
        dp = self.mesh.axis_size(AXIS_DP)
        if k.shape[1] % dp:
            return k, v
        r = self.mesh.axis_rank(AXIS_DP)
        return k.chunk(dp, dim=1)[r], v.chunk(dp, dim=1)[r]

    # ---- observability --------------------------------------------------
    def stats(self) -> Dict[str, float]:
        with self._lock:
            live = len(self._seqs)
            tokens = self._cached_tokens
            in_use = self._alloc.n_in_use
        return {
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "blocks_in_use": in_use,
            "blocks_free": self.n_blocks - in_use,
            "live_sequences": live,
            "cached_tokens": tokens,
            "occupancy": in_use / self.n_blocks,
            "waste_tokens": in_use * self.block_size - tokens,
        }
