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
indexed assignment (:meth:`write`), a decode step scatters its window in
place inside the model's forward, and the cache then only advances the
committed lengths (:meth:`advance_many`).  The gather view and its mesh
placement (``gather``/``shard_gathered``) serve the sharded route and
come with it in a later slice.

Thread-safety: bookkeeping is lock-protected; the data plane assumes the
engine's single step thread.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..base import DMLCError, resolve_device

__all__ = ["BlockAllocator", "PagedKVCache"]


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
        self._lock = threading.Lock()

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


class PagedKVCache:
    """Block-paged K/V pools on ``device`` for a set of live sequences:
    the card unless the caller names another device (``device="cpu"``
    for the plain versions); with no card and no device it raises."""

    def __init__(self, n_layers: int, n_heads: int, head_dim: int, *,
                 n_blocks: int = 256, block_size: int = 16,
                 dtype: torch.dtype = torch.float32, device=None):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_layers = int(n_layers)
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.device = resolve_device(device)
        shape = (self.n_layers, self.n_blocks, self.block_size, int(n_heads),
                 int(head_dim))
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self._alloc = BlockAllocator(self.n_blocks)
        self._seqs: Dict[int, _SeqEntry] = {}
        self._cached_tokens = 0
        self._lock = threading.Lock()

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

    # ---- data plane -----------------------------------------------------
    def write(self, seq_id: int, k: torch.Tensor, v: torch.Tensor,
              start: Optional[int] = None) -> None:
        """Write ``k/v [L, T, H, D]`` (on the cache's device) at token
        offset ``start`` with one in-place indexed assignment per pool."""
        t = k.shape[1]
        blocks, pos = self._reserve(seq_id, t, start)
        p = torch.arange(pos, pos + t)
        blk = torch.tensor(blocks, dtype=torch.long)[p // self.block_size]
        slot = p % self.block_size
        blk, slot = blk.to(self.device), slot.to(self.device)
        self.k_pool[:, blk, slot] = k.to(self.k_pool.dtype)
        self.v_pool[:, blk, slot] = v.to(self.v_pool.dtype)

    def advance_many(self, counts: Sequence[Tuple[int, int]]) -> None:
        """Commit ``n`` tokens per ``(seq_id, n)`` whose K/V the decode
        step already scattered into the pools: bookkeeping only."""
        for seq_id, n in counts:
            self._reserve(seq_id, n, None)

    def block_tables_array(self, seq_ids: Sequence[int]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(tables [B, W] int32, lengths [B] int32)`` on the cache's
        device; ``W`` is the largest owned-block count, rows padded with
        block 0 (the mask keeps padded entries unreachable)."""
        with self._lock:
            ents = [self._seq(s) for s in seq_ids]
            tables = [list(e.blocks) for e in ents]
            lens = [e.length for e in ents]
        w = max((len(t) for t in tables), default=0) or 1
        out = torch.zeros((len(tables), w), dtype=torch.int32)
        for i, t in enumerate(tables):
            out[i, :len(t)] = torch.tensor(t, dtype=torch.int32)
        return (out.to(self.device),
                torch.tensor(lens, dtype=torch.int32).to(self.device))

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
