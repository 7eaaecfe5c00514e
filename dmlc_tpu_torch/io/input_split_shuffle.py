"""Coarse-grained global shuffle over sub-splits (the port of
``dmlc_tpu/io/input_split_shuffle.py``).

Rebuild of reference include/dmlc/input_split_shuffle.h:23-137: each logical
partition is divided into ``num_shuffle_parts`` sub-splits which are visited
in a freshly shuffled order every epoch. This is the epoch-shuffle mechanism
for formats without an index file.
"""

from __future__ import annotations

import random
from typing import List, Optional

from ..base import check
from . import input_split as isplit

__all__ = ["InputSplitShuffle", "create_shuffled"]


class InputSplitShuffle(isplit.InputSplit):
    KRAND_MAGIC = 127  # input_split_shuffle.h seed mix

    def __init__(
        self,
        uri: str,
        part_index: int,
        num_parts: int,
        type: str = "text",
        num_shuffle_parts: int = 4,
        shuffle_seed: int = 0,
    ):
        check(num_shuffle_parts >= 1, "num_shuffle_parts must be >= 1")
        self._subs: List[isplit.InputSplit] = []
        for i in range(num_shuffle_parts):
            sub = isplit.create(
                uri,
                part_index * num_shuffle_parts + i,
                num_parts * num_shuffle_parts,
                type=type,
                threaded=False,
            )
            self._subs.append(sub)
        self._rng = random.Random(self.KRAND_MAGIC + shuffle_seed)
        self._order = list(range(num_shuffle_parts))
        self._rng.shuffle(self._order)
        self._cursor = 0

    def next_record(self) -> Optional[memoryview]:
        while self._cursor < len(self._order):
            rec = self._subs[self._order[self._cursor]].next_record()
            if rec is not None:
                return rec
            self._cursor += 1
        return None

    def next_chunk(self) -> Optional[memoryview]:
        while self._cursor < len(self._order):
            chunk = self._subs[self._order[self._cursor]].next_chunk()
            if chunk is not None:
                return chunk
            self._cursor += 1
        return None

    def before_first(self) -> None:
        # reshuffle visit order each epoch (input_split_shuffle.h:117-137)
        self._rng.shuffle(self._order)
        for s in self._subs:
            s.before_first()
        self._cursor = 0

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        n = len(self._subs)
        for i, s in enumerate(self._subs):
            s.reset_partition(part_index * n + i, num_parts * n)
        self._rng.shuffle(self._order)
        self._cursor = 0

    def hint_chunk_size(self, chunk_size: int) -> None:
        for s in self._subs:
            s.hint_chunk_size(chunk_size)

    def get_total_size(self) -> int:
        return self._subs[0].get_total_size()

    def close(self) -> None:
        for s in self._subs:
            if hasattr(s, "close"):
                s.close()


def create_shuffled(
    uri: str,
    part_index: int,
    num_parts: int,
    type: str = "text",
    num_shuffle_parts: int = 4,
    shuffle_seed: int = 0,
) -> isplit.InputSplit:
    """Factory analog of InputSplitShuffle::Create (input_split_shuffle.h:139+).
    num_shuffle_parts == 1 degrades to a plain split."""
    if num_shuffle_parts == 1:
        return isplit.create(uri, part_index, num_parts, type=type)
    return InputSplitShuffle(
        uri, part_index, num_parts, type, num_shuffle_parts, shuffle_seed
    )
