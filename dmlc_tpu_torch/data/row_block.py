"""Sparse-row data structures: Row, RowBlock, RowBlockContainer (the port
of ``dmlc_tpu/data/row_block.py``).

Rebuild of reference include/dmlc/data.h:69-214 (Row/RowBlock zero-copy CSR
views) and src/data/row_block.h:26-205 (owning growable container with
binary Save/Load).  Arrays are numpy: the feed packs them into fixed-shape
batches (``feed.pack_rowblock``) on their way to the card.

Binary Save/Load is wire-compatible with the reference
(row_block.h:183-203): offset/label/weight/field/index/value as u64-length-
prefixed vectors, then max_field/max_index as raw IndexType scalars.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..base import check
from .. import serializer as ser

__all__ = ["Row", "RowBlock", "RowBlockContainer", "real_t", "index_t"]

# data.h:23-29 — real_t = float32, default index_t = uint32
real_t = np.float32
index_t = np.uint32


class Row:
    """A zero-copy view of one instance (data.h:69-148)."""

    __slots__ = ("label", "weight", "qid", "field", "index", "value")

    def __init__(self, label, weight, qid, field, index, value):
        self.label = label
        self.weight = weight
        self.qid = qid
        self.field = field
        self.index = index
        self.value = value

    @property
    def length(self) -> int:
        return len(self.index)

    def get_value(self, i: int) -> float:
        """Safe even when value is None (implicit 1.0, data.h:110-113)."""
        return 1.0 if self.value is None else float(self.value[i])

    def get_weight(self) -> float:
        return 1.0 if self.weight is None else float(self.weight)

    def sdot(self, dense_weight: np.ndarray) -> float:
        """Sparse dot with a dense vector (data.h:134-148)."""
        check(
            self.length == 0 or int(self.index.max()) < len(dense_weight),
            "feature index exceeds bound",
        )
        if self.value is None:
            return float(dense_weight[self.index].sum())
        return float((dense_weight[self.index] * self.value).sum())


class RowBlock:
    """CSR batch view (data.h:160-214)."""

    __slots__ = ("offset", "label", "weight", "qid", "field", "index", "value")

    def __init__(
        self,
        offset: np.ndarray,
        label: np.ndarray,
        index: np.ndarray,
        value: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        qid: Optional[np.ndarray] = None,
        field: Optional[np.ndarray] = None,
    ):
        self.offset = offset
        self.label = label
        self.weight = weight
        self.qid = qid
        self.field = field
        self.index = index
        self.value = value

    @property
    def size(self) -> int:
        return len(self.offset) - 1

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: int) -> Row:
        check(0 <= i < self.size, "row index out of range")
        lo, hi = int(self.offset[i]), int(self.offset[i + 1])
        return Row(
            label=float(self.label[i]) if self.label is not None else 0.0,
            weight=float(self.weight[i]) if self.weight is not None else None,
            qid=int(self.qid[i]) if self.qid is not None else None,
            field=self.field[lo:hi] if self.field is not None else None,
            index=self.index[lo:hi],
            value=self.value[lo:hi] if self.value is not None else None,
        )

    def slice(self, begin: int, end: int) -> "RowBlock":
        """Sub-block view sharing storage (data.h:189-208)."""
        check(0 <= begin <= end <= self.size, "bad slice range")
        return RowBlock(
            offset=self.offset[begin : end + 1],
            label=self.label[begin:end],
            weight=self.weight[begin:end] if self.weight is not None else None,
            qid=self.qid[begin:end] if self.qid is not None else None,
            field=self.field,
            index=self.index,
            value=self.value,
        )

    def mem_cost_bytes(self) -> int:
        """Approximate memory cost (data.h:336-361)."""
        cost = self.offset.nbytes + self.label.nbytes
        ndata = int(self.offset[-1]) - int(self.offset[0])
        for arr in (self.weight, self.qid):
            if arr is not None:
                cost += arr.nbytes
        for arr in (self.field, self.index, self.value):
            if arr is not None:
                cost += ndata * arr.itemsize
        return cost

    def __iter__(self):
        for i in range(self.size):
            yield self[i]


class RowBlockContainer:
    """Owning growable CSR container (src/data/row_block.h:26-205).

    Storage is segment-based: each push appends numpy arrays; get_block
    concatenates once.  This keeps the parse hot path free of
    numpy→list→numpy round trips (the native parsers hand whole chunks
    as arrays)."""

    _FIELDS = ("label", "weight", "qid", "field", "index", "value")

    def __init__(self, index_dtype=index_t):
        self._idt = np.dtype(index_dtype)
        self.clear()

    def clear(self) -> None:
        self._segs = {k: [] for k in self._FIELDS}
        self._off_segs: list = []
        self._nrows = 0
        self._nnz = 0
        self.max_field = 0
        self.max_index = 0

    @property
    def size(self) -> int:
        return self._nrows

    def mem_cost_bytes(self) -> int:
        return 8 * (self._nrows + 1) + 4 * self._nrows + 8 * self._nnz

    def push(
        self,
        label: float,
        index: Sequence[int],
        value: Optional[Sequence[float]] = None,
        weight: Optional[float] = None,
        qid: Optional[int] = None,
        field: Optional[Sequence[int]] = None,
    ) -> None:
        """Push one row (row_block.h:110-140); tracks max_index/max_field."""
        self.push_arrays(
            labels=np.asarray([label], dtype=real_t),
            offsets=np.asarray([0, len(index)], dtype=np.uint64),
            index=np.asarray(index, dtype=self._idt),
            value=None if value is None else np.asarray(value, dtype=real_t),
            weight=None if weight is None else np.asarray([weight], real_t),
            qid=None if qid is None else np.asarray([qid], np.uint64),
            field=None if field is None else np.asarray(field, self._idt),
        )

    def push_arrays(
        self,
        labels: np.ndarray,
        offsets: np.ndarray,
        index: np.ndarray,
        value: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        field: Optional[np.ndarray] = None,
        qid: Optional[np.ndarray] = None,
    ) -> None:
        """Bulk push of a parsed chunk (vectorized analog of
        Push(RowBlock), row_block.h:142-179)."""
        self._off_segs.append(
            np.asarray(offsets[1:], np.uint64) + np.uint64(self._nnz))
        self._segs["label"].append(np.asarray(labels, real_t))
        self._segs["index"].append(np.asarray(index, self._idt))
        self._nrows += len(labels)
        self._nnz += len(index)
        if index.size:
            self.max_index = max(self.max_index, int(index.max()))
        if value is not None:
            self._segs["value"].append(np.asarray(value, real_t))
        if weight is not None:
            self._segs["weight"].append(np.asarray(weight, real_t))
        if qid is not None:
            self._segs["qid"].append(np.asarray(qid, np.uint64))
        if field is not None:
            field = np.asarray(field, self._idt)
            self._segs["field"].append(field)
            if field.size:
                self.max_field = max(self.max_field, int(field.max()))

    # read-only views (the reference exposes its vectors publicly,
    # row_block.h:30-44)
    @property
    def offset(self):
        out = np.empty(self._nrows + 1, np.uint64)
        out[0] = 0
        if self._off_segs:
            np.concatenate(self._off_segs, out=out[1:])
        return out.tolist()

    @property
    def label(self) -> np.ndarray:
        return self._cat("label", real_t)

    @property
    def index(self) -> np.ndarray:
        return self._cat("index", self._idt)

    @property
    def value(self) -> np.ndarray:
        return self._cat("value", real_t)

    @property
    def weight(self) -> np.ndarray:
        return self._cat("weight", real_t)

    @property
    def field(self) -> np.ndarray:
        return self._cat("field", self._idt)

    def _cat(self, name: str, dtype) -> np.ndarray:
        segs = self._segs[name]
        if not segs:
            return np.empty(0, dtype)
        if len(segs) == 1:
            return np.asarray(segs[0], dtype)
        return np.concatenate(segs).astype(dtype, copy=False)

    def get_block(self) -> RowBlock:
        """Freeze into a RowBlock view (row_block.h:87-108)."""
        n = self._nrows
        nval = self._nnz
        offset = np.empty(n + 1, np.uint64)
        offset[0] = 0
        if self._off_segs:
            np.concatenate(self._off_segs, out=offset[1:])
        weight = self._cat("weight", real_t)
        qid = self._cat("qid", np.uint64)
        field = self._cat("field", self._idt)
        value = self._cat("value", real_t)
        return RowBlock(
            offset=offset,
            label=self._cat("label", real_t),
            weight=weight if len(weight) == n and n else None,
            qid=qid if len(qid) == n and n else None,
            field=field if len(field) == nval and nval else None,
            index=self._cat("index", self._idt),
            value=value if len(value) == nval and nval else None,
        )

    # ---- binary round trip, reference wire format (row_block.h:183-203)
    def save(self, strm) -> None:
        offset = np.empty(self._nrows + 1, np.uint64)
        offset[0] = 0
        if self._off_segs:
            np.concatenate(self._off_segs, out=offset[1:])
        ser.write_array(strm, offset)
        ser.write_array(strm, self._cat("label", real_t))
        ser.write_array(strm, self._cat("weight", real_t))
        ser.write_array(strm, self._cat("field", self._idt))
        ser.write_array(strm, self._cat("index", self._idt))
        ser.write_array(strm, self._cat("value", real_t))
        strm.write(np.asarray([self.max_field, self.max_index], dtype=self._idt).tobytes())

    def load(self, strm) -> bool:
        """Returns False at clean EOF (row_block.h:195-203)."""
        head = strm.read(8)
        if len(head) < 8:
            return False
        import struct as _struct

        (n,) = _struct.unpack("<Q", head)
        self.clear()
        offset = np.frombuffer(strm.read_exact(8 * n), dtype=np.uint64)
        label = ser.read_array(strm, real_t)
        weight = ser.read_array(strm, real_t)
        field = ser.read_array(strm, self._idt)
        index = ser.read_array(strm, self._idt)
        value = ser.read_array(strm, real_t)
        self._off_segs = [offset[1:].copy()] if n > 1 else []
        self._segs["label"] = [label]
        self._segs["weight"] = [weight] if weight.size else []
        self._segs["field"] = [field] if field.size else []
        self._segs["index"] = [index]
        self._segs["value"] = [value] if value.size else []
        self._nrows = len(label)
        self._nnz = len(index)
        tail = np.frombuffer(strm.read_exact(2 * self._idt.itemsize), dtype=self._idt)
        self.max_field, self.max_index = int(tail[0]), int(tail[1])
        return True
