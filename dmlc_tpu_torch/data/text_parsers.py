"""LibSVM / CSV / LibFM text parsers producing RowBlockContainers (the
port of ``dmlc_tpu/data/text_parsers.py``).

Rebuild of reference src/data/libsvm_parser.h:35-90 (``label[:weight]
idx[:val]...``), src/data/csv_parser.h:43-102 (dense CSV with
``label_column``), src/data/libfm_parser.h:35-96 (``label[:weight]
field:idx:val...``).

``parse_chunk`` runs the host C++ core (``native``), which parses a chunk
in ``nthread`` threads at line boundaries with the GIL released.
``parse_chunk_plain`` is the plain version: Python ``float()`` per token,
then float32, the JAX package's Python route bit for bit.  The native
number scan adds digit by digit in double and is not correctly rounded,
so the two routes may differ in the last bit of a float32 (within 1 ulp).
A CSV delimiter that is blank or longer than one byte is beyond the
native scanner, which skips blanks: such a CSV parses through the plain
version, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..base import DMLCError, check
from ..param import Parameter, field
from .. import native
from .parser import TextParserBase, register_parser
from .row_block import RowBlockContainer, real_t
from ..io import input_split as isplit

__all__ = ["LibSVMParser", "CSVParser", "LibFMParser", "CSVParserParam"]


class LibSVMParser(TextParserBase):
    """``label[:weight] index[:value] ...``; omitted value => implicit 1.0
    (libsvm_parser.h:35-90)."""

    def parse_chunk(self, data, out: RowBlockContainer) -> None:
        try:
            parsed = native.parse_libsvm(data, nthread=self._nthread)
        except ValueError as e:
            raise DMLCError(str(e)) from e
        out.push_arrays(
            labels=parsed["labels"],
            offsets=parsed["offsets"],
            index=parsed["index"].astype(out._idt, copy=False),
            value=parsed["value"],
            weight=parsed["weights"],
        )

    def parse_chunk_plain(self, data, out: RowBlockContainer) -> None:
        data = bytes(data)
        labels = []
        weights = []
        indices = []
        values = []
        offsets = [0]
        any_weight = False
        for line in data.split(b"\n"):
            line = line.strip()
            if not line:
                continue
            toks = line.split()
            head, sep, w = toks[0].partition(b":")
            labels.append(float(head))
            if sep:
                weights.append(float(w))
                any_weight = True
            for tok in toks[1:]:
                i, sep, v = tok.partition(b":")
                indices.append(int(i))
                values.append(float(v) if sep else 1.0)
            offsets.append(len(indices))
        # weights only kept when every row has one (row_block.h GetBlock
        # NULLs the weight pointer on size mismatch)
        if any_weight and len(weights) != len(labels):
            any_weight = False
        out.push_arrays(
            labels=np.asarray(labels, dtype=real_t),
            offsets=np.asarray(offsets, dtype=np.uint64),
            index=np.asarray(indices, dtype=out._idt),
            value=np.asarray(values, dtype=real_t),
            weight=np.asarray(weights, dtype=real_t) if any_weight else None,
        )


class CSVParserParam(Parameter):
    """csv_parser.h:22-32."""

    format = field(str, "csv")
    label_column = field(int, -1).set_describe("column index of the label; -1 = no label (0.0)")
    delimiter = field(str, ",").set_describe("field delimiter")


class CSVParser(TextParserBase):
    """Dense CSV -> CSR with column indices (csv_parser.h:43-102)."""

    def __init__(self, source: isplit.InputSplit, args: Dict[str, str],
                 nthread=None):
        super().__init__(source, nthread=nthread)
        self.param = CSVParserParam()
        self.param.init(args)

    def parse_chunk(self, data, out: RowBlockContainer) -> None:
        delim = self.param.delimiter.encode()
        if len(delim) != 1 or delim in (b" ", b"\t", b"\r"):
            self.parse_chunk_plain(data, out)
            return
        try:
            arr = native.parse_csv(data, delim, nthread=self._nthread)
        except ValueError as e:
            raise DMLCError(str(e)) from e
        if arr.size:
            self._push_dense(arr, out)

    def parse_chunk_plain(self, data, out: RowBlockContainer) -> None:
        delim = self.param.delimiter.encode()
        lines = [ln for ln in bytes(data).split(b"\n") if ln.strip()]
        if not lines:
            return
        ncol = lines[0].count(delim) + 1
        # reference csv_parser.h CHECK-fails on ragged rows; validate per
        # line up front so the flat fast path can never reassign cells
        # across row boundaries
        for ln in lines:
            check(
                ln.count(delim) + 1 == ncol,
                f"CSV has inconsistent column counts: {ln[:80]!r}",
            )
        flat = delim.join(lines)
        try:
            arr = np.fromiter(
                map(float, flat.split(delim)), dtype=np.float64,
                count=len(lines) * ncol,
            )
        except ValueError as e:
            raise DMLCError(f"CSV: non-numeric cell: {e}") from e
        self._push_dense(arr.reshape(len(lines), ncol), out)

    def _push_dense(self, arr: np.ndarray, out: RowBlockContainer) -> None:
        nrow, ncol = arr.shape
        lc = self.param.label_column
        if lc >= 0:
            check(lc < ncol, f"label_column {lc} >= num columns {ncol}")
            labels = arr[:, lc].astype(real_t)
            feats = np.delete(arr, lc, axis=1)
        else:
            labels = np.zeros(nrow, dtype=real_t)
            feats = arr
        nfeat = feats.shape[1]
        index = np.tile(np.arange(nfeat, dtype=out._idt), nrow)
        offsets = np.arange(nrow + 1, dtype=np.uint64) * nfeat
        out.push_arrays(
            labels=labels,
            offsets=offsets,
            index=index,
            value=feats.astype(real_t).ravel(),
        )


class LibFMParser(TextParserBase):
    """``label[:weight] field:index:value ...`` (libfm_parser.h:35-96)."""

    def parse_chunk(self, data, out: RowBlockContainer) -> None:
        try:
            parsed = native.parse_libfm(data, nthread=self._nthread)
        except ValueError as e:
            raise DMLCError(str(e)) from e
        out.push_arrays(
            labels=parsed["labels"],
            offsets=parsed["offsets"],
            index=parsed["index"].astype(out._idt, copy=False),
            value=parsed["value"],
            weight=parsed["weights"],
            field=parsed["fields"].astype(out._idt, copy=False),
        )

    def parse_chunk_plain(self, data, out: RowBlockContainer) -> None:
        data = bytes(data)
        labels = []
        weights = []
        fields = []
        indices = []
        values = []
        offsets = [0]
        any_weight = False
        for line in data.split(b"\n"):
            line = line.strip()
            if not line:
                continue
            toks = line.split()
            head, sep, w = toks[0].partition(b":")
            labels.append(float(head))
            if sep:
                weights.append(float(w))
                any_weight = True
            for tok in toks[1:]:
                parts = tok.split(b":")
                check(len(parts) == 3, lambda t=tok: f"bad libfm triple {t!r}")
                fields.append(int(parts[0]))
                indices.append(int(parts[1]))
                values.append(float(parts[2]))
            offsets.append(len(indices))
        out.push_arrays(
            labels=np.asarray(labels, dtype=real_t),
            offsets=np.asarray(offsets, dtype=np.uint64),
            index=np.asarray(indices, dtype=out._idt),
            value=np.asarray(values, dtype=real_t),
            weight=np.asarray(weights, dtype=real_t) if any_weight else None,
            field=np.asarray(fields, dtype=out._idt),
        )


# ---- registrations (data.cc:150-158) -----------------------------------

def _nthread_arg(args):
    v = args.get("nthread")
    return int(v) if v else None


@register_parser("libsvm")
def _make_libsvm(uri, args, part_index, num_parts):
    src = isplit.create(uri, part_index, num_parts, "text")
    return LibSVMParser(src, nthread=_nthread_arg(args))


@register_parser("csv")
def _make_csv(uri, args, part_index, num_parts):
    src = isplit.create(uri, part_index, num_parts, "text")
    return CSVParser(src, args, nthread=_nthread_arg(args))


@register_parser("libfm")
def _make_libfm(uri, args, part_index, num_parts):
    src = isplit.create(uri, part_index, num_parts, "text")
    return LibFMParser(src, nthread=_nthread_arg(args))
