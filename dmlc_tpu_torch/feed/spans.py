"""RecordIO chunk scans and the row gathers of the device feed (the port
of the span functions of ``dmlc_tpu/feed/device_feed.py``).

A chunk scan yields ``(offset, len, flag)`` triples, one per logical
record: flags 0/1 plain (direct payload / escaped multi-segment region),
2/3 checksummed (CRC32C-verified in the scan), and typed rejects with
flag >= 8 covering [begin, resync point) of every corruption.

The hot path is the host C++ core (``native``, a copy of the JAX
package's): one fused scan-and-verify call per chunk
(:func:`scan_chunk`), one pad-pack call per span group
(:func:`gather_rows_into`) and one pack call per (chunk, batch)
(``native.pack_spans``), each with the GIL released.  The numpy and Python
walkers beside them (``*_plain``) are the plain versions, bit-identical
to the JAX package's Python twins; the tests hold the two routes to the
same triples and bytes, and nothing calls the plain versions on the
feed's path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import native, telemetry
from ..io import integrity
from ..io.recordio import (CRC_BIT, HEAD_CFLAGS, KMAGIC, _MAGIC_BYTES, _U32,
                           decode_flag, decode_length, find_next_record_head,
                           stored_crc)

__all__ = ["chunk_spans", "scan_chunk", "scan_chunk_plain", "verify_spans",
           "reassemble_region", "chunk_record_views", "gather_rows_into",
           "gather_rows_into_plain", "pack_spans_plain"]

#: reject kinds (flag >= 8) and the message each reports; kind 12 names
#: the offending cflag read back from the chunk
_REJECT_WHAT = {
    8: "bad magic",
    9: "truncated payload",
    10: "torn multi-segment record",
    11: "missing end segment",
    13: "crc32c mismatch",
    14: "torn tail (sub-word remainder)",
}


def scan_chunk(mv) -> np.ndarray:
    """One pass over a record-aligned chunk: the ``[n, 3]`` uint64 span
    table, checksummed segments verified inline, in one native call.  No
    policy is applied here (:func:`verify_spans` routes the rejects).  A
    stray sub-word tail is a reject (14) unless the chunk already
    reported, whose report covers those bytes."""
    return native.recordio_spans(mv, KMAGIC, verify=True)


def scan_chunk_plain(mv: memoryview) -> np.ndarray:
    """The plain version of :func:`scan_chunk`: the same walk in Python,
    the same triples."""
    triples, pos, n = [], 0, len(mv)
    any_reject = False

    def resync(p):
        nxt = min(n, p + 4)
        nxt += (-nxt) % 4
        end = n - n % 4
        return find_next_record_head(mv, nxt, end) if nxt < end else end

    def region_crc_ok(off, ln):
        p2, end2 = off, off + ln
        while p2 + 12 <= end2:
            lrec2 = _U32.unpack_from(mv, p2 + 4)[0]
            want = _U32.unpack_from(mv, p2 + 8)[0]
            m = decode_length(lrec2)
            if stored_crc(integrity.crc32c(
                    mv[p2 + 12: p2 + 12 + m])) != want:
                return False
            p2 += 12 + ((m + 3) & ~3)
        return True

    while pos + 8 <= n:
        if mv[pos:pos + 4] != _MAGIC_BYTES:
            r = resync(pos)
            triples.append((pos, r - pos, 8))
            any_reject = True
            pos = r
            continue
        lrec = _U32.unpack_from(mv, pos + 4)[0]
        cflag, ln = decode_flag(lrec), decode_length(lrec)
        ck = cflag >= CRC_BIT
        hdr = 12 if ck else 8
        if cflag & 3 == 0 and cflag in HEAD_CFLAGS:
            nxt = pos + hdr + ((ln + 3) & ~3)
            if nxt > n:
                r = resync(pos)
                triples.append((pos, r - pos, 9))
                any_reject = True
                pos = r
                continue
            if ck:
                want = _U32.unpack_from(mv, pos + 8)[0]
                if stored_crc(integrity.crc32c(
                        mv[pos + hdr: pos + hdr + ln])) != want:
                    # span = [head, payload end): the quarantine key
                    triples.append((pos, hdr + ln, 13))
                    any_reject = True
                    pos = nxt
                    continue
            triples.append((pos + hdr, ln, 2 if ck else 0))
            pos = nxt
        elif cflag & 3 == 1 and cflag in HEAD_CFLAGS:
            start = pos
            p = pos + hdr + ((ln + 3) & ~3)
            kind = 0  # 0 = structurally sound
            while True:
                if p + hdr > n or mv[p:p + 4] != _MAGIC_BYTES:
                    kind = 10
                    break
                lrec = _U32.unpack_from(mv, p + 4)[0]
                cf, l2 = decode_flag(lrec), decode_length(lrec)
                if cf & 3 not in (2, 3) or (cf >= CRC_BIT) != ck:
                    kind = 11
                    break
                p += hdr + ((l2 + 3) & ~3)
                if p > n:
                    kind = 9
                    break
                if cf & 3 == 3:
                    break
            if kind:
                r = resync(start)
                triples.append((start, r - start, kind))
                any_reject = True
                pos = r
                continue
            if ck and not region_crc_ok(start, p - start):
                triples.append((start, p - start, 13))
                any_reject = True
            else:
                triples.append((start, p - start, 3 if ck else 1))
            pos = p
        else:
            r = resync(pos)
            triples.append((pos, r - pos, 12))
            any_reject = True
            pos = r
    if pos < n and not any_reject:
        triples.append((pos, n - pos, 14))
    return np.asarray(triples, np.uint64).reshape(-1, 3)


def chunk_spans(mv: memoryview, source: Optional[str] = None,
                base: Optional[int] = None) -> np.ndarray:
    """The span table of one chunk with rejects reported under
    ``DMLC_INTEGRITY_POLICY`` and quarantined spans dropped on replay;
    ``source``/``base`` key quarantined spans as (uri, global offset of
    the record head).  The scan is timed as ``feed.parse_native`` and the
    routing of rejects and skip-listed spans as ``feed.crc``, the JAX
    feed's names."""
    with telemetry.span("feed.parse_native", stage="feed"), \
            telemetry.timed("feed", "parse_native"):
        sp = scan_chunk(mv)
    with telemetry.timed("feed", "crc"):
        return verify_spans(mv, sp, source, base)


def verify_spans(mv: memoryview, sp: np.ndarray, source, base) -> np.ndarray:
    """Route a scan's rejects through the integrity policy (raise / skip
    / quarantine) and drop them, and drop skip-listed spans.  A clean
    chunk with nothing quarantined costs one vectorized compare."""
    if sp.shape[0] == 0:
        return sp
    rejects = sp[:, 2] >= 8
    listed = integrity.has_quarantine(source)
    if not rejects.any() and not listed:
        return sp
    keep = np.ones(sp.shape[0], bool)
    for i in np.nonzero(rejects)[0]:
        keep[i] = False
        off, ln, kind = int(sp[i, 0]), int(sp[i, 1]), int(sp[i, 2])
        gbegin = None if base is None else base + off
        if kind == 13 and integrity.should_drop(source, gbegin):
            # quarantined on an earlier pass: a replay drops it silently
            continue
        if kind == 12:
            cf = decode_flag(_U32.unpack_from(mv, off + 4)[0])
            what = f"cflag {cf} at record head"
        else:
            what = _REJECT_WHAT[kind]
        integrity.handle_corrupt(  # raises under policy 'raise'
            what, source=source, begin=gbegin,
            end=None if base is None else base + off + ln)
    if listed and base is not None:
        for i in np.nonzero(~rejects)[0]:
            off, flag = int(sp[i, 0]), int(sp[i, 2])
            head = off - 12 if flag == 2 else off - 8 if flag == 0 else off
            if integrity.should_drop(source, base + head):
                keep[i] = False
    return sp if keep.all() else sp[keep]


def reassemble_region(mv: memoryview, off: int, ln: int) -> bytes:
    """One escaped-magic (multi-segment) record region reassembled, plain
    (8-byte headers) or checksummed (12-byte headers)."""
    region = mv[off: off + ln]
    parts, pos = [], 0
    first = True
    while pos + 8 <= len(region):
        lrec = _U32.unpack_from(region, pos + 4)[0]
        cf, n = decode_flag(lrec), decode_length(lrec)
        hdr = 12 if cf >= CRC_BIT else 8
        if not first:
            parts.append(_MAGIC_BYTES)
        parts.append(bytes(region[pos + hdr: pos + hdr + n]))
        first = False
        pos += hdr + ((n + 3) & ~3)
        if cf & 3 in (0, 3):
            break
    return b"".join(parts)


def chunk_record_views(mv: memoryview, sp=None) -> list:
    """Per-record uint8 arrays over one chunk: views for direct payloads
    (flags 0/2), reassembled copies for multi-segment regions (1/3)."""
    if sp is None:
        sp = chunk_spans(mv)
    arr = np.frombuffer(mv, np.uint8)
    out = []
    for off, ln, flag in sp.tolist():
        if flag % 2 == 0:
            out.append(arr[off: off + ln])
        else:
            out.append(np.frombuffer(reassemble_region(mv, off, ln),
                                     np.uint8))
    return out


def gather_rows_into(mv, sp: np.ndarray, lo: int, hi: int, max_bytes: int,
                     out_rows: np.ndarray, out_lens: np.ndarray) -> None:
    """Span records ``[lo, hi)`` of one chunk into ``out_rows [hi-lo,
    max_bytes]`` (zero past each length, records over ``max_bytes``
    truncated) and their lengths into ``out_lens`` (int32): one native
    pad-pack, escaped records reassembled in place."""
    g = hi - lo
    native.pad_pack_rows(mv, sp[lo:hi], KMAGIC, max_bytes, out_rows[:g],
                         out_lens[:g])


def gather_rows_into_plain(mv: memoryview, sp: np.ndarray, lo: int, hi: int,
                           max_bytes: int, out_rows: np.ndarray,
                           out_lens: np.ndarray) -> None:
    """The plain version of :func:`gather_rows_into`: one broadcast numpy
    gather, escaped records reassembled in Python."""
    g = hi - lo
    arr = np.frombuffer(mv, np.uint8)
    offs = sp[lo:hi, 0].astype(np.int32)   # chunk-local: always < 2^31
    lens = np.minimum(sp[lo:hi, 1].astype(np.int64), max_bytes)
    idx = offs[:, None] + np.arange(max_bytes, dtype=np.int32)[None, :]
    np.minimum(idx, arr.size - 1, out=idx)
    np.take(arr, idx, out=out_rows[:g])
    out_rows[:g] *= (np.arange(max_bytes, dtype=np.int64)[None, :]
                     < lens[:, None])
    for i in np.nonzero(sp[lo:hi, 2] % 2 == 1)[0]:  # escaped magic
        payload = reassemble_region(mv, int(offs[i]), int(sp[lo + i, 1]))
        n = min(len(payload), max_bytes)
        out_rows[i, :n] = np.frombuffer(payload, np.uint8, n)
        out_rows[i, n:] = 0
        lens[i] = n
    out_lens[:g] = lens


def pack_spans_plain(src, offs: np.ndarray, lens: np.ndarray,
                     dst: np.ndarray, dst_pos: int, slots: int,
                     allow_truncate: bool, ends_out: np.ndarray):
    """The plain version of ``native.pack_spans``: append whole record
    spans of ``src`` to the packed buffer ``dst``
    from ``dst_pos`` until it fills (bytes or ``slots`` records);
    ``ends_out[:consumed]`` receives each record's end offset.  A span that
    would overflow waits for the next batch, except in an empty batch
    (``allow_truncate``), where it is packed truncated so one oversized
    record cannot wedge the feed.  Returns ``(consumed, new_pos, full)``."""
    n = len(lens)
    cap = dst.size
    src_arr = np.frombuffer(src, np.uint8)
    ends = dst_pos + np.cumsum(lens[:n], dtype=np.int64)
    k = int(np.searchsorted(ends, cap, side="right"))
    full = k < n or (k > 0 and int(ends[k - 1]) >= cap)
    if k > slots:
        k, full = slots, True
    pos = dst_pos
    for j in range(k):
        o, ln = int(offs[j]), int(lens[j])
        dst[pos: pos + ln] = src_arr[o: o + ln]
        pos += ln
        ends_out[j] = pos
    if k == 0 and n > 0 and slots > 0 and allow_truncate \
            and dst_pos + int(lens[0]) > cap:
        m = cap - dst_pos
        o = int(offs[0])
        dst[dst_pos:] = src_arr[o: o + m]
        ends_out[0] = cap
        return 1, cap, True
    return k, pos, full
