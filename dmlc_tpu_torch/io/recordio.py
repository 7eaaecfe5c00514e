"""RecordIO: the splittable binary record format, byte-identical with the
JAX package and the reference (the port of ``dmlc_tpu/io/recordio.py``;
reference include/dmlc/recordio.h, src/recordio.cc).

A record segment on the wire (recordio.h:16-45)::

    [ magic:u32 = 0xced7230a ][ lrecord:u32 ][ data ][ pad to 4 bytes ]
    lrecord = (cflag << 29) | length, cflag in {0 complete, 1 start,
                                                2 middle, 3 end}

A payload holding the magic at a 4-byte-aligned offset is split into
segments there; the magic word is elided and re-inserted on read (the
escape protocol, src/recordio.cc:11-82).

The checksummed variant (``checksum=True`` or
``DMLC_RECORDIO_CHECKSUM=1``) writes cflag ``plain|4`` and a CRC-32C
word of the stored payload between the lrec and the payload.  A stored
crc equal to the magic is written as ``crc ^ 1``, and the one segment
length whose lrec would equal the magic under cflag 6 is refused, so a
scan for an aligned magic never finds a false record head.  Readers
verify every checksummed segment and route corruption through
``DMLC_INTEGRITY_POLICY`` (``io.integrity``).
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional

from ..base import check, get_env
from .stream import Stream

__all__ = [
    "KMAGIC",
    "encode_lrec",
    "decode_flag",
    "decode_length",
    "RecordIOWriter",
    "RecordIOReader",
    "RecordIOChunkReader",
    "find_next_record_head",
]

KMAGIC = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", KMAGIC)
_U32 = struct.Struct("<I")
_HDR = struct.Struct("<II")

#: cflags with the CRC32C word present; ``cflag & 3`` is the plain role
CRC_BIT = 4
#: cflags that may begin a logical record (head positions for scans)
HEAD_CFLAGS = (0, 1, 4, 5)

_SKIPPED = object()  # sentinel: a record was dropped by the policy


def encode_lrec(cflag: int, length: int) -> int:
    """(cflag << 29) | length (recordio.h:52-54)."""
    return ((cflag << 29) | length) & 0xFFFFFFFF


def decode_flag(rec: int) -> int:
    return (rec >> 29) & 7


def decode_length(rec: int) -> int:
    return rec & ((1 << 29) - 1)


def stored_crc(c: int) -> int:
    """The on-disk form of a crc: one equal to the magic is flipped in
    its low bit, so no stored cell can pass for a record head."""
    return c ^ 1 if c == KMAGIC else c


class RecordIOWriter:
    """Writes records with the escape protocol; ``checksum=True``
    (default from ``DMLC_RECORDIO_CHECKSUM``) selects the CRC32C
    variant."""

    def __init__(self, stream: Stream, checksum: Optional[bool] = None):
        self._strm = stream
        self.checksum = (get_env("DMLC_RECORDIO_CHECKSUM", False)
                         if checksum is None else bool(checksum))
        self.except_counter = 0  # escape splits emitted

    def _emit(self, out: bytearray, cflag: int, payload) -> None:
        if self.checksum:
            from .integrity import crc32c

            cflag |= CRC_BIT
            lrec = encode_lrec(cflag, len(payload))
            check(lrec != KMAGIC,
                  "RecordIO: pathological segment length collides with "
                  "the magic word under the checksummed variant")
            out += _MAGIC_BYTES
            out += _U32.pack(lrec)
            out += _U32.pack(stored_crc(crc32c(payload)))
        else:
            out += _MAGIC_BYTES
            out += _U32.pack(encode_lrec(cflag, len(payload)))
        out += payload

    def write_record(self, data: bytes) -> None:
        size = len(data)
        check(size < (1 << 29), "RecordIO only accepts records < 2^29 bytes")
        lower_align = (size >> 2) << 2
        upper_align = ((size + 3) >> 2) << 2
        out = bytearray()
        dptr = 0
        idx = data.find(_MAGIC_BYTES)
        while idx != -1 and idx < lower_align:
            if idx % 4 == 0:
                self._emit(out, 1 if dptr == 0 else 2, data[dptr:idx])
                dptr = idx + 4
                self.except_counter += 1
                idx = data.find(_MAGIC_BYTES, dptr)
            else:
                idx = data.find(_MAGIC_BYTES, idx + 1)
        self._emit(out, 3 if dptr != 0 else 0, data[dptr:size])
        if upper_align != size:
            out += b"\x00" * (upper_align - size)
        self._strm.write(bytes(out))


class RecordIOReader:
    """Sequential reader reassembling multi-segment records
    (src/recordio.cc:53-82), verifying checksummed segments; under
    ``skip``/``quarantine`` a bad record is dropped and the reader resyncs
    to the next record head.  ``source`` labels quarantined spans (byte
    offsets into this stream)."""

    def __init__(self, stream: Stream, source: Optional[str] = None):
        self._strm = stream
        self._source = source
        self._eos = False
        self._off = 0          # bytes consumed (quarantine span keys)
        self._pend_lrec: Optional[int] = None  # header found by resync

    def close(self) -> None:
        """Nothing to release: the caller owns the stream."""

    def _read(self, n: int) -> bytes:
        data = self._strm.read(n)
        got = len(data)
        while got < n:
            more = self._strm.read(n - got)
            if not more:
                break
            data += more
            got += len(more)
        self._off += len(data)
        return data

    def _corrupt(self, what: str, begin: int) -> None:
        from .integrity import handle_corrupt

        handle_corrupt(what, source=self._source, begin=begin, end=self._off)

    def _resync(self) -> None:
        """Scan forward word by word for the next record head and leave
        its lrec pending (the u32 walk of recordio_split.cc:9-25)."""
        w = self._read(4)
        while True:
            if len(w) < 4:
                self._eos = True
                return
            if w != _MAGIC_BYTES:
                w = self._read(4)
                continue
            lw = self._read(4)
            if len(lw) < 4:
                self._eos = True
                return
            lrec = _U32.unpack(lw)[0]
            if decode_flag(lrec) in HEAD_CFLAGS:
                self._pend_lrec = lrec
                return
            # the follower word may itself be a real head's magic: test it
            # again, as find_next_record_head does, so both readers drop
            # the same records for the same bytes
            w = lw

    def _next_once(self):
        """One parse attempt: record bytes, None (EOS), or _SKIPPED."""
        if self._pend_lrec is not None:
            lrec, self._pend_lrec = self._pend_lrec, None
            begin = self._off - 8
        else:
            begin = self._off
            hdr = self._read(8)
            if len(hdr) == 0:
                self._eos = True
                return None
            if len(hdr) < 8:
                self._corrupt("truncated header", begin)
                self._eos = True
                return None
            magic, lrec = _HDR.unpack(hdr)
            if magic != KMAGIC:
                self._corrupt("bad magic", begin)
                self._resync()
                return _SKIPPED
        parts = []
        bad = None
        first = True
        while True:
            cflag = decode_flag(lrec)
            length = decode_length(lrec)
            checked = cflag >= CRC_BIT
            if first and cflag not in HEAD_CFLAGS:
                self._corrupt(f"cflag {cflag} at record head", begin)
                self._resync()
                return _SKIPPED
            want = None
            if checked:
                crcb = self._read(4)
                if len(crcb) < 4:
                    self._corrupt("truncated crc word", begin)
                    self._eos = True
                    return None
                want = _U32.unpack(crcb)[0]
            upper_align = ((length + 3) >> 2) << 2
            payload = b""
            if upper_align:
                payload = self._read(upper_align)
                if len(payload) < upper_align:
                    self._corrupt("truncated payload", begin)
                    self._eos = True
                    return None
            seg = payload[:length]
            if checked:
                from .integrity import crc32c

                if stored_crc(crc32c(seg)) != want:
                    bad = bad or "crc32c mismatch"
            parts.append(seg)
            if cflag & 3 in (0, 3):
                break
            parts.append(_MAGIC_BYTES)  # re-insert the elided magic cell
            hdr = self._read(8)
            if len(hdr) < 8:
                self._corrupt("truncated continuation", begin)
                self._eos = True
                return None
            magic, lrec = _HDR.unpack(hdr)
            if magic != KMAGIC:
                self._corrupt("bad continuation magic", begin)
                self._resync()
                return _SKIPPED
            cf = decode_flag(lrec)
            if cf & 3 not in (2, 3) or (cf >= CRC_BIT) != checked:
                # the end cell is gone; what we found may be the next head
                if cf in HEAD_CFLAGS:
                    self._pend_lrec = lrec
                    self._corrupt("missing end segment", begin)
                    return _SKIPPED
                self._corrupt(f"cflag {cf} in continuation", begin)
                self._resync()
                return _SKIPPED
            first = False
        if bad is not None:
            self._corrupt(bad, begin)
            return _SKIPPED
        from .integrity import should_drop

        if should_drop(self._source, begin):
            return _SKIPPED
        return b"".join(parts)

    def next_record(self) -> Optional[bytes]:
        while True:
            if self._eos:
                return None
            rec = self._next_once()
            if rec is _SKIPPED:
                continue
            return rec

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


def find_next_record_head(buf: memoryview, begin: int, end: int) -> int:
    """The offset of the first record head (magic + a head cflag) at a
    4-byte-aligned word of buf[begin:end), or ``end`` (src/recordio.cc:
    86-100).  ``begin``/``end`` are aligned to the record stream."""
    check(begin % 4 == 0 and end % 4 == 0, "unaligned recordio scan bounds")
    block = 1 << 16   # bounded blocks: O(distance to the head)
    base = begin
    while base < end:
        stop = min(end, base + block)
        # 8 bytes of overlap find a header straddling the block seam
        data = bytes(buf[base: min(end, stop + 8)])
        pos = 0
        limit = len(data) - 8
        while True:
            idx = data.find(_MAGIC_BYTES, pos)
            if idx < 0 or idx > limit or base + idx >= stop:
                break
            if (base + idx - begin) % 4 == 0:
                lrec = _U32.unpack_from(data, idx + 4)[0]
                if decode_flag(lrec) in HEAD_CFLAGS:
                    return base + idx
                pos = idx + 4
            else:
                pos = idx + 1
        base = stop
    return end


class RecordIOChunkReader:
    """Parts of an in-memory chunk of RecordIO bytes among ``num_parts``
    readers (src/recordio.cc:101-156).  Complete records come back as
    memoryview slices; escaped multi-segment records are reassembled.
    Checksummed segments are verified and corruption follows
    ``DMLC_INTEGRITY_POLICY``; ``source``/``base_offset`` key quarantined
    spans by global byte offset."""

    def __init__(self, chunk: bytes, part_index: int = 0, num_parts: int = 1,
                 source: Optional[str] = None, base_offset: int = 0):
        self._buf = memoryview(chunk)
        self._source = source
        self._base = base_offset
        # a torn tail can leave an unaligned size: the part that owns the
        # chunk tail reports the sub-word remainder once its parse is done
        rem = len(chunk) % 4
        size = len(chunk) - rem
        nstep = (size + num_parts - 1) // num_parts
        nstep = ((nstep + 3) >> 2) << 2
        begin = min(size, nstep * part_index)
        end = min(size, nstep * (part_index + 1))
        owns_tail = end == size and (
            begin < end or (size == 0 and part_index == 0))
        self._tail = (size, rem) if rem and owns_tail else None
        self._corrupt_seen = False
        self._pbegin = find_next_record_head(self._buf, begin, size)
        self._pend = find_next_record_head(self._buf, end, size)

    def _corrupt(self, what: str, begin: int) -> bool:
        from .integrity import handle_corrupt

        self._corrupt_seen = True
        handle_corrupt(what, source=self._source,
                       begin=self._base + begin,
                       end=self._base + min(self._pbegin, self._pend))
        return True

    def _resync(self, frm: int) -> None:
        frm = min(self._pend, frm + 4)
        frm += (-frm) % 4
        self._pbegin = find_next_record_head(self._buf, frm, self._pend)

    def _next_once(self):
        if self._pbegin >= self._pend:
            if self._tail is not None:
                tbegin, rem = self._tail
                self._tail = None
                # a part that already reported corruption covers the tail
                if not self._corrupt_seen:
                    from .integrity import handle_corrupt

                    handle_corrupt("torn tail (sub-word remainder)",
                                   source=self._source,
                                   begin=self._base + tbegin,
                                   end=self._base + tbegin + rem)
            return None
        buf = self._buf
        begin = self._pbegin
        # positions move BEFORE each report, so the reported span covers
        # the poisoned extent
        if begin + 8 > self._pend:
            self._pbegin = self._pend
            self._corrupt("truncated header", begin)
            return _SKIPPED
        magic, lrec = _HDR.unpack_from(buf, begin)
        if magic != KMAGIC:
            self._resync(begin)
            self._corrupt("bad magic", begin)
            return _SKIPPED
        cflag = decode_flag(lrec)
        if cflag not in HEAD_CFLAGS:
            self._resync(begin)
            self._corrupt(f"cflag {cflag} at record head", begin)
            return _SKIPPED
        from .integrity import should_drop

        parts = []
        bad = None
        pos = begin
        first = True
        zero_copy = None  # (start, len) for a single-segment record
        while True:
            if pos + 8 > self._pend:
                self._pbegin = self._pend
                self._corrupt("truncated segment", begin)
                return _SKIPPED
            magic, lrec = _HDR.unpack_from(buf, pos)
            if magic != KMAGIC:
                self._resync(pos)
                self._corrupt("bad continuation magic", begin)
                return _SKIPPED
            cf = decode_flag(lrec)
            clen = decode_length(lrec)
            checked = cf >= CRC_BIT
            expected = HEAD_CFLAGS if first else (
                (6, 7) if cflag >= CRC_BIT else (2, 3))
            if cf not in expected:
                if not first and cf in HEAD_CFLAGS:
                    self._pbegin = pos
                    self._corrupt("missing end segment", begin)
                    return _SKIPPED
                self._resync(pos)
                self._corrupt(f"cflag {cf} in continuation", begin)
                return _SKIPPED
            want = None
            start = pos + 8
            if checked:
                if start + 4 > self._pend:
                    self._pbegin = self._pend
                    self._corrupt("truncated crc word", begin)
                    return _SKIPPED
                want = _U32.unpack_from(buf, start)[0]
                start += 4
            nxt = start + (((clen + 3) >> 2) << 2)
            if nxt > self._pend or start + clen > self._pend:
                self._pbegin = self._pend
                self._corrupt("truncated payload", begin)
                return _SKIPPED
            seg = buf[start: start + clen]
            if checked:
                from .integrity import crc32c

                if stored_crc(crc32c(seg)) != want:
                    bad = bad or "crc32c mismatch"
            if first and cf & 3 == 0:
                zero_copy = (start, clen)
            else:
                if not first:
                    parts.append(_MAGIC_BYTES)
                parts.append(bytes(seg))
            pos = nxt
            if cf & 3 in (0, 3):
                break
            first = False
        self._pbegin = pos
        if bad is not None:
            self._corrupt(bad, begin)
            return _SKIPPED
        if should_drop(self._source, self._base + begin):
            return _SKIPPED
        if zero_copy is not None:
            s, n = zero_copy
            return buf[s: s + n]
        return memoryview(b"".join(parts))

    def next_record(self) -> Optional[memoryview]:
        while True:
            rec = self._next_once()
            if rec is _SKIPPED:
                continue
            return rec

    def __iter__(self) -> Iterator[memoryview]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec
