"""Raw Snappy block format, pure Python (the port's copy of
`photon_tpu/data/snappy.py`, byte for byte the same output).

Avro containers at LinkedIn commonly use the snappy codec (each block:
raw-snappy-compressed payload + 4-byte big-endian CRC32 of the UNCOMPRESSED
bytes). No snappy binding is assumed, so the raw block format is
implemented here; `native.snappy_uncompress` is the C++ twin the
container reader prefers when the native library builds.

Format (github.com/google/snappy format_description.txt):
  preamble: uncompressed length, little-endian varint;
  elements: tag byte, low 2 bits = type —
    00 literal   (len-1) in tag bits 2-7; 60..63 mean 1..4 extra LE bytes
    01 copy      len 4..11 in tag bits 2-4, offset 11 bits (3 tag + 1 byte)
    10 copy      len 1..64 in tag bits 2-7, offset 2-byte LE
    11 copy      like 10 with 4-byte LE offset
  copies may overlap forward (offset < len repeats the pattern).
"""
from __future__ import annotations


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("snappy: truncated length varint")
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 35:
            raise ValueError("snappy: malformed length varint")


def uncompress(data: bytes) -> bytes:
    """Decompress one raw snappy block."""
    n, pos = _read_varint(data, 0)
    out = bytearray(n)
    end = len(data)
    w = 0
    while pos < end:
        tag = data[pos]
        pos += 1
        t = tag & 3
        if t == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                if pos + extra > end:
                    raise ValueError("snappy: truncated literal length")
                ln = int.from_bytes(data[pos:pos + extra], "little")
                pos += extra
            ln += 1
            if pos + ln > end or w + ln > n:
                raise ValueError("snappy: literal overruns buffer")
            out[w:w + ln] = data[pos:pos + ln]
            pos += ln
            w += ln
            continue
        # truncated copy operands must raise (ValueError, like every other
        # corruption — and matching the C++ twin's error codes)
        if t == 1:
            if pos + 1 > end:
                raise ValueError("snappy: truncated copy")
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif t == 2:
            if pos + 2 > end:
                raise ValueError("snappy: truncated copy")
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:
            if pos + 4 > end:
                raise ValueError("snappy: truncated copy")
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > w or w + ln > n:
            raise ValueError("snappy: bad copy")
        if off >= ln:
            out[w:w + ln] = out[w - off:w - off + ln]
        else:  # overlapping copy: the pattern repeats forward
            for i in range(ln):
                out[w + i] = out[w - off + i]
        w += ln
    if w != n:
        raise ValueError(f"snappy: decoded {w} bytes, header said {n}")
    return bytes(out)


def uncompressed_length(data: bytes) -> int:
    return _read_varint(data, 0)[0]


_BLOCK = 1 << 16  # matches are found within 64 KiB fragments, as upstream


def _emit_literal(out: bytearray, data: bytes, lo: int, hi: int) -> None:
    while lo < hi:
        ln = min(hi - lo, 1 << 32)
        n = ln - 1
        if n < 60:
            out.append(n << 2)
        else:
            extra = (n.bit_length() + 7) // 8
            out.append((59 + extra) << 2)
            out += n.to_bytes(extra, "little")
        out += data[lo:lo + ln]
        lo += ln


def _emit_copy(out: bytearray, off: int, ln: int) -> None:
    # longest-first: 2-byte-offset copies carry up to 64 bytes each
    while ln >= 68:
        out.append(2 | (63 << 2))
        out += off.to_bytes(2, "little")
        ln -= 64
    if ln > 64:  # leave ≥ 4 for the final copy
        out.append(2 | (59 << 2))
        out += off.to_bytes(2, "little")
        ln -= 60
    if 4 <= ln <= 11 and off < 2048:
        out.append(1 | ((ln - 4) << 2) | ((off >> 8) << 5))
        out.append(off & 0xFF)
    else:
        out.append(2 | ((ln - 1) << 2))
        out += off.to_bytes(2, "little")


def compress(data: bytes) -> bytes:
    """Greedy hash-match compressor (one 4-byte-hash table per 64 KiB
    fragment — the upstream algorithm's shape, minus its tuning)."""
    out = bytearray()
    n = len(data)
    pos = 0
    while pos < n:  # per-fragment: table/base reset, no state carries over
        frag_end = min(pos + _BLOCK, n)
        base = pos
        table: dict = {}
        lit = pos
        i = pos
        while i + 4 <= frag_end:
            key = data[i:i + 4]
            j = table.get(key)
            table[key] = i
            if j is not None and j >= base:
                ln = 4
                maxl = frag_end - i
                while ln < maxl and data[j + ln] == data[i + ln]:
                    ln += 1
                _emit_literal(out, data, lit, i)
                _emit_copy(out, i - j, ln)
                i += ln
                lit = i
            else:
                i += 1
        _emit_literal(out, data, lit, frag_end)
        pos = frag_end
    return _varint(len(data)) + bytes(out)


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)
