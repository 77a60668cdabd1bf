"""Pure-Python Snappy block format (reference uses klauspost/compress
S2/snappy in Go; parquet column chunks and the S2 input path need the
decompressor, and the compressor emits valid all-literal and
match-compressed streams for tests and internal use).

Format (google/snappy format_description.txt): a varint uncompressed
length, then tagged elements — literals and back-references (copies)
with 1/2/4-byte offsets.

The port's copy of minio_tpu/utils/snappy.py: the port imports
nothing of the JAX package, not even this pure-Python module.
"""
from __future__ import annotations


class SnappyError(Exception):
    pass


def _uvarint(b: bytes, i: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        if i >= len(b):
            raise SnappyError("truncated varint")
        c = b[i]
        i += 1
        out |= (c & 0x7F) << shift
        if not c & 0x80:
            return out, i
        shift += 7


def decompress(data: bytes) -> bytes:
    try:
        return _decompress(data)
    except IndexError:
        raise SnappyError("truncated snappy data") from None


def _decompress(data: bytes) -> bytes:
    total, i = _uvarint(data, 0)
    out = bytearray()
    n = len(data)
    while i < n:
        tag = data[i]
        i += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(data[i: i + nb], "little")
                i += nb
            ln += 1
            if i + ln > n:
                raise SnappyError("truncated literal")
            out += data[i: i + ln]
            i += ln
            continue
        if kind == 1:
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | data[i]
            i += 1
        elif kind == 2:
            if i + 2 > n:
                raise SnappyError("truncated copy offset")
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[i: i + 2], "little")
            i += 2
        else:
            if i + 4 > n:
                raise SnappyError("truncated copy offset")
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[i: i + 4], "little")
            i += 4
        if off == 0 or off > len(out):
            raise SnappyError("invalid copy offset")
        if off >= ln:
            start = len(out) - off
            out += out[start: start + ln]
        else:  # overlapping copy: byte-at-a-time semantics
            for _ in range(ln):
                out.append(out[-off])
    if len(out) != total:
        raise SnappyError(f"length mismatch: {len(out)} != {total}")
    return bytes(out)


def compress(data: bytes) -> bytes:
    """Greedy hash-match compressor — small and correct rather than
    fast; emits the same element kinds real snappy streams use."""
    out = bytearray()
    n = len(data)
    # uncompressed length varint
    v = n
    while True:
        if v < 0x80:
            out.append(v)
            break
        out.append((v & 0x7F) | 0x80)
        v >>= 7

    def emit_literal(lo: int, hi: int):
        nonlocal out
        ln = hi - lo - 1
        if ln < 60:
            out.append(ln << 2)
        elif ln < (1 << 8):
            out.append(60 << 2)
            out.append(ln & 0xFF)
        elif ln < (1 << 16):
            out.append(61 << 2)
            out += (ln).to_bytes(2, "little")
        elif ln < (1 << 24):
            out.append(62 << 2)
            out += (ln).to_bytes(3, "little")
        else:
            out.append(63 << 2)
            out += (ln).to_bytes(4, "little")
        out += data[lo:hi]

    table: dict[bytes, int] = {}
    i = lit_start = 0
    while i + 4 <= n:
        key = data[i: i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF:
            # extend the match
            ln = 4
            while i + ln < n and ln < 64 and data[cand + ln] == data[i + ln]:
                ln += 1
            if lit_start < i:
                emit_literal(lit_start, i)
            off = i - cand
            if 4 <= ln <= 11 and off < 2048:
                out.append(1 | ((ln - 4) << 2) | ((off >> 8) << 5))
                out.append(off & 0xFF)
            else:
                out.append(2 | ((ln - 1) << 2))
                out += off.to_bytes(2, "little")
            i += ln
            lit_start = i
        else:
            i += 1
    if lit_start < n:
        emit_literal(lit_start, n)
    return bytes(out)
