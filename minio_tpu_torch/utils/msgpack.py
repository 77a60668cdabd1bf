"""A MessagePack packer and unpacker for the subset the object layer stores
and the storage RPC carries: the xl.meta journal, the listing-cache blocks
and manifests, the multipart part records, and the storage REST bodies
(FileInfo documents, lists of them, disk and volume records, the walks'
entries; the JAX package packs all of these with the ``msgpack`` wheel,
which the card's machine does not have).

Types: dict (packed in insertion order), list and tuple (packed as arrays,
unpacked as lists), str, bytes/bytearray/memoryview, int, float, bool and
None. ``packb(doc)`` gives the bytes of ``msgpack.packb(doc,
use_bin_type=True)`` and ``unpackb(b)`` the object of ``msgpack.unpackb(b,
raw=False, strict_map_key=False)``:

- ints take the smallest encoding: positive fixint, negative fixint, then
  uint8..uint64 for non-negative and int8..int64 for negative values;
- a float is always float64 (0xcb); float32 (0xca) is read, never written;
- str uses fixstr, str8 (0xd9, lengths 32-255), str16 and str32;
- bytes use bin8/16/32, never str;
- arrays and maps use their fix form below 16 entries, then the 16- and
  32-bit forms.

Extension types, and anything else outside the subset, raise ValueError.
"""
from __future__ import annotations

import struct

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


def _pack_int(x: int, out: list) -> None:
    if 0 <= x < 0x80:
        out.append(_B.pack(x))
    elif -32 <= x < 0:
        out.append(_b.pack(x))
    elif x >= 0:
        if x <= 0xFF:
            out.append(b"\xcc" + _B.pack(x))
        elif x <= 0xFFFF:
            out.append(b"\xcd" + _H.pack(x))
        elif x <= 0xFFFFFFFF:
            out.append(b"\xce" + _I.pack(x))
        elif x <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _Q.pack(x))
        else:
            raise ValueError(f"int {x} does not fit 64 bits")
    elif x >= -0x80:
        out.append(b"\xd0" + _b.pack(x))
    elif x >= -0x8000:
        out.append(b"\xd1" + _h.pack(x))
    elif x >= -0x80000000:
        out.append(b"\xd2" + _i.pack(x))
    elif x >= -0x8000000000000000:
        out.append(b"\xd3" + _q.pack(x))
    else:
        raise ValueError(f"int {x} does not fit 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, c16: bytes, c32: bytes,
              out: list, c8: bytes | None = None) -> None:
    if n < fix_max:
        out.append(_B.pack(fix | n))
    elif c8 is not None and n <= 0xFF:
        out.append(c8 + _B.pack(n))
    elif n <= 0xFFFF:
        out.append(c16 + _H.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(c32 + _I.pack(n))
    else:
        raise ValueError(f"length {n} does not fit 32 bits")


def _pack_str(obj: str, out: list) -> None:
    b = obj.encode("utf-8")
    if len(b) < 32:
        out.append(_FIXSTR[len(b)])
    else:
        _pack_len(len(b), 0xA0, 32, b"\xda", b"\xdb", out, c8=b"\xd9")
    out.append(b)


def _pack(obj, out: list) -> None:
    # the exact types first, most frequent in a journal first (a journal
    # dump is mostly short keys, small maps and small ints)
    t = type(obj)
    if t is str:
        _pack_str(obj, out)
    elif t is dict:
        _pack_len(len(obj), 0x80, 16, b"\xde", b"\xdf", out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif t is int:
        _pack_int(obj, out)
    elif obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _d.pack(obj))
    elif isinstance(obj, str):
        _pack_str(obj, out)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        n = len(b)
        if n <= 0xFF:
            out.append(b"\xc4" + _B.pack(n))
        elif n <= 0xFFFF:
            out.append(b"\xc5" + _H.pack(n))
        elif n <= 0xFFFFFFFF:
            out.append(b"\xc6" + _I.pack(n))
        else:
            raise ValueError(f"bytes of {n} do not fit bin32")
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, b"\xdc", b"\xdd", out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, b"\xde", b"\xdf", out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise ValueError(f"cannot pack {type(obj).__name__}")


_FIXSTR = [bytes([0xA0 | n]) for n in range(32)]


def packb(obj) -> bytes:
    """MessagePack bytes of ``obj`` (``msgpack.packb(obj,
    use_bin_type=True)``)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def _unpack(buf: bytes, pos: int):
    """(object at ``pos``, the position after it). The common cases
    (fixstr keys, fixints, fixmaps, fixarrays) come first: a journal load
    is mostly those, and listings load one journal per disk per entry."""
    c = buf[pos]
    pos += 1
    if 0xA0 <= c <= 0xBF:
        end = pos + (c & 0x1F)
        if end > len(buf):
            raise ValueError("truncated msgpack data")
        return buf[pos:end].decode("utf-8"), end
    if c < 0x80:
        return c, pos
    if c < 0x90:
        out = {}
        for _ in range(c & 0x0F):
            k, pos = _unpack(buf, pos)
            out[k], pos = _unpack(buf, pos)
        return out, pos
    if c < 0xA0:
        out = []
        for _ in range(c & 0x0F):
            v, pos = _unpack(buf, pos)
            out.append(v)
        return out, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if c == 0xC0:
        return None, pos
    if c == 0xC2:
        return False, pos
    if c == 0xC3:
        return True, pos
    fixed = _FIXED.get(c)
    if fixed is not None:
        end = pos + fixed.size
        if end > len(buf):
            raise ValueError("truncated msgpack data")
        return fixed.unpack_from(buf, pos)[0], end
    sized = _SIZED.get(c)
    if sized is None:
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")
    kind, width = sized
    if pos + width.size > len(buf):
        raise ValueError("truncated msgpack data")
    n = width.unpack_from(buf, pos)[0]
    pos += width.size
    if kind == "bin" or kind == "str":
        end = pos + n
        if end > len(buf):
            raise ValueError("truncated msgpack data")
        b = buf[pos:end]
        return (b.decode("utf-8") if kind == "str" else b), end
    if kind == "array":
        out = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            out.append(v)
        return out, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos


#: fixed-width scalars: type byte -> its struct
_FIXED = {0xCA: _f, 0xCB: _d, 0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
          0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}
#: length-prefixed types: type byte -> (kind, length struct)
_SIZED = {0xC4: ("bin", _B), 0xC5: ("bin", _H), 0xC6: ("bin", _I),
          0xD9: ("str", _B), 0xDA: ("str", _H), 0xDB: ("str", _I),
          0xDC: ("array", _H), 0xDD: ("array", _I),
          0xDE: ("map", _H), 0xDF: ("map", _I)}


def unpackb(data) -> object:
    """The object of one MessagePack document (``msgpack.unpackb(data,
    raw=False, strict_map_key=False)``); raises ValueError on truncated
    data, trailing bytes or a type outside the subset."""
    buf = bytes(data)
    try:
        obj, pos = _unpack(buf, 0)
    except IndexError:
        raise ValueError("truncated msgpack data") from None
    if pos != len(buf):
        raise ValueError("extra bytes after the msgpack document")
    return obj
