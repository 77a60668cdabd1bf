"""Pure-Python Parquet reader for S3 Select (reference
pkg/s3select/parquet/ via parquet-go; rebuilt here with no dependency:
a Thrift compact-protocol decoder, FileMetaData/PageHeader field maps,
and v1/v2 data-page decoding).

Scope (what S3 Select over parquet needs):

* flat schemas (no nested groups beyond the root), REQUIRED + OPTIONAL
  fields (definition levels as RLE/bit-packed hybrid)
* physical types BOOLEAN, INT32, INT64, FLOAT, DOUBLE, BYTE_ARRAY,
  FIXED_LEN_BYTE_ARRAY; UTF8/converted types decode to str
* encodings PLAIN, PLAIN_DICTIONARY, RLE_DICTIONARY, RLE
* codecs UNCOMPRESSED, SNAPPY (pure-python, utils/snappy.py), GZIP

Rows come out as dicts, which S3 Select evaluates like JSON records.

The port's copy of minio_tpu/s3select/parquet.py: the port imports
nothing of the JAX package, not even this pure-Python module.
"""
from __future__ import annotations

import gzip
import struct

MAGIC = b"PAR1"

# physical types (parquet.thrift Type)
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED = range(8)
# codecs
UNCOMPRESSED, SNAPPY, GZIP_CODEC = 0, 1, 2
# encodings
ENC_PLAIN, ENC_PLAIN_DICT, ENC_RLE, ENC_RLE_DICT = 0, 2, 3, 8
# converted types that decode BYTE_ARRAY to str
_UTF8 = 0


class ParquetError(Exception):
    pass


# -- Thrift compact protocol (read side) --------------------------------------
# Generic: structs decode to {field_id: value}; callers pick fields by id
# against parquet.thrift. Types: https://github.com/apache/thrift
# compact-protocol spec.

CT_STOP, CT_TRUE, CT_FALSE, CT_BYTE, CT_I16, CT_I32, CT_I64, CT_DOUBLE, \
    CT_BINARY, CT_LIST, CT_SET, CT_MAP, CT_STRUCT = range(13)


class _Reader:
    __slots__ = ("b", "i")

    def __init__(self, b: bytes, i: int = 0):
        self.b = b
        self.i = i

    def varint(self) -> int:
        out = shift = 0
        while True:
            c = self.b[self.i]
            self.i += 1
            out |= (c & 0x7F) << shift
            if not c & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def read(self, n: int) -> bytes:
        out = self.b[self.i: self.i + n]
        if len(out) != n:
            raise ParquetError("truncated thrift data")
        self.i += n
        return out

    def struct(self) -> dict:
        out: dict = {}
        fid = 0
        while True:
            head = self.b[self.i]
            self.i += 1
            if head == CT_STOP:
                return out
            delta, ctype = head >> 4, head & 0x0F
            fid = fid + delta if delta else self.zigzag()
            out[fid] = self.value(ctype)

    def value(self, ctype: int):
        if ctype == CT_TRUE:
            return True
        if ctype == CT_FALSE:
            return False
        if ctype in (CT_BYTE, CT_I16, CT_I32, CT_I64):
            return self.zigzag()
        if ctype == CT_DOUBLE:
            return struct.unpack("<d", self.read(8))[0]
        if ctype == CT_BINARY:
            return self.read(self.varint())
        if ctype in (CT_LIST, CT_SET):
            head = self.b[self.i]
            self.i += 1
            size, etype = head >> 4, head & 0x0F
            if size == 15:
                size = self.varint()
            return [self.value(etype) for _ in range(size)]
        if ctype == CT_MAP:
            size = self.varint()
            if size == 0:
                return {}
            kv = self.b[self.i]
            self.i += 1
            kt, vt = kv >> 4, kv & 0x0F
            return {self.value(kt): self.value(vt) for _ in range(size)}
        if ctype == CT_STRUCT:
            return self.struct()
        raise ParquetError(f"unknown thrift compact type {ctype}")


# -- RLE / bit-packed hybrid --------------------------------------------------


def _rle_bp_hybrid(r: _Reader, bit_width: int, count: int) -> list[int]:
    """Decode `count` values from an RLE/bit-packed hybrid run stream."""
    out: list[int] = []
    if bit_width == 0:
        return [0] * count
    byte_w = (bit_width + 7) // 8
    mask = (1 << bit_width) - 1
    while len(out) < count:
        header = r.varint()
        if header & 1:  # bit-packed: (header>>1) groups of 8
            n_groups = header >> 1
            n_bytes = n_groups * bit_width
            data = r.read(n_bytes)
            acc = int.from_bytes(data, "little")
            n_vals = n_groups * 8
            for k in range(n_vals):
                out.append((acc >> (k * bit_width)) & mask)
        else:  # RLE run
            run = header >> 1
            v = int.from_bytes(r.read(byte_w), "little")
            out.extend([v] * run)
    return out[:count]


# -- value decoding -----------------------------------------------------------


def _plain_values(data: bytes, ptype: int, n: int, type_length: int,
                  to_str: bool) -> list:
    r = _Reader(data)
    out: list = []
    if ptype == BOOLEAN:
        for k in range(n):
            out.append(bool((data[k >> 3] >> (k & 7)) & 1))
        return out
    if ptype == INT32:
        return list(struct.unpack(f"<{n}i", r.read(4 * n)))
    if ptype == INT64:
        return list(struct.unpack(f"<{n}q", r.read(8 * n)))
    if ptype == FLOAT:
        return list(struct.unpack(f"<{n}f", r.read(4 * n)))
    if ptype == DOUBLE:
        return list(struct.unpack(f"<{n}d", r.read(8 * n)))
    if ptype == INT96:  # legacy timestamps: return raw int
        for _ in range(n):
            out.append(int.from_bytes(r.read(12), "little"))
        return out
    if ptype == FIXED:
        for _ in range(n):
            out.append(r.read(type_length))
        return out
    # BYTE_ARRAY
    for _ in range(n):
        ln = struct.unpack("<I", r.read(4))[0]
        b = r.read(ln)
        out.append(b.decode("utf-8", "replace") if to_str else b)
    return out


def _decompress(data: bytes, codec: int, uncompressed_size: int) -> bytes:
    if codec == UNCOMPRESSED:
        return data
    if codec == GZIP_CODEC:
        return gzip.decompress(data)
    if codec == SNAPPY:
        from ..utils.snappy import decompress
        return decompress(data)
    raise ParquetError(f"unsupported parquet codec {codec}")


# -- column + file readers ----------------------------------------------------


class _Column:
    def __init__(self, name: str, ptype: int, optional: bool,
                 type_length: int, to_str: bool):
        self.name = name
        self.ptype = ptype
        self.optional = optional
        self.type_length = type_length
        self.to_str = to_str


def _read_column_chunk(raw: bytes, col: _Column, meta: dict) -> list:
    """Decode one column chunk into per-row values (None for nulls)."""
    codec = meta.get(4, UNCOMPRESSED)
    num_values = meta.get(5, 0)
    # read pages starting at dictionary_page_offset (when present) else
    # data_page_offset
    off = meta.get(11)
    if off is None:
        off = meta.get(9, 0)
    r = _Reader(raw, off)
    dictionary: list | None = None
    values: list = []
    while len(values) < num_values:
        header = r.struct()  # PageHeader
        page_type = header.get(1, 0)
        comp_size = header.get(3, 0)
        unc_size = header.get(2, 0)
        page_raw = r.read(comp_size)
        if page_type == 2:  # DICTIONARY_PAGE
            dph = header.get(7, {})
            n = dph.get(1, 0)
            data = _decompress(page_raw, codec, unc_size)
            dictionary = _plain_values(data, col.ptype, n,
                                       col.type_length, col.to_str)
            continue
        if page_type == 0:  # DATA_PAGE v1
            dph = header.get(5, {})
            n = dph.get(1, 0)
            enc = dph.get(2, ENC_PLAIN)
            data = _decompress(page_raw, codec, unc_size)
            pr = _Reader(data)
            defs = None
            if col.optional:
                dl_len = struct.unpack("<I", pr.read(4))[0]
                defs = _rle_bp_hybrid(_Reader(pr.read(dl_len)), 1, n)
            values.extend(_page_values(pr, col, enc, n, defs, dictionary))
            continue
        if page_type == 3:  # DATA_PAGE_V2
            dph = header.get(8, {})
            n = dph.get(1, 0)
            n_nulls = dph.get(2, 0)
            enc = dph.get(4, ENC_PLAIN)
            dl_bytes = dph.get(5, 0)
            rl_bytes = dph.get(6, 0)
            is_comp = dph.get(7, True)
            levels = page_raw[: dl_bytes + rl_bytes]
            body = page_raw[dl_bytes + rl_bytes:]
            if is_comp:
                body = _decompress(body, codec,
                                   unc_size - dl_bytes - rl_bytes)
            defs = None
            if col.optional:
                defs = _rle_bp_hybrid(_Reader(levels, rl_bytes), 1, n)
            elif n_nulls:
                raise ParquetError("nulls in required column")
            values.extend(_page_values(_Reader(body), col, enc, n, defs,
                                       dictionary))
            continue
        raise ParquetError(f"unsupported page type {page_type}")
    return values[:num_values]


def _page_values(pr: _Reader, col: _Column, enc: int, n: int,
                 defs: list | None, dictionary: list | None) -> list:
    n_present = n if defs is None else sum(defs)
    if enc in (ENC_PLAIN_DICT, ENC_RLE_DICT):
        if dictionary is None:
            raise ParquetError("dictionary-encoded page without dictionary")
        bw = pr.read(1)[0]
        idx = _rle_bp_hybrid(pr, bw, n_present)
        present = [dictionary[i] for i in idx]
    elif enc == ENC_PLAIN:
        present = _plain_values(pr.b[pr.i:], col.ptype, n_present,
                                col.type_length, col.to_str)
    elif enc == ENC_RLE and col.ptype == BOOLEAN:
        ln = struct.unpack("<I", pr.read(4))[0]
        present = [bool(v) for v in _rle_bp_hybrid(
            _Reader(pr.read(ln)), 1, n_present)]
    else:
        raise ParquetError(f"unsupported encoding {enc}")
    if defs is None:
        return present
    out = []
    it = iter(present)
    for d in defs:
        out.append(next(it) if d else None)
    return out


def _wrap_errors(fn):
    """Corrupt input must surface as ParquetError (the select layer's
    contract), not as IndexError/struct.error/gzip errors from whatever
    decode step tripped on it."""
    import functools

    @functools.wraps(fn)
    def inner(*a, **kw):
        try:
            return fn(*a, **kw)
        except ParquetError:
            raise
        except Exception as e:  # noqa: BLE001
            raise ParquetError(f"corrupt parquet data: {e!r}") from None
    return inner


class ParquetReader:
    """Whole-object parquet reader: ``columns`` (names in schema order)
    and ``iter_rows()`` yielding dicts."""

    @_wrap_errors
    def __init__(self, raw: bytes):
        if len(raw) < 12 or raw[:4] != MAGIC or raw[-4:] != MAGIC:
            raise ParquetError("not a parquet file")
        meta_len = struct.unpack("<I", raw[-8:-4])[0]
        meta_start = len(raw) - 8 - meta_len
        if meta_start < 4:
            raise ParquetError("corrupt parquet footer")
        fmeta = _Reader(raw[meta_start: len(raw) - 8]).struct()
        self.raw = raw
        self.num_rows = fmeta.get(3, 0)
        schema = fmeta.get(2, [])
        if not schema:
            raise ParquetError("empty parquet schema")
        root = schema[0]
        n_children = root.get(5, 0)
        self.columns: list[_Column] = []
        for el in schema[1: 1 + n_children]:
            if el.get(5):  # has children: nested group
                raise ParquetError("nested parquet schemas not supported")
            name = el.get(4, b"").decode("utf-8", "replace")
            ptype = el.get(1, BYTE_ARRAY)
            optional = el.get(3, 0) == 1
            conv = el.get(6)
            # string-annotated byte arrays decode to str — either the
            # legacy ConvertedType UTF8 (field 6) or the modern
            # LogicalType union's STRING member (field 10, union field 1);
            # unannotated columns stay bytes (base64'd at the Select
            # output layer)
            logical = el.get(10)
            is_str = conv == _UTF8 or (
                isinstance(logical, dict) and 1 in logical)
            to_str = ptype == BYTE_ARRAY and is_str
            self.columns.append(_Column(name, ptype, optional,
                                        el.get(2, 0), to_str))
        self.row_groups = fmeta.get(4, [])

    def iter_rows(self):
        names = [c.name for c in self.columns]
        for rg in self.row_groups:
            cols = self._row_group_columns(rg)
            for row in zip(*cols):
                yield dict(zip(names, row))

    @_wrap_errors
    def _row_group_columns(self, rg: dict) -> list[list]:
        chunks = rg.get(1, [])
        cols: list[list] = []
        for i, col in enumerate(self.columns):
            if i >= len(chunks):
                raise ParquetError("row group missing column chunk")
            meta = chunks[i].get(3)
            if meta is None:
                raise ParquetError("column chunk without metadata")
            cols.append(_read_column_chunk(self.raw, col, meta))
        return cols


def iter_parquet_rows(raw: bytes):
    return ParquetReader(raw).iter_rows()
