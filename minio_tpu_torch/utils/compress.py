"""Transparent object compression, the port of minio_tpu/utils/compress.py
(reference cmd/object-api-utils.go:920 newS2CompressReader + the
compression config): opt-in through ``MINIO_TPU_COMPRESSION``, applied on
PUT to compressible content (extension and MIME filters), recorded in the
object's internal metadata, undone on GET.

Formats. New objects are stored as an **S2/snappy frame stream** (a stream
identifier, then one CRC32C-checked chunk per 64 KiB block, snappy-
compressed only when that wins) under the reference's marker
``klauspost/compress/s2``; ``MINIO_TPU_COMPRESSION_FORMAT=zlib`` selects
the raw-deflate ``zlib/1`` scheme instead. All three markers read back:
``zlib/1``, ``klauspost/compress/s2`` and ``golang/snappy/LZ77`` (the
reference's V1, the same frames). Blocks that use S2's non-snappy
extension tags fail to decode with ``SnappyError``.

The snappy blocks and the CRC32C run in the port's native library
(``native/s2.cpp``, byte for byte the JAX package's pure-Python
``utils/snappy.py`` and CRC32C): a stream either package writes for one
input is the other's, byte for byte.
"""
from __future__ import annotations

import io
import os
import struct
import zlib

from .. import native
from .snappy import SnappyError

META_COMPRESSION = "x-minio-internal-compression"
META_ACTUAL_SIZE = "x-minio-internal-actual-size"

ALGO_ZLIB = "zlib/1"
#: reference compressionAlgorithmV2 (cmd/object-handlers.go:74)
ALGO_S2 = "klauspost/compress/s2"
#: reference compressionAlgorithmV1: the same frame format, snappy blocks
ALGO_SNAPPY_V1 = "golang/snappy/LZ77"

_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
_CHUNK_COMPRESSED = 0x00
_CHUNK_UNCOMPRESSED = 0x01
_CHUNK_PADDING = 0xFE
_BLOCK = 1 << 16  # the most uncompressed bytes per frame chunk

DEFAULT_EXTENSIONS = (".txt", ".log", ".csv", ".json", ".tar", ".xml",
                      ".bin")
DEFAULT_MIME = ("text/", "application/json", "application/xml",
                "application/x-ndjson")


def enabled() -> bool:
    return os.environ.get("MINIO_TPU_COMPRESSION", "") in ("1", "on",
                                                           "true")


def algo() -> str:
    """The algorithm recorded on NEW compressed objects."""
    fmt = os.environ.get("MINIO_TPU_COMPRESSION_FORMAT", "s2").lower()
    return ALGO_ZLIB if fmt == "zlib" else ALGO_S2


def should_compress(key: str, content_type: str) -> bool:
    if not enabled():
        return False
    ext_env = os.environ.get("MINIO_TPU_COMPRESSION_EXTENSIONS", "")
    exts = tuple(e.strip() for e in ext_env.split(",") if e.strip()) \
        or DEFAULT_EXTENSIONS
    mime_env = os.environ.get("MINIO_TPU_COMPRESSION_MIME", "")
    mimes = tuple(m.strip() for m in mime_env.split(",") if m.strip()) \
        or DEFAULT_MIME
    if any(key.lower().endswith(e) for e in exts):
        return True
    return any((content_type or "").lower().startswith(m) for m in mimes)


def _crc32c_masked(data) -> int:
    c = native.crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- writers (PUT path) -------------------------------------------------------


class _Reader:
    """read(n) over a pump that appends to ``_buf`` until EOF."""

    def __init__(self, stream, head: bytes = b""):
        self.stream = stream
        self._buf = bytearray(head)
        self._eof = False

    def _pump(self) -> None:
        raise NotImplementedError

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            out = bytearray()
            while True:
                b = self.read(1 << 20)
                if not b:
                    return bytes(out)
                out += b
        while not self._eof and len(self._buf) < n:
            self._pump()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


class CompressReader(_Reader):
    """Wraps a plaintext stream, yields the raw-deflate stream (the
    ``zlib/1`` scheme)."""

    def __init__(self, stream, level: int = 1):
        super().__init__(stream)
        self._c = zlib.compressobj(level)

    def _pump(self) -> None:
        chunk = self.stream.read(1 << 20)
        if not chunk:
            self._eof = True
            self._buf += self._c.flush()
            return
        self._buf += self._c.compress(chunk)


class S2CompressReader(_Reader):
    """Wraps a plaintext stream, yields an S2/snappy frame stream
    (reference newS2CompressReader, cmd/object-api-utils.go:920-935): the
    stream identifier, then one CRC32C-checked chunk per read of 64 KiB,
    stored compressed only when snappy actually wins."""

    def __init__(self, stream):
        super().__init__(stream, _STREAM_ID)

    def _pump(self) -> None:
        raw = self.stream.read(_BLOCK)
        if not raw:
            self._eof = True
            return
        crc = struct.pack("<I", _crc32c_masked(raw))
        comp = native.snappy_compress(raw)
        if len(comp) < len(raw):
            kind, body = _CHUNK_COMPRESSED, comp
        else:
            kind, body = _CHUNK_UNCOMPRESSED, raw
        self._buf += bytes([kind]) + (len(body) + 4).to_bytes(3, "little")
        self._buf += crc
        self._buf += body


def compress_reader(stream):
    """The PUT-side wrapper of the configured format; pair it with
    ``algo()`` for the metadata marker."""
    return CompressReader(stream) if algo() == ALGO_ZLIB \
        else S2CompressReader(stream)


# -- readers (GET path) -------------------------------------------------------


class _RangeEmitter:
    """The [skip, skip+limit) plaintext window of a ranged GET: the stream
    is inflated from its start and trimmed (as the reference serves a
    compressed range)."""

    def __init__(self, writer, skip: int = 0, limit: int = -1):
        self.writer = writer
        self._skip = skip
        self._left = limit

    def _emit(self, plain: bytes) -> None:
        if not plain:
            return
        if self._skip:
            drop = min(self._skip, len(plain))
            plain = plain[drop:]
            self._skip -= drop
        if self._left >= 0:
            plain = plain[:self._left]
            self._left -= len(plain)
        if plain:
            self.writer.write(plain)

    def close(self) -> None:
        self.finish()
        if hasattr(self.writer, "close"):
            self.writer.close()

    def finish(self) -> None:
        pass


class DecompressWriter(_RangeEmitter):
    """Writer wrapper inflating a ``zlib/1`` stored stream."""

    def __init__(self, writer, skip: int = 0, limit: int = -1):
        super().__init__(writer, skip, limit)
        self._d = zlib.decompressobj()

    def write(self, b) -> None:
        self._emit(self._d.decompress(b))

    def finish(self) -> None:
        self._emit(self._d.flush())


class S2DecompressWriter(_RangeEmitter):
    """Writer wrapper inflating an S2/snappy frame stream: compressed,
    uncompressed, padding and skippable chunks, each chunk's CRC32C
    checked. An unknown unskippable chunk type, a bad checksum and a block
    the snappy decoder cannot parse raise SnappyError."""

    def __init__(self, writer, skip: int = 0, limit: int = -1):
        super().__init__(writer, skip, limit)
        self._pend = bytearray()

    def write(self, b) -> None:
        self._pend += b
        while len(self._pend) >= 4:
            kind = self._pend[0]
            ln = int.from_bytes(self._pend[1:4], "little")
            if len(self._pend) < 4 + ln:
                return
            payload = bytes(self._pend[4: 4 + ln])
            del self._pend[: 4 + ln]
            if kind == 0xFF:
                if payload != _STREAM_ID[4:]:
                    raise SnappyError("bad s2 stream identifier")
                continue
            if kind in (_CHUNK_COMPRESSED, _CHUNK_UNCOMPRESSED):
                if ln < 4:
                    raise SnappyError("truncated s2 chunk")
                (want_crc,) = struct.unpack_from("<I", payload)
                raw = native.snappy_decompress(payload[4:]) \
                    if kind == _CHUNK_COMPRESSED else payload[4:]
                if _crc32c_masked(raw) != want_crc:
                    raise SnappyError("s2 chunk crc mismatch")
                self._emit(raw)
                continue
            if kind == _CHUNK_PADDING or 0x80 <= kind <= 0xFD:
                continue  # padding / skippable
            raise SnappyError(f"unskippable s2 chunk type {kind:#x}")

    def finish(self) -> None:
        if self._pend:
            raise SnappyError("truncated s2 frame stream")


def decompress_writer(algo_name: str, writer, skip: int = 0,
                      limit: int = -1):
    """The reader-side wrapper of a stored object's recorded algorithm."""
    if algo_name in (ALGO_S2, ALGO_SNAPPY_V1):
        return S2DecompressWriter(writer, skip, limit)
    return DecompressWriter(writer, skip, limit)


def logical_bytes(oi, stored: bytes) -> bytes:
    """The object's plaintext given its STORED bytes: inflated when the
    compression marker is present (what leaves the deployment is
    plaintext: the destination does not know the markers)."""
    marker = getattr(oi, "internal", {}).get(META_COMPRESSION)
    if not marker:
        return stored
    if marker in (ALGO_S2, ALGO_SNAPPY_V1):
        buf = io.BytesIO()
        d = S2DecompressWriter(buf)
        d.write(stored)
        d.finish()
        return buf.getvalue()
    return zlib.decompress(stored)
