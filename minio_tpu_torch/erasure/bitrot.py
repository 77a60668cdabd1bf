"""Bitrot protection — the port of erasure/bitrot.py: per-shard checksums
in the reference's two modes.

- **streaming** (HIGHWAYHASH256S, the default; MUR3X256S; BLAKE2B256S):
  each shard file interleaves a 32-byte digest before every chunk,
  ``[H][chunk][H][chunk]...``, with a file size of ceil(len/chunk)*32 +
  len. Reads are chunk-aligned and every chunk is verified.
- **whole-file** (SHA256, BLAKE2B512, HIGHWAYHASH256): one digest over the
  whole shard, kept by the caller (xl.meta in the reference); the file
  holds the raw bytes.

HIGHWAYHASH256S and MUR3X256S have device hashes (``native_algo_id``):
full blocks are digested on the card (ops/fused.py). Every host digest of
those two (tail blocks, host-verified replacement reads, the streaming
writer's last chunk) and of HIGHWAYHASH256 comes from the native library
(native/__init__.py); the BLAKE2b and SHA-256 algorithms are ``hashlib``'s.
"""
from __future__ import annotations

import enum
import hashlib
import os

import numpy as np

from .. import native
from ..native import highwayhash
from ..ops.fused import ALGO_HIGHWAY as ALGO_ID_HIGHWAY
from ..ops.fused import ALGO_MUR3 as ALGO_ID_MUR3
from ..ops.fused import chunk_align
from ..utils import errors

#: xl.meta key recording the streaming-bitrot chunk size an object was
#: written with (readers must use the same chunking to find the digests).
BITROT_CHUNK_KEY = "x-minio-internal-bitrot-chunk"

#: Default streaming chunk: 16 KiB, so the device hash (parallel across
#: chunks, sequential within one) gets many chunks per block. Override with
#: the ``bitrot.chunk`` config key (MINIO_TPU_BITROT_CHUNK).
DEFAULT_BITROT_CHUNK = 16384

#: The framework-wide bitrot key (the JAX package's value: digests must
#: match across the two packages).
HIGHWAY_KEY = bytes.fromhex(
    "4be734fa8e238acd263e83e6bb968552040f935da39f441497e09d1322de36a0")


def pick_bitrot_chunk(shard_size: int, chunk: int | None = None) -> int:
    """Streaming chunk size for a new object with the given erasure shard
    size: ``chunk`` (default: the registry's ``bitrot.chunk``, env
    MINIO_TPU_BITROT_CHUNK > stored > 16 KiB, so a set-config-kv applies to
    new objects without restart) when it divides the shard, so block reads
    stay chunk-aligned, else the shard size itself."""
    if chunk is None:
        from ..config import get_config_sys
        chunk = get_config_sys().get_int("bitrot", "chunk",
                                         DEFAULT_BITROT_CHUNK)
    if chunk > 0 and shard_size % chunk == 0:
        return chunk
    return shard_size


class BitrotAlgorithm(enum.Enum):
    """The reference's bitrot algorithm table (cmd/bitrot.go:33-51) plus
    the JAX package's MUR3X256S."""
    SHA256 = "sha256"
    BLAKE2B512 = "blake2b"
    HIGHWAYHASH256 = "highwayhash256"
    HIGHWAYHASH256S = "highwayhash256S"
    BLAKE2B256S = "blake2b256S"
    MUR3X256S = "mur3x256S"

    @property
    def streaming(self) -> bool:
        return self in (BitrotAlgorithm.HIGHWAYHASH256S,
                        BitrotAlgorithm.BLAKE2B256S,
                        BitrotAlgorithm.MUR3X256S)

    @property
    def digest_size(self) -> int:
        return _DIGEST_SIZE[self]

    def new(self):
        """A hashlib-shaped hasher of this algorithm."""
        return _ALGOS[self]()


def _highwayhash256():
    return highwayhash.HighwayHash256(HIGHWAY_KEY)


_ALGOS = {
    BitrotAlgorithm.SHA256: hashlib.sha256,
    BitrotAlgorithm.BLAKE2B512: lambda: hashlib.blake2b(digest_size=64),
    BitrotAlgorithm.HIGHWAYHASH256: _highwayhash256,
    BitrotAlgorithm.HIGHWAYHASH256S: _highwayhash256,
    BitrotAlgorithm.BLAKE2B256S: lambda: hashlib.blake2b(digest_size=32),
    BitrotAlgorithm.MUR3X256S: lambda: native.Mur3x256(HIGHWAY_KEY),
}
_DIGEST_SIZE = {a: 64 if a is BitrotAlgorithm.BLAKE2B512 else 32
                for a in BitrotAlgorithm}


def native_algo_id(algo: BitrotAlgorithm) -> int | None:
    """The native ALGO_* id of an algorithm with a device hash."""
    return {BitrotAlgorithm.HIGHWAYHASH256S: ALGO_ID_HIGHWAY,
            BitrotAlgorithm.MUR3X256S: ALGO_ID_MUR3}.get(algo)


def default_bitrot_algo() -> BitrotAlgorithm:
    """HIGHWAYHASH256S, the JAX package's default whenever its native
    library builds and the reference's own (cmd/bitrot.go:51). Overridable
    with MINIO_TPU_BITROT_ALGO, as in the JAX package, by any streaming
    algorithm."""
    env = os.environ.get("MINIO_TPU_BITROT_ALGO", "")
    if env:
        try:
            a = BitrotAlgorithm(env)
        except ValueError:
            a = None
        if a is not None and a.streaming:
            return a
    return BitrotAlgorithm.HIGHWAYHASH256S


#: the default itself, whatever the environment says
DEFAULT_BITROT_ALGO = BitrotAlgorithm.HIGHWAYHASH256S


def device_chunk(shard_len: int, chunk: int, algo_id: int) -> int | None:
    """The chunk size at which one block's shards of ``shard_len`` bytes
    are digested on the device: ``chunk`` when the shard is whole chunks,
    the shard length itself when the shard is one short tail chunk the
    device hash takes (a tail block's), else None (the host hashes)."""
    if shard_len <= 0 or chunk <= 0:
        return None
    align = chunk_align(algo_id)
    if shard_len % chunk == 0 and chunk % align == 0:
        return chunk
    if shard_len < chunk and shard_len % align == 0:
        return shard_len
    return None


def _batch_digests(algo: BitrotAlgorithm, blob, n: int, chunk_size: int
                   ) -> np.ndarray:
    """Digests of n equal chunks as uint8 [n, digest_size]: one native
    call for the algorithms with a native engine, a hashlib loop else."""
    chunks = np.frombuffer(blob, dtype=np.uint8).reshape(n, chunk_size)
    aid = native_algo_id(algo)
    if aid is not None:
        return native.batch_hasher(aid)(HIGHWAY_KEY, chunks)
    out = np.empty((n, algo.digest_size), dtype=np.uint8)
    for i in range(n):
        h = algo.new()
        h.update(chunks[i])
        out[i] = np.frombuffer(h.digest(), dtype=np.uint8)
    return out


def shard_chunk_digests(shards: np.ndarray, chunk: int,
                        algo_id: int = ALGO_ID_HIGHWAY) -> np.ndarray:
    """Per-chunk digests of each row of uint8 [k, shard_len] as uint8
    [k, n_chunks*32] on the native engine of ``algo_id``: full
    ``chunk``-size pieces batched, a short tail piece (shard_len % chunk)
    digested last — the [digest][chunk] framing order of the shard files."""
    batch = native.batch_hasher(algo_id)
    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    k, shard_len = shards.shape
    n_full = shard_len // chunk
    tail = shard_len - n_full * chunk
    nc = n_full + (1 if tail else 0)
    out = np.empty((k, nc * 32), dtype=np.uint8)
    if n_full:
        full = batch(HIGHWAY_KEY, shards[:, : n_full * chunk].reshape(
            k * n_full, chunk))
        out[:, : n_full * 32] = full.reshape(k, n_full * 32)
    if tail:
        out[:, n_full * 32:] = batch(HIGHWAY_KEY, shards[:, n_full * chunk:])
    return out


def frame_block_shards(shards: np.ndarray, digs: np.ndarray, chunk: int,
                       out: np.ndarray | None = None) -> np.ndarray:
    """Interleave precomputed digests with shard payloads into the on-disk
    [digest][chunk] framing: uint8 [k, shard_len] + [k, nc*32] -> uint8
    [k, framed_len] (``out``, when given, is the destination)."""
    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    k, shard_len = shards.shape
    n_full = shard_len // chunk
    tail = shard_len - n_full * chunk
    nc = n_full + (1 if tail else 0)
    fl = nc * 32 + shard_len
    if out is None:
        out = np.empty((k, fl), dtype=np.uint8)
    elif out.shape != (k, fl):
        raise ValueError("frame_block_shards: out shape mismatch")
    h = 32
    if n_full:
        span = out[:, : n_full * (h + chunk)].reshape(k, n_full, h + chunk)
        span[:, :, :h] = digs[:, : n_full * h].reshape(k, n_full, h)
        span[:, :, h:] = shards[:, : n_full * chunk].reshape(
            k, n_full, chunk)
    if tail:
        pos = n_full * (h + chunk)
        out[:, pos: pos + h] = digs[:, n_full * h:]
        out[:, pos + h:] = shards[:, n_full * chunk:]
    return out


def bitrot_shard_file_size(size: int, shard_size: int,
                           algo: BitrotAlgorithm) -> int:
    """On-disk size of a shard file of ``size`` logical bytes."""
    if not algo.streaming:
        return size
    if size == 0:
        return 0
    return -(-size // shard_size) * algo.digest_size + size


def bitrot_logical_size(file_size: int, shard_size: int,
                        algo: BitrotAlgorithm) -> int:
    """Inverse of bitrot_shard_file_size: logical shard bytes in a file."""
    if not algo.streaming or file_size == 0:
        return file_size
    h = algo.digest_size
    chunks = -(-file_size // (shard_size + h))
    return file_size - chunks * h


# --- streaming writer/reader -------------------------------------------------


def _check_streaming(algo: BitrotAlgorithm) -> None:
    # every streaming algorithm's digest is 32 bytes: the framing below
    # relies on it
    if not algo.streaming:
        raise ValueError(f"{algo.value} is a whole-file algorithm")


class StreamingBitrotWriter:
    """Writes ``[digest][chunk]`` per ``shard_size``-byte chunk into a byte
    sink (write(bytes), close(), optional abort()). Callers may write()
    arbitrary sizes; digests are emitted every shard_size logical bytes."""

    def __init__(self, sink, algo: BitrotAlgorithm, shard_size: int):
        _check_streaming(algo)
        self.sink = sink
        self.algo = algo
        self.shard_size = shard_size
        self._buf = bytearray()

    def write(self, b: bytes):
        self._buf += b
        n = len(self._buf) // self.shard_size
        if n:
            blob = bytes(self._buf[: n * self.shard_size])
            del self._buf[: n * self.shard_size]
            digs = _batch_digests(self.algo, blob, n, self.shard_size)
            out = np.empty((n, 32 + self.shard_size), dtype=np.uint8)
            out[:, :32] = digs
            out[:, 32:] = np.frombuffer(blob, dtype=np.uint8).reshape(
                n, self.shard_size)
            self.sink.write(out.tobytes())

    def write_framed(self, framed) -> None:
        """Pass pre-framed ``[digest][chunk]`` bytes straight to the sink
        (digests computed with the parity on the device). Only legal on
        chunk boundaries."""
        if self._buf:
            raise ValueError("write_framed with partial chunk buffered")
        self.sink.write(framed if isinstance(
            framed, (bytes, bytearray, memoryview)) else memoryview(framed))

    def close(self):
        if self._buf:
            h = self.algo.new()
            h.update(bytes(self._buf))
            self.sink.write(h.digest())
            self.sink.write(bytes(self._buf))
            self._buf.clear()
        self.sink.close()

    def abort(self):
        if hasattr(self.sink, "abort"):
            self.sink.abort()
        else:
            self.sink.close()


class StreamingBitrotReader:
    """Chunk-aligned verified reads over a ``[digest][chunk]`` stream.

    ``src`` exposes read_at(offset, length) over the physical file;
    read_at() here takes logical, chunk-aligned shard offsets."""

    def __init__(self, src, till_offset: int, algo: BitrotAlgorithm,
                 shard_size: int):
        _check_streaming(algo)
        self.src = src
        self.algo = algo
        self.shard_size = shard_size
        self.till_offset = till_offset

    @property
    def fusable(self) -> bool:
        """True when chunk digests can be verified on the device: the
        algorithm has a device hash and the chunk suits it (MUR3X256 needs
        16-byte packets, HighwayHash 4-byte words)."""
        aid = native_algo_id(self.algo)
        return aid is not None and self.shard_size % chunk_align(aid) == 0

    def _read_phys_span(self, offset: int, length: int) -> bytes:
        """Aligned physical read covering ceil(length/chunk) digests +
        length payload bytes; a span ending mid-chunk is legal only at
        stream end."""
        if offset % self.shard_size:
            raise ValueError(f"unaligned bitrot read at {offset}")
        if offset + length > self.till_offset:
            raise errors.FileCorrupt(
                f"bitrot read [{offset}, {offset + length}) past shard end "
                f"{self.till_offset}")
        if length % self.shard_size and offset + length != self.till_offset:
            raise ValueError(
                f"bitrot read [{offset}, {offset + length}) ends mid-chunk "
                f"before stream end {self.till_offset}")
        n_chunks = -(-length // self.shard_size) if length else 0
        phys = (offset // self.shard_size) * (self.shard_size + 32)
        blob = self.src.read_at(phys, n_chunks * 32 + length)
        if len(blob) < n_chunks * 32 + length:
            raise errors.FileCorrupt("short bitrot stream")
        return blob

    def read_at_raw(self, offset: int, length: int) -> tuple[bytes, bytes]:
        """Read (digests, payload) without verifying — the device checks the
        digests in the same flush as the rebuild."""
        blob = self._read_phys_span(offset, length)
        cs = self.shard_size
        n_full = length // cs
        framed = np.frombuffer(blob, dtype=np.uint8)
        body = framed[: n_full * (32 + cs)].reshape(n_full, 32 + cs)
        digests = body[:, :32].tobytes()
        payload = body[:, 32:].tobytes()
        tail = length - n_full * cs
        if tail:
            pos = n_full * (32 + cs)
            digests += blob[pos: pos + 32]
            payload += blob[pos + 32: pos + 32 + tail]
        return digests, payload

    def read_at(self, offset: int, length: int) -> bytes:
        """Verified read: every chunk's digest is checked on the host."""
        if length == 0:
            return b""
        blob = self._read_phys_span(offset, length)
        cs = self.shard_size
        n_full = length // cs
        out = bytearray()
        if n_full:
            framed = np.frombuffer(blob[: n_full * (32 + cs)],
                                   dtype=np.uint8).reshape(n_full, 32 + cs)
            payload = np.ascontiguousarray(framed[:, 32:])
            digs = _batch_digests(self.algo, payload.data, n_full, cs)
            if not np.array_equal(digs, framed[:, :32]):
                raise errors.FileCorrupt("bitrot hash mismatch")
            out += payload.data
        tail = length - n_full * cs
        if tail:
            pos = n_full * (32 + cs)
            digest = blob[pos: pos + 32]
            chunk = blob[pos + 32: pos + 32 + tail]
            hh = self.algo.new()
            hh.update(chunk)
            if hh.digest() != digest:
                raise errors.FileCorrupt("bitrot hash mismatch")
            out += chunk
        return bytes(out)


# --- whole-file writer/reader -------------------------------------------------


class WholeBitrotWriter:
    """Raw passthrough writer accumulating one digest of the whole shard,
    which the caller stores (xl.meta in the reference;
    cmd/bitrot-whole.go)."""

    def __init__(self, sink, algo: BitrotAlgorithm):
        self.sink = sink
        self.algo = algo
        self._h = algo.new()

    def write(self, b) -> None:
        self._h.update(b)
        self.sink.write(b)

    def digest(self) -> bytes:
        return self._h.digest()

    def close(self) -> None:
        self.sink.close()


class WholeBitrotReader:
    """Reads the whole shard once, verifies it against the stored digest,
    then serves read_at from memory (the reference verifies lazily on the
    first read, cmd/bitrot-whole.go:55-80)."""

    def __init__(self, src, expected_digest: bytes, algo: BitrotAlgorithm,
                 file_size: int):
        self.src = src
        self.expected = expected_digest
        self.algo = algo
        self.file_size = file_size
        self._data: bytes | None = None

    def read_at(self, offset: int, length: int) -> bytes:
        if self._data is None:
            data = self.src.read_at(0, self.file_size)
            h = self.algo.new()
            h.update(data)
            if self.expected and h.digest() != self.expected:
                raise errors.FileCorrupt("bitrot whole-file hash mismatch")
            self._data = data
        if offset + length > len(self._data):
            raise errors.FileCorrupt("bitrot read past end")
        return self._data[offset: offset + length]


def new_bitrot_writer(sink, algo: BitrotAlgorithm, shard_size: int):
    if algo.streaming:
        return StreamingBitrotWriter(sink, algo, shard_size)
    return WholeBitrotWriter(sink, algo)


def new_bitrot_reader(src, algo: BitrotAlgorithm, till_offset: int,
                      shard_size: int, expected_digest: bytes = b"",
                      file_size: int = 0):
    """A streaming reader over ``[digest][chunk]`` files, or a whole-file
    reader checking ``expected_digest`` over the first ``file_size``
    bytes."""
    if algo.streaming:
        return StreamingBitrotReader(src, till_offset, algo, shard_size)
    return WholeBitrotReader(src, expected_digest, algo, file_size)
