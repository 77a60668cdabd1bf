"""Bitrot protection — the port of erasure/bitrot.py, for the streaming
algorithms HIGHWAYHASH256S (the default) and MUR3X256S: each shard file
interleaves a 32-byte digest before every chunk, ``[H][chunk][H][chunk]...``,
with a file size of ceil(len/chunk)*32 + len. Reads are chunk-aligned and
every chunk is verified.

The host digests (tail blocks, CPU-verified replacement reads) come from
numpy (native/hhpy.py, native/mur3py.py); full blocks are digested on the
device (ops/fused.py). The JAX package's other algorithms (HIGHWAYHASH256,
SHA256, BLAKE2B512, BLAKE2B256S) are not ported and raise.
"""
from __future__ import annotations

import enum
import os

import numpy as np

from ..native import hhpy, mur3py
from ..ops.fused import ALGO_HIGHWAY as ALGO_ID_HIGHWAY
from ..ops.fused import ALGO_MUR3 as ALGO_ID_MUR3
from ..ops.fused import chunk_align
from ..utils import errors

#: Default streaming chunk: 16 KiB, so the device hash (parallel across
#: chunks, sequential within one) gets many chunks per block. Override with
#: MINIO_TPU_BITROT_CHUNK.
DEFAULT_BITROT_CHUNK = 16384

#: The framework-wide bitrot key (the JAX package's value: digests must
#: match across the two packages).
HIGHWAY_KEY = bytes.fromhex(
    "4be734fa8e238acd263e83e6bb968552040f935da39f441497e09d1322de36a0")

_NOT_PORTED = ("bitrot algorithm {} is not ported: only HIGHWAYHASH256S "
               "and MUR3X256S are")

#: host batch hashers per native ALGO_* id: uint8 [n, L] -> uint8 [n, 32]
_HOST_BATCH = {ALGO_ID_HIGHWAY: hhpy.hash256_batch,
               ALGO_ID_MUR3: mur3py.hash256_batch}


def pick_bitrot_chunk(shard_size: int, chunk: int | None = None) -> int:
    """Streaming chunk size for a new object with the given erasure shard
    size: ``chunk`` (default: MINIO_TPU_BITROT_CHUNK or 16 KiB) when it
    divides the shard, so block reads stay chunk-aligned, else the shard
    size itself."""
    if chunk is None:
        try:
            chunk = int(os.environ.get("MINIO_TPU_BITROT_CHUNK",
                                       str(DEFAULT_BITROT_CHUNK)))
        except ValueError:
            chunk = DEFAULT_BITROT_CHUNK
    if chunk > 0 and shard_size % chunk == 0:
        return chunk
    return shard_size


class BitrotAlgorithm(enum.Enum):
    """The JAX package's algorithm names; HIGHWAYHASH256S and MUR3X256S are
    ported."""
    SHA256 = "sha256"
    BLAKE2B512 = "blake2b"
    HIGHWAYHASH256 = "highwayhash256"
    HIGHWAYHASH256S = "highwayhash256S"
    BLAKE2B256S = "blake2b256S"
    MUR3X256S = "mur3x256S"

    def _check(self) -> None:
        if native_algo_id(self) is None:
            raise NotImplementedError(_NOT_PORTED.format(self.value))

    @property
    def streaming(self) -> bool:
        return self in (BitrotAlgorithm.HIGHWAYHASH256S,
                        BitrotAlgorithm.BLAKE2B256S,
                        BitrotAlgorithm.MUR3X256S)

    @property
    def digest_size(self) -> int:
        self._check()
        return 32

    def new(self):
        self._check()
        if self is BitrotAlgorithm.HIGHWAYHASH256S:
            return hhpy.HighwayHash256(HIGHWAY_KEY)
        return mur3py.Mur3x256(HIGHWAY_KEY)


def native_algo_id(algo: BitrotAlgorithm) -> int | None:
    """The native ALGO_* id of an algorithm with a device hash."""
    return {BitrotAlgorithm.HIGHWAYHASH256S: ALGO_ID_HIGHWAY,
            BitrotAlgorithm.MUR3X256S: ALGO_ID_MUR3}.get(algo)


def default_bitrot_algo() -> BitrotAlgorithm:
    """HIGHWAYHASH256S, the JAX package's default whenever its native
    library builds and the reference's own (cmd/bitrot.go:51). Overridable
    with MINIO_TPU_BITROT_ALGO, as in the JAX package, by any ported
    streaming algorithm."""
    env = os.environ.get("MINIO_TPU_BITROT_ALGO", "")
    if env:
        try:
            a = BitrotAlgorithm(env)
        except ValueError:
            a = None
        if a is not None and a.streaming and native_algo_id(a) is not None:
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
    """Digests of n equal chunks as uint8 [n, 32]."""
    algo._check()
    return _HOST_BATCH[native_algo_id(algo)](
        HIGHWAY_KEY, np.frombuffer(blob, dtype=np.uint8).reshape(
            n, chunk_size))


def shard_chunk_digests(shards: np.ndarray, chunk: int,
                        algo_id: int = ALGO_ID_HIGHWAY) -> np.ndarray:
    """Per-chunk digests of each row of uint8 [k, shard_len] as uint8
    [k, n_chunks*32]: full ``chunk``-size pieces batched, a short tail piece
    (shard_len % chunk) digested last — the [digest][chunk] framing order
    of the shard files."""
    if algo_id not in _HOST_BATCH:
        raise NotImplementedError(_NOT_PORTED.format(f"id {algo_id}"))
    batch = _HOST_BATCH[algo_id]
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


class StreamingBitrotWriter:
    """Writes ``[digest][chunk]`` per ``shard_size``-byte chunk into a byte
    sink (write(bytes), close(), optional abort()). Callers may write()
    arbitrary sizes; digests are emitted every shard_size logical bytes."""

    def __init__(self, sink, algo: BitrotAlgorithm, shard_size: int):
        algo._check()
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
        algo._check()
        self.src = src
        self.algo = algo
        self.shard_size = shard_size
        self.till_offset = till_offset

    @property
    def fusable(self) -> bool:
        """True when chunk digests can be verified on the device (MUR3X256
        needs 16-byte packets, HighwayHash 4-byte words)."""
        return self.shard_size % chunk_align(native_algo_id(self.algo)) == 0

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


def new_bitrot_writer(sink, algo: BitrotAlgorithm, shard_size: int):
    if not algo.streaming:
        raise NotImplementedError(_NOT_PORTED.format(algo.value))
    return StreamingBitrotWriter(sink, algo, shard_size)


def new_bitrot_reader(src, algo: BitrotAlgorithm, till_offset: int,
                      shard_size: int):
    if not algo.streaming:
        raise NotImplementedError(_NOT_PORTED.format(algo.value))
    return StreamingBitrotReader(src, till_offset, algo, shard_size)
