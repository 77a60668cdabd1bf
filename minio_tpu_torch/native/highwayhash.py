"""HighwayHash-256 on the port's native library (highwayhash.cpp through
``libnative.so``) — the port of minio_tpu/native/highwayhash.py: the
hashlib-shaped ``HighwayHash256`` of the HIGHWAYHASH256 and
HIGHWAYHASH256S bitrot algorithms. One-shot and batch digests are
``native.hh256`` and ``native.hh256_batch``.
"""
from __future__ import annotations

from .. import native


class HighwayHash256:
    """hashlib-shaped streaming wrapper: buffers updates, hashes once at
    digest() (bitrot chunks are at most a shard, whole-file shards one
    part, so the buffer is bounded by what the caller writes)."""

    digest_size = 32

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("HighwayHash key must be 32 bytes")
        native.load_native()  # fail here, not at the first digest()
        self._key = key
        self._buf = bytearray()

    def update(self, b) -> None:
        self._buf += b

    def digest(self) -> bytes:
        return native.hh256(self._key, self._buf)

    def hexdigest(self) -> str:
        return self.digest().hex()
