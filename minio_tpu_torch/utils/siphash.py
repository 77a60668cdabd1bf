"""SipHash-2-4 (64-bit), the port of utils/siphash.py — used only for
object→set placement (reference sipHashMod, cmd/erasure-sets.go:663:
dchest/siphash keyed by the deployment ID). Pure Python is fine here: one
short-string hash per request, microseconds vs the milliseconds of shard
I/O it routes."""
from __future__ import annotations

MASK = 0xFFFFFFFFFFFFFFFF


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & MASK


def siphash24(key: bytes, data: bytes) -> int:
    if len(key) != 16:
        raise ValueError("siphash key must be 16 bytes")
    k0 = int.from_bytes(key[:8], "little")
    k1 = int.from_bytes(key[8:], "little")
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573

    def rounds(n):
        nonlocal v0, v1, v2, v3
        for _ in range(n):
            v0 = (v0 + v1) & MASK
            v1 = _rotl(v1, 13) ^ v0
            v0 = _rotl(v0, 32)
            v2 = (v2 + v3) & MASK
            v3 = _rotl(v3, 16) ^ v2
            v0 = (v0 + v3) & MASK
            v3 = _rotl(v3, 21) ^ v0
            v2 = (v2 + v1) & MASK
            v1 = _rotl(v1, 17) ^ v2
            v2 = _rotl(v2, 32)

    b = len(data) & 0xFF
    i = 0
    while i + 8 <= len(data):
        m = int.from_bytes(data[i:i + 8], "little")
        v3 ^= m
        rounds(2)
        v0 ^= m
        i += 8
    tail = data[i:] + b"\x00" * (7 - (len(data) - i))
    m = int.from_bytes(tail, "little") | (b << 56)
    v3 ^= m
    rounds(2)
    v0 ^= m
    v2 ^= 0xFF
    rounds(4)
    return (v0 ^ v1 ^ v2 ^ v3) & MASK


def sip_hash_mod(key: str, cardinality: int, id_bytes: bytes) -> int:
    """Reference sipHashMod: siphash(key) % cardinality with a 16-byte id
    (deploymentID) as the hash key."""
    return siphash24(id_bytes[:16].ljust(16, b"\0"),
                     key.encode()) % cardinality
