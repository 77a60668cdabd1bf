"""HighwayHash-256 on the host in numpy ``uint64`` — the bitrot hash of the
HIGHWAYHASH256S algorithm, the JAX package's default.

A numpy transcription of highwayhash.cpp, independent of the C++ code: the
same state, update, remainder packet, permute and modular reduction,
vectorised across the 4 lanes of the state and across every chunk of a
batch, so one numpy call per step serves them all. It takes chunks of any
byte length (the remainder rules of the C code for lengths that are not a
multiple of 4 included) and is hashlib-shaped like native/mur3py.py. No
path of the port calls it: host digests come from the native library
(native/__init__.py); the tests and ``chip_smoke.py`` hold that library and
the device hash (ops/hh_cuda.py) to it.
"""
from __future__ import annotations

import numpy as np

_U64 = np.uint64
_M32 = _U64(0xFFFFFFFF)
_INIT0 = np.array([0xdbe6d5d5fe4cce2f, 0xa4093822299f31d0,
                   0x13198a2e03707344, 0x243f6a8885a308d3], _U64)[:, None]
_INIT1 = np.array([0x3bd39e10cb0ef593, 0xc0acf169b5f18a8c,
                   0xbe5466cf34e90c6c, 0x452821e638d01377], _U64)[:, None]


def _swap32(x: np.ndarray) -> np.ndarray:
    return (x >> _U64(32)) | (x << _U64(32))


def _zipper(x: np.ndarray) -> np.ndarray:
    """ZipperMergeAndAdd's addends for both lane pairs of ``x`` [4, n]: the
    pair (x[2j+1], x[2j]) gives the addend of lane 2j and of lane 2j+1."""
    v0, v1 = x[0::2], x[1::2]
    u = _U64
    add0 = ((((v0 & u(0xff000000)) | (v1 & u(0xff00000000))) >> u(24))
            | (((v0 & u(0xff0000000000)) | (v1 & u(0xff000000000000)))
               >> u(16))
            | (v0 & u(0xff0000)) | ((v0 & u(0xff00)) << u(32))
            | ((v1 & u(0xff00000000000000)) >> u(8)) | (v0 << u(56)))
    add1 = ((((v1 & u(0xff000000)) | (v0 & u(0xff00000000))) >> u(24))
            | (v1 & u(0xff0000)) | ((v1 & u(0xff0000000000)) >> u(16))
            | ((v1 & u(0xff00)) << u(24))
            | ((v0 & u(0xff000000000000)) >> u(8))
            | ((v1 & u(0xff)) << u(48))
            | (v0 & u(0xff00000000000000)))
    out = np.empty_like(x)
    out[0::2] = add0
    out[1::2] = add1
    return out


def _update(st: list, lanes: np.ndarray) -> None:
    """One packet: ``st`` = [v0, v1, mul0, mul1], each uint64 [4, n];
    ``lanes`` uint64 [4, n]."""
    v0, v1, mul0, mul1 = st
    v1 = v1 + mul0 + lanes
    mul0 = mul0 ^ ((v1 & _M32) * (v0 >> _U64(32)))
    v0 = v0 + mul1
    mul1 = mul1 ^ ((v0 & _M32) * (v1 >> _U64(32)))
    v0 = v0 + _zipper(v1)
    v1 = v1 + _zipper(v0)
    st[:] = [v0, v1, mul0, mul1]


def _remainder_packet(tail: np.ndarray) -> np.ndarray:
    """The padded 32-byte packet of uint8 [n, r] remainders (0 < r < 32),
    as the C RemainderPacket builds it."""
    n, r = tail.shape
    mod4 = r & 3
    whole = r & ~3
    packet = np.zeros((n, 32), np.uint8)
    packet[:, :whole] = tail[:, :whole]
    if r & 16:
        packet[:, 28:32] = tail[:, r - 4:r]
    elif mod4:
        packet[:, 16] = tail[:, whole]
        packet[:, 17] = tail[:, whole + (mod4 >> 1)]
        packet[:, 18] = tail[:, whole + mod4 - 1]
    return packet


def _lanes(packets: np.ndarray) -> np.ndarray:
    """uint8 [n, 32] -> uint64 lanes [4, n]."""
    return np.ascontiguousarray(packets).view("<u8").astype(_U64).T


def _modular_reduction(a3, a2, a1, a0):
    a3 = a3 & _U64(0x3fffffffffffffff)
    m1 = a1 ^ ((a3 << _U64(1)) | (a2 >> _U64(63))) ^ \
        ((a3 << _U64(2)) | (a2 >> _U64(62)))
    m0 = a0 ^ (a2 << _U64(1)) ^ (a2 << _U64(2))
    return m1, m0


def _key_lanes(key: bytes) -> np.ndarray:
    if len(key) != 32:
        raise ValueError("HighwayHash key must be 32 bytes")
    return np.frombuffer(key, "<u8").astype(_U64)[:, None]


def hash256_batch(key: bytes, chunks: np.ndarray) -> np.ndarray:
    """Digest every row of a uint8 [n, L] array -> uint8 [n, 32]."""
    chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
    n, length = chunks.shape
    k = _key_lanes(key)
    with np.errstate(over="ignore"):
        st = [np.repeat(_INIT0 ^ k, n, axis=1),
              np.repeat(_INIT1 ^ _swap32(k), n, axis=1),
              np.repeat(_INIT0, n, axis=1), np.repeat(_INIT1, n, axis=1)]
        n_pkts = length // 32
        if n_pkts:
            # packet-major: lanes[p] is packet p of every chunk as [4, n]
            pk = chunks[:, : n_pkts * 32].view("<u8").reshape(n, n_pkts, 4)
            pk = np.ascontiguousarray(pk.transpose(1, 2, 0)).astype(_U64)
            for p in range(n_pkts):
                _update(st, pk[p])
        rem = length & 31
        if rem:
            st[0] = st[0] + _U64((rem << 32) + rem)
            lo, hi = st[1] & _M32, st[1] >> _U64(32)
            rot = [((h << _U64(rem)) | (h >> _U64(32 - rem))) & _M32
                   for h in (lo, hi)]
            st[1] = rot[0] | (rot[1] << _U64(32))
            _update(st, _lanes(_remainder_packet(chunks[:, n_pkts * 32:])))
        for _ in range(10):
            v0 = st[0]
            _update(st, _swap32(v0[[2, 3, 0, 1]]))
        v0, v1, mul0, mul1 = st
        h1, h0 = _modular_reduction(v1[1] + mul1[1], v1[0] + mul1[0],
                                    v0[1] + mul0[1], v0[0] + mul0[0])
        h3, h2 = _modular_reduction(v1[3] + mul1[3], v1[2] + mul1[2],
                                    v0[3] + mul0[3], v0[2] + mul0[2])
    out = np.stack([h0, h1, h2, h3], axis=1).astype("<u8")
    return out.view(np.uint8).reshape(n, 32)


def hash256(key: bytes, data: bytes) -> bytes:
    """One-shot 256-bit digest of ``data`` under the 32-byte ``key``."""
    return hash256_batch(
        key, np.frombuffer(bytes(data), np.uint8).reshape(1, -1)).tobytes()


class HighwayHash256:
    """hashlib-shaped buffering wrapper (the bitrot writer hashes one chunk
    per digest, so buffering, not incremental state, is sufficient)."""

    digest_size = 32

    def __init__(self, key: bytes):
        _key_lanes(key)
        self.key = key
        self._buf = bytearray()

    def update(self, b) -> None:
        self._buf += b

    def digest(self) -> bytes:
        return hash256(self.key, bytes(self._buf))
