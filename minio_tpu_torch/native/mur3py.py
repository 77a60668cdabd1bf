"""MUR3X256 on the host: two seeded MurmurHash3_x86_128 instances giving a
256-bit digest per chunk (the bitrot hash of the MUR3X256S algorithm).

The port's copy of minio_tpu/native/mur3py.py without its ctypes library:
a pure-Python digest (``digest256_py``, the reference every other
implementation is pinned to) and a numpy batch form (``hash256_batch``)
that runs the 16-byte packet chain once for all chunks of a batch, so its
per-packet numpy overhead is shared across the batch. The batch form takes
any chunk length: the MurmurHash3 tail of a short final chunk is the same
zero-padded packet mix, applied without the per-packet h rotation. No path
of the port calls it: host digests come from the native library
(native/__init__.py); the tests and ``chip_smoke.py`` hold that library to
it.
"""
from __future__ import annotations

import struct

import numpy as np

_C1, _C2, _C3, _C4 = 0x239B961B, 0xAB0E9789, 0x38B34AE5, 0xA1E38B93
_A1, _A2, _A3, _A4 = 0x561CCD1B, 0x0BCAA747, 0x96CD1C35, 0x32AC3B17
_F1, _F2 = 0x85EBCA6B, 0xC2B2AE35
_M = 0xFFFFFFFF

#: below this many chunks the pure-Python loop beats the numpy batch
#: (whose cost per packet is nearly independent of the batch width)
_VECTOR_MIN = 16


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def _fmix(h: int) -> int:
    h ^= h >> 16
    h = (h * _F1) & _M
    h ^= h >> 13
    h = (h * _F2) & _M
    h ^= h >> 16
    return h


def _x86_128(seed: int, data: bytes) -> bytes:
    """MurmurHash3_x86_128 (public-domain algorithm), pure Python."""
    h1 = h2 = h3 = h4 = seed
    length = len(data)
    nblocks = length // 16
    for i in range(nblocks):
        k1, k2, k3, k4 = struct.unpack_from("<4I", data, i * 16)
        k1 = (k1 * _C1) & _M
        k1 = (_rotl(k1, 15) * _C2) & _M
        h1 ^= k1
        h1 = (_rotl(h1, 19) + h2) & _M
        h1 = (h1 * 5 + _A1) & _M
        k2 = (k2 * _C2) & _M
        k2 = (_rotl(k2, 16) * _C3) & _M
        h2 ^= k2
        h2 = (_rotl(h2, 17) + h3) & _M
        h2 = (h2 * 5 + _A2) & _M
        k3 = (k3 * _C3) & _M
        k3 = (_rotl(k3, 17) * _C4) & _M
        h3 ^= k3
        h3 = (_rotl(h3, 15) + h4) & _M
        h3 = (h3 * 5 + _A3) & _M
        k4 = (k4 * _C4) & _M
        k4 = (_rotl(k4, 18) * _C1) & _M
        h4 ^= k4
        h4 = (_rotl(h4, 13) + h1) & _M
        h4 = (h4 * 5 + _A4) & _M
    tail = data[nblocks * 16:]
    k1 = k2 = k3 = k4 = 0
    t = len(tail)
    if t >= 13:
        for j in range(t - 1, 11, -1):
            k4 = (k4 << 8) | tail[j]
        k4 = (k4 * _C4) & _M
        k4 = (_rotl(k4, 18) * _C1) & _M
        h4 ^= k4
    if t >= 9:
        for j in range(min(t, 12) - 1, 7, -1):
            k3 = (k3 << 8) | tail[j]
        k3 = (k3 * _C3) & _M
        k3 = (_rotl(k3, 17) * _C4) & _M
        h3 ^= k3
    if t >= 5:
        for j in range(min(t, 8) - 1, 3, -1):
            k2 = (k2 << 8) | tail[j]
        k2 = (k2 * _C2) & _M
        k2 = (_rotl(k2, 16) * _C3) & _M
        h2 ^= k2
    if t >= 1:
        for j in range(min(t, 4) - 1, -1, -1):
            k1 = (k1 << 8) | tail[j]
        k1 = (k1 * _C1) & _M
        k1 = (_rotl(k1, 15) * _C2) & _M
        h1 ^= k1
    h1 ^= length
    h2 ^= length
    h3 ^= length
    h4 ^= length
    h1 = (h1 + h2 + h3 + h4) & _M
    h2 = (h2 + h1) & _M
    h3 = (h3 + h1) & _M
    h4 = (h4 + h1) & _M
    h1, h2, h3, h4 = _fmix(h1), _fmix(h2), _fmix(h3), _fmix(h4)
    h1 = (h1 + h2 + h3 + h4) & _M
    h2 = (h2 + h1) & _M
    h3 = (h3 + h1) & _M
    h4 = (h4 + h1) & _M
    return struct.pack("<4I", h1, h2, h3, h4)


def seeds_from_key(key: bytes) -> tuple[int, int]:
    """seed1 = LE u32 word 0, seed2 = LE u32 word 4 ^ golden ratio (the
    second instance must differ even under an all-equal-words key)."""
    s1 = struct.unpack_from("<I", key, 0)[0]
    s2 = struct.unpack_from("<I", key, 16)[0] ^ 0x9E3779B9
    return s1, s2


def digest256_py(key: bytes, data: bytes) -> bytes:
    s1, s2 = seeds_from_key(key)
    return _x86_128(s1, data) + _x86_128(s2, data)


# --- numpy batch form --------------------------------------------------------

_U = np.uint32


def _np_rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U(r)) | (x >> _U(32 - r))


def _np_fmix(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> _U(16))
    h = h * _U(_F1)
    h = h ^ (h >> _U(13))
    h = h * _U(_F2)
    return h ^ (h >> _U(16))


def _np_kmix(k1, k2, k3, k4):
    """The seed-independent half of a packet: each word's multiply-rotate-
    multiply (shared by both instances)."""
    return (_np_rotl(k1 * _U(_C1), 15) * _U(_C2),
            _np_rotl(k2 * _U(_C2), 16) * _U(_C3),
            _np_rotl(k3 * _U(_C3), 17) * _U(_C4),
            _np_rotl(k4 * _U(_C4), 18) * _U(_C1))


def _np_digests(seeds: tuple[int, int], chunks: np.ndarray) -> np.ndarray:
    """uint8 [n, L] -> digest words uint32 [n, 8]; both instances run as
    the rows of [2, n] state arrays."""
    n, length = chunks.shape
    nb = length // 16
    seed = np.array(seeds, dtype=_U)[:, None]
    h1, h2, h3, h4 = (np.repeat(seed, n, axis=1) for _ in range(4))
    if nb:
        # packet-major lane streams: ks[b, i] is word i of packet b of
        # every chunk, contiguous across the batch
        ks = np.ascontiguousarray(
            chunks[:, : nb * 16].view("<u4").reshape(n, nb, 4)
            .transpose(1, 2, 0)).astype(_U, copy=False)
        for b in range(nb):
            k1, k2, k3, k4 = _np_kmix(ks[b, 0], ks[b, 1], ks[b, 2], ks[b, 3])
            h1 = ((_np_rotl(h1 ^ k1, 19) + h2) * _U(5)) + _U(_A1)
            h2 = ((_np_rotl(h2 ^ k2, 17) + h3) * _U(5)) + _U(_A2)
            h3 = ((_np_rotl(h3 ^ k3, 15) + h4) * _U(5)) + _U(_A3)
            h4 = ((_np_rotl(h4 ^ k4, 13) + h1) * _U(5)) + _U(_A4)
    t = length - nb * 16
    if t:
        # a zero word mixes to zero, so the tail mix of the zero-padded
        # packet equals MurmurHash3's byte-count switch
        pad = np.zeros((n, 16), dtype=np.uint8)
        pad[:, :t] = chunks[:, nb * 16:]
        w = pad.view("<u4").astype(_U)
        k1, k2, k3, k4 = _np_kmix(w[:, 0], w[:, 1], w[:, 2], w[:, 3])
        h1, h2, h3, h4 = h1 ^ k1, h2 ^ k2, h3 ^ k3, h4 ^ k4
    ln = _U(length & _M)
    h1, h2, h3, h4 = h1 ^ ln, h2 ^ ln, h3 ^ ln, h4 ^ ln
    h1 = h1 + h2 + h3 + h4
    h2, h3, h4 = h2 + h1, h3 + h1, h4 + h1
    h1, h2, h3, h4 = _np_fmix(h1), _np_fmix(h2), _np_fmix(h3), _np_fmix(h4)
    h1 = h1 + h2 + h3 + h4
    h2, h3, h4 = h2 + h1, h3 + h1, h4 + h1
    # [4, 2, n] -> [n, 8]: instance 0's h1..h4, then instance 1's
    return np.stack([h1, h2, h3, h4]).transpose(2, 1, 0).reshape(n, 8)


def hash256_batch(key: bytes, chunks: np.ndarray) -> np.ndarray:
    """Digest every row of a uint8 [n, L] array -> uint8 [n, 32]."""
    chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
    n = chunks.shape[0]
    if n < _VECTOR_MIN:
        out = np.empty((n, 32), dtype=np.uint8)
        for i in range(n):
            out[i] = np.frombuffer(
                digest256_py(key, chunks[i].tobytes()), dtype=np.uint8)
        return out
    words = _np_digests(seeds_from_key(key), chunks)
    return np.ascontiguousarray(words.astype("<u4")).view(np.uint8)


class Mur3x256:
    """hashlib-shaped buffering wrapper (the bitrot writer hashes one chunk
    per digest, so buffering — not incremental state — is sufficient)."""

    digest_size = 32

    def __init__(self, key: bytes):
        self.key = key
        self._buf = bytearray()

    def update(self, b: bytes):
        self._buf += b

    def digest(self) -> bytes:
        return digest256_py(self.key, bytes(self._buf))
