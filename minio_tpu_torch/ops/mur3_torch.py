"""MUR3X256 in plain PyTorch, batched over chunks — the port of
ops/mur3_jax.py and the plain version of the CUDA kernel in mur3_cuda.py.

The 16-byte packet chain runs as a Python loop over packets, vectorised
across every chunk of the batch, with both seeded instances as the rows of
[2, N] state tensors (the seed-independent half of each packet is computed
once). PyTorch's uint32 has no shifts, adds or multiplies and int32 ``>>``
is arithmetic, so the state lives in int64 holding values below 2**32, and
every shift, add and multiply is masked with 0xFFFFFFFF.

Bit-identical to minio_tpu_torch/native/mur3py.py (and to the JAX package's
implementations); pinned in tests.
"""
from __future__ import annotations

import struct

import torch

from .rs_torch import to_i32, to_u32_i64

_C1, _C2, _C3, _C4 = 0x239B961B, 0xAB0E9789, 0x38B34AE5, 0xA1E38B93
_A = (0x561CCD1B, 0x0BCAA747, 0x96CD1C35, 0x32AC3B17)
_F1, _F2 = 0x85EBCA6B, 0xC2B2AE35
_M = 0xFFFFFFFF


def seeds_from_key(key: bytes) -> tuple[int, int]:
    """seed1 = LE u32 word 0, seed2 = LE u32 word 4 ^ golden ratio (the
    second instance must differ even under an all-equal-words key)."""
    s1 = struct.unpack_from("<I", key, 0)[0]
    s2 = struct.unpack_from("<I", key, 16)[0] ^ 0x9E3779B9
    return s1, s2


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    # int64 products wrap modulo 2**64, which keeps the low 32 bits exact
    return (x * c) & _M


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul(h, _F1)
    h = h ^ (h >> 13)
    h = _mul(h, _F2)
    return h ^ (h >> 16)


def _key_words(key: bytes) -> tuple[int, int]:
    """The two instance seeds for a bitrot key."""
    return seeds_from_key(key)


def hash256_device_words(key_words: tuple[int, int], nbytes: int,
                         data32: torch.Tensor) -> torch.Tensor:
    """Digest chunks of ``nbytes`` bytes given as 32-bit LE words
    [..., nbytes//4] -> int32 digest words [..., 8] (instance 0's h1..h4,
    then instance 1's)."""
    if nbytes % 16:
        raise ValueError("device MUR3X256 needs 16-byte-multiple chunks")
    if data32.shape[-1] != nbytes // 4:
        raise ValueError(f"last dim {data32.shape[-1]} != nbytes/4")
    batch = data32.shape[:-1]
    x = to_u32_i64(data32).reshape(-1, nbytes // 16, 4)
    n = x.shape[0]
    seeds = torch.tensor([[key_words[0]], [key_words[1]]], dtype=torch.int64,
                         device=data32.device).expand(2, n)
    h = [seeds.clone() for _ in range(4)]
    for b in range(nbytes // 16):
        k = x[:, b]
        ks = (_mul(_rotl(_mul(k[:, 0], _C1), 15), _C2),
              _mul(_rotl(_mul(k[:, 1], _C2), 16), _C3),
              _mul(_rotl(_mul(k[:, 2], _C3), 17), _C4),
              _mul(_rotl(_mul(k[:, 3], _C4), 18), _C1))
        for j, r in enumerate((19, 17, 15, 13)):
            nxt = h[(j + 1) % 4]
            h[j] = (_mul((_rotl(h[j] ^ ks[j], r) + nxt) & _M, 5) + _A[j]) & _M
    h = [v ^ nbytes for v in h]
    h[0] = (h[0] + h[1] + h[2] + h[3]) & _M
    h[1:] = [(v + h[0]) & _M for v in h[1:]]
    h = [_fmix(v) for v in h]
    h[0] = (h[0] + h[1] + h[2] + h[3]) & _M
    h[1:] = [(v + h[0]) & _M for v in h[1:]]
    # [4, 2, n] -> [n, 8]
    dig = torch.stack(h).permute(2, 1, 0).reshape(n, 8)
    return to_i32(dig).reshape(batch + (8,))
