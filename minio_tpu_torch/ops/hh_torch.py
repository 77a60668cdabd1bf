"""HighwayHash-256 in plain PyTorch, batched over chunks — the port of
ops/hh_jax.py (``hash256_device_words``) and the plain version of the CUDA
kernel in hh_cuda.py.

The JAX package emulates each 64-bit lane as a (lo, hi) uint32 pair because
the TPU has no 64-bit integers. Here the lanes are int64 tensors holding the
bits of the uint64 values: adds and the 32x32->64 multiply wrap modulo 2**64
as uint64 arithmetic does (two values below 2**32 multiply exactly into the
same bits), and XOR, AND, OR and left shifts act on the bits alike. Only
``>>`` differs, being arithmetic: every right shift is masked back to the
bits a logical shift keeps (the multiply's ``>> 32``, the zipper merge's
high byte, the half swap and the modular reduction's ``>> 62/63``).

The 16 state rows run as [4, N] tensors, one column per chunk, through one
Python loop over the packets. Chunks are int32 words [..., nbytes/4], so
``nbytes % 4 == 0`` (erasure shards are 4-byte aligned), as in hh_jax.py.
Bit-identical to native/hhpy.py and to the JAX package's implementations;
pinned in tests.
"""
from __future__ import annotations

import torch

from .rs_torch import to_i32, to_u32_i64

_M32 = 0xFFFFFFFF
_INIT0 = (0xdbe6d5d5fe4cce2f, 0xa4093822299f31d0,
          0x13198a2e03707344, 0x243f6a8885a308d3)
_INIT1 = (0x3bd39e10cb0ef593, 0xc0acf169b5f18a8c,
          0xbe5466cf34e90c6c, 0x452821e638d01377)


def _s(v: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding uint64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _swap32(x: torch.Tensor) -> torch.Tensor:
    return _shr(x, 32) | (x << 32)


def _zipper(x: torch.Tensor) -> torch.Tensor:
    """ZipperMergeAndAdd's addends for both lane pairs of ``x`` [4, N]: the
    pair (x[2j+1], x[2j]) gives the addend of lane 2j and of lane 2j+1."""
    v0, v1 = x[0::2], x[1::2]
    add0 = (_shr((v0 & 0xff000000) | (v1 & 0xff00000000), 24)
            | _shr((v0 & 0xff0000000000) | (v1 & 0xff000000000000), 16)
            | (v0 & 0xff0000) | ((v0 & 0xff00) << 32)
            | _shr(v1 & _s(0xff00000000000000), 8) | (v0 << 56))
    add1 = (_shr((v1 & 0xff000000) | (v0 & 0xff00000000), 24)
            | (v1 & 0xff0000) | _shr(v1 & 0xff0000000000, 16)
            | ((v1 & 0xff00) << 24) | _shr(v0 & 0xff000000000000, 8)
            | ((v1 & 0xff) << 48) | (v0 & _s(0xff00000000000000)))
    return torch.stack([add0[0], add1[0], add0[1], add1[1]])


def _update(st: list, lanes: torch.Tensor) -> None:
    """One packet: ``st`` = [v0, v1, mul0, mul1], each int64 [4, N]."""
    v0, v1, mul0, mul1 = st
    v1 = v1 + mul0 + lanes
    mul0 = mul0 ^ ((v1 & _M32) * _shr(v0, 32))
    v0 = v0 + mul1
    mul1 = mul1 ^ ((v0 & _M32) * _shr(v1, 32))
    v0 = v0 + _zipper(v1)
    v1 = v1 + _zipper(v0)
    st[:] = [v0, v1, mul0, mul1]


def _modular_reduction(a3, a2, a1, a0):
    a3 = a3 & 0x3fffffffffffffff
    m1 = a1 ^ ((a3 << 1) | _shr(a2, 63)) ^ ((a3 << 2) | _shr(a2, 62))
    m0 = a0 ^ (a2 << 1) ^ (a2 << 2)
    return m1, m0


def _pairs(w: torch.Tensor) -> torch.Tensor:
    """int64 words [..., 8] below 2**32 -> uint64 lanes [..., 4]."""
    return w[..., 0::2] | (w[..., 1::2] << 32)


def key_words(key: bytes) -> tuple[int, ...]:
    """The 32-byte key as four little-endian uint64 words."""
    if len(key) != 32:
        raise ValueError("HighwayHash key must be 32 bytes")
    return tuple(int.from_bytes(key[8 * i: 8 * i + 8], "little")
                 for i in range(4))


def hash256_device_words(key_words: tuple[int, ...], nbytes: int,
                         data32: torch.Tensor) -> torch.Tensor:
    """Digest chunks of ``nbytes`` bytes given as 32-bit LE words
    [..., nbytes/4] -> int32 digest words [..., 8]."""
    if nbytes % 4:
        raise ValueError("device HighwayHash needs 4-byte-aligned chunks")
    if data32.shape[-1] != nbytes // 4:
        raise ValueError(f"last dim {data32.shape[-1]} != nbytes/4")
    batch = data32.shape[:-1]
    x = to_u32_i64(data32).reshape(-1, nbytes // 4)
    n = x.shape[0]
    dev = x.device

    def col(vals):
        return torch.tensor([_s(v) for v in vals], dtype=torch.int64,
                            device=dev)[:, None].expand(4, n)

    k = [_s(v) for v in key_words]
    krot = [_s(((v >> 32) | (v << 32)) & ((1 << 64) - 1)) for v in key_words]
    init0, init1 = col(_INIT0), col(_INIT1)
    st = [init0 ^ torch.tensor(k, device=dev)[:, None],
          init1 ^ torch.tensor(krot, device=dev)[:, None], init0, init1]
    n_pkts = nbytes // 32
    if n_pkts:
        # packet-major lanes [n_pkts, 4, N]
        pk = _pairs(x[:, : n_pkts * 8].reshape(n, n_pkts, 8))
        pk = pk.permute(1, 2, 0).contiguous()
        for p in range(n_pkts):
            _update(st, pk[p])
    rem = nbytes & 31
    if rem:
        st[0] = st[0] + ((rem << 32) + rem)
        halves = (st[1] & _M32, _shr(st[1], 32))
        lo, hi = (((h << rem) | (h >> (32 - rem))) & _M32 for h in halves)
        st[1] = lo | (hi << 32)
        nw = rem // 4
        packet = torch.zeros((n, 8), dtype=torch.int64, device=dev)
        packet[:, :nw] = x[:, n_pkts * 8:]
        if rem & 16:
            packet[:, 7] = x[:, -1]
        _update(st, _pairs(packet).T)
    for _ in range(10):
        _update(st, _swap32(st[0][[2, 3, 0, 1]]))
    v0, v1, mul0, mul1 = st
    h1, h0 = _modular_reduction(v1[1] + mul1[1], v1[0] + mul1[0],
                                v0[1] + mul0[1], v0[0] + mul0[0])
    h3, h2 = _modular_reduction(v1[3] + mul1[3], v1[2] + mul1[2],
                                v0[3] + mul0[3], v0[2] + mul0[2])
    words = [w for h in (h0, h1, h2, h3) for w in (h & _M32, _shr(h, 32))]
    return to_i32(torch.stack(words, dim=-1)).reshape(batch + (8,))
