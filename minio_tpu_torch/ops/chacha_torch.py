"""ChaCha20 keystream XOR in plain PyTorch — the port of ops/chacha_pallas.py
and the plain version of the CUDA kernel in chacha_cuda.py.

- ``multi_xor`` is the counterpart of ``chacha_pallas.multi_fn_for``: the
  packages of many objects, each object under its own key.
- ``xor_packages`` is the counterpart of ``chacha_pallas.xor_packages_device``:
  one object's packages under one key.

Layout, as in the JAX package: package p of item i has nb = W/16 data blocks
and one more lane first, counter 0, whose keystream head (8 words) is that
package's Poly1305 one-time key; data block j (0-based) uses counter j + 1.
Every 64-byte block is one lane of [16]-word state tensors. PyTorch's uint32
has no shifts or adds and int32 ``>>`` is arithmetic, so the state lives in
int64 holding values below 2**32, masked after every add and shift.

Bit-identical to crypto/chacha20poly1305.keystream_xor (pinned in tests).
"""
from __future__ import annotations

import numpy as np
import torch

from .rs_torch import to_i32, to_u32_i64

_CONSTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_M = 0xFFFFFFFF


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M


def _qr(s: list, a: int, b: int, c: int, d: int) -> None:
    s[a] = (s[a] + s[b]) & _M
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _M
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & _M
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _M
    s[b] = _rotl(s[b] ^ s[c], 7)


def check_shapes(keys: torch.Tensor, nonces: torch.Tensor,
                 data: torch.Tensor) -> None:
    """keys [I, 8], nonces [I, P, 3], data [I, P, W] with W % 16 == 0."""
    if data.dim() != 3 or data.shape[-1] % 16:
        raise ValueError(f"data {tuple(data.shape)} is not [I, P, W] with "
                         "W a multiple of 16 words (64-byte packages)")
    items, pkgs, _ = data.shape
    if tuple(keys.shape) != (items, 8) or \
            tuple(nonces.shape) != (items, pkgs, 3):
        raise ValueError(f"keys {tuple(keys.shape)} / nonces "
                         f"{tuple(nonces.shape)} do not match data "
                         f"{tuple(data.shape)}")


def check_shared_nonce(nonces: np.ndarray) -> None:
    """The packages of one object share nonce words 0 and 1 (base_iv[:8]);
    only word 2, the package sequence, varies. ``nonces`` [..., P, 3]."""
    n = np.asarray(nonces)
    if not (np.all(n[..., 0] == n[..., :1, 0])
            and np.all(n[..., 1] == n[..., :1, 1])):
        raise ValueError("packages of one object share nonce words 0/1 "
                         "(base_iv[:8]); only word 2 varies per package")


def multi_xor(keys: torch.Tensor, nonces: torch.Tensor, data: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys int32 [I, 8], nonces int32 [I, P, 3], data int32 [I, P, W]) ->
    (xored int32 [I, P, W], poly_keys int32 [I, P, 8])."""
    check_shapes(keys, nonces, data)
    items, pkgs, words = data.shape
    nb = words // 16
    shape = (items, pkgs, nb + 1)
    k = to_u32_i64(keys)
    n = to_u32_i64(nonces)
    init = [torch.full(shape, c, dtype=torch.int64, device=data.device)
            for c in _CONSTS]
    init += [k[:, i, None, None].expand(shape) for i in range(8)]
    init.append(torch.arange(nb + 1, dtype=torch.int64,
                             device=data.device).expand(shape))
    init += [n[:, :, i, None].expand(shape) for i in range(3)]
    s = list(init)
    for _ in range(10):
        _qr(s, 0, 4, 8, 12)
        _qr(s, 1, 5, 9, 13)
        _qr(s, 2, 6, 10, 14)
        _qr(s, 3, 7, 11, 15)
        _qr(s, 0, 5, 10, 15)
        _qr(s, 1, 6, 11, 12)
        _qr(s, 2, 7, 8, 13)
        _qr(s, 3, 4, 9, 14)
    ks = torch.stack([(s[i] + init[i]) & _M for i in range(16)], dim=-1)
    x = to_u32_i64(data).reshape(items, pkgs, nb, 16)
    xored = to_i32(x ^ ks[:, :, 1:]).reshape(items, pkgs, words)
    return xored, to_i32(ks[:, :, 0, :8])


def key_words(key: bytes, device) -> torch.Tensor:
    """A 32-byte key as int32 [1, 8] (its little-endian words)."""
    if len(key) != 32:
        raise ValueError("ChaCha20 keys are 32 bytes")
    return torch.from_numpy(np.frombuffer(key, "<u4").view(np.int32)
                            .reshape(1, 8).copy()).to(device)


def xor_packages(key: bytes, nonces: torch.Tensor, data: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One object's packages under one key: (nonces int32 [P, 3], data
    int32 [P, W]) -> (xored [P, W], poly_keys [P, 8])."""
    check_shared_nonce(nonces.cpu().numpy())
    out, pk = multi_xor(key_words(key, data.device), nonces[None], data[None])
    return out[0], pk[0]
