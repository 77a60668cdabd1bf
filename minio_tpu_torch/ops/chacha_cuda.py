"""Wrapper for the ChaCha20 Hopper kernel of csrc/chacha20.cu — the port of
ops/chacha_pallas.py.

``chacha20_xor`` (K4) XORs the packages of many objects, each under its own
key, with their ChaCha20 keystream and returns each package's Poly1305 key;
it replaces chacha_pallas._make_multi_kernel / multi_fn_for.
``xor_packages`` is one object's packages under one key, the same kernel
with one item; it replaces chacha_pallas._make_kernel / xor_packages_device.
Given CPU tensors they return the plain version (ops/chacha_torch.py);
given CUDA tensors they launch the kernel on the current stream or raise.
``launches`` counts kernel launches, ``launch_sizes`` the same launches by
item count I (powers of two).
"""
from __future__ import annotations

import torch

from . import cuda_build
from .chacha_torch import (check_shapes, check_shared_nonce, key_words,
                           multi_xor)
from .rs_cuda import _as_i32, _check_cuda, count_launch

__all__ = ["chacha20_xor", "xor_packages", "launches", "launch_sizes",
           "reset_launches"]

#: kernel launches (plain-version calls are not counted)
launches = {"chacha20_xor": 0}
#: the same launches by item count I, rounded up to a power of two
launch_sizes: dict[str, dict[int, int]] = {"chacha20_xor": {}}


def reset_launches() -> None:
    launches["chacha20_xor"] = 0
    launch_sizes["chacha20_xor"] = {}


def chacha20_xor(keys: torch.Tensor, nonces: torch.Tensor,
                 data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys int32 [I, 8], nonces int32 [I, P, 3], data int32 [I, P, W],
    W % 16 == 0) -> (xored int32 [I, P, W], poly_keys int32 [I, P, 8])."""
    keys = _as_i32(keys, "keys")
    nonces = _as_i32(nonces, "nonces")
    data = _as_i32(data, "data")
    check_shapes(keys, nonces, data)
    if data.device.type == "cpu":
        return multi_xor(keys, nonces, data)
    _check_cuda(data, keys, nonces)
    items, pkgs, words = data.shape
    out = torch.empty_like(data)
    poly = torch.empty((items, pkgs, 8), dtype=torch.int32,
                       device=data.device)
    if data.numel() == 0:
        return out, poly
    lib = cuda_build.library("chacha20")
    with torch.cuda.device(data.device):
        err = lib.chacha20_xor(
            keys.data_ptr(), nonces.data_ptr(), data.data_ptr(),
            out.data_ptr(), poly.data_ptr(), items, pkgs, words,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "chacha20_xor")
    count_launch(launches, launch_sizes, "chacha20_xor", items)
    return out, poly


def xor_packages(key: bytes, nonces: torch.Tensor, data: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One object's packages under one key: (nonces int32 [P, 3], data
    int32 [P, W]) -> (xored [P, W], poly_keys [P, 8])."""
    check_shared_nonce(nonces.cpu().numpy())
    out, pk = chacha20_xor(key_words(key, data.device), nonces[None],
                           data[None])
    return out[0], pk[0]
