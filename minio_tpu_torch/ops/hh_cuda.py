"""Wrapper for the HighwayHash-256 Hopper kernel of csrc/highwayhash.cu —
the port of ops/hh_jax.py (plain jnp in the JAX package, the device hash of
the default HighwayHash256S bitrot algorithm).

``highwayhash256_chunks`` (K5) digests chunks of ``nbytes`` bytes (any
multiple of 4, a remainder past the last 32-byte packet included) given as
32-bit words [..., nbytes//4] -> digest words [..., 8]; it replaces
hh_jax._hash256_core / hash256_device_words. Given CPU tensors it returns
its plain version, ``highwayhash256_ref`` (ops/hh_torch.py); given CUDA
tensors it launches the kernel on the current stream or raises.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import cuda_build
from .hh_torch import hash256_device_words as highwayhash256_ref
from .rs_cuda import _as_i32, _check_cuda

__all__ = ["highwayhash256_chunks", "highwayhash256_ref", "launches",
           "reset_launches"]

#: kernel launches (plain-version calls are not counted)
launches = {"highwayhash256_chunks": 0}


def reset_launches() -> None:
    launches["highwayhash256_chunks"] = 0


def highwayhash256_chunks(key_words: tuple[int, ...], nbytes: int,
                          data32: torch.Tensor) -> torch.Tensor:
    """int32 words [..., nbytes//4] -> int32 digests [..., 8] under the
    key's four little-endian uint64 words (hh_torch.key_words)."""
    if nbytes <= 0 or nbytes % 4:
        raise ValueError("device HighwayHash needs 4-byte-aligned chunks")
    data32 = _as_i32(data32, "data32")
    if data32.dim() < 1 or data32.shape[-1] != nbytes // 4:
        raise ValueError(f"data32 {tuple(data32.shape)} is not [..., "
                         f"{nbytes // 4}]")
    if data32.device.type == "cpu":
        return highwayhash256_ref(key_words, nbytes, data32)
    _check_cuda(data32)
    batch = data32.shape[:-1]
    out = torch.empty(batch + (8,), dtype=torch.int32, device=data32.device)
    n = out.numel() // 8
    if n == 0:
        return out
    lib = cuda_build.library("highwayhash")
    with torch.cuda.device(data32.device):
        err = lib.hh256_chunks(
            data32.data_ptr(), out.data_ptr(), n, nbytes,
            *(int(k) & 0xFFFFFFFFFFFFFFFF for k in key_words),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "highwayhash256_chunks")
    launches["highwayhash256_chunks"] += 1
    return out
