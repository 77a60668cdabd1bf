"""Wrapper for the MUR3X256 Hopper kernel of csrc/mur3x256.cu — the port of
ops/mur3_pallas.py.

``mur3x256_chunks`` (K3) digests chunks of ``nbytes`` bytes given as 32-bit
words [..., nbytes//4] -> digest words [..., 8]; it replaces
mur3_pallas._make_kernel / _jitted. Given CPU tensors it returns its plain
version, ``mur3x256_ref`` (ops/mur3_torch.py); given CUDA tensors it
launches the kernel on the current stream or raises, with the CTA geometry
of ``hh_cuda.launch_plan``. ``launches`` counts kernel launches,
``launch_sizes`` the same launches by chunk count (powers of two).
"""
from __future__ import annotations

import torch

from . import cuda_build
from .mur3_torch import hash256_device_words as mur3x256_ref
from .hh_cuda import count_launch, device_plan
from .rs_cuda import _as_i32, _check_cuda

__all__ = ["mur3x256_chunks", "mur3x256_ref", "launch_sizes", "launches",
           "reset_launches"]

#: kernel launches (plain-version calls are not counted)
launches = {"mur3x256_chunks": 0}
#: the same launches by chunk count, rounded up to a power of two
launch_sizes: dict[str, dict[int, int]] = {"mur3x256_chunks": {}}


def reset_launches() -> None:
    launches["mur3x256_chunks"] = 0
    launch_sizes["mur3x256_chunks"] = {}


def mur3x256_chunks(key_words: tuple[int, int], nbytes: int,
                    data32: torch.Tensor) -> torch.Tensor:
    """int32 words [..., nbytes//4] -> int32 digests [..., 8]."""
    if nbytes % 16:
        raise ValueError("device MUR3X256 needs 16-byte-multiple chunks")
    data32 = _as_i32(data32, "data32")
    if data32.dim() < 1 or data32.shape[-1] != nbytes // 4:
        raise ValueError(f"data32 {tuple(data32.shape)} is not [..., "
                         f"{nbytes // 4}]")
    if data32.device.type == "cpu":
        return mur3x256_ref(key_words, nbytes, data32)
    _check_cuda(data32)
    if data32.data_ptr() % 16:
        raise ValueError("data32 must be 16-byte aligned")
    batch = data32.shape[:-1]
    out = torch.empty(batch + (8,), dtype=torch.int32, device=data32.device)
    n = out.numel() // 8
    if n == 0:
        return out
    plan = device_plan(n, nbytes, data32)
    lib = cuda_build.library("mur3x256")
    with torch.cuda.device(data32.device):
        err = lib.mur3_chunks(
            data32.data_ptr(), out.data_ptr(), n, nbytes, plan.grid,
            plan.chunks_per_cta, plan.stages, plan.tile_bytes, plan.pitch,
            int(key_words[0]) & 0xFFFFFFFF, int(key_words[1]) & 0xFFFFFFFF,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "mur3x256_chunks")
    count_launch(launches, launch_sizes, "mur3x256_chunks", n)
    return out
