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
item count I and ``launch_pkgs`` by package count P (powers of two).
``launch_plan`` picks the layout of a launch: four threads per 64-byte
block for the small launches the paths make, one for the large ones.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_build
from .chacha_torch import (check_shapes, check_shared_nonce, key_words,
                           multi_xor)
from .rs_cuda import (COUNT_LOCK, SMS, _as_i32, _check_cuda, _sms,
                      count_launch)

__all__ = ["ChachaPlan", "chacha20_xor", "four_lane_plan", "launch",
           "launch_empty", "launch_pkgs", "launch_plan", "launch_sizes",
           "launches", "one_lane_plan", "reset_launches", "xor_packages"]

#: threads per K4 CTA
THREADS = 128
#: the four-lane layout's reach: K4 runs four threads per block while one
#: thread per block would give the SMs at most this many warps each (three
#: CTAs: I <= 3 at 16 packages of 64 KiB); from I = 4 one thread per block
#: was as fast or faster on an H100 SXM (tools/kernel_rows.py --sweep and
#: chip_smoke.py, PERF.md §6: the shuffles and per-lane selects double a
#: block's instructions, which only a card with idle schedulers absorbs)
QUAD_MAX_WARPS_PER_SM = 12


class ChachaPlan(NamedTuple):
    """CTA geometry of a K4 launch over ``blocks`` 64-byte ChaCha20 blocks
    (each package's counter-0 key block included): ``lanes_per_block``
    threads per block, ``threads`` per CTA, ``grid`` CTAs."""
    lanes_per_block: int
    threads: int
    grid: int
    blocks: int


def _plan(items: int, pkgs: int, words: int, lanes: int) -> ChachaPlan:
    if items <= 0 or pkgs <= 0 or words <= 0 or words % 16:
        raise ValueError(f"K4 cannot take I={items} P={pkgs} W={words}")
    blocks = items * pkgs * (words // 16 + 1)
    grid = -(-blocks * lanes // THREADS)
    if grid > 0x7FFFFFFF:
        raise ValueError(f"K4's grid of {grid} CTAs is too large")
    return ChachaPlan(lanes, THREADS, grid, blocks)


def one_lane_plan(items: int, pkgs: int, words: int) -> ChachaPlan:
    """One thread per 64-byte block, the whole state in its registers."""
    return _plan(items, pkgs, words, 1)


def four_lane_plan(items: int, pkgs: int, words: int) -> ChachaPlan:
    """Four threads per 64-byte block, one column of the state each."""
    return _plan(items, pkgs, words, 4)


def launch_plan(items: int, pkgs: int, words: int, sms: int = SMS
                ) -> ChachaPlan:
    """K4's geometry for ``items`` x ``pkgs`` packages of ``words`` words:
    four threads per block while one thread per block would give the SMs
    at most ``QUAD_MAX_WARPS_PER_SM`` warps each, else one. Raises for
    shapes the kernel cannot take."""
    one = one_lane_plan(items, pkgs, words)
    if one.blocks <= QUAD_MAX_WARPS_PER_SM * 32 * sms:
        return four_lane_plan(items, pkgs, words)
    return one


#: kernel launches (plain-version calls are not counted)
launches = {"chacha20_xor": 0}
#: the same launches by item count I, rounded up to a power of two
launch_sizes: dict[str, dict[int, int]] = {"chacha20_xor": {}}
#: the same launches by package count P, rounded up to a power of two
launch_pkgs: dict[str, dict[int, int]] = {"chacha20_xor": {}}


def reset_launches() -> None:
    launches["chacha20_xor"] = 0
    launch_sizes["chacha20_xor"] = {}
    launch_pkgs["chacha20_xor"] = {}


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
    plan = launch_plan(items, pkgs, words, _sms(data.device.index or 0))
    return launch(keys, nonces, data, out, poly, plan)


def launch(keys: torch.Tensor, nonces: torch.Tensor, data: torch.Tensor,
           out: torch.Tensor, poly: torch.Tensor, plan: ChachaPlan
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 at ``plan`` on checked CUDA tensors (``chacha20_xor`` gives it
    ``launch_plan``'s); counts the launch."""
    items, pkgs, words = data.shape
    lib = cuda_build.library("chacha20")
    with torch.cuda.device(data.device):
        err = lib.chacha20_xor(
            keys.data_ptr(), nonces.data_ptr(), data.data_ptr(),
            out.data_ptr(), poly.data_ptr(), items, pkgs, words,
            plan.lanes_per_block, plan.threads, plan.grid,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "chacha20_xor")
    count_launch(launches, launch_sizes, "chacha20_xor", items)
    bucket = 1 << (pkgs - 1).bit_length()
    with COUNT_LOCK:
        by_p = launch_pkgs["chacha20_xor"]
        by_p[bucket] = by_p.get(bucket, 0) + 1
    return out, poly


def launch_empty(plan: ChachaPlan, device) -> None:
    """An empty kernel of K4's library at ``plan``'s grid and block (a
    launch's floor at that geometry; not counted)."""
    lib = cuda_build.library("chacha20")
    with torch.cuda.device(device):
        err = lib.chacha20_empty(plan.grid, plan.threads,
                                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "chacha20_empty")


def xor_packages(key: bytes, nonces: torch.Tensor, data: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One object's packages under one key: (nonces int32 [P, 3], data
    int32 [P, W]) -> (xored [P, W], poly_keys [P, 8])."""
    check_shared_nonce(nonces.cpu().numpy())
    out, pk = chacha20_xor(key_words(key, data.device), nonces[None],
                           data[None])
    return out[0], pk[0]
