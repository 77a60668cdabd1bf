"""Wrapper for the HighwayHash-256 Hopper kernel of csrc/highwayhash.cu —
the port of ops/hh_jax.py (plain jnp in the JAX package, the device hash of
the default HighwayHash256S bitrot algorithm) — and the launch plan it
shares with the MUR3X256 kernel (ops/mur3_cuda.py).

``highwayhash256_chunks`` (K5) digests chunks of ``nbytes`` bytes (any
multiple of 4, a remainder past the last 32-byte packet included) given as
32-bit words [..., nbytes//4] -> digest words [..., 8]; it replaces
hh_jax._hash256_core / hash256_device_words. Given CPU tensors it returns
its plain version, ``highwayhash256_ref`` (ops/hh_torch.py); given CUDA
tensors it launches the kernel on the current stream or raises.
``launches`` counts kernel launches, ``launch_sizes`` the same launches by
chunk count (powers of two).

``launch_plan`` is the CTA geometry of both bitrot-hash kernels: two
threads per chunk, a shared-memory ring of bulk-copied tiles
(csrc/chunk_ring.cuh), and the chunks spread over every SM.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import cuda_build
from .hh_torch import hash256_device_words as highwayhash256_ref
from .rs_cuda import _as_i32, _check_cuda, count_launch

__all__ = ["LaunchPlan", "count_launch", "highwayhash256_chunks",
           "highwayhash256_ref", "launch_plan", "launch_sizes", "launches",
           "reset_launches"]

#: kernel launches (plain-version calls are not counted)
launches = {"highwayhash256_chunks": 0}
#: the same launches by chunk count, rounded up to a power of two
launch_sizes: dict[str, dict[int, int]] = {"highwayhash256_chunks": {}}

#: the H100 SXM's SMs, the default of ``launch_plan``
SMS = 132
#: two CTAs per SM, each with at most half of the SM's 228 KB of shared
#: memory less the 1 KB the card keeps per CTA
CTAS_PER_SM = 2
CTA_SMEM = 115_712
#: the ring (csrc/chunk_ring.cuh): its barrier header, the tiles it tries
#: (largest first), its stages at most, and the chunks of a CTA at most (two
#: threads each, plus the producer warp: 544 threads, kMaxThreads)
RING_HEADER = 128
TILES = (4096, 2048, 1024, 512)
MAX_STAGES = 4
MAX_CHUNKS_PER_CTA = 256


class LaunchPlan(NamedTuple):
    """CTA geometry of a K3/K5 launch over n chunks. CTA b hashes chunks
    [b*n//grid, (b+1)*n//grid), at most ``chunks_per_cta``; its ring holds
    ``stages`` tiles of ``tile_bytes`` per chunk, rows ``pitch`` bytes
    apart."""
    grid: int
    chunks_per_cta: int
    stages: int
    tile_bytes: int
    pitch: int
    smem_bytes: int
    threads: int


def _pitch(tile: int) -> int:
    """Row pitch of a tile: 32 mod 128 bytes, so the 16-byte reads of the
    4 chunks a quarter warp touches fall on distinct banks."""
    return -(-tile // 128) * 128 + 32


def launch_plan(n: int, nbytes: int, bulk: bool = True,
                sms: int = SMS) -> LaunchPlan:
    """The plan for ``n`` chunks of ``nbytes``: two CTAs per SM, each with
    as few chunks as still fills ``sms`` SMs (grid = min(n, 2 * sms *
    waves), where more waves come only when a CTA's shared memory or thread
    cap cannot hold its share), then the largest tile of ``TILES`` (at most
    the chunk) of which two stages per chunk fit the CTA's half of the SM,
    and as many stages of it as fit, up to 4. A chunk's tiles hold whole
    32-byte packets whenever it spans more than one. ``bulk`` False is the
    direct-load case (rows bulk copies cannot take): no ring (0 stages, 0
    shared memory), no producer warp."""
    if n <= 0 or nbytes <= 0:
        raise ValueError(f"no chunks to plan: n={n}, nbytes={nbytes}")
    row = -(-nbytes // 16) * 16
    room = CTA_SMEM - RING_HEADER
    cap = MAX_CHUNKS_PER_CTA
    if bulk:
        cap = min(cap, room // (2 * _pitch(min(TILES[-1], row))))
    waves = -(-n // (CTAS_PER_SM * sms * cap))
    grid = min(n, CTAS_PER_SM * sms * waves)
    per_cta = -(-n // grid)
    threads = -(-2 * per_cta // 32) * 32
    if not bulk:
        return LaunchPlan(grid, per_cta, 0, 0, 0, 0, threads)
    for t in TILES:
        tile = min(t, row)
        pitch = _pitch(tile)
        tiles = -(-nbytes // tile)
        stages = min(MAX_STAGES, tiles, room // (per_cta * pitch))
        if stages >= min(2, tiles):
            break
    return LaunchPlan(grid, per_cta, stages, tile, pitch,
                      RING_HEADER + stages * per_cta * pitch, threads + 32)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_plan(n: int, nbytes: int, data32: torch.Tensor) -> LaunchPlan:
    """``launch_plan`` for the card ``data32`` lies on; the ring's case when
    bulk copies take the rows (nbytes % 16 == 0, 16-byte aligned)."""
    bulk = nbytes % 16 == 0 and data32.data_ptr() % 16 == 0
    return launch_plan(n, nbytes, bulk, _sms(data32.device.index or 0))


def reset_launches() -> None:
    launches["highwayhash256_chunks"] = 0
    launch_sizes["highwayhash256_chunks"] = {}


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
    plan = device_plan(n, nbytes, data32)
    lib = cuda_build.library("highwayhash")
    with torch.cuda.device(data32.device):
        err = lib.hh256_chunks(
            data32.data_ptr(), out.data_ptr(), n, nbytes, plan.grid,
            plan.chunks_per_cta, plan.stages, plan.tile_bytes, plan.pitch,
            *(int(k) & 0xFFFFFFFFFFFFFFFF for k in key_words),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "highwayhash256_chunks")
    count_launch(launches, launch_sizes, "highwayhash256_chunks", n)
    return out
