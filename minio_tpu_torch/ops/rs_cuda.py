"""Wrappers for the GF(256) Hopper kernels — the port of ops/rs_pallas.py.

- ``gf_matmul_batched`` (K1, csrc/gf_matmul.cu): per-element coefficient
  masks [B, 8, o, i] x words [B, i, W] -> [B, o, W]; replaces
  rs_pallas._dyn_batch_kernel (and _dyn_kernel as B = 1). Its CTA geometry
  is ``matmul_plan``'s (``launch_matmul`` takes any of
  ``candidate_plans``).
- ``gf_encode_batched`` (K2, csrc/gf_encode.cu): one fixed uint8 matrix
  [o, i] for the whole batch, compiled into the kernel: one library per
  matrix (``prepare_encode``, a few seconds of ``nvcc`` the first time a
  matrix is seen on a host, then cached in build/); replaces
  rs_pallas._make_static_batch_kernel (and _make_static_kernel as B = 1).
  A CUDA codec (rs_torch.ReedSolomon) prepares its matrix when it is made,
  so no encode flush waits on the compiler.

Words are int32 tensors holding uint32 bits (uint32 tensors are accepted and
viewed as int32). A wrapper given CPU tensors returns its plain version,
``gf_matmul_batched_ref``; given CUDA tensors it launches its kernel on the
current stream or raises. ``launches`` counts kernel launches per wrapper,
``launch_sizes`` K1's and K2's launches by batch size (powers of two),
``launch_rows`` K1's by its output row count o.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_build, gf256, rs_torch

#: kernel launches per wrapper (plain-version calls are not counted); the
#: dispatch queue's two lanes launch from two threads, so every count of
#: this module and its siblings is taken under COUNT_LOCK
COUNT_LOCK = threading.Lock()
launches = {"gf_matmul_batched": 0, "gf_encode_batched": 0}
#: K1's and K2's launches by batch size B, rounded up to a power of two
launch_sizes: dict[str, dict[int, int]] = {"gf_matmul_batched": {},
                                           "gf_encode_batched": {}}
#: K1's launches by output rows o (2 for a heal of two shards, k+m for a
#: whole-stripe rebuild)
launch_rows: dict[str, dict[int, int]] = {"gf_matmul_batched": {}}
#: K2's largest input count (its kernel keeps the i input words of a
#: column in registers)
ENCODE_MAX_INPUTS = 32
#: K1's largest input count (the input words of a thread live in registers)
MATMUL_MAX_INPUTS = 32
#: the H100 SXM's SMs, the default of ``matmul_plan``
SMS = 132
#: dynamic shared memory a Hopper CTA may take (227 KB)
MAX_SMEM = 232_448
#: K1's geometries: slices per CTA, words per thread, threads per CTA (each
#: slice whole warps); a thread's J * V input words live in registers, at
#: most MAX_THREAD_WORDS
SLICES = (1, 2, 4)
WORDS = (4, 2, 1)
THREADS = (128, 64, 32)
MAX_THREAD_WORDS = 64
#: CTAs per SM a plan reaches where it can: with fewer, a launch leaves SMs
#: idle and has too few warps on each to hide its round trip
CTAS_PER_SM = 2
#: CTAs per SM from which 16-byte words pay (the large flushes, bound by
#: bytes); below it 8-byte words with more threads were faster on an H100
#: SXM (tools/kernel_rows.py --sweep, PERF.md §6)
WIDE_CTAS_PER_SM = 8


class MatmulPlan(NamedTuple):
    """CTA geometry of a K1 launch. ``grid`` is (CTAs per element, B); a
    CTA of ``threads`` threads covers ``threads // slices *
    words_per_thread`` neighbouring words of its element, each of its
    ``slices`` groups of threads over its own share of the i inputs, J =
    ceil(i / slices), at most ``jmax`` (the kernel's template bound). Its
    shared memory holds the masks as [8*o][slices][JP] words (JP: J
    rounded up to a power of two, at least 4), then, with more than one
    slice, the slices' partial rows [slices][o][threads // slices *
    words_per_thread]."""
    words_per_thread: int
    slices: int
    jmax: int
    threads: int
    grid: tuple[int, int]
    smem_bytes: int


def _check_matmul_shape(B: int, o: int, i: int, W: int) -> None:
    if not (0 < B <= 65535 and o > 0 and 0 < i <= MATMUL_MAX_INPUTS
            and W > 0):
        raise ValueError(f"K1 cannot take B={B} o={o} i={i} W={W}")


def _bound(n: int) -> int:
    """The kernel's template bound on a thread's inputs at or above n."""
    return next(b for b in (4, 8, 16, 32) if b >= n)


def make_plan(B: int, o: int, i: int, W: int, aligned: bool = True,
              slices: int = 1, words_per_thread: int = 1,
              threads: int = 128) -> MatmulPlan:
    """K1 at one geometry (``MatmulPlan``); ``aligned``: the words are
    16-byte aligned. Raises for a geometry the kernel cannot take."""
    _check_matmul_shape(B, o, i, W)
    s, v, t = slices, words_per_thread, threads
    j = -(-i // s)
    if s not in SLICES or v not in WORDS or t not in THREADS \
            or t // s < 32 or j * v > MAX_THREAD_WORDS \
            or (v > 1 and (not aligned or W % v)):
        raise ValueError(f"K1 has no geometry S={s} V={v} T={t} for i={i} "
                         f"W={W} aligned={aligned}")
    jp = max(4, 1 << (j - 1).bit_length())
    smem = 4 * o * (8 * s * jp + (t * v if s > 1 else 0))
    if smem > MAX_SMEM:
        raise ValueError(f"K1 at S={s} V={v} T={t}, o={o} i={i} takes "
                         f"{smem} bytes of shared memory")
    return MatmulPlan(v, s, _bound(j), t, (-(-W // (t // s * v)), B), smem)


def candidate_plans(B: int, o: int, i: int, W: int, aligned: bool = True
                    ) -> list[MatmulPlan]:
    """Every geometry the kernel takes at a shape."""
    plans = []
    for s in SLICES:
        for v in WORDS:
            for t in THREADS:
                try:
                    plans.append(make_plan(B, o, i, W, aligned, s, v, t))
                except ValueError:
                    pass
    return plans


def matmul_plan(B: int, o: int, i: int, W: int, aligned: bool = True,
                sms: int = SMS) -> MatmulPlan:
    """K1's geometry for B elements of masks [8, o, i] x words [i, W];
    ``aligned``: the words are 16-byte aligned. 16-byte words in
    128-thread CTAs when that runs ``WIDE_CTAS_PER_SM`` CTAs per SM; else,
    in this order, 8-byte words, then slices of one word, then one word a
    thread without slices (two slices first where no 8-byte words can be
    had: odd W, unaligned), each at the largest CTA that still runs
    ``CTAS_PER_SM`` CTAs per SM; the most CTAs when none does. Raises for
    shapes the kernel cannot take."""
    _check_matmul_shape(B, o, i, W)
    pairs = [(1, 2), (2, 1), (4, 1), (1, 1)]
    if not aligned or W % 2:
        pairs = [(1, 1), (2, 1), (4, 1)]
    order = [(1, 4, 128)] + [(s, v, t) for s, v in pairs for t in THREADS]
    best = None
    for s, v, t in order:
        try:
            plan = make_plan(B, o, i, W, aligned, s, v, t)
        except ValueError:
            continue
        ctas = plan.grid[0] * B
        if ctas >= (WIDE_CTAS_PER_SM if v == 4 else CTAS_PER_SM) * sms:
            return plan
        if v < 4 and (best is None or plan.grid[0] > best.grid[0]):
            best = plan
    if best is None:
        raise ValueError(f"K1's masks of o={o} i={i} exceed a CTA's shared "
                         "memory")
    return best


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for sizes in (launch_sizes, launch_rows):
        for name in sizes:
            sizes[name] = {}


def count_launch(counts: dict, sizes: dict, name: str, n: int) -> None:
    """One launch of ``name`` over ``n`` items (chunks, batch elements),
    counted in ``counts`` and in ``sizes`` under the least power of two at
    or above n."""
    bucket = 1 << (n - 1).bit_length()
    with COUNT_LOCK:
        counts[name] += 1
        sizes[name][bucket] = sizes[name].get(bucket, 0) + 1


def gf_matmul_batched_ref(masks: torch.Tensor, x: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version of K1 (and, with broadcast masks, of K2)."""
    return rs_torch.gf_matmul_packed(masks, x)


def _as_i32(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32/uint32 words, got {t.dtype}")
    return t


def _check_cuda(x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"tensors on {x.device} and {t.device}")
    for t in (x,) + others:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def gf_matmul_batched(masks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """masks int32 [B, 8, o, i] full-word masks, x int32 [B, i, W] ->
    int32 [B, o, W]."""
    masks = _as_i32(masks, "masks")
    x = _as_i32(x, "x")
    if masks.dim() != 4 or masks.shape[1] != 8 or x.dim() != 3 \
            or masks.shape[0] != x.shape[0] or masks.shape[3] != x.shape[1]:
        raise ValueError(f"shapes masks {tuple(masks.shape)} x "
                         f"{tuple(x.shape)} do not match [B,8,o,i] [B,i,W]")
    if x.device.type == "cpu":
        return gf_matmul_batched_ref(masks, x)
    _check_cuda(x, masks)
    bsz, _, o, i = masks.shape
    w = x.shape[-1]
    out = torch.empty((bsz, o, w), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    plan = matmul_plan(bsz, o, i, w, x.data_ptr() % 16 == 0,
                       _sms(x.device.index or 0))
    return launch_matmul(masks, x, out, plan)


def launch_matmul(masks: torch.Tensor, x: torch.Tensor, out: torch.Tensor,
                  plan: MatmulPlan) -> torch.Tensor:
    """K1 at ``plan`` on checked CUDA tensors (``gf_matmul_batched`` gives
    it ``matmul_plan``'s); counts the launch."""
    bsz, _, o, i = masks.shape
    lib = cuda_build.library("gf_matmul")
    with torch.cuda.device(x.device):
        err = lib.gfk_matmul_batched(
            masks.data_ptr(), x.data_ptr(), out.data_ptr(), bsz, o, i,
            x.shape[-1], plan.words_per_thread, plan.slices, plan.threads,
            plan.grid[0], plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "gf_matmul_batched")
    count_launch(launches, launch_sizes, "gf_matmul_batched", bsz)
    with COUNT_LOCK:
        rows = launch_rows["gf_matmul_batched"]
        rows[o] = rows.get(o, 0) + 1
    return out


def launch_empty(plan: MatmulPlan, device) -> None:
    """An empty kernel of K1's library at ``plan``'s grid, block and shared
    memory (a launch's floor at that geometry; not counted)."""
    lib = cuda_build.library("gf_matmul")
    with torch.cuda.device(device):
        err = lib.gfk_empty(plan.grid[0], plan.grid[1], plan.threads,
                            plan.smem_bytes,
                            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "gfk_empty")


def encode_defines(mat: np.ndarray) -> tuple[tuple[str, str], ...]:
    """The preprocessor values K2 is built with for the uint8 matrix
    ``mat`` [o, i]: GFK_O, GFK_I and GFK_MAT, the coefficients row-major as
    one run of hex digits after 0x."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    if mat.ndim != 2 or not mat.size:
        raise ValueError(f"an encode matrix is [o, i], got {mat.shape}")
    o, i = mat.shape
    return (("GFK_O", str(o)), ("GFK_I", str(i)),
            ("GFK_MAT", "0x" + mat.tobytes().hex()))


def prepare_encode(mat: np.ndarray) -> ctypes.CDLL:
    """K2's library for ``mat`` [o, i], built (nvcc, once per matrix and
    host) and loaded if it is not yet. Raises when the matrix has more
    inputs than the kernel takes or the build fails."""
    if np.shape(mat)[-1] > ENCODE_MAX_INPUTS:
        raise ValueError(f"K2 takes at most {ENCODE_MAX_INPUTS} inputs, "
                         f"got {np.shape(mat)[-1]}")
    return cuda_build.library("gf_encode", encode_defines(mat))


def gf_encode_batched(mat: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """x int32 [B, i, W] times the fixed uint8 matrix ``mat`` [o, i] ->
    int32 [B, o, W]."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    x = _as_i32(x, "x")
    if mat.ndim != 2 or x.dim() != 3 or mat.shape[1] != x.shape[1]:
        raise ValueError(f"shapes mat {mat.shape} x {tuple(x.shape)} do not "
                         "match [o,i] [B,i,W]")
    if x.device.type == "cpu":
        masks = torch.from_numpy(gf256.coeff_masks(mat).view(np.int32))
        return gf_matmul_batched_ref(masks, x)
    _check_cuda(x)
    o, i = mat.shape
    bsz, _, w = x.shape
    out = torch.empty((bsz, o, w), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    lib = prepare_encode(mat)
    with torch.cuda.device(x.device):
        err = lib.gfk_encode(x.data_ptr(), out.data_ptr(), bsz, o, i, w,
                             torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "gf_encode_batched")
    count_launch(launches, launch_sizes, "gf_encode_batched", bsz)
    return out
