"""Wrapper for the S3 Select scan kernel of csrc/scan.cu — the port of
ops/scan_pallas.py.

``scan_codes`` (K6) gives the row codes (0 / MATCH / RESIDUAL) of a batch
of newline-terminated CSV blocks under one compiled WHERE program; it
replaces scan_pallas._make_scan_kernel / scan_fn_for.run. Given CPU tensors
it returns the plain version, ``scan_torch.scan_blocks``; given CUDA tensors
it launches the kernel on the current stream, or raises. ``launches``
counts its launches, ``launch_sizes`` the same launches by batch size B.

The kernel reads each block once, in tiles (``tile_plan``): a CTA per tile,
taken in ticket order, parses the rows that end in its tile and finds
their ranks by a look-back over the tiles before it in the block (status
words: the launch's only scratch besides the codes). It interprets the
program as an op table (``encode_program``), built once per program on the
host: one build of the kernel serves every WHERE clause.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_build
from .rs_cuda import COUNT_LOCK
from .scan_torch import as_bytes, check_args, scan_blocks

__all__ = ["scan_codes", "encode_program", "launches", "launch_sizes",
           "reset_launches", "tile_plan", "TilePlan", "MAX_COLS", "MAX_OPS"]

#: the kernel's limits, the compiler's guardrails (s3select/device.py)
MAX_COLS = 8
MAX_OPS = 64

#: the tile plan: tile bytes (a 1 MiB block is 86 tiles), the halo read
#: before each tile (rows that start in it are parsed from shared memory),
#: the limits csrc/scan.cu takes (whole 32-byte bitmap words), and the
#: threads of a CTA
TILE = 12288
HALO = 512
MAX_TILE = 16384
MAX_HALO = 4096
THREADS = 128

#: kernel launches (plain-version calls are not counted)
launches = {"scan_codes": 0}
#: the same launches by batch size B
launch_sizes: dict[str, dict[int, int]] = {"scan_codes": {}}

_CMP = ("lt", "le", "gt", "ge", "eq", "ne")
_BETWEEN, _IN, _AND, _OR, _NOT, _CONST = range(6, 12)
_I32 = 1 << 31


def reset_launches() -> None:
    launches["scan_codes"] = 0
    launch_sizes["scan_codes"] = {}


class TilePlan(NamedTuple):
    """K6's launch over B blocks of L bytes: each block cut into ``tiles``
    tiles of ``tile`` bytes (the last one short), each CTA copying its tile
    and the ``halo`` bytes before it (0 for a one-tile block) into
    ``smem_bytes`` of dynamic shared memory; ``grid`` = B * tiles CTAs of
    ``threads``."""
    tile: int
    halo: int
    tiles: int
    grid: int
    smem_bytes: int
    threads: int


def tile_plan(L: int, B: int, tile: int | None = None,
              halo: int | None = None) -> TilePlan:
    """The plan for B blocks of L bytes: tiles of ``tile`` bytes (default
    TILE, or the block rounded up to 32 bytes when it is shorter) and a halo
    of ``halo`` (default HALO), both multiples of 32 within the kernel's
    limits."""
    if L <= 0 or B <= 0:
        raise ValueError(f"no blocks to plan: L={L}, B={B}")
    t = min(TILE, -(-L // 32) * 32) if tile is None else tile
    if t % 32 or not 32 <= t <= MAX_TILE:
        raise ValueError(f"tile {t} is not a multiple of 32 in "
                         f"[32, {MAX_TILE}]")
    tiles = -(-L // t)
    h = (HALO if halo is None else halo) if tiles > 1 else 0
    if h % 32 or not 0 <= h <= MAX_HALO:
        raise ValueError(f"halo {h} is not a multiple of 32 in "
                         f"[0, {MAX_HALO}]")
    grid = B * tiles
    if grid >= 2**31:
        raise ValueError(f"{grid} tiles are too many for one launch")
    # the window, its newline bitmap and the slack a row's 36-byte read near
    # the window's end may touch (csrc/scan.cu smem_bytes)
    smem = t + h + 4 * ((t + h) // 32) + 64
    return TilePlan(t, h, tiles, grid, smem, THREADS)


def _i32(v) -> int:
    v = int(v)
    if not -_I32 <= v < _I32:
        raise ValueError(f"program literal {v} is outside int32")
    return v


@functools.lru_cache(maxsize=256)
def encode_program(program: tuple, n_cols: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """A compiled WHERE program -> (op table int32 [n_ops, 4] of (opcode,
    slot, k or lo or IN count, hi or IN offset), IN options int32 [>= 1]).
    Raises on an op the kernel does not know, a slot past ``n_cols``, more
    than MAX_OPS ops, or a stack that does not end with one value."""
    if not 0 < len(program) <= MAX_OPS:
        raise ValueError(f"a scan program has 1..{MAX_OPS} ops")
    rows, opts, depth = [], [], 0
    for op in program:
        kind = op[0]
        if kind in ("num", "between", "in") and not 0 <= op[1] < n_cols:
            raise ValueError(f"slot {op[1]} of {op!r} is not below {n_cols}")
        if kind == "num":
            rows.append((_CMP.index(op[2]), op[1], _i32(op[3]), 0))
        elif kind == "between":
            rows.append((_BETWEEN, op[1], _i32(op[2]), _i32(op[3])))
        elif kind == "in":
            rows.append((_IN, op[1], len(op[2]), len(opts)))
            opts.extend(_i32(k) for k in op[2])
        elif kind in ("and", "or"):
            depth -= 2
            rows.append((_AND if kind == "and" else _OR, 0, 0, 0))
        elif kind == "not":
            depth -= 1
            rows.append((_NOT, 0, 0, 0))
        elif kind == "const":
            rows.append((_CONST, 0, int(bool(op[1])), 0))
        else:
            raise ValueError(f"unknown scan op {kind}")
        if depth < 0:
            raise ValueError("scan program pops an empty stack")
        depth += 1
    if depth != 1:
        raise ValueError("unbalanced scan program")
    table = np.asarray(rows, dtype=np.int32).reshape(-1, 4)
    return table, np.asarray(opts or [0], dtype=np.int32)


@functools.lru_cache(maxsize=256)
def _program_on(program: tuple, n_cols: int, device: torch.device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The op table and IN options of a program, on ``device``."""
    table, opts = encode_program(program, n_cols)
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(opts).to(device))


def scan_codes(blocks: torch.Tensor, program: tuple, cols: tuple,
               delim: int, max_rows: int, *, tile: int | None = None,
               halo: int | None = None) -> torch.Tensor:
    """Row codes of newline-terminated CSV blocks (uint8 [B, L] or 32-bit
    words [B, L//4]) under ``program`` over the CSV columns ``cols`` ->
    int32 [B, max_rows]. ``tile`` and ``halo`` override the kernel's tile
    plan (``tile_plan``); the plain version has none."""
    check_args(cols, delim, max_rows)
    if len(cols) > MAX_COLS:
        raise ValueError(f"at most {MAX_COLS} columns, got {len(cols)}")
    x = as_bytes(blocks)
    if x.device.type == "cpu":
        return scan_blocks(x, program, cols, delim, max_rows)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    table, opts = _program_on(program, len(cols), x.device)
    nb, L = x.shape
    out = torch.empty((nb, max_rows), dtype=torch.int32, device=x.device)
    if nb == 0 or L == 0:
        return out
    plan = tile_plan(L, nb, tile, halo)
    # the tiles' status words, then the ticket, zeroed on this stream
    status = torch.zeros(plan.grid + 1, dtype=torch.int32, device=x.device)
    host_cols = np.asarray(cols, dtype=np.int32)
    lib = cuda_build.library("scan")
    with torch.cuda.device(x.device):
        err = lib.scan_codes(
            x.data_ptr(), status.data_ptr(), table.data_ptr(),
            table.shape[0], opts.data_ptr(), opts.numel(),
            host_cols.ctypes.data,
            len(cols), delim, nb, L, max_rows, plan.tile, plan.halo,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "scan_codes")
    with COUNT_LOCK:
        launches["scan_codes"] += 1
        sizes = launch_sizes["scan_codes"]
        sizes[nb] = sizes.get(nb, 0) + 1
    return out
