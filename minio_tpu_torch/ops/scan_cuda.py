"""Wrapper for the S3 Select scan kernel of csrc/scan.cu — the port of
ops/scan_pallas.py.

``scan_codes`` (K6) gives the row codes (0 / MATCH / RESIDUAL) of a batch
of newline-terminated CSV blocks under one compiled WHERE program; it
replaces scan_pallas._make_scan_kernel / scan_fn_for.run. Given CPU tensors
it returns the plain version, ``scan_torch.scan_blocks``; given CUDA tensors
it launches the kernel on the current stream (its newline index, then the
scan: one launch of K6 in ``launches``), or raises.

The kernel interprets the program as an op table (``encode_program``),
built once per program on the host: one build of the kernel serves every
WHERE clause.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import cuda_build
from .scan_torch import as_bytes, check_args, scan_blocks

__all__ = ["scan_codes", "encode_program", "launches", "reset_launches",
           "MAX_COLS", "MAX_OPS"]

#: the kernel's limits, the compiler's guardrails (s3select/device.py)
MAX_COLS = 8
MAX_OPS = 64

#: kernel launches (plain-version calls are not counted)
launches = {"scan_codes": 0}

_CMP = ("lt", "le", "gt", "ge", "eq", "ne")
_BETWEEN, _IN, _AND, _OR, _NOT, _CONST = range(6, 12)
_I32 = 1 << 31


def reset_launches() -> None:
    launches["scan_codes"] = 0


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
               delim: int, max_rows: int) -> torch.Tensor:
    """Row codes of newline-terminated CSV blocks (uint8 [B, L] or 32-bit
    words [B, L//4]) under ``program`` over the CSV columns ``cols`` ->
    int32 [B, max_rows]."""
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
    nl = torch.empty_like(out)          # the kernel's newline index
    host_cols = np.asarray(cols, dtype=np.int32)
    lib = cuda_build.library("scan")
    with torch.cuda.device(x.device):
        err = lib.scan_codes(
            x.data_ptr(), nl.data_ptr(), table.data_ptr(), table.shape[0],
            opts.data_ptr(), host_cols.ctypes.data, len(cols), delim, nb, L,
            max_rows, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "scan_codes")
    launches["scan_codes"] += 1
    return out
