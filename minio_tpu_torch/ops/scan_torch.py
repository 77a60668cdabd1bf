"""Plain PyTorch version of the S3 Select CSV predicate scan — the port of
the device function of ops/scan_pallas.py (``scan_fn_for.run``: the
structural index ``_cells_one_block``, the parse automaton ``_parse_col``
and the predicate stack machine ``_eval_program``).

Per row of a newline-terminated CSV block it gives 0 (no match), ``MATCH``
(every referenced cell parsed as a clean integer of at most 9 digits and the
program holds) or ``RESIDUAL`` (some referenced cell did not parse: the
caller re-evaluates that row with the s3select interpreter). Rows past the
block's newline count read ``RESIDUAL``, as the Pallas path gives them (its
pure-Python twin ``scan_block_reference`` leaves them at 0; no caller reads
them).

This is the yardstick of the Hopper kernel K6 (ops/scan_cuda.py): the CPU
tests run it, the CPU dispatch queue's ``select_scan`` flush runs it, and on
the card only ``chip_smoke.py`` calls it, to check K6. Every tensor stays
batched over blocks [B, ...] (no vmap); indices stay int32 where they fit.
"""
from __future__ import annotations

import torch

#: fixed parse-slot width: a referenced cell wider than this cannot be a
#: 9-digit integer and is poisoned so that it fails the parse
CELL_W = 16
MATCH = 1
RESIDUAL = 2
#: the byte a cell's NUL bytes and over-wide cells are poisoned with
POISON = 88

#: bytes Python's str.strip() removes that can appear inside a CSV cell
SPACES = (32, 9, 13, 11, 12)

T_TRAIL, T_DIG, T_SIGNED, T_LEAD, T_FAIL = range(5)

CMP = {"lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
       "eq": torch.eq, "ne": torch.ne}


def as_bytes(blocks: torch.Tensor) -> torch.Tensor:
    """Blocks as uint8 [B, L]: int32/uint32 words [B, L//4] are viewed as
    their little-endian bytes, uint8 blocks pass through."""
    if blocks.dtype == torch.uint32:
        blocks = blocks.view(torch.int32)
    if blocks.dtype == torch.int32:
        blocks = blocks.contiguous().view(torch.uint8)
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise TypeError(f"blocks must be uint8 [B, L] or 32-bit words "
                        f"[B, L//4], got {blocks.dtype} "
                        f"{tuple(blocks.shape)}")
    return blocks


def check_args(cols: tuple, delim: int, max_rows: int) -> None:
    if not cols or min(cols) < 0:
        raise ValueError(f"cols {cols!r} must be non-empty and >= 0")
    if not 0 <= delim <= 255 or delim == 10:
        raise ValueError(f"delimiter {delim} must be a byte other than "
                         "the newline")
    if max_rows <= 0:
        raise ValueError("max_rows must be positive")


def _scatter(n: int, fill: int, idx: torch.Tensor, src: torch.Tensor
             ) -> torch.Tensor:
    """[B, n] filled with ``fill``, ``src`` written at ``idx``. The JAX
    index drops a write by aiming it out of range (mode="drop"); torch's
    scatter raises there, so a dropped write goes to an extra trash slot
    ``n`` that is sliced off."""
    out = torch.full((idx.shape[0], n + 1), fill, dtype=torch.int32,
                     device=idx.device)
    return out.scatter_(1, idx.long(), src)[:, :n]


def cells(blocks: torch.Tensor, cols: tuple, delim: int, max_rows: int
          ) -> torch.Tensor:
    """The referenced cells of every row: blocks -> int32 [B, max_rows, C,
    CELL_W] left-aligned cell bytes (0-padded; a missing cell is all pad, an
    over-wide one all POISON, a NUL byte POISON) — _cells_one_block batched
    over B."""
    check_args(cols, delim, max_rows)
    x = as_bytes(blocks).to(torch.int32)
    nb, L = x.shape
    dev = x.device
    F = max(cols) + 2          # fields tracked per row
    is_nl = x == 10
    is_d = x == delim
    sep = is_nl | is_d
    nl32 = is_nl.to(torch.int32)
    sep32 = sep.to(torch.int32)
    n_cum = torch.cumsum(nl32, 1, dtype=torch.int32)
    row = n_cum - nl32         # 0-based row of each byte
    s_cum = torch.cumsum(sep32, 1, dtype=torch.int32)
    # separators strictly before each row's first byte, from the newline
    # that ends the previous row
    trash = max_rows + 2
    base = _scatter(max_rows + 2, 0,
                    torch.where(is_nl & (row + 1 <= max_rows + 1), row + 1,
                                trash), s_cum)
    field = (s_cum - sep32) - torch.gather(
        base, 1, torch.clamp(row, max=max_rows + 1).long())
    pos = torch.arange(L, dtype=torch.int32, device=dev).expand(nb, L)
    ok_row = row < max_rows
    nf = max_rows * F
    # cell (r, f) ends at its separator and starts after the previous one
    end = _scatter(nf, -1, torch.where(sep & ok_row & (field < F),
                                       row * F + field, nf), pos)
    start = torch.full((nb, nf + 1), L, dtype=torch.int32, device=dev)
    start[:, 0] = 0
    start.scatter_(1, torch.where(is_d & ok_row & (field + 1 < F),
                                  row * F + field + 1, nf).long(), pos + 1)
    start.scatter_(1, torch.where(is_nl & (row + 1 < max_rows),
                                  (row + 1) * F, nf).long(), pos + 1)
    start = start[:, :nf].reshape(nb, max_rows, F)
    end = end.reshape(nb, max_rows, F)
    cidx = torch.tensor(cols, dtype=torch.long, device=dev)
    st = start[:, :, cidx]                   # [B, max_rows, C]
    ln = end[:, :, cidx] - st
    off = torch.arange(CELL_W, dtype=torch.int32, device=dev)
    idx = torch.clamp(st[..., None] + off, 0, L - 1)
    raw = torch.gather(x, 1, idx.reshape(nb, -1).long()).reshape(idx.shape)
    raw = torch.where(raw == 0, POISON, raw)
    b = torch.where(off < ln[..., None], raw, 0)
    return torch.where((ln > CELL_W)[..., None], POISON, b)


def parse_col(cell: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Right-to-left integer-parse automaton over the CELL_W bytes of each
    cell (int32 [..., CELL_W]) -> (value int32, fail bool), as Python's
    int(cell.strip()) for at most 9 digits. The value is accumulated in
    int64, so a 10th digit cannot overflow (such a cell fails anyway)."""
    shape = cell.shape[:-1]
    dev = cell.device
    val = torch.zeros(shape, dtype=torch.int64, device=dev)
    pw = torch.ones(shape, dtype=torch.int64, device=dev)
    ndig = torch.zeros(shape, dtype=torch.int32, device=dev)
    neg = torch.zeros(shape, dtype=torch.bool, device=dev)
    phase = torch.full(shape, T_TRAIL, dtype=torch.int32, device=dev)
    for j in reversed(range(cell.shape[-1])):
        b = cell[..., j]
        is_pad = b == 0
        is_sp = torch.zeros(shape, dtype=torch.bool, device=dev)
        for s in SPACES:
            is_sp |= b == s
        is_dig = (b >= 48) & (b <= 57)
        is_sign = (b == 45) | (b == 43)
        in_trail = phase == T_TRAIL
        in_dig = phase == T_DIG
        dig_step = is_dig & (in_trail | in_dig)
        val += torch.where(dig_step, (b - 48).to(torch.int64) * pw, 0)
        pw = torch.where(dig_step, pw * 10, pw)
        ndig += dig_step.to(torch.int32)
        neg |= in_dig & (b == 45)
        lead_ok = ((phase == T_SIGNED) | (phase == T_LEAD)) & is_sp
        phase = torch.where(
            in_trail,
            torch.where(is_pad | is_sp, T_TRAIL,
                        torch.where(is_dig, T_DIG, T_FAIL)),
            torch.where(
                in_dig,
                torch.where(is_dig, T_DIG,
                            torch.where(is_sign, T_SIGNED,
                                        torch.where(is_sp, T_LEAD, T_FAIL))),
                torch.where(lead_ok, T_LEAD, T_FAIL))).to(torch.int32)
    ok = ((phase == T_DIG) | (phase == T_SIGNED) | (phase == T_LEAD)) \
        & (ndig >= 1) & (ndig <= 9)
    val = torch.where(neg, -val, val).to(torch.int32)
    return val, ~ok


def eval_program(program: tuple, vals: list, shape, device) -> torch.Tensor:
    """The compiled predicate as a stack machine over int32 column values
    -> bool [shape]."""
    stack = []
    for op in program:
        kind = op[0]
        if kind == "num":
            _, slot, o, k = op
            stack.append(CMP[o](vals[slot], k))
        elif kind == "between":
            _, slot, lo, hi = op
            stack.append((vals[slot] >= lo) & (vals[slot] <= hi))
        elif kind == "in":
            _, slot, opts = op
            hit = torch.zeros(shape, dtype=torch.bool, device=device)
            for k in opts:
                hit |= vals[slot] == k
            stack.append(hit)
        elif kind == "and":
            b, a = stack.pop(), stack.pop()
            stack.append(a & b)
        elif kind == "or":
            b, a = stack.pop(), stack.pop()
            stack.append(a | b)
        elif kind == "not":
            stack.append(~stack.pop())
        elif kind == "const":
            stack.append(torch.full(shape, bool(op[1]), dtype=torch.bool,
                                    device=device))
        else:
            raise ValueError(f"unknown scan op {kind}")
    if len(stack) != 1:
        raise ValueError("unbalanced scan program")
    return stack[0]


def scan_blocks(blocks: torch.Tensor, program: tuple, cols: tuple,
                delim: int, max_rows: int) -> torch.Tensor:
    """Row codes of newline-terminated CSV blocks (uint8 [B, L] or 32-bit
    words [B, L//4]) -> int32 [B, max_rows]. ``max_rows`` must cover the
    newline count of every block the caller reads codes of."""
    c = cells(blocks, cols, delim, max_rows)   # [B, max_rows, C, CELL_W]
    vals, fail = [], None
    for i in range(len(cols)):
        v, f = parse_col(c[:, :, i])
        vals.append(v)
        fail = f if fail is None else fail | f
    match = eval_program(program, vals, fail.shape, fail.device)
    return torch.where(fail, RESIDUAL,
                       torch.where(match, MATCH, 0)).to(torch.int32)
