"""The S3 Select device scan lane — the port of minio_tpu/s3select/device.py:
compile a WHERE clause into the integer predicate program that K6
(ops/scan_cuda.py) interprets, split the decoded object into newline-aligned
blocks, and stream per-row selection codes back so select.py materializes
ONLY matching rows; the classic row-by-row interpreter stays the semantic
authority for everything the lane does not cover.

Coverage contract (as in the JAX package): the compiled program handles
compare/AND/OR/NOT/BETWEEN/IN (and constant-folded IS NULL) over
integer-valued CSV columns against numeric literals. Everything else falls
back WITHOUT changing semantics:

- **query**: a predicate with LIKE/string ordering/arithmetic/aggregates, a
  non-CSV input, an uncompilable literal, or a quote, CR or NUL byte
  anywhere in the payload -> select.py runs the classic interpreter;
- **span**: a single line longer than a block -> every row of that span is
  handed to the interpreter;
- **row**: a referenced cell that is not a clean <= 9-digit integer
  (floats, strings, empties, missing fields) -> RESIDUAL code; the
  interpreter re-evaluates exactly that row.

``compile_where`` and its compiler are copies. ``DeviceScan`` runs the
blocks through the dispatch queue of its ``device`` (the CUDA card unless
the caller passes ``device="cpu"``, where the queue's flush takes the plain
version); there is no mode that turns the lane off when no card is found,
and no config knob. Blocks are 1 MiB, the JAX package's default
(``workloads scan_block_bytes``).
"""
from __future__ import annotations

import math

import numpy as np

from ..ops.scan_cuda import MAX_COLS, MAX_OPS
from ..ops.scan_torch import RESIDUAL
from ..runtime.dispatch import global_queue
from .sql import Between, Binary, Col, In, IsNull, Lit, Unary

#: int literals must stay strictly inside int32 (cells parse to <= 9
#: digits, so any in-range literal compares exactly)
_I32 = 1 << 31
#: bytes per scan block (newline-aligned; a block is padded with newlines to
#: a power of two of at least 4 KiB)
BLOCK_BYTES = 1 << 20


# --------------------------------------------------------------------------
# predicate compiler


def _lit_value(node):
    """Literal numeric value (int/float), folding unary minus and
    numeric-parseable strings (evaluate.py coerces them the same way);
    None when not usable."""
    if isinstance(node, Unary) and node.op == "-":
        v = _lit_value(node.operand)
        return None if v is None else -v
    if not isinstance(node, Lit):
        return None
    v = node.value
    if isinstance(v, bool) or v is None:
        return None
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        s = v.strip()
        try:
            return int(s)
        except ValueError:
            try:
                return float(s)
            except ValueError:
                return None
    return None


def _is_nonnum_string(node) -> bool:
    return isinstance(node, Lit) and isinstance(node.value, str) and \
        _lit_value(node) is None


def _col_index(node, alias: str, names: dict[str, int]) -> int | None:
    """CSV column index of a Col reference (positional _N or header
    name); None when unresolvable."""
    if not isinstance(node, Col):
        return None
    parts = list(node.path)
    if parts and parts[0].lower() in (alias.lower(), "s3object"):
        parts = parts[1:]
    if len(parts) != 1:
        return None
    name = parts[0]
    if len(name) > 1 and name[0] == "_" and name[1:].isdigit():
        idx = int(name[1:]) - 1
        return idx if idx >= 0 else None
    idx = names.get(name.lower())
    return idx


_SWAP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
         "eq": "eq", "ne": "ne"}
_OPS = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge", "=": "eq",
        "!=": "ne"}


class _Compiler:
    def __init__(self, alias: str, names: dict[str, int]):
        self.alias = alias
        self.names = names
        self.cols: dict[int, int] = {}
        self.prog: list[tuple] = []

    def _slot(self, ci: int) -> int | None:
        if ci not in self.cols:
            if len(self.cols) >= MAX_COLS:
                return None
            self.cols[ci] = len(self.cols)
        return self.cols[ci]

    def _emit_cmp(self, ci: int, op: str, k) -> bool:
        """Integer-domain canonicalization of ``col OP k`` for
        int-parsed cells (non-int rows are RESIDUAL and never reach the
        program)."""
        if isinstance(k, float) and k.is_integer():
            k = int(k)
        slot = self._slot(ci)
        if slot is None:
            return False
        if isinstance(k, int):
            if not (-_I32 < k < _I32):
                return False
            self.prog.append(("num", slot, op, k))
            return True
        f = math.floor(k)
        if not (-_I32 < f < _I32 - 1):
            return False
        if op in ("lt", "le"):       # a <  2.5  <=>  a <= 2 for int a
            self.prog.append(("num", slot, "le", f))
        elif op in ("gt", "ge"):     # a >= 2.5  <=>  a >= 3
            self.prog.append(("num", slot, "ge", f + 1))
        elif op == "eq":
            self.prog.append(("const", False))
        else:                        # ne: an int never equals 2.5
            self.prog.append(("const", True))
        return True

    def walk(self, node) -> bool:
        if len(self.prog) >= MAX_OPS:
            return False
        if isinstance(node, Binary):
            if node.op in ("and", "or"):
                if not (self.walk(node.left) and self.walk(node.right)):
                    return False
                self.prog.append((node.op,))
                return True
            op = _OPS.get(node.op)
            if op is None:
                return False
            ci = _col_index(node.left, self.alias, self.names)
            lit, other = node.right, node.left
            if ci is None:
                ci = _col_index(node.right, self.alias, self.names)
                op = _SWAP[op]
                lit, other = node.left, node.right
            if ci is None:
                return False
            v = _lit_value(lit)
            if v is None:
                # a non-numeric string literal can never equal (and
                # always differs from) the canonical str() of an
                # int-parsed cell — evaluate.py compares str(int) there
                if op == "eq" and _is_nonnum_string(lit):
                    self.prog.append(("const", False))
                    return self._slot(ci) is not None
                if op == "ne" and _is_nonnum_string(lit):
                    self.prog.append(("const", True))
                    return self._slot(ci) is not None
                return False
            return self._emit_cmp(ci, op, v)
        if isinstance(node, Unary) and node.op == "not":
            if not self.walk(node.operand):
                return False
            self.prog.append(("not",))
            return True
        if isinstance(node, IsNull):
            # an int-parsed cell is never NULL/'' — constant under the
            # residual contract (empty/missing cells fail the parse)
            ci = _col_index(node.operand, self.alias, self.names)
            if ci is None or self._slot(ci) is None:
                return False
            self.prog.append(("const", bool(node.negate)))
            return True
        if isinstance(node, Between):
            ci = _col_index(node.operand, self.alias, self.names)
            if ci is None:
                return False
            lo, hi = _lit_value(node.lo), _lit_value(node.hi)
            if lo is None or hi is None:
                return False
            lo = int(math.ceil(lo))     # a >= 2.5 <=> a >= 3
            hi = int(math.floor(hi))    # a <= 7.5 <=> a <= 7
            slot = self._slot(ci)
            if slot is None or not (-_I32 < lo < _I32 and
                                    -_I32 < hi < _I32):
                return False
            self.prog.append(("between", slot, lo, hi))
            if node.negate:
                self.prog.append(("not",))
            return True
        if isinstance(node, In):
            ci = _col_index(node.operand, self.alias, self.names)
            if ci is None:
                return False
            slot = self._slot(ci)
            if slot is None:
                return False
            opts = []
            for o in node.options:
                v = _lit_value(o)
                if v is None:
                    if _is_nonnum_string(o):
                        continue    # unmatchable by an int-parsed cell
                    return False
                if isinstance(v, float):
                    if not v.is_integer():
                        continue    # an int never equals 2.5
                    v = int(v)
                if not (-_I32 < v < _I32):
                    return False
                opts.append(v)
            self.prog.append(("in", slot, tuple(opts)))
            if node.negate:
                self.prog.append(("not",))
            return True
        return False


def compile_where(where, alias: str, names: dict[str, int]
                  ) -> tuple[tuple, tuple] | None:
    """WHERE AST -> (program, csv column indices) or None when any part
    is outside the device lane's coverage (the whole query then runs on
    the classic interpreter — query-level fallback)."""
    if where is None:
        return None
    c = _Compiler(alias, names)
    if not c.walk(where) or not c.cols or len(c.prog) > MAX_OPS:
        return None
    cols = tuple(ci for ci, _ in sorted(c.cols.items(),
                                        key=lambda kv: kv[1]))
    return tuple(c.prog), cols


# --------------------------------------------------------------------------
# block split + scan execution


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class DeviceScan:
    """Iterates (row_start, row_end, residual) for CANDIDATE rows of the
    decoded payload, in order — matched rows (residual=False) need no
    WHERE re-evaluation; residual rows must go through the interpreter.
    Non-candidate rows never surface. Blocks are scanned through the
    dispatch queue of ``device``, a few blocks ahead of consumption."""

    WAVE = 8

    def __init__(self, data: np.ndarray, program: tuple, cols: tuple,
                 delim: int, device=None):
        self.queue = global_queue(device)
        self.data = data
        self.program = program
        self.cols = cols
        self.delim = delim
        self.spans: list[tuple[int, int, bool]] = []  # (off, end, residual)
        self._split()

    def _split(self):
        """Newline-aligned block spans. Quote/CR/NUL bytes anywhere in the
        payload already sent the whole query to the classic path (select.py
        _device_rows): only an over-long single line still goes residual as
        a span (it IS exactly one row, so the byte-level split stays
        faithful)."""
        data, L = self.data, BLOCK_BYTES
        pos, n = 0, len(data)
        while pos < n:
            end = min(pos + L, n)
            if end < n:
                # cut at the last newline inside the window
                nls = np.flatnonzero(data[pos:end] == 10)
                if nls.size == 0:
                    # a single line longer than the block: residual span
                    # to its end (or EOF)
                    nl = np.flatnonzero(data[end:] == 10)
                    stop = n if nl.size == 0 else end + int(nl[0]) + 1
                    self.spans.append((pos, stop, True))
                    pos = stop
                    continue
                end = pos + int(nls[-1]) + 1
            self.spans.append((pos, end, False))
            pos = end

    def _codes_for(self, off: int, end: int, max_rows: int):
        """Future of the row codes of one block span."""
        blk = self.data[off:end]
        # +1 guarantees at least one '\n' pad byte even at an exact
        # power-of-two length: a final unterminated row must be
        # newline-closed or the scan would miss it (codes and _row_spans
        # must agree row for row)
        L = _next_pow2(max(len(blk) + 1, 4096))
        padded = np.full(L, 10, np.uint8)  # '\n' pad: fake rows land
        padded[:len(blk)] = blk            # beyond the real row count
        return self.queue.select_scan(
            padded.view("<u4").reshape(1, -1), self.program, self.cols,
            self.delim, max_rows)

    def rows(self):
        data = self.data
        # one bucketed max_rows for the whole request so every block
        # shares a dispatch bucket. Count rows the way _row_spans does: a
        # trailing line WITHOUT a newline is still a row
        max_nl = 1
        for off, end, residual in self.spans:
            if not residual:
                n = int(np.count_nonzero(data[off:end] == 10))
                if end > off and data[end - 1] != 10:
                    n += 1
                max_nl = max(max_nl, n)
        max_rows = _next_pow2(max_nl)
        pending: list[tuple[int, int, object]] = []
        spans = list(self.spans)
        i = 0
        while i < len(spans) or pending:
            while i < len(spans) and len(pending) < self.WAVE:
                off, end, residual = spans[i]
                i += 1
                pending.append((off, end, None if residual else
                                self._codes_for(off, end, max_rows)))
            off, end, codes = pending.pop(0)
            starts, stops = _row_spans(data, off, end)
            if codes is None:
                # whole-span fallback: every row is residual
                for a, b in zip(starts.tolist(), stops.tolist()):
                    yield a, b, True
                continue
            codes = codes.result()[:len(starts)]
            # only candidate rows surface: the others cost no Python
            for r in np.flatnonzero(codes).tolist():
                yield int(starts[r]), int(stops[r]), \
                    bool(codes[r] == RESIDUAL)


def _row_spans(data: np.ndarray, off: int, end: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """(starts, stops) byte offsets of the rows in data[off:end], newline
    exclusive; a trailing line without a newline is still a row (the scan
    pads blocks with '\\n', csv.reader yields it too)."""
    nls = np.flatnonzero(data[off:end] == 10) + off
    starts = np.concatenate(([off], nls + 1))
    stops = np.concatenate((nls, [end]))
    if starts[-1] >= end:       # the span ends with its last newline
        starts, stops = starts[:-1], stops[:-1]
    return starts, stops
