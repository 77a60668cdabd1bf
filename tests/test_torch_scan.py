"""The port's S3 Select scan (minio_tpu_torch.ops.scan_torch, the plain
version of K6, and the op table K6 interprets) held to the JAX package's
ops/scan_pallas.py on numpy-made blocks: the structural index against
``_cells_one_block``, the row codes against ``scan_fn_for`` in interpret
mode (whole arrays, rows past the newline count included) and against the
pure-Python ``scan_blocks_reference`` over the real rows. Every comparison
is exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import scan_pallas as sp
from minio_tpu_torch.ops import scan_cuda, scan_torch

COMMA, PIPE = 44, 124

# the edge-case rows of tests/test_scan_pallas.py::test_parse_edge_cases
EDGE_ROWS = [
    b"a,34,x\n", b"b, 41 ,x\n", b"c,-7,x\n", b"d,+19,x\n", b"e,2.5,x\n",
    b"f,,x\n", b"g,12_000,x\n", b"h,1234567890,x\n", b"i,007,x\n",
    b"j,999999999,x\n", b"k\n", b"l,1 2,x\n", b"m,                9,x\n",
    b"\n", b"n,5-3,x\n", b"o,0,x\n", b"p,-0,x\n", b"q,123\x00,x\n",
    b"r,\x0045,x\n",
]
EDGE_WANT = [1, 1, 0, 1, 2, 2, 2, 2, 1, 1, 2, 2, 2, 2, 2, 1, 1, 2, 2]


def block_of(rows: list[bytes], L: int) -> np.ndarray:
    txt = b"".join(rows)
    assert len(txt) <= L
    return np.frombuffer(txt + b"\n" * (L - len(txt)), np.uint8)


def port_codes(blocks: np.ndarray, program, cols, delim, max_rows):
    return scan_torch.scan_blocks(torch.from_numpy(blocks.copy()), program,
                                  cols, delim, max_rows).numpy()


def random_block(rng, L: int, delim: int) -> np.ndarray:
    """Digits, signs, spaces, dots, NULs, separators and newlines: every
    structural corner of a block (long rows, missing fields, no final
    newline)."""
    alphabet = np.frombuffer(b"0123456789 -+.x\x00" + bytes([delim]) * 4
                             + b"\n" * 3, np.uint8)
    return rng.choice(alphabet, L).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def jax_cells(cols, delim, max_rows):
    return jax.jit(functools.partial(sp._cells_one_block, cols=cols,
                                     delim=delim, max_rows=max_rows))


@pytest.mark.parametrize("delim", [COMMA, PIPE])
@pytest.mark.parametrize("cols", [(1,), (0, 2), (7, 3, 0, 15, 1, 2, 9, 4)])
def test_cells_match_jax(delim, cols):
    rng = np.random.default_rng(delim * 100 + len(cols))
    blocks = np.stack([random_block(rng, 256, delim) for _ in range(3)])
    want = np.stack([np.asarray(jax_cells(cols, delim, 32)(
        jnp.asarray(b.astype(np.int32)))) for b in blocks])
    got = scan_torch.cells(torch.from_numpy(blocks), cols, delim, 32)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_codes_match_jax_edge_rows():
    program = (("num", 0, "ge", 0),)
    block = block_of(EDGE_ROWS, 512)[None]
    fn = sp.scan_fn_for(program, (1,), COMMA, 512, 32, interpret=True)
    want = np.asarray(fn(block.view("<u4")))
    got = port_codes(block, program, (1,), COMMA, 32)
    assert np.array_equal(got, want)
    assert got[0, :len(EDGE_ROWS)].tolist() == EDGE_WANT


def test_codes_match_jax_past_the_newline_count():
    """max_rows above the block's newline count: the rows past it read
    RESIDUAL in the Pallas path (and in the port), where
    scan_block_reference leaves 0 (a finding about the reference; no
    caller reads those rows)."""
    rows = [b"%d|%d|x\n" % (i, 7 * i - 20) for i in range(40)]
    txt = sum(map(len, rows))
    block = block_of(rows, txt + 12 + (-(txt + 12)) % 4)[None]
    n = int((block == 10).sum())
    assert 52 <= n < 128
    program = (("num", 0, "lt", 100), ("num", 1, "ge", 0), ("and",))
    fn = sp.scan_fn_for(program, (1, 0), PIPE, block.shape[1], 128,
                        interpret=True)
    want = np.asarray(fn(block.view("<u4")))
    got = port_codes(block, program, (1, 0), PIPE, 128)
    assert np.array_equal(got, want)
    assert (got[0, n:] == scan_torch.RESIDUAL).all()
    ref = sp.scan_blocks_reference(block, program, (1, 0), PIPE, 128)
    assert np.array_equal(got[0, :n], ref[0, :n])
    assert (ref[0, n:] == 0).all()


# the programs of tests/test_scan_pallas.py::test_program_ops_pinned, plus
# an IN with no options and a nested NOT
PROGRAMS = [
    ((("num", 0, "gt", 10), ("num", 0, "lt", 40), ("and",)), (1,)),
    ((("between", 0, -5, 25),), (0,)),
    ((("in", 0, (7, 19, 34)),), (1,)),
    ((("num", 0, "eq", 0), ("const", True), ("or",), ("not",)), (2,)),
    ((("num", 0, "ne", 3), ("num", 1, "ge", 1), ("or",)), (0, 2)),
    ((("in", 0, ()), ("not",), ("num", 1, "le", 5), ("and",)), (1, 0)),
    ((("num", 0, "lt", 0), ("not",), ("not",), ("not",)), (2,)),
]


@pytest.mark.parametrize("program,cols", PROGRAMS)
def test_codes_match_reference(program, cols):
    rng = np.random.default_rng(len(program) * 7 + cols[0])
    blocks, nrows = [], []
    for _ in range(3):
        n = int(rng.integers(1, 40))
        rows = [b"%d,%d,%d\n" % tuple(rng.integers(-50, 50, 3))
                for _ in range(n)]
        rows[n // 2] = b"x,y,z\n"        # a residual row in the middle
        blocks.append(block_of(rows, 1024))
        nrows.append(n)
    blocks = np.stack(blocks)
    got = port_codes(blocks, program, cols, COMMA, 64)
    ref = sp.scan_blocks_reference(blocks, program, cols, COMMA, 64)
    for i, n in enumerate(nrows):
        assert np.array_equal(got[i, :n], ref[i, :n]), (program, i)


def test_dropped_writes_take_the_trash_slot():
    """A row with more fields than the F = max(cols) + 2 tracked, and a
    block with more rows than max_rows: the JAX index drops those writes
    out of range; the port routes them to a trash slot. Rows past max_rows
    are cut, not wrapped."""
    rows = [b"1,2,3,4,5,6,7,8,9\n", b"4,5\n"] + \
        [b"%d,9\n" % i for i in range(30)]
    block = block_of(rows, 512)[None]
    cols = (0, 1)
    want = np.asarray(jax_cells(cols, COMMA, 8)(
        jnp.asarray(block[0].astype(np.int32))))
    got = scan_torch.cells(torch.from_numpy(block.copy()), cols, COMMA, 8)
    assert np.array_equal(got[0].numpy(), want)
    program = (("num", 0, "lt", 5), ("num", 1, "ge", 2), ("and",))
    codes = port_codes(block, program, cols, COMMA, 8)
    ref = sp.scan_blocks_reference(block, program, cols, COMMA, 8)
    assert np.array_equal(codes, ref)
    assert codes[0, :4].tolist() == [1, 1, 1, 1]


#: K6's opcodes (the enum of csrc/scan.cu)
CMP_OPS = ("lt", "le", "gt", "ge", "eq", "ne")
BETWEEN, IN, AND, OR, NOT, CONST = range(6, 12)


def decode_program(table: np.ndarray, opts: np.ndarray) -> tuple:
    """The program an op table encodes, read as K6 reads it."""
    out = []
    for code, slot, a, b in np.asarray(table).tolist():
        if code < len(CMP_OPS):
            out.append(("num", slot, CMP_OPS[code], a))
        elif code == BETWEEN:
            out.append(("between", slot, a, b))
        elif code == IN:
            out.append(("in", slot, tuple(int(k) for k in opts[b:b + a])))
        elif code in (AND, OR):
            out.append(("and" if code == AND else "or",))
        elif code == NOT:
            out.append(("not",))
        else:
            assert code == CONST
            out.append(("const", bool(a)))
    return tuple(out)


@pytest.mark.parametrize("program,cols", PROGRAMS + [
    ((("const", False),), (3,)),
    (tuple([("num", i, op, i - 3) for i, op in enumerate(
        ("lt", "le", "gt", "ge", "eq", "ne", "lt", "ge"))]
        + [("between", 7, -2**31 + 1, 2**31 - 1)] + [("and",)] * 8),
     tuple(range(8))),
])
def test_op_table_round_trip(program, cols):
    table, opts = scan_cuda.encode_program(program, len(cols))
    assert table.dtype == np.int32 and table.shape == (len(program), 4)
    assert opts.dtype == np.int32 and opts.size >= 1
    assert decode_program(table, opts) == program


@pytest.mark.parametrize("program", [
    (("num", 0, "lt", 1), ("num", 0, "gt", 1)),       # two values left
    (("and",),),                                       # pops nothing
    (("num", 2, "lt", 1),),                            # slot past cols
    (("num", 0, "lt", 2**31),),                        # past int32
    (("like", 0, "a%"),),                              # unknown op
    tuple([("const", True)] * 33 + [("and",)] * 32),   # > MAX_OPS ops
])
def test_op_table_refuses_bad_programs(program):
    with pytest.raises(ValueError):
        scan_cuda.encode_program(program, 2)


def test_wrapper_takes_plain_version_on_cpu():
    block = block_of(EDGE_ROWS, 512)[None]
    words = torch.from_numpy(block.view("<u4").view(np.int32).copy())
    before = scan_cuda.launches["scan_codes"]
    got = scan_cuda.scan_codes(words, (("num", 0, "ge", 0),), (1,), COMMA,
                               32)
    assert scan_cuda.launches["scan_codes"] == before
    assert got[0, :len(EDGE_ROWS)].tolist() == EDGE_WANT
    with pytest.raises(ValueError):
        scan_cuda.scan_codes(words, (("num", 0, "ge", 0),), (1,), 10, 32)


# --- K6's tile decomposition (csrc/scan.cu), on the host --------------------

MIB = 1 << 20


@pytest.mark.parametrize("B", [1, 16, 128])
@pytest.mark.parametrize("L", [4096, MIB, 1001])
def test_tile_plan(L, B):
    plan = scan_cuda.tile_plan(L, B)
    assert plan.tile % 32 == 0 and 32 <= plan.tile <= scan_cuda.MAX_TILE
    assert (plan.tiles - 1) * plan.tile < L <= plan.tiles * plan.tile
    assert plan.grid == B * plan.tiles  # a CTA per tile
    assert plan.halo == (0 if plan.tiles == 1 else scan_cuda.HALO)
    assert plan.halo % 32 == 0
    words = (plan.tile + plan.halo) // 32
    assert plan.smem_bytes == plan.tile + plan.halo + 4 * words + 64
    assert plan.smem_bytes <= 48 * 1024  # no opt-in to more
    assert plan.threads == 128
    # the launch's scratch: a status word per tile, then the ticket
    assert 4 * (plan.grid + 1) <= 64 * 1024
    want = {4096: (4096, 1), MIB: (12288, 86), 1001: (1024, 1)}[L]
    assert (plan.tile, plan.tiles) == want


def test_tile_plan_forced_and_refused():
    plan = scan_cuda.tile_plan(MIB, 16, tile=1024, halo=256)
    assert (plan.tile, plan.halo, plan.tiles, plan.grid) == \
        (1024, 256, 1024, 16384)
    assert scan_cuda.tile_plan(MIB, 1, halo=0).halo == 0
    for kw in ({"tile": 48}, {"tile": 0}, {"tile": 32768}, {"halo": 16},
               {"halo": 8192}, {"halo": -32}):
        with pytest.raises(ValueError):
            scan_cuda.tile_plan(MIB, 1, **kw)
    for L, B in ((0, 1), (4096, 0)):
        with pytest.raises(ValueError):
            scan_cuda.tile_plan(L, B)


def parse_cell(cell: bytes):
    """csrc/scan.cu parse_cell: int(cell.strip()) for a cell of 1-16
    bytes and at most 9 digits, right to left; None when it fails."""
    if not 0 < len(cell) <= scan_torch.CELL_W:
        return None
    val, pw, ndig, neg, phase = 0, 1, 0, False, 0
    for b in reversed(cell):
        dig = 48 <= b <= 57
        if phase == 0:
            if b in scan_torch.SPACES:
                continue
            if not dig:
                return None
            phase = 1
        elif phase == 1:
            if not dig:
                if b in (43, 45):
                    neg, phase = b == 45, 2
                elif b in scan_torch.SPACES:
                    phase = 3
                else:
                    return None
                continue
        else:
            if b not in scan_torch.SPACES:
                return None
            phase = 3
            continue
        val += (b - 48) * pw
        pw *= 10
        ndig += 1
    if phase == 0 or ndig > 9:
        return None
    return -val if neg else val


def run_program(program, vals) -> bool:
    stack = []
    for op in program:
        if op[0] == "num":
            stack.append({"lt": vals[op[1]] < op[3], "le": vals[op[1]] <= op[3],
                          "gt": vals[op[1]] > op[3], "ge": vals[op[1]] >= op[3],
                          "eq": vals[op[1]] == op[3],
                          "ne": vals[op[1]] != op[3]}[op[2]])
        elif op[0] == "between":
            stack.append(op[2] <= vals[op[1]] <= op[3])
        elif op[0] == "in":
            stack.append(vals[op[1]] in op[2])
        elif op[0] in ("and", "or"):
            b, a = stack.pop(), stack.pop()
            stack.append(a and b if op[0] == "and" else a or b)
        elif op[0] == "not":
            stack.append(not stack.pop())
        else:
            stack.append(bool(op[1]))
    return stack.pop()


def row_code(block: bytes, s: int, e: int, term: bool, program, cols,
             delim: int) -> int:
    """One row [s, e) of the block: its referenced fields up to the last
    referenced column (a field ends at a delimiter, the last at the row's
    newline when it has one), each parsed, then the program."""
    last, fields, f, fstart = max(cols), {}, 0, s
    for p in range(s, e):
        if f > last:
            break
        if block[p] == delim:
            fields[f] = block[fstart:p]
            f, fstart = f + 1, p + 1
    if term and f <= last:
        fields[f] = block[fstart:e]
    vals = []
    for c in cols:
        v = parse_cell(fields[c]) if c in fields else None
        if v is None:
            return scan_torch.RESIDUAL
        vals.append(v)
    return scan_torch.MATCH if run_program(program, vals) else 0


def tile_walk(block: np.ndarray, program, cols, delim, max_rows, T, H):
    """A numpy model of K6's walk over one block: tiles of T bytes, each
    with a halo of H bytes before it; a tile's rows are those whose
    newline it holds, ranked from the newline counts of the tiles before it
    (the look-back's prefix); a row starts after the previous newline, in
    the tile, in the halo, at the block's start, or (the slow path) before
    the halo; the last tile takes the bytes after the last newline and
    fills every later rank with RESIDUAL. Returns (codes, path counts)."""
    L = len(block)
    raw = block.tobytes()
    tiles = -(-L // T)
    counts = [int((block[k * T: (k + 1) * T] == 10).sum())
              for k in range(tiles)]
    out = np.full(max_rows, -1, np.int32)
    seen = {"tile": 0, "halo": 0, "slow": 0, "fragment": 0, "fill": 0}
    for k in range(tiles):
        ts, te = k * T, min(L, (k + 1) * T)
        ws = max(0, ts - H) if tiles > 1 else 0
        nl = [ws + int(p) for p in np.flatnonzero(block[ws:te] == 10)]
        halo_nl = [p for p in nl if p < ts]
        tile_nl = [p for p in nl if p >= ts]
        excl = sum(counts[:k])
        if halo_nl:
            first = halo_nl[-1] + 1
        elif ws == 0 or excl == 0:
            first = 0
        else:  # the warp's search of device memory before the window
            first = int(np.flatnonzero(block[:ws] == 10)[-1]) + 1
        rows = [(first if j == 0 else tile_nl[j - 1] + 1, e, True)
                for j, e in enumerate(tile_nl)]
        last = k == tiles - 1
        if last:
            rows.append((tile_nl[-1] + 1 if tile_nl else first, L, False))
        for j, (s, e, term) in enumerate(rows):
            rank = excl + j
            if rank >= max_rows:
                break
            seen["fragment" if not term else "slow" if s < ws else
                 "tile" if s >= ts else "halo"] += 1
            out[rank] = row_code(raw, s, e, term, program, cols, delim)
        if last:
            fill = out[excl + len(tile_nl) + 1:]
            seen["fill"] += len(fill)
            fill[:] = scan_torch.RESIDUAL
    assert (out >= 0).all()
    return out, seen


def lineitem_rows(rng, n, crlf=False, empty_every=0):
    """'|' rows of 6 fields, the 2nd and 5th integers (Query A's columns),
    some CRLF-ended, some with empty fields."""
    rows = []
    for i in range(n):
        cells = [b"%d" % i, b"%d" % rng.integers(-50, 4000), b"x" * int(
            rng.integers(0, 40)), b"7", b"%d" % rng.integers(0, 50), b"c"]
        if empty_every and i % empty_every == 0:
            cells[int(rng.integers(0, 6))] = b""
        rows.append(b"|".join(cells) + (b"|\r\n" if crlf else b"|\n"))
    return rows


QUERY_A = (("num", 0, "lt", 2000), ("num", 1, "le", 24), ("and",))


def walk_cases():
    rng = np.random.default_rng(17)
    txt = b"".join(lineitem_rows(rng, 120, crlf=True, empty_every=3))
    crossing = block_of(lineitem_rows(rng, 90), 4096)
    long_row = block_of([txt[:2000], b"9|5|" + b"y" * 1500 + b"|\n",
                         txt[2000:2500]], 4096)
    no_newline = np.frombuffer((b"12|3|4|5|6|" * 400)[:4096], np.uint8)
    sparse = np.frombuffer(b"".join(lineitem_rows(rng, 8)).ljust(4096, b" "),
                           np.uint8)
    return {"crossing": (crossing, 64), "crossing_cut": (crossing, 40),
            "crlf_empty": (block_of([txt[:4000]], 4096), 256),
            "long_row": (long_row, 256), "no_newline": (no_newline, 16),
            "sparse": (sparse, 512)}


@pytest.mark.parametrize("T,H", [(256, 64), (1024, 256), (512, 0)])
@pytest.mark.parametrize("case", list(walk_cases()))
def test_tile_walk_model_matches_plain(case, T, H):
    block, max_rows = walk_cases()[case]
    got, seen = tile_walk(block, QUERY_A, (1, 4), PIPE, max_rows, T, H)
    want = port_codes(block[None], QUERY_A, (1, 4), PIPE, max_rows)[0]
    assert np.array_equal(got, want)
    n = int((block == 10).sum())
    assert seen["fill"] == max(0, max_rows - n - 1)
    assert seen["fragment"] == (n < max_rows)
    if case == "long_row" and H < 1500:
        assert seen["slow"] >= 1         # a row longer than a tile + halo
    if case in ("crossing", "crlf_empty") and H:
        assert seen["halo"] >= 1         # rows starting in the halo
    if case == "no_newline":
        assert (seen["fragment"], seen["tile"], seen["slow"]) == (1, 0, 0)
