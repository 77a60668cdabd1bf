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
