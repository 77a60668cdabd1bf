"""The port's MessagePack subset (minio_tpu_torch.utils.msgpack) held to the
``msgpack`` wheel the JAX package writes its xl.meta journals, listing
blocks and part records with: seeded documents and every width edge of
ints, floats, str, bin, arrays and maps pack to the same bytes as
``msgpack.packb(use_bin_type=True)`` and unpack to the object of
``msgpack.unpackb(raw=False, strict_map_key=False)``; a real xl.meta the
JAX object layer wrote round-trips to identical bytes."""
import io

import msgpack
import numpy as np
import pytest

from minio_tpu.objectlayer import ErasureObjects as JObjects
from minio_tpu.storage import XLStorage as JXLStorage
from minio_tpu_torch.utils import msgpack as pm

INT_EDGES = [0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF,
             0x100000000, 2**64 - 1, -1, -32, -33, -128, -129, -32768,
             -32769, -2**31, -2**31 - 1, -2**63]
STR_EDGES = [0, 1, 31, 32, 255, 256, 65535, 65536]
BIN_EDGES = [0, 1, 255, 256, 65535, 65536]
SEQ_EDGES = [0, 15, 16, 65535, 65536]


def _wheel(doc) -> bytes:
    return msgpack.packb(doc, use_bin_type=True)


def _check(doc):
    want = _wheel(doc)
    assert pm.packb(doc) == want
    assert pm.unpackb(want) == msgpack.unpackb(want, raw=False,
                                               strict_map_key=False)


@pytest.mark.parametrize("x", INT_EDGES)
def test_int_widths(x):
    _check(x)
    _check(x + 1 if x < 2**64 - 1 else x - 1)


@pytest.mark.parametrize("x", [0.0, -0.0, 1.5, 1e-310, -2.25e300,
                               float("inf"), 3.141592653589793])
def test_float_is_float64(x):
    assert pm.packb(x)[0] == 0xCB
    _check(x)


def test_float32_reads():
    assert pm.unpackb(b"\xca\x3f\xc0\x00\x00") == 1.5


@pytest.mark.parametrize("n", STR_EDGES)
def test_str_widths(n):
    _check("é" * (n // 2) + "a" * (n % 2))
    _check("x" * n)


@pytest.mark.parametrize("n", BIN_EDGES)
def test_bin_widths(n):
    b = bytes(range(256)) * (n // 256) + bytes(n % 256)
    _check(b)
    assert pm.packb(bytearray(b)) == _wheel(b)
    assert pm.packb(memoryview(b)) == _wheel(b)


@pytest.mark.parametrize("n", SEQ_EDGES)
def test_array_and_map_widths(n):
    _check(list(range(n)))
    _check(tuple(range(n)))
    _check({f"k{i}": i for i in range(n)})


def _random_doc(gen, depth=0):
    kind = gen.integers(0, 9 if depth < 4 else 6)
    if kind == 0:
        return int(gen.integers(-2**63, 2**63 - 1))
    if kind == 1:
        return float(gen.normal() * 10.0 ** gen.integers(-20, 20))
    if kind == 2:
        return "".join(chr(c) for c in gen.integers(32, 0x3000,
                                                     gen.integers(0, 300)))
    if kind == 3:
        return gen.bytes(int(gen.integers(0, 400)))
    if kind == 4:
        return [None, True, False][gen.integers(0, 3)]
    if kind == 5:
        return int(gen.integers(-40, 300))
    if kind == 6:
        return [_random_doc(gen, depth + 1)
                for _ in range(gen.integers(0, 20))]
    if kind == 7:
        return tuple(_random_doc(gen, depth + 1)
                     for _ in range(gen.integers(0, 20)))
    return {f"key{j}-{gen.integers(0, 9)}": _random_doc(gen, depth + 1)
            for j in range(gen.integers(0, 20))}


@pytest.mark.parametrize("seed", range(12))
def test_seeded_documents(seed):
    gen = np.random.default_rng(seed)
    _check({"Versions": [_random_doc(gen) for _ in range(5)],
            "Data": {"x": gen.bytes(64)}, "n": _random_doc(gen)})


@pytest.mark.parametrize("bad", [b"", b"\xc1", b"\xd4\x00\x00", b"\x92\x01",
                                 b"\xa3ab", b"\x01\x02", b"\xc4\x05abc"])
def test_malformed_raises(bad):
    with pytest.raises(ValueError):
        pm.unpackb(bad)


def test_unsupported_type_raises():
    with pytest.raises(ValueError):
        pm.packb({"x": object()})
    with pytest.raises(ValueError):
        pm.packb(2**64)


def test_jax_written_xlmeta_round_trips(tmp_path):
    disks = [JXLStorage(str(tmp_path / f"d{i}")) for i in range(6)]
    ol = JObjects(disks, default_parity=2, block_size=1 << 16)
    ol.make_bucket("b")
    body = np.random.default_rng(3).bytes(200_001)
    ol.put_object("b", "dir/o", io.BytesIO(body), len(body))
    raw = (tmp_path / "d0" / "b" / "dir" / "o" / "xl.meta").read_bytes()
    payload = raw[8:-8]  # the header and the XLC1+CRC trailer
    doc = pm.unpackb(payload)
    assert doc == msgpack.unpackb(payload, raw=False, strict_map_key=False)
    assert pm.packb(doc) == payload
