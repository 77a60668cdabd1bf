"""Transparent compression in the port (minio_tpu_torch.utils.compress on
the native snappy and CRC32C of native/s2.cpp) held byte for byte to the
JAX package's (minio_tpu.utils.compress, pure Python) on numpy-made
inputs: the S2 and zlib/1 streams of both are equal, each package's
decompressor reads the other's streams (the three markers, with
skip/limit windows), and a corrupt stream fails alike. Then the servers:
with MINIO_TPU_COMPRESSION=on the JAX S3 server and the port's answer the
same PUT, GET, ranged GET, HEAD, listing, copy and Select of ``.csv`` and
``.bin`` objects alike and leave byte-identical trees (ids pinned), and
each serves the other's tree with the writer's own answers. Last, the
multi-address listeners."""
import io
import os
import sys
import zlib

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from minio_tpu.utils import compress as jcz  # noqa: E402
from minio_tpu.utils.snappy import SnappyError as JSnappyError  # noqa
from minio_tpu_torch import native  # noqa: E402
from minio_tpu_torch.utils import compress as pcz  # noqa: E402
from minio_tpu_torch.utils.snappy import SnappyError  # noqa: E402
from test_torch_s3server import (SELECT, Server, assert_same,  # noqa
                                 norm, pinned, run_both)

SEED = 20261018
BLOCK = 1 << 16


def _csv(n: int) -> bytes:
    """``|``-delimited rows (some repeated fields, so snappy wins)."""
    rng = np.random.default_rng(SEED + n)
    rows = []
    size = 0
    i = 0
    while size < n:
        row = b"%d|%d|%s|%d\n" % (i, int(rng.integers(0, 1000)),
                                  b"name%d" % (i % 97),
                                  int(rng.integers(0, 10**6)))
        rows.append(row)
        size += len(row)
        i += 1
    return b"".join(rows)[:n]


INPUTS = {
    "empty": b"",
    "one byte": b"z",
    "block - 1": _csv(BLOCK - 1),
    "block": _csv(BLOCK),
    "block + 1": _csv(BLOCK + 1),
    "repeats": b"abcabcabcabd" * 30_000,
    "incompressible": np.random.default_rng(SEED).bytes(3 * BLOCK + 7),
    "csv": _csv(5 * BLOCK + 12_345),
}


@pytest.mark.parametrize("name", list(INPUTS))
def test_streams_equal_the_jax_package(name):
    data = INPUTS[name]
    got = pcz.S2CompressReader(io.BytesIO(data)).read()
    want = jcz.S2CompressReader(io.BytesIO(data)).read()
    assert got == want
    # read in odd pieces: the same bytes
    r = pcz.S2CompressReader(io.BytesIO(data))
    pieces = b"".join(iter(lambda: r.read(7_777), b""))
    assert pieces == want
    zgot = pcz.CompressReader(io.BytesIO(data)).read()
    assert zgot == jcz.CompressReader(io.BytesIO(data)).read()
    assert zlib.decompress(zgot) == data
    if name in ("csv", "repeats"):
        assert len(got) < len(data) * 0.8


@pytest.mark.parametrize("marker", [pcz.ALGO_S2, pcz.ALGO_SNAPPY_V1,
                                    pcz.ALGO_ZLIB])
@pytest.mark.parametrize("skip,limit", [(0, -1), (1, 10), (BLOCK - 3, 9),
                                        (BLOCK, BLOCK + 1), (300_000, -1),
                                        (5 * BLOCK, 100_000)])
def test_each_decompressor_reads_the_others_streams(marker, skip, limit):
    data = INPUTS["csv"]
    want = data[skip:] if limit < 0 else data[skip:skip + limit]
    for writer, reader in ((jcz, pcz), (pcz, jcz)):
        make = writer.CompressReader if marker == pcz.ALGO_ZLIB \
            else writer.S2CompressReader
        stream = make(io.BytesIO(data)).read()
        out = io.BytesIO()
        d = reader.decompress_writer(marker, out, skip=skip, limit=limit)
        step = 4093  # writes that cut frames anywhere
        for off in range(0, len(stream), step):
            d.write(stream[off:off + step])
        d.finish()
        assert out.getvalue() == want, (writer.__name__, marker)


def test_logical_bytes_and_markers():
    data = INPUTS["csv"]

    class Info:
        internal = {}

    for marker, make in ((pcz.ALGO_S2, jcz.S2CompressReader),
                         (pcz.ALGO_SNAPPY_V1, jcz.S2CompressReader),
                         (pcz.ALGO_ZLIB, jcz.CompressReader)):
        Info.internal = {pcz.META_COMPRESSION: marker}
        stored = make(io.BytesIO(data)).read()
        assert pcz.logical_bytes(Info, stored) == data
    Info.internal = {}
    assert pcz.logical_bytes(Info, b"raw") == b"raw"
    assert (pcz.ALGO_ZLIB, pcz.ALGO_S2, pcz.ALGO_SNAPPY_V1) == \
        (jcz.ALGO_ZLIB, jcz.ALGO_S2, jcz.ALGO_SNAPPY_V1)


@pytest.mark.parametrize("fmt", ["s2", "zlib", "ZLIB", "bogus"])
def test_config_switches_match(monkeypatch, fmt):
    monkeypatch.setenv("MINIO_TPU_COMPRESSION_FORMAT", fmt)
    assert pcz.algo() == jcz.algo()
    for on in ("", "on", "1", "true", "off"):
        monkeypatch.setenv("MINIO_TPU_COMPRESSION", on)
        monkeypatch.setenv("MINIO_TPU_COMPRESSION_EXTENSIONS",
                           ".dat, .log" if on == "1" else "")
        monkeypatch.setenv("MINIO_TPU_COMPRESSION_MIME",
                           "image/" if on == "true" else "")
        assert pcz.enabled() == jcz.enabled()
        for key, ct in (("a.csv", ""), ("a.CSV", ""), ("a.png", "image/x"),
                        ("a.dat", ""), ("a", "text/plain"),
                        ("a", "application/json; charset=utf-8"),
                        ("a.bin", "application/octet-stream")):
            assert pcz.should_compress(key, ct) == \
                jcz.should_compress(key, ct), (on, key, ct)


@pytest.mark.parametrize("mangle", ["crc", "chunk type", "identifier",
                                    "truncated", "snappy body"])
def test_corrupt_streams_fail_alike(mangle):
    stream = bytearray(jcz.S2CompressReader(io.BytesIO(INPUTS["csv"]))
                       .read())
    if mangle == "crc":
        stream[14] ^= 0x01  # the first chunk's checksum
    elif mangle == "chunk type":
        stream[10] = 0x05   # an unskippable reserved type
    elif mangle == "identifier":
        stream[5] ^= 0x20
    elif mangle == "truncated":
        del stream[-3:]
    else:
        stream[20] = 0xFF   # a copy tag with an offset past the start
    for mod, err in ((pcz, SnappyError), (jcz, JSnappyError)):
        d = mod.S2DecompressWriter(io.BytesIO())
        with pytest.raises(err):
            d.write(bytes(stream))
            d.finish()


def test_native_snappy_equals_the_python_block_codec():
    from minio_tpu.utils import snappy as jsnappy
    for data in list(INPUTS.values()) + [b"ab" * 40_000 + b"c",
                                         _csv(300_000)]:
        block = native.snappy_compress(data)
        assert block == jsnappy.compress(data)
        assert native.snappy_decompress(block) == data
        assert jsnappy.decompress(block) == data
    for bad in (b"", b"\x80", b"\x05\x00", b"\x0a\x0c\x00", b"\x03\x08ab"):
        with pytest.raises(SnappyError):
            native.snappy_decompress(bad)
        with pytest.raises(JSnappyError):
            jsnappy.decompress(bad)


# --- the servers ----------------------------------------------------------

#: the objects of the server script: CSV text over several erasure blocks
#: once compressed, a small CSV, and incompressible bytes under ``.bin``
OBJECTS = {"t/a.csv": _csv(260_000), "t/small.csv": _csv(3_000),
           "t/r.bin": np.random.default_rng(SEED + 1).bytes(70_001)}
RANGES = ("bytes=7-70000", "bytes=65530-131080", "bytes=-1000")
SELECT_CSV = SELECT.replace(b"s._2 &lt; 100", b"s._2 &lt; 300")


def reads(c):
    """The reads each server answers over a tree of the script's objects."""
    for key in OBJECTS:
        yield f"get {key}", c.get_object("b", key)
        yield f"head {key}", c.head_object("b", key)
        for rng in RANGES:
            yield f"range {key} {rng}", c.get_object(
                "b", key, headers={"Range": rng})
    yield "get copy", c.get_object("b", "t/copy.csv")
    yield "list", c.request("GET", "/b", query={"list-type": "2"})
    yield "list v1", c.request("GET", "/b")
    yield "select", c.request("POST", "/b/t/a.csv",
                              query={"select": "", "select-type": "2"},
                              body=SELECT_CSV)


@pytest.mark.parametrize("fmt", ["s2", "zlib"])
def test_compressed_objects_cross_both_ways(tmp_path, pinned, monkeypatch,
                                            fmt):
    monkeypatch.setenv("MINIO_TPU_COMPRESSION", "on")
    monkeypatch.setenv("MINIO_TPU_COMPRESSION_FORMAT", fmt)

    def script(s: Server):
        c = s.cl
        yield "put bucket", c.put_bucket("b")
        for key, data in OBJECTS.items():
            yield f"put {key}", c.put_object("b", key, data)
        yield "copy", c.request("PUT", "/b/t/copy.csv", headers={
            "x-amz-copy-source": "/b/t/a.csv"})
        yield from reads(c)

    out = run_both(pinned, tmp_path, script)
    assert_same(out, tmp_path)
    own = dict(out["jax"])
    marker = (pcz.ALGO_ZLIB if fmt == "zlib" else pcz.ALGO_S2).encode()
    for key, data in OBJECTS.items():
        status, headers, content = own[f"get {key}"]
        assert status == 200 and content == data
        assert headers["content-length"] == str(len(data))
        assert own[f"head {key}"][1]["content-length"] == str(len(data))
        assert own[f"range {key} bytes=7-70000"][2] == data[7:70001]
        assert own[f"range {key} bytes=-1000"][2] == data[-1000:]
    assert own["get copy"][2] == OBJECTS["t/a.csv"]
    assert b"<Size>260000</Size>" in own["list"][2]
    assert own["select"][0] == 200 and b"Records" in own["select"][2]
    from test_torch_objectlayer import tree
    metas = {f: b for f, b in tree(tmp_path / "jax").items()
             if f.endswith("xl.meta") and "/b/t/" in f}
    assert metas and all(marker in b for b in metas.values())
    for reader, writer in (("port", "jax"), ("jax", "port")):
        s = Server(reader, tmp_path / writer)
        try:
            got = [(label, norm(r)) for label, r in reads(s.cl)]
        finally:
            s.close()
        for label, resp in got:
            assert resp == own[label], (reader, writer, label)


def test_compression_off_stores_plain_and_the_copy_keeps_markers(
        tmp_path, monkeypatch):
    """Compression off: a ``.csv`` is stored as sent. A compressed object
    copied with compression off keeps its markers (the copy moves the
    stored bytes)."""
    monkeypatch.setenv("MINIO_TPU_COMPRESSION", "on")
    s = Server("port", tmp_path / "p")
    try:
        c = s.cl
        c.put_bucket("b")
        data = OBJECTS["t/a.csv"]
        c.put_object("b", "z.csv", data)
        monkeypatch.setenv("MINIO_TPU_COMPRESSION", "off")
        c.put_object("b", "plain.csv", data)
        r = c.request("PUT", "/b/z2.csv",
                      headers={"x-amz-copy-source": "/b/z.csv"})
        assert r.status_code == 200
        layer = s.srv.obj
        assert layer.get_object_info("b", "plain.csv").size == len(data)
        zi = layer.get_object_info("b", "z2.csv")
        assert zi.size < len(data) and zi.actual_size == len(data)
        assert zi.internal[pcz.META_COMPRESSION] == pcz.ALGO_S2
        assert c.get_object("b", "z2.csv").content == data
    finally:
        s.close()


def test_server_listens_on_extra_addresses(tmp_path):
    """``extra_addresses``: one server state behind several bindings; a
    failed extra bind leaks no socket and raises."""
    import socket

    from minio_tpu_torch.objectlayer import ErasureObjects
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.storage import XLStorage
    from s3client import S3Client
    from test_torch_s3server import AK, SK
    disks = [XLStorage(str(tmp_path / f"d{i}")) for i in range(4)]
    obj = ErasureObjects(disks, default_parity=2, block_size=BLOCK,
                         device="cpu")
    srv = S3Server(obj, "127.0.0.1", 0, access_key=AK, secret_key=SK,
                   device="cpu", extra_addresses=[("127.0.0.1", 0),
                                                  ("127.0.0.1", 0)])
    srv.start_background()
    try:
        assert len(srv.extra_ports) == 2
        assert len({srv.port, *srv.extra_ports}) == 3
        main = S3Client(srv.endpoint(), AK, SK)
        assert main.put_bucket("b").status_code == 200
        assert main.put_object("b", "o", b"hello").status_code == 200
        for port in srv.extra_ports:
            c = S3Client(f"http://127.0.0.1:{port}", AK, SK)
            assert c.get_object("b", "o").content == b"hello"
    finally:
        srv.shutdown()
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        busy = taken.getsockname()[1]
        bad = S3Server(obj, "127.0.0.1", 0, access_key=AK, secret_key=SK,
                       device="cpu", extra_addresses=[("127.0.0.1", busy)])
        with pytest.raises(OSError):
            bad.build()
        assert bad._httpd is None and bad._extra_httpds == []
