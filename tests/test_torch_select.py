"""The port's S3 Select (minio_tpu_torch.s3select) held to the JAX package's
minio_tpu.s3select: the same WHERE programs from ``compile_where``, the same
event-stream bytes from ``run_select`` (the port with ``device="cpu"``, the
JAX package with its scan lane off and on its pure reference) over CSV with
and without the scan lane's query-level fallbacks, GZIP, snappy, JSON lines
and Parquet inputs, and ``select_object_content`` over erasure-coded
objects (plain, degraded, SSE-C) on temp-dir disks."""
import base64
import gzip
import hashlib
import io
import os
import sys
import xml.etree.ElementTree as ET
from xml.sax.saxutils import escape

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from parquet_writer import BYTE_ARRAY, DOUBLE, INT32, write_parquet  # noqa

from minio_tpu.s3select import S3SelectRequest as JRequest  # noqa: E402
from minio_tpu.s3select import device as jdev  # noqa: E402
from minio_tpu.s3select import run_select as j_run_select  # noqa: E402
from minio_tpu.s3select.sql import parse_select as j_parse  # noqa: E402
from minio_tpu.utils.snappy import compress as snappy_compress  # noqa
from minio_tpu_torch.crypto import sse  # noqa: E402
from minio_tpu_torch.erasure import (BitrotAlgorithm, Erasure,  # noqa
                                     new_bitrot_reader, new_bitrot_writer)
from minio_tpu_torch.erasure.bitrot import pick_bitrot_chunk  # noqa: E402
from minio_tpu_torch.erasure.streaming import erasure_encode  # noqa: E402
from minio_tpu_torch.ops import scan_cuda  # noqa: E402
from minio_tpu_torch.runtime.dispatch import (DispatchQueue,  # noqa: E402
                                              global_queue)
from minio_tpu_torch.s3select import (S3SelectRequest,  # noqa: E402
                                      run_select, select_object_content)
from minio_tpu_torch.s3select import device as pdev  # noqa: E402
from minio_tpu_torch.s3select.message import decode_messages  # noqa
from minio_tpu_torch.s3select.sql import SQLError, parse_select  # noqa
from minio_tpu_torch.storage.xlstorage import XLStorage  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import chip_smoke  # noqa: E402

CSV = (b"name,age,city,score\n"
       b"alice,34,paris,10\n"
       b"bob,28,london,-3\n"
       b"carol,41,paris,7\n"
       b"dave,19,tokyo,2.5\n"
       b"erin,x,oslo,9\n")

# tests/test_workloads.py QUERY_MATRIX
QUERY_MATRIX = [
    ("SELECT name FROM S3Object WHERE age > 30", "USE"),
    ("SELECT name, age FROM S3Object WHERE age BETWEEN 25 AND 40", "USE"),
    ("SELECT * FROM S3Object WHERE age IN (19, 41, 99)", "USE"),
    ("SELECT name FROM S3Object WHERE NOT (age = 34 OR age < 20)", "USE"),
    ("SELECT UPPER(name) FROM S3Object WHERE score >= 7 LIMIT 1", "USE"),
    ("SELECT name FROM S3Object WHERE age > 25.5", "USE"),
    ("SELECT s._1 FROM S3Object s WHERE s._2 >= 28", "NONE"),
    ("SELECT name FROM S3Object WHERE age IS NOT NULL", "USE"),
    ("SELECT name FROM S3Object WHERE score < 8 AND age > 0", "USE"),
]

# the chip smoke's select path (TPC-H lineitem, '|', no header)
QUERY_A = "SELECT s._1, s._2, s._5 FROM s3object s " \
    "WHERE s._2 < 2000 AND s._5 <= 24"
QUERY_B = "SELECT s._1 FROM s3object s WHERE s._6 < 1000.5"
LINEITEM = chip_smoke.lineitem(5, 300 / chip_smoke.ROWS_SF1)


def _req(cls, sql, header="NONE", delim=",", infmt="csv",
         compression="NONE"):
    req = cls()
    req.expression = sql
    req.csv_header = header
    req.csv_delim = delim
    req.input_format = infmt
    req.compression = compression
    return req


def both(sql, data, monkeypatch, **kw):
    """(port bytes, [JAX bytes with the lane off, on its reference]) — or
    the error each raised, by class and text."""
    def call(fn):
        out = io.BytesIO()
        try:
            fn(out)
        except Exception as e:  # noqa: BLE001 — compared across packages
            return ("error", type(e).__name__, str(e))
        return out.getvalue()

    port = call(lambda out: run_select(_req(S3SelectRequest, sql, **kw),
                                       data, out, device="cpu"))
    jax = []
    for mode in ("off", "cpu"):
        monkeypatch.setenv("MINIO_TPU_SCAN", mode)
        jax.append(call(lambda out: j_run_select(_req(JRequest, sql, **kw),
                                                 data, out)))
    return port, jax


def records(blob: bytes) -> bytes:
    return b"".join(p for h, p in decode_messages(blob)
                    if h.get(":event-type") == "Records")


@pytest.mark.parametrize("sql,names", [
    ("SELECT name FROM S3Object WHERE age > 30 AND score BETWEEN 0 AND 9",
     {"age": 1, "score": 3}),
    ("SELECT * FROM S3Object WHERE age > 25.5", {"age": 1}),
    ("SELECT * FROM S3Object WHERE age = 25.5", {"age": 1}),
    ("SELECT * FROM S3Object WHERE age = '30'", {"age": 1}),
    ("SELECT * FROM S3Object WHERE age != 'zzz'", {"age": 1}),
    ("SELECT * FROM S3Object WHERE city LIKE 'p%'", {"age": 1, "city": 2}),
    ("SELECT * FROM S3Object WHERE age + 1 > 30", {"age": 1, "city": 2}),
    ("SELECT * FROM S3Object WHERE LOWER(city) = 'paris'",
     {"age": 1, "city": 2}),
    ("SELECT * FROM S3Object WHERE age < 'abc'", {"age": 1, "city": 2}),
    ("SELECT * FROM S3Object WHERE nosuch > 3", {"age": 1, "city": 2}),
    ("SELECT * FROM S3Object WHERE age > 9999999999", {"age": 1}),
    (QUERY_A, {}),
    (QUERY_B, {}),
])
def test_compile_where_matches_jax(sql, names):
    sel = parse_select(sql)
    jsel = j_parse(sql)
    assert pdev.compile_where(sel.where, sel.alias, names) == \
        jdev.compile_where(jsel.where, jsel.alias, names)


@pytest.mark.parametrize("sql,header", QUERY_MATRIX)
def test_run_select_matches_jax(sql, header, monkeypatch):
    port, jax = both(sql, CSV, monkeypatch, header=header)
    assert port == jax[0] == jax[1]
    assert records(port)


@pytest.mark.parametrize("sql", [QUERY_A, QUERY_B,
                                 "SELECT * FROM s3object s WHERE s._4 IN "
                                 "(1, 3) AND NOT s._5 BETWEEN 10 AND 40"])
def test_lineitem_sample_matches_jax(sql, monkeypatch):
    data = LINEITEM["text"]
    assert LINEITEM["rows"] == 300
    port, jax = both(sql, data, monkeypatch, delim="|")
    assert port == jax[0] == jax[1]


@pytest.mark.parametrize("data", [
    b"name,age\n\"quoted, name\",34\nplain,28\nlast,41\n",
    b"name,age\na,34\rb,41\n",
])
def test_query_level_fallbacks_match_jax(data, monkeypatch):
    """A quote or a CR byte anywhere sends the whole query to the classic
    interpreter in both packages: same bytes, or the same csv error."""
    port, jax = both("SELECT name FROM S3Object WHERE age > 30", data,
                     monkeypatch, header="USE")
    assert port == jax[0] == jax[1]


@pytest.mark.parametrize("kind", ["gzip", "snappy", "json", "parquet"])
def test_other_inputs_match_jax(kind, monkeypatch):
    sql = "SELECT name FROM S3Object WHERE age > 30"
    if kind == "gzip":
        kw = dict(header="USE", compression="GZIP")
        data = gzip.compress(CSV)
    elif kind == "snappy":
        kw = dict(header="USE", compression="SNAPPY")
        data = snappy_compress(CSV)
    elif kind == "json":
        kw = dict(infmt="json")
        data = b'{"name":"alice","age":34}\n{"name":"bob","age":28}\n' \
               b'{"name":"carol","age":41}\n'
    else:
        kw = dict(infmt="parquet")
        data = write_parquet([
            {"name": "name", "type": BYTE_ARRAY,
             "values": ["alice", "bob", "carol"]},
            {"name": "age", "type": INT32, "values": [34, 28, 41]},
            {"name": "score", "type": DOUBLE, "values": [1.5, 2.0, -3.25]},
        ], num_rows=3)
    port, jax = both(sql, data, monkeypatch, **kw)
    assert port == jax[0] == jax[1]
    # the CSV's "erin,x" compares as text in both packages
    assert records(port).startswith(b"alice\ncarol\n")


def test_scan_lane_runs_on_the_queue():
    """A compiled WHERE clause over CSV goes through the queue's
    select_scan op (the CPU queue takes the plain version), never K6."""
    q = global_queue("cpu")
    q.reset_stats()
    before = scan_cuda.launches["scan_codes"]
    out = io.BytesIO()
    run_select(_req(S3SelectRequest, QUERY_A, delim="|"), LINEITEM["text"],
               out, device="cpu")
    assert q.stats()["ops"]["select_scan"]["items"] == 1
    assert scan_cuda.launches["scan_codes"] == before


def test_same_sql_from_two_requests_shares_a_flush():
    """Both requests compile the same program (equal, hashable tuples), so
    their blocks bucket together and go out in one flush."""
    sel = [parse_select(QUERY_A) for _ in range(2)]
    progs = [pdev.compile_where(s.where, s.alias, {}) for s in sel]
    assert progs[0] == progs[1] and hash(progs[0]) == hash(progs[1])
    block = np.full(4096, 10, np.uint8)
    text = LINEITEM["text"][:2000]
    block[:text.rindex(b"\n") + 1] = np.frombuffer(
        text[:text.rindex(b"\n") + 1], np.uint8)
    q = DispatchQueue("cpu", max_delay=0.2)
    try:
        futs = [q.select_scan(block.view("<u4").reshape(1, -1), p, c, 124,
                              64) for p, c in progs]
        codes = [f.result(timeout=60) for f in futs]
        assert q.stats()["ops"]["select_scan"] == {"batches": 1, "items": 2}
    finally:
        q.stop()
    assert codes[0].dtype == np.int32 and np.array_equal(codes[0], codes[1])
    assert (codes[0] == 1).any()


# --- select_object_content over erasure-coded objects ----------------------

K, M, BS = 4, 2, 16 << 10
#: Query A with a looser part-key bound, so that a few KiB hold matches
OBJ_SQL = QUERY_A.replace("2000", "100000")
ALGO = BitrotAlgorithm.HIGHWAYHASH256S
CKEY = bytes(range(7, 39))


def _body(sql: str) -> bytes:
    return (b"<SelectObjectContentRequest><Expression>%s</Expression>"
            b"<ExpressionType>SQL</ExpressionType><InputSerialization><CSV>"
            b"<FileHeaderInfo>NONE</FileHeaderInfo><FieldDelimiter>|"
            b"</FieldDelimiter></CSV></InputSerialization>"
            b"<OutputSerialization><CSV/></OutputSerialization>"
            b"</SelectObjectContentRequest>" % escape(sql).encode())


def _ssec_headers():
    return {"x-amz-server-side-encryption-customer-algorithm": "AES256",
            "x-amz-server-side-encryption-customer-key":
                base64.b64encode(CKEY).decode(),
            "x-amz-server-side-encryption-customer-key-md5":
                base64.b64encode(hashlib.md5(CKEY).digest()).decode()}


class _Counting:
    """A shard file source that counts its reads."""

    def __init__(self, src, counter):
        self.src, self.counter = src, counter

    def read_at(self, offset, length):
        self.counter.append(length)
        return self.src.read_at(offset, length)


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """Three objects of the lineitem sample on 6 temp-dir disks: plain,
    plain with two data shards gone, SSE-C."""
    root = tmp_path_factory.mktemp("select")
    disks = [XLStorage(str(root / f"d{i}")) for i in range(K + M)]
    er = Erasure(K, M, BS, device="cpu")
    chunk = pick_bitrot_chunk(er.shard_size(), 16 << 10)
    plain = LINEITEM["text"][:6000]
    plain = plain[:plain.rindex(b"\n") + 1]
    objs = {}
    for name, ssec in (("plain", False), ("degraded", False), ("ssec", True)):
        meta, stream, size = {}, io.BytesIO(plain), len(plain)
        if ssec:
            info = sse.parse_sse_headers(_ssec_headers(), "b", name)
            stream, size, _ = sse.encrypt_setup(info, stream, len(plain),
                                                meta, "b", name,
                                                device="cpu")
        ws = [new_bitrot_writer(d.create_file_writer("b", name), ALGO, chunk)
              for d in disks]
        assert erasure_encode(er, stream, ws, K) == size
        for w in ws:
            w.close()
        objs[name] = (size, meta)
    return disks, er, chunk, plain, objs


def _select(stored, name, sql):
    disks, er, chunk, _, objs = stored
    size, meta = objs[name]
    till = er.shard_file_size(size)
    drop = (0, 1) if name == "degraded" else ()
    readers = [None if i in drop else new_bitrot_reader(
        d.read_file_at("b", name), ALGO, till, chunk)
        for i, d in enumerate(disks)]
    hdr = _ssec_headers() if name == "ssec" else {}
    out = io.BytesIO()
    st = select_object_content(_body(sql), er, readers, size, meta, hdr, "b",
                               name, out, device="cpu")
    return out.getvalue(), st


@pytest.mark.parametrize("name", ["plain", "degraded", "ssec"])
def test_select_object_content_matches_jax(stored, name, monkeypatch):
    plain = stored[3]
    got, st = _select(stored, name, OBJ_SQL)
    monkeypatch.setenv("MINIO_TPU_SCAN", "off")
    want = io.BytesIO()
    jreq = JRequest.parse(_body(OBJ_SQL))
    j_run_select(jreq, plain, want)
    assert records(got) == records(want.getvalue())
    assert records(got)
    size = stored[4][name][0]
    assert st == {"scanned": size, "processed": len(plain),
                  "returned": len(records(got))}
    assert (size > len(plain)) == (name == "ssec")


@pytest.mark.parametrize("body,err", [
    (_body("SELECT FROM WHERE"), SQLError),
    (b"<SelectObjectContentRequest><Expression>", ET.ParseError),
])
def test_bad_request_refused_before_any_read(stored, body, err):
    disks, er, chunk, _, objs = stored
    reads: list = []
    size, meta = objs["plain"]
    readers = [new_bitrot_reader(_Counting(d.read_file_at("b", "plain"),
                                           reads), ALGO,
                                 er.shard_file_size(size), chunk)
               for d in disks]
    with pytest.raises(err):
        select_object_content(body, er, readers, size, meta, {}, "b",
                              "plain", io.BytesIO(), device="cpu")
    assert reads == []
    # the same readers serve a good request afterwards
    select_object_content(_body(QUERY_A), er, readers, size, meta, {}, "b",
                          "plain", io.BytesIO(), device="cpu")
    assert reads


def test_compressed_object_waits_for_the_object_layer(stored):
    """A compressed object (an S2 stream the JAX package's compressor
    made) is inflated before the scan: the records equal the plain
    object's, BytesScanned is the stored size."""
    from minio_tpu.utils import compress as jcz
    disks, er, chunk, plain, objs = stored
    comp = jcz.S2CompressReader(io.BytesIO(plain)).read()
    ws = [new_bitrot_writer(d.create_file_writer("b", "s2"), ALGO, chunk)
          for d in disks]
    assert erasure_encode(er, io.BytesIO(comp), ws, K) == len(comp)
    for w in ws:
        w.close()
    readers = [new_bitrot_reader(d.read_file_at("b", "s2"), ALGO,
                                 er.shard_file_size(len(comp)), chunk)
               for d in disks]
    out = io.BytesIO()
    st = select_object_content(
        _body(OBJ_SQL), er, readers, len(comp),
        {"x-minio-internal-compression": jcz.ALGO_S2}, {}, "b", "s2", out,
        device="cpu")
    want, _ = _select(stored, "plain", OBJ_SQL)
    assert records(out.getvalue()) == records(want) and records(want)
    assert st["scanned"] == len(comp) < len(plain) == st["processed"]


def test_lineitem_text_holds_no_fallback_bytes():
    text = LINEITEM["text"]
    for b in (b'"', b"\r", b"\x00", b","):
        assert b not in text
    offs = LINEITEM["offsets"]
    assert offs[-1] == len(text) and len(offs) == 301
    rows = text.split(b"\n")[:-1]
    assert all(r.count(b"|") == 16 and r.endswith(b"|") for r in rows)
    assert [int(r.split(b"|")[1]) for r in rows] == \
        LINEITEM["partkey"].tolist()
    assert np.array_equal(np.diff(offs), [len(r) + 1 for r in rows])
