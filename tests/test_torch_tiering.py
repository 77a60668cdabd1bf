"""The port's tiers and ILM transition (minio_tpu_torch.bucket.tiers and
bucket.transition, the admin ``tier`` op, the stub's read-through GET,
``POST ?restore``) held to the JAX package's: the same signed script and
transitions against a JAX S3Server and a port one (each with a TierFS
directory at the same path) give the same answers, byte-identical disk
trees — the stubs' xl.meta with their tier pointers, the restored copies,
``tiers.json`` — and byte-identical tier directories; each package reads
the other's stubs through the other's tier objects, restores them and
lists them at their archived size; a lifecycle Transition rule moves an
aged object; both packages' TierS3 send the same signed requests to an S3
tier.

The transition module's tier keys (``uuid.uuid4``) and clock (the
restore window) are pinned per module in both packages."""
import http.server
import itertools
import json
import os
import shutil
import threading
import types
import uuid

import pytest

from minio_tpu.bucket import tiers as jtiers
from minio_tpu.bucket import transition as jtx
from minio_tpu.bucket.lifecycle import LifecycleSys as JLifecycleSys
from minio_tpu_torch.bucket import tiers as ptiers
from minio_tpu_torch.bucket import transition as ptx
from minio_tpu_torch.bucket.lifecycle import LifecycleSys
from test_torch_s3server import (Server, body, norm,  # noqa: F401
                                 pinned)
from test_torch_objectlayer import tree

TX_NOW = 1.75e9
BIG = body(150_000, 7)
#: a ten-year rule over everything (whose pass re-stubs a lapsed restore)
#: and a one-day rule over aged/
RULE = (b"<LifecycleConfiguration><Rule><ID>all</ID><Status>Enabled</Status>"
        b"<Filter><Prefix></Prefix></Filter><Transition><Days>3650</Days>"
        b"<StorageClass>COLD</StorageClass></Transition></Rule>"
        b"<Rule><ID>t</ID><Status>Enabled</Status>"
        b"<Filter><Prefix>aged/</Prefix></Filter><Transition><Days>1</Days>"
        b"<StorageClass>COLD</StorageClass></Transition></Rule>"
        b"</LifecycleConfiguration>")


@pytest.fixture
def tx_pinned(monkeypatch, pinned):
    """The transition modules' uuid and clock on counters, reset with
    ``pinned``."""
    import time
    state = {}

    def reset():
        state["ids"] = itertools.count(1)

    fake_uuid = types.SimpleNamespace(
        uuid4=lambda: uuid.UUID(int=(1 << 100) + next(state["ids"])))
    fake_time = types.SimpleNamespace(time=lambda: TX_NOW,
                                      monotonic=time.monotonic)
    for mod in (jtx, ptx):
        monkeypatch.setattr(mod, "uuid", fake_uuid)
        monkeypatch.setattr(mod, "time", fake_time)
    orig = pinned.reset

    def both():
        orig()
        reset()

    pinned.reset = both
    both()
    return pinned


def _admin(c, method, op, body=b"", **query):
    return c.request(method, f"/minio/admin/v3/{op}", query=query,
                     body=body)


def tier_script(s: Server, cold: str):
    c = s.cl
    yield "list tiers empty", _admin(c, "GET", "tier")
    yield "add tier", _admin(c, "PUT", "tier", json.dumps(
        {"kind": "fs", "name": "COLD", "dir": cold}).encode())
    yield "add tier again", _admin(c, "PUT", "tier", json.dumps(
        {"kind": "fs", "name": "COLD", "dir": cold}).encode())
    yield "add bad kind", _admin(c, "PUT", "tier", json.dumps(
        {"kind": "tape", "name": "X"}).encode())
    yield "add missing field", _admin(c, "PUT", "tier", json.dumps(
        {"kind": "s3", "name": "S"}).encode())
    yield "add s3 tier", _admin(c, "PUT", "tier", json.dumps(
        {"kind": "s3", "name": "REMOTE", "endpoint": "http://127.0.0.1:9",
         "bucket": "rb", "access_key": "ak", "secret_key": "sk"}).encode())
    yield "list tiers", _admin(c, "GET", "tier")
    yield "remove s3 tier", _admin(c, "DELETE", "tier", name="REMOTE")
    c.put_bucket("tb")
    c.put_object("tb", "archive.bin", BIG,
                 headers={"x-amz-meta-owner": "ops"})
    c.put_object("tb", "small.txt", b"small cold text")
    c.put_object("tb", "aged/old.bin", BIG[:70_000])
    for key in ("archive.bin", "small.txt"):
        oi = s.srv.obj.get_object_info("tb", key)
        yield f"transition {key}", s.srv.transition.transition(
            "tb", oi, "COLD")
    oi = s.srv.obj.get_object_info("tb", "small.txt")
    yield "transition twice", s.srv.transition.transition("tb", oi, "COLD")
    yield from reads(c)
    yield "restore missing", c.request("POST", "/tb/nope",
                                       query={"restore": ""})
    yield "restore not archived", c.request("POST", "/tb/aged/old.bin",
                                            query={"restore": ""})
    yield "restore bad xml", c.request("POST", "/tb/archive.bin",
                                       query={"restore": ""},
                                       body=b"<RestoreRequest")
    yield "restore", c.request(
        "POST", "/tb/archive.bin", query={"restore": ""},
        body=b"<RestoreRequest><Days>2</Days></RestoreRequest>")
    yield "head restored", c.head_object("tb", "archive.bin")
    yield "get restored", c.get_object("tb", "archive.bin")
    yield "restore extend", c.request(
        "POST", "/tb/archive.bin", query={"restore": ""},
        body=b"<RestoreRequest><Days>5</Days></RestoreRequest>")
    # the restore window lapses: the lifecycle pass re-stubs the copy
    s.srv.obj.update_object_meta("tb", "archive.bin",
                                 {jtx.META_RESTORE: str(TX_NOW - 1)})
    lc = (LifecycleSys if s.pkg == "port" else JLifecycleSys)(
        s.srv.obj, s.srv.bucket_meta, s.srv.transition)
    yield "put rule", c.request("PUT", "/tb", query={"lifecycle": ""},
                                body=RULE)
    for key in ("archive.bin", "aged/old.bin"):
        oi = s.srv.obj.get_object_info("tb", key)
        oi.mod_time -= 2 * 86400
        yield f"lifecycle {key}", lc.apply("tb", oi)
    yield "head restubbed", c.head_object("tb", "archive.bin")
    yield "get aged", c.get_object("tb", "aged/old.bin")
    yield "delete stub", c.delete_object("tb", "small.txt")


def reads(c):
    yield "head stub", c.head_object("tb", "archive.bin")
    yield "get stub", c.get_object("tb", "archive.bin")
    yield "range stub", c.get_object("tb", "archive.bin",
                                     headers={"Range": "bytes=100-199"})
    yield "get small stub", c.get_object("tb", "small.txt")
    yield "list", c.request("GET", "/tb", query={"list-type": "2"})


def _run(tmp_path, tx_pinned, script) -> dict:
    cold = str(tmp_path / "cold")
    out = {}
    for pkg in ("jax", "port"):
        tx_pinned.reset()
        s = Server(pkg, tmp_path / pkg)
        try:
            out[pkg] = [(label, r if isinstance(r, bool) else norm(r))
                        for label, r in script(s, cold)]
        finally:
            s.close()
        os.rename(cold, tmp_path / f"cold-{pkg}")
    return out


def test_same_tier_script_same_answers_stubs_and_tier_objects(tmp_path,
                                                              tx_pinned):
    out = _run(tmp_path, tx_pinned, tier_script)
    jax, port = out["jax"], out["port"]
    assert [lbl for lbl, _ in port] == [lbl for lbl, _ in jax]
    for (label, want), (_, got) in zip(jax, port):
        assert got == want, label
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    assert tree(tmp_path / "cold-port") == tree(tmp_path / "cold-jax")
    got = dict(port)
    assert got["transition archive.bin"] is True
    assert got["transition twice"] is False
    assert got["get stub"][2] == BIG and got["range stub"][0] == 206
    assert got["head stub"][1]["x-amz-storage-class"] == "COLD"
    assert got["restore"][0] == 202
    assert got["restore not archived"][0] == 403
    assert got["get restored"][2] == BIG
    assert got["lifecycle aged/old.bin"] is False  # moved, not expired
    assert got["get aged"][2] == BIG[:70_000]
    assert got["head restubbed"][1]["x-amz-storage-class"] == "COLD"
    assert "x-amz-restore" not in got["head restubbed"][1]
    # an S3 DELETE of a stub leaves its tier copy (only a lifecycle
    # expiry reclaims it, as in the JAX package)
    objs = tree(tmp_path / "cold-port")
    assert sorted(objs.values(), key=len) == [b"small cold text",
                                              BIG[:70_000], BIG]


def test_each_server_reads_the_others_stubs_and_tier(tmp_path, tx_pinned):
    """The port over the JAX tree with the JAX tier objects (and the
    reverse): the same stubs read through, restore and list alike."""
    out = _run(tmp_path, tx_pinned, tier_script)
    got = {}
    cold = tmp_path / "cold"
    for reader, writer in (("port", "jax"), ("jax", "port")):
        shutil.copytree(tmp_path / f"cold-{writer}", cold)
        tx_pinned.reset()
        s = Server(reader, tmp_path / writer)
        try:
            c = s.cl
            got[reader] = [(label, norm(r)) for label, r in reads(c)] + [
                ("tiers", norm(_admin(c, "GET", "tier"))),
                ("get aged", norm(c.get_object("tb", "aged/old.bin"))),
                ("restore aged", norm(c.request(
                    "POST", "/tb/aged/old.bin", query={"restore": ""}))),
                ("head aged", norm(c.head_object("tb", "aged/old.bin")))]
        finally:
            s.close()
        shutil.rmtree(cold)
    assert got["port"] == got["jax"]
    st = dict(got["port"])
    assert st["get stub"][2] == BIG and st["restore aged"][0] == 202
    assert st["head aged"][1]["x-amz-storage-class"] == "COLD"
    assert dict(out["jax"])["get stub"] == st["get stub"]
    assert st["head stub"][1]["x-amz-storage-class"] == "COLD"


class _Recorder(http.server.BaseHTTPRequestHandler):
    got: list = []

    def _record(self):
        n = int(self.headers.get("Content-Length") or 0)
        data = self.rfile.read(n) if n else b""
        hdrs = {k.lower(): v for k, v in self.headers.items()}
        signed = hdrs["authorization"].split("SignedHeaders=")[1] \
            .split(",")[0].split(";")
        type(self).got.append((self.command, self.path,
                               {k: hdrs[k] for k in signed}, data))
        out = b"tier object" if self.command == "GET" else b""
        self.send_response(404 if self.path.endswith("/missing") else 200)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    do_GET = do_PUT = do_DELETE = _record

    def log_message(self, *a):
        pass


def test_tier_s3_sends_the_jax_requests(monkeypatch):
    """Both packages' TierS3 PUT, GET and DELETE against one recording
    stub: the same methods, paths, signed headers and bodies (the SigV4
    date pinned), and a 404 read as FileNotFound."""
    import datetime
    from minio_tpu.server import auth as jauth
    from minio_tpu_torch.server import auth as pauth
    from minio_tpu.utils import errors as jerr
    from minio_tpu_torch.utils import errors as perr

    class Fixed(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return datetime.datetime(2026, 10, 18, 12, 0, 0, tzinfo=tz)

    for mod in (jauth, pauth):
        monkeypatch.setattr(mod.datetime, "datetime", Fixed)

    class Rec(_Recorder):
        got = []

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Rec)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    seen = {}
    try:
        for name, mod, err in (("jax", jtiers, jerr), ("port", ptiers, perr)):
            Rec.got = []
            t = mod.TierS3("REMOTE", url, "rb", "ak", "sk", prefix="p/x")
            t.put("tb/o/1", b"cold bytes")
            assert t.get("tb/o/1") == b"tier object"
            with pytest.raises(err.FileNotFound):
                t.get("missing")
            t.remove("tb/o/1")
            seen[name] = Rec.got
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert seen["port"] == seen["jax"]
    assert [m for m, *_ in seen["port"]] == ["PUT", "GET", "GET", "DELETE"]
    assert seen["port"][0][1] == "/rb/p/x/tb/o/1"
