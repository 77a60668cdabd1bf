"""The port's replication planes held to the JAX package's.

* ``bucket/replication.py``: the port's S3Target (http.client, signed by
  the port's ``server/auth.py``) sends the same requests as the JAX
  package's (``requests``): method, path, query, signed headers, body.
  A ReplicationPool behind ``S3Server.enable_replication`` copies every
  PUT to the target server and replicates its DELETE, on both packages'
  servers, leaving byte-identical target trees; a GET that misses locally
  proxies to the target.
* ``bucket/replicate.py``: the ``?replication`` rules (grammar,
  validation, the sub-resource), the per-object status keys in xl.meta
  (PENDING with the write, COMPLETED once the worker shipped it), the
  journal each package reads from the other, the scanner's sweep, the
  admin ``replication`` op and the SLO plane's lag probe. Its peer
  transport is a recording stub registered per rule endpoint, as the JAX
  package's unit tests run it (the peer RPC client comes with the port's
  dist layer).

The requests' SigV4 clock is pinned in both packages where bytes on the
wire are compared; ids and times of stored objects by ``pinned``."""
import datetime
import http.server
import io
import threading
import time

import pytest

from minio_tpu.bucket import replicate as jrepl
from minio_tpu.bucket import replication as jrep
from minio_tpu.obs import slo as jslo
from minio_tpu.server import auth as jauth
from minio_tpu_torch.bucket import bandwidth as pbw
from minio_tpu_torch.bucket import replicate as prepl
from minio_tpu_torch.bucket import replication as prep
from minio_tpu_torch.obs import slo as pslo
from minio_tpu_torch.server import auth as pauth
from test_torch_s3server import (AK, SK, Server, body,  # noqa: F401
                                 norm, pinned)
from test_torch_objectlayer import tree


class _Fixed(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2026, 10, 18, 12, 0, 0, tzinfo=tz)


@pytest.fixture
def sig_clock(monkeypatch):
    for mod in (jauth, pauth):
        monkeypatch.setattr(mod.datetime, "datetime", _Fixed)


class _Recorder(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    got: list = []

    def _record(self):
        n = int(self.headers.get("Content-Length") or 0)
        data = self.rfile.read(n) if n else b""
        hdrs = {k.lower(): v for k, v in self.headers.items()}
        signed = hdrs["authorization"].split("SignedHeaders=")[1] \
            .split(",")[0].split(";")
        type(self).got.append((self.command, self.path,
                               {k: hdrs[k] for k in signed},
                               hdrs.get("content-length"), data))
        out = b"replica bytes" if self.command == "GET" else b""
        self.send_response(200)
        self.send_header("Content-Length", str(len(out)))
        self.send_header("ETag", '"e"')
        self.end_headers()
        self.wfile.write(out)

    do_GET = do_PUT = do_DELETE = _record

    def log_message(self, *a):
        pass


def test_s3_target_sends_the_jax_requests(sig_clock, monkeypatch):
    """Both packages' S3Target against one recording stub: bucket
    creation, a PUT of bytes with headers, a PUT streamed through a
    throttled MonitoredReader, a ranged GET read whole and streamed, a
    DELETE — the same requests on the wire."""
    from minio_tpu.bucket import bandwidth as jbw
    for mod in (jbw, pbw):
        monkeypatch.setattr(mod, "_monitor", None)

    class Rec(_Recorder):
        got = []

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Rec)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/"
    seen = {}
    data = body(300_000, 3)
    try:
        for name, mod, bw in (("jax", jrep, jbw), ("port", prep, pbw)):
            Rec.got = []
            t = mod.S3Target(url, "ak", "sk", "dst", bandwidth_limit=1 << 22)
            t.ensure_bucket()
            r1 = t.put("dir/o 1", b"object bytes",
                       {"Content-Type": "text/plain",
                        "x-amz-meta-replicated-from": "src"})
            reader = bw.MonitoredReader(bw.global_monitor(), "src",
                                        io.BytesIO(data), t.bandwidth_limit,
                                        total_size=len(data))
            r2 = t.put("big", reader, {"content-type": "app/x"})
            r3 = t._req("GET", "big", headers={"range": "bytes=0-3"})
            r4 = t._req("GET", "big", stream=True)
            streamed = b"".join(r4.iter_content(4))
            r5 = t.delete("dir/o 1")
            seen[name] = (Rec.got, [r.status_code for r in
                                    (r1, r2, r3, r4, r5)],
                          r3.content, streamed, r3.headers.get("etag"))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert seen["port"] == seen["jax"]
    calls = seen["port"][0]
    assert [c[0] for c in calls] == ["PUT", "PUT", "PUT", "GET", "GET",
                                     "DELETE"]
    assert calls[1][1] == "/dst/dir/o%201" and calls[2][4] == data


def _wait(pred, timeout=60):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline
        time.sleep(0.02)


def pool_script(src: Server, dst: Server, pool):
    c = src.cl
    yield "put bucket", c.put_bucket("rb")
    pkg = prep if src.pkg == "port" else jrep
    pool.set_target("rb", pkg.S3Target(dst.srv.endpoint(), AK, SK, "rb"))
    done = 0
    for i, n in enumerate((1000, 70_000, 0)):
        yield f"put o{i}", c.put_object("rb", f"o{i}", body(n, i),
                                        headers={"x-amz-meta-k": f"v{i}"})
        done += 1
        _wait(lambda: pool.replicated + pool.failed >= done)
        pool.drain()
    yield "copy", c.request("PUT", "/rb/copy",
                            headers={"x-amz-copy-source": "/rb/o0"})
    done += 1
    _wait(lambda: pool.replicated + pool.failed >= done)
    pool.drain()
    yield "delete o0", c.delete_object("rb", "o0")
    done += 1
    _wait(lambda: pool.replicated + pool.failed >= done)
    pool.drain()
    yield "target o1", dst.cl.get_object("rb", "o1")
    yield "target head o2", dst.cl.head_object("rb", "o2")
    yield "target o0 gone", dst.cl.get_object("rb", "o0")
    # an object only the target holds: the source's GET proxies to it
    dst.cl.put_object("rb", "remote-only", b"from the target")
    yield "proxied get", c.get_object("rb", "remote-only")
    yield "proxied range", c.get_object(
        "rb", "remote-only", headers={"Range": "bytes=5-7"})
    yield "missing everywhere", c.get_object("rb", "nowhere")


def test_pool_replicates_alike_and_proxies_misses(tmp_path, pinned):
    from minio_tpu.bucket.replication import ReplicationPool as JPool
    from minio_tpu_torch.bucket.replication import ReplicationPool
    out = {}
    counts = {}
    for pkg in ("jax", "port"):
        pinned.reset()
        src = Server(pkg, tmp_path / pkg / "src")
        dst = Server(pkg, tmp_path / pkg / "dst")
        pool = (ReplicationPool if pkg == "port" else JPool)(
            src.srv.obj, workers=1).start()
        src.srv.enable_replication(pool)
        try:
            out[pkg] = [(label, norm(r))
                        for label, r in pool_script(src, dst, pool)]
            counts[pkg] = (pool.replicated, pool.failed)
        finally:
            pool.stop()
            src.close()
            dst.close()
    assert out["port"] == out["jax"]
    assert counts["port"] == counts["jax"] == (5, 0)
    assert tree(tmp_path / "port" / "dst") == tree(tmp_path / "jax" / "dst")
    got = dict(out["port"])
    assert got["target o1"][2] == body(70_000, 1)
    assert got["target o1"][1]["x-amz-meta-k"] == "v1"
    assert got["target o0 gone"][0] == 404
    assert got["proxied get"][0] == 200 and \
        got["proxied get"][2] == b"from the target"
    assert got["proxied range"][2] == b"the"


RULES = (b"<ReplicationConfiguration><Rule><ID>r1</ID><Status>Enabled"
         b"</Status><Priority>1</Priority><Filter><Prefix>logs/</Prefix>"
         b"</Filter><DeleteMarkerReplication><Status>Enabled</Status>"
         b"</DeleteMarkerReplication><Destination><Bucket>arn:aws:s3:::dst"
         b"</Bucket><Endpoint>http://node2:9000/</Endpoint></Destination>"
         b"</Rule><Rule><ID>r2</ID><Status>Enabled</Status><Priority>5"
         b"</Priority><Filter><Prefix>logs/hot/</Prefix></Filter>"
         b"<Destination><Bucket>hot</Bucket><Endpoint>http://node3:9000"
         b"</Endpoint></Destination></Rule></ReplicationConfiguration>")


@pytest.mark.parametrize("blob", [
    RULES, b"",
    b'<ReplicationConfiguration xmlns="http://s3.amazonaws.com/doc/'
    b'2006-03-01/"><Rule><Status>Enabled</Status><Prefix>a/</Prefix>'
    b"<Destination><Bucket>d</Bucket><Endpoint>http://x:1</Endpoint>"
    b"</Destination></Rule></ReplicationConfiguration>",
    b"<ReplicationConfiguration><Rule><Status>Enabled</Status></Rule>"
    b"</ReplicationConfiguration>",
    b"<ReplicationConfiguration><Rule><Status>Disabled</Status></Rule>"
    b"</ReplicationConfiguration>",
], ids=["two-rules", "empty", "namespaced-legacy-prefix",
        "no-destination", "disabled"])
def test_rule_grammar_and_validation_match_jax(blob):
    outs = []
    for mod in (jrepl, prepl):
        rules = [tuple(sorted(vars(r).items()))
                 for r in mod.parse_replication(blob)]
        try:
            mod.validate_replication(blob)
            valid = "valid"
        except ValueError as e:
            valid = str(e)
        outs.append((rules, valid))
    assert outs[0] == outs[1]


class _Peer:
    """The recording peer transport of one rule endpoint."""

    def __init__(self):
        self.calls: list = []

    def replicate_object(self, bucket, key, data, meta=None,
                         version_id="", timeout=None):
        self.calls.append(("put", bucket, key, bytes(data),
                           sorted(meta["user_defined"].items()),
                           meta["etag"], version_id))

    def replicate_delete(self, bucket, key, version_id="", timeout=None):
        self.calls.append(("delete", bucket, key, version_id))


def sys_script(s: Server, rs, peer):
    c = s.cl
    c.put_bucket("src")
    yield "get none", c.request("GET", "/src", query={"replication": ""})
    yield "put bad", c.request(
        "PUT", "/src", query={"replication": ""},
        body=b"<ReplicationConfiguration><Rule><Status>Enabled</Status>"
             b"</Rule></ReplicationConfiguration>")
    yield "put malformed", c.request("PUT", "/src",
                                     query={"replication": ""}, body=b"<x")
    yield "put", c.request("PUT", "/src", query={"replication": ""},
                           body=RULES)
    yield "get", c.request("GET", "/src", query={"replication": ""})
    n = 0
    for key in ("logs/a", "logs/hot/b", "other/c"):
        yield f"put {key}", c.put_object("src", key, body(900, n),
                                         headers={"x-amz-meta-x": key})
    _wait(lambda: rs.completed + rs.failed >= 2)
    rs.drain()
    yield "delete logs/a", c.delete_object("src", "logs/a")
    _wait(lambda: rs.completed + rs.failed >= 3)
    rs.drain()
    # a write that missed its charge is found by the scanner's sweep
    s.srv.obj.update_object_meta("src", "logs/hot/b",
                                 {prepl.META_REP_STATUS: prepl.FAILED})
    oi = s.srv.obj.get_object_info("src", "logs/hot/b")
    yield "sweep", rs.sweep("src", oi)
    _wait(lambda: rs.completed + rs.failed >= 4)
    rs.drain()
    oi = s.srv.obj.get_object_info("src", "other/c")
    yield "sweep unruled", rs.sweep("src", oi)
    yield "head b", c.head_object("src", "logs/hot/b")
    yield "admin replication", c.request("GET",
                                         "/minio/admin/v3/replication")
    yield "admin resync none", c.request(
        "POST", "/minio/admin/v3/replication")
    yield "delete config", c.request("DELETE", "/src",
                                     query={"replication": ""})
    yield "get after delete", c.request("GET", "/src",
                                        query={"replication": ""})


def test_cross_replication_statuses_calls_and_trees_match_jax(tmp_path,
                                                             pinned):
    """The same script through both servers with their ReplicationSys on
    a stub transport per endpoint: the same answers, the same shipped
    calls in the same order, byte-identical trees (the status keys in
    xl.meta), an admin report of the same counts, and the SLO report's
    replication objective."""
    out, calls, stats = {}, {}, {}
    for pkg, mod in (("jax", jrepl), ("port", prepl)):
        pinned.reset()
        s = Server(pkg, tmp_path / pkg)
        rs = mod.ReplicationSys(s.srv.obj, s.srv.bucket_meta)
        peer = _Peer()
        rs._extra_peers.update({"http://node2:9000": peer,
                                "http://node3:9000": peer})
        s.srv.enable_cross_replication(rs.start())
        try:
            res = []
            for label, r in sys_script(s, rs, peer):
                if label == "admin replication":
                    doc = r.json()
                    stats[pkg] = {k: doc[k] for k in (
                        "completed", "failed", "resynced", "queued",
                        "dropped")}
                    assert doc["lag"]["samples"] >= 2
                    continue
                res.append((label, r if isinstance(r, bool) else norm(r)))
            out[pkg] = res
            calls[pkg] = peer.calls
            slo = (pslo if pkg == "port" else jslo).report()
            assert slo["async"]["replication"]["ok"] is True
        finally:
            s.close()
            (pslo if pkg == "port" else jslo).unregister_async_probe(
                "replication")
    assert out["port"] == out["jax"]
    assert calls["port"] == calls["jax"]
    assert stats["port"] == stats["jax"]
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    ops = [(c[0], c[1], c[2]) for c in calls["port"]]
    assert ops == [("put", "dst", "logs/a"), ("put", "hot", "logs/hot/b"),
                   ("delete", "dst", "logs/a"),
                   ("put", "hot", "logs/hot/b")]
    metas = {f: b for f, b in tree(tmp_path / "port").items()
             if "/src/logs/hot/b/" in f and f.endswith("xl.meta")}
    assert metas and all(b"COMPLETED" in b for b in metas.values())
    got = dict(out["port"])
    assert got["sweep"] is True and got["sweep unruled"] is False
    assert got["put bad"][0] == got["put malformed"][0] == 400


def test_each_package_replays_the_others_journal(tmp_path):
    """A journal written by either package (a put, a delete that
    supersedes its put, another put) loads in the other with the same
    obligations; a torn journal loads as empty."""
    for writer, reader in ((jrepl, prepl), (prepl, jrepl)):
        path = str(tmp_path / f"{writer.__name__}.json")
        rs = writer.ReplicationSys(None, None)
        rs.attach_persistence(path)
        rs.dq.add("b", "o1", "", mode="put")
        rs.dq.add("b", "o2", "", mode="put")
        rs.dq.add("b", "o2", "", mode="delete")
        rs.dq.add("b", "o3", "v3", mode="put")
        rs.flush_journal()
        blob = open(path, "rb").read()
        rd = reader.ReplicationSys(None, None)
        assert rd.attach_persistence(path) == 3
        assert {e[1]: (e[2], e[3]) for e in list(rd.dq.q.queue)} == {
            "o1": ("", "put"), "o2": ("", "delete"), "o3": ("v3", "put")}
        with open(path, "wb") as f:
            f.write(blob[:len(blob) // 2])
        assert reader.ReplicationSys(None, None).attach_persistence(path) \
            == 0
    a, b = (open(tmp_path / f"{m.__name__}.json", "rb").read()
            for m in (jrepl, prepl))
    assert a == b  # both torn at the same byte of the same journal


def test_unregistered_endpoint_of_a_node_waits_for_the_dist_layer():
    """Without a node an unknown endpoint has no transport; a node builds
    (and caches) a peer RPC client with its cluster secret, as the JAX
    package does; a registered transport wins."""
    from minio_tpu_torch.dist.peer import PeerRESTClient
    rs = prepl.ReplicationSys(None, None)
    assert rs._peer_for("http://x:1") is None
    rs.node = type("Node", (), {"peers": [], "secret": "s",
                                "local_url": "http://me:1"})()
    built = rs._peer_for("http://x:1")
    assert isinstance(built, PeerRESTClient)
    assert built.url == "http://x:1" and built.rpc.secret == "s"
    assert built.rpc.src == "http://me:1"
    assert rs._peer_for("http://x:1/") is built
    peer = _Peer()
    rs._extra_peers["http://y:1"] = peer
    assert rs._peer_for("http://y:1/") is peer


def test_each_server_reads_the_others_replication_rules(tmp_path, pinned):
    """A ``?replication`` document PUT through one package's server is
    served, parsed and routed alike by the other's over the same tree."""
    def write(s: Server):
        s.cl.put_bucket("src")
        yield "put", s.cl.request("PUT", "/src", query={"replication": ""},
                                  body=RULES)

    from test_torch_s3server import assert_same, run_both
    assert_same(run_both(pinned, tmp_path, write), tmp_path)
    got = {}
    for reader, writer in (("port", "jax"), ("jax", "port")):
        s = Server(reader, tmp_path / writer)
        try:
            rs = (prepl if reader == "port" else jrepl).ReplicationSys(
                s.srv.obj, s.srv.bucket_meta)
            got[reader] = (
                norm(s.cl.request("GET", "/src", query={"replication": ""})),
                [(k, vars(rs.heads_up("src", k)) if rs.heads_up("src", k)
                  else None) for k in ("logs/a", "logs/hot/x", "other")])
        finally:
            s.close()
    assert got["port"] == got["jax"]
    assert got["port"][0][2] == RULES
    assert got["port"][1][1][1]["target_bucket"] == "hot"
