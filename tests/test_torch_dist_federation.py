"""Bucket-DNS federation over etcd in the port (dist/etcd.py,
dist/federation.py and the S3 server's branches), held to the JAX
package's through a stub etcd v3 JSON gateway (the JAX package's own test
stub, copied): the same DNS operations leave the same etcd records, and a
JAX cluster and a port cluster federate with each other — each sees the
other's buckets, proxies requests for them (re-signed after the caller's
own policy gate), refuses a name the other owns, and unregisters on
delete."""
import base64
import json
import os
import secrets
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from s3client import S3Client  # noqa: E402

from minio_tpu.dist.etcd import EtcdClient as JEtcd  # noqa: E402
from minio_tpu.dist.federation import BucketDNS as JDNS  # noqa: E402
from minio_tpu.dist.federation import \
    FederationConflict as JConflict  # noqa: E402
from minio_tpu.objectlayer import ErasureObjects as JObjects  # noqa: E402
from minio_tpu.server import S3Server as JServer  # noqa: E402
from minio_tpu.storage import XLStorage as JXLStorage  # noqa: E402
from minio_tpu_torch.dist.etcd import EtcdClient, EtcdError  # noqa: E402
from minio_tpu_torch.dist.federation import (BucketDNS,  # noqa: E402
                                             FederationConflict,
                                             federation_from_env)
from minio_tpu_torch.objectlayer import ErasureObjects  # noqa: E402
from minio_tpu_torch.server import S3Server  # noqa: E402
from minio_tpu_torch.storage import XLStorage  # noqa: E402

AK, SK = "fedak", "fedsk"


class _StubEtcd(BaseHTTPRequestHandler):
    """etcd v3 JSON gateway subset: kv/put, kv/range (with range_end),
    kv/deleterange."""

    store: dict = {}

    def log_message(self, *a):  # noqa: D102
        pass

    def do_POST(self):  # noqa: N802
        body = json.loads(self.rfile.read(
            int(self.headers.get("Content-Length", 0) or 0)) or b"{}")
        key = base64.b64decode(body.get("key", "")).decode()
        if self.path.endswith("/kv/put"):
            self.store[key] = base64.b64decode(body.get("value", ""))
            return self._reply({})
        if self.path.endswith("/kv/range"):
            if "range_end" in body:
                end = base64.b64decode(body["range_end"]).decode()
                kvs = [{"key": base64.b64encode(k.encode()).decode(),
                        "value": base64.b64encode(v).decode()}
                       for k, v in sorted(self.store.items())
                       if key <= k < end]
            else:
                kvs = [{"key": base64.b64encode(key.encode()).decode(),
                        "value": base64.b64encode(
                            self.store[key]).decode()}] \
                    if key in self.store else []
            return self._reply({"kvs": kvs, "count": str(len(kvs))})
        if self.path.endswith("/kv/deleterange"):
            self.store.pop(key, None)
            return self._reply({})
        if self.path.endswith("/kv/txn"):
            cmp = (body.get("compare") or [{}])[0]
            ckey = base64.b64decode(cmp.get("key", "")).decode()
            if cmp.get("target") == "VALUE":
                want = base64.b64decode(cmp.get("value", ""))
                ok = self.store.get(ckey) == want
            else:  # CREATE: create_revision == 0 -> key absent
                ok = ckey not in self.store
            if ok:
                for op in body.get("success", []):
                    putreq = op.get("request_put")
                    if putreq:
                        k = base64.b64decode(
                            putreq.get("key", "")).decode()
                        self.store[k] = base64.b64decode(
                            putreq.get("value", ""))
                    delreq = op.get("request_delete_range")
                    if delreq:
                        k = base64.b64decode(
                            delreq.get("key", "")).decode()
                        self.store.pop(k, None)
            return self._reply({"succeeded": ok})
        self._reply({}, 404)

    def _reply(self, obj, status=200):
        out = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)


def _stub():
    """A fresh stub gateway: (its URL, its store, the server)."""
    store: dict = {}
    handler = type("Stub", (_StubEtcd,), {"store": store})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", store, httpd


@pytest.fixture(scope="module")
def etcd_url():
    url, _store, httpd = _stub()
    yield url
    httpd.shutdown()
    httpd.server_close()


def _dns_script(etcd_cls, dns_cls, conflict_cls, url: str) -> list:
    """Claims, conflicts, idempotent re-puts, lookups, listings and
    guarded deletes; what each answers."""
    etcd = etcd_cls([url])
    a = dns_cls(etcd, "10.0.0.1", 9000, "race.test")
    b = dns_cls(etcd, "10.0.0.2", 9001, "race.test")
    out = []
    for step in (lambda: a.put("contested"), lambda: b.put("contested"),
                 lambda: a.put("contested"), lambda: b.put("other"),
                 lambda: a.lookup("contested"), lambda: b.lookup("none"),
                 lambda: a.list_buckets(), lambda: b.delete("contested"),
                 lambda: a.lookup("contested"), lambda: a.delete("contested"),
                 lambda: b.put("contested"), lambda: b.list_buckets(),
                 lambda: a.is_mine(b.lookup("contested")),
                 lambda: etcd.get_prefix("/skydns/test/race/")):
        try:
            out.append(step())
        except conflict_cls as e:
            out.append(("conflict", str(e)))
    return out


def test_bucket_dns_leaves_the_same_records():
    runs = []
    for pkg in ("jax", "port"):
        url, store, httpd = _stub()
        try:
            if pkg == "jax":
                ans = _dns_script(JEtcd, JDNS, JConflict, url)
            else:
                ans = _dns_script(EtcdClient, BucketDNS,
                                  FederationConflict, url)
            runs.append((ans, dict(store)))
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert runs[0] == runs[1]
    assert ("conflict", "bucket 'contested' is owned by 10.0.0.1:9000") \
        in runs[1][0]


def test_etcd_client_roundtrip_and_errors(etcd_url):
    etcd = EtcdClient([etcd_url])
    etcd.put("/k/one", "v1")
    etcd.put("/k/two", "v2")
    assert etcd.get("/k/one") == b"v1"
    assert etcd.get("/k/missing") is None
    assert etcd.get_prefix("/k/") == {"/k/one": b"v1", "/k/two": b"v2"}
    assert etcd.put_if_absent("/k/one", "x") is False
    assert etcd.delete_if_value("/k/one", "v1") is True
    assert etcd.get("/k/one") is None
    with pytest.raises(EtcdError):
        EtcdClient([])
    with pytest.raises(EtcdError, match="unreachable"):
        EtcdClient(["http://127.0.0.1:1"], timeout=0.5).get("/k")


def test_federation_from_env(monkeypatch, etcd_url):
    monkeypatch.delenv("MINIO_TPU_ETCD_ENDPOINTS", raising=False)
    assert federation_from_env("h", 1) is None
    monkeypatch.setenv("MINIO_TPU_ETCD_ENDPOINTS", etcd_url)
    monkeypatch.setenv("MINIO_TPU_DOMAIN", "env.test")
    dns = federation_from_env("h", 1)
    assert dns.domain == "env.test" and dns._prefix == "/skydns/test/env/"


@pytest.fixture(scope="module")
def clusters(tmp_path_factory, etcd_url):
    """Cluster A is a JAX server, cluster B a port server: independent
    erasure sets joined only through the bucket DNS."""
    tmp = tmp_path_factory.mktemp("fed")
    a = JServer(JObjects([JXLStorage(str(tmp / "a" / f"d{i}"))
                          for i in range(4)], default_parity=1),
                "127.0.0.1", 0, access_key=AK, secret_key=SK)
    b = S3Server(ErasureObjects([XLStorage(str(tmp / "b" / f"d{i}"))
                                 for i in range(4)], default_parity=1,
                                device="cpu"),
                 "127.0.0.1", 0, access_key=AK, secret_key=SK,
                 device="cpu")
    for srv, dns in ((a, JDNS), (b, BucketDNS)):
        srv.start_background()
        etcd = (JEtcd if dns is JDNS else EtcdClient)([etcd_url])
        srv.enable_federation(dns(etcd, "127.0.0.1", srv.port, "fed.test"))
    yield a, b
    for srv in (a, b):
        srv.shutdown()
    a._httpd.server_close()


def test_federated_bucket_namespace(clusters):
    a, b = clusters
    ca, cb = S3Client(a.endpoint(), AK, SK), S3Client(b.endpoint(), AK, SK)
    assert ca.request("PUT", "/from-jax").status_code == 200
    assert cb.request("PUT", "/from-port").status_code == 200
    for c in (ca, cb):
        r = c.request("GET", "/")
        assert "<Name>from-jax</Name>" in r.text
        assert "<Name>from-port</Name>" in r.text
    # neither cluster may shadow the other's name
    assert cb.request("PUT", "/from-jax").status_code == 409
    assert ca.request("PUT", "/from-port").status_code == 409


@pytest.mark.parametrize("owner", ["jax", "port"])
def test_cross_cluster_proxy(clusters, owner):
    """Writes, reads, HEAD, ranges, listings and deletes through the
    cluster that does not own the bucket land on the one that does."""
    a, b = clusters
    own, other = (a, b) if owner == "jax" else (b, a)
    co = S3Client(own.endpoint(), AK, SK)
    cx = S3Client(other.endpoint(), AK, SK)
    bucket = f"fed-{owner}"
    assert co.request("PUT", f"/{bucket}").status_code == 200
    data = secrets.token_bytes(256 << 10)
    r = cx.request("PUT", f"/{bucket}/obj", body=data)
    assert r.status_code == 200, r.text
    assert own.obj.get_object_bytes(bucket, "obj") == data
    r = cx.request("GET", f"/{bucket}/obj")
    assert r.status_code == 200 and r.content == data
    r = cx.request("HEAD", f"/{bucket}/obj")
    assert r.status_code == 200
    assert int(r.headers["Content-Length"]) == len(data)
    r = cx.request("GET", f"/{bucket}/obj",
                   headers={"Range": "bytes=1000-2000"})
    assert r.status_code == 206 and r.content == data[1000:2001]
    r = cx.request("GET", f"/{bucket}")
    assert r.status_code == 200 and "obj" in r.text
    assert cx.request("DELETE", f"/{bucket}/obj").status_code == 204
    assert own.obj.list_objects(bucket).objects == []


def test_unknown_bucket_still_404s_and_delete_unregisters(clusters):
    a, b = clusters
    ca, cb = S3Client(a.endpoint(), AK, SK), S3Client(b.endpoint(), AK, SK)
    assert cb.request("GET", "/never-created/x").status_code == 404
    assert cb.request("PUT", "/ephemeral").status_code == 200
    assert cb.request("DELETE", "/ephemeral").status_code == 204
    assert ca.request("PUT", "/ephemeral").status_code == 200
    assert ca.request("DELETE", "/ephemeral").status_code == 204


def test_stale_dns_does_not_loop(clusters, etcd_url):
    _, b = clusters
    etcd = EtcdClient([etcd_url])
    prefix = b.federation._prefix
    etcd.put(f"{prefix}ghost/@owner", "127.0.0.1:1")
    etcd.put(f"{prefix}ghost/127.0.0.1:1",
             json.dumps({"host": "127.0.0.1", "port": b.port, "ttl": 30}))
    try:
        r = S3Client(b.endpoint(), AK, SK).request("GET", "/ghost/x")
        assert r.status_code in (404, 503)
    finally:
        etcd.delete(f"{prefix}ghost/@owner")
        etcd.delete(f"{prefix}ghost/127.0.0.1:1")


def test_non_owner_delete_cannot_strip_claim(clusters):
    a, b = clusters
    ca, cb = S3Client(a.endpoint(), AK, SK), S3Client(b.endpoint(), AK, SK)
    assert ca.request("PUT", "/claimed").status_code == 200
    b.obj.make_bucket("claimed")  # a same-named local bucket on B
    assert cb.request("DELETE", "/claimed").status_code == 204
    assert cb.request("PUT", "/claimed").status_code == 409
    assert ("127.0.0.1", a.port) in a.federation.lookup("claimed")
    ca.request("DELETE", "/claimed")


def test_forwarding_enforces_local_policy(tmp_path, etcd_url):
    """A scoped IAM user of the port cluster reads a JAX cluster's bucket
    through it but cannot write or delete there: the caller's own policy
    gate runs before the request is re-signed with cluster
    credentials."""
    p = JServer(JObjects([JXLStorage(str(tmp_path / "p" / f"d{i}"))
                          for i in range(4)], default_parity=1),
                "127.0.0.1", 0, access_key=AK, secret_key=SK)
    q = S3Server(ErasureObjects([XLStorage(str(tmp_path / "q" / f"d{i}"))
                                 for i in range(4)], default_parity=1,
                                device="cpu"),
                 "127.0.0.1", 0, access_key=AK, secret_key=SK,
                 device="cpu")
    q.enable_iam()
    p.start_background()
    q.start_background()
    p.enable_federation(JDNS(JEtcd([etcd_url]), "127.0.0.1", p.port,
                             "fediam.test"))
    q.enable_federation(BucketDNS(EtcdClient([etcd_url]), "127.0.0.1",
                                  q.port, "fediam.test"))
    try:
        root_p = S3Client(p.endpoint(), AK, SK)
        assert root_p.request("PUT", "/locked").status_code == 200
        q.iam.add_user("fviewer", "fviewersecret", policies=["readonly"])
        viewer = S3Client(q.endpoint(), "fviewer", "fviewersecret")
        root_p.request("PUT", "/locked/doc", body=b"data")
        r = viewer.request("GET", "/locked/doc")
        assert r.status_code == 200 and r.content == b"data"
        assert viewer.request("PUT", "/locked/evil",
                              body=b"x").status_code == 403
        assert viewer.request("DELETE", "/locked/doc").status_code == 403
        assert p.obj.get_object_bytes("locked", "doc") == b"data"
    finally:
        for s in (p, q):
            s.shutdown()
        p._httpd.server_close()
