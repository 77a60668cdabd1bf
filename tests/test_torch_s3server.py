"""The port's S3 front end (minio_tpu_torch.server over the port's erasure
set on ``device="cpu"``) held to the JAX package's (minio_tpu.server over
minio_tpu.objectlayer, run as tests/test_s3server.py runs it): both servers
get the same signed requests over real HTTP (tests/s3client.py) and must
answer alike, leave byte-identical disk trees, and serve each other's tree.

Compared per response: the status, the body, and the ETag, Content-Length,
Content-Range, Content-Type, Last-Modified, Accept-Ranges, Location and
every ``x-amz-*`` header. Masked (see ``norm``): ``x-amz-request-id`` and
the error XML's ``RequestId`` (random per request in both), the
ListBuckets ``CreationDate`` (the bucket directory's ctime) and the
server's own port in a CompleteMultipartUpload ``Location``. Nothing else:
with the persisted ids, the times, the bucket records' creation time and
the SSE-C object keys pinned per module (``pinned``), the version ids,
upload ids and LastModified values agree too. The trees are compared file
by file, leaving out only ``.minio.sys/tmp`` (staging) and the listing
cache blocks under ``.metacache`` (``TREE_SKIPS``).

Geometry: 4+2 with 64 KiB blocks; objects up to ~200 KB (the plain
HighwayHash of the CPU queue costs ~0.2 s per flush here)."""
import base64
import dataclasses
import hashlib
import hmac
import itertools
import os
import re
import secrets
import socket
import subprocess
import sys
import time
import urllib.parse

import numpy as np
import pytest
import requests
import torch

from minio_tpu.bucket import metadata as jmeta
from minio_tpu.crypto import kms as jkms
from minio_tpu.objectlayer import ErasureObjects as JObjects
from minio_tpu.objectlayer import multipart as jmp
from minio_tpu.server import S3Server as JServer
from minio_tpu.server.auth import (EMPTY_SHA256, UNSIGNED_PAYLOAD,
                                   SigV4Verifier, canonical_request,
                                   presign_v4, signing_key, string_to_sign)
from minio_tpu.storage import XLStorage as JXLStorage
from minio_tpu_torch.bucket import metadata as pmeta
from minio_tpu_torch.crypto import kms as pkms
from minio_tpu_torch.objectlayer import ErasureObjects
from minio_tpu_torch.objectlayer import multipart as pmp
from minio_tpu_torch.server import S3Server
from minio_tpu_torch.storage import XLStorage
from s3client import S3Client
from test_torch_objectlayer import Pin, tree

AK, SK = "testadmin", "testadmin-secret"
N, PARITY, BLOCK = 6, 2, 1 << 16
SEED = 20261017
CREATED = 1.6e9
#: the only paths of the trees left out of the comparison
TREE_SKIPS = (".minio.sys/tmp", "/.metacache")
SSE_KEY = bytes(range(32))
SSE = {"x-amz-server-side-encryption-customer-algorithm": "AES256",
       "x-amz-server-side-encryption-customer-key":
           base64.b64encode(SSE_KEY).decode(),
       "x-amz-server-side-encryption-customer-key-md5":
           base64.b64encode(hashlib.md5(SSE_KEY).digest()).decode()}
WRONG_KEY = bytes(32)
SSE_WRONG = {**SSE,
             "x-amz-server-side-encryption-customer-key":
                 base64.b64encode(WRONG_KEY).decode(),
             "x-amz-server-side-encryption-customer-key-md5":
                 base64.b64encode(hashlib.md5(WRONG_KEY).digest()).decode()}
CSV = b"".join(b"%d|%d|name%d\n" % (i, (i * 37) % 1000, i)
               for i in range(400))
SELECT = (b"<SelectObjectContentRequest><Expression>SELECT s._1, s._3 FROM "
          b"s3object s WHERE s._2 &lt; 100</Expression><ExpressionType>SQL"
          b"</ExpressionType><InputSerialization><CompressionType>NONE"
          b"</CompressionType><CSV><FileHeaderInfo>NONE</FileHeaderInfo>"
          b"<FieldDelimiter>|</FieldDelimiter></CSV></InputSerialization>"
          b"<OutputSerialization><CSV/></OutputSerialization>"
          b"</SelectObjectContentRequest>")


def body(n: int, tag: int = 0) -> bytes:
    return np.random.default_rng(SEED + n + tag).bytes(n)


class Keys:
    """``secrets.token_bytes`` on a counter: the SSE-C object keys and
    IVs both servers draw, the same sequence after each reset."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._n = itertools.count(1)

    def __call__(self, n: int = 32) -> bytes:
        return hashlib.sha256(b"%d" % next(self._n)).digest()[:n]


@pytest.fixture
def pinned(monkeypatch):
    """Pin the ids and times both packages persist (see
    test_torch_objectlayer.Pin), the bucket records' creation time, and
    the SSE object keys, IVs and KMS data keys; both servers write
    ChaCha20-Poly1305 SSE objects (the port's default package cipher)
    unless a test sets ``MINIO_TPU_SSE_CIPHER`` again, and resolve their
    KMS afresh from the root secret; the JAX server runs Select without
    its scan lane; a non-final multipart part may be 64 KiB here."""
    pin = Pin(monkeypatch)
    for mod in (jmeta, pmeta):
        cls = dataclasses.make_dataclass(
            "BucketMetadata",
            [("created", float,
              dataclasses.field(default_factory=lambda: CREATED))],
            bases=(mod.BucketMetadata,))
        monkeypatch.setattr(mod, "BucketMetadata", cls)
    keys = Keys()
    monkeypatch.setattr(secrets, "token_bytes", keys)
    for mod in (jmp, pmp):
        monkeypatch.setattr(mod, "MIN_PART_SIZE", 64 << 10)
    monkeypatch.setenv("MINIO_TPU_SSE_CIPHER", "chacha20-poly1305")
    monkeypatch.setenv("MINIO_TPU_SCAN", "off")
    for var in [v for v in os.environ if v.startswith("MINIO_TPU_KMS_")]:
        monkeypatch.delenv(var)
    for mod in (jkms, pkms):
        monkeypatch.setattr(mod, "_kms", None)
    orig = pin.reset

    def reset():
        orig()
        keys.reset()

    pin.reset = reset
    return pin


class Server:
    """One package's S3 server over its erasure set on ``root``."""

    def __init__(self, pkg: str, root):
        self.pkg = pkg
        self.root = str(root)
        port = pkg == "port"
        disk = XLStorage if port else JXLStorage
        disks = [disk(os.path.join(self.root, f"d{i:02d}"))
                 for i in range(N)]
        if port:
            obj = ErasureObjects(disks, default_parity=PARITY,
                                 block_size=BLOCK, device="cpu")
            self.srv = S3Server(obj, "127.0.0.1", 0, access_key=AK,
                                secret_key=SK, device="cpu")
        else:
            obj = JObjects(disks, default_parity=PARITY, block_size=BLOCK)
            self.srv = JServer(obj, "127.0.0.1", 0, access_key=AK,
                               secret_key=SK)
        self.srv.start_background()
        self.cl = S3Client(self.srv.endpoint(), AK, SK)
        self.host = self.srv.endpoint().split("//", 1)[1]

    def close(self):
        self.srv.shutdown()
        if self.pkg == "jax":
            self.srv._httpd.server_close()

    def send(self, method, path, body=b"", headers=None, query=None,
             payload_hash=UNSIGNED_PAYLOAD):
        """A request signed over ``payload_hash`` whatever the body."""
        query = {k: [v] for k, v in (query or {}).items()}
        h = {"host": self.host, **(headers or {})}
        h["authorization"] = self.cl.signer.sign_request(
            AK, SK, method, path, query, h, payload_hash)
        qs = urllib.parse.urlencode([(k, v[0]) for k, v in query.items()])
        url = self.srv.endpoint() + urllib.parse.quote(path) + \
            (f"?{qs}" if qs else "")
        return requests.request(method, url, data=body, headers=h)

    def chunked_put(self, path, payload, tamper=False):
        """A STREAMING-AWS4-HMAC-SHA256-PAYLOAD upload in 64 KiB chunks,
        as mc and the AWS SDKs send it."""
        ts = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        scope = f"{ts[:8]}/us-east-1/s3/aws4_request"
        headers = {"host": self.host, "x-amz-date": ts,
                   "x-amz-content-sha256":
                       "STREAMING-AWS4-HMAC-SHA256-PAYLOAD",
                   "x-amz-decoded-content-length": str(len(payload))}
        signed = sorted(headers)
        creq = canonical_request("PUT", path, {}, headers, signed,
                                 "STREAMING-AWS4-HMAC-SHA256-PAYLOAD")
        key = signing_key(SK, ts[:8], "us-east-1")
        prev = hmac.new(key, string_to_sign(ts, scope, creq).encode(),
                        hashlib.sha256).hexdigest()
        headers["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={AK}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={prev}")
        out = bytearray()
        chunks = [payload[i:i + 65536]
                  for i in range(0, len(payload), 65536)]
        for chunk in chunks + [b""]:
            sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", ts, scope, prev,
                             EMPTY_SHA256,
                             hashlib.sha256(chunk).hexdigest()])
            prev = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
            out += f"{len(chunk):x};chunk-signature={prev}\r\n".encode()
            out += chunk + b"\r\n"
        if tamper:
            out[out.find(b"\r\n") + 102] ^= 0xFF
        return requests.put(self.srv.endpoint() + path, data=bytes(out),
                            headers=headers)

    def presigned_v2_get(self, path):
        expires = str(int(time.time()) + 600)
        sts = SigV4Verifier(lambda a: None)._v2_string_to_sign(
            "GET", path, {}, {}, expires=expires)
        sig = base64.b64encode(hmac.new(SK.encode(), sts.encode(),
                                        hashlib.sha1).digest()).decode()
        qs = urllib.parse.urlencode({"AWSAccessKeyId": AK,
                                     "Expires": expires, "Signature": sig})
        return requests.get(f"{self.srv.endpoint()}{path}?{qs}")


_HEADERS = ("etag", "content-length", "content-range", "content-type",
            "last-modified", "accept-ranges", "location")
_MASKS = ((re.compile(rb"<RequestId>[0-9a-f]*</RequestId>"),
           b"<RequestId>*</RequestId>"),
          (re.compile(rb"<CreationDate>[^<]*</CreationDate>"),
           b"<CreationDate>*</CreationDate>"),
          (re.compile(rb"http://127\.0\.0\.1:[0-9]+/"),
           b"http://127.0.0.1:*/"))


def norm(r) -> tuple:
    """The parts of a response the comparison holds equal."""
    h = {k.lower(): v for k, v in r.headers.items()
         if k.lower() in _HEADERS or k.lower().startswith("x-amz-")}
    assert re.fullmatch("[0-9a-f]{32}", h.pop("x-amz-request-id")), h
    content = r.content
    for pattern, mask in _MASKS:
        content = pattern.sub(mask, content)
    return r.status_code, h, content


def run_both(pinned, tmp_path, script) -> dict:
    """script(server) on the JAX server and on the port's, each over a
    fresh tree, from the same pinned ids; returns the two transcripts."""
    out = {}
    for pkg in ("jax", "port"):
        pinned.reset()
        s = Server(pkg, tmp_path / pkg)
        try:
            out[pkg] = [(label, norm(r)) for label, r in script(s)]
        finally:
            s.close()
    return out


def assert_same(out: dict, tmp_path):
    jax, port = out["jax"], out["port"]
    assert [lbl for lbl, _ in port] == [lbl for lbl, _ in jax]
    for (label, want), (_, got) in zip(jax, port):
        assert got == want, label
    assert sorted(tree(tmp_path / "port")) == sorted(tree(tmp_path / "jax"))
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")


def xml_keys(r) -> list:
    return re.findall(rb"<Key>([^<]*)</Key>", r.content)


# --- the scripts: each returns (label, response) pairs ----------------------


def buckets_script(s: Server):
    c = s.cl
    yield "put bucket", c.put_bucket("b")
    yield "put bucket again", c.put_bucket("b")
    yield "put bucket bad name", c.put_bucket("B_ad")
    yield "put bucket 2", c.put_bucket("other")
    yield "list buckets", c.request("GET", "/")
    yield "head bucket", c.request("HEAD", "/b")
    yield "head missing bucket", c.request("HEAD", "/nope")
    yield "location", c.request("GET", "/b", query={"location": ""})
    yield "tagging none", c.request("GET", "/b", query={"tagging": ""})
    tags = (b"<Tagging><TagSet><Tag><Key>env</Key><Value>prod</Value></Tag>"
            b"<Tag><Key>team</Key><Value>a &amp; b</Value></Tag></TagSet>"
            b"</Tagging>")
    yield "put tagging", c.request("PUT", "/b", query={"tagging": ""},
                                   body=tags)
    yield "get tagging", c.request("GET", "/b", query={"tagging": ""})
    yield "delete tagging", c.request("DELETE", "/b",
                                      query={"tagging": ""})
    yield "tagging after delete", c.request("GET", "/b",
                                            query={"tagging": ""})
    yield "versioning unset", c.request("GET", "/b",
                                        query={"versioning": ""})
    names = ["a/1.txt", "a/2.txt", "a/b/3.json", "b.html", "c", "d/é x"]
    for i, name in enumerate(names):
        yield f"put {name}", c.put_object("b", name, body(500 + i))
    yield "list v2", c.request("GET", "/b", query={"list-type": "2"})
    yield "list v2 delimiter", c.request(
        "GET", "/b", query={"list-type": "2", "delimiter": "/"})
    yield "list v2 prefix", c.request(
        "GET", "/b", query={"list-type": "2", "prefix": "a/",
                            "delimiter": "/"})
    r = c.request("GET", "/b", query={"list-type": "2", "max-keys": "2"})
    yield "list v2 page 1", r
    token = re.search(rb"<NextContinuationToken>([^<]*)<", r.content)
    r = c.request("GET", "/b", query={
        "list-type": "2", "max-keys": "2",
        "continuation-token": token.group(1).decode()})
    yield "list v2 page 2", r
    yield "list v2 start-after", c.request(
        "GET", "/b", query={"list-type": "2", "start-after": "b.html"})
    yield "list v1", c.request("GET", "/b")
    yield "list v1 marker", c.request("GET", "/b", query={
        "marker": "a/b/3.json", "max-keys": "2"})
    yield "list missing bucket", c.request("GET", "/nope",
                                           query={"list-type": "2"})
    yield "delete non-empty bucket", c.delete_bucket("b")
    objs = "".join(f"<Object><Key>{n}</Key></Object>" for n in names[:3])
    yield "delete objects", c.request(
        "POST", "/b", query={"delete": ""},
        body=f"<Delete>{objs}<Object><Key>missing</Key></Object>"
             f"</Delete>".encode())
    objs = "".join(f"<Object><Key>{n}</Key></Object>" for n in names[3:])
    yield "delete objects quiet", c.request(
        "POST", "/b", query={"delete": ""},
        body=f"<Delete><Quiet>true</Quiet>{objs}</Delete>".encode())
    yield "list after deletes", c.request("GET", "/b",
                                          query={"list-type": "2"})
    yield "delete bucket", c.delete_bucket("b")
    yield "delete missing bucket", c.delete_bucket("b")
    yield "bad service op", c.request("DELETE", "/")


def objects_script(s: Server):
    c = s.cl
    c.put_bucket("b")
    big = body(131_075)
    yield "put small", c.put_object("b", "dir/small.txt", body(1000), headers={
        "content-type": "application/x-test", "x-amz-meta-color": "teal",
        "cache-control": "no-cache"})
    yield "put big", c.put_object("b", "dir/big.bin", big)
    yield "put html", c.put_object("b", "page.html", b"<html></html>")
    yield "put signed payload", c.put_object("b", "signed", b"signed-body",
                                             sign_payload=True)
    yield "put wrong sha256", s.send(
        "PUT", "/b/badsha", b"some-body",
        payload_hash=hashlib.sha256(b"other").hexdigest())
    good = base64.b64encode(hashlib.md5(b"md5-body").digest()).decode()
    yield "put content-md5", c.put_object("b", "md5", b"md5-body",
                                          headers={"content-md5": good})
    bad = base64.b64encode(hashlib.md5(b"x").digest()).decode()
    yield "put bad content-md5", c.put_object("b", "md5bad", b"md5-body",
                                              headers={"content-md5": bad})
    yield "put invalid content-md5", c.put_object(
        "b", "md5inv", b"md5-body", headers={"content-md5": "!!"})
    yield "put chunked", s.chunked_put("/b/chunked", big[:70_000])
    yield "put chunked tampered", s.chunked_put("/b/tampered",
                                                big[:70_000], tamper=True)
    yield "get small", c.get_object("b", "dir/small.txt")
    yield "get big", c.get_object("b", "dir/big.bin")
    yield "get chunked", c.get_object("b", "chunked")
    yield "get signed", c.get_object("b", "signed")
    yield "head big", c.head_object("b", "dir/big.bin")
    yield "head html", c.head_object("b", "page.html")
    for rng in ("bytes=65000-66000", "bytes=-100", "bytes=131075-"):
        yield f"range {rng}", c.get_object("b", "dir/big.bin",
                                           headers={"Range": rng})
    for rng in ("bytes=0-0", "bytes=990-3000", "bytes=5-2", "bytes=-0",
                "bytes=abc", "items=0-1", "bytes=1-2,5-6"):
        yield f"small range {rng}", c.get_object(
            "b", "dir/small.txt", headers={"Range": rng})
    etag = c.head_object("b", "dir/small.txt").headers["ETag"]
    yield "if-none-match", c.get_object("b", "dir/small.txt",
                                        headers={"If-None-Match": etag})
    yield "if-match bogus", c.get_object("b", "dir/small.txt",
                                         headers={"If-Match": '"bogus"'})
    yield "if-match", c.get_object("b", "dir/small.txt",
                                   headers={"If-Match": etag})
    yield "head if-match bogus", c.head_object(
        "b", "dir/small.txt", headers={"If-Match": '"bogus"'})
    yield "get missing key", c.get_object("b", "missing")
    yield "get missing bucket", c.get_object("nobucket", "x")
    yield "head missing key", c.head_object("b", "missing")
    yield "presigned v4 get", requests.get(presign_v4(
        "GET", "http", s.host, "/b/dir/small.txt", AK, SK, "us-east-1",
        600))
    yield "presigned v2 get", s.presigned_v2_get("/b/page.html")
    yield "copy", c.request("PUT", "/b/copy",
                            headers={"x-amz-copy-source":
                                     "/b/dir/small.txt"})
    yield "get copy", c.get_object("b", "copy")
    yield "copy replace", c.request(
        "PUT", "/b/copy2", headers={"x-amz-copy-source": "/b/page.html",
                                    "x-amz-metadata-directive": "REPLACE",
                                    "content-type": "text/plain",
                                    "x-amz-meta-new": "1"})
    yield "head copy replace", c.head_object("b", "copy2")
    yield "copy missing source", c.request(
        "PUT", "/b/copy3", headers={"x-amz-copy-source": "/b/missing"})
    tags = (b"<Tagging><TagSet><Tag><Key>k</Key><Value>v</Value></Tag>"
            b"</TagSet></Tagging>")
    yield "put object tagging", c.request(
        "PUT", "/b/dir/small.txt", query={"tagging": ""}, body=tags)
    yield "get object tagging", c.request(
        "GET", "/b/dir/small.txt", query={"tagging": ""})
    yield "delete object tagging", c.request(
        "DELETE", "/b/dir/small.txt", query={"tagging": ""})
    yield "get object tagging after", c.request(
        "GET", "/b/dir/small.txt", query={"tagging": ""})
    yield "delete object", c.delete_object("b", "page.html")
    yield "delete missing object", c.delete_object("b", "page.html")
    yield "get deleted", c.get_object("b", "page.html")
    yield "bad auth secret", S3Client(s.srv.endpoint(), AK,
                                      "wrong-secret").get_object(
        "b", "dir/small.txt")
    yield "bad auth key", S3Client(s.srv.endpoint(), "nobody",
                                   SK).get_object("b", "dir/small.txt")
    yield "anonymous", requests.get(s.srv.endpoint() + "/b/dir/small.txt")
    yield "health live", requests.get(s.srv.endpoint() +
                                      "/minio/health/live")
    yield "health ready", requests.get(s.srv.endpoint() +
                                       "/minio/health/ready")


def versioning_multipart_script(s: Server):
    c = s.cl
    c.put_bucket("vb")
    on = (b"<VersioningConfiguration><Status>Enabled</Status>"
          b"</VersioningConfiguration>")
    off = (b"<VersioningConfiguration><Status>Suspended</Status>"
           b"</VersioningConfiguration>")
    yield "versioning on", c.request("PUT", "/vb", query={"versioning": ""},
                                     body=on)
    yield "get versioning", c.request("GET", "/vb",
                                      query={"versioning": ""})
    r1 = c.put_object("vb", "v", b"one")
    yield "put v1", r1
    yield "put v2", c.put_object("vb", "v", b"two-two")
    v1 = r1.headers["x-amz-version-id"]
    yield "get latest", c.get_object("vb", "v")
    yield "get v1", c.get_object("vb", "v", query={"versionId": v1})
    yield "head v1", c.head_object("vb", "v", query={"versionId": v1})
    yield "get bad version", c.get_object(
        "vb", "v", query={"versionId": "00000000-0000-0000-0000-00000000ffff"})
    yield "delete (marker)", c.delete_object("vb", "v")
    yield "get after marker", c.get_object("vb", "v")
    yield "list versions", c.request("GET", "/vb", query={"versions": ""})
    yield "delete v1", c.delete_object("vb", "v", query={"versionId": v1})
    yield "list versions after", c.request("GET", "/vb",
                                           query={"versions": ""})
    yield "versioning suspended", c.request(
        "PUT", "/vb", query={"versioning": ""}, body=off)
    yield "get versioning suspended", c.request(
        "GET", "/vb", query={"versioning": ""})
    # multipart: list, parts, errors, complete, abort
    c.put_bucket("mp")
    r = c.request("POST", "/mp/big", query={"uploads": ""},
                  headers={"content-type": "application/x-mp"})
    yield "initiate", r
    uid = re.search(rb"<UploadId>([^<]*)<", r.content).group(1).decode()
    yield "list uploads", c.request("GET", "/mp", query={"uploads": ""})
    p1, p2 = body(100_000, 1), body(3000, 2)
    e1 = c.request("PUT", "/mp/big", query={"partNumber": "1",
                                            "uploadId": uid}, body=p1)
    yield "put part 1", e1
    bad = base64.b64encode(hashlib.md5(b"x").digest()).decode()
    yield "put part bad md5", c.request(
        "PUT", "/mp/big", query={"partNumber": "2", "uploadId": uid},
        body=p2, headers={"content-md5": bad})
    e2 = c.request("PUT", "/mp/big", query={"partNumber": "2",
                                            "uploadId": uid}, body=p2)
    yield "put part 2", e2
    yield "put part no upload", c.request(
        "PUT", "/mp/big", query={"partNumber": "1", "uploadId": "nope"},
        body=p2)
    yield "list parts", c.request("GET", "/mp/big",
                                  query={"uploadId": uid})
    yield "list parts page", c.request(
        "GET", "/mp/big", query={"uploadId": uid, "max-parts": "1"})

    def complete(parts):
        xml = "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag>"
                      f"</Part>" for n, e in parts)
        return c.request("POST", "/mp/big", query={"uploadId": uid},
                         body=f"<CompleteMultipartUpload>{xml}"
                              f"</CompleteMultipartUpload>".encode())

    yield "complete bad etag", complete([(1, e1.headers["ETag"]),
                                         (2, '"ffff"')])
    yield "complete bad order", complete([(2, e2.headers["ETag"]),
                                          (1, e1.headers["ETag"])])
    yield "complete", complete([(1, e1.headers["ETag"]),
                                (2, e2.headers["ETag"])])
    yield "get multipart", c.get_object("mp", "big")
    yield "range across parts", c.get_object(
        "mp", "big", headers={"Range": "bytes=99990-100010"})
    yield "head multipart", c.head_object("mp", "big")
    r = c.request("POST", "/mp/small", query={"uploads": ""})
    uid2 = re.search(rb"<UploadId>([^<]*)<", r.content).group(1).decode()
    s1 = c.request("PUT", "/mp/small", query={"partNumber": "1",
                                              "uploadId": uid2},
                   body=b"x" * 1000)
    s2 = c.request("PUT", "/mp/small", query={"partNumber": "2",
                                              "uploadId": uid2},
                   body=b"y" * 1000)
    xml = (f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
           f"<ETag>{s1.headers['ETag']}</ETag></Part><Part><PartNumber>2"
           f"</PartNumber><ETag>{s2.headers['ETag']}</ETag></Part>"
           f"</CompleteMultipartUpload>").encode()
    yield "complete too small", c.request(
        "POST", "/mp/small", query={"uploadId": uid2}, body=xml)
    yield "abort", c.request("DELETE", "/mp/small",
                             query={"uploadId": uid2})
    yield "abort again", c.request("DELETE", "/mp/small",
                                   query={"uploadId": uid2})
    yield "list uploads after", c.request("GET", "/mp",
                                          query={"uploads": ""})


def sse_select_script(s: Server):
    c = s.cl
    c.put_bucket("enc")
    plain = body(70_000, 3)
    yield "sse put", c.put_object("enc", "o", plain, headers=SSE)
    yield "sse put short", c.put_object("enc", "short", b"tiny", headers=SSE)
    yield "sse get", c.get_object("enc", "o", headers=SSE)
    yield "sse get short", c.get_object("enc", "short", headers=SSE)
    yield "sse ranged get", c.get_object(
        "enc", "o", headers={**SSE, "Range": "bytes=65530-70000"})
    yield "sse head", c.head_object("enc", "o", headers=SSE)
    yield "sse get without key", c.get_object("enc", "o")
    yield "sse get wrong key", c.get_object("enc", "o", headers=SSE_WRONG)
    bad_md5 = {**SSE, "x-amz-server-side-encryption-customer-key-md5":
               base64.b64encode(b"0" * 16).decode()}
    yield "sse put bad key md5", c.put_object("enc", "x", b"abc",
                                              headers=bad_md5)
    yield "sse put bad algorithm", c.put_object(
        "enc", "x", b"abc", headers={
            **SSE, "x-amz-server-side-encryption-customer-algorithm":
                "AES128"})
    yield "sse copy refused", c.request(
        "PUT", "/enc/copy", headers={"x-amz-copy-source": "/enc/o"})
    yield "sse multipart refused", c.request(
        "POST", "/enc/mp", query={"uploads": ""}, headers=SSE)
    yield "list encrypted", c.request("GET", "/enc",
                                      query={"list-type": "2"})
    c.put_bucket("sel")
    yield "put csv", c.put_object("sel", "t.csv", CSV)
    yield "put csv sse", c.put_object("sel", "e.csv", CSV, headers=SSE)
    yield "select", c.request("POST", "/sel/t.csv",
                              query={"select": "", "select-type": "2"},
                              body=SELECT)
    yield "select sse", c.request("POST", "/sel/e.csv",
                                  query={"select": "", "select-type": "2"},
                                  body=SELECT, headers=SSE)
    yield "select bad sql", c.request(
        "POST", "/sel/t.csv", query={"select": "", "select-type": "2"},
        body=SELECT.replace(b"SELECT", b"SELEKT"))
    yield "select missing", c.request(
        "POST", "/sel/none.csv", query={"select": "", "select-type": "2"},
        body=SELECT)


def quota_script(s: Server):
    """The hard quota: set and read back through the admin ops, checked
    against the usage snapshot."""
    c = s.cl
    c.put_bucket("q")
    yield "set quota", c.request(
        "PUT", "/minio/admin/v3/set-bucket-quota", query={"bucket": "q"},
        body=b'{"quota": 1500}')
    yield "get quota", c.request("GET", "/minio/admin/v3/get-bucket-quota",
                                 query={"bucket": "q"})
    yield "put under quota", c.put_object("q", "a", b"x" * 1000)
    yield "put over quota", c.put_object("q", "b", b"x" * 2000)
    r = c.request("POST", "/q/mp", query={"uploads": ""})
    uid = re.search(rb"<UploadId>([^<]*)<", r.content).group(1).decode()
    yield "part over quota", c.request(
        "PUT", "/q/mp", query={"partNumber": "1", "uploadId": uid},
        body=b"y" * 1600)
    c.request("DELETE", "/q/mp", query={"uploadId": uid})


def _kms_of(s: Server):
    return pkms if s.pkg == "port" else jkms


def _dead_endpoint() -> str:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{sk.getsockname()[1]}"


KMS_CTX = base64.b64encode(b'{"tenant": "t1", "app": ["a", 2]}').decode()
SSE_S3 = {"x-amz-server-side-encryption": "AES256"}
SSE_KMS = {"x-amz-server-side-encryption": "aws:kms"}
SSE_KMS_KEY = {**SSE_KMS,
               "x-amz-server-side-encryption-aws-kms-key-id": "tenant-key",
               "x-amz-server-side-encryption-context": KMS_CTX}


def sse_kms_script(s: Server):
    """SSE-S3 and SSE-KMS under the process KMS (a LocalKMS derived from
    the root secret): PUT, GET, ranged GET, HEAD and Select, what is not
    wired in either package, a rotated master key (403) and a KMS outage
    (503), and the admin KMS ops."""
    c = s.cl
    kms = _kms_of(s)
    c.put_bucket("kms")
    plain = body(70_000, 4)
    yield "s3 put", c.put_object("kms", "s3", plain, headers=SSE_S3)
    yield "s3 put short", c.put_object("kms", "s3-short", b"tiny",
                                       headers=SSE_S3)
    yield "kms put default key", c.put_object("kms", "k", plain,
                                              headers=SSE_KMS)
    yield "kms put key and context", c.put_object("kms", "kc", plain,
                                                  headers=SSE_KMS_KEY)
    yield "kms put bad context", c.put_object(
        "kms", "bad", b"abc", headers={
            **SSE_KMS, "x-amz-server-side-encryption-context": "e30"})
    yield "kms put context not an object", c.put_object(
        "kms", "bad", b"abc", headers={
            **SSE_KMS, "x-amz-server-side-encryption-context":
                base64.b64encode(b"[1]").decode()})
    for key in ("s3", "s3-short", "k", "kc"):
        yield f"get {key}", c.get_object("kms", key)
        yield f"head {key}", c.head_object("kms", key)
    for rng in ("bytes=65530-70000", "bytes=-7", "bytes=0-0"):
        yield f"s3 range {rng}", c.get_object("kms", "s3",
                                              headers={"Range": rng})
        yield f"kms range {rng}", c.get_object("kms", "kc",
                                               headers={"Range": rng})
    yield "s3 get with sse-c headers", c.get_object("kms", "s3",
                                                    headers=SSE)
    yield "s3 copy refused", c.request(
        "PUT", "/kms/copy", headers={"x-amz-copy-source": "/kms/s3"})
    yield "kms multipart refused", c.request(
        "POST", "/kms/mp", query={"uploads": ""}, headers=SSE_KMS)
    yield "list", c.request("GET", "/kms", query={"list-type": "2"})
    c.put_bucket("sel")
    yield "put csv s3", c.put_object("sel", "e.csv", CSV, headers=SSE_S3)
    yield "put csv kms", c.put_object("sel", "k.csv", CSV,
                                      headers=SSE_KMS_KEY)
    for key in ("e.csv", "k.csv"):
        yield f"select {key}", c.request(
            "POST", f"/sel/{key}", query={"select": "", "select-type": "2"},
            body=SELECT)
    # a second master key: every S3/KMS read is a key mismatch
    kms.set_kms(kms.LocalKMS(hashlib.sha256(b"another master").digest()))
    yield "s3 get other master", c.get_object("kms", "s3")
    yield "kms head other master", c.head_object("kms", "kc")
    # the KMS unreachable: reads and writes answer 503
    kms.set_kms(kms.KESClient([DEAD_KES], "k"))
    yield "kms get outage", c.get_object("kms", "kc")
    yield "s3 put outage", c.put_object("kms", "o2", b"x", headers=SSE_S3)
    yield "kms put outage", c.put_object("kms", "o3", b"x",
                                         headers=SSE_KMS)
    kms.set_kms(None)
    yield "s3 get after", c.get_object("kms", "s3")
    admin = "/minio/admin/v3/"
    yield "kms status", c.request("GET", admin + "kms/status")
    yield "kms key create", c.request("POST", admin + "kms/key/create",
                                      query={"key-id": "new-key"})
    yield "kms key create no id", c.request("POST",
                                            admin + "kms/key/create")
    yield "kms key status default", c.request("GET",
                                              admin + "kms/key/status")
    yield "kms key status named", c.request(
        "GET", admin + "kms/key/status", query={"key-id": "tenant-key"})


#: the module's dead KES endpoint (one port for both servers, so their
#: outage messages agree)
DEAD_KES = _dead_endpoint()

SCRIPTS = {"buckets": buckets_script, "objects": objects_script,
           "versioning_multipart": versioning_multipart_script,
           "sse_select": sse_select_script, "quota": quota_script,
           "sse_kms_aes_gcm": sse_kms_script,
           "sse_kms_chacha20": sse_kms_script}
#: the package cipher a script's servers write (MINIO_TPU_SSE_CIPHER)
SCRIPT_CIPHER = {"sse_kms_aes_gcm": "aes-gcm"}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_same_requests_same_responses_and_trees(tmp_path, pinned, script,
                                                monkeypatch):
    monkeypatch.setenv("MINIO_TPU_SSE_CIPHER",
                       SCRIPT_CIPHER.get(script, "chacha20-poly1305"))
    out = run_both(pinned, tmp_path, SCRIPTS[script])
    assert_same(out, tmp_path)
    statuses = {label: resp[0] for label, resp in out["port"]}
    if script == "objects":
        assert statuses["put wrong sha256"] == 400
        assert statuses["put chunked tampered"] == 403
        assert statuses["range bytes=131075-"] == 416
        assert statuses["if-none-match"] == 304
        assert statuses["presigned v4 get"] == 200
        assert statuses["presigned v2 get"] == 200
    if script == "sse_select":
        assert statuses["select"] == statuses["select sse"] == 200
        assert statuses["sse get wrong key"] == 403
    if script.startswith("sse_kms"):
        replies = dict(out["port"])
        for key in ("s3", "s3-short", "k", "kc"):
            assert statuses[f"get {key}"] == statuses[f"head {key}"] == 200
        assert replies["get kc"][2] == body(70_000, 4)
        assert statuses["s3 range bytes=65530-70000"] == 206
        assert statuses["select e.csv"] == statuses["select k.csv"] == 200
        assert statuses["kms put bad context"] == 400
        assert statuses["s3 get other master"] == 403
        assert statuses["kms get outage"] == statuses["kms put outage"] == 503
        assert b"<Code>ServiceUnavailable</Code>" in \
            replies["kms get outage"][2]
        assert statuses["kms status"] == statuses["kms key create"] == 200
        assert b'"encryption-err": ""' in replies["kms key status named"][2]
        want = "AES256-GCM" if script == "sse_kms_aes_gcm" else \
            "CHACHA20-POLY1305"
        metas = [f for f in tree(tmp_path / "port") if f.endswith("xl.meta")]
        assert metas and all(want.encode() in tree(tmp_path / "port")[f]
                             for f in metas if "/kms/" in f)


def test_each_server_serves_the_others_tree(tmp_path, pinned):
    """The JAX server over the tree the port's wrote, and the port's over
    the JAX server's: every object reads back exact."""
    big = body(131_075)

    def write(s: Server):
        c = s.cl
        c.put_bucket("b")
        c.put_bucket("vb")
        c.request("PUT", "/vb", query={"versioning": ""},
                  body=b"<VersioningConfiguration><Status>Enabled</Status>"
                       b"</VersioningConfiguration>")
        yield "big", c.put_object("b", "big", big)
        yield "small", c.put_object("b", "small", b"s" * 700)
        yield "chunked", s.chunked_put("/b/chunked", big[:70_000])
        yield "sse", c.put_object("b", "sse", big[:70_000], headers=SSE)
        yield "csv", c.put_object("b", "t.csv", CSV)
        yield "v1", c.put_object("vb", "v", b"first")
        yield "v2", c.put_object("vb", "v", b"second")

    out = run_both(pinned, tmp_path, write)
    assert_same(out, tmp_path)
    v1 = dict(out["jax"])["v1"][1]["x-amz-version-id"]
    want = {"big": big, "small": b"s" * 700, "chunked": big[:70_000]}
    replies = {}
    for reader, writer in (("jax", "port"), ("port", "jax")):
        s = Server(reader, tmp_path / writer)
        try:
            c = s.cl
            got = {k: c.get_object("b", k).content for k in want}
            assert got == want, (reader, writer)
            assert c.get_object("b", "sse", headers=SSE).content == \
                big[:70_000]
            r = c.get_object("b", "big", headers={"Range":
                                                  "bytes=65530-65540"})
            assert r.content == big[65530:65541]
            assert c.get_object("vb", "v").content == b"second"
            assert c.get_object("vb", "v",
                                query={"versionId": v1}).content == b"first"
            r = c.request("GET", "/b", query={"list-type": "2"})
            assert xml_keys(r) == [b"big", b"chunked", b"small", b"sse",
                                   b"t.csv"]
            replies[reader] = [norm(r), norm(c.request(
                "POST", "/b/t.csv", query={"select": "", "select-type": "2"},
                body=SELECT)), norm(c.get_object("vb", "v"))]
        finally:
            s.close()
    assert replies["port"] == replies["jax"]


def test_each_server_reads_the_others_default_cipher_sse(tmp_path, pinned,
                                                         monkeypatch):
    """The JAX server with no ``MINIO_TPU_SSE_CIPHER`` (so AES-256-GCM, the
    ``cryptography`` wheel being here) writes SSE-C, SSE-S3 and SSE-KMS
    objects; the port, told ``aes-gcm``, writes the same. The trees are
    byte-identical, and each server reads the other's objects with the
    writer's own status, headers and plaintext."""
    plain = body(70_000, 5)
    objects = {"c": SSE, "s3": SSE_S3, "kms": SSE_KMS_KEY}

    def reads(c):
        for key, hdr in objects.items():
            get_hdr = SSE if hdr is SSE else {}
            yield f"get {key}", c.get_object("b", key, headers=get_hdr)
            yield f"head {key}", c.head_object("b", key, headers=get_hdr)
            yield f"range {key}", c.get_object(
                "b", key, headers={**get_hdr, "Range": "bytes=65000-66000"})

    def write(s: Server):
        if s.pkg == "jax":
            monkeypatch.delenv("MINIO_TPU_SSE_CIPHER", raising=False)
        else:
            monkeypatch.setenv("MINIO_TPU_SSE_CIPHER", "aes-gcm")
        c = s.cl
        c.put_bucket("b")
        for key, hdr in objects.items():
            yield f"put {key}", c.put_object("b", key, plain, headers=hdr)
        yield from reads(c)

    out = run_both(pinned, tmp_path, write)
    assert_same(out, tmp_path)
    metas = [f for f, b in tree(tmp_path / "jax").items()
             if f.endswith("xl.meta") and "/b/" in f]
    assert metas and all(b"AES256-GCM" in tree(tmp_path / "jax")[f]
                         for f in metas)
    own = dict(out["jax"])
    assert own["get kms"][2] == plain and own["range c"][0] == 206
    for reader, writer in (("port", "jax"), ("jax", "port")):
        s = Server(reader, tmp_path / writer)
        try:
            got = [(label, norm(r)) for label, r in reads(s.cl)]
        finally:
            s.close()
        for label, resp in got:
            assert resp == own[label], (reader, writer, label)


def test_admin_durability_and_service_ops_match_jax(tmp_path, monkeypatch):
    """``durability`` answers the JAX server's JSON (its counters and the
    flusher's totals are each package's own process totals, which other
    tests in the process move: their names are compared, not values);
    ``service`` acknowledges, then calls the server's hook with the
    action; the CLI's hook re-executes the same command line or exits."""
    got = {}
    for pkg in ("jax", "port"):
        s = Server(pkg, tmp_path / pkg)
        calls = []
        s.srv.on_service_signal = calls.append
        try:
            c = s.cl
            replies = [norm(c.request("POST", "/minio/admin/v3/service",
                                      query={"action": a}))
                       for a in ("restart", "stop", "bogus")]
            dur = c.request("GET", "/minio/admin/v3/durability")
            deadline = time.monotonic() + 10
            while len(calls) < 2 and time.monotonic() < deadline:
                time.sleep(0.05)
        finally:
            s.close()
        doc = dur.json()
        assert all(k.startswith("minio_tpu_durability_")
                   for k in doc.pop("counters"))
        totals = {k: doc.pop(k) for k in ("pending", "flushed_total")}
        assert all(isinstance(v, int) and v >= 0 for v in totals.values())
        got[pkg] = (replies, dur.status_code, doc, sorted(calls))
    assert got["port"] == got["jax"]
    assert got["port"][3] == ["restart", "stop"]
    assert [r[0] for r in got["port"][0]] == [200, 200, 400]
    from minio_tpu_torch.server import __main__ as cli
    seen = []
    monkeypatch.setattr(cli.os, "execv", lambda *a: seen.append(a))
    monkeypatch.setattr(cli.os, "_exit", lambda code: seen.append(code))
    srv = type("Srv", (), {})()
    cli.install_service_hook(srv, ["--device", "cpu", "/d{1...4}"])
    srv.on_service_signal("restart")
    srv.on_service_signal("stop")
    assert seen[0] == (sys.executable, [sys.executable, "-m",
                                        "minio_tpu_torch.server",
                                        "--device", "cpu", "/d{1...4}"])
    assert seen[-1] == 0


def test_unported_planes_answer_not_implemented(tmp_path):
    """What the port does not have answers S3's 501 NotImplemented in the
    error XML shape (the bucket's ``?encryption``, which the JAX server
    names and does not handle, the IAM ops without IAM, the console, STS
    without IAM). A tiered object whose tier is not configured here is
    refused with the JAX server's 403 InvalidObjectState, never served as
    its stub; its HEAD names the tier (the bucket feature planes are held
    to the JAX server in tests/test_torch_{objectlock,lifecycle,tiering,
    replication,events}.py)."""
    s = Server("port", tmp_path)
    try:
        c = s.cl
        c.put_bucket("b")
        c.put_object("b", "o", b"x" * 100)
        calls = [
            ("GET", "/minio/admin/v3/list-users", {}, {}),
            ("POST", "/minio/webrpc", {}, {}),
            ("GET", "/b", {"encryption": ""}, {}),
            ("PUT", "/b", {"encryption": ""}, {}),
        ]
        for method, path, query, headers in calls:
            r = c.request(method, path, query=query, headers=headers)
            assert r.status_code == 501, (method, path, r.content)
            assert b"<Code>NotImplemented</Code>" in r.content
            assert b"<RequestId>" in r.content
        r = requests.post(s.srv.endpoint() + "/",
                          data=b"Action=AssumeRole&Version=2011-06-15")
        assert r.status_code == 501
        # an object the JAX package transitioned to a tier this server
        # does not have
        layer = s.srv.obj
        c.put_object("b", "t", b"")
        layer.update_object_meta("b", "t", {
            "x-minio-internal-transition-tier": "v",
            "x-minio-internal-transition-size": "100"})
        r = c.request("GET", "/b/t")
        assert r.status_code == 403, r.content
        assert b"<Code>InvalidObjectState</Code>" in r.content
        r = c.request("HEAD", "/b/t")
        assert r.status_code == 200
        assert r.headers["x-amz-storage-class"] == "v"
        assert r.headers["Content-Length"] == "100"
        assert c.get_object("b", "o").content == b"x" * 100
    finally:
        s.close()


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def test_cli_needs_the_card_unless_cpu_is_asked(tmp_path):
    """Without a card and without ``--device cpu`` the server exits
    non-zero with resolve_device's error; with ``--device cpu``
    ``python -m minio_tpu_torch.server`` serves signed requests."""
    from minio_tpu_torch.server.__main__ import main
    disks = str(tmp_path / "d{1...4}")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            main(["--address", "127.0.0.1:0", disks])
        assert e.value.code != 0 and "CUDA is not available" in \
            str(e.value.code)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, MINIO_TPU_ROOT_USER=AK,
               MINIO_TPU_ROOT_PASSWORD=SK)
    port = _free_port()
    p = subprocess.Popen([sys.executable, "-m", "minio_tpu_torch.server",
                          "--device", "cpu", "--address",
                          f"127.0.0.1:{port}", disks], env=env,
                         stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 300
        while True:
            try:
                if requests.get(url + "/minio/health/ready",
                                timeout=2).status_code == 200:
                    break
            except requests.ConnectionError:
                pass
            assert p.poll() is None and time.monotonic() < deadline
            time.sleep(0.2)
        c = S3Client(url, AK, SK)
        assert c.put_bucket("cli").status_code == 200
        assert c.put_object("cli", "o", b"hello").status_code == 200
        assert c.get_object("cli", "o").content == b"hello"
    finally:
        p.terminate()
        p.wait(timeout=30)


@pytest.mark.parametrize("argv,item", [
    (["/one/disk"], "item 7"),
    (["--device", "cpu", "--address", "127.0.0.1:9000",
      "http://127.0.0.1:1/d{1...4}"], "matches no endpoint"),
    (["--address", "127.0.0.1:1,127.0.0.1:2", "http://h{1...4}/d"],
     "multi-addr"),
    (["--gateway", "nas", "/mnt"], "item 10"),
    (["/p{1...4}", "/plain"], "ellipses"),
])
def test_cli_refuses_unported_modes(argv, item, capsys):
    """The unported modes, and the distributed arguments the CLI cannot
    serve (no endpoint of this node's address, several addresses)."""
    from minio_tpu_torch.server.__main__ import main
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code != 0
    assert item in capsys.readouterr().err + str(e.value.code)


@pytest.mark.parametrize("args,want", [
    (["/d{1...4}"], "ErasureObjects"),
    (["/d{1...32}"], "ErasureSets"),
    (["/a{1...8}", "/b{1...8}"], "ServerPools"),
])
def test_cli_layouts(tmp_path, args, want):
    from minio_tpu_torch.server.__main__ import build_layer
    layer, banner = build_layer([str(tmp_path) + a for a in args], None,
                                torch.device("cpu"))
    assert type(layer).__name__ == want, banner


def test_bucket_metadata_bytes_equal_the_wheel():
    """BucketMetadata.dump() packs what the msgpack wheel packs (float64
    creation time, bools, bin fields, the nested tag map), and each
    package loads the other's record."""
    fields = dict(name="bkt", created=1.7e9 + 0.125,
                  versioning_enabled=True, versioning_suspended=False,
                  policy_json=b'{"Version":"2012-10-17"}',
                  tagging={"env": "prod", "é": "ü" * 40},
                  lifecycle_xml=b"<L/>" * 100, notification_xml=b"",
                  sse_xml=b"\x00\xff", quota=1 << 40,
                  object_lock_enabled=True, object_lock_xml=b"<O/>",
                  replication_xml=b"<R/>")
    for variant in (fields, {"name": "plain"},
                    dict(fields, tagging={f"k{i}": "v" for i in range(20)},
                         quota=0, created=0.0)):
        j = jmeta.BucketMetadata(**variant)
        p = pmeta.BucketMetadata(**variant)
        if "created" not in variant:
            p.created = j.created
        assert p.dump() == j.dump()
        assert dataclasses.asdict(pmeta.BucketMetadata.load(j.dump())) == \
            dataclasses.asdict(jmeta.BucketMetadata.load(p.dump()))
