"""Bucket replication to an S3 target, the port of
minio_tpu/bucket/replication.py (reference cmd/bucket-replication.go:562-991):
async per-object replication to a remote S3-compatible target via a bounded
worker pool. Targets are registered per bucket (cmd/bucket-targets.go);
replication triggers on object-created/removed events.

The JAX package's target client rides the ``requests`` wheel; the port's
signs with its own ``server/auth.py`` and sends through ``http.client``:
the same method, path, query, signed headers and body on the wire, one
connection per request (``requests`` pools them), a request body streamed
from a file-like in 1 MiB reads under an explicit Content-Length."""
from __future__ import annotations

import http.client
import queue
import threading
import urllib.parse

from ..server.auth import SigV4Verifier, UNSIGNED_PAYLOAD

#: the bytes http.client reads from a streamed request body per send
_BLOCK = 1 << 20
#: a request's socket timeout (the JAX package's ``requests`` timeout)
_TIMEOUT_S = 30.0


class _Response:
    """What a replication step reads of a target's answer, in the shape
    of the ``requests`` response the JAX package's pool reads: the
    status, the headers (case-insensitive), the body at once
    (``content``) or streamed (``iter_content``), and ``close``."""

    def __init__(self, conn: http.client.HTTPConnection,
                 resp: http.client.HTTPResponse, stream: bool):
        self._conn = conn
        self._resp = resp
        self.status_code = resp.status
        self.headers = resp.headers
        self._content = None if stream else self._read_all()

    def _read_all(self) -> bytes:
        try:
            return self._resp.read()
        finally:
            self.close()

    @property
    def content(self) -> bytes:
        if self._content is None:
            self._content = self._read_all()
        return self._content

    def iter_content(self, chunk_size: int = 1 << 20):
        try:
            while True:
                b = self._resp.read(chunk_size)
                if not b:
                    return
                yield b
        finally:
            self.close()

    def close(self) -> None:
        self._resp.close()
        self._conn.close()


class S3Target:
    """Minimal signing S3 client for a replication target (the framework's
    outbound S3 client, like the reference's internal miniogo client)."""

    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 target_bucket: str, region: str = "us-east-1",
                 bandwidth_limit: int = 0):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = target_bucket
        self.ak, self.sk = access_key, secret_key
        self.signer = SigV4Verifier(lambda a: None, region)
        u = urllib.parse.urlsplit(self.endpoint)
        self._https = u.scheme == "https"
        self._host, self._port = u.hostname, u.port
        #: bytes/sec cap for replication uploads to this target (0 = none;
        #: reference cmd/bucket-targets.go BandwidthLimit)
        self.bandwidth_limit = int(bandwidth_limit)

    def _req(self, method: str, key: str, body=b"",
             headers: dict | None = None, query: dict | None = None,
             stream: bool = False) -> _Response:
        path = f"/{self.bucket}/{key}" if key else f"/{self.bucket}"
        q = {k: [v] for k, v in (query or {}).items()}
        host = self.endpoint.split("//", 1)[1]
        h = {"host": host}
        for k, v in (headers or {}).items():
            h[k.lower()] = v
        auth = self.signer.sign_request(self.ak, self.sk, method, path, q,
                                        h, UNSIGNED_PAYLOAD)
        h["authorization"] = auth
        qs = urllib.parse.urlencode([(k, v[0]) for k, v in q.items()])
        url = urllib.parse.quote(path) + (f"?{qs}" if qs else "")
        # bytes, or a file-like body of known size (MonitoredReader): sent
        # under its Content-Length, never chunked; an empty body of a
        # method other than GET and HEAD says 0, as ``requests`` sends it
        n = len(body)
        if n or method not in ("GET", "HEAD"):
            h["content-length"] = str(n)
        cls = http.client.HTTPSConnection if self._https \
            else http.client.HTTPConnection
        conn = cls(self._host, self._port, timeout=_TIMEOUT_S,
                   blocksize=_BLOCK)
        try:
            conn.putrequest(method, url, skip_host=True,
                            skip_accept_encoding=True)
            for k, v in h.items():
                conn.putheader(k, v)
            conn.endheaders()
            if n:
                conn.send(body)
            resp = conn.getresponse()
        except BaseException:
            conn.close()
            raise
        return _Response(conn, resp, stream)

    def put(self, key: str, body, headers: dict | None = None):
        return self._req("PUT", key, body, headers)

    def get(self, key: str):
        return self._req("GET", key)

    def delete(self, key: str):
        return self._req("DELETE", key)

    def ensure_bucket(self):
        self._req("PUT", "")


class ReplicationPool:
    """Bounded async workers (reference replication workers,
    cmd/bucket-replication.go:977): jobs are (bucket, key, op)."""

    def __init__(self, objlayer, workers: int = 4, max_queue: int = 100_000):
        self.obj = objlayer
        #: bucket -> S3Target
        self.targets: dict[str, S3Target] = {}
        self.q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"replication-{i}")
            for i in range(workers)]
        self.replicated = 0
        self.failed = 0

    def set_target(self, bucket: str, target: S3Target):
        target.ensure_bucket()
        self.targets[bucket] = target

    def start(self):
        for t in self._threads:
            t.start()
        return self

    def on_event(self, event: str, bucket: str, oi):
        """Wire as (or into) S3Server.notify."""
        if bucket not in self.targets:
            return
        if event.startswith("s3:ObjectCreated"):
            self.schedule(bucket, oi.name, "put")
        elif event.startswith("s3:ObjectRemoved"):
            self.schedule(bucket, oi.name, "delete")

    def schedule(self, bucket: str, key: str, op: str):
        try:
            self.q.put_nowait((bucket, key, op))
        except queue.Full:
            self.failed += 1

    def _worker(self):
        while not self._stop.is_set():
            try:
                bucket, key, op = self.q.get(timeout=0.5)
            except queue.Empty:
                continue
            with self._inflight_lock:
                self._inflight += 1
            try:
                self._replicate(bucket, key, op)
                self.replicated += 1
            except Exception:  # noqa: BLE001
                self.failed += 1
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

    #: objects above this spill to a temp file instead of RAM
    SPOOL_THRESHOLD = 8 << 20

    def _replicate(self, bucket: str, key: str, op: str):
        import tempfile
        tgt = self.targets.get(bucket)
        if tgt is None:
            return
        if op == "delete":
            r = tgt.delete(key)
            if r.status_code not in (200, 204, 404):
                raise RuntimeError(f"replication delete: {r.status_code}")
            return
        oi = self.obj.get_object_info(bucket, key)
        headers = {"content-type": oi.content_type or
                   "application/octet-stream",
                   "x-amz-meta-replicated-from": bucket}
        for k, v in oi.user_defined.items():
            if k.startswith("x-amz-meta-"):
                headers[k] = v
        from ..utils.compress import META_COMPRESSION, decompress_writer
        from .bandwidth import MonitoredReader, global_monitor
        compressed = oi.internal.get(META_COMPRESSION, "")
        if not compressed and oi.size <= self.SPOOL_THRESHOLD:
            from ..erasure.streaming import BufferSink
            sink = BufferSink()
            self.obj.get_object(bucket, key, sink)
            size = sink.buf.tell()
            sink.buf.seek(0)
            body = MonitoredReader(global_monitor(), bucket, sink.buf,
                                   tgt.bandwidth_limit, total_size=size)
            r = tgt.put(key, body, headers)
        else:
            # spool to disk so multi-GB objects never sit in RAM; the
            # replica must hold PLAINTEXT, so compressed objects stream
            # through the inflater on the way to the spool
            with tempfile.TemporaryFile() as spool:
                if compressed:
                    dz = decompress_writer(compressed, spool)
                    self.obj.get_object(bucket, key, dz)
                    dz.finish()
                else:
                    self.obj.get_object(bucket, key, spool)
                size = spool.tell()
                spool.seek(0)
                body = MonitoredReader(global_monitor(), bucket, spool,
                                       tgt.bandwidth_limit,
                                       total_size=size)
                r = tgt.put(key, body, headers)
        if r.status_code != 200:
            raise RuntimeError(f"replication target: {r.status_code}")

    def resync(self, bucket: str) -> int:
        """Re-schedule every object for replication (reference
        cmd/bucket-replication.go resyncBucket: recover a target that was
        down or newly attached). Returns the number scheduled."""
        if bucket not in self.targets:
            return 0
        count = 0
        for oi in self.obj.iter_objects(bucket):
            self.schedule(bucket, oi.name, "put")
            count += 1
        return count

    def proxy_get(self, bucket: str, key: str, range_header: str = ""):
        """GET proxy-to-target on local miss (reference
        ObjectOptions.ProxyRequest, cmd/object-api-interface.go:55): an
        object not yet replicated back can still be served. The client's
        Range header is forwarded so ranged requests stay ranged, and the
        body STREAMS (never fully resident). Returns (status, body
        iterator, headers dict incl. Content-Length) or None."""
        tgt = self.targets.get(bucket)
        if tgt is None:
            return None
        try:
            hdrs = {"range": range_header} if range_header else None
            r = tgt._req("GET", key, headers=hdrs, stream=True)
        except Exception:  # noqa: BLE001 — target down
            return None
        if r.status_code not in (200, 206):
            r.close()
            return None
        keep = {k: v for k, v in r.headers.items()
                if k.lower() in ("content-type", "content-range", "etag",
                                 "last-modified")}
        # framing: stream only when the target's Content-Length is usable
        # as-is (present and not content-encoded — iter_content decodes
        # gzip, which would desync the advertised length); otherwise
        # materialize once and frame it ourselves
        clen = r.headers.get("Content-Length")
        if clen is not None and not r.headers.get("Content-Encoding"):
            return r.status_code, r.iter_content(1 << 20), keep, int(clen)
        body = r.content
        return r.status_code, iter((body,)), keep, len(body)

    def drain(self, timeout: float = 30.0):
        """Block until the queue is empty AND no worker is mid-replication."""
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._inflight_lock:
                busy = self._inflight
            if self.q.empty() and busy == 0:
                return
            time.sleep(0.05)

    def stop(self):
        self._stop.set()
