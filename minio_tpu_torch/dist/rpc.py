"""Generic REST-RPC transport, the port of minio_tpu/dist/rpc.py
(reference cmd/rest/client.go:75-233 + SURVEY.md A.7): POST
``/minio/<service>/<version>/<method>?args...`` with an HMAC bearer token,
msgpack or raw-stream bodies. The client marks itself offline on transport
errors and a background ping re-marks it online (reference :204-211) —
the disk and peer failure-detection primitive.

The wire is the JAX package's byte for byte (token, paths, query
parameters, bodies, the typed error in ``x-minio-tpu-error``, the span
header ``x-minio-tpu-traceparent``), so JAX and port nodes form one
cluster. The transport is ``http.client`` over a bounded pool of idle
keep-alive connections per client: a call takes an idle connection or
opens one, and gives it back once its response was read whole (or
closes it, when ``POOL_IDLE_MAX`` are idle already or the call failed),
so threads that come and go leave at most ``POOL_IDLE_MAX`` sockets
behind. A connection the peer closed while idle (a restart, the idle
timeout) is found by a zero-timeout poll before reuse and dropped, never
discovered by a failed call. A streaming call (live trace and console)
gets a connection of its own, closed with the stream.
"""
from __future__ import annotations

import hashlib
import hmac
import http.client
import os
import random
import select
import socket
import threading
import time
import urllib.parse
from collections import deque

from .. import fault as _fault
from ..utils import errors

RPC_VERSION = "v1"
HEALTH_INTERVAL_S = 1.0
#: health ping backoff ceiling: a long-dead peer costs one probe per
#: ~HEALTH_MAX_INTERVAL_S instead of one per second forever — it also
#: bounds how long a REJOINED peer waits to be rediscovered, so chaos
#: tests (and latency-sensitive deployments) can lower it
HEALTH_MAX_INTERVAL_S = float(os.environ.get(
    "MINIO_TPU_RPC_PING_MAX_S", "30"))
#: extra attempts for idempotent (read-only) calls on transport errors
RETRY_BUDGET = 2
RETRY_BACKOFF_S = 0.05
#: successful-call latencies kept per method for ``method_stats``
METHOD_WINDOW = 4096
#: idle keep-alive connections a client keeps; more calls than this in
#: flight open more, and those close after their call
POOL_IDLE_MAX = 32

#: wire form of typed storage errors (class name travels in a header)
_ERR_BY_NAME = {c.__name__: c for c in [
    errors.DiskNotFound, errors.FaultyDisk, errors.DiskFull,
    errors.DiskAccessDenied, errors.UnformattedDisk, errors.CorruptedFormat,
    errors.VolumeNotFound, errors.VolumeExists, errors.VolumeNotEmpty,
    errors.FileNotFound, errors.FileVersionNotFound, errors.FileNameTooLong,
    errors.FileAccessDenied, errors.FileCorrupt, errors.IsNotRegular,
    errors.MethodNotSupported, errors.ErasureReadQuorum,
    errors.ErasureWriteQuorum, errors.LessData, errors.MoreData,
]}

#: transport-level failures: the socket layer and http.client's protocol
#: errors (a peer that closed mid-response, a malformed status line)
_TRANSPORT = (OSError, http.client.HTTPException)


def make_token(secret: str, expiry_s: int = 3600) -> str:
    """Compact HMAC bearer token (the reference uses JWT with the same root
    secret — cmd/jwt.go; an HMAC-signed expiry carries the same guarantee
    without a JWT dependency)."""
    exp = str(int(time.time()) + expiry_s)
    mac = hmac.new(secret.encode(), exp.encode(), hashlib.sha256).hexdigest()
    return f"{exp}.{mac}"


def check_token(secret: str, token: str) -> bool:
    try:
        exp, mac = token.split(".", 1)
        want = hmac.new(secret.encode(), exp.encode(),
                        hashlib.sha256).hexdigest()
        return hmac.compare_digest(want, mac) and int(exp) >= time.time()
    except (ValueError, AttributeError):
        return False


class RPCError(errors.RPCError):
    pass


#: peer EWMA above this means "degraded" in the health snapshot
PEER_DEGRADED_EWMA_S = 0.5
_EWMA_ALPHA = 0.3


class _Connection(http.client.HTTPConnection):
    """A keep-alive connection with Nagle off: RPC bodies are small
    request/response pairs, and a delayed ACK would add ~40 ms to each."""

    def connect(self):
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


def _dropped(sock) -> bool:
    """An idle keep-alive socket that polls readable was closed by the
    peer (or holds stray bytes): either way it must not carry a call."""
    try:
        p = select.poll()
        p.register(sock, select.POLLIN | select.POLLERR | select.POLLHUP)
        return bool(p.poll(0))
    except (OSError, ValueError):
        return True


class _Stream:
    """A streaming response on a connection of its own: ``iter_lines``
    yields its newline-framed records (http.client undoes the chunked
    framing), ``close`` releases both."""

    def __init__(self, conn: http.client.HTTPConnection,
                 resp: http.client.HTTPResponse):
        self._conn = conn
        self._resp = resp

    def iter_lines(self):
        while True:
            line = self._resp.readline()
            if not line:
                return
            yield line.rstrip(b"\r\n")

    def close(self):
        self._resp.close()
        self._conn.close()


class RPCClient:
    """One client per remote service endpoint. Offline marking: any
    transport-level failure flips offline; a daemon ping loop probes
    ``/minio/health/live`` and flips back online.

    ``src`` names the CALLING node (its local URL) — node-layer fault
    rules key asymmetric partitions on (src, dst), and several nodes
    share one process in test topologies, so a process-global "my url"
    cannot exist. The client also keeps a tiny health score (latency
    EWMA + consecutive/total failures) that the node health snapshot
    rolls up per peer — partition and slow-peer injections land here,
    not only disk-layer errors — and per-method call counts and latency
    windows (``method_stats``)."""

    def __init__(self, base_url: str, service: str, secret: str,
                 timeout: float = 30.0, src: str = ""):
        self.base = base_url.rstrip("/")
        u = urllib.parse.urlsplit(self.base)
        if u.scheme != "http":
            raise ValueError(f"rpc endpoint {base_url!r}: only http:// "
                             "peers are served")
        self._host, self._port = u.hostname, u.port or 80
        self.service = service
        self.secret = secret
        self.timeout = timeout
        self.src = src.rstrip("/")
        #: idle keep-alive connections, the most recently used last
        self._idle: list = []
        self._online = True
        self._closed = False
        self._lock = threading.Lock()
        self._ping_thread: threading.Thread | None = None
        self.on_reconnect = None  # hook: called when back online
        self._ewma_s = 0.0
        self.failures_total = 0
        self.consecutive_failures = 0
        self.reconnects_total = 0
        #: wall-clock times (``time.time()``) of the last flips offline
        #: and back online, 0.0 before the first
        self.offline_at = 0.0
        self.online_at = 0.0
        #: method -> [calls, errors, deque of successful-call seconds]
        self._methods: dict[str, list] = {}

    def is_online(self) -> bool:
        return self._online

    def health_stats(self) -> dict:
        """Per-peer health row for the node snapshot: a peer is
        ``degraded`` when it is offline, mid-failure-streak, or its
        success-latency EWMA (which slow-peer delay injections inflate)
        crossed the threshold."""
        ewma = self._ewma_s
        return {
            "online": self._online,
            "ewma_ms": round(ewma * 1e3, 3),
            "failures_total": self.failures_total,
            "consecutive_failures": self.consecutive_failures,
            "reconnects_total": self.reconnects_total,
            "degraded": (not self._online or self.consecutive_failures > 0
                         or ewma > PEER_DEGRADED_EWMA_S),
        }

    def method_stats(self) -> dict:
        """{method: {"calls", "errors", "seconds": [...]}}: the calls made,
        the failed ones, and the last ``METHOD_WINDOW`` successful calls'
        wall seconds (callers merge several clients' windows before
        taking percentiles)."""
        with self._lock:
            return {m: {"calls": c, "errors": e, "seconds": list(w)}
                    for m, (c, e, w) in self._methods.items()}

    def _note_method(self, method: str, dur_s: float | None) -> None:
        with self._lock:
            row = self._methods.get(method)
            if row is None:
                row = self._methods[method] = [
                    0, 0, deque(maxlen=METHOD_WINDOW)]
            row[0] += 1
            if dur_s is None:
                row[1] += 1
            else:
                row[2].append(dur_s)

    def _note_result(self, ok: bool, dur_s: float = 0.0) -> None:
        if ok:
            self.consecutive_failures = 0
            self._ewma_s = dur_s if self._ewma_s == 0.0 else \
                (1 - _EWMA_ALPHA) * self._ewma_s + _EWMA_ALPHA * dur_s
        else:
            self.failures_total += 1
            self.consecutive_failures += 1

    def _mark_offline(self):
        with self._lock:
            if not self._online:
                return
            self._online = False
            self.offline_at = time.time()
            t = threading.Thread(target=self._ping_loop, daemon=True,
                                 name=f"rpc-ping-{self.base}")
            self._ping_thread = t
            t.start()

    def _probe(self) -> bool:
        """One liveness probe on a fresh connection."""
        conn = _Connection(self._host, self._port, timeout=2)
        try:
            conn.request("GET", "/minio/health/live")
            r = conn.getresponse()
            r.read()
            return r.status == 200
        except _TRANSPORT:
            return False
        finally:
            conn.close()

    def _ping_loop(self):
        """Jittered exponential backoff probe (1s doubling to
        HEALTH_MAX_INTERVAL_S, x[0.5, 1.5) jitter so a cluster of
        clients doesn't probe a recovering peer in lockstep). An
        on_reconnect hook failure is logged-and-swallowed — the ping
        daemon itself must survive any callback."""
        interval = HEALTH_INTERVAL_S
        while not self._online and not self._closed:
            time.sleep(interval * (0.5 + random.random()))
            if self._closed:
                return
            if _fault.blocked("node", self.base, self.src):
                # a standing partition rule gates the probe: a
                # partitioned peer must NOT flip back online just
                # because the wire underneath still answers
                interval = min(interval * 2, HEALTH_MAX_INTERVAL_S)
                continue
            if not self._probe():
                interval = min(interval * 2, HEALTH_MAX_INTERVAL_S)
                continue
            self._online = True
            self.online_at = time.time()
            self.reconnects_total += 1
            # the probe IS a successful round trip: clear the failure
            # streak, or an idle cluster (no RPC traffic to call
            # _note_result) reports the recovered peer degraded forever
            self.consecutive_failures = 0
            if self.on_reconnect is not None:
                try:
                    self.on_reconnect(self)
                except Exception as e:  # noqa: BLE001 — a broken hook
                    # must not kill the daemon or the online flip, but
                    # must not vanish either
                    from ..obs.logger import log_sys
                    log_sys().log_once(
                        f"rpc-reconnect:{type(e).__name__}", "warning",
                        "rpc", f"on_reconnect hook failed for "
                        f"{self.base}: {e!r}")
            return

    # -- the wire -------------------------------------------------------------

    def _checkout(self, timeout: float) -> http.client.HTTPConnection:
        """An idle keep-alive connection to the peer, else a new one; idle
        ones the peer closed meanwhile are dropped on the way."""
        while True:
            with self._lock:
                conn = self._idle.pop() if self._idle else None
            if conn is None:
                conn = _Connection(self._host, self._port, timeout=timeout)
                break
            if conn.sock is not None and not _dropped(conn.sock):
                conn.timeout = timeout
                conn.sock.settimeout(timeout)
                break
            conn.close()
        return conn

    def _checkin(self, conn: http.client.HTTPConnection) -> None:
        """Give back a connection whose response was read whole: it stays
        idle unless the pool is full or the client closed."""
        with self._lock:
            if not self._closed and len(self._idle) < POOL_IDLE_MAX:
                self._idle.append(conn)
                return
        conn.close()

    def _post(self, path: str, body, headers: dict, timeout: float,
              stream: bool):
        """(status, headers, body bytes or a _Stream)."""
        if stream:
            conn = _Connection(self._host, self._port, timeout=timeout)
            try:
                conn.request("POST", path, body=body, headers=headers)
                r = conn.getresponse()
                if r.status == 200:
                    return r.status, r.headers, _Stream(conn, r)
                data = r.read()
            except BaseException:
                conn.close()
                raise
            conn.close()
            return r.status, r.headers, data
        conn = self._checkout(timeout)
        try:
            conn.request("POST", path, body=body, headers=headers)
            r = conn.getresponse()
            data = r.read()
        except BaseException:
            conn.close()  # a half-used connection never carries another
            raise
        if r.will_close:
            conn.close()
        else:
            self._checkin(conn)
        return r.status, r.headers, data

    def call(self, method: str, params: dict | None = None,
             body: bytes | None = None, stream: bool = False,
             timeout: float | None = None, idempotent: bool = False):
        """POST the method; returns response bytes (or the stream, with
        ``iter_lines`` and ``close``, when stream=True). Typed storage
        errors re-raise as their class. A request-scoped span context
        propagates over the ``x-minio-tpu-traceparent`` header so
        peer-side spans share the caller's trace_id (and a client span
        records the RPC leg in the caller's own tree).

        ``idempotent=True`` (read-only methods) grants a small retry
        budget with jittered exponential backoff on transport-level
        failures — the peer is only marked offline once the budget is
        exhausted, so one dropped packet doesn't fence a healthy disk."""
        from ..obs import metrics as mx
        from ..obs import spans as sp
        if not self._online:
            raise errors.DiskNotFound(f"{self.base} offline")
        qs = urllib.parse.urlencode(
            {k: str(v) for k, v in (params or {}).items()})
        path = (f"/minio/{self.service}/{RPC_VERSION}/{method}"
                + (f"?{qs}" if qs else ""))
        if body is not None and not isinstance(body, (bytes, bytearray)):
            body = memoryview(body).cast("B")
        mx.inc("minio_tpu_inter_node_calls_total", service=self.service)
        if body:
            mx.inc("minio_tpu_inter_node_sent_bytes_total", len(body),
                   service=self.service)
        attempts = 1 + (RETRY_BUDGET if idempotent else 0)
        # the status/typed-error handling stays INSIDE the client span:
        # a peer's 500 + x-minio-tpu-error raises from here, and the
        # span must record that failure
        with sp.span(f"rpc.{self.service}.{method}",
                     peer=self.base) as span_ctx:
            headers = {"Authorization": f"Bearer "
                       f"{make_token(self.secret)}"}
            if span_ctx is not None:
                headers[sp.RPC_HEADER] = sp.to_traceparent(span_ctx)
            for attempt in range(attempts):
                if attempt:
                    # jittered exponential backoff between retries
                    time.sleep(RETRY_BACKOFF_S * (1 << (attempt - 1))
                               * (0.5 + random.random()))
                t_call = time.monotonic()
                try:
                    if _fault.armed("node"):
                        # whole-peer injection point (node chaos):
                        # partition blackholes the call before the
                        # wire, delay slows EVERY service/method
                        # toward this peer
                        _fault.inject("node", self.base, self.src)
                    if _fault.armed("rpc"):
                        # per-call injection point (chaos harness);
                        # typed errors raise like a peer-sent error,
                        # transport-class errors retry like one
                        _fault.inject("rpc", self.base, method)
                    status, rh, data = self._post(
                        path, body, headers, timeout or self.timeout,
                        stream)
                except (*_TRANSPORT, errors.RPCError) as e:
                    mx.inc("minio_tpu_inter_node_errors_total",
                           service=self.service)
                    mx.inc("minio_tpu_node_peer_errors_total",
                           service=self.service)
                    self._note_result(False)
                    if attempt + 1 < attempts:
                        continue
                    self._note_method(method, None)
                    self._mark_offline()
                    raise errors.DiskNotFound(f"{self.base}: {e}") from e
                dur = time.monotonic() - t_call
                if status == 200:
                    self._note_result(True, dur)
                    self._note_method(method, dur)
                    if not stream:
                        mx.inc("minio_tpu_inter_node_received_bytes_total",
                               len(data), service=self.service)
                    return data
                err_name = rh.get("x-minio-tpu-error", "")
                msg = data.decode("utf-8", "replace")[:200]
                if err_name in _ERR_BY_NAME:
                    # typed error = the peer answered: the WIRE is fine
                    self._note_result(True, dur)
                    self._note_method(method, dur)
                    raise _ERR_BY_NAME[err_name](msg)
                if status in (502, 503, 504):
                    self._note_result(False)
                    if attempt + 1 < attempts:
                        continue
                    self._note_method(method, None)
                    self._mark_offline()
                    raise errors.DiskNotFound(f"{self.base}: {status}")
                self._note_method(method, None)
                raise RPCError(f"{method}: HTTP {status} {msg}")

    def close(self):
        self._online = False
        with self._lock:
            self._closed = True
            conns, self._idle = self._idle, []
        for c in conns:
            c.close()


def rpc_error_response(handler, e: BaseException):
    """Send a typed error over the wire (server side)."""
    name = type(e).__name__ if type(e).__name__ in _ERR_BY_NAME \
        else "RPCError"
    body = str(e).encode()
    handler.send_response(500)
    handler.send_header("x-minio-tpu-error", name)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)
