"""Minimal wire-protocol publishers for event delivery targets, the port
of minio_tpu/event/wire.py.

The reference links vendor client SDKs (sarama, paho, amqp091-go, redis,
nats.go, nsq — pkg/event/target/*.go); this build has no
external dependencies, so each target speaks just enough of its wire
protocol to authenticate and publish, in plain sockets. Every client here
is publish-only, raises on any failure (the queue store retries with
backoff), and reconnects lazily on the next send.

Protocols implemented: Redis RESP, MQTT 3.1.1 (QoS 0/1), Kafka produce
(api v3, record-batch v2 with crc32c), AMQP 0-9-1 (PLAIN auth), NATS,
NSQ (V2), PostgreSQL and MySQL (simple queries). The Kafka record batch's
CRC-32C comes from the port's host library (``native.crc32c``, the
slicing-by-8 loop of ``native/s2.cpp``), not a table walk in Python.
"""
from __future__ import annotations

import json
import socket
import struct
import threading


class WireError(RuntimeError):
    pass


class _SocketClient:
    """Shared lazy-connect/reconnect-on-error plumbing."""

    def __init__(self, host: str, port: int, timeout_s: float = 5.0):
        self.host = host
        self.port = port
        self.timeout = timeout_s
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        s = socket.create_connection((self.host, self.port), self.timeout)
        s.settimeout(self.timeout)
        return s

    def _handshake(self, s: socket.socket) -> None:  # override
        pass

    def _ensure(self) -> socket.socket:
        if self._sock is None:
            s = self._connect()
            try:
                self._handshake(s)
            except BaseException:
                s.close()
                raise
            self._sock = s
        return self._sock

    def _reset(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._reset()

    def _recv_exact(self, s: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise WireError("connection closed")
            buf += chunk
        return buf

    def _retry_once(self, op, *args):
        """Run ``op(sock, *args)`` under the client lock; one transparent
        reconnect on socket/protocol failure (shared by every publish
        path so fixes land in one place)."""
        with self._lock:
            # deliberate blocking-under-lock: the lock IS the wire — it
            # serializes request/response frames on the one socket, so
            # connect/send/recv must happen inside it by design
            try:
                return op(self._ensure(), *args)
            except (OSError, WireError):
                self._reset()
                return op(self._ensure(), *args)


# --- Redis (RESP2) ---------------------------------------------------------


class RESPClient(_SocketClient):
    """Publish-side RESP: AUTH/SELECT on connect, then commands."""

    def __init__(self, host: str, port: int = 6379, password: str = "",
                 user: str = "", timeout_s: float = 5.0):
        super().__init__(host, port, timeout_s)
        self.password = password
        self.user = user

    def _handshake(self, s: socket.socket) -> None:
        if self.password:
            args = ["AUTH"] + ([self.user] if self.user else []) \
                + [self.password]
            self._cmd_on(s, *args)
        self._cmd_on(s, "PING")

    def _encode(self, *args: str | bytes) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        return b"".join(out)

    def _read_line(self, s: socket.socket) -> bytes:
        line = b""
        while not line.endswith(b"\r\n"):
            c = s.recv(1)
            if not c:
                raise WireError("redis closed")
            line += c
        return line[:-2]

    def _read_reply(self, s: socket.socket):
        line = self._read_line(s)
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise WireError(f"redis error: {rest.decode()}")
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = self._recv_exact(s, n + 2)
            return data[:-2]
        if t == b"*":
            return [self._read_reply(s) for _ in range(int(rest))]
        raise WireError(f"redis bad reply type {t!r}")

    def _cmd_on(self, s: socket.socket, *args):
        s.sendall(self._encode(*args))
        return self._read_reply(s)

    def command(self, *args):
        return self._retry_once(self._cmd_on, *args)


# --- MQTT 3.1.1 ------------------------------------------------------------


def _mqtt_remlen(n: int) -> bytes:
    out = bytearray()
    while True:
        d = n % 128
        n //= 128
        out.append(d | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _mqtt_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


class MQTTClient(_SocketClient):
    def __init__(self, host: str, port: int = 1883, client_id: str = "",
                 user: str = "", password: str = "", qos: int = 1,
                 timeout_s: float = 5.0):
        super().__init__(host, port, timeout_s)
        self.client_id = client_id or "minio-tpu"
        self.user = user
        self.password = password
        self.qos = max(0, min(1, qos))
        self._pkt_id = 0

    def _handshake(self, s: socket.socket) -> None:
        flags = 0x02  # clean session
        payload = _mqtt_str(self.client_id)
        if self.user:
            flags |= 0x80
            payload += _mqtt_str(self.user)
            if self.password:
                flags |= 0x40
                payload += _mqtt_str(self.password)
        var = _mqtt_str("MQTT") + bytes([4, flags]) + struct.pack(">H", 60)
        pkt = bytes([0x10]) + _mqtt_remlen(len(var) + len(payload)) \
            + var + payload
        s.sendall(pkt)
        hdr = self._recv_exact(s, 4)  # CONNACK is always 4 bytes
        if hdr[0] != 0x20 or hdr[3] != 0:
            raise WireError(f"mqtt connack refused: {hdr!r}")

    def publish(self, topic: str, payload: bytes) -> None:
        self._retry_once(self._publish_on, topic, payload)

    def _publish_on(self, s: socket.socket, topic: str,
                    payload: bytes) -> None:
        var = _mqtt_str(topic)
        fixed = 0x30 | (self.qos << 1)
        if self.qos:
            self._pkt_id = self._pkt_id % 0xFFFF + 1
            var += struct.pack(">H", self._pkt_id)
        s.sendall(bytes([fixed]) + _mqtt_remlen(len(var) + len(payload))
                  + var + payload)
        if self.qos:
            ack = self._recv_exact(s, 4)
            if ack[0] != 0x40 or \
                    struct.unpack(">H", ack[2:4])[0] != self._pkt_id:
                raise WireError(f"mqtt puback mismatch: {ack!r}")


# --- Kafka (produce v3 / record batch v2) ----------------------------------

def _crc32c(data: bytes) -> int:
    """CRC-32/Castagnoli of a record batch's tail (from the attributes
    on), as the broker checks it."""
    from ..native import crc32c
    return crc32c(data)


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _varint(n: int) -> bytes:
    u = _zigzag(n) & 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        out.append(b | (0x80 if u else 0))
        if not u:
            return bytes(out)


def _kstr(s: str | None) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _kbytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class KafkaProducer(_SocketClient):
    """acks=1 producer to one broker, partition 0 (single-broker topic —
    the configured broker must lead the partition; a NotLeader error
    surfaces as a retryable failure)."""

    API_PRODUCE, PRODUCE_V = 0, 3

    def __init__(self, host: str, port: int = 9092, topic: str = "minio",
                 client_id: str = "minio-tpu", timeout_s: float = 5.0):
        super().__init__(host, port, timeout_s)
        self.topic = topic
        self.client_id = client_id
        self._corr = 0

    def _record_batch(self, key: bytes, value: bytes, ts_ms: int) -> bytes:
        rec_body = (b"\x00" + _varint(0) + _varint(0)
                    + _varint(len(key)) + key
                    + _varint(len(value)) + value + _varint(0))
        record = _varint(len(rec_body)) + rec_body
        after_crc = (struct.pack(">hiqqqhii", 0, 0, ts_ms, ts_ms, -1, -1,
                                 -1, 1) + record)
        crc = _crc32c(after_crc)
        body = struct.pack(">iB", -1, 2) + struct.pack(">I", crc) \
            + after_crc
        return struct.pack(">qi", 0, len(body)) + body

    def produce(self, key: bytes, value: bytes, ts_ms: int) -> None:
        self._retry_once(self._produce_on, key, value, ts_ms)

    def _produce_on(self, s: socket.socket, key: bytes, value: bytes,
                    ts_ms: int) -> None:
        self._corr += 1
        batch = self._record_batch(key, value, ts_ms)
        body = (_kstr(None)                      # transactional_id
                + struct.pack(">hi", 1, 10000)   # acks=1, timeout
                + struct.pack(">i", 1) + _kstr(self.topic)
                + struct.pack(">i", 1) + struct.pack(">i", 0)
                + _kbytes(batch))
        hdr = struct.pack(">hhi", self.API_PRODUCE, self.PRODUCE_V,
                          self._corr) + _kstr(self.client_id)
        msg = hdr + body
        s.sendall(struct.pack(">i", len(msg)) + msg)
        (size,) = struct.unpack(">i", self._recv_exact(s, 4))
        resp = self._recv_exact(s, size)
        (corr,) = struct.unpack(">i", resp[:4])
        if corr != self._corr:
            raise WireError("kafka correlation mismatch")
        # [topics] -> topic -> [partitions] -> partition err at fixed
        # offsets for our single-topic single-partition request
        off = 4
        (ntop,) = struct.unpack(">i", resp[off:off + 4])
        off += 4
        (tlen,) = struct.unpack(">h", resp[off:off + 2])
        off += 2 + tlen
        (nparts,) = struct.unpack(">i", resp[off:off + 4])
        off += 4
        _pidx, err = struct.unpack(">ih", resp[off:off + 6])
        if ntop != 1 or nparts != 1 or err != 0:
            raise WireError(f"kafka produce error code {err}")


# --- AMQP 0-9-1 ------------------------------------------------------------


def _amqp_shortstr(s: str) -> bytes:
    b = s.encode()
    return bytes([len(b)]) + b


def _amqp_longstr(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


class AMQPPublisher(_SocketClient):
    def __init__(self, host: str, port: int = 5672, user: str = "guest",
                 password: str = "guest", vhost: str = "/",
                 exchange: str = "", routing_key: str = "",
                 timeout_s: float = 5.0):
        super().__init__(host, port, timeout_s)
        self.user = user
        self.password = password
        self.vhost = vhost
        self.exchange = exchange
        self.routing_key = routing_key

    def _read_frame(self, s: socket.socket) -> tuple[int, int, bytes]:
        hdr = self._recv_exact(s, 7)
        ftype, chan, size = struct.unpack(">BHI", hdr)
        payload = self._recv_exact(s, size)
        if self._recv_exact(s, 1) != b"\xce":
            raise WireError("amqp bad frame end")
        return ftype, chan, payload

    def _read_method(self, s: socket.socket, want_class: int,
                     want_method: int) -> bytes:
        while True:
            ftype, _chan, payload = self._read_frame(s)
            if ftype == 8:  # heartbeat
                continue
            if ftype != 1:
                raise WireError(f"amqp unexpected frame type {ftype}")
            cls, meth = struct.unpack(">HH", payload[:4])
            if (cls, meth) != (want_class, want_method):
                raise WireError(
                    f"amqp got {cls}.{meth}, want "
                    f"{want_class}.{want_method}")
            return payload[4:]

    def _send_method(self, s: socket.socket, chan: int, cls: int,
                     meth: int, args: bytes) -> None:
        payload = struct.pack(">HH", cls, meth) + args
        s.sendall(struct.pack(">BHI", 1, chan, len(payload)) + payload
                  + b"\xce")

    def _handshake(self, s: socket.socket) -> None:
        s.sendall(b"AMQP\x00\x00\x09\x01")
        self._read_method(s, 10, 10)  # Connection.Start
        sasl = b"\x00" + self.user.encode() + b"\x00" \
            + self.password.encode()
        args = (struct.pack(">I", 0)              # client-properties: {}
                + _amqp_shortstr("PLAIN") + _amqp_longstr(sasl)
                + _amqp_shortstr("en_US"))
        self._send_method(s, 0, 10, 11, args)     # Connection.StartOk
        tune = self._read_method(s, 10, 30)       # Connection.Tune
        chan_max, frame_max, heartbeat = struct.unpack(">HIH", tune[:8])
        self._send_method(s, 0, 10, 31, struct.pack(
            ">HIH", chan_max or 1, frame_max or 131072, 0))
        self._send_method(s, 0, 10, 40,           # Connection.Open
                          _amqp_shortstr(self.vhost) + b"\x00\x00")
        self._read_method(s, 10, 41)
        self._send_method(s, 1, 20, 10, _amqp_shortstr(""))  # Channel.Open
        self._read_method(s, 20, 11)

    def publish(self, body: bytes) -> None:
        self._retry_once(self._publish_on, body)

    def _publish_on(self, s: socket.socket, body: bytes) -> None:
        self._send_method(s, 1, 60, 40,
                          b"\x00\x00" + _amqp_shortstr(self.exchange)
                          + _amqp_shortstr(self.routing_key) + b"\x00")
        # content header: class 60, weight 0, size, flags: content-type
        # (1<<15) + delivery-mode (1<<12), persistent
        props = struct.pack(">HHQH", 60, 0, len(body), 0x9000) \
            + _amqp_shortstr("application/json") + bytes([2])
        s.sendall(struct.pack(">BHI", 2, 1, len(props)) + props + b"\xce")
        s.sendall(struct.pack(">BHI", 3, 1, len(body)) + body + b"\xce")
        # publish is async in AMQP; a broker-side error arrives as a
        # Channel.Close on the next read — probe opportunistically
        s.setblocking(False)
        try:
            # drain any already-arrived async frames: only Channel.Close
            # (20.40) / Connection.Close (10.50) mean the publish failed;
            # heartbeats and e.g. Basic.Return are legitimate and must not
            # trigger the reconnect+republish path (duplicate delivery)
            while s.recv(1, socket.MSG_PEEK):
                s.settimeout(self.timeout)
                try:
                    ftype, _chan, payload = self._read_frame(s)
                except socket.timeout:
                    # a PARTIAL frame was consumed: the connection is
                    # desynced — drop it so the next publish reconnects
                    # cleanly (the publish itself already succeeded, so
                    # no republish here)
                    self._reset()
                    return
                finally:
                    if self._sock is not None:
                        s.setblocking(False)
                if ftype != 1 or len(payload) < 4:
                    continue  # heartbeat / content frame — ignore
                cls, meth = struct.unpack(">HH", payload[:4])
                if (cls, meth) in ((20, 40), (10, 50)):
                    raise WireError(
                        f"amqp broker closed after publish: {cls}.{meth}")
        except (BlockingIOError, InterruptedError):
            pass
        finally:
            if self._sock is not None:
                s.settimeout(self.timeout)


# --- NATS ------------------------------------------------------------------


class NATSClient(_SocketClient):
    def __init__(self, host: str, port: int = 4222, subject: str = "minio",
                 user: str = "", password: str = "", token: str = "",
                 timeout_s: float = 5.0):
        super().__init__(host, port, timeout_s)
        self.subject = subject
        self.user = user
        self.password = password
        self.token = token

    def _read_line(self, s: socket.socket) -> bytes:
        line = b""
        while not line.endswith(b"\r\n"):
            c = s.recv(1)
            if not c:
                raise WireError("nats closed")
            line += c
        return line[:-2]

    def _handshake(self, s: socket.socket) -> None:
        info = self._read_line(s)
        if not info.startswith(b"INFO "):
            raise WireError(f"nats bad greeting {info[:40]!r}")
        opts = {"verbose": True, "pedantic": False,
                "name": "minio-tpu", "lang": "py", "version": "1"}
        if self.token:
            opts["auth_token"] = self.token
        if self.user:
            opts["user"] = self.user
            opts["pass"] = self.password
        s.sendall(b"CONNECT " + json.dumps(opts).encode() + b"\r\n")
        self._read_ok(s)

    def publish(self, payload: bytes) -> None:
        self._retry_once(self._publish_on, payload)

    def _read_ok(self, s: socket.socket) -> None:
        """Next control line, answering server PINGs in between (an idle
        server pings every couple of minutes; treating a buffered PING as
        a failed +OK would double-deliver via the reconnect retry)."""
        while True:
            line = self._read_line(s)
            if line == b"PING":
                s.sendall(b"PONG\r\n")
                continue
            if line != b"+OK":
                raise WireError(f"nats: {line!r}")
            return

    def _publish_on(self, s: socket.socket, payload: bytes) -> None:
        s.sendall(b"PUB %s %d\r\n%s\r\n"
                  % (self.subject.encode(), len(payload), payload))
        self._read_ok(s)


# --- NSQ (V2) --------------------------------------------------------------


class NSQClient(_SocketClient):
    def __init__(self, host: str, port: int = 4150, topic: str = "minio",
                 timeout_s: float = 5.0):
        super().__init__(host, port, timeout_s)
        self.topic = topic

    def _handshake(self, s: socket.socket) -> None:
        s.sendall(b"  V2")

    def publish(self, payload: bytes) -> None:
        self._retry_once(self._publish_on, payload)

    def _publish_on(self, s: socket.socket, payload: bytes) -> None:
        s.sendall(b"PUB " + self.topic.encode() + b"\n"
                  + struct.pack(">I", len(payload)) + payload)
        size, ftype = struct.unpack(">iI", self._recv_exact(s, 8))
        data = self._recv_exact(s, size - 4)
        if ftype == 1 and data == b"_heartbeat_":
            s.sendall(b"NOP\n")
            size, ftype = struct.unpack(">iI", self._recv_exact(s, 8))
            data = self._recv_exact(s, size - 4)
        if ftype != 0 or data != b"OK":
            raise WireError(f"nsq pub response {ftype} {data!r}")


__all__ = ["WireError", "RESPClient", "MQTTClient", "KafkaProducer",
           "AMQPPublisher", "NATSClient", "NSQClient"]


# --- PostgreSQL (frontend/backend protocol v3) -----------------------------


class PGServerError(RuntimeError):
    """Server-reported SQL error on a healthy connection — retrying or
    reconnecting cannot fix it, so it must NOT trip the transport-level
    retry path."""


class PostgresClient(_SocketClient):
    """Simple-query PostgreSQL client (startup; trust, cleartext, md5
    and SCRAM-SHA-256 auth; 'Q' simple queries) — enough for the event
    target's INSERT/UPDATE/DELETE statements, with no driver dependency
    (reference pkg/event/target/postgresql.go uses lib/pq)."""

    def __init__(self, host: str, port: int, user: str, database: str,
                 password: str = "", timeout_s: float = 5.0):
        super().__init__(host, port, timeout_s)
        self.user = user
        self.database = database
        self.password = password

    def _handshake(self, s: socket.socket) -> None:
        # standard_conforming_strings is pinned ON so pg_quote's
        # ''-doubling is injection-safe regardless of server defaults
        # (with it off, a backslash could escape the closing quote)
        params = (f"user\0{self.user}\0database\0{self.database}\0"
                  "options\0-c standard_conforming_strings=on\0\0"
                  ).encode()
        body = struct.pack(">i", 196608) + params  # protocol 3.0
        s.sendall(struct.pack(">i", len(body) + 4) + body)
        while True:
            mtype, payload = self._read_msg(s)
            if mtype == b"R":
                code = struct.unpack(">i", payload[:4])[0]
                if code == 0:
                    continue  # AuthenticationOk
                if code == 3:  # cleartext password
                    self._send_msg(s, b"p", self.password.encode() + b"\0")
                    continue
                if code == 5:  # md5: md5(md5(password+user)+salt)
                    import hashlib
                    salt = payload[4:8]
                    inner = hashlib.md5(
                        (self.password + self.user).encode()).hexdigest()
                    outer = hashlib.md5(
                        inner.encode() + salt).hexdigest()
                    self._send_msg(s, b"p",
                                   b"md5" + outer.encode() + b"\0")
                    continue
                if code == 10:  # SASL (modern default: SCRAM-SHA-256)
                    mechs = payload[4:].split(b"\0")
                    if b"SCRAM-SHA-256" not in mechs:
                        raise WireError(
                            f"postgres SASL mechanisms {mechs} "
                            "not supported")
                    self._scram(s)
                    continue
                raise WireError(f"postgres auth method {code} "
                                "not supported")
            if mtype == b"E":
                raise WireError(f"postgres: {_pg_error(payload)}")
            if mtype == b"Z":  # ReadyForQuery
                return
            # 'S' ParameterStatus / 'K' BackendKeyData / 'N' notices

    def _scram(self, s: socket.socket) -> None:
        """SCRAM-SHA-256 (RFC 5802/7677) — PostgreSQL 14+'s default
        password_encryption."""
        import base64
        import hashlib
        import hmac as _hmac
        import secrets
        nonce = base64.b64encode(secrets.token_bytes(18)).decode()
        client_first_bare = f"n={self.user},r={nonce}"
        initial = b"n,," + client_first_bare.encode()
        self._send_msg(s, b"p", b"SCRAM-SHA-256\0" +
                       struct.pack(">i", len(initial)) + initial)
        mtype, payload = self._read_msg(s)
        if mtype == b"E":
            raise WireError(f"postgres: {_pg_error(payload)}")
        if mtype != b"R" or struct.unpack(">i", payload[:4])[0] != 11:
            raise WireError("postgres: unexpected SASL continue")
        server_first = payload[4:].decode()
        attrs = dict(p.split("=", 1) for p in server_first.split(","))
        r, salt_b64, iters = attrs["r"], attrs["s"], int(attrs["i"])
        if not r.startswith(nonce):
            raise WireError("postgres: SCRAM nonce mismatch")
        salted = hashlib.pbkdf2_hmac("sha256", self.password.encode(),
                                     base64.b64decode(salt_b64), iters)
        client_key = _hmac.new(salted, b"Client Key",
                               hashlib.sha256).digest()
        stored_key = hashlib.sha256(client_key).digest()
        without_proof = f"c=biws,r={r}"
        auth_msg = ",".join([client_first_bare, server_first,
                             without_proof]).encode()
        sig = _hmac.new(stored_key, auth_msg, hashlib.sha256).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, sig))
        final = (without_proof + ",p=" +
                 base64.b64encode(proof).decode()).encode()
        self._send_msg(s, b"p", final)
        mtype, payload = self._read_msg(s)
        if mtype == b"E":
            raise WireError(f"postgres: {_pg_error(payload)}")
        if mtype != b"R" or struct.unpack(">i", payload[:4])[0] != 12:
            raise WireError("postgres: unexpected SASL final")
        server_final = payload[4:].decode()
        server_key = _hmac.new(salted, b"Server Key",
                               hashlib.sha256).digest()
        want = base64.b64encode(_hmac.new(
            server_key, auth_msg, hashlib.sha256).digest()).decode()
        if dict(p.split("=", 1) for p in
                server_final.split(",")).get("v") != want:
            raise WireError("postgres: server signature mismatch")

    def _send_msg(self, s: socket.socket, mtype: bytes, payload: bytes):
        s.sendall(mtype + struct.pack(">i", len(payload) + 4) + payload)

    def _read_msg(self, s: socket.socket) -> tuple[bytes, bytes]:
        head = self._recv_exact(s, 5)
        ln = struct.unpack(">i", head[1:])[0]
        return head[:1], self._recv_exact(s, ln - 4)

    def execute(self, sql: str) -> None:
        """Run one simple query. Transport failures reconnect-and-retry
        once; a server-reported SQL error arrives on a HEALTHY
        connection (ReadyForQuery follows it) and raises PGServerError
        without the pointless reconnect/re-execute."""
        def op(s):
            self._send_msg(s, b"Q", sql.encode() + b"\0")
            err = None
            while True:
                mtype, payload = self._read_msg(s)
                if mtype == b"E":
                    err = _pg_error(payload)
                elif mtype == b"Z":
                    if err:
                        raise PGServerError(f"postgres: {err}")
                    return
                # 'C' CommandComplete, 'T'/'D' row data, 'N' notices
        self._retry_once(lambda s: op(s))


def _pg_error(payload: bytes) -> str:
    fields = {}
    for part in payload.split(b"\0"):
        if len(part) >= 2:
            fields[chr(part[0])] = part[1:].decode("utf-8", "replace")
    return fields.get("M", "unknown error")


def pg_quote(s: str) -> str:
    """Standard-conforming string literal ('' doubling)."""
    return "'" + s.replace("'", "''") + "'"


# --- MySQL (client/server protocol) ----------------------------------------


class MySQLServerError(RuntimeError):
    """Server-reported SQL error on a healthy connection (ERR packet
    after the command) — not a transport failure, never retried."""


class MySQLClient(_SocketClient):
    """Minimal MySQL client: handshake v10 with mysql_native_password
    auth, COM_QUERY text protocol — what the event target needs
    (reference pkg/event/target/mysql.go uses go-sql-driver). The
    caching_sha2_password full-auth path needs TLS or RSA key exchange;
    servers wanting this target over plain TCP enable
    mysql_native_password for the event user."""

    #: LONG_PASSWORD(0x1) | CONNECT_WITH_DB(0x8) | PROTOCOL_41(0x200) |
    #: TRANSACTIONS(0x2000) | SECURE_CONNECTION(0x8000) |
    #: PLUGIN_AUTH(0x80000) — the response appends database and
    #: auth-plugin fields, so those capabilities MUST be announced or a
    #: strict server misparses the packet
    CLIENT_FLAGS = 0x0008_A209

    def __init__(self, host: str, port: int, user: str, database: str,
                 password: str = "", timeout_s: float = 5.0):
        super().__init__(host, port, timeout_s)
        self.user = user
        self.database = database
        self.password = password

    # -- packet framing: 3-byte little-endian length + sequence id ----------

    def _read_packet(self, s: socket.socket) -> tuple[int, bytes]:
        head = self._recv_exact(s, 4)
        ln = head[0] | (head[1] << 8) | (head[2] << 16)
        return head[3], self._recv_exact(s, ln)

    def _send_packet(self, s: socket.socket, seq: int, payload: bytes):
        ln = len(payload)
        s.sendall(bytes((ln & 0xFF, (ln >> 8) & 0xFF, (ln >> 16) & 0xFF,
                         seq)) + payload)

    def _handshake(self, s: socket.socket) -> None:
        import hashlib
        seq, pkt = self._read_packet(s)
        if pkt[:1] == b"\xff":
            raise WireError(f"mysql: {pkt[3:].decode('utf-8', 'replace')}")
        if pkt[0] != 10:
            raise WireError(f"mysql protocol version {pkt[0]}")
        i = pkt.index(b"\0", 1) + 1    # skip server version
        i += 4                          # thread id
        auth1 = pkt[i:i + 8]
        i += 8 + 1                      # filler
        i += 2 + 1 + 2 + 2              # caps low, charset, status, caps hi
        auth_len = pkt[i]
        i += 1 + 10                     # reserved
        auth2 = pkt[i:i + max(13, auth_len - 8)]
        salt = (auth1 + auth2).rstrip(b"\0")[:20]
        plugin = pkt[i + max(13, auth_len - 8):].split(b"\0")[0]
        if plugin and plugin != b"mysql_native_password":
            raise WireError(
                f"mysql auth plugin {plugin.decode()} not supported; "
                "enable mysql_native_password for this user")
        if self.password:
            sha_pwd = hashlib.sha1(self.password.encode()).digest()
            rehash = hashlib.sha1(salt + hashlib.sha1(
                sha_pwd).digest()).digest()
            token = bytes(a ^ b for a, b in zip(sha_pwd, rehash))
        else:
            token = b""
        resp = struct.pack("<IIB23x", self.CLIENT_FLAGS, 1 << 24, 45)
        resp += self.user.encode() + b"\0"
        resp += bytes([len(token)]) + token
        resp += self.database.encode() + b"\0"
        resp += b"mysql_native_password\0"
        self._send_packet(s, seq + 1, resp)
        _, pkt = self._read_packet(s)
        if pkt[:1] == b"\xff":
            raise WireError(
                f"mysql auth: {pkt[3:].decode('utf-8', 'replace')}")
        if pkt[:1] == b"\xfe":
            raise WireError("mysql: server requested auth method switch; "
                            "enable mysql_native_password")
        # pin escaping semantics for this session: mysql_quote doubles
        # backslashes, which is only correct while NO_BACKSLASH_ESCAPES
        # is off (the Postgres client pins its equivalent GUC the same
        # way)
        self._send_packet(s, 0, b"\x03SET SESSION sql_mode=(SELECT "
                          b"REPLACE(@@SESSION.sql_mode,"
                          b"'NO_BACKSLASH_ESCAPES',''))")
        _, pkt = self._read_packet(s)
        if pkt[:1] == b"\xff":
            raise WireError(
                f"mysql sql_mode: {pkt[3:].decode('utf-8', 'replace')}")

    def execute(self, sql: str) -> None:
        def op(s):
            self._send_packet(s, 0, b"\x03" + sql.encode())
            _, pkt = self._read_packet(s)
            if pkt[:1] == b"\xff":
                code = struct.unpack("<H", pkt[1:3])[0]
                raise MySQLServerError(
                    f"mysql error {code}: "
                    f"{pkt[3:].decode('utf-8', 'replace')}")
            # OK packet (or result set header for SELECTs, unused here)
        self._retry_once(lambda s: op(s))


def mysql_quote(s: str) -> str:
    """String literal with backslash AND quote escaping — correct under
    the backslash-escapes semantics the client pins at handshake (the
    session's NO_BACKSLASH_ESCAPES mode is stripped)."""
    return "'" + s.replace("\\", "\\\\").replace("'", "''") + "'"
