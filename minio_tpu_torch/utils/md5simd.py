"""The shared multi-lane MD5 hash server (the reference's md5-simd), the
port of minio_tpu/utils/md5simd.py.

The S3 ETag contract makes every PUT that cannot take the pipeline ETag
(a compressed body, a Content-MD5 to check) pay an MD5 pass over its
plaintext. MD5 cannot be parallelised within a stream, but independent
streams can share AVX2 lanes.

One worker thread owns every stream's MD5 state. Streams enqueue ordered
buffers; each scheduling round the worker takes everything queued for up
to 8 streams and advances them together in one ``md5_multi_segments`` call
of the port's ``libnative.so`` (which releases the interpreter lock). One
active stream takes the scalar path inside the native call; two or more
share AVX2 lanes. A stream's buffers are hashed in order, and a stream is
in at most one round at a time.

The library is built at the first use; a failed build raises
``utils.errors.BuildError`` (the port has no hashlib fallback here).
"""
from __future__ import annotations

import ctypes
import threading
from collections import deque

import numpy as np

_LANES = 8


class MD5Stream:
    """One sequential MD5 chain, fed through the shared server.

    update() enqueues and returns (the buffer is kept until hashed);
    digest()/hexdigest() block until the chain drains. One producer per
    stream, like hashlib."""

    #: queued bytes per stream above which update() blocks, so a fast
    #: producer cannot park its whole body in the hash queue
    MAX_QUEUED = 8 << 20

    def __init__(self, server: "MD5Server"):
        self._srv = server
        self._state = np.empty(4, dtype=np.uint32)
        server._lib.md5_init_state(
            self._state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        self._tail = b""
        self._total = 0
        self._queue: deque = deque()
        self._qbytes = 0
        self._done = threading.Event()
        self._done.set()  # nothing pending
        self._digest: bytes | None = None
        self._error: BaseException | None = None

    def update(self, b) -> None:
        if self._digest is not None:
            raise ValueError("update after digest")
        if not b:
            return
        self._total += len(b)
        self._srv._enqueue(self, b)

    def digest(self) -> bytes:
        if self._digest is None:
            self._done.wait()
            if self._error is not None:
                raise self._error
            out = np.empty(16, dtype=np.uint8)
            self._srv._lib.md5_finish(
                self._state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                self._tail, len(self._tail), self._total,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            self._digest = out.tobytes()
        return self._digest

    def hexdigest(self) -> str:
        return self.digest().hex()


class MD5Server:
    def __init__(self, lib):
        self._lib = lib
        self._cv = threading.Condition()
        self._pending: deque = deque()  # streams with queued buffers
        self._member: set[int] = set()  # ids in _pending
        self._stop = False
        #: rounds by lane count (lane_rounds[n - 1]: rounds of n streams)
        self.lane_rounds = [0] * _LANES
        self.bytes_hashed = 0
        self._thread = threading.Thread(
            target=self._loop, name="minio-tpu-torch-md5", daemon=True)
        self._thread.start()

    def stream(self) -> MD5Stream:
        return MD5Stream(self)

    def _enqueue(self, s: MD5Stream, b) -> None:
        with self._cv:
            while s._qbytes >= MD5Stream.MAX_QUEUED:
                self._cv.wait()
            s._queue.append(b)
            s._qbytes += len(b)
            s._done.clear()  # under the lock: pairs with the worker's set
            if id(s) not in self._member:
                self._member.add(id(s))
                self._pending.append(s)
            self._cv.notify()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if self._stop and not self._pending:
                    return
                # everything queued for up to 8 streams: one native call
                # per round keeps the worker's lock round-trips rare
                batch: list = []
                while self._pending and len(batch) < _LANES:
                    s = self._pending.popleft()
                    batch.append((s, list(s._queue)))
                    s._queue.clear()
                    s._qbytes = 0
                    self._member.discard(id(s))
                self._cv.notify_all()  # wake producers in backpressure
            try:
                self._run_batch(batch)
            except BaseException as e:  # noqa: BLE001 — isolate the round
                # only the round's streams fail: the shared worker must
                # survive (a dead one would hang every later PUT)
                with self._cv:
                    for s, _ in batch:
                        s._error = e
                        s._queue.clear()
                        s._qbytes = 0
                        self._member.discard(id(s))
                        s._done.set()
                    self._cv.notify_all()

    def _run_batch(self, batch: list) -> None:
        u32p = ctypes.POINTER(ctypes.c_uint32)
        states = np.concatenate([s._state for s, _ in batch])
        seg_ptrs: list = []
        seg_blocks: list = []
        seg_off = [0]
        anchors: list = []  # keeps the buffers alive through the call
        for s, bufs in batch:
            # whole 64-byte blocks of each buffer, remainders carried into
            # the next buffer (copies only at unaligned boundaries)
            carry = s._tail
            s._tail = b""
            for buf in bufs:
                if carry:
                    buf = carry + bytes(buf)
                    carry = b""
                nb = len(buf) // 64
                if nb:
                    arr = np.frombuffer(buf, dtype=np.uint8, count=nb * 64)
                    anchors.append(arr)
                    seg_ptrs.append(arr.ctypes.data)
                    seg_blocks.append(nb)
                if len(buf) > nb * 64:
                    carry = bytes(buf[nb * 64:])
            s._tail = carry
            seg_off.append(len(seg_ptrs))
        n = len(batch)
        self.lane_rounds[n - 1] += 1
        self.bytes_hashed += sum(seg_blocks) * 64
        c_ptrs = (ctypes.c_void_p * max(1, len(seg_ptrs)))(*seg_ptrs)
        c_blocks = (ctypes.c_long * max(1, len(seg_blocks)))(*seg_blocks)
        c_off = (ctypes.c_int * (n + 1))(*seg_off)
        self._lib.md5_multi_segments(states.ctypes.data_as(u32p), c_ptrs,
                                     c_blocks, c_off, n)
        with self._cv:
            for i, (s, _) in enumerate(batch):
                s._state[:] = states[4 * i: 4 * i + 4]
                if not s._queue and id(s) not in self._member:
                    s._done.set()

    def stats(self) -> dict:
        """Rounds by lane count, rounds, streams per round, bytes."""
        rounds = sum(self.lane_rounds)
        streams = sum((i + 1) * r for i, r in enumerate(self.lane_rounds))
        return {"lane_rounds": list(self.lane_rounds), "rounds": rounds,
                "streams_per_round": streams / rounds if rounds else 0.0,
                "bytes_hashed": self.bytes_hashed}

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)


_server: MD5Server | None = None
_server_lock = threading.Lock()


def global_server() -> MD5Server:
    """The process-wide hash server, started at the first call. The
    library's build failing raises ``BuildError``."""
    global _server
    if _server is None:
        with _server_lock:
            if _server is None:
                from .. import native
                _server = MD5Server(native.load_native())
    return _server


def shutdown_server() -> None:
    global _server
    with _server_lock:
        srv, _server = _server, None
    if srv is not None:
        srv.stop()
