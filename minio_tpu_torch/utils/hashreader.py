"""hash.Reader equivalent, the port of utils/hashreader.py (reference
pkg/hash/reader.go:62): wraps an input stream, enforces the declared size,
computes MD5 (the ETag) and an optional SHA256, and verifies expected
digests at EOF — the PutObject ingress integrity gate.

Where the payload digests run, by the JAX package's rules:
- an MD5-only body of at least ``ASYNC_DIGEST_MIN`` (4 MiB) hashes on the
  shared multi-lane MD5 server (``utils/md5simd.py``: concurrent PUT
  streams share AVX2 lanes) when the host has a spare core, or when another
  large body is already being ingested;
- a large body that also needs SHA256 (a signed payload), or whose size
  turns out large only while it streams, hashes on a per-reader worker
  thread (``_AsyncDigest``) when the host has a spare core;
- everything else hashes in the reading thread (``hashlib`` releases the
  interpreter lock for buffers over 2 KiB).
The ETag is the same bytes on every route. When the fused-pipeline ETag is
eligible the object layer calls :meth:`HashReader.disable_payload_hash` and
derives the ETag from the per-chunk bitrot digests the encode path
computes anyway (:class:`PipelineETag`); :func:`pipeline_etag_reference`
is the from-raw-bytes reference of that ETag. The payload digests charge
the ``etag`` stage of an armed stage collector (``obs/stages``)."""
from __future__ import annotations

import base64
import binascii
import hashlib
import os
import queue
import threading
import weakref

from ..obs import stages as _stages
from . import errors

#: bodies at least this large leave the reading thread for the MD5 lanes
#: or a digest worker (the hop costs more than the digest below it)
ASYNC_DIGEST_MIN = 4 << 20


def _usable_cpus() -> int:
    """CPUs this process may run on (affinity-aware where the platform
    says; os.cpu_count() counts the whole host)."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


#: moving the digest chain off the reading thread pays only when another
#: core can run it
_MULTI_CORE = _usable_cpus() > 1

#: large-body ingests in flight: on one core the first hashes inline and
#: the concurrent ones share the MD5 lanes
_active_lock = threading.Lock()
_active_large = 0


def _enter_large() -> int:
    """Registers a large-body ingest; returns how many were active."""
    global _active_large
    with _active_lock:
        n = _active_large
        _active_large += 1
        return n


def _leave_large() -> None:
    global _active_large
    with _active_lock:
        _active_large = max(0, _active_large - 1)


def _release_large(token: dict) -> None:
    """Idempotent: runs at EOF and again when an abandoned reader (an
    aborted upload) is collected; only the first counts."""
    if token.pop("on", None):
        _leave_large()


class _AsyncDigest:
    """Ordered digest updates on one worker thread: update() enqueues and
    returns, drain() joins the worker. The queue is bounded (a slow digest
    cannot buffer the stream), and a finalizer stops the worker when its
    reader is abandoned, so no thread outlives its stream."""

    def __init__(self, hashes: list):
        self.hashes = hashes
        self._q: queue.Queue = queue.Queue(maxsize=8)
        # the thread holds no reference to self, or the finalizer below
        # could never fire
        self._t = threading.Thread(target=_digest_loop,
                                   args=(self._q, list(hashes)),
                                   daemon=True, name="minio-tpu-torch-digest")
        self._t.start()
        weakref.finalize(self, self._q.put, None)

    def update(self, b) -> None:
        self._q.put(b)

    def drain(self) -> None:
        self._q.put(None)
        self._t.join()


def _digest_loop(q: queue.Queue, hashes: list) -> None:
    while True:
        b = q.get()
        if b is None:
            return
        for h in hashes:
            h.update(b)


class BadDigestError(Exception):
    def __init__(self, want: str, got: str):
        self.want, self.got = want, got
        super().__init__(f"md5 mismatch want={want} got={got}")


class SHA256MismatchError(Exception):
    def __init__(self, want: str, got: str):
        self.want, self.got = want, got
        super().__init__(f"sha256 mismatch want={want} got={got}")


class HashReader:
    def __init__(self, stream, size: int = -1, md5_hex: str = "",
                 sha256_hex: str = "", actual_size: int = -1):
        self.stream = stream
        self.size = size
        self.actual_size = actual_size if actual_size >= 0 else size
        self.want_md5 = md5_hex.lower()
        self.want_sha256 = sha256_hex.lower()
        self._md5 = hashlib.md5()
        self._sha256 = hashlib.sha256() if sha256_hex else None
        self._read = 0
        self._eof = False
        self._async: _AsyncDigest | None = None
        self._lane = False  # the MD5 runs on the shared lane server
        self._payload_hash = True  # False: the fused-ETag pipeline owns it
        self._active_token: dict = {}
        if size >= ASYNC_DIGEST_MIN:
            already_active = _enter_large()
            self._active_token = {"on": True}
            weakref.finalize(self, _release_large, self._active_token)
            # a spare core: always off the reading thread; one core: only
            # concurrent streams leave it, for the shared lanes
            if _MULTI_CORE or already_active >= 1:
                if self._sha256 is None:
                    from .md5simd import global_server
                    self._md5 = global_server().stream()
                    self._lane = True
                elif _MULTI_CORE:
                    self._async = _AsyncDigest(self._hashes())

    def _hashes(self) -> list:
        return [self._md5] + (
            [self._sha256] if self._sha256 is not None else [])

    def disable_payload_hash(self) -> bool:
        """Stop hashing payload bytes — the fused pipeline derives the ETag
        from the encode path's bitrot digests instead. Refused (returns
        False) when the client sent digests to verify (Content-MD5 / signed
        SHA256): those MUST be checked over the payload. Legal mid-stream:
        the bytes hashed so far are dropped with the digest state."""
        if self.want_md5 or self.want_sha256:
            return False
        self._payload_hash = False
        if self._async is not None:
            self._async.drain()
            self._async = None
        return True

    def _ingest(self, b) -> None:
        """Charge one read's bytes to the digest chain (nothing in fused-
        ETag mode)."""
        if not self._payload_hash:
            return
        with _stages.timed(_stages.active(), "etag"):
            if self._async is not None:
                self._async.update(b)
            else:
                self._md5.update(b)
                if self._sha256 is not None:
                    self._sha256.update(b)

    def read(self, n: int = -1) -> bytes:
        if self._eof:
            return b""
        if self.size >= 0:
            remaining = self.size - self._read
            if remaining <= 0:
                # enforce the declared size even when the source has more
                if self.stream.read(1):
                    raise errors.MoreData()
                self._finish()
                return b""
            n = remaining if n < 0 else min(n, remaining)
        b = self.stream.read(n)
        if not b:
            if self.size >= 0 and self._read < self.size:
                raise errors.LessData()
            self._finish()
            return b""
        self._read += len(b)
        if self.size < 0 and not self._active_token and \
                self._read >= ASYNC_DIGEST_MIN:
            # an unknown-size body that turned out large counts toward the
            # concurrent large ingests; with a spare core its digest chain
            # moves to a worker from here on (the lanes cannot adopt a
            # hashlib state mid-stream)
            _enter_large()
            self._active_token = {"on": True}
            weakref.finalize(self, _release_large, self._active_token)
            if _MULTI_CORE and self._payload_hash:
                self._async = _AsyncDigest(self._hashes())
        self._ingest(b)
        return b

    def readinto(self, view) -> int:
        """Read up to ``len(view)`` bytes straight into a caller's buffer
        (the PUT ingest into the erasure pipeline's pooled block buffers:
        no ``bytes`` object per block). Loops over short reads like
        io.ReadFull. A deferred digest (the lanes, a worker) keeps its
        input until hashed, which would race the caller's reuse of the
        buffer: those go through read() and a copy."""
        view = memoryview(view).cast("B")
        want = len(view)
        if self._payload_hash and (self._async is not None or self._lane):
            got = 0
            while got < want:
                b = self.read(want - got)
                if not b:
                    break
                view[got: got + len(b)] = b
                got += len(b)
            return got
        if self._eof:
            return 0
        if self.size >= 0:
            remaining = self.size - self._read
            if remaining <= 0:
                if self.stream.read(1):
                    raise errors.MoreData()
                self._finish()
                return 0
            want = min(want, remaining)
        got = 0
        inner = getattr(self.stream, "readinto", None)
        while got < want:
            if inner is not None:
                n = inner(view[got:want])
                if not n:
                    break
                got += n
            else:
                b = self.stream.read(want - got)
                if not b:
                    break
                view[got: got + len(b)] = b
                got += len(b)
        if got == 0:
            if self.size >= 0 and self._read < self.size:
                raise errors.LessData()
            self._finish()
            return 0
        self._read += got
        self._ingest(view[:got])
        return got

    def _drain(self) -> None:
        if self._async is not None:
            self._async.drain()
            self._async = None

    def _finish(self) -> None:
        self._eof = True
        _release_large(self._active_token)
        self._drain()
        if self.want_md5 and self.md5_hex() != self.want_md5:
            raise BadDigestError(self.want_md5, self.md5_hex())
        if self._sha256 is not None and self.want_sha256 and \
                self._sha256.hexdigest() != self.want_sha256:
            raise SHA256MismatchError(self.want_sha256,
                                      self._sha256.hexdigest())

    def md5_hex(self) -> str:
        self._drain()
        return self._md5.hexdigest()

    def etag(self) -> str:
        return self.md5_hex()

    def md5_base64(self) -> str:
        self._drain()
        return base64.b64encode(self._md5.digest()).decode()

    def bytes_read(self) -> int:
        return self._read


def etag_from_parts(part_etags: list[str]) -> str:
    """S3 multipart ETag: md5(concat(binary md5s))-N."""
    h = hashlib.md5()
    for e in part_etags:
        h.update(binascii.unhexlify(e.split("-")[0]))
    return f"{h.hexdigest()}-{len(part_etags)}"


# --- fused-pipeline ETag ------------------------------------------------------


class PipelineETag:
    """Content ETag derived from the per-chunk bitrot digests of the DATA
    shards, in stream order (block-major, shard-major within a block, chunk
    order within a shard) — the digests the PUT path computes anyway (the
    dispatch queue's encode+hash flush on the card, the native host hash
    for tail blocks). The host folds only the digest stream (32 B per
    bitrot chunk, ~0.2% of the payload at 16 KiB chunks) through MD5, so a
    PUT never runs host MD5 over payload bytes.

    Deterministic given (payload, k, block_size, bitrot chunk, algo) — the
    tuple xl.meta records — and the JAX package's bytes. The empty object
    folds an empty digest stream, so its ETag equals the empty-body MD5."""

    def __init__(self):
        self._md5 = hashlib.md5()
        self.blocks = 0

    def add_digests(self, dig_bytes) -> None:
        """Fold one block's data-shard digest stream (bytes/buffer, shard
        major)."""
        self._md5.update(dig_bytes)
        self.blocks += 1

    def etag(self) -> str:
        return self._md5.hexdigest()


def pipeline_etag_reference(payload: bytes, k: int, block_size: int,
                            chunk: int, algo_id: int = 0) -> str:
    """From-raw-bytes reference of :class:`PipelineETag`: split each block
    into k zero-padded ``ceil(len/k)`` shards (the reference Split
    semantics, cmd/erasure-coding.go:74), digest each shard's
    ``chunk``-size pieces (short tail piece last) on the host, fold the
    data-shard digests through MD5 in stream order."""
    import numpy as np

    from ..erasure import bitrot
    md5 = hashlib.md5()
    n = len(payload)
    off = 0
    while off < n:
        block = payload[off: off + block_size]
        off += block_size
        shard_len = -(-len(block) // k)
        arr = np.zeros(k * shard_len, dtype=np.uint8)
        arr[: len(block)] = np.frombuffer(block, dtype=np.uint8)
        digs = bitrot.shard_chunk_digests(
            arr.reshape(k, shard_len), chunk, algo_id)
        md5.update(digs.tobytes())
    return md5.hexdigest()
