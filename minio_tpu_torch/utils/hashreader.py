"""hash.Reader equivalent, the port of utils/hashreader.py (reference
pkg/hash/reader.go:62): wraps an input stream, enforces the declared size,
computes MD5 (the ETag) and an optional SHA256, and verifies expected
digests at EOF — the PutObject ingress integrity gate.

Payload digests run through ``hashlib`` in the reading thread (it releases
the interpreter lock for buffers over 2 KiB); the JAX package's multi-lane
MD5 server and digest worker thread are not ported — the ETag is the same
bytes either way. When the fused-pipeline ETag is eligible the object
layer calls :meth:`HashReader.disable_payload_hash` and derives the ETag
from the per-chunk bitrot digests the encode path computes anyway
(:class:`PipelineETag`); :func:`pipeline_etag_reference` is the
from-raw-bytes reference of that ETag. The payload digests charge the
``etag`` stage of an armed stage collector (``obs/stages``)."""
from __future__ import annotations

import base64
import binascii
import hashlib

from ..obs import stages as _stages
from . import errors


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
        self._payload_hash = True  # False: the fused-ETag pipeline owns it

    def disable_payload_hash(self) -> bool:
        """Stop hashing payload bytes — the fused pipeline derives the ETag
        from the encode path's bitrot digests instead. Refused (returns
        False) when the client sent digests to verify (Content-MD5 / signed
        SHA256): those MUST be checked over the payload."""
        if self.want_md5 or self.want_sha256:
            return False
        self._payload_hash = False
        return True

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
        if self._payload_hash:
            with _stages.timed(_stages.active(), "etag"):
                self._md5.update(b)
                if self._sha256 is not None:
                    self._sha256.update(b)
        return b

    def _finish(self):
        self._eof = True
        if self.want_md5 and self.md5_hex() != self.want_md5:
            raise BadDigestError(self.want_md5, self.md5_hex())
        if self._sha256 is not None and self.want_sha256 and \
                self._sha256.hexdigest() != self.want_sha256:
            raise SHA256MismatchError(self.want_sha256,
                                      self._sha256.hexdigest())

    def md5_hex(self) -> str:
        return self._md5.hexdigest()

    def etag(self) -> str:
        return self.md5_hex()

    def md5_base64(self) -> str:
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
