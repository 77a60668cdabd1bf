"""SSE core — the port of minio_tpu/crypto/sse.py (reference
cmd/crypto/sse-c.go, sse-s3.go, sse-kms.go, metadata.go and the DARE stream
the reference gets from sio, re-designed there as explicit AEAD packages):
header parsing for SSE-C, SSE-S3 and SSE-KMS, the sealed per-object key
(OEK envelope), and the package stream under either package cipher.

Stream format, byte-identical to the JAX package: plaintext split into
PKG_SIZE packages; package i is ``AEAD(OEK).seal(nonce_i, pkg, aad_i)`` =
ciphertext || 16-byte tag with ``nonce_i = base_iv[0:8] || BE32(seq0+i)``
and ``aad_i = "minio-tpu-sse-v1" || BE32(seq0+i)``. Encrypted length =
plain + 16*ceil(plain/PKG_SIZE).

Two package ciphers share that framing, as in the JAX package:

- **ChaCha20-Poly1305**: every keystream comes from the dispatch op
  ``sse_xor`` of the queue of the caller's device: one ChaCha20 kernel
  launch (ops/chacha_cuda.py, K4) per flush over many objects on the card,
  the plain PyTorch version on the CPU. That holds for the full packages of
  a PUT or GET block (FLUSH_PKGS of them), for a short tail package and for
  the 32-byte OEK envelope (both zero-padded to whole 64-byte blocks). The
  Poly1305 tags stay on the host (numpy limbs), as in the JAX package.
- **AES-256-GCM**: on the host, as the JAX package runs it (there through
  the ``cryptography`` wheel's AES-NI), on the port's own engine
  (native/aesgcm.cpp): one native call per block of FLUSH_PKGS packages,
  the interpreter lock released. Its envelope and the KMS's data-key seal
  use the same engine (crypto/aesgcm.py).

The package cipher of NEW objects is ``default_cipher()``, the config
registry's ``workloads.sse_cipher`` (env ``MINIO_TPU_SSE_CIPHER`` > stored
> default): ``aes-gcm`` (also ``aes``, ``aes256-gcm``),
``chacha20`` (also ``chacha``, ``chacha20-poly1305``) or ``auto``. In the
port ``auto`` means ChaCha20-Poly1305, whose keystream runs on the card:
that is the JAX package's rule for a build without the ``cryptography``
wheel, and the port never has the wheel. An object's own cipher is
recorded in its internal metadata (META_CIPHER; absent = AES-256-GCM, the
legacy objects), so objects under either cipher read back whatever the
setting. Metrics feeds of the ``workloads`` group wait for the config
plane.

SSE-S3 seals the OEK under a data key of the process KMS (crypto/kms.py,
``get_kms``); SSE-KMS under a data key of a named master key, bound to
the object path and the caller's canonical JSON context.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import secrets
import struct
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from .. import native
from ..utils import errors
from . import chacha20poly1305 as ccp
from . import kms as _kms
from .aesgcm import AESGCM, InvalidTag

PKG_SIZE = 64 << 10
TAG = 16
_AAD = b"minio-tpu-sse-v1"

#: package cipher wire names (META_CIPHER values)
CIPHER_AESGCM = "AES256-GCM"
CIPHER_CHACHA20 = "CHACHA20-POLY1305"
#: packages per coalesced seal/open flush (1 MiB of 64 KiB packages, the
#: PUT/GET block quantum the dispatch queue batches on)
FLUSH_PKGS = 16

# internal metadata keys (reference: X-Minio-Internal-Server-Side-Encryption-*)
META_SCHEME = "x-minio-internal-sse-scheme"          # "C" | "S3" | "KMS"
META_SEALED = "x-minio-internal-sse-sealed-key"      # b64 sealed OEK
META_IV = "x-minio-internal-sse-iv"                  # b64 12-byte base IV
META_KEY_MD5 = "x-minio-internal-sse-c-key-md5"      # SSE-C key fingerprint
META_KMS_BLOB = "x-minio-internal-sse-kms-blob"      # S3/KMS sealed data key
META_KMS_KEY_ID = "x-minio-internal-sse-kms-key-id"  # SSE-KMS master key id
META_KMS_CONTEXT = "x-minio-internal-sse-kms-context"  # b64 JSON context
META_PLAIN_SIZE = "x-minio-internal-sse-plain-size"
META_CIPHER = "x-minio-internal-sse-cipher"  # package cipher; absent = GCM


def default_cipher() -> str:
    """The package cipher for NEW objects, the registry's
    ``workloads.sse_cipher`` (env MINIO_TPU_SSE_CIPHER > stored > auto);
    ``auto`` and anything unknown give ChaCha20-Poly1305 (the module
    docstring says why)."""
    from ..config import get_config_sys
    v = (get_config_sys().get("workloads", "sse_cipher") or "auto").lower()
    if v in ("aes-gcm", "aes", "aes256-gcm"):
        return CIPHER_AESGCM
    return CIPHER_CHACHA20


def cipher_of(meta: dict) -> str:
    """The package cipher an existing object was written with."""
    return meta.get(META_CIPHER, "") or CIPHER_AESGCM


@dataclass
class SSEInfo:
    scheme: str                    # "C", "S3" or "KMS"
    key: bytes = b""               # SSE-C: client key (never persisted)
    key_md5: str = ""
    kms_key_id: str = ""           # SSE-KMS: requested master key id
    kms_context: str = ""          # SSE-KMS: canonical JSON context


def parse_sse_headers(hdr, bucket: str, object: str) -> SSEInfo | None:
    """Validate the request's SSE headers (cmd/crypto/sse-c.go ParseHTTP).
    Returns None when the request asks for no encryption."""
    algo_c = hdr.get("x-amz-server-side-encryption-customer-algorithm", "")
    sse = hdr.get("x-amz-server-side-encryption", "")
    if algo_c:
        if algo_c != "AES256":
            raise errors.InvalidEncryptionAlgo(bucket, object)
        key_b64 = hdr.get("x-amz-server-side-encryption-customer-key", "")
        md5_b64 = hdr.get("x-amz-server-side-encryption-customer-key-md5", "")
        try:
            key = base64.b64decode(key_b64, validate=True)
        except ValueError:
            raise errors.InvalidSSEKey(bucket, object) from None
        if len(key) != 32:
            raise errors.InvalidSSEKey(bucket, object)
        want = base64.b64encode(hashlib.md5(key).digest()).decode()
        if md5_b64 != want:
            raise errors.SSEKeyMD5Mismatch(bucket, object)
        return SSEInfo(scheme="C", key=key, key_md5=md5_b64)
    if sse:
        if sse == "AES256":
            return SSEInfo(scheme="S3")
        if sse == "aws:kms":
            key_id = hdr.get(
                "x-amz-server-side-encryption-aws-kms-key-id", "")
            ctx_b64 = hdr.get("x-amz-server-side-encryption-context", "")
            ctx = ""
            if ctx_b64:
                # cmd/crypto/sse-kms.go ParseHTTP: context is b64 JSON;
                # re-serialize with sorted keys so the stored form is
                # canonical and unseal can't fail on key-order drift.
                try:
                    parsed = json.loads(base64.b64decode(ctx_b64,
                                                         validate=True))
                    if not isinstance(parsed, dict):
                        raise ValueError
                    ctx = json.dumps(parsed, sort_keys=True,
                                     separators=(",", ":"))
                except ValueError:  # binascii.Error, JSON and UTF-8 too
                    raise errors.InvalidSSEContext(bucket, object) \
                        from None
            return SSEInfo(scheme="KMS", kms_key_id=key_id,
                           kms_context=ctx)
        raise errors.InvalidEncryptionAlgo(bucket, object)
    return None


def sse_kms_context(bucket: str, object: str, user_ctx: str) -> str:
    """The KMS context string for an SSE-KMS object: the object path plus
    the caller's canonical JSON context (cmd/crypto/sse-kms.go binds both
    into the sealed blob so a blob replayed on another object — or with a
    different context — fails to unseal)."""
    return f"{bucket}/{object}|{user_ctx}"


def _kek(scheme_key: bytes, bucket: str, object: str) -> bytes:
    """Key-encryption key bound to the object path (unseal of a blob copied
    to another path fails)."""
    return hashlib.sha256(
        b"minio-tpu-sse-kek:" + scheme_key +
        f":{bucket}/{object}".encode()).digest()


def _queue(device):
    from ..runtime.dispatch import global_queue
    return global_queue(device)


def _xor_one(queue, key: bytes, nonce: bytes, data) -> Future:
    """Submit one buffer of any length (a tail package, the OEK) to the
    queue's ``sse_xor``, zero-padded to whole 64-byte blocks (one at
    least): Future[(xored u32 [1, L/4], poly_key u32 [1, 8])]."""
    n = len(data)
    buf = np.zeros((1, max(64, -(-n // 64) * 64)), np.uint8)
    buf[0, :n] = np.frombuffer(data, np.uint8)
    return queue.sse_xor(buf.view("<u4"), key,
                         ccp.nonce_words(nonce).reshape(1, 3))


def _seal_one(queue, key: bytes, nonce: bytes, aad: bytes, plain) -> bytes:
    """ChaCha20-Poly1305 seal of one buffer: ciphertext || 16-byte tag
    (ccp.seal_one with the keystream from the queue)."""
    xored, pk = _xor_one(queue, key, nonce, plain).result()
    ct = xored.view(np.uint8)[0, :len(plain)].tobytes()
    return ct + ccp.poly1305_tag(pk.view(np.uint8)[0].tobytes(),
                                 ccp.mac_data(aad, ct))


def _open_one(queue, key: bytes, nonce: bytes, aad: bytes, sealed) -> bytes:
    """ChaCha20-Poly1305 open of one buffer (ccp.open_one with the
    keystream from the queue); raises ccp.BadTag, releasing nothing."""
    if len(sealed) < TAG:
        raise ccp.BadTag("short package")
    ct, tag = bytes(sealed[:-TAG]), bytes(sealed[-TAG:])
    xored, pk = _xor_one(queue, key, nonce, ct).result()
    want = ccp.poly1305_tag(pk.view(np.uint8)[0].tobytes(),
                            ccp.mac_data(aad, ct))
    if not hmac.compare_digest(want, tag):
        raise ccp.BadTag("poly1305 tag mismatch")
    return xored.view(np.uint8)[0, :len(ct)].tobytes()


def seal_object_key(oek: bytes, scheme_key: bytes, bucket: str,
                    object: str, cipher: str = CIPHER_CHACHA20,
                    device=None) -> bytes:
    """Seal the OEK under the path-bound KEK (nonce || 32 bytes || tag).
    The envelope AEAD follows the object's package cipher: ChaCha20-
    Poly1305 with its keystream from the queue of ``device`` (None = the
    CUDA card), or AES-256-GCM on the host engine."""
    nonce = secrets.token_bytes(12)
    kek = _kek(scheme_key, bucket, object)
    if cipher == CIPHER_CHACHA20:
        return nonce + _seal_one(_queue(device), kek, nonce, _AAD, oek)
    return nonce + AESGCM(kek).encrypt(nonce, oek, _AAD)


def unseal_object_key(sealed: bytes, scheme_key: bytes, bucket: str,
                      object: str, cipher: str = CIPHER_CHACHA20,
                      device=None) -> bytes:
    kek = _kek(scheme_key, bucket, object)
    try:
        if cipher == CIPHER_CHACHA20:
            return _open_one(_queue(device), kek, sealed[:12], _AAD,
                             sealed[12:])
        return AESGCM(kek).decrypt(sealed[:12], sealed[12:], _AAD)
    except (ccp.BadTag, InvalidTag):
        raise errors.SSEKeyMismatch(bucket, object) from None


def enc_size(plain: int) -> int:
    if plain <= 0:
        return max(plain, 0)
    return plain + TAG * (-(-plain // PKG_SIZE))


def plain_size_of(meta: dict, fallback: int) -> int:
    try:
        return int(meta.get(META_PLAIN_SIZE, ""))
    except ValueError:
        return fallback


def _nonce(base_iv: bytes, seq: int) -> bytes:
    return base_iv[:8] + struct.pack(">I", seq)


def _aad(seq: int) -> bytes:
    return _AAD + struct.pack(">I", seq)


class _TagError(Exception):
    """Internal: package AEAD verification failed (mapped to
    SSEDecryptError by the stream wrappers, which know bucket/key)."""


class _GCMPackages:
    """AES-256-GCM package lane on the host engine: a block of packages is
    sealed or opened in ONE native call (nonces and AADs derived there as
    ``_nonce``/``_aad`` derive them); an open checks every tag before it
    decrypts any package."""

    name = CIPHER_AESGCM

    def __init__(self, oek: bytes, base_iv: bytes):
        self._oek = oek
        self.base_iv = base_iv

    def seal_block(self, seq0: int, pkgs: list) -> list:
        return native.aesgcm_seal_pkgs(self._oek, self.base_iv, seq0, pkgs)

    def open_block(self, seq0: int, cts: list) -> list:
        bad, out = native.aesgcm_open_pkgs(self._oek, self.base_iv, seq0,
                                           cts)
        if bad >= 0:
            raise _TagError
        return out


class _ChaChaPackages:
    """ChaCha20-Poly1305 package lane. Full packages of a block are
    keystream-XORed in ONE coalesced flush of the dispatch op ``sse_xor``
    and tagged with the batched numpy Poly1305; a short tail package rides
    the same op, padded to whole blocks, with the scalar Poly1305."""

    name = CIPHER_CHACHA20

    def __init__(self, oek: bytes, base_iv: bytes, queue):
        self._oek = oek
        self.base_iv = base_iv
        self._queue = queue

    def _xor_full(self, seq0: int, data: np.ndarray) -> Future:
        """Future[(xored u32 [P, L/4], poly_keys u32 [P, 8])] for full
        packages uint8 [P, L]."""
        nonces = np.stack([ccp.nonce_words(_nonce(self.base_iv, seq0 + i))
                           for i in range(data.shape[0])])
        return self._queue.sse_xor(np.ascontiguousarray(data).view("<u4"),
                                   self._oek, nonces)

    def seal_block(self, seq0: int, pkgs: list) -> list:
        nfull = 0
        while nfull < len(pkgs) and len(pkgs[nfull]) == PKG_SIZE:
            nfull += 1
        full = self._xor_full(seq0, np.stack(
            [np.frombuffer(p, np.uint8) for p in pkgs[:nfull]])) \
            if nfull else None
        tails = [_seal_one(self._queue, self._oek,
                           _nonce(self.base_iv, seq0 + i), _aad(seq0 + i),
                           pkgs[i]) for i in range(nfull, len(pkgs))]
        out: list = []
        if full is not None:
            ct, pk = (w.view(np.uint8) for w in full.result())
            aads = [_aad(seq0 + i) for i in range(nfull)]
            tags = ccp.poly1305_tags(pk, ccp.mac_datas(aads, ct))
            sealed = np.empty((nfull, PKG_SIZE + TAG), np.uint8)
            sealed[:, :PKG_SIZE] = ct
            sealed[:, PKG_SIZE:] = tags
            out.extend(memoryview(sealed[i]) for i in range(nfull))
        return out + tails

    def open_block(self, seq0: int, cts: list) -> list:
        nfull = 0
        while nfull < len(cts) and len(cts[nfull]) == PKG_SIZE + TAG:
            nfull += 1
        out: list = []
        if nfull:
            sealed = np.stack([np.frombuffer(c, np.uint8)
                               for c in cts[:nfull]])
            ct = np.ascontiguousarray(sealed[:, :PKG_SIZE])
            full = self._xor_full(seq0, ct)
        try:
            tails = [_open_one(self._queue, self._oek,
                               _nonce(self.base_iv, seq0 + i),
                               _aad(seq0 + i), cts[i])
                     for i in range(nfull, len(cts))]
        except ccp.BadTag:
            raise _TagError from None
        if nfull:
            plain, pk = (w.view(np.uint8) for w in full.result())
            aads = [_aad(seq0 + i) for i in range(nfull)]
            tags = ccp.poly1305_tags(pk, ccp.mac_datas(aads, ct))
            # verify-before-release: nothing is emitted unless EVERY
            # package of the flush authenticates; constant-time compare
            # over the whole tag block
            want = np.ascontiguousarray(sealed[:, PKG_SIZE:])
            if not hmac.compare_digest(tags.tobytes(), want.tobytes()):
                raise _TagError
            out.extend(memoryview(plain[i]) for i in range(nfull))
        return out + tails


def package_cipher(cipher: str, oek: bytes, base_iv: bytes, device=None):
    """The package AEAD lane for a cipher wire name (META_CIPHER): the
    ChaCha20 lane rides the dispatch queue of ``device`` (None = the CUDA
    card), the AES-GCM lane the host engine."""
    if cipher == CIPHER_CHACHA20:
        return _ChaChaPackages(oek, base_iv, _queue(device))
    if cipher == CIPHER_AESGCM:
        return _GCMPackages(oek, base_iv)
    raise ValueError(f"unknown SSE package cipher {cipher!r}")


class EncryptReader:
    """Wraps a plaintext stream and yields the encrypted package stream.
    Collects up to FLUSH_PKGS packages of plaintext and seals them through
    the package cipher's ONE coalesced flush."""

    def __init__(self, stream, oek: bytes, base_iv: bytes,
                 cipher: str = CIPHER_CHACHA20, device=None):
        self.stream = stream
        self.base_iv = base_iv
        self.cipher = package_cipher(cipher, oek, base_iv, device)
        self._seq = 0
        self._chunks: list = []   # sealed buffers, consume-from-front
        self._pos = 0             # read offset into _chunks[0]
        self._avail = 0
        self._eof = False

    def _fill(self):
        while not self._eof and self._avail < (1 << 20):
            pkgs = []
            for _ in range(FLUSH_PKGS):
                pkg = _read_full(self.stream, PKG_SIZE)
                if len(pkg) < PKG_SIZE:
                    self._eof = True
                if pkg:
                    pkgs.append(pkg)
                if self._eof:
                    break
            if not pkgs:
                break
            for sealed in self.cipher.seal_block(self._seq, pkgs):
                self._chunks.append(memoryview(sealed))
                self._avail += len(sealed)
            self._seq += len(pkgs)

    def readinto(self, buf) -> int:
        mv = memoryview(buf).cast("B")
        done = 0
        while done < len(mv):
            if not self._chunks:
                self._fill()
                if not self._chunks:
                    break
            head = self._chunks[0]
            take = min(len(mv) - done, len(head) - self._pos)
            mv[done:done + take] = head[self._pos:self._pos + take]
            done += take
            self._pos += take
            self._avail -= take
            if self._pos == len(head):
                self._chunks.pop(0)
                self._pos = 0
        return done

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            out = bytearray()
            while True:
                b = self.read(1 << 20)
                if not b:
                    return bytes(out)
                out += b
        self._fill()
        n = min(n, self._avail)
        out = bytearray(n)
        got = self.readinto(out)
        return bytes(out[:got])


class DecryptWriter:
    """Writer wrapper decrypting a package-aligned ciphertext stream and
    emitting the plaintext sub-range [skip, skip+limit) of it (ranged GETs
    read whole covering packages; the trim happens here). Full packages
    accumulate up to FLUSH_PKGS and open through the package cipher's one
    coalesced flush; nothing is emitted from a flush whose tags do not
    ALL verify."""

    def __init__(self, writer, oek: bytes, base_iv: bytes, seq0: int,
                 skip: int, limit: int, bucket: str = "", object: str = "",
                 cipher: str = CIPHER_CHACHA20, device=None):
        self.writer = writer
        self.base_iv = base_iv
        self.cipher = package_cipher(cipher, oek, base_iv, device)
        self._seq = seq0
        self._skip = skip
        self._left = limit
        self._buf = bytearray()
        self._bo = (bucket, object)

    def write(self, b):
        self._buf += b
        unit = PKG_SIZE + TAG
        while len(self._buf) >= FLUSH_PKGS * unit:
            n = (len(self._buf) // unit) * unit
            # replace the buffer, never resize it: _open hands views of it
            # downstream, and resizing an exported bytearray raises
            full, self._buf = self._buf, self._buf[n:]
            self._open(memoryview(full)[:n], n // unit)

    def _open(self, ct: memoryview, npkgs: int):
        unit = PKG_SIZE + TAG
        cts = [ct[i * unit: min((i + 1) * unit, len(ct))]
               for i in range(npkgs)]
        try:
            plains = self.cipher.open_block(self._seq, cts)
        except _TagError:
            raise errors.SSEDecryptError(*self._bo) from None
        self._seq += npkgs
        for plain in plains:
            plain = memoryview(plain).cast("B")
            if self._skip:
                drop = min(self._skip, len(plain))
                plain = plain[drop:]
                self._skip -= drop
            if self._left >= 0:
                plain = plain[:self._left]
                self._left -= len(plain)
            if len(plain):
                self.writer.write(plain)

    def _drain(self):
        if self._buf:
            unit = PKG_SIZE + TAG
            npkgs = -(-len(self._buf) // unit)
            full, self._buf = self._buf, bytearray()
            self._open(memoryview(full), npkgs)

    def close(self):
        self._drain()
        if hasattr(self.writer, "close"):
            self.writer.close()

    def finish(self):
        """Flush the trailing packages without closing the sink."""
        self._drain()


def decrypt_range_bounds(offset: int, length: int, plain_size: int
                         ) -> tuple[int, int, int, int]:
    """For a plaintext range [offset, offset+length): the ciphertext span
    to read (enc_off, enc_len), the first package seq, and the in-package
    skip. length < 0 means to-end."""
    if length < 0:
        length = plain_size - offset
    end = min(offset + length, plain_size)
    if offset >= plain_size or end <= offset:
        return 0, 0, 0, 0
    pkg0 = offset // PKG_SIZE
    pkg1 = (end - 1) // PKG_SIZE
    enc_off = pkg0 * (PKG_SIZE + TAG)
    enc_end = min((pkg1 + 1) * (PKG_SIZE + TAG), enc_size(plain_size))
    return enc_off, enc_end - enc_off, pkg0, offset - pkg0 * PKG_SIZE


def _read_full(stream, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        b = stream.read(n - got)
        if not b:
            break
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


# --- the S3 handler's PUT and GET set-up ------------------------------------


def _kms_generate(kms, ctx: str, bucket: str, object: str,
                  key_id: str = ""):
    """generate_key with a KMS outage surfaced as a retryable 503
    (matching the read path) instead of a generic 500."""
    try:
        return kms.generate_key(ctx, key_id=key_id)
    except _kms.KMSUnreachable as e:
        raise errors.KMSNotAvailable(bucket, object, extra=str(e)) from None


def _kms_unseal(blob: bytes, ctx: str, bucket: str, object: str,
                key_id: str = "") -> bytes:
    """The data key of an SSE-S3/KMS object: an outage is a 503, any other
    failure (a rotated or deleted master key, a wrong context) the 403 of
    a key mismatch."""
    try:
        return _kms.get_kms().unseal(blob, ctx, key_id=key_id)
    except _kms.KMSUnreachable as e:
        # transient KMS outage — not a wrong-key condition
        raise errors.KMSNotAvailable(bucket, object, extra=str(e)) from None
    except Exception:  # noqa: BLE001 — rotated/deleted master key
        raise errors.SSEKeyMismatch(bucket, object) from None


def encrypt_setup(sse: SSEInfo, stream, size: int, user_defined: dict,
                  bucket: str, object: str, device=None):
    """Envelope set-up for a PUT — minio_tpu/server/s3api.py
    S3Handler._encrypt_setup (cmd/encryption-v1.go EncryptRequest): a
    random OEK sealed under the customer key (SSE-C) or a KMS data key
    (SSE-S3, SSE-KMS), under the package cipher ``default_cipher()``; the
    internal metadata records everything a reader needs except the secret
    itself. Returns (cipher stream, encrypted size, response headers)."""
    oek = secrets.token_bytes(32)
    base_iv = secrets.token_bytes(12)
    cipher = default_cipher()
    user_defined[META_SCHEME] = sse.scheme
    user_defined[META_IV] = base64.b64encode(base_iv).decode()
    user_defined[META_PLAIN_SIZE] = str(size)
    user_defined[META_CIPHER] = cipher
    if sse.scheme == "C":
        key = sse.key
        user_defined[META_KEY_MD5] = sse.key_md5
        resp = {"x-amz-server-side-encryption-customer-algorithm": "AES256",
                "x-amz-server-side-encryption-customer-key-MD5": sse.key_md5}
    elif sse.scheme == "KMS":
        kms = _kms.get_kms()
        key_id = sse.kms_key_id or kms.key_id
        ctx = sse_kms_context(bucket, object, sse.kms_context)
        key, blob = _kms_generate(kms, ctx, bucket, object, key_id)
        user_defined[META_KMS_BLOB] = base64.b64encode(blob).decode()
        user_defined[META_KMS_KEY_ID] = key_id
        if sse.kms_context:
            user_defined[META_KMS_CONTEXT] = base64.b64encode(
                sse.kms_context.encode()).decode()
        resp = {"x-amz-server-side-encryption": "aws:kms",
                "x-amz-server-side-encryption-aws-kms-key-id": key_id}
    else:
        key, blob = _kms_generate(_kms.get_kms(), f"{bucket}/{object}",
                                  bucket, object)
        user_defined[META_KMS_BLOB] = base64.b64encode(blob).decode()
        resp = {"x-amz-server-side-encryption": "AES256"}
    sealed = seal_object_key(oek, key, bucket, object, cipher=cipher,
                             device=device)
    user_defined[META_SEALED] = base64.b64encode(sealed).decode()
    return (EncryptReader(stream, oek, base_iv, cipher=cipher,
                          device=device), enc_size(size), resp)


def sse_read_ctx(internal: dict, hdr, bucket: str, object: str, size: int,
                 device=None):
    """For an encrypted object: unseal the OEK and return (oek, base_iv,
    plain_size, response headers, package cipher); None for plaintext
    objects — minio_tpu/server/s3api.py S3Handler._sse_read_ctx
    (cmd/encryption-v1.go DecryptRequest). SSE-C needs this request's
    customer key (a wrong key MD5 is refused before any package is read or
    opened); SSE-S3 and SSE-KMS unseal their data key through the KMS.
    ``internal`` is the object's internal metadata, ``size`` its stored
    size; a ChaCha20 envelope opens on the queue of ``device`` (None = the
    CUDA card)."""
    scheme = internal.get(META_SCHEME, "")
    if not scheme:
        return None
    sealed = base64.b64decode(internal.get(META_SEALED, ""))
    base_iv = base64.b64decode(internal.get(META_IV, ""))
    plain_size = plain_size_of(internal, size)
    cipher = cipher_of(internal)
    if scheme == "C":
        req = parse_sse_headers(hdr, bucket, object)
        if req is None or req.scheme != "C":
            raise errors.SSEEncryptedObject(bucket, object)
        if req.key_md5 != internal.get(META_KEY_MD5, ""):
            raise errors.SSEKeyMismatch(bucket, object)
        key = req.key
        resp = {"x-amz-server-side-encryption-customer-algorithm": "AES256",
                "x-amz-server-side-encryption-customer-key-MD5": req.key_md5}
    elif scheme == "KMS":
        blob = base64.b64decode(internal.get(META_KMS_BLOB, ""))
        key_id = internal.get(META_KMS_KEY_ID, "")
        stored_ctx = ""
        if internal.get(META_KMS_CONTEXT, ""):
            stored_ctx = base64.b64decode(internal[META_KMS_CONTEXT]).decode()
        key = _kms_unseal(blob, sse_kms_context(bucket, object, stored_ctx),
                          bucket, object, key_id)
        resp = {"x-amz-server-side-encryption": "aws:kms",
                "x-amz-server-side-encryption-aws-kms-key-id": key_id}
    else:
        blob = base64.b64decode(internal.get(META_KMS_BLOB, ""))
        key = _kms_unseal(blob, f"{bucket}/{object}", bucket, object)
        resp = {"x-amz-server-side-encryption": "AES256"}
    oek = unseal_object_key(sealed, key, bucket, object, cipher=cipher,
                            device=device)
    return oek, base_iv, plain_size, resp, cipher
