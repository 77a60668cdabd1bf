"""The port's SSE-C ChaCha20-Poly1305 path (minio_tpu_torch.crypto over the
dispatch op ``sse_xor`` and HighwayHash256S erasure shards) held to the JAX
package: the same OEK and base IV give the same ciphertext bytes; shard
files of an encrypted object written by either package are identical,
decode (degraded, ranged, through the other package's DecryptWriter) and
heal through the other; the errors carry the JAX package's classes and
codes. The JAX PUT takes its dispatch-framed route on the CPU."""
import base64
import hashlib
import io
import os

import numpy as np
import pytest

from minio_tpu.crypto import sse as jsse
from minio_tpu.crypto import chacha20poly1305 as jccp
from minio_tpu.erasure import BitrotAlgorithm as JAlgo
from minio_tpu.erasure import Erasure as JErasure
from minio_tpu.erasure import new_bitrot_reader as j_reader
from minio_tpu.erasure import new_bitrot_writer as j_writer
from minio_tpu.erasure.streaming import BufferSink as JSink
from minio_tpu.erasure.streaming import erasure_decode as j_decode
from minio_tpu.erasure.streaming import erasure_encode as j_encode
from minio_tpu.erasure.streaming import erasure_heal as j_heal
from minio_tpu.objectlayer import datatypes as dt
from minio_tpu.storage.xlstorage import _FileReadAt, _FileWriter
from minio_tpu_torch.crypto import sse
from minio_tpu_torch.erasure import BitrotAlgorithm, Erasure
from minio_tpu_torch.erasure import new_bitrot_reader, new_bitrot_writer
from minio_tpu_torch.erasure.bitrot import pick_bitrot_chunk
from minio_tpu_torch.erasure.streaming import (BufferSink, erasure_decode,
                                               erasure_encode, erasure_heal)
from minio_tpu_torch.runtime.dispatch import DispatchQueue
from minio_tpu_torch.utils import errors

PKG = sse.PKG_SIZE
OEK = bytes(range(100, 132))
IV = bytes(range(12))
K, M, BS = 4, 2, 64 << 10


@pytest.fixture(autouse=True)
def _jax_routes(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_PUT_PATH", "dispatch")
    monkeypatch.setenv("MINIO_TPU_DISPATCH_MODE", "cpu")


def plain_of(size, seed=1):
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


def port_seal(plain):
    return sse.EncryptReader(io.BytesIO(plain), OEK, IV,
                             device="cpu").read()


@pytest.mark.parametrize("size", [0, 100, 2 * PKG, 3 * PKG + 1000])
def test_ciphertext_matches_jax(size):
    plain = plain_of(size)
    want = jsse.EncryptReader(io.BytesIO(plain), OEK, IV,
                              cipher=jsse.CIPHER_CHACHA20).read()
    assert len(want) == sse.enc_size(size)
    assert port_seal(plain) == want


class Obj:
    """One SSE-C object sealed and erasure-coded at HighwayHash256S by both
    packages into two sets of disk directories."""

    def __init__(self, root):
        self.plain = plain_of(3 * PKG + 777, 2)
        self.ct = port_seal(self.plain)
        self.er = Erasure(K, M, BS, device="cpu")
        self.jer = JErasure(K, M, BS)
        self.chunk = pick_bitrot_chunk(self.er.shard_size())
        self.till = self.er.shard_file_size(len(self.ct))
        self.dirs = {side: [os.path.join(root, side, f"d{i}")
                            for i in range(K + M)]
                     for side in ("jax", "port")}

    def path(self, side, i):
        return os.path.join(self.dirs[side][i], "b", "o", "part.1")

    def put(self):
        ct = jsse.EncryptReader(io.BytesIO(self.plain), OEK, IV,
                                cipher=jsse.CIPHER_CHACHA20)
        ws = [j_writer(_FileWriter(self.path("jax", i)),
                       JAlgo.HIGHWAYHASH256S, self.chunk)
              for i in range(K + M)]
        assert j_encode(self.jer, ct, ws, K) == len(self.ct)
        for w in ws:
            w.close()
        ws = [new_bitrot_writer(_FileWriter(self.path("port", i)),
                                BitrotAlgorithm.HIGHWAYHASH256S, self.chunk)
              for i in range(K + M)]
        assert erasure_encode(self.er, io.BytesIO(self.ct), ws, K) == \
            len(self.ct)
        for w in ws:
            w.close()

    def readers(self, side, reader, algo, drop=()):
        return [None if i in drop else reader(
            _FileReadAt(self.path(side, i)), algo, self.till, self.chunk)
            for i in range(K + M)]


@pytest.fixture(scope="module")
def obj(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIO_TPU_PUT_PATH", "dispatch")
        mp.setenv("MINIO_TPU_DISPATCH_MODE", "cpu")
        o = Obj(str(tmp_path_factory.mktemp("sse")))
        o.put()
    return o


def read(p):
    with open(p, "rb") as f:
        return f.read()


def test_shard_files_identical(obj):
    for i in range(K + M):
        assert read(obj.path("port", i)) == read(obj.path("jax", i)), i


def test_jax_decrypts_port_ranged_degraded(obj):
    off, ln = PKG - 3, PKG + 70001  # across two package boundaries
    eo, el, seq0, skip = sse.decrypt_range_bounds(off, ln, len(obj.plain))
    assert (eo, el, seq0, skip) == jsse.decrypt_range_bounds(
        off, ln, len(obj.plain))
    out = JSink()
    dw = jsse.DecryptWriter(out, OEK, IV, seq0, skip, ln,
                            cipher=jsse.CIPHER_CHACHA20)
    j_decode(obj.jer, dw, obj.readers("port", j_reader,
                                      JAlgo.HIGHWAYHASH256S, drop=(0, 2)),
             eo, el, len(obj.ct))
    dw.close()
    assert out.getvalue() == obj.plain[off: off + ln]


def test_port_decrypts_jax_whole_and_ranged(obj):
    for off, ln, drop in ((0, len(obj.plain), (1, 3)),
                          (2 * PKG + 11, 30000, ())):
        eo, el, seq0, skip = sse.decrypt_range_bounds(off, ln,
                                                      len(obj.plain))
        out = BufferSink()
        dw = sse.DecryptWriter(out, OEK, IV, seq0, skip, ln, device="cpu")
        erasure_decode(obj.er, dw, obj.readers(
            "jax", new_bitrot_reader, BitrotAlgorithm.HIGHWAYHASH256S,
            drop), eo, el, len(obj.ct))
        dw.close()
        assert out.getvalue() == obj.plain[off: off + ln]


@pytest.mark.parametrize("healer", ["port", "jax"])
def test_heal_across_packages(obj, tmp_path, healer):
    """Each package heals a data and a parity shard of the other's files,
    byte-identical to the removed ones."""
    src = "jax" if healer == "port" else "port"
    lost = (1, K)
    if healer == "port":
        ws = [new_bitrot_writer(_FileWriter(str(tmp_path / f"{i}")),
                                BitrotAlgorithm.HIGHWAYHASH256S, obj.chunk)
              if i in lost else None for i in range(K + M)]
        erasure_heal(obj.er, ws, obj.readers(
            src, new_bitrot_reader, BitrotAlgorithm.HIGHWAYHASH256S, lost),
            len(obj.ct))
    else:
        ws = [j_writer(_FileWriter(str(tmp_path / f"{i}")),
                       JAlgo.HIGHWAYHASH256S, obj.chunk)
              if i in lost else None for i in range(K + M)]
        j_heal(obj.jer, ws, obj.readers(src, j_reader,
                                        JAlgo.HIGHWAYHASH256S, lost),
               len(obj.ct))
    for i in lost:
        assert read(str(tmp_path / f"{i}")) == read(obj.path(src, i)), i


def headers(key):
    return {"x-amz-server-side-encryption-customer-algorithm": "AES256",
            "x-amz-server-side-encryption-customer-key":
                base64.b64encode(key).decode(),
            "x-amz-server-side-encryption-customer-key-md5":
                base64.b64encode(hashlib.md5(key).digest()).decode()}


def test_sse_c_setup_and_wrong_key():
    """encrypt_setup's metadata opens with the right key through
    sse_read_ctx; a wrong key is refused before any package is read."""
    key = bytes(range(32))
    info = sse.parse_sse_headers(headers(key), "b", "o")
    meta = {}
    plain = plain_of(PKG + 5, 3)
    reader, size, resp = sse.encrypt_setup(
        info, io.BytesIO(plain), len(plain), meta, "b", "o", device="cpu")
    ct = reader.read()
    assert size == len(ct) == sse.enc_size(len(plain))
    assert meta[sse.META_CIPHER] == sse.CIPHER_CHACHA20
    oek, iv, psize, resp2, cipher = sse.sse_read_ctx(
        meta, headers(key), "b", "o", size, device="cpu")
    assert psize == len(plain) and resp2 == resp
    out = BufferSink()
    dw = sse.DecryptWriter(out, oek, iv, 0, 0, psize, "b", "o", cipher,
                           device="cpu")
    dw.write(ct)
    dw.close()
    assert out.getvalue() == plain
    wrong = bytes(range(1, 33))
    with pytest.raises(errors.SSEKeyMismatch):
        sse.sse_read_ctx(meta, headers(wrong), "b", "o", size)
    sealed = base64.b64decode(meta[sse.META_SEALED])
    with pytest.raises(errors.SSEKeyMismatch):
        sse.unseal_object_key(sealed, wrong, "b", "o", device="cpu")
    with pytest.raises(errors.SSEEncryptedObject):
        sse.sse_read_ctx(meta, {}, "b", "o", size)
    assert sse.sse_read_ctx({}, headers(key), "b", "o", size) is None


def test_every_keystream_rides_sse_xor(monkeypatch):
    """The envelope, the full packages and the short tail package all take
    their keystream from the queue's sse_xor; the numpy keystream is a
    test reference only."""
    from minio_tpu_torch.runtime.dispatch import global_queue

    def refuse(*a, **kw):
        raise AssertionError("the numpy keystream ran on an SSE path")

    monkeypatch.setattr(sse.ccp, "keystream_xor", refuse)
    monkeypatch.setattr(sse.ccp, "chacha20_blocks", refuse)
    q = global_queue("cpu")
    q.reset_stats()
    key = bytes(range(32))
    meta = {}
    plain = plain_of(PKG + 5, 6)
    reader, size, _ = sse.encrypt_setup(
        sse.parse_sse_headers(headers(key), "b", "o"), io.BytesIO(plain),
        len(plain), meta, "b", "o", device="cpu")
    ct = reader.read()
    # envelope, one full package, one 5-byte tail
    assert q.stats()["ops"]["sse_xor"]["items"] == 3
    oek, iv, psize, _, cipher = sse.sse_read_ctx(
        meta, headers(key), "b", "o", size, device="cpu")
    out = BufferSink()
    dw = sse.DecryptWriter(out, oek, iv, 0, 0, psize, "b", "o", cipher,
                           device="cpu")
    dw.write(ct)
    dw.close()
    assert out.getvalue() == plain
    assert q.stats()["ops"]["sse_xor"]["items"] == 6


def test_flipped_tag_fails_its_flush_only():
    """17 packages written as 16 + 1: the first flush is emitted, the
    second carries a flipped tag byte and emits nothing."""
    plain = plain_of(17 * PKG, 4)
    ct = bytearray(port_seal(plain))
    ct[-1] ^= 0x40
    out = BufferSink()
    dw = sse.DecryptWriter(out, OEK, IV, 0, 0, len(plain), "b", "o",
                           device="cpu")
    first = 16 * (PKG + sse.TAG)
    dw.write(bytes(ct[:first]))
    assert out.getvalue() == plain[: 16 * PKG]
    dw.write(bytes(ct[first:]))
    with pytest.raises(errors.SSEDecryptError):
        dw.close()
    assert out.getvalue() == plain[: 16 * PKG]


BAD_HEADERS = [
    {"x-amz-server-side-encryption-customer-algorithm": "AES128"},
    {**headers(bytes(32)),
     "x-amz-server-side-encryption-customer-key": "not base64!"},
    headers(bytes(16)),
    {**headers(bytes(32)),
     "x-amz-server-side-encryption-customer-key-md5":
         base64.b64encode(b"x" * 16).decode()},
    {"x-amz-server-side-encryption": "bogus"},
]


@pytest.mark.parametrize("hdr", BAD_HEADERS,
                         ids=["algo", "b64", "short", "md5", "sse"])
def test_header_errors_match_jax(hdr):
    with pytest.raises(dt.ObjectAPIError) as want:
        jsse.parse_sse_headers(hdr, "b", "o")
    with pytest.raises(errors.ObjectAPIError) as got:
        sse.parse_sse_headers(hdr, "b", "o")
    assert type(got.value).__name__ == type(want.value).__name__
    assert (got.value.code, got.value.http_status) == \
        (want.value.code, want.value.http_status)


def test_unported_schemes_and_cipher_raise():
    """The schemes and the cipher this test once found unported: the
    SSE-S3 and SSE-KMS headers parse as the JAX package parses them (a
    malformed KMS context raises its error), the AES-256-GCM package
    stream is the JAX package's bytes, and an untagged object is still
    AES-GCM. An unknown cipher name raises in both."""
    ctx = base64.b64encode(b'{"b": 2, "a": [1]}').decode()
    for hdr in ({"x-amz-server-side-encryption": "AES256"},
                {"x-amz-server-side-encryption": "aws:kms"},
                {"x-amz-server-side-encryption": "aws:kms",
                 "x-amz-server-side-encryption-aws-kms-key-id": "k1",
                 "x-amz-server-side-encryption-context": ctx}):
        got = sse.parse_sse_headers(hdr, "b", "o")
        want = jsse.parse_sse_headers(hdr, "b", "o")
        assert (got.scheme, got.key, got.key_md5, got.kms_key_id,
                got.kms_context) == (want.scheme, want.key, want.key_md5,
                                     want.kms_key_id, want.kms_context)
    assert got.kms_context == '{"a":[1],"b":2}'
    for bad in ("not b64!", base64.b64encode(b"[1, 2]").decode(),
                base64.b64encode(b"{oops").decode()):
        hdr = {"x-amz-server-side-encryption": "aws:kms",
               "x-amz-server-side-encryption-context": bad}
        with pytest.raises(dt.ObjectAPIError) as want:
            jsse.parse_sse_headers(hdr, "b", "o")
        with pytest.raises(errors.InvalidSSEContext) as got:
            sse.parse_sse_headers(hdr, "b", "o")
        assert (got.value.code, got.value.http_status) == \
            (want.value.code, want.value.http_status)
    plain = plain_of(PKG + 9, 5)
    assert sse.EncryptReader(io.BytesIO(plain), OEK, IV, sse.CIPHER_AESGCM,
                             device="cpu").read() == \
        jsse.EncryptReader(io.BytesIO(plain), OEK, IV,
                           jsse.CIPHER_AESGCM).read()
    assert sse.cipher_of({}) == jsse.cipher_of({}) == sse.CIPHER_AESGCM
    with pytest.raises(ValueError, match="unknown SSE package cipher"):
        sse.package_cipher("ROT13", OEK, IV, device="cpu")
    for a, b in ((errors.SSEEncryptedObject, dt.SSEEncryptedObject),
                 (errors.SSEDecryptError, dt.SSEDecryptError),
                 (errors.InvalidSSEContext, dt.InvalidSSEContext),
                 (errors.KMSNotAvailable, dt.KMSNotAvailable)):
        assert (a.code, a.http_status) == (b.code, b.http_status)


def test_sse_xor_op_batches_objects_under_their_own_keys():
    """Three objects' packages, each under its own key, share one flush;
    each result is its own copy; shared nonce words are enforced."""
    # the bucket flushes when the third item arrives, never on a timer
    q = DispatchQueue(device="cpu", max_batch=3, max_delay=3600.0)
    rng = np.random.default_rng(6)
    items = []
    for j in range(3):
        key = rng.bytes(32)
        nonces = np.stack([jccp.nonce_words(IV[:8] + bytes([0, 0, 0, s]))
                           for s in range(2)])
        data = rng.integers(0, 2**32, (2, 64), dtype=np.uint64).astype(
            np.uint32)
        items.append((key, nonces, data))
    try:
        futs = [q.sse_xor(d, k, n) for k, n, d in items]
        res = [f.result(timeout=60) for f in futs]
        st = q.stats()["ops"]["sse_xor"]
        assert st == {"batches": 1, "items": 3}
        for (key, nonces, data), (ct, pk) in zip(items, res):
            want_ct, want_pk = jccp.keystream_xor(
                key, nonces, data.view(np.uint8).reshape(2, -1))
            assert ct.base is None and pk.base is None
            assert np.array_equal(ct.view(np.uint8).reshape(2, -1), want_ct)
            assert np.array_equal(pk.view(np.uint8).reshape(2, -1), want_pk)
        bad = items[0][1].copy()
        bad[1, 0] ^= 1
        with pytest.raises(ValueError, match="nonce words 0/1"):
            q.sse_xor(items[0][2], items[0][0], bad)
    finally:
        q.stop()
    assert not any(lane.thread.is_alive() for lane in q._lanes())
