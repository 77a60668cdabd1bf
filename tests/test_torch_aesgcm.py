"""The port's AES-256-GCM (native/aesgcm.cpp through crypto/aesgcm.py, and
the SSE package cipher AES256-GCM on it) held to the ``cryptography``
wheel's ``AESGCM`` and to the JAX package's package stream: the same key,
nonce, AAD and plaintext give the same ciphertext || tag; a flipped bit
anywhere fails the tag and releases nothing; the engine refuses a CPU
without AES-NI/PCLMULQDQ instead of falling back."""
import io
import struct

import numpy as np
import pytest
from cryptography.exceptions import InvalidTag as WheelInvalidTag
from cryptography.hazmat.primitives.ciphers.aead import AESGCM as WheelAESGCM
from hypothesis import given, settings
from hypothesis import strategies as st

from minio_tpu.crypto import sse as jsse
from minio_tpu_torch import native
from minio_tpu_torch.crypto import sse
from minio_tpu_torch.crypto.aesgcm import AESGCM, InvalidTag
from minio_tpu_torch.erasure.streaming import BufferSink
from minio_tpu_torch.utils import errors

PKG = sse.PKG_SIZE
RNG = np.random.default_rng(20261018)
KEY = RNG.bytes(32)
NONCE = RNG.bytes(12)
OEK = bytes(range(64, 96))
IV = bytes(range(200, 212))
LENGTHS = [0, 1, 15, 16, 17, 65_536, 65_541]


def data(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed + n).bytes(n)


@pytest.mark.parametrize("aad", [b"", b"minio-tpu-sse-v1\x00\x00\x00\x07"],
                         ids=["no-aad", "aad"])
@pytest.mark.parametrize("n", LENGTHS)
def test_seal_equals_the_wheel(n, aad):
    pt = data(n)
    want = WheelAESGCM(KEY).encrypt(NONCE, pt, aad or None)
    assert AESGCM(KEY).encrypt(NONCE, pt, aad or None) == want
    assert AESGCM(KEY).decrypt(NONCE, want, aad or None) == pt


@pytest.mark.parametrize("part", ["tag", "aad", "nonce", "ciphertext"])
def test_a_flipped_bit_fails_the_tag(part):
    pt, aad = data(1000, 1), b"context"
    sealed = bytearray(AESGCM(KEY).encrypt(NONCE, pt, aad))
    nonce = bytearray(NONCE)
    if part == "tag":
        sealed[-3] ^= 0x10
    elif part == "ciphertext":
        sealed[500] ^= 0x01
    elif part == "nonce":
        nonce[11] ^= 0x80
    else:
        aad = b"Context"
    with pytest.raises(InvalidTag):
        AESGCM(KEY).decrypt(bytes(nonce), bytes(sealed), aad)
    with pytest.raises(WheelInvalidTag):
        WheelAESGCM(KEY).decrypt(bytes(nonce), bytes(sealed), aad)


def test_short_inputs_and_bad_sizes():
    with pytest.raises(InvalidTag):
        AESGCM(KEY).decrypt(NONCE, b"x" * 15, b"")
    with pytest.raises(ValueError):
        AESGCM(KEY[:16])
    with pytest.raises(ValueError):
        AESGCM(KEY).encrypt(NONCE[:8], b"x", b"")


@settings(max_examples=25, deadline=None)
@given(n=st.integers(0, 70_000), aad_len=st.integers(0, 40),
       seed=st.integers(0, 2**32 - 1))
def test_any_length_equals_the_wheel(n, aad_len, seed):
    rng = np.random.default_rng(seed)
    key, nonce = rng.bytes(32), rng.bytes(12)
    pt, aad = rng.bytes(n), rng.bytes(aad_len)
    want = WheelAESGCM(key).encrypt(nonce, pt, aad)
    assert AESGCM(key).encrypt(nonce, pt, aad) == want
    assert AESGCM(key).decrypt(nonce, want, aad) == pt


def test_package_entries_derive_nonce_and_aad_per_sequence():
    """One native call seals a block of packages, each under
    base_iv[:8] || BE32(seq) and "minio-tpu-sse-v1" || BE32(seq); an open
    with one bad tag names it and decrypts nothing."""
    pkgs = [data(PKG, i) for i in range(3)] + [data(77, 9)]
    seq0 = 0xFFFFFFFE  # the sequence number wraps as BE32 does
    views = native.aesgcm_seal_pkgs(OEK, IV, seq0, pkgs)
    for i, (p, v) in enumerate(zip(pkgs, views)):
        seq = (seq0 + i) & 0xFFFFFFFF
        assert bytes(v) == WheelAESGCM(OEK).encrypt(
            IV[:8] + struct.pack(">I", seq), p,
            b"minio-tpu-sse-v1" + struct.pack(">I", seq))
    sealed = [bytes(v) for v in views]
    bad, plain = native.aesgcm_open_pkgs(OEK, IV, seq0, sealed)
    assert bad == -1 and [bytes(p) for p in plain] == pkgs
    sealed[2] = sealed[2][:-1] + bytes([sealed[2][-1] ^ 1])
    assert native.aesgcm_open_pkgs(OEK, IV, seq0, sealed) == (2, [])
    assert native.aesgcm_open_pkgs(OEK, IV, seq0, [b"short"]) == (0, [])


@pytest.mark.parametrize("size", [0, 1, PKG - 1, PKG, PKG + 1,
                                  (1 << 20) + 7])
def test_package_stream_equals_jax(size):
    plain = data(size, 3)
    want = jsse.EncryptReader(io.BytesIO(plain), OEK, IV,
                              cipher=jsse.CIPHER_AESGCM).read()
    got = sse.EncryptReader(io.BytesIO(plain), OEK, IV,
                            cipher=sse.CIPHER_AESGCM, device="cpu").read()
    assert len(got) == sse.enc_size(size) and got == want
    for off, ln in ((0, -1), (PKG - 3, 70_001), (size // 2, 5),
                    (max(size - 1, 0), 1)):
        eo, el, seq0, skip = sse.decrypt_range_bounds(off, ln, size)
        assert (eo, el, seq0, skip) == jsse.decrypt_range_bounds(off, ln,
                                                                 size)
        limit = size - off if ln < 0 else min(ln, max(size - off, 0))
        out = BufferSink()
        dw = sse.DecryptWriter(out, OEK, IV, seq0, skip, limit,
                               cipher=sse.CIPHER_AESGCM, device="cpu")
        dw.write(want[eo:eo + el])
        dw.close()
        jout = io.BytesIO()
        jdw = jsse.DecryptWriter(jout, OEK, IV, seq0, skip, limit,
                                 cipher=jsse.CIPHER_AESGCM)
        jdw.write(want[eo:eo + el])
        jdw.finish()
        assert out.getvalue() == jout.getvalue() == \
            plain[off:off + limit]


def test_jax_default_cipher_objects_read_through_the_port():
    """The re-anchor's reproduction of the cross-read fault: a package
    stream the JAX package seals under its default cipher opens through
    the port's DecryptWriter; the reverse holds too."""
    assert jsse.default_cipher() == jsse.CIPHER_AESGCM  # the wheel is here
    plain = b"x" * 1000
    oek, iv = bytes(range(32)), bytes(32)
    ct = jsse.EncryptReader(io.BytesIO(plain), oek, iv).read()
    out = BufferSink()
    dw = sse.DecryptWriter(out, oek, iv, 0, 0, len(plain),
                           cipher=jsse.default_cipher(), device="cpu")
    dw.write(ct)
    dw.close()
    assert out.getvalue() == plain
    mine = sse.EncryptReader(io.BytesIO(plain), oek, iv,
                             cipher=sse.CIPHER_AESGCM, device="cpu").read()
    jout = io.BytesIO()
    jdw = jsse.DecryptWriter(jout, oek, iv, 0, 0, len(plain))
    jdw.write(mine)
    jdw.finish()
    assert jout.getvalue() == plain


def test_a_flipped_package_byte_fails_its_flush_only():
    plain = data(17 * PKG, 4)
    ct = bytearray(sse.EncryptReader(io.BytesIO(plain), OEK, IV,
                                     cipher=sse.CIPHER_AESGCM,
                                     device="cpu").read())
    ct[-PKG // 2] ^= 0x40
    out = BufferSink()
    dw = sse.DecryptWriter(out, OEK, IV, 0, 0, len(plain), "b", "o",
                           cipher=sse.CIPHER_AESGCM, device="cpu")
    first = 16 * (PKG + sse.TAG)
    dw.write(bytes(ct[:first]))
    assert out.getvalue() == plain[:16 * PKG]
    dw.write(bytes(ct[first:]))
    with pytest.raises(errors.SSEDecryptError):
        dw.close()
    assert out.getvalue() == plain[:16 * PKG]


def test_cpu_without_aes_ni_raises_at_first_use(monkeypatch):
    """No portable AES: the engine refuses, it does not fall back."""
    lib = native.load_native()

    class NoAES:
        def aesgcm_cpu_ok(self):
            return 0

        def __getattr__(self, name):
            raise AssertionError(f"{name} called on a CPU without AES-NI")

    monkeypatch.setattr(native, "load_native", lambda: NoAES())
    with pytest.raises(native.AESUnavailable, match="AES-NI"):
        AESGCM(KEY).encrypt(NONCE, b"x", b"")
    with pytest.raises(native.AESUnavailable):
        sse.EncryptReader(io.BytesIO(b"x"), OEK, IV, sse.CIPHER_AESGCM,
                          device="cpu").read()
    monkeypatch.undo()
    assert lib.aesgcm_cpu_ok() == 1  # this sandbox and the card's machine

