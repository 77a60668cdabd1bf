"""AES-256-GCM over the port's native engine (``native/aesgcm.cpp``, AES-NI
and PCLMULQDQ, built into ``libnative.so`` at first use), with the shape of
the ``cryptography`` wheel's ``AESGCM`` that the JAX package uses, so the
SSE envelope and the KMS port line for line: ``AESGCM(key).encrypt(nonce,
data, associated_data)`` returns ciphertext || 16-byte tag and
``.decrypt(...)`` the plaintext or raises ``InvalidTag``. Keys are 32 bytes
and nonces 12 (all the JAX package uses); the bytes equal the wheel's.

A CPU without AES-NI or PCLMULQDQ raises ``native.AESUnavailable`` at the
first call: there is no portable AES."""
from __future__ import annotations

from .. import native


class InvalidTag(Exception):
    """The tag did not verify: wrong key, nonce or associated data, or a
    modified ciphertext. Nothing was decrypted."""


class AESGCM:
    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("AESGCM key must be 256 bits")
        self._key = bytes(key)

    def encrypt(self, nonce: bytes, data, associated_data) -> bytes:
        return native.aesgcm_seal(self._key, nonce, associated_data or b"",
                                  data)

    def decrypt(self, nonce: bytes, data, associated_data) -> bytes:
        out = native.aesgcm_open(self._key, nonce, associated_data or b"",
                                 data)
        if out is None:
            raise InvalidTag
        return out
