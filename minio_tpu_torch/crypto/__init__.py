"""Server-side encryption (SSE-C, SSE-S3, SSE-KMS), the port of
minio_tpu.crypto: envelope encryption with a random per-object key (OEK)
sealed by the customer's key (SSE-C) or a KMS data key (SSE-S3, SSE-KMS),
and a package stream (64 KiB packages, sequence numbers bound into nonce
and AAD) under ChaCha20-Poly1305, whose keystream runs on the card through
the dispatch op ``sse_xor``, or AES-256-GCM on the host's native engine."""
from .aesgcm import AESGCM, InvalidTag
from .kms import (KESClient, KMS, KMSError, KMSUnreachable, LocalKMS,
                  VaultClient, configure, get_kms, set_kms)
from .sse import (CIPHER_AESGCM, CIPHER_CHACHA20, META_CIPHER, META_SCHEME,
                  PKG_SIZE, DecryptWriter, EncryptReader, SSEInfo, cipher_of,
                  decrypt_range_bounds, default_cipher, enc_size,
                  encrypt_setup, package_cipher, parse_sse_headers,
                  plain_size_of, seal_object_key, sse_kms_context,
                  sse_read_ctx, unseal_object_key)

__all__ = [
    "AESGCM", "InvalidTag",
    "KESClient", "KMS", "KMSError", "KMSUnreachable", "LocalKMS",
    "VaultClient", "configure", "get_kms", "set_kms",
    "CIPHER_AESGCM", "CIPHER_CHACHA20", "META_CIPHER", "META_SCHEME",
    "PKG_SIZE", "DecryptWriter", "EncryptReader", "SSEInfo", "cipher_of",
    "decrypt_range_bounds", "default_cipher", "enc_size", "encrypt_setup",
    "package_cipher", "parse_sse_headers", "plain_size_of",
    "seal_object_key", "sse_kms_context", "sse_read_ctx",
    "unseal_object_key",
]
