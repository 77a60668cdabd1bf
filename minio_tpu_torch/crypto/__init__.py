"""Server-side encryption, SSE-C with the ChaCha20-Poly1305 package cipher
(the port of minio_tpu.crypto): envelope encryption with a random
per-object key (OEK) sealed by the customer's key, and a package stream
(64 KiB packages, sequence numbers bound into nonce and AAD) whose
keystream runs on the card through the dispatch op ``sse_xor``."""
from .sse import (CIPHER_AESGCM, CIPHER_CHACHA20, META_CIPHER, META_SCHEME,
                  PKG_SIZE, DecryptWriter, EncryptReader, SSEInfo, cipher_of,
                  decrypt_range_bounds, enc_size, encrypt_setup,
                  package_cipher, parse_sse_headers, plain_size_of,
                  seal_object_key, sse_read_ctx, unseal_object_key)

__all__ = [
    "CIPHER_AESGCM", "CIPHER_CHACHA20", "META_CIPHER", "META_SCHEME",
    "PKG_SIZE", "DecryptWriter", "EncryptReader", "SSEInfo", "cipher_of",
    "decrypt_range_bounds", "enc_size", "encrypt_setup", "package_cipher",
    "parse_sse_headers", "plain_size_of", "seal_object_key", "sse_read_ctx",
    "unseal_object_key",
]
