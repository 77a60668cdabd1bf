"""ChaCha20-Poly1305 (RFC 8439) on numpy — the port's copy of
minio_tpu/crypto/chacha20poly1305.py (the port imports nothing of the JAX
package, not even this numpy module).

What each part serves in the port:

- ``chacha20_blocks`` / ``keystream_xor`` — the numpy keystream, the
  reference the ChaCha20 kernel (ops/chacha_cuda.py, K4) and its plain
  PyTorch version (ops/chacha_torch.py) are pinned to in tests. No path
  of the port takes it: every keystream of crypto/sse.py rides the
  dispatch op ``sse_xor``.
- ``poly1305_tag`` (scalar bigint; crypto/sse.py tags a short tail package
  and the OEK envelope with it) and ``poly1305_tags`` (batched: strided
  streams in 5x26-bit numpy limbs, log-tree stream combine) — the tag is
  130-bit arithmetic and stays on the host, as in the JAX package.
- ``seal_one`` / ``open_one`` — scalar AEAD on the numpy keystream: the
  semantic reference for the seal/open of crypto/sse.py in tests.
"""
from __future__ import annotations

import struct

import numpy as np

_CONSTS = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574],
                   np.uint32)
P1305 = (1 << 130) - 5
_M26 = (1 << 26) - 1
#: the batched Poly1305's Horner streams per message: at most this many,
#: as few Horner steps as that allows, and as many streams as those steps
#: need (a 64 KiB package's 4,099 chunks: 5 steps of 820 streams, then a
#: 10-round combine). Few rounds over wide arrays keep the numpy calls per
#: tag, and so the interpreter-lock hand-offs between request threads, low.
_STREAMS = 1024


# --------------------------------------------------------------------------
# ChaCha20 (vectorized across block lanes)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _qr(s, a: int, b: int, c: int, d: int):
    s[a] = s[a] + s[b]
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = s[c] + s[d]
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = s[a] + s[b]
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = s[c] + s[d]
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha20_blocks(key: bytes, nonces: np.ndarray,
                    counters: np.ndarray) -> np.ndarray:
    """64-byte keystream blocks, vectorized: ``nonces`` uint32 [N, 3]
    (the RFC's three LE nonce words), ``counters`` uint32 [N] ->
    keystream uint32 [N, 16] (LE words, lane i = block for
    (nonce_i, counter_i))."""
    kw = np.frombuffer(key, "<u4")
    n = len(counters)
    s = [np.broadcast_to(_CONSTS[i], (n,)).copy() for i in range(4)]
    s += [np.broadcast_to(kw[i], (n,)).copy() for i in range(8)]
    s.append(counters.astype(np.uint32).copy())
    s += [nonces[:, i].astype(np.uint32).copy() for i in range(3)]
    init = [w.copy() for w in s]
    for _ in range(10):
        _qr(s, 0, 4, 8, 12)
        _qr(s, 1, 5, 9, 13)
        _qr(s, 2, 6, 10, 14)
        _qr(s, 3, 7, 11, 15)
        _qr(s, 0, 5, 10, 15)
        _qr(s, 1, 6, 11, 12)
        _qr(s, 2, 7, 8, 13)
        _qr(s, 3, 4, 9, 14)
    return np.stack([s[i] + init[i] for i in range(16)], axis=1)


def nonce_words(nonce12: bytes) -> np.ndarray:
    """A 12-byte nonce as the RFC's three LE uint32 words."""
    return np.frombuffer(nonce12, "<u4").copy()


def keystream_xor(key: bytes, nonces: np.ndarray, data: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """XOR ``data`` uint8 [P, L] (L a 64-multiple; a package padded to it)
    with each package's ChaCha20 keystream (counters 1..L/64 under
    ``nonces`` uint32 [P, 3]) and return (xored uint8 [P, L], poly_keys
    uint8 [P, 32] — the first 32 bytes of each package's counter-0
    block). Pure numpy: the reference the ChaCha20 kernel and its plain
    PyTorch version are pinned to."""
    pkgs, ln = data.shape
    if ln % 64:
        raise ValueError("keystream_xor needs 64-byte-multiple packages")
    nb = ln // 64
    ctrs = np.tile(np.arange(nb + 1, dtype=np.uint32), pkgs)
    lanes = np.repeat(nonces, nb + 1, axis=0)
    ks = chacha20_blocks(key, lanes, ctrs).reshape(pkgs, nb + 1, 16)
    poly_keys = ks[:, 0, :8].astype("<u4").view(np.uint8).reshape(pkgs, 32)
    stream = ks[:, 1:, :].reshape(pkgs, nb * 16).astype("<u4")
    out = data.view("<u4").reshape(pkgs, nb * 16) ^ stream
    return out.view(np.uint8).reshape(pkgs, ln), poly_keys


# --------------------------------------------------------------------------
# Poly1305


def _clamp_r(key16: bytes | np.ndarray) -> int:
    r = int.from_bytes(bytes(key16), "little")
    return r & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF


def poly1305_tag(key32: bytes, msg: bytes) -> bytes:
    """Scalar RFC 8439 Poly1305 — the bigint reference the batched limb
    implementation is pinned against."""
    r = _clamp_r(key32[:16])
    s = int.from_bytes(key32[16:32], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        chunk = msg[i:i + 16]
        n = int.from_bytes(chunk, "little") + (1 << (8 * len(chunk)))
        acc = ((acc + n) * r) % P1305
    return ((acc + s) % (1 << 128)).to_bytes(16, "little")


def _limbs_of(v: int) -> np.ndarray:
    return np.array([(v >> (26 * i)) & _M26 for i in range(5)], np.uint64)


def _limb_mul(a: list[np.ndarray], b: np.ndarray) -> list[np.ndarray]:
    """5x26-bit limb mulmod 2^130-5: ``a`` limbs (arrays, < 2^28), ``b``
    limbs (< 2^26, broadcastable). Result carried back under 2^27."""
    a0, a1, a2, a3, a4 = a
    b0, b1, b2, b3, b4 = (b[i] for i in range(5))
    five = np.uint64(5)
    d0 = a0 * b0 + five * (a1 * b4 + a2 * b3 + a3 * b2 + a4 * b1)
    d1 = a0 * b1 + a1 * b0 + five * (a2 * b4 + a3 * b3 + a4 * b2)
    d2 = a0 * b2 + a1 * b1 + a2 * b0 + five * (a3 * b4 + a4 * b3)
    d3 = a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0 + five * (a4 * b4)
    d4 = a0 * b4 + a1 * b3 + a2 * b2 + a3 * b1 + a4 * b0
    m26 = np.uint64(_M26)
    c = d0 >> np.uint64(26); d0 &= m26; d1 += c                # noqa: E702
    c = d1 >> np.uint64(26); d1 &= m26; d2 += c                # noqa: E702
    c = d2 >> np.uint64(26); d2 &= m26; d3 += c                # noqa: E702
    c = d3 >> np.uint64(26); d3 &= m26; d4 += c                # noqa: E702
    c = d4 >> np.uint64(26); d4 &= m26; d0 += five * c         # noqa: E702
    c = d0 >> np.uint64(26); d0 &= m26; d1 += c                # noqa: E702
    return [d0, d1, d2, d3, d4]


def _limb_add(a: list[np.ndarray], b: list[np.ndarray]) -> list[np.ndarray]:
    return [x + y for x, y in zip(a, b)]


def _chunk_limbs(chunks: np.ndarray) -> list[np.ndarray]:
    """uint8 [..., 16] full chunks -> five uint64 limb arrays [...] of
    le128(chunk) + 2^128."""
    w = chunks.view("<u4").astype(np.uint64)
    w0, w1, w2, w3 = (w[..., i] for i in range(4))
    m26 = np.uint64(_M26)
    return [
        w0 & m26,
        ((w0 >> np.uint64(26)) | (w1 << np.uint64(6))) & m26,
        ((w1 >> np.uint64(20)) | (w2 << np.uint64(12))) & m26,
        ((w2 >> np.uint64(14)) | (w3 << np.uint64(18))) & m26,
        (w3 >> np.uint64(8)) | np.uint64(1 << 24),
    ]


def poly1305_tags(keys: np.ndarray, msgs: np.ndarray) -> np.ndarray:
    """Batched Poly1305: ``keys`` uint8 [P, 32], ``msgs`` uint8 [P, M]
    with M a 16-multiple -> tags uint8 [P, 16]. The sequential Horner
    chain is split into k interleaved streams per message (multiplier
    r^k), each advanced with vectorized 5x26-bit limb mulmods, then the
    streams are folded with a log-tree of r^(2^m) combines — bit-identical
    to the scalar reference (pinned)."""
    pkgs, mlen = msgs.shape
    if mlen % 16:
        raise ValueError("batched poly1305 needs 16-multiple messages")
    n = mlen // 16
    t_steps = max(1, -(-n // _STREAMS))
    k = max(1, -(-n // t_steps))
    pad = t_steps * k - n
    rs = [_clamp_r(keys[p, :16]) for p in range(pkgs)]
    # r^k per package (stream multiplier), r^(2^m) for the combine tree
    rk = np.stack([_limbs_of(pow(r, k, P1305)) for r in rs], axis=1)
    rk = rk[:, :, None]                      # [5, P, 1] broadcast limbs
    chunks = msgs.reshape(pkgs, n, 16)
    limbs = _chunk_limbs(chunks)             # five [P, n]
    if pad:
        # PREPEND literal-zero chunks: leading zeros do not change the
        # polynomial, and every stream gets exactly t_steps chunks
        limbs = [np.concatenate(
            [np.zeros((pkgs, pad), np.uint64), li], axis=1) for li in limbs]
    limbs = [li.reshape(pkgs, t_steps, k) for li in limbs]
    acc = [np.zeros((pkgs, k), np.uint64) for _ in range(5)]
    for t in range(t_steps):
        # Horner per stream: S = S * r^k + chunk. The mul's carry chain
        # re-normalizes limbs under 2^27 every step, so the single add
        # (< 2^26 per limb) can never drift out of uint64 headroom.
        acc = _limb_mul(acc, rk)
        acc = _limb_add(acc, [li[:, t, :] for li in limbs])
    # log-tree combine of V = sum_j S_j r^(w-1-j) over the w streams; the
    # tag's value is V * r. An odd width takes a zero stream in front (a
    # zero term of the highest power changes nothing).
    width = k
    m = 0
    while width > 1:
        if width % 2:
            acc = [np.concatenate([np.zeros((pkgs, 1), np.uint64), a],
                                  axis=1) for a in acc]
            width += 1
        rp = np.stack([_limbs_of(pow(r, 1 << m, P1305)) for r in rs],
                      axis=1)[:, :, None]
        half = width // 2
        left = [a.reshape(pkgs, half, 2)[:, :, 0] for a in acc]
        right = [a.reshape(pkgs, half, 2)[:, :, 1] for a in acc]
        # order within a pair: higher-j streams carry LOWER powers of r;
        # A_i = S_{2i} * r^(2^m) + S_{2i+1}
        acc = _limb_add(_limb_mul(left, rp), right)
        width = half
        m += 1
    out = np.empty((pkgs, 16), np.uint8)
    for p in range(pkgs):
        v = sum(int(acc[i][p, 0]) << (26 * i) for i in range(5))
        v = (v * rs[p]) % P1305
        s = int.from_bytes(bytes(keys[p, 16:32]), "little")
        out[p] = np.frombuffer(
            ((v + s) % (1 << 128)).to_bytes(16, "little"), np.uint8)
    return out


# --------------------------------------------------------------------------
# AEAD (RFC 8439 §2.8)


def _pad16(n: int) -> bytes:
    return b"\x00" * (-n % 16)


def mac_data(aad: bytes, ct: bytes | memoryview) -> bytes:
    """The Poly1305 input for one AEAD package: aad || pad16 || ct ||
    pad16 || le64(len(aad)) || le64(len(ct))."""
    ct = bytes(ct)
    return (aad + _pad16(len(aad)) + ct + _pad16(len(ct)) +
            struct.pack("<QQ", len(aad), len(ct)))


def mac_datas(aads: list[bytes], cts: np.ndarray) -> np.ndarray:
    """Batched ``mac_data`` for equal-size packages: ``cts`` uint8 [P, L]
    with L a 16-multiple -> uint8 [P, A + L + 16] (A = padded aad)."""
    pkgs, ln = cts.shape
    if ln % 16:
        raise ValueError("batched mac needs 16-multiple ciphertext")
    alen = len(aads[0])
    apad = -alen % 16
    out = np.zeros((pkgs, alen + apad + ln + 16), np.uint8)
    for p, aad in enumerate(aads):
        out[p, :alen] = np.frombuffer(aad, np.uint8)
    out[:, alen + apad:alen + apad + ln] = cts
    out[:, -16:] = np.frombuffer(
        struct.pack("<QQ", alen, ln), np.uint8)
    return out


def _xor_one(key: bytes, nonce: bytes, data: bytes) -> tuple[bytes, bytes]:
    """(keystream-XORed data, 32-byte poly key) for ONE package of any
    length (tail packages)."""
    pad = -len(data) % 64
    arr = np.frombuffer(data + b"\x00" * pad, np.uint8).reshape(1, -1) \
        if data else np.zeros((1, 0), np.uint8)
    nw = nonce_words(nonce).reshape(1, 3)
    if arr.shape[1]:
        out, pk = keystream_xor(key, nw, arr)
        return out[0, :len(data)].tobytes(), pk[0].tobytes()
    ks = chacha20_blocks(key, nw, np.zeros(1, np.uint32))
    return b"", ks[0, :8].astype("<u4").tobytes()


def seal_one(key: bytes, nonce: bytes, aad: bytes, plain: bytes) -> bytes:
    """Scalar ChaCha20-Poly1305 seal: ciphertext || 16-byte tag."""
    ct, pk = _xor_one(key, nonce, plain)
    return ct + poly1305_tag(pk, mac_data(aad, ct))


class BadTag(Exception):
    """AEAD tag verification failed."""


def open_one(key: bytes, nonce: bytes, aad: bytes, sealed: bytes) -> bytes:
    """Scalar ChaCha20-Poly1305 open; raises BadTag on verify failure."""
    if len(sealed) < 16:
        raise BadTag("short package")
    ct, tag = sealed[:-16], sealed[-16:]
    _, pk = _xor_one(key, nonce, b"")
    want = poly1305_tag(pk, mac_data(aad, ct))
    if not _ct_eq(want, tag):
        raise BadTag("poly1305 tag mismatch")
    plain, _ = _xor_one(key, nonce, ct)
    return plain


def _ct_eq(a: bytes, b: bytes) -> bool:
    import hmac
    return hmac.compare_digest(a, b)
