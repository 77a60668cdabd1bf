"""The port's ChaCha20 (minio_tpu_torch.ops.chacha_torch / chacha_cuda, whose
CPU route is the plain version) and its Poly1305 copy held to the JAX
package byte for byte: the numpy keystream of crypto/chacha20poly1305.py
over several shapes, the Pallas kernels in interpret mode at one toy shape
each (~2.5 s each on a CPU), and the RFC 8439 §2.8.2 AEAD vector."""
import numpy as np
import pytest
import torch

from minio_tpu.crypto import chacha20poly1305 as jccp
from minio_tpu.ops import chacha_pallas
from minio_tpu_torch.crypto import chacha20poly1305 as ccp
from minio_tpu_torch.ops import chacha_cuda, chacha_torch


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def u8(t):
    return t.numpy().view(np.uint8)


def inputs(items, pkgs, w, seed):
    """Keys with the top bit set in every word, nonce word 2 counting down
    from 2**32 - 1 (package sequence numbers at the top of their range)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, (items, 8), dtype=np.uint64).astype(
        np.uint32) | np.uint32(0x80000000)
    nonces = rng.integers(0, 2**32, (items, 1, 3), dtype=np.uint64).astype(
        np.uint32).repeat(pkgs, axis=1)
    nonces[:, :, 2] = np.uint32(2**32 - 1) - np.arange(pkgs, dtype=np.uint32)
    data = rng.integers(0, 2**32, (items, pkgs, w), dtype=np.uint64).astype(
        np.uint32)
    return keys, nonces, data


@pytest.mark.parametrize("items,pkgs,w", [(1, 1, 16), (2, 3, 64),
                                          (3, 2, 256), (1, 4, 1024)])
def test_multi_xor_matches_numpy(items, pkgs, w):
    keys, nonces, data = inputs(items, pkgs, w, items * pkgs + w)
    for fn in (chacha_torch.multi_xor, chacha_cuda.chacha20_xor):
        out, pk = fn(t32(keys), t32(nonces), t32(data))
        for i in range(items):
            ref_ct, ref_pk = jccp.keystream_xor(
                keys[i].tobytes(), nonces[i],
                data[i].view(np.uint8).reshape(pkgs, w * 4))
            assert np.array_equal(u8(out[i]).reshape(pkgs, -1), ref_ct)
            assert np.array_equal(u8(pk[i]).reshape(pkgs, 32), ref_pk)


def test_xor_packages_matches_numpy_and_checks_nonces():
    keys, nonces, data = inputs(1, 5, 128, 3)
    key = keys[0].tobytes()
    ref_ct, ref_pk = jccp.keystream_xor(
        key, nonces[0], data[0].view(np.uint8).reshape(5, -1))
    for fn in (chacha_torch.xor_packages, chacha_cuda.xor_packages):
        out, pk = fn(key, t32(nonces[0]), t32(data[0]))
        assert np.array_equal(u8(out).reshape(5, -1), ref_ct)
        assert np.array_equal(u8(pk).reshape(5, 32), ref_pk)
        bad = nonces[0].copy()
        bad[3, 1] ^= 1
        with pytest.raises(ValueError, match="nonce words 0/1"):
            fn(key, t32(bad), t32(data[0]))


def test_wrappers_refuse_bad_shapes():
    keys, nonces, data = inputs(2, 2, 64, 4)
    with pytest.raises(ValueError):  # W not a multiple of 16 words
        chacha_cuda.chacha20_xor(t32(keys), t32(nonces), t32(data[..., :60]))
    with pytest.raises(ValueError):  # keys of another item count
        chacha_cuda.chacha20_xor(t32(keys[:1]), t32(nonces), t32(data))
    with pytest.raises(TypeError):
        chacha_cuda.chacha20_xor(t32(keys).long(), t32(nonces), t32(data))


def test_multi_xor_matches_pallas_multi_kernel():
    keys, nonces, data = inputs(2, 2, 32, 5)
    want_ct, want_pk = chacha_pallas.multi_fn_for(2, 32, interpret=True)(
        keys, nonces, data)
    out, pk = chacha_torch.multi_xor(t32(keys), t32(nonces), t32(data))
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(want_ct))
    assert np.array_equal(pk.numpy().view(np.uint32), np.asarray(want_pk))


def test_xor_packages_matches_pallas_single_kernel():
    keys, nonces, data = inputs(1, 1, 16, 6)
    want_ct, want_pk = chacha_pallas.xor_packages_device(
        keys[0].tobytes(), nonces[0], data[0])
    out, pk = chacha_torch.xor_packages(keys[0].tobytes(), t32(nonces[0]),
                                        t32(data[0]))
    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(want_ct))
    assert np.array_equal(pk.numpy().view(np.uint32), np.asarray(want_pk))


def test_poly1305_copy_matches_jax():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    msgs = rng.integers(0, 256, (5, 16 * 67), dtype=np.uint8)
    tags = ccp.poly1305_tags(keys, msgs)
    assert np.array_equal(tags, jccp.poly1305_tags(keys, msgs))
    for i in range(5):
        for ln in (0, 1, 15, 16, 17, 16 * 67):
            msg = msgs[i, :ln].tobytes()
            assert ccp.poly1305_tag(keys[i].tobytes(), msg) == \
                jccp.poly1305_tag(keys[i].tobytes(), msg)
        assert tags[i].tobytes() == ccp.poly1305_tag(keys[i].tobytes(),
                                                     msgs[i].tobytes())


# RFC 8439 §2.8.2: ChaCha20-Poly1305 AEAD test vector
RFC_KEY = bytes(range(0x80, 0xA0))
RFC_NONCE = bytes.fromhex("070000004041424344454647")
RFC_AAD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
RFC_PLAIN = (b"Ladies and Gentlemen of the class of '99: If I could offer "
             b"you only one tip for the future, sunscreen would be it.")
RFC_CT = bytes.fromhex(
    "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
    "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
    "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
    "3ff4def08e4b7a9de576d26586cec64b6116")
RFC_TAG = bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")


def test_aead_rfc8439_vector():
    sealed = ccp.seal_one(RFC_KEY, RFC_NONCE, RFC_AAD, RFC_PLAIN)
    assert sealed == RFC_CT + RFC_TAG
    assert sealed == jccp.seal_one(RFC_KEY, RFC_NONCE, RFC_AAD, RFC_PLAIN)
    assert ccp.open_one(RFC_KEY, RFC_NONCE, RFC_AAD, sealed) == RFC_PLAIN
    with pytest.raises(ccp.BadTag):
        ccp.open_one(RFC_KEY, RFC_NONCE, RFC_AAD,
                     sealed[:-1] + bytes([sealed[-1] ^ 1]))
