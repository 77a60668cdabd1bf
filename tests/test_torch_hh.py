"""The port's HighwayHash-256 (the plain PyTorch ``ops/hh_torch.py``, the
``ops/hh_cuda.py`` wrapper's CPU route, and the host ``native/hhpy.py``)
held to the JAX package byte for byte: its native C++ library (pinned to
the published test vectors) at chunk lengths with and without a remainder
and odd chunk counts, and ``hh_jax`` at two lengths (each new length costs
~8 s of jit on a CPU)."""
import numpy as np
import pytest
import torch

from minio_tpu.native import highwayhash as jhh
from minio_tpu.ops import hh_jax
from minio_tpu_torch.erasure.bitrot import (DEFAULT_BITROT_ALGO,
                                            HIGHWAY_KEY, BitrotAlgorithm,
                                            default_bitrot_algo,
                                            shard_chunk_digests)
from minio_tpu_torch.native import hhpy
from minio_tpu_torch.ops import hh_cuda, hh_torch

KW = hh_torch.key_words(HIGHWAY_KEY)


def chunks(n, nbytes, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, nbytes),
                                                dtype=np.uint8)


def device_digests(c):
    """hh_torch and the K5 wrapper's CPU route on uint8 [n, L] chunks."""
    words = torch.from_numpy(np.ascontiguousarray(c).view(np.int32))
    out = [fn(KW, c.shape[1], words).numpy().view(np.uint8)
           for fn in (hh_torch.hash256_device_words,
                      hh_cuda.highwayhash256_chunks)]
    assert np.array_equal(out[0], out[1])
    return out[0]


@pytest.mark.parametrize("nbytes,n", [(4, 3), (16, 5), (28, 3), (32, 1),
                                      (36, 7), (60, 3), (64, 5), (1028, 3),
                                      (16384, 3)])
def test_device_hash_matches_native(nbytes, n):
    c = chunks(n, nbytes, nbytes + n)
    want = jhh.hash256_batch(HIGHWAY_KEY, c)
    assert np.array_equal(device_digests(c), want)
    assert np.array_equal(hhpy.hash256_batch(HIGHWAY_KEY, c), want)


def test_host_hash_takes_any_length():
    """The remainder rules for lengths that are not a multiple of 4."""
    for nbytes in (0, 1, 2, 3, 5, 17, 19, 31, 33, 63, 1027):
        c = chunks(3, nbytes, nbytes)
        assert np.array_equal(hhpy.hash256_batch(HIGHWAY_KEY, c),
                              jhh.hash256_batch(HIGHWAY_KEY, c)), nbytes
        h = hhpy.HighwayHash256(HIGHWAY_KEY)
        h.update(c[0, :nbytes // 2].tobytes())
        h.update(c[0, nbytes // 2:].tobytes())
        assert h.digest() == jhh.hash256(HIGHWAY_KEY, c[0].tobytes())


@pytest.mark.parametrize("nbytes", [64, 1028])
def test_device_hash_matches_hh_jax(nbytes):
    c = chunks(3, nbytes, 9)
    assert np.array_equal(device_digests(c),
                          hh_jax.hash256_chunks(HIGHWAY_KEY, c))


def test_batch_shapes_and_guards():
    c = chunks(6, 64, 2)
    words = torch.from_numpy(c.view(np.int32).reshape(2, 3, 16).copy())
    got = hh_torch.hash256_device_words(KW, 64, words)
    assert got.shape == (2, 3, 8)
    assert np.array_equal(got.numpy().view(np.uint8).reshape(6, 32),
                          jhh.hash256_batch(HIGHWAY_KEY, c))
    with pytest.raises(ValueError):
        hh_cuda.highwayhash256_chunks(KW, 62, words[..., :15])
    with pytest.raises(ValueError):
        hh_cuda.highwayhash256_chunks(KW, 64, words[..., :15])
    with pytest.raises(ValueError):
        hh_torch.key_words(b"short")


def test_bitrot_default_and_host_digests(monkeypatch):
    """HIGHWAYHASH256S is the default (MINIO_TPU_BITROT_ALGO overrides it
    with a streaming algorithm, not with the whole-file HIGHWAYHASH256,
    whose hasher is the native one); shard_chunk_digests frames a short
    tail chunk last, as the native hash of each piece."""
    assert DEFAULT_BITROT_ALGO is BitrotAlgorithm.HIGHWAYHASH256S
    monkeypatch.setenv("MINIO_TPU_BITROT_ALGO", "mur3x256S")
    assert default_bitrot_algo() is BitrotAlgorithm.MUR3X256S
    monkeypatch.setenv("MINIO_TPU_BITROT_ALGO", "highwayhash256")
    assert default_bitrot_algo() is BitrotAlgorithm.HIGHWAYHASH256S
    whole = BitrotAlgorithm.HIGHWAYHASH256.new()
    whole.update(b"whole-file shard")
    assert whole.digest() == jhh.hash256(HIGHWAY_KEY, b"whole-file shard")
    shards = chunks(3, 1000 + 64, 4)
    digs = shard_chunk_digests(shards, 1000, 0)
    assert np.array_equal(digs[:, :32],
                          jhh.hash256_batch(HIGHWAY_KEY, shards[:, :1000]))
    assert np.array_equal(digs[:, 32:],
                          jhh.hash256_batch(HIGHWAY_KEY, shards[:, 1000:]))
    h = BitrotAlgorithm.HIGHWAYHASH256S.new()
    h.update(shards[0].tobytes())
    assert h.digest() == jhh.hash256(HIGHWAY_KEY, shards[0].tobytes())
