"""The port's fused launches (minio_tpu_torch.ops.fused) and the dispatch
queue that batches them, held to the JAX package's ops/fused.py byte for
byte. The JAX side runs its jnp MUR3 kernel (MINIO_TPU_MUR3_PALLAS=0) — the
Pallas one compiles in interpret mode for ~30 s per shape on a CPU."""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from minio_tpu.native import mur3py as jmur3py
from minio_tpu.ops import fused as jfused
from minio_tpu.ops import rs_jax
from minio_tpu_torch.erasure.bitrot import HIGHWAY_KEY
from minio_tpu_torch.ops import fused, rs_cuda, rs_torch
from minio_tpu_torch.runtime import dispatch
from minio_tpu_torch.runtime.dispatch import DispatchQueue

K, M = 4, 2
W = 1024          # words per shard (4 KiB)
CHUNK = 1024      # bitrot chunk bytes -> 4 chunks per shard
B = 3


@pytest.fixture(autouse=True)
def _jnp_mur3(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_MUR3_PALLAS", "0")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, (B, K, W), dtype=np.uint64).astype(
        np.uint32)
    jrs = rs_jax.ReedSolomon(K, M, backend="xla")
    trs = rs_torch.ReedSolomon(K, M, device="cpu")
    # one loss pattern per item, two targets each (a bucket keys on o)
    pats = [((1, 2, 3, 4), (0, 5)), ((0, 2, 4, 5), (1, 3)),
            ((0, 1, 2, 3), (4, 5))]
    masks = np.stack([jrs.target_masks_np(p, t) for p, t in pats])
    return words, jrs, trs, masks


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


def test_encode_hashed_matches_jax(setup):
    words, jrs, trs, _ = setup
    jfn = jfused.encode_hashed_fn_for(HIGHWAY_KEY, W * 4,
                                      jrs.encode_words_batch, CHUNK, 1)
    jpar, jdig = (np.asarray(a) for a in jfn(jnp.asarray(words)))
    fn = fused.encode_hashed_fn_for(HIGHWAY_KEY, W * 4,
                                    trs.encode_words_batch, CHUNK, 1)
    par, dig = fn(t32(words))
    assert dig.shape == (B, K + M, (W * 4 // CHUNK) * 8)
    assert np.array_equal(u32(par), jpar)
    assert np.array_equal(u32(dig), jdig)


def _digests(words):
    """Expected per-chunk digest words of [B, r, W], from the JAX
    package's host MUR3X256 (native/mur3py)."""
    rows = words.shape[1]
    d = jmur3py.hash256_batch(
        HIGHWAY_KEY, np.ascontiguousarray(words).view(np.uint8)
        .reshape(-1, CHUNK))
    return d.view(np.uint32).reshape(B, rows, -1).copy()


@pytest.mark.parametrize("corrupt", [None, (1, 2), (0, 0)])
def test_fused_matches_jax(setup, corrupt):
    """valid is False at exactly the corrupted (item, shard) index."""
    words, jrs, _, masks = setup
    digs = _digests(words)
    if corrupt is not None:
        digs[corrupt[0], corrupt[1], 3] ^= 1
    jfn = jfused.fused_fn_for(HIGHWAY_KEY, W * 4, jrs._mm_batch_per, CHUNK, 1)
    jout, jvalid = (np.asarray(a) for a in jfn(
        jnp.asarray(masks), jnp.asarray(words), jnp.asarray(digs)))
    fn = fused.fused_fn_for(HIGHWAY_KEY, W * 4, rs_cuda.gf_matmul_batched,
                            CHUNK, 1)
    out, valid = fn(t32(masks), t32(words), t32(digs))
    assert np.array_equal(u32(out), jout)
    assert np.array_equal(valid.numpy(), jvalid)
    want = np.ones((B, K), dtype=bool)
    if corrupt is not None:
        want[corrupt] = False
    assert np.array_equal(valid.numpy(), want)
    vfn = fused.verify_fn_for(HIGHWAY_KEY, W * 4, CHUNK, 1)
    assert np.array_equal(vfn(t32(words), t32(digs)).numpy(), want)
    # hash_out: the rebuilt rows' own digests come back too (heal framing)
    out2, valid2, odigs = fused.fused_fn_for(
        HIGHWAY_KEY, W * 4, rs_cuda.gf_matmul_batched, CHUNK, 1,
        hash_out=True)(t32(masks), t32(words), t32(digs))
    assert torch.equal(out2, out) and torch.equal(valid2, valid)
    assert np.array_equal(u32(odigs), _digests(jout))


def test_guards():
    with pytest.raises(ValueError):  # shard not a chunk multiple
        fused.fused_fn_for(HIGHWAY_KEY, 4096, rs_cuda.gf_matmul_batched,
                           1000, 1)
    with pytest.raises(ValueError):
        fused.encode_hashed_fn_for(HIGHWAY_KEY, 4096, None, 0, 1)
    with pytest.raises(NotImplementedError):  # no device hash for id 2
        fused.verify_fn_for(HIGHWAY_KEY, 4096, 1024, 2)


def test_dispatch_ops_match_direct_calls(setup, monkeypatch):
    """Every queue op, flushed as one batch, gives the direct results."""
    words, _, trs, masks = setup
    digs = _digests(words)
    digs[2, 1, 0] ^= 1
    # each lane flushes a bucket when its B-th item arrives, never on a
    # timer: the coalescing does not depend on the host's load
    monkeypatch.setattr(dispatch, "INTERACTIVE_DELAY_S", 3600.0)
    q = DispatchQueue(device="cpu", max_batch=B, max_delay=3600.0,
                      interactive_batch=B)
    try:
        futs = {
            "encode": [q.encode(trs, words[b]) for b in range(B)],
            "encode_hashed": [q.encode_hashed(trs, words[b], HIGHWAY_KEY,
                                              CHUNK, 1) for b in range(B)],
            "masked": [q.masked(trs, words[b], masks[b]) for b in range(B)],
            "fused": [q.fused(trs, words[b], masks[b], digs[b], HIGHWAY_KEY,
                              CHUNK, 1) for b in range(B)],
            "verify": [q.verify(trs, words[b], digs[b], HIGHWAY_KEY, CHUNK, 1)
                       for b in range(B)],
        }
        res = {op: [f.result(timeout=60) for f in fs]
               for op, fs in futs.items()}
    finally:
        q.stop()
    par, dig = fused.encode_hashed_fn_for(
        HIGHWAY_KEY, W * 4, trs.encode_words_batch, CHUNK, 1)(t32(words))
    out, valid = fused.fused_fn_for(
        HIGHWAY_KEY, W * 4, rs_cuda.gf_matmul_batched, CHUNK, 1)(
            t32(masks), t32(words), t32(digs))
    for b in range(B):
        assert np.array_equal(res["encode"][b], u32(par)[b])
        assert np.array_equal(res["encode_hashed"][b][0], u32(par)[b])
        assert np.array_equal(res["encode_hashed"][b][1], u32(dig)[b])
        assert np.array_equal(res["masked"][b], u32(out)[b])
        assert np.array_equal(res["fused"][b][0], u32(out)[b])
        assert np.array_equal(res["fused"][b][1], valid.numpy()[b])
        assert np.array_equal(res["verify"][b], valid.numpy()[b])
    assert not res["verify"][2][1] and res["verify"][2][0]
    st = q.stats()
    for op in ("encode", "encode_hashed", "masked", "fused", "verify"):
        assert st["ops"][op]["items"] == B
        assert st["ops"][op]["batches"] == 1, op  # one coalesced flush each


def test_dispatch_coalesces_concurrent_threads(setup):
    words, _, trs, _ = setup
    # the bucket flushes when the 12th item arrives, never on a timer
    q = DispatchQueue(device="cpu", max_batch=12, max_delay=3600.0)
    out = [None] * 12
    barrier = threading.Barrier(12)

    def worker(i):
        barrier.wait(timeout=30)
        out[i] = q.encode(trs, words[i % B]).result(timeout=60)

    ths = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
    try:
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ths)
    finally:
        q.stop()
    want = u32(trs.encode_words_batch(t32(words)))
    for i in range(12):
        assert np.array_equal(out[i], want[i % B])
    st = q.stats()
    assert st["items"] == 12 and st["max_items"] > 1
