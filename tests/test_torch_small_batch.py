"""The launch plans of K1 (csrc/gf_matmul.cu) and K4 (csrc/chacha20.cu) at
the batch sizes the paths launch, and numpy models of how the kernels split
their work, held to the JAX package. Pure CPU: no card needed.

- ``rs_cuda.matmul_plan`` and ``chacha_cuda.launch_plan`` cover every word
  of every element and every 64-byte block exactly once, run at least two
  CTAs per SM where the shape allows (B >= 1 at W = 16384), keep shared
  memory within a Hopper CTA's 227 KB, and refuse shapes the kernels cannot
  take.
- A numpy model of K1's split of its work (the masks staged as [8*o][S][JP],
  each slice's Horner partial over its share of the inputs, the slices'
  XOR in shared memory, each CTA's words) equals
  ``minio_tpu/ops/rs_jax.py`` ``gf_matmul_packed`` and
  ``minio_tpu/ops/gf256.py`` ``gf_matmul_ref``.
- A numpy model of K4's four-lane layout (one state column a thread,
  column rounds in the thread, diagonal rounds by rotating rows 1-3 across
  the block's 4 lanes and back) equals
  ``minio_tpu/crypto/chacha20poly1305.py`` and the Pallas multi kernel in
  interpret mode, with key words whose top bit is set and nonce word 2
  near 2**32 - 1.

As K6's tile walk is held to a numpy model in test_torch_scan.py.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from minio_tpu.crypto import chacha20poly1305 as jccp
from minio_tpu.ops import chacha_pallas, gf256 as jgf256, rs_jax
from minio_tpu_torch.ops import chacha_cuda, rs_cuda

#: a Hopper CTA's shared memory at most, two CTAs per SM of the H100's 132
HOPPER_SMEM = 232_448
MIN_CTAS = 2 * 132


# --- K1 ---------------------------------------------------------------------


def x2(a):
    """GF(2^8)/0x11D doubling of four bytes packed in uint32 words."""
    hi = a & np.uint32(0x80808080)
    return ((a << np.uint32(1)) & np.uint32(0xFEFEFEFE)) ^ \
        ((hi >> np.uint32(7)) * np.uint32(0x1D))


def horner(masks_rows, xs):
    """acc = x2(acc) ^ XOR_j (masks[b][j] & x[j]) for b = 7 .. 0, with
    masks_rows [8, J] and xs [J, n] -> [n]."""
    acc = np.zeros(xs.shape[1:], np.uint32)
    for b in range(7, -1, -1):
        s = np.zeros_like(acc)
        for j in range(xs.shape[0]):
            s ^= masks_rows[b, j] & xs[j]
        acc = s if b == 7 else x2(acc) ^ s
    return acc


def staged_masks(m, S):
    """K1's shared memory of one element's masks [8, o, i]:
    [8*o][S][JP] words (JP: J rounded up to a power of two, at least 4),
    slice sl's inputs [sl*J, (sl+1)*J) first in its row, zero past them
    (the kernel's cp.async loop, index by index)."""
    _, o, i = m.shape
    J = -(-i // S)
    JP = max(4, 1 << (J - 1).bit_length())
    per_row = S * JP
    flat = m.reshape(8 * o * i)
    smem = np.empty(8 * o * per_row, np.uint32)
    for t in range(smem.size):
        row, rem = divmod(t, per_row)
        sl, jj = divmod(rem, JP)
        full = jj < J and sl * J + jj < i
        smem[t] = flat[row * i + sl * J + jj] if full else 0
    return smem.reshape(8, o, S, JP), J


def matmul_model(masks, x, plan):
    """K1 at ``plan``, CTA by CTA: the words each CTA covers, each slice's
    partial rows over its inputs, their XOR, written once. Returns the
    result and how often each output word was written."""
    B, _, o, i = masks.shape
    W = x.shape[-1]
    out = np.zeros((B, o, W), np.uint32)
    writes = np.zeros((B, W), np.int64)
    S, V = plan.slices, plan.words_per_thread
    span = plan.threads // S * V
    assert plan.grid[1] == B
    for e in range(B):
        sm, J = staged_masks(masks[e], S)
        for bx in range(plan.grid[0]):
            lo, hi = bx * span, min((bx + 1) * span, W)
            if lo >= W:
                continue
            part = np.zeros((S, o, hi - lo), np.uint32)
            for s in range(S):
                j0 = s * J
                nj = max(0, min(J, i - j0))
                xs = np.zeros((max(nj, 1), hi - lo), np.uint32)
                xs[:nj] = x[e, j0:j0 + nj, lo:hi]
                for r in range(o):
                    mr = np.zeros((8, max(nj, 1)), np.uint32)
                    mr[:, :nj] = sm[:, r, s, :nj]
                    part[s, r] = horner(mr, xs)
            out[e, :, lo:hi] = np.bitwise_xor.reduce(part, axis=0)
            writes[e, lo:hi] += 1
    return out, writes


def rebuild_inputs(B, o, i, W, seed):
    rng = np.random.default_rng(seed)
    mats = rng.integers(0, 256, (B, o, i), dtype=np.uint8)
    masks = np.stack([jgf256.coeff_masks(m) for m in mats])
    x = rng.integers(0, 2**32, (B, i, W), dtype=np.uint64).astype(np.uint32)
    return mats, masks, x


def every_plan(B, o, i, W):
    return [rs_cuda.matmul_plan(B, o, i, W)] + \
        rs_cuda.candidate_plans(B, o, i, W)


@pytest.mark.parametrize("i", [4, 16, 17])
@pytest.mark.parametrize("o", [1, 2, 20])
def test_matmul_split_model_matches_jax(o, i):
    B, W = 2, 300
    mats, masks, x = rebuild_inputs(B, o, i, W, 100 * o + i)
    want = np.stack([np.asarray(rs_jax.gf_matmul_packed(
        jnp.asarray(masks[e]), jnp.asarray(x[e]))) for e in range(B)])
    for e in range(B):
        ref = jgf256.gf_matmul_ref(mats[e], x[e].view(np.uint8).reshape(
            i, 4 * W))
        assert np.array_equal(want[e].view(np.uint8).reshape(o, 4 * W), ref)
    for plan in every_plan(B, o, i, W):
        got, writes = matmul_model(masks, x, plan)
        assert np.array_equal(writes, np.ones_like(writes)), plan
        assert np.array_equal(got, want), plan


@pytest.mark.parametrize("i", [1, 4, 5, 16, 17, 32])
@pytest.mark.parametrize("o", [1, 2, 20, 40])
@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 8, 9, 128])
def test_matmul_plan_covers_fills_and_fits(B, o, i):
    for W, aligned in itertools.product([16384, 1029, 16383, 1, 33],
                                        [True, False]):
        plan = rs_cuda.matmul_plan(B, o, i, W, aligned)
        S, V = plan.slices, plan.words_per_thread
        span = plan.threads // S * V
        # every word of every element once: CTAs of span words, the last
        # one reaching past W by less than a CTA
        assert plan.grid[1] == B
        assert plan.grid[0] * span >= W > (plan.grid[0] - 1) * span
        assert plan.threads % S == 0 and plan.threads // S % 32 == 0
        assert W % V == 0 and (aligned or V == 1)
        j = -(-i // S)
        assert plan.jmax >= j and plan.jmax in (4, 8, 16, 32)
        assert j * V <= rs_cuda.MAX_THREAD_WORDS
        assert plan.smem_bytes <= HOPPER_SMEM
        assert plan.threads in rs_cuda.THREADS
        jp = max(4, 1 << (j - 1).bit_length())
        assert plan.smem_bytes == 4 * o * (
            8 * S * jp + (plan.threads * V if S > 1 else 0))
        if W == 16384:
            assert plan.grid[0] * B >= MIN_CTAS, plan


def test_matmul_plan_at_the_paths_shapes():
    # W = 16384, i = 16: the batches the paths launch run 512 CTAs of one
    # or two words a thread, the large flushes 16-byte words in 128-thread
    # CTAs
    got = []
    for b in (1, 2, 4, 8, 32, 33, 128):
        p = rs_cuda.matmul_plan(b, 2, 16, 16384)
        got.append((b, p.slices, p.words_per_thread, p.threads,
                    p.grid[0] * b))
    assert got == [(1, 2, 1, 64, 512), (2, 1, 2, 32, 512),
                   (4, 1, 2, 64, 512), (8, 1, 2, 128, 512),
                   (32, 1, 2, 128, 2048), (33, 1, 4, 128, 1056),
                   (128, 1, 4, 128, 4096)]
    # an unaligned view or an odd W: one word a thread
    for aligned, w in ((False, 16384), (True, 16383)):
        assert {rs_cuda.matmul_plan(b, 2, 16, w, aligned).words_per_thread
                for b in (1, 8, 128)} == {1}
    # i > 16: no 16-byte words (a thread's 32 words of registers)
    assert rs_cuda.matmul_plan(128, 2, 32, 16384).words_per_thread == 2


@pytest.mark.parametrize("B,o,i,W", [(0, 2, 16, 64), (65536, 2, 16, 64),
                                     (1, 0, 16, 64), (1, 2, 0, 64),
                                     (1, 2, 33, 64), (1, 2, 16, 0),
                                     (1, 300, 32, 64), (1, 400, 17, 64)])
def test_matmul_plan_refuses_what_the_kernel_cannot_take(B, o, i, W):
    with pytest.raises(ValueError):
        rs_cuda.matmul_plan(B, o, i, W)


def test_make_plan_refuses_geometries_the_kernel_lacks():
    for s, v, t, aligned, W in ((3, 1, 128, True, 64), (1, 8, 128, True, 64),
                                (1, 2, 128, False, 64), (1, 4, 128, True, 66),
                                (1, 1, 96, True, 64), (2, 1, 32, True, 64)):
        with pytest.raises(ValueError):
            rs_cuda.make_plan(1, 2, 16, W, aligned, s, v, t)
    with pytest.raises(ValueError):  # 32 inputs x 4 words: 128 registers
        rs_cuda.make_plan(1, 2, 32, 64, True, 1, 4)
    with pytest.raises(ValueError):  # partial rows past a CTA's memory
        rs_cuda.make_plan(1, 100, 16, 64, True, 4, 4)


# --- K4 ---------------------------------------------------------------------

SIGMA = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574],
                 np.uint32)


def rotl(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def qr(a, b, c, d):
    a = a + b
    d = rotl(d ^ a, 16)
    c = c + d
    b = rotl(b ^ c, 12)
    a = a + b
    d = rotl(d ^ a, 8)
    c = c + d
    b = rotl(b ^ c, 7)
    return a, b, c, d


def from_lane(v, k):
    """Row values across each block's 4 lanes [n, 4]: lane c gets lane
    (c + k) & 3's (the kernel's width-4 __shfl_sync)."""
    return v[:, (np.arange(4) + k) & 3]


def quad_model(keys, nonces, data, plan):
    """K4's four-lane layout: thread t holds column t & 3 of block t >> 2;
    returns (xored, poly keys) and how often each output word was
    written."""
    items, pkgs, words = data.shape
    lpp = words // 16 + 1
    n_thr = plan.grid * plan.threads
    assert plan.lanes_per_block == 4 and n_thr >= 4 * plan.blocks
    t = np.arange(n_thr).reshape(-1, 4)
    lane = t[:, 0] >> 2
    valid = lane < plan.blocks
    lane = np.where(valid, lane, plan.blocks - 1)
    pkg = lane // lpp
    ctr = (lane - pkg * lpp).astype(np.uint32)
    k = keys.reshape(-1, 8)[pkg // pkgs]
    n = nonces.reshape(-1, 3)[pkg]
    s = np.stack([np.broadcast_to(SIGMA, k[:, :4].shape), k[:, :4],
                  k[:, 4:], np.concatenate([ctr[:, None], n], axis=1)])
    a, b, c, d = s.copy()  # rows 0-3, each [blocks, 4 lanes]
    with np.errstate(over="ignore"):
        for _ in range(10):
            a, b, c, d = qr(a, b, c, d)
            b, c, d = from_lane(b, 1), from_lane(c, 2), from_lane(d, 3)
            a, b, c, d = qr(a, b, c, d)
            b, c, d = from_lane(b, 3), from_lane(c, 2), from_lane(d, 1)
        ks = np.stack([a, b, c, d]) + s
    out = np.zeros(items * pkgs * words, np.uint32)
    poly = np.zeros(items * pkgs * 8, np.uint32)
    writes = np.zeros(out.size + poly.size, np.int64)
    flat = data.reshape(-1)
    for blk in np.nonzero(valid)[0]:
        p, cr = pkg[blk], int(ctr[blk])
        for col in range(4):
            if cr == 0:
                for row in (0, 1):
                    poly[p * 8 + 4 * row + col] = ks[row, blk, col]
                    writes[out.size + p * 8 + 4 * row + col] += 1
                continue
            for row in range(4):
                off = p * words + (cr - 1) * 16 + 4 * row + col
                out[off] = flat[off] ^ ks[row, blk, col]
                writes[off] += 1
    return (out.reshape(data.shape), poly.reshape(items, pkgs, 8),
            writes)


def chacha_inputs(items, pkgs, w, seed):
    """Keys with the top bit set in every word, nonce word 2 counting down
    from 2**32 - 1, words 0 and 1 shared by an item's packages."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, (items, 8), dtype=np.uint64).astype(
        np.uint32) | np.uint32(0x80000000)
    nonces = rng.integers(0, 2**32, (items, 1, 3), dtype=np.uint64).astype(
        np.uint32).repeat(pkgs, axis=1)
    nonces[:, :, 2] = np.uint32(2**32 - 1) - np.arange(pkgs, dtype=np.uint32)
    data = rng.integers(0, 2**32, (items, pkgs, w), dtype=np.uint64).astype(
        np.uint32)
    return keys, nonces, data


@pytest.mark.parametrize("items,pkgs,w", [(1, 1, 16), (3, 2, 64),
                                          (2, 5, 48)])
def test_quad_model_matches_numpy_chacha(items, pkgs, w):
    keys, nonces, data = chacha_inputs(items, pkgs, w, items + pkgs + w)
    out, poly, writes = quad_model(keys, nonces, data,
                                   chacha_cuda.four_lane_plan(items, pkgs, w))
    assert np.array_equal(writes, np.ones_like(writes))
    for i in range(items):
        ref_ct, ref_pk = jccp.keystream_xor(
            keys[i].tobytes(), nonces[i],
            data[i].view(np.uint8).reshape(pkgs, 4 * w))
        assert np.array_equal(out[i].view(np.uint8).reshape(pkgs, -1), ref_ct)
        assert np.array_equal(poly[i].view(np.uint8).reshape(pkgs, 32),
                              ref_pk)


def test_quad_model_matches_pallas_multi_kernel():
    keys, nonces, data = chacha_inputs(2, 2, 32, 5)
    want_ct, want_pk = chacha_pallas.multi_fn_for(2, 32, interpret=True)(
        keys, nonces, data)
    out, poly, _ = quad_model(keys, nonces, data,
                              chacha_cuda.four_lane_plan(2, 2, 32))
    assert np.array_equal(out, np.asarray(want_ct))
    assert np.array_equal(poly, np.asarray(want_pk))


@pytest.mark.parametrize("w", [16, 64, 16384])
@pytest.mark.parametrize("pkgs", [1, 3, 16])
@pytest.mark.parametrize("items", [1, 2, 3, 4, 16, 64, 128])
def test_chacha_plan_covers_every_block_once(items, pkgs, w):
    plan = chacha_cuda.launch_plan(items, pkgs, w)
    blocks = items * pkgs * (w // 16 + 1)
    assert plan.blocks == blocks
    assert plan.threads % 32 == 0 and plan.lanes_per_block in (1, 4)
    # thread t takes block t // lanes (and column t % 4 of four lanes): a
    # grid reaching past the last block by less than a CTA covers each
    # block with exactly lanes threads
    n = plan.grid * plan.threads
    assert n >= blocks * plan.lanes_per_block > n - plan.threads
    lanes = np.arange(n) // plan.lanes_per_block
    counts = np.bincount(lanes[lanes < blocks], minlength=blocks)
    assert np.array_equal(counts, np.full(blocks, plan.lanes_per_block))
    # four lanes for the launches the paths make, one for the full ones
    assert (plan.lanes_per_block == 4) == (
        blocks <= chacha_cuda.QUAD_MAX_WARPS_PER_SM * 32 * chacha_cuda.SMS)
    if w == 16384 and pkgs == 16:
        assert plan.grid >= MIN_CTAS


def test_chacha_plan_refuses_what_the_kernel_cannot_take():
    for items, pkgs, w in ((0, 1, 16), (1, 0, 16), (1, 1, 0), (1, 1, 24)):
        with pytest.raises(ValueError):
            chacha_cuda.launch_plan(items, pkgs, w)
