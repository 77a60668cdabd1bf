"""The port's hand-written CUDA kernels held to their plain PyTorch versions
on the card, bit for bit, over shapes the CPU tests cannot reach (ragged
word counts, every template bound and every CTA geometry of K1 at the
batches of either side of each switch of its plan, both layouts of K4 at
1-128 items, K2 built for the codecs' encode
matrices and for random ones of 1-32 inputs, more than 32 output rows,
chunk lengths with and without a HighwayHash remainder at the edges of the
hash kernels' tiles and at the flush shape, unaligned views), the fused
launches at both device hashes, plus an erasure round trip and an SSE-C
round trip on the card; the S3 Select scan kernel (K6) on lineitem blocks
at B = 1, 16 and 128, the edge-case block and the edge blocks of the chip
smoke (a row longer than a tile and its halo, no newline, wide rows), also
with tiles forced small so that many rows cross tiles, and one select_scan
flush and one select through the CUDA queue; the object layer and the S3
server (signed requests over HTTP, the MRF healing lost drives), an IAM
user's PUT and GET through a server with IAM, the auto-heal monitor's
global heal, a replication of a degraded source to a second server and a
restore of a transitioned object on the card against the CPU, file for
file; an injected
kernel fault failing its flush on the card, and a
hedged GET rebuilding through K1. Marked ``cuda``: they skip on hosts
without a CUDA card. On the card:

    MINIO_TPU_TEST_ON_DEVICE=1 MINIO_TPU_LOCKRANK=0 \
        python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import io

import numpy as np
import pytest
import torch

from minio_tpu_torch.erasure import (BitrotAlgorithm, Erasure,
                                     new_bitrot_reader, new_bitrot_writer)
from minio_tpu_torch.erasure.streaming import (BufferSink, BufferSource,
                                               erasure_decode, erasure_encode)
from minio_tpu_torch.crypto import sse
from minio_tpu_torch.ops import (chacha_cuda, chacha_torch, cuda_build,
                                 fused, gf256, hh_cuda, hh_torch, mur3_cuda,
                                 rs_cuda, scan_cuda, scan_torch)

pytestmark = pytest.mark.cuda

#: K2's matrices: random ones of 1-32 inputs, and the codecs' parity rows
RANDOM_INPUTS = [1, 4, 5, 8, 12, 16, 17, 32]
CODECS = [(16, 4), (12, 4), (8, 4), (4, 2)]


def random_matrix(i):
    return np.random.default_rng(i).integers(0, 256, (3, i), dtype=np.uint8)


def parity_rows(k, m):
    return gf256.build_matrix(k, m)[k:]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def encoders():
    """Every K2 library these tests use, built at once (one nvcc each, in
    parallel) rather than one at a time on first use."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mats = [random_matrix(i) for i in RANDOM_INPUTS] + \
        [parity_rows(k, m) for k, m in CODECS]
    cuda_build.build([("gf_encode", rs_cuda.encode_defines(m))
                      for m in mats])


def words(shape, seed, dev):
    a = np.random.default_rng(seed).integers(-2**31, 2**31, shape,
                                             dtype=np.int64)
    return torch.from_numpy(a.astype(np.int32)).to(dev)


@pytest.mark.parametrize("i", RANDOM_INPUTS)
@pytest.mark.parametrize("w", [1, 3, 4, 1000, 1027, 16384])
def test_encode_kernel_matches_plain(dev, encoders, i, w):
    mat = random_matrix(i)
    x = words((2, i, w), i * w, dev)
    masks = torch.from_numpy(gf256.coeff_masks(mat).view(np.int32)).to(dev)
    got = rs_cuda.gf_encode_batched(mat, x)
    assert torch.equal(got, rs_cuda.gf_matmul_batched_ref(masks, x))


@pytest.mark.parametrize("view", ["aligned", "unaligned"])
@pytest.mark.parametrize("w", [16384, 1027])
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("k,m", CODECS)
def test_encode_kernel_at_codec_matrices(dev, encoders, k, m, b, w, view):
    """K2 built for each codec's parity rows: the paths' batch sizes, a W
    that is not a multiple of 4 and a view one word into its storage; each
    launch counted by its batch size."""
    par = parity_rows(k, m)
    if view == "unaligned":
        x = words((b * k * w + 1,), b + w, dev)[1:].view(b, k, w)
        assert x.data_ptr() % 16
    else:
        x = words((b, k, w), b + w, dev)
    masks = torch.from_numpy(gf256.coeff_masks(par).view(np.int32)).to(dev)
    rs_cuda.reset_launches()
    got = rs_cuda.gf_encode_batched(par, x)
    assert torch.equal(got, rs_cuda.gf_matmul_batched_ref(masks, x))
    assert rs_cuda.launches["gf_encode_batched"] == 1
    assert rs_cuda.launch_sizes["gf_encode_batched"] == {b: 1}


def test_codec_on_card_prepares_its_encoder(dev):
    """A CUDA codec builds (or loads) K2 for its matrix when it is made;
    its encode then launches that library."""
    from minio_tpu_torch.ops import rs_torch
    codec = rs_torch.ReedSolomon(6, 3, device=dev)
    assert ("gf_encode", rs_cuda.encode_defines(codec.parity_rows)) \
        in cuda_build._libs
    data = np.random.default_rng(6).integers(0, 256, (6, 4096),
                                             dtype=np.uint8)
    assert np.array_equal(codec.encode(data),
                          gf256.gf_matmul_ref(codec.parity_rows, data))


#: K1's shapes: the batches the paths launch and the flush's 128, on
#: either side of each switch of rs_cuda.matmul_plan at W = 16384 (i = 16:
#: two slices of one word at B = 1, 8-byte words in CTAs of 32 threads at
#: 2, of 64 at 3-4, of 128 at 5-32, 16-byte words from 33), output rows of
#: one and two lost shards and of a whole stripe, i of the template bounds,
#: W whole, odd and ragged; views one word into their storage (not 16-byte
#: aligned: one word per thread); and the earlier cases of three elements,
#: more than 32 output rows among them
MATMUL_SHAPES = [
    (b, o, i, w, "aligned")
    for b in (1, 2, 3, 5, 8, 32, 33, 128) for o in (1, 2, 20)
    for i in (4, 16, 32) for w in (16384, 1029, 16383)] + [
    (b, 2, 16, 16384, "unaligned") for b in (1, 4, 8, 128)] + [
    (3, o, i, w, "aligned") for o in (1, 2, 20, 40)
    for i, w in ((4, 4096), (20, 2048))] + [
    (3, 40, 16, w, "aligned") for w in (1029, 16384)]


@pytest.mark.parametrize("b,o,i,w,view", MATMUL_SHAPES)
def test_matmul_kernel_matches_plain(dev, b, o, i, w, view):
    """K1 at its plan, and at every other geometry it takes, word for word
    against the plain version; the wrapper's launch counted by B and o."""
    rng = np.random.default_rng(b * 1000 + o * i)
    mats = rng.integers(0, 256, (b, o, i), dtype=np.uint8)
    masks = torch.from_numpy(np.stack(
        [gf256.coeff_masks(m) for m in mats]).view(np.int32)).to(dev)
    if view == "unaligned":
        x = words((b * i * w + 1,), o + w, dev)[1:].view(b, i, w)
        assert x.data_ptr() % 16
    else:
        x = words((b, i, w), o + w, dev)
    want = rs_cuda.gf_matmul_batched_ref(masks, x)
    rs_cuda.reset_launches()
    assert torch.equal(rs_cuda.gf_matmul_batched(masks, x), want)
    assert rs_cuda.launch_sizes["gf_matmul_batched"] == {
        1 << (b - 1).bit_length(): 1}
    assert rs_cuda.launch_rows["gf_matmul_batched"] == {o: 1}
    for plan in rs_cuda.candidate_plans(b, o, i, w, view == "aligned"):
        out = torch.empty_like(want)
        assert torch.equal(rs_cuda.launch_matmul(masks, x, out, plan),
                           want), plan


#: chunk counts around one CTA per SM (132) and one chunk per CTA, and
#: chunk lengths at the edges of the ring's 512-byte tiles (1, 3 and 32
#: tiles, one packet either side) for K3 and K5 (csrc/chunk_ring.cuh)
HASH_COUNTS = [1, 2, 3, 131, 133, 257]
HASH_NBYTES = [16, 32, 48, 496, 512, 528, 16384, 16416]


@pytest.mark.parametrize("nbytes", HASH_NBYTES)
@pytest.mark.parametrize("n", HASH_COUNTS)
def test_mur3_kernel_matches_plain(dev, nbytes, n):
    x = words((n, nbytes // 4), nbytes + n, dev)
    seeds = (0x12345678, 0x9E3779B9)
    assert torch.equal(mur3_cuda.mur3x256_chunks(seeds, nbytes, x),
                       mur3_cuda.mur3x256_ref(seeds, nbytes, x))


@pytest.mark.parametrize("kernel", ["encode", "matmul"])
def test_gf_kernels_take_unaligned_views(dev, encoders, kernel):
    # a contiguous view one word into its storage: not 16-byte aligned,
    # so the kernel must fall back to one word per thread
    i, w = 16, 4096
    x = words((i * w + 1,), 5, dev)[1:].view(1, i, w)
    assert x.is_contiguous() and x.data_ptr() % 16
    mat = np.random.default_rng(9).integers(0, 256, (4, i), dtype=np.uint8)
    masks = torch.from_numpy(
        gf256.coeff_masks(mat).view(np.int32)[None]).to(dev)
    got = rs_cuda.gf_encode_batched(mat, x) if kernel == "encode" \
        else rs_cuda.gf_matmul_batched(masks, x)
    assert torch.equal(got, rs_cuda.gf_matmul_batched_ref(masks, x))


def test_wrappers_refuse_bad_inputs(dev):
    x = words((1, 4, 64), 0, dev)
    masks = torch.zeros((1, 8, 2, 4), dtype=torch.int32)  # on the CPU
    with pytest.raises(ValueError):
        rs_cuda.gf_matmul_batched(masks, x)
    with pytest.raises(ValueError):
        rs_cuda.gf_matmul_batched(masks.to(dev), x[:, :, ::2])
    with pytest.raises(TypeError):
        rs_cuda.gf_matmul_batched(masks.to(dev), x.to(torch.int64))
    with pytest.raises(ValueError):
        mur3_cuda.mur3x256_chunks((1, 2), 64, x[0, :, 1:-3])


def test_erasure_round_trip_on_card(dev):
    k, m, bs = 4, 2, 64 << 10
    data = np.random.default_rng(3).integers(
        0, 256, 3 * bs + 999, dtype=np.uint8).tobytes()
    er = Erasure(k, m, bs)
    algo = BitrotAlgorithm.MUR3X256S
    sinks = [BufferSink() for _ in range(k + m)]
    ws = [new_bitrot_writer(s, algo, 16384) for s in sinks]
    assert erasure_encode(er, io.BytesIO(data), ws, k) == len(data)
    for w in ws:
        w.close()
    blk = np.frombuffer(data[:bs], dtype=np.uint8).reshape(k, -1)
    parity = gf256.gf_matmul_ref(er.codec.parity_rows, blk)
    assert sinks[k].getvalue()[32: 32 + 16384] == parity[0, :16384].tobytes()
    till = er.shard_file_size(len(data))
    readers = [None if i in (0, 1) else new_bitrot_reader(
        BufferSource(s.getvalue()), algo, till, 16384)
        for i, s in enumerate(sinks)]
    out = BufferSink()
    erasure_decode(er, out, readers, 0, len(data), len(data))
    assert out.getvalue() == data


#: K4's shapes: item counts on either side of launch_plan's switch (I = 3
#: and 4 at 16 packages of 64 KiB) and the flush's 128, one and 16
#: packages of one, four and 1,024 blocks, and the earlier cases
CHACHA_SHAPES = [(i, p, w) for i in (1, 2, 3, 4, 64, 128) for p in (1, 16)
                 for w in (16, 64, 16384)] + [
    (3, 2, 64), (5, 16, 1024), (2, 3, 16384)]


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("items,pkgs,w", CHACHA_SHAPES)
def test_chacha_kernel_matches_plain(dev, items, pkgs, w, lanes):
    """K4 with one and with four threads per 64-byte block, and at its
    plan through the wrapper (counted by I and by P), word for word against
    the plain version."""
    keys = words((items, 8), items, dev)
    keys[:, 0] |= -2**31
    nonces = words((items, pkgs, 3), pkgs, dev)
    nonces[:, :, 2] = -1 - torch.arange(pkgs, dtype=torch.int32, device=dev)
    data = words((items, pkgs, w), w, dev)
    want = chacha_torch.multi_xor(keys, nonces, data)
    plan = (chacha_cuda.one_lane_plan if lanes == 1
            else chacha_cuda.four_lane_plan)(items, pkgs, w)
    got = chacha_cuda.launch(
        keys, nonces, data, torch.empty_like(data),
        torch.empty((items, pkgs, 8), dtype=torch.int32, device=dev), plan)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    chacha_cuda.reset_launches()
    got = chacha_cuda.chacha20_xor(keys, nonces, data)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert chacha_cuda.launch_sizes["chacha20_xor"] == {
        1 << (items - 1).bit_length(): 1}
    assert chacha_cuda.launch_pkgs["chacha20_xor"] == {
        1 << (pkgs - 1).bit_length(): 1}


def test_chacha_single_object_and_unaligned_view(dev):
    nonces = words((4, 3), 1, dev)
    nonces[:, :2] = nonces[0, :2]
    data = words((4 * 64 + 1,), 2, dev)[1:].view(4, 64)
    assert data.data_ptr() % 16
    key = bytes(range(32))
    got = chacha_cuda.xor_packages(key, nonces, data)
    want = chacha_torch.xor_packages(key, nonces, data)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):  # words 0/1 must be shared
        chacha_cuda.xor_packages(key, words((4, 3), 3, dev), data)


@pytest.mark.parametrize("nbytes", HASH_NBYTES + [4, 28, 36, 1028])
@pytest.mark.parametrize("n", HASH_COUNTS)
def test_hh_kernel_matches_plain(dev, nbytes, n):
    x = words((n, nbytes // 4), nbytes + n, dev)
    kw = hh_torch.key_words(bytes(range(32)))
    assert torch.equal(hh_cuda.highwayhash256_chunks(kw, nbytes, x),
                       hh_cuda.highwayhash256_ref(kw, nbytes, x))


@pytest.mark.parametrize("n", [9, 133])
@pytest.mark.parametrize("nbytes", [64, 1028, 16384])
def test_hh_kernel_takes_unaligned_views(dev, nbytes, n):
    # rows a bulk copy cannot take: the kernel's direct-load case
    x = words((n * nbytes // 4 + 1,), 7, dev)[1:].view(n, nbytes // 4)
    assert x.data_ptr() % 16
    kw = hh_torch.key_words(bytes(range(32)))
    assert torch.equal(hh_cuda.highwayhash256_chunks(kw, nbytes, x),
                       hh_cuda.highwayhash256_ref(kw, nbytes, x))


@pytest.mark.parametrize("kernel", ["mur3", "hh"])
def test_hash_kernels_at_the_flush_shape(dev, kernel):
    # 10,240 chunks of 16 KiB (a 128-item 16+4 flush): several chunks per
    # CTA on every SM, a 4-stage ring; one launch, counted by its size
    x = words((10240, 4096), 11, dev)
    if kernel == "mur3":
        mod, name, run, ref = (mur3_cuda, "mur3x256_chunks",
                               mur3_cuda.mur3x256_chunks,
                               mur3_cuda.mur3x256_ref)
        key = (0x12345678, 0x9E3779B9)
    else:
        mod, name, run, ref = (hh_cuda, "highwayhash256_chunks",
                               hh_cuda.highwayhash256_chunks,
                               hh_cuda.highwayhash256_ref)
        key = hh_torch.key_words(bytes(range(32)))
    mod.reset_launches()
    assert torch.equal(run(key, 16384, x), ref(key, 16384, x))
    assert mod.launches[name] == 1
    assert mod.launch_sizes[name] == {16384: 1}


@pytest.mark.parametrize("algo", [0, 1])
def test_fused_launches_match_cpu(dev, algo):
    """encode_hashed, fused (with hash_out) and verify on the card give the
    CPU plain versions' words, at HighwayHash (0) and MUR3X256 (1)."""
    k, m, w, chunk = 4, 2, 1024, 1024
    key = bytes(range(32))
    x = words((3, k, w), 11, "cpu")
    res = {}
    for d in ("cpu", dev):
        codec = rs_cuda.gf_encode_batched
        par_rows = np.random.default_rng(1).integers(0, 256, (m, k),
                                                     dtype=np.uint8)
        enc = fused.encode_hashed_fn_for(
            key, w * 4, lambda t: codec(par_rows, t), chunk, algo)
        par, digs = enc(x.to(d))
        masks = torch.from_numpy(np.stack([gf256.coeff_masks(
            par_rows)] * 3).view(np.int32)).to(d)
        bad = digs[:, :k].clone()
        bad[1, 2, 0] ^= 1
        out, valid, odigs = fused.fused_fn_for(
            key, w * 4, rs_cuda.gf_matmul_batched, chunk, algo,
            hash_out=True)(masks, x.to(d), bad)
        ok = fused.verify_fn_for(key, w * 4, chunk, algo)(
            x.to(d), digs[:, :k])
        res[str(d)] = [t.cpu() for t in (par, digs, out, valid, odigs, ok)]
    for a, b in zip(res["cpu"], res[str(dev)]):
        assert torch.equal(a, b)
    assert not res["cpu"][3][1, 2] and res["cpu"][5].all()


def test_sse_hh_round_trip_on_card(dev):
    """One SSE-C object at HighwayHash256S: sealed through the card's
    sse_xor, erasure-coded, read back whole and ranged, degraded."""
    k, m, bs = 4, 2, 64 << 10
    plain = np.random.default_rng(4).integers(
        0, 256, 5 * sse.PKG_SIZE + 777, dtype=np.uint8).tobytes()
    oek, iv = bytes(range(32)), bytes(range(12))
    ct = sse.EncryptReader(io.BytesIO(plain), oek, iv).read()
    assert len(ct) == sse.enc_size(len(plain))
    er = Erasure(k, m, bs)
    algo = BitrotAlgorithm.HIGHWAYHASH256S
    sinks = [BufferSink() for _ in range(k + m)]
    ws = [new_bitrot_writer(s, algo, 16384) for s in sinks]
    assert erasure_encode(er, io.BytesIO(ct), ws, k) == len(ct)
    for w in ws:
        w.close()
    till = er.shard_file_size(len(ct))
    for drop, off, ln in (((), 0, len(plain)), ((0, 1), 65536 - 3, 70001)):
        eo, el, seq0, skip = sse.decrypt_range_bounds(off, ln, len(plain))
        readers = [None if i in drop else new_bitrot_reader(
            BufferSource(s.getvalue()), algo, till, 16384)
            for i, s in enumerate(sinks)]
        out = BufferSink()
        dw = sse.DecryptWriter(out, oek, iv, seq0, skip, ln)
        erasure_decode(er, dw, readers, eo, el, len(ct))
        dw.close()
        assert out.getvalue() == plain[off: off + ln]


@pytest.fixture(scope="module")
def smoke():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module")
def lineitem_blocks(smoke):
    """128 lineitem blocks of 1 MiB as the select path cuts them, with
    their max_rows (on the host; each test moves what it needs)."""
    table = smoke.lineitem(11, 0.2)
    x, mr = smoke.select_blocks(table["text"], 128, torch.device("cpu"))
    return table["text"], x, mr


#: K6's tile plans: the default, and tiles forced small (1 KiB tiles, a
#: 256-byte halo) so that many rows cross tiles, start in the halo or
#: before it
TILES = {"default": {}, "small": {"tile": 1024, "halo": 256}}


@pytest.mark.parametrize("tiles", list(TILES))
@pytest.mark.parametrize("shape", ["flush", "sixteen", "one", "edge",
                                   "long_row", "no_newline", "wide_rows"])
def test_scan_kernel_matches_plain(dev, smoke, lineitem_blocks, shape,
                                   tiles):
    """K6 at the chip smoke's shapes: Query A over 128, 16 and one
    lineitem blocks of 1 MiB, the edge-case block under a program with
    every op kind over 8 columns, and the edge blocks (a row longer than a
    tile and its halo, no newline, rows so wide that the newline count is
    under max_rows by more than a tile's rows); each launch counted by its
    batch size."""
    text, blocks, mr = lineitem_blocks
    (prog, cols), delim = smoke.select_program(smoke.QUERY_A), smoke.PIPE
    if shape == "edge":
        x = torch.from_numpy(smoke.edge_block(np.random.default_rng(3)))
        x, prog, cols, delim, mr = (x.to(dev), smoke.EDGE_PROGRAM,
                                    tuple(range(1, 9)), smoke.COMMA, 1024)
    elif shape in ("flush", "sixteen", "one"):
        x = blocks[:{"flush": 128, "sixteen": 16, "one": 1}[shape]].to(dev)
    else:
        x = torch.from_numpy(smoke.edge_blocks(text, blocks.shape[1])[
            shape][None]).to(dev)
    scan_cuda.reset_launches()
    got = scan_cuda.scan_codes(x, prog, cols, delim, mr, **TILES[tiles])
    assert scan_cuda.launches["scan_codes"] == 1
    assert scan_cuda.launch_sizes["scan_codes"] == {x.shape[0]: 1}
    want = scan_torch.scan_blocks(x, prog, cols, delim, mr)
    assert torch.equal(got, want)
    assert (want == 2).any()
    if shape != "no_newline":
        assert (want == 1).any()


@pytest.mark.parametrize("L,tile,halo", [(4096 + 4, 1024, 256),
                                         (3000, 512, 96), (1000, 32, 32)])
def test_scan_kernel_direct_loads(dev, smoke, L, tile, halo):
    """Blocks bulk copies cannot take (L % 16 != 0, a view one byte into
    its storage): the direct-load case, several tiles per block, rows
    crossing tiles and longer than a tile and its halo."""
    rng = np.random.default_rng(L)
    alphabet = np.frombuffer(b"0123456789 -+.x\x00" + b"|" * 4 + b"\n" * 3,
                             np.uint8)
    rows = rng.choice(alphabet, (3, L)).astype(np.uint8)
    rows[1, 100:100 + 2 * (tile + halo)] = ord("7")   # a long row
    flat = torch.from_numpy(np.concatenate([[0], rows.ravel()])
                            .astype(np.uint8)).to(dev)
    for x in (flat[1:].view(3, L), flat[1:].view(3, L).clone()):
        for prog, cols in (((("num", 0, "ge", 0),), (1,)),
                           ((("num", 0, "ne", 3), ("num", 1, "ge", 1),
                             ("or",)), (0, 2))):
            got = scan_cuda.scan_codes(x, prog, cols, smoke.PIPE, 4096,
                                       tile=tile, halo=halo)
            want = scan_torch.scan_blocks(x, prog, cols, smoke.PIPE, 4096)
            assert torch.equal(got, want)


def test_scan_kernel_refuses_bad_inputs(dev):
    x = torch.full((1, 64), 10, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        scan_cuda.scan_codes(x, (("num", 0, "lt", 1),), tuple(range(9)), 44,
                             8)
    with pytest.raises(ValueError):
        scan_cuda.scan_codes(x, (("num", 1, "lt", 1),), (0,), 44, 8)
    with pytest.raises(TypeError):
        scan_cuda.scan_codes(x.to(torch.int64), (("num", 0, "lt", 1),),
                             (0,), 44, 8)
    with pytest.raises(ValueError):  # a tile of part of a bitmap word
        scan_cuda.scan_codes(x, (("num", 0, "lt", 1),), (0,), 44, 8,
                             tile=48)


def test_select_scan_flush_on_card(dev):
    """Blocks of two requests with the same program share one CUDA flush of
    K6; its codes equal the plain version's on the CPU."""
    from minio_tpu_torch.runtime.dispatch import DispatchQueue
    rows = [b"%d|%d|x\n" % (i, i * 37 % 101 - 50) for i in range(300)]
    txt = b"".join(rows)
    block = np.frombuffer(txt + b"\n" * (8192 - len(txt)), np.uint8)
    prog, cols = (("num", 0, "lt", 0), ("num", 1, "ge", 5), ("or",)), (1, 0)
    q = DispatchQueue(dev, max_delay=0.05)
    try:
        before = scan_cuda.launches["scan_codes"]
        futs = [q.select_scan(block.view("<u4").reshape(1, -1), prog, cols,
                              124, 512) for _ in range(2)]
        got = [f.result(timeout=60) for f in futs]
        assert scan_cuda.launches["scan_codes"] == before + 1
        assert q.stats()["ops"]["select_scan"] == {"batches": 1, "items": 2}
    finally:
        q.stop()
    want = scan_torch.scan_blocks(torch.from_numpy(block[None].copy()),
                                  prog, cols, 124, 512)[0].numpy()
    for g in got:
        assert g.dtype == np.int32 and np.array_equal(g, want)


def test_select_object_content_on_card(dev):
    """One SelectObjectContent over an erasure-coded object on the card:
    the records of the CPU run, the scan through K6."""
    from minio_tpu_torch.s3select import S3SelectRequest, run_select
    rows = [b"%d|%d|%d.5|\n" % (i, i * 7 % 50, i) for i in range(5000)]
    data = b"".join(rows)
    k, m, bs = 4, 2, 64 << 10
    er = Erasure(k, m, bs)
    algo = BitrotAlgorithm.HIGHWAYHASH256S
    sinks = [BufferSink() for _ in range(k + m)]
    ws = [new_bitrot_writer(s, algo, 16384) for s in sinks]
    assert erasure_encode(er, io.BytesIO(data), ws, k) == len(data)
    for w in ws:
        w.close()
    till = er.shard_file_size(len(data))
    readers = [None if i in (0, 1) else new_bitrot_reader(
        BufferSource(s.getvalue()), algo, till, 16384)
        for i, s in enumerate(sinks)]
    from minio_tpu_torch.s3select import select_object_content
    body = (b"<SelectObjectContentRequest><Expression>SELECT s._1 FROM "
            b"s3object s WHERE s._2 &lt; 10 AND s._3 &gt; 100</Expression>"
            b"<InputSerialization><CSV><FieldDelimiter>|</FieldDelimiter>"
            b"</CSV></InputSerialization></SelectObjectContentRequest>")
    before = scan_cuda.launches["scan_codes"]
    out = io.BytesIO()
    st = select_object_content(body, er, readers, len(data), {}, {}, "b",
                               "k", out)
    assert scan_cuda.launches["scan_codes"] > before
    req = S3SelectRequest.parse(body)
    want = io.BytesIO()
    run_select(req, data, want, device="cpu")
    assert out.getvalue() == want.getvalue()
    assert st["processed"] == len(data)


def _encode_hashed_case(codec, seed: int, chunk: int = 4096):
    """(words, parity, digests) of one encode_hashed item, the expected
    values from the host's native library."""
    from minio_tpu_torch import native
    from minio_tpu_torch.erasure.bitrot import HIGHWAY_KEY
    from minio_tpu_torch.ops.rs_torch import pack_shards
    data = np.random.default_rng(seed).integers(0, 256, (codec.k, 4 * chunk),
                                                dtype=np.uint8)
    parity = native.cpu_encode(codec.parity_rows, data, codec.m)
    both = np.concatenate([data, parity])
    digs = native.hh256_batch(HIGHWAY_KEY, both.reshape(-1, chunk))
    return pack_shards(data), parity, digs.reshape(len(both), -1)


def test_queue_overlapping_flushes_reuse_staging_exactly(dev):
    """Eight threads keep the bulk lane's flushes of one shape overlapping,
    so pinned staging buffers are reused while earlier copies may be in
    flight; every result equals the host's."""
    import threading
    from minio_tpu_torch.erasure.bitrot import HIGHWAY_KEY
    from minio_tpu_torch.ops.rs_torch import get_codec, unpack_shards
    from minio_tpu_torch.runtime.dispatch import DispatchQueue
    codec = get_codec(4, 2, device=dev)
    cases = [_encode_hashed_case(codec, s) for s in range(64)]
    q = DispatchQueue(dev, max_batch=4, max_delay=0.0005)
    bad = []

    def work(t):
        for j in range(t, 64 * 6, 8):
            words, parity, digs = cases[j % 64]
            par, d = q.encode_hashed(codec, words, HIGHWAY_KEY, 4096,
                                     0).result(timeout=120)
            if not (np.array_equal(unpack_shards(par), parity) and
                    np.array_equal(d.view(np.uint8).reshape(6, -1), digs)):
                bad.append(j)
    try:
        ths = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in ths)
        st = q.stats()
    finally:
        q.stop()
    assert not bad, bad[:5]
    assert st["ops"]["encode_hashed"]["items"] == 64 * 6
    assert st["staging"]["hits"] > 0 and st["salvaged_batches"] == 0
    assert st["failed_batches"] == 0
    assert st["completer_seconds"] > 0


def test_queue_fails_a_failed_launch_on_card(dev):
    """A launch that raises on the card is not moved to the host: every
    waiter gets the exception, the failure is counted, nothing salvaged;
    the same items on an unfailed queue come back right."""
    from minio_tpu_torch.erasure.bitrot import HIGHWAY_KEY
    from minio_tpu_torch.ops.rs_torch import get_codec, unpack_shards
    from minio_tpu_torch.runtime.dispatch import DispatchQueue
    codec = get_codec(4, 2, device=dev)
    cases = [_encode_hashed_case(codec, 100 + s) for s in range(6)]
    for fail in (False, True):
        q = DispatchQueue(dev, max_delay=0.05)
        if fail:
            def boom(*a, **kw):
                raise RuntimeError("injected launch failure")
            q._launch = boom
        try:
            futs = [q.encode_hashed(codec, w, HIGHWAY_KEY, 4096, 0)
                    for w, _, _ in cases]
            for f, (_, parity, digs) in zip(futs, cases):
                if fail:
                    with pytest.raises(RuntimeError, match="injected"):
                        f.result(timeout=120)
                    continue
                par, d = f.result(timeout=120)
                assert np.array_equal(unpack_shards(par), parity)
                assert np.array_equal(d.view(np.uint8).reshape(6, -1), digs)
            st = q.stats()
        finally:
            q.stop()
        assert st["failed_items"] == (6 if fail else 0)
        assert st["salvaged_items"] == 0


def test_injected_kernel_error_fails_its_flush_on_card(dev):
    """A ``kernel`` rule of the fault plane on the card fails its flush as
    a failed launch does: the waiters get the injected error, the flush
    is counted failed and nothing is salvaged; the next flush is right."""
    from minio_tpu_torch import fault
    from minio_tpu_torch.erasure.bitrot import HIGHWAY_KEY
    from minio_tpu_torch.ops.rs_torch import get_codec, unpack_shards
    from minio_tpu_torch.runtime.dispatch import DispatchQueue
    from minio_tpu_torch.utils import errors
    codec = get_codec(4, 2, device=dev)
    cases = [_encode_hashed_case(codec, 200 + s) for s in range(4)]
    q = DispatchQueue(dev, max_delay=0.05)
    fault.clear()
    try:
        fault.arm("kernel:device:*:error(FaultyDisk)@count=1")
        futs = [q.encode_hashed(codec, w, HIGHWAY_KEY, 4096, 0)
                for w, _, _ in cases]
        for f in futs:
            with pytest.raises(errors.FaultyDisk):
                f.result(timeout=120)
        st = q.stats()
        assert st["failed_batches"] == 1 and st["failed_items"] == 4
        assert st["salvaged_items"] == 0
        for w, parity, digs in cases:
            par, d = q.encode_hashed(codec, w, HIGHWAY_KEY, 4096,
                                     0).result(timeout=120)
            assert np.array_equal(unpack_shards(par), parity)
            assert np.array_equal(d.view(np.uint8).reshape(6, -1), digs)
    finally:
        fault.clear()
        q.stop()


def test_hedged_get_on_card_rebuilds_through_k1(dev, tmp_path, monkeypatch):
    """A 5 s straggler on one data shard's disk: the hedged GET on the card
    is right in under 4 s, its block rebuilt by the fused launch (K1 +
    K5), and the straggler is no failure (no on_partial)."""
    import time
    from minio_tpu_torch import fault
    from minio_tpu_torch.objectlayer import ErasureObjects
    from minio_tpu_torch.objectlayer.metadata import hash_order
    from minio_tpu_torch.storage import XLStorage
    disks = [XLStorage(str(tmp_path / f"d{i:02d}")) for i in range(6)]
    ol = ErasureObjects(disks, default_parity=2, block_size=1 << 20)
    ol.make_bucket("b")
    body = np.random.default_rng(7).bytes(4 << 20)
    ol.put_object("b", "o", io.BytesIO(body), len(body))
    assert ol.get_object_bytes("b", "o") == body
    partial = []
    ol.on_partial = lambda *a, **kw: partial.append(a)
    monkeypatch.setenv("MINIO_TPU_HEDGE_MS", "15")
    d = disks[hash_order("b/o", 6).index(1)]
    rs_cuda.reset_launches()
    fault.clear()
    fault.arm(f"disk:{d.endpoint()}:read_at:delay(5000)")
    try:
        t0 = time.perf_counter()
        assert ol.get_object_bytes("b", "o") == body
        wall = time.perf_counter() - t0
    finally:
        fault.clear()
    assert wall < 4.0
    assert rs_cuda.launches["gf_matmul_batched"] > 0
    assert partial == []


def test_interactive_lane_on_card_completes_in_order(dev):
    """Rebuilds on the card ride the interactive lane's own stream and
    complete through the event-polling completer, in submission order."""
    from minio_tpu_torch import native
    from minio_tpu_torch.ops.rs_torch import get_codec, pack_shards, \
        unpack_shards
    from minio_tpu_torch.runtime.dispatch import DispatchQueue
    codec = get_codec(4, 2, device=dev)
    q = DispatchQueue(dev, max_delay=0.005, interactive_batch=2)
    order, futs = [], []
    try:
        for i in range(10):
            data = np.random.default_rng(200 + i).integers(
                0, 256, (4, 8192), dtype=np.uint8)
            full = np.concatenate([data, native.cpu_encode(
                codec.parity_rows, data, 2)])
            present = (0, 2, 3, 4)
            masks = codec.target_masks_np(present, (1,))
            f = q.masked(codec, pack_shards(full[list(present)]), masks)
            f.add_done_callback(lambda _f, i=i: order.append(i))
            futs.append((f, full[1]))
        for f, want in futs:
            assert np.array_equal(unpack_shards(f.result(timeout=60))[0],
                                  want)
        st = q.stats()["lanes"]["interactive"]
    finally:
        q.stop()
    assert order == sorted(order)
    assert st["items"] == 10 and st["async_completions"] == st["flushes"]


def _pin_object_ids(monkeypatch):
    """The port's persisted ids and times on counters, so two runs of the
    same calls write the same files."""
    import itertools
    import types
    import uuid
    from minio_tpu_torch.objectlayer import erasure_objects, multipart
    from minio_tpu_torch.storage.datatypes import FileInfo
    ids, times = itertools.count(1), itertools.count(1)

    def new_uuid():
        return uuid.UUID(int=next(ids))

    fake = types.SimpleNamespace(uuid4=new_uuid, UUID=uuid.UUID)
    for mod in (erasure_objects, multipart):
        monkeypatch.setattr(mod, "uuid", fake)
    monkeypatch.setattr(FileInfo, "now",
                        staticmethod(lambda: 1.7e9 + next(times) / 8))
    monkeypatch.setattr(FileInfo, "new_version_id",
                        staticmethod(lambda: str(new_uuid())))


def _object_layer_run(root, device) -> tuple:
    """PUT, drive loss, heal and GET through one 16+4 / 1 MiB set on
    ``device`` (None = the card); returns the ETags, the GET bytes and
    every file of the set."""
    import os
    import shutil
    from minio_tpu_torch.objectlayer import ErasureObjects
    from minio_tpu_torch.storage.xlstorage import XLStorage
    dirs = [os.path.join(str(root), f"d{i:02d}") for i in range(20)]
    ol = ErasureObjects([XLStorage(d) for d in dirs], default_parity=4,
                        block_size=1 << 20, device=device)
    ol.make_bucket("b")
    etags, got = {}, {}
    for name, data in OL_BODIES.items():
        etags[name] = ol.put_object("b", name, io.BytesIO(data),
                                    len(data)).etag
    for i in (0, 7):
        shutil.rmtree(os.path.join(dirs[i], "b"))
    ol.heal_bucket("b")
    for name in OL_BODIES:
        ol.heal_object("b", name)
    for i in (1, 2):  # two more drives gone: the GETs rebuild
        shutil.rmtree(os.path.join(dirs[i], "b"))
    for name in OL_BODIES:
        got[name] = ol.get_object_bytes("b", name)
    files = {}
    for d, _sub, names in os.walk(str(root)):
        if ".minio.sys" in d:
            continue
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                files[os.path.relpath(os.path.join(d, n), str(root))] = \
                    f.read()
    return etags, got, files


OL_BODIES = {f"o{n}": np.random.default_rng(n).bytes(n)
             for n in (100_000, (1 << 20) + 7, (4 << 20) + 333)}


def test_objectlayer_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """The object layer on the card (device=None: K2 prepared at start-up,
    PUT digests on K5, rebuilds on K1) writes, heals and reads back the
    same bytes as on the CPU, with the reference ETags."""
    import hashlib
    from minio_tpu_torch.ops import hh_cuda, rs_cuda
    from minio_tpu_torch.utils.hashreader import pipeline_etag_reference
    _pin_object_ids(monkeypatch)
    rs_cuda.reset_launches()
    hh_cuda.reset_launches()
    card = _object_layer_run(tmp_path / "card", None)
    launched = {**rs_cuda.launches, **hh_cuda.launches}
    _pin_object_ids(monkeypatch)
    host = _object_layer_run(tmp_path / "cpu", "cpu")
    assert card[0] == host[0]
    for name, data in OL_BODIES.items():
        want = hashlib.md5(data).hexdigest() if len(data) < 1 << 20 else \
            pipeline_etag_reference(data, 16, 1 << 20, 16384, 0)
        assert card[0][name] == want, name
        assert card[1][name] == data and host[1][name] == data
    assert card[2] == host[2]
    for name in ("gf_encode_batched", "gf_matmul_batched",
                 "highwayhash256_chunks"):
        assert launched[name] > 0, name


S3_AK, S3_SK = "card-admin", "card-admin-secret"
S3_KEY = bytes(range(32))
S3_SSE = {"x-amz-server-side-encryption-customer-algorithm": "AES256",
          "x-amz-server-side-encryption-customer-key":
              __import__("base64").b64encode(S3_KEY).decode(),
          "x-amz-server-side-encryption-customer-key-md5":
              __import__("base64").b64encode(
                  __import__("hashlib").md5(S3_KEY).digest()).decode()}
S3_CSV = b"".join(b"%d|%d|row%d\n" % (i, (i * 37) % 1000, i)
                  for i in range(3000))
S3_SELECT = (b"<SelectObjectContentRequest><Expression>SELECT s._1 FROM "
             b"s3object s WHERE s._2 &lt; 100</Expression><ExpressionType>"
             b"SQL</ExpressionType><InputSerialization><CSV><FileHeaderInfo>"
             b"NONE</FileHeaderInfo><FieldDelimiter>|</FieldDelimiter></CSV>"
             b"</InputSerialization><OutputSerialization><CSV/>"
             b"</OutputSerialization></SelectObjectContentRequest>")


def _s3server_run(root, device, monkeypatch) -> tuple:
    """Signed requests over http.client to the S3 server over one 16+4 /
    1 MiB set on ``device`` (None = the card): PUTs (one SSE-C), a
    SelectObjectContent, then two drives lost, GETs that rebuild and feed
    the MRF, and the MRF drained. Returns each response's status, ETag and
    body, and every file of the set."""
    import hashlib
    import http.client
    import itertools
    import os
    import secrets
    import shutil
    import time
    import urllib.parse
    from minio_tpu_torch.objectlayer import ErasureObjects
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.server.auth import UNSIGNED_PAYLOAD, SigV4Verifier
    from minio_tpu_torch.storage.xlstorage import XLStorage
    _pin_object_ids(monkeypatch)
    keys = itertools.count(1)
    monkeypatch.setattr(secrets, "token_bytes", lambda n=32: hashlib.sha256(
        b"%d" % next(keys)).digest()[:n])
    dirs = [os.path.join(str(root), f"d{i:02d}") for i in range(20)]
    ol = ErasureObjects([XLStorage(d) for d in dirs], default_parity=4,
                        block_size=1 << 20, device=device)
    srv = S3Server(ol, "127.0.0.1", 0, access_key=S3_AK, secret_key=S3_SK,
                   device=device)
    srv.start_background()
    srv.start_background_services()
    signer = SigV4Verifier(lambda ak: None)
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=300)

    def req(method, path, body=b"", headers=None, query=None):
        query = {k: [v] for k, v in (query or {}).items()}
        h = {"host": f"127.0.0.1:{srv.port}", **(headers or {})}
        h["authorization"] = signer.sign_request(
            S3_AK, S3_SK, method, path, query, h, UNSIGNED_PAYLOAD)
        qs = urllib.parse.urlencode([(k, v[0]) for k, v in query.items()])
        conn.request(method, path + (f"?{qs}" if qs else ""), body=body,
                     headers=h)
        r = conn.getresponse()
        return r.status, r.getheader("ETag"), r.read()

    try:
        out = [req("PUT", "/b")]
        out += [req("PUT", f"/b/{n}", d) for n, d in OL_BODIES.items()]
        big = OL_BODIES["o1048583"]
        out.append(req("PUT", "/b/enc", big, S3_SSE))
        out.append(req("PUT", "/b/t.csv", S3_CSV))
        out.append(req("POST", "/b/t.csv", S3_SELECT,
                       query={"select": "", "select-type": "2"}))
        for i in (0, 9):
            shutil.rmtree(os.path.join(dirs[i], "b"))
        ol.heal_bucket("b")
        names = [*OL_BODIES, "enc", "t.csv"]
        out += [req("GET", f"/b/{n}", headers=S3_SSE if n == "enc" else
                    None) for n in names]
        out.append(req("GET", "/b/enc",
                       headers={**S3_SSE, "range": "bytes=65530-70000"}))
        deadline = time.monotonic() + 300
        while srv.mrf.healed + srv.mrf.failed < len(names):
            assert time.monotonic() < deadline, srv.mrf.stats()
            time.sleep(0.05)
        assert srv.mrf.failed == 0
    finally:
        conn.close()
        srv.shutdown()
    files = {}
    for d, _sub, fnames in os.walk(str(root)):
        if ".minio.sys" in d:
            continue
        for n in fnames:
            with open(os.path.join(d, n), "rb") as f:
                files[os.path.relpath(os.path.join(d, n), str(root))] = \
                    f.read()
    return out, files


def test_s3server_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """The S3 server on the card answers the same signed requests with the
    same statuses, ETags and bodies as on the CPU, its MRF heals the lost
    drives to the same files, and the path launched K1, K2, K4, K5 and
    K6."""
    from minio_tpu_torch.ops import chacha_cuda, hh_cuda, rs_cuda, scan_cuda
    for mod in (rs_cuda, hh_cuda, chacha_cuda, scan_cuda):
        mod.reset_launches()
    card = _s3server_run(tmp_path / "card", None, monkeypatch)
    launched = {**rs_cuda.launches, **hh_cuda.launches,
                **chacha_cuda.launches, **scan_cuda.launches}
    host = _s3server_run(tmp_path / "cpu", "cpu", monkeypatch)
    assert [r[0] for r in card[0]] == [200] * 7 + [200] * 5 + [206]
    assert card[0] == host[0]
    assert card[1] == host[1]
    got = {r[2] for r in card[0][7:12]}
    assert all(d in got for d in OL_BODIES.values())
    assert card[0][-1][2] == OL_BODIES["o1048583"][65530:70001]
    for name in ("gf_encode_batched", "gf_matmul_batched", "chacha20_xor",
                 "highwayhash256_chunks", "scan_codes"):
        assert launched[name] > 0, name


def _iam_run(root, device, monkeypatch) -> tuple:
    """An S3 server with IAM over one 16+4 / 1 MiB set on ``device`` (None
    = the card): root creates a user through the admin client, the user
    PUTs and GETs the bodies in its bucket and is refused another's.
    Returns each response's status, ETag and body, and every file of the
    set, ``.minio.sys/config/iam/state.json`` included."""
    import hashlib
    import http.client
    import itertools
    import json
    import os
    import re
    import types
    import urllib.parse
    from minio_tpu_torch.iam import sys as iam_sys
    from minio_tpu_torch.madmin import AdminClient
    from minio_tpu_torch.objectlayer import ErasureObjects
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.server.auth import UNSIGNED_PAYLOAD, SigV4Verifier
    from minio_tpu_torch.storage.xlstorage import XLStorage
    _pin_object_ids(monkeypatch)
    draws = itertools.count(1)
    monkeypatch.setattr(iam_sys, "secrets", types.SimpleNamespace(
        token_hex=lambda n: hashlib.sha256(b"%d" % next(draws)).hexdigest()
        [:2 * n], token_urlsafe=lambda n: "s" * n))
    monkeypatch.setattr(iam_sys, "time", types.SimpleNamespace(
        time=lambda: 1.75e9))
    dirs = [os.path.join(str(root), f"d{i:02d}") for i in range(20)]
    ol = ErasureObjects([XLStorage(d) for d in dirs], default_parity=4,
                        block_size=1 << 20, device=device)
    srv = S3Server(ol, "127.0.0.1", 0, access_key=S3_AK, secret_key=S3_SK,
                   device=device)
    srv.enable_iam()
    srv.start_background()
    signer = SigV4Verifier(lambda ak: None)
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=300)

    def req(ak, sk, method, path, body=b""):
        h = {"host": f"127.0.0.1:{srv.port}"}
        h["authorization"] = signer.sign_request(
            ak, sk, method, path, {}, h, UNSIGNED_PAYLOAD)
        conn.request(method, urllib.parse.quote(path), body=body, headers=h)
        r = conn.getresponse()
        data = r.read()
        if r.status >= 400:  # the error XML's request id is per request
            data = re.search(rb"<Code>([^<]+)</Code>", data).group(1)
        return r.status, r.getheader("ETag"), data

    try:
        adm = AdminClient(srv.endpoint(), S3_AK, S3_SK)
        adm.add_canned_policy("tenant", json.dumps({"Statement": [{
            "Effect": "Allow", "Action": ["s3:*"],
            "Resource": ["arn:aws:s3:::tenant-a",
                         "arn:aws:s3:::tenant-a/*"]}]}).encode())
        adm.add_user("tenant-a-user", "tenant-a-secret", ["tenant"])
        out = [req(S3_AK, S3_SK, "PUT", "/tenant-b")]
        user = ("tenant-a-user", "tenant-a-secret")
        out.append(req(*user, "PUT", "/tenant-a"))
        out += [req(*user, "PUT", f"/tenant-a/{n}", d)
                for n, d in OL_BODIES.items()]
        out += [req(*user, "GET", f"/tenant-a/{n}") for n in OL_BODIES]
        out.append(req(*user, "PUT", "/tenant-b/x", b"denied"))
        out.append(req(*user, "GET", "/tenant-b/x"))
    finally:
        conn.close()
        srv.shutdown()
    files = {}
    for d, _sub, fnames in os.walk(str(root)):
        # of the system volume, the IAM document only (the bucket records
        # carry their creation time)
        if ".minio.sys" in d and not d.endswith(os.path.join("config",
                                                             "iam")):
            continue
        for n in fnames:
            with open(os.path.join(d, n), "rb") as f:
                files[os.path.relpath(os.path.join(d, n), str(root))] = \
                    f.read()
    return out, files


def test_iam_user_put_and_get_on_card_match_cpu(dev, tmp_path, monkeypatch):
    """An IAM user's PUT and GET on the card leave the same files as on
    the CPU (the objects and the IAM state document) and answer alike;
    the user's PUT and GET in another tenant's bucket are refused."""
    import json as _json
    from minio_tpu_torch.ops import hh_cuda, rs_cuda
    for mod in (rs_cuda, hh_cuda):
        mod.reset_launches()
    card = _iam_run(tmp_path / "card", None, monkeypatch)
    launched = {**rs_cuda.launches, **hh_cuda.launches}
    host = _iam_run(tmp_path / "cpu", "cpu", monkeypatch)
    n = len(OL_BODIES)
    assert [r[0] for r in card[0]] == [200] * (2 + 2 * n) + [403, 403]
    assert [r[2] for r in card[0][-2:]] == [b"AccessDenied"] * 2
    assert card[0] == host[0]
    assert card[1] == host[1]
    assert [r[2] for r in card[0][2 + n:2 + 2 * n]] == \
        list(OL_BODIES.values())
    state = [k for k in card[1] if k.endswith("iam/state.json")]
    assert len(state) == 20
    assert "tenant-a-user" in _json.loads(card[1][state[0]])["users"]
    for name in ("gf_encode_batched", "highwayhash256_chunks"):
        assert launched[name] > 0, name


def _global_heal_run(root, device) -> dict:
    """Objects PUT through one 16+4 / 1 MiB set on ``device`` (None = the
    card), two drives wiped with their healing trackers set, the auto-heal
    monitor's global heal; returns every file of the set."""
    import os
    import shutil
    from minio_tpu_torch.objectlayer import ErasureObjects
    from minio_tpu_torch.scanner.autoheal import (AutoHealMonitor,
                                                  get_healing_tracker,
                                                  set_healing_tracker)
    from minio_tpu_torch.storage.xlstorage import XLStorage
    dirs = [os.path.join(str(root), f"d{i:02d}") for i in range(20)]
    ol = ErasureObjects([XLStorage(d) for d in dirs], default_parity=4,
                        block_size=1 << 20, device=device)
    ol.make_bucket("b")
    for name, data in OL_BODIES.items():
        ol.put_object("b", f"p/{name}", io.BytesIO(data), len(data))
    for i in (3, 11):
        shutil.rmtree(os.path.join(dirs[i], "b"))
        set_healing_tracker(ol.disks[i])
    mon = AutoHealMonitor(ol, ol.disks, interval_s=9999)
    assert mon.check_and_heal()
    assert mon.healer.objects_healed == len(OL_BODIES)
    assert all(get_healing_tracker(d) is None for d in ol.disks)
    files = {}
    for d, _sub, names in os.walk(str(root)):
        if ".minio.sys" in d:
            continue
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                files[os.path.relpath(os.path.join(d, n), str(root))] = \
                    f.read()
    return files


def test_global_heal_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """The auto-heal monitor's global heal on the card (rebuilds on K1,
    verifies and digests on K5) leaves the same files as on the CPU."""
    from minio_tpu_torch.ops import hh_cuda, rs_cuda
    _pin_object_ids(monkeypatch)
    rs_cuda.reset_launches()
    hh_cuda.reset_launches()
    card = _global_heal_run(tmp_path / "card", None)
    launched = {**rs_cuda.launches, **hh_cuda.launches}
    _pin_object_ids(monkeypatch)
    host = _global_heal_run(tmp_path / "cpu", "cpu")
    assert card == host
    for name in ("gf_encode_batched", "gf_matmul_batched",
                 "highwayhash256_chunks"):
        assert launched[name] > 0, name


# -- the observability plane on the card --------------------------------------


def test_flush_device_time_comes_from_cuda_events(dev):
    """A CUDA queue's flushes land in the device plane: each op's CUDA-event
    device seconds are > 0 and at most its flushes' walls (flush start to
    readback landed, on the host clock); the streams' occupancy over the
    run and each lane's lie in (0, 1]; the roofline ratio is the card's
    (or null for a card whose bound the port does not know); the ledger
    is balanced after the drain."""
    import time
    from minio_tpu_torch.erasure.bitrot import HIGHWAY_KEY
    from minio_tpu_torch.obs import device as pdev
    from minio_tpu_torch.obs import timeline as ptl
    from minio_tpu_torch.ops.rs_torch import get_codec, pack_shards
    from minio_tpu_torch.runtime.dispatch import DispatchQueue
    codec = get_codec(4, 2, device=dev)
    cases = [_encode_hashed_case(codec, 300 + s) for s in range(32)]
    full = np.concatenate([np.random.default_rng(9).integers(
        0, 256, (4, 8192), dtype=np.uint8)])
    q = DispatchQueue(dev, max_batch=8, max_delay=0.002)
    ptl.configure()
    ptl.reset()
    pdev.reset()
    before = pdev.occupancy_totals()
    t0 = time.monotonic()
    try:
        futs = [q.encode_hashed(codec, w, HIGHWAY_KEY, 4096, 0)
                for w, _, _ in cases]
        masks = codec.target_masks_np((0, 2, 3, 4), (1,))
        futs += [q.masked(codec, pack_shards(full), masks)
                 for _ in range(6)]
        for f in futs:
            f.result(timeout=120)
        wall = time.monotonic() - t0
    finally:
        q.stop()
    assert q.stats()["obs_errors"] == 0
    st = pdev.status()
    ends = [e for e in ptl.snapshot() if e["type"] == "flush_end"]
    for op in ("encode_hashed", "reconstruct"):
        row = st["roofline"][op]
        walls = [e["dur"] for e in ends if e["op"] == op]
        assert row["flushes"] == len(walls) >= 1
        assert 0 < row["device_seconds"] <= sum(walls)
        ceiling = pdev.roofline_gibs()
        if ceiling is None:
            assert row["roofline_ratio"] is None
        else:
            assert 0 < row["roofline_ratio"] <= 1.05
    share = pdev.occupancy_share(before, pdev.occupancy_totals(),
                                 wall)[str(dev)]
    assert 0.0 < share["union"] <= 1.0
    assert set(share["lanes"]) == {"bulk", "interactive"}
    assert all(0.0 < v <= 1.0 for v in share["lanes"].values())
    assert share["union"] <= sum(share["lanes"].values()) + 1e-9
    assert st["ledger_balanced"]
    assert st["ledger"]["bulk"]["acquired_total"] >= 4
    assert st["card"] == torch.cuda.get_device_name(dev)


def test_device_memory_rows_once_cuda_is_live(dev):
    from minio_tpu_torch.obs import device as pdev
    torch.empty(1 << 20, device=dev)
    rows = pdev.device_memory()
    assert rows and rows[0]["name"] == torch.cuda.get_device_name(0)
    assert rows[0]["peak_bytes_in_use"] >= rows[0]["bytes_in_use"] >= 0
    assert rows[0]["bytes_limit"] > rows[0]["free_bytes"] > 0


_SCRAPE_PROBE = r"""
import sys, tempfile, torch
from minio_tpu_torch.obs import device, metrics
from minio_tpu_torch.objectlayer import ErasureObjects
from minio_tpu_torch.server import S3Server
from minio_tpu_torch.storage import XLStorage
d = tempfile.mkdtemp()
layer = ErasureObjects([XLStorage(f"{d}/d{i}") for i in range(4)],
                       default_parity=2, device="cpu")
srv = S3Server(layer, "127.0.0.1", 0, device="cpu")
text = metrics.render_prometheus(srv, "node").decode()
assert not torch.cuda.is_initialized(), "a scrape initialised CUDA"
assert "minio_tpu_device_hbm_bytes_in_use" not in text
assert device.status()["device_memory"] == []
from minio_tpu_torch.runtime.dispatch import DispatchQueue
from minio_tpu_torch.ops.rs_torch import get_codec, pack_shards
import numpy as np
q = DispatchQueue("cuda")
q.encode(get_codec(4, 2, device="cuda"), pack_shards(np.zeros(
    (4, 4096), np.uint8))).result(timeout=120)
q.stop()
text = metrics.render_prometheus(srv, "node").decode()
assert "minio_tpu_device_hbm_bytes_in_use" in text
assert "minio_tpu_device_obs_stream_occupancy_ratio" in text
print("ok")
"""


def test_scrape_never_initialises_cuda_before_a_flush(dev):
    import os
    import pathlib
    import subprocess
    import sys
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    r = subprocess.run([sys.executable, "-c", _SCRAPE_PROBE], cwd=repo,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.split()[-1] == "ok", \
        r.stderr[-3000:]


def test_capture_trace_on_the_card(dev):
    """The admin plane's torch.profiler session while a queue flushes on
    the card: a Chrome trace comes back (the device time by kernel name is
    whatever CUPTI gave the profiler, reported, not required)."""
    import json
    import os
    import shutil
    import threading
    from minio_tpu_torch.erasure.bitrot import HIGHWAY_KEY
    from minio_tpu_torch.obs import device as pdev
    from minio_tpu_torch.ops.rs_torch import get_codec
    from minio_tpu_torch.runtime.dispatch import DispatchQueue
    codec = get_codec(4, 2, device=dev)
    cases = [_encode_hashed_case(codec, 500 + s) for s in range(16)]
    q = DispatchQueue(dev, max_batch=4, max_delay=0.001)
    stop = threading.Event()

    def load():
        while not stop.is_set():
            for f in [q.encode_hashed(codec, w, HIGHWAY_KEY, 4096, 0)
                      for w, _, _ in cases]:
                f.result(timeout=120)

    t = threading.Thread(target=load)
    t.start()
    try:
        out = pdev.capture_trace(0.5)
    finally:
        stop.set()
        t.join(timeout=120)
        q.stop()
    assert not t.is_alive()
    try:
        with open(os.path.join(out["logdir"], "trace.json")) as f:
            assert json.load(f)["traceEvents"]
        assert isinstance(out["device_seconds_by_name"], dict)
        share = out["device_busy_share"]
        assert share is not None and 0.0 <= share <= 1.0
        assert out["device_idle_share"] == pytest.approx(1.0 - share)
    finally:
        shutil.rmtree(out["logdir"], ignore_errors=True)


def _tree(root) -> dict:
    import os
    out = {}
    for d, _sub, names in os.walk(str(root)):
        if ".minio.sys" in d:
            continue
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), str(root))] = \
                    f.read()
    return out


REPL_BODIES = {f"r{n}": np.random.default_rng(n + 16).bytes(n)
               for n in (70_000, (2 << 20) + 5, (4 << 20) + 333)}


def _replication_run(root, device) -> tuple:
    """Objects PUT into one 16+4 / 1 MiB set on ``device`` (None = the
    card), two drives' copies of the bucket taken away, then replicated
    by a ReplicationPool (one worker) to an S3Server over a second set:
    every source read rebuilds. Returns the replicas' bytes and every
    file of the target set."""
    import os
    import shutil
    import time
    from minio_tpu_torch.bucket.replication import ReplicationPool, S3Target
    from minio_tpu_torch.objectlayer import ErasureObjects
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.storage.xlstorage import XLStorage

    def layer(name):
        return ErasureObjects([XLStorage(os.path.join(str(root), name,
                                                      f"d{i:02d}"))
                               for i in range(20)], default_parity=4,
                              block_size=1 << 20, device=device)

    src, dst_layer = layer("src"), layer("dst")
    dst = S3Server(dst_layer, "127.0.0.1", 0, access_key=S3_AK,
                   secret_key=S3_SK, device=device)
    dst.start_background()
    src.make_bucket("rb")
    for name, data in REPL_BODIES.items():
        src.put_object("rb", name, io.BytesIO(data), len(data))
    for i in (3, 11):
        shutil.rmtree(os.path.join(str(root), "src", f"d{i:02d}", "rb"))
    pool = ReplicationPool(src, workers=1).start()
    try:
        pool.set_target("rb", S3Target(dst.endpoint(), S3_AK, S3_SK, "rb"))
        assert pool.resync("rb") == len(REPL_BODIES)
        deadline = time.monotonic() + 300
        while pool.replicated + pool.failed < len(REPL_BODIES):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        pool.drain()
        assert pool.failed == 0
        got = {n: dst_layer.get_object_bytes("rb", n) for n in REPL_BODIES}
    finally:
        pool.stop()
        dst.shutdown()
    return got, _tree(os.path.join(str(root), "dst"))


def test_replication_of_a_degraded_source_on_card_matches_cpu(
        dev, tmp_path, monkeypatch):
    """The pool's reads of a source missing two drives rebuild on K1 and
    the target's PUTs run K2 and K5: the replicas and the target's files
    equal the CPU run's."""
    from minio_tpu_torch.ops import hh_cuda, rs_cuda
    _pin_object_ids(monkeypatch)
    rs_cuda.reset_launches()
    hh_cuda.reset_launches()
    card = _replication_run(tmp_path / "card", None)
    launched = {**rs_cuda.launches, **hh_cuda.launches}
    _pin_object_ids(monkeypatch)
    host = _replication_run(tmp_path / "cpu", "cpu")
    assert card[0] == REPL_BODIES == host[0]
    assert card[1] == host[1]
    for name in ("gf_matmul_batched", "gf_encode_batched",
                 "highwayhash256_chunks"):
        assert launched[name] > 0, name


def _restore_run(root, device, monkeypatch) -> tuple:
    """An object PUT into one 16+4 / 1 MiB set on ``device``, transitioned
    to a TierFS tier (its read verified, a stub written), its stub read
    through, then restored (its bytes PUT back). Returns the read-through
    and restored bytes and every file of the set and of the tier."""
    import itertools
    import os
    import types
    import uuid
    from minio_tpu_torch.bucket import transition as tx
    from minio_tpu_torch.bucket.tiers import TierFS
    from minio_tpu_torch.objectlayer import ErasureObjects
    from minio_tpu_torch.storage.xlstorage import XLStorage
    ids = itertools.count(1)
    monkeypatch.setattr(tx, "uuid", types.SimpleNamespace(
        uuid4=lambda: uuid.UUID(int=(1 << 90) + next(ids))))
    monkeypatch.setattr(tx, "time", types.SimpleNamespace(
        time=lambda: 1.75e9))
    ol = ErasureObjects([XLStorage(os.path.join(str(root), "set",
                                                f"d{i:02d}"))
                         for i in range(20)], default_parity=4,
                        block_size=1 << 20, device=device)
    tiers = types.SimpleNamespace(get={
        "COLD": TierFS("COLD", os.path.join(str(root), "tier"))}.get)
    ts = tx.TransitionSys(ol, tiers)
    data = REPL_BODIES["r4194637"]
    ol.make_bucket("tb")
    ol.put_object("tb", "o", io.BytesIO(data), len(data))
    assert ts.transition("tb", ol.get_object_info("tb", "o"), "COLD")
    stub = ol.get_object_info("tb", "o")
    assert stub.size == 0 and tx.is_transitioned(stub)
    through = ts.read(stub)
    ts.restore("tb", stub, 2)
    restored = ol.get_object_bytes("tb", "o")
    return through, restored, _tree(root)


def test_restore_of_a_transitioned_object_on_card_matches_cpu(
        dev, tmp_path, monkeypatch):
    """Transition (K5 verifying the read), read-through and restore (K2
    and K5 writing the bytes back) on the card give the CPU run's bytes
    and files."""
    from minio_tpu_torch.ops import hh_cuda, rs_cuda
    _pin_object_ids(monkeypatch)
    rs_cuda.reset_launches()
    hh_cuda.reset_launches()
    card = _restore_run(tmp_path / "card", None, monkeypatch)
    launched = {**rs_cuda.launches, **hh_cuda.launches}
    _pin_object_ids(monkeypatch)
    host = _restore_run(tmp_path / "cpu", "cpu", monkeypatch)
    data = REPL_BODIES["r4194637"]
    assert card[0] == card[1] == data == host[0] == host[1]
    assert card[2] == host[2]
    for name in ("gf_encode_batched", "highwayhash256_chunks"):
        assert launched[name] > 0, name


CLUSTER_BODIES = {f"c{n}": np.random.default_rng(n + 32).bytes(n)
                  for n in (90_000, (1 << 20) + 3, (3 << 20) + 333)}


def _cluster_run(root, device) -> tuple:
    """A 2-node LocalCluster (2 x 4 drives: one 8-drive set at 4+4, 1 MiB
    blocks) on ``device`` (None = the card): PUTs through node 0, one
    node's copies of the bucket on two drives taken away, GETs through
    node 1 (degraded: K1 rebuilds over the storage RPC). Returns the GET
    bytes and every file of the cluster's drives."""
    import os
    import shutil
    from minio_tpu_torch.dist.harness import LocalCluster
    lc = LocalCluster(str(root), nodes=2, disks_per_node=4, parity=None,
                      device=device, block_size=1 << 20)
    try:
        ol0, ol1 = lc.nodes[0].obj, lc.nodes[1].obj
        ol0.make_bucket("b")
        for name, data in CLUSTER_BODIES.items():
            ol0.put_object("b", name, io.BytesIO(data), len(data))
        for d in (0, 3):
            shutil.rmtree(os.path.join(str(root), "n0", f"d{d}", "b"))
        got = {name: ol1.get_object_bytes("b", name)
               for name in CLUSTER_BODIES}
    finally:
        lc.shutdown()
    return got, _tree(root)


def test_cluster_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """Two nodes on the card (one process, one dispatch queue) and two on
    the CPU take the same PUTs and degraded GETs and leave the same
    files; K2, K1 and K5 launch on the card's."""
    from minio_tpu_torch.ops import hh_cuda, rs_cuda
    _pin_object_ids(monkeypatch)
    rs_cuda.reset_launches()
    hh_cuda.reset_launches()
    card = _cluster_run(tmp_path / "card", None)
    launched = {**rs_cuda.launches, **hh_cuda.launches}
    _pin_object_ids(monkeypatch)
    host = _cluster_run(tmp_path / "cpu", "cpu")
    for name, data in CLUSTER_BODIES.items():
        assert card[0][name] == data and host[0][name] == data
    assert card[1] == host[1] and len(card[1]) >= 3 * 6
    for name in ("gf_encode_batched", "gf_matmul_batched",
                 "highwayhash256_chunks"):
        assert launched[name] > 0, name
