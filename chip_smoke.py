#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (minio_tpu_torch) on one card.

    python3 chip_smoke.py                  # the full run, needs a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny host-only dry run of the
                                           # same phases (never prints ok)

Phases, each printing one JSON line:

1. build — compiles minio_tpu_torch/csrc/*.cu with nvcc (one process per
   source, all at once) into build/minio_tpu_torch/, cached by content hash.
2. card — the card's name and power limit from nvidia-smi.
3. kernels — each hand-written kernel (K1-K5) at the shapes the paths give
   it, batched and single-block, held bit-exact against its plain PyTorch
   version on the card, with CUDA-event medians, the plain version's time,
   the computed bound and a device-to-device copy of the same bytes as the
   measured memory floor.
4. main path (MUR3X256S) — a 16+4 erasure set over 20 disk directories,
   1 MiB blocks, MUR3X256S bitrot with 16 KiB chunks: 128 objects of 4 MiB
   PUT from 128 threads through erasure_encode, GET back, two data shards
   of every object removed and a degraded GET of all, one flipped byte
   detected with the GET still exact, and erasure_heal of all 128 objects
   with the healed files byte-identical to the originals. One object's
   first block is also checked against the host reference math.
5. SSE path (HighwayHash256S, the default bitrot algorithm) — 128 SSE-C
   ChaCha20-Poly1305 objects of 4 MiB (every second one 333 bytes short,
   so it ends in a short package), each under its own customer key made
   from --seed, at 16+4 / 1 MiB / 16 KiB chunks: PUT through
   EncryptReader into erasure_encode, whole GET and a ranged GET across a
   package boundary through DecryptWriter, degraded GET with two data
   shards gone, and heal; every plaintext byte is compared, the healed
   files are byte-identical, and the host Poly1305 seconds are reported.
   Every keystream (full packages, short packages, the key envelope) is
   K4's.

Kernel launch counts are reset just before each path (each SSE sub-phase)
and read just after; every kernel a path should run must have launched.
Then the {"kernels": [...]} summary line and, last, the ok line. Any
failure exits non-zero without the ok line; so does a host without CUDA.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM rates of the bounds. HBM3 bytes/s. Integer instructions the
#: SMs can issue: 128 lanes/clk/SM * 132 SMs * 1.98 GHz (the float32 peak
#: of 67 TFLOP/s, which counts a fused multiply-add as two). The integer
#: ALU pipe alone runs half of that: bitwise logic (XOR, AND, OR: LOP3) has
#: no other pipe, while adds, shifts, rotates and multiplies can also issue
#: on the FMA pipe (IMAD forms), so only logic is held to the ALU's rate.
HBM_BYTES_S = 3.35e12
ISSUE_OPS_S = 128 * 132 * 1.98e9
LOGIC_OPS_S = 64 * 132 * 1.98e9

K, M = 16, 4
BLOCK = 1 << 20
CHUNK = 16384
N_OBJECTS = 128
OBJECT_BYTES = 4 << 20
#: every second SSE object is this many bytes short of whole packages
TAIL_SHORT = 333
#: CUDA-event timings per kernel: the median of this many launches
REPS = 20
#: the plain versions' timings: the median of this many calls
PLAIN_REPS = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# --- timing ---------------------------------------------------------------


def time_ms(fn, reps: int, device) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls after one warm-up
    call: CUDA events around each call on the card, the host clock on the
    CPU (rehearsal only)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def copy_floor_ms(nbytes: int, reps: int, device) -> float:
    """A device-to-device copy that reads and writes ``nbytes`` in all."""
    import torch
    n = max(1, nbytes // 8)
    src = torch.empty(n, dtype=torch.int32, device=device)
    dst = torch.empty_like(src)
    return time_ms(lambda: dst.copy_(src), reps, device)


def max_abs_err(a, b) -> int:
    from minio_tpu_torch.ops.rs_torch import to_u32_i64
    if a.shape != b.shape or a.dtype != b.dtype:
        raise PhaseError(f"{a.dtype} {tuple(a.shape)} != "
                         f"{b.dtype} {tuple(b.shape)}")
    return int((to_u32_i64(a) - to_u32_i64(b)).abs().max().item())


def fixed_matrix_ops(mat) -> tuple[int, int]:
    """(integer operations, of them bitwise logic) per word column for a
    product by a matrix known before launch (K2): only the set coefficient
    bits cost work. Per output row and bit plane, the set bits' words fold
    into the accumulator two at a time (one 3-input LOP3 per pair), and the
    7 Horner doublings take 5 ops each, 3 of them logic."""
    import numpy as np
    bits = np.unpackbits(np.asarray(mat, dtype=np.uint8)[..., None], axis=-1)
    per_plane = bits.sum(axis=1)  # [o, 8]: set bits per row and plane
    folds = int(((per_plane + 1) // 2).sum())
    return folds + 35 * len(mat), folds + 21 * len(mat)


def bound_ms(nbytes: int, ops: int, logic_ops: int) -> tuple[float, str]:
    """The least time of the work: its bytes over the memory rate, or its
    integer operations over the issue rate, or its bitwise logic over the
    ALU pipe's rate, whichever is largest."""
    tb = nbytes / HBM_BYTES_S * 1e3
    to = max(ops / ISSUE_OPS_S, logic_ops / LOGIC_OPS_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# --- phases ---------------------------------------------------------------


def phase_build(rehearsal: bool) -> None:
    from minio_tpu_torch.ops import cuda_build
    if rehearsal:
        emit({"phase": "build", "skipped": "cpu rehearsal"})
        return
    t0 = time.monotonic()
    took = cuda_build.build()
    ptxas = {}
    for name in cuda_build.SIGNATURES:
        lines = [ln.strip() for ln in cuda_build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        ptxas[name] = lines[:8]
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "per_library_s": {k: round(v, 3) for k, v in took.items()},
          "ptxas": ptxas})


def phase_card(rehearsal: bool) -> str:
    if rehearsal:
        emit({"phase": "card", "skipped": "cpu rehearsal"})
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(out, flush=True)
    emit({"phase": "card", "nvidia_smi": out})
    return out


def _words(gen, shape, device):
    import numpy as np
    import torch
    return torch.from_numpy(gen.integers(
        -2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).to(device)


def _err(got, want) -> int:
    """Largest word difference over a result or a tuple of results."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    return max(max_abs_err(a, b) for a, b in zip(got, want))


def kernel_row(name: str, source: str, replaces: str, shape: str, run,
               plain, nbytes: int, ops: tuple[int, int], device) -> dict:
    """One kernel at one shape: held word for word against its plain
    version on the same inputs, then timed (CUDA-event medians), with the
    bound of the work, what bounds it, and a device-to-device copy of the
    same bytes as the measured memory floor."""
    err = _err(run(), plain())
    check(err == 0, f"{name} at {shape} disagrees with its plain version: "
          f"max_abs_err {err}")
    b_ms, b_by = bound_ms(nbytes, *ops)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "shape": shape, "max_abs_err": err,
           "ms": time_ms(run, REPS, device),
           "plain_ms": time_ms(plain, PLAIN_REPS, device),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "copy_floor_ms": copy_floor_ms(nbytes, REPS, device)}
    emit({"phase": "kernel", **row})
    return row


def chacha_ops(items: int, pkgs: int, words: int) -> tuple[int, int]:
    """(int32 operations, of them XORs) of the ChaCha20 XOR: per data block
    the 960 of the rounds (320 adds, 320 XORs, 320 rotates), 16
    feed-forward adds and 16 XORs with the payload; per package key block
    the rounds and the 8 feed-forward adds its Poly1305 key needs."""
    per = items * pkgs
    return (per * ((words // 16) * 992 + 968),
            per * ((words // 16) * 336 + 320))


def chacha_bytes(items: int, pkgs: int, words: int) -> int:
    """Payload in and out, keys and nonces in, Poly1305 keys out."""
    return 4 * items * pkgs * (2 * words + 3 + 8) + 32 * items


def hh_ops(n: int, nbytes: int) -> tuple[int, int]:
    """(int32 operations, of them XORs) of HighwayHash-256 per chunk
    (64-bit adds and XORs as 2, the 32x32->64 multiply as 2, a byte
    permute as 1): 96 per 32-byte packet, 112 for a remainder packet (its
    length add, half rotates and update), 1,018 for the key set-up, 10
    finalize rounds and the modular reduction; the XORs of the packet
    updates, 16 per packet, are the logic (the rest is left out, which
    only lowers the bound)."""
    packets = nbytes // 32 + (1 if nbytes % 32 else 0)
    return (n * (96 * (nbytes // 32) + (112 if nbytes % 32 else 0) + 1018),
            n * 16 * packets)


#: SASS opcodes by the pipe that issues them (Hopper); the uniform
#: datapath's U* opcodes and anything else fall under "other"
_PIPES = {
    "alu": ("IADD3", "LOP3", "SHF", "PRMT", "ISETP", "SEL", "LEA", "IABS",
            "IMNMX", "FLO", "MOV", "PLOP3", "SGXT", "BMSK"),
    "fma": ("IMAD", "IMUL", "FFMA", "FADD", "FMUL"),
    "memory": ("LDG", "STG", "LD", "ST", "LDS", "STS", "LDC"),
    "control": ("BRA", "EXIT", "BSSY", "BSYNC", "RET", "CALL", "BAR",
                "WARPSYNC"),
}


def sass_mix(lib: str, symbol: str) -> dict:
    """Static SASS instruction counts of one kernel of a built library, by
    issuing pipe (``cuobjdump -sass``, beside nvcc; NOP padding left out).
    The kernels are fully unrolled, so this is what one thread issues,
    both branches of a lane kind included."""
    import re
    from minio_tpu_torch.ops import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-sass", cuda_build.target(lib)[1]],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts = {k: 0 for k in (*_PIPES, "other")}
    ops: dict = {}
    inside = False
    for line in dump.splitlines():
        if "Function :" in line:
            inside = symbol in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if not inside or not m or m.group(1) == "NOP":
            continue
        base = m.group(1).split(".")[0]
        ops[base] = ops.get(base, 0) + 1
        pipe = next((p for p, names in _PIPES.items() if base in names),
                    "other")
        counts[pipe] += 1
    check(sum(counts.values()) > 0, f"no SASS found for {symbol} in {lib}")
    return {"per_pipe": counts, "total": sum(counts.values()),
            "by_opcode": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}


def phase_kernels(device, small: bool) -> dict:
    """Each kernel against its plain version at the shapes the paths give
    it: the batched shapes of a 128-object flush and the B = 1 / I = 1
    shapes of the single-block entry points."""
    import numpy as np
    import torch
    from minio_tpu_torch.erasure.bitrot import HIGHWAY_KEY
    from minio_tpu_torch.native.mur3py import seeds_from_key
    from minio_tpu_torch.ops import (chacha_cuda, chacha_torch, gf256,
                                     hh_cuda, hh_torch, mur3_cuda, rs_cuda)
    from minio_tpu_torch.ops.rs_torch import get_codec

    B, W = (4, 1024 + 4) if small else (128, BLOCK // K // 4)
    gen = np.random.default_rng(7)
    x = _words(gen, (B, K, W), device)
    codec = get_codec(K, M, device=device)
    gf_src = "minio_tpu_torch/csrc/gf_matmul.cu"
    rows = {}

    # K2: the fixed 16+4 encode matrix over the batch, and over one block
    # (ReedSolomon.encode)
    par = codec.parity_rows
    enc_masks = torch.from_numpy(
        gf256.coeff_masks(par).view(np.int32)).to(device)
    enc = []
    for b, replaces in ((B, "minio_tpu/ops/rs_pallas.py:300"),
                        (1, "minio_tpu/ops/rs_pallas.py:224")):
        xb = x[:b]
        enc.append(kernel_row(
            "gf_encode_batched", gf_src, replaces, f"B={b} {K}+{M} W={W}",
            lambda xb=xb: rs_cuda.gf_encode_batched(par, xb),
            lambda xb=xb: rs_cuda.gf_matmul_batched_ref(enc_masks, xb),
            4 * b * W * (K + M),
            tuple(b * W * v for v in fixed_matrix_ops(par)), device))
    rows["gf_encode_batched"] = {**enc[0], "also": enc[1:]}

    # K1: per-element masks, known only at run time, so every coefficient
    # bit costs one LOP3 ((mask & x) ^ acc), plus 7 doublings of 5 ops (3
    # of them logic) per output word — o=2 (two lost data shards per
    # item: degraded GET and heal), o=20 (reconstruct_batch), and o=2 at
    # B = 1 (ReedSolomon.reconstruct of one block)
    mm = []
    for b, o, replaces in ((B, 2, "minio_tpu/ops/rs_pallas.py:147"),
                           (B, K + M, "minio_tpu/ops/rs_pallas.py:147"),
                           (1, 2, "minio_tpu/ops/rs_pallas.py:89")):
        masks = np.empty((b, 8, o, K), dtype=np.uint32)
        for e in range(b):
            lost = sorted(gen.choice(K + M, size=M, replace=False))
            present = tuple(i for i in range(K + M) if i not in lost)[:K]
            targets = tuple(int(t) for t in lost[:2]) if o == 2 \
                else tuple(range(K + M))
            masks[e] = gf256.coeff_masks(codec.rebuild_rows(present, targets))
        mk = torch.from_numpy(masks.view(np.int32)).to(device)
        xb = x[:b]
        mm.append(kernel_row(
            "gf_matmul_batched", gf_src, replaces, f"B={b} o={o} i={K} W={W}",
            lambda mk=mk, xb=xb: rs_cuda.gf_matmul_batched(mk, xb),
            lambda mk=mk, xb=xb: rs_cuda.gf_matmul_batched_ref(mk, xb),
            4 * b * (K * W + o * W + 8 * o * K),
            (b * W * o * (8 * K + 35), b * W * o * (8 * K + 21)), device))
    rows["gf_matmul_batched"] = {**mm[0], "also": mm[1:]}

    # K3: digests of every 16 KiB chunk of a 128-item 16+4 batch (44 ops
    # per 16-byte packet, 8 of them XORs)
    nc = (W * 4) // CHUNK if not small else 2
    cw = CHUNK // 4 if not small else 64
    data = _words(gen, (B, K + M, nc, cw), device)
    seeds = seeds_from_key(HIGHWAY_KEY)
    n = B * (K + M) * nc
    rows["mur3x256_chunks"] = kernel_row(
        "mur3x256_chunks", "minio_tpu_torch/csrc/mur3x256.cu",
        "minio_tpu/ops/mur3_pallas.py:164", f"N={n} chunks x {cw * 4} B",
        lambda: mur3_cuda.mur3x256_chunks(seeds, cw * 4, data),
        lambda: mur3_cuda.mur3x256_ref(seeds, cw * 4, data),
        n * cw * 4 + n * 32, (n * (cw // 4) * 44, n * (cw // 4) * 8), device)

    # K4: the sse_xor flush (128 objects of 16 packages of 64 KiB, each
    # object under its own key), and one object's packages under one key
    # (I = 1, the shape of xor_packages, whose wrapper is held to its plain
    # version too; the row times the kernel alone, without that wrapper's
    # nonce read-back)
    items, pkgs, pw = (3, 2, 64) if small else (N_OBJECTS, 16, 16384)
    keys = _words(gen, (items, 8), device)
    nonces = _words(gen, (items, pkgs, 3), device)
    # package sequence numbers near 2**32 - 1, key words with the top bit
    nonces[:, :, 2] = -1 - torch.arange(pkgs, dtype=torch.int32,
                                        device=device)
    keys[:, 0] |= -2**31
    payload = _words(gen, (items, pkgs, pw), device)
    ch_src = "minio_tpu_torch/csrc/chacha20.cu"
    multi = kernel_row(
        "chacha20_xor", ch_src, "minio_tpu/ops/chacha_pallas.py:210",
        f"I={items} P={pkgs} W={pw}",
        lambda: chacha_cuda.chacha20_xor(keys, nonces, payload),
        lambda: chacha_torch.multi_xor(keys, nonces, payload),
        chacha_bytes(items, pkgs, pw), chacha_ops(items, pkgs, pw), device)
    key0 = gen.bytes(32)
    one_nonce = nonces[0].clone()
    one_nonce[:, :2] = one_nonce[0, :2]
    err = _err(chacha_cuda.xor_packages(key0, one_nonce, payload[0]),
               chacha_torch.xor_packages(key0, one_nonce, payload[0]))
    check(err == 0, f"xor_packages disagrees with its plain version: "
          f"max_abs_err {err}")
    kw0 = chacha_torch.key_words(key0, device)
    single = kernel_row(
        "chacha20_xor", ch_src, "minio_tpu/ops/chacha_pallas.py:92",
        f"I=1 P={pkgs} W={pw}",
        lambda: chacha_cuda.chacha20_xor(kw0, one_nonce[None], payload[:1]),
        lambda: chacha_torch.multi_xor(kw0, one_nonce[None], payload[:1]),
        chacha_bytes(1, pkgs, pw), chacha_ops(1, pkgs, pw), device)
    rows["chacha20_xor"] = {**multi, "also": [single]}
    if not small:
        multi["sass"] = sass_mix("chacha20", "chacha20_kernelILb1E")
        emit({"phase": "sass", "kernel": "chacha20_kernel<true>",
              **multi["sass"]})

    # K5: every 16 KiB chunk of a 128-item 16+4 flush, and the short tail
    # chunks of the SSE objects' last block (64 B: 1 KiB of ciphertext over
    # 16 data shards) and of a remainder past the last packet (1,028 B)
    kw = hh_torch.key_words(HIGHWAY_KEY)
    hh = []
    for n, nbytes in ((B * (K + M) * nc, cw * 4),
                      (B * (K + M), 64), (B * (K + M), 1028)):
        d = _words(gen, (n, nbytes // 4), device)
        hh.append(kernel_row(
            "highwayhash256_chunks", "minio_tpu_torch/csrc/highwayhash.cu",
            "minio_tpu/ops/hh_jax.py:302", f"N={n} chunks x {nbytes} B",
            lambda d=d, nb=nbytes: hh_cuda.highwayhash256_chunks(kw, nb, d),
            lambda d=d, nb=nbytes: hh_cuda.highwayhash256_ref(kw, nb, d),
            n * nbytes + n * 32, hh_ops(n, nbytes), device))
    rows["highwayhash256_chunks"] = {**hh[0], "also": hh[1:]}
    return rows


def _disk_root(name: str) -> str:
    """Disk directories live inside the checkout (build/ is git-ignored)."""
    root = os.path.join(HERE, "build", "minio_tpu_torch",
                        f"smoke_disks_{os.getpid()}", name)
    os.makedirs(root, exist_ok=True)
    return root


def _percentile(vals: list, q: float) -> float:
    s = sorted(vals)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def _kernel_modules():
    from minio_tpu_torch.ops import chacha_cuda, hh_cuda, mur3_cuda, rs_cuda
    return rs_cuda, mur3_cuda, chacha_cuda, hh_cuda


def reset_launches() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


def read_launches() -> dict:
    out = {}
    for mod in _kernel_modules():
        out.update(mod.launches)
    return out


def _phase_row(q, total: int, wall: float) -> dict:
    """Wall, GiB/s and the dispatch queue's flush statistics of one
    sub-phase (the queue's counters were reset just before it)."""
    st = q.stats()
    return {"wall_s": wall, "gib_s": total / wall / 2**30,
            "flushes": st["batches"], "items": st["items"],
            "items_per_flush": st["avg_batch"],
            "max_items_per_flush": st["max_items"],
            "items_per_flush_by_op": {
                op: v["items"] / v["batches"]
                for op, v in st["ops"].items() if v["batches"]},
            "dispatcher_busy_s": st["flush_seconds"],
            "dispatcher_busy_share": st["flush_seconds"] / wall,
            "ops": {op: v for op, v in st["ops"].items() if v["items"]}}


def phase_main(device, n_objects: int, obj_bytes: int, seed: int) -> dict:
    """The MUR3X256S path: objects PUT, GET, degraded GET, corrupted
    GET and healed (see the module docstring)."""
    import numpy as np
    from minio_tpu_torch.erasure import (BitrotAlgorithm, Erasure,
                                         new_bitrot_reader, new_bitrot_writer)
    from minio_tpu_torch.erasure.bitrot import (HIGHWAY_KEY,
                                                pick_bitrot_chunk)
    from minio_tpu_torch.erasure.streaming import (BufferSink,
                                                   erasure_decode,
                                                   erasure_encode,
                                                   erasure_heal)
    from minio_tpu_torch.native import mur3py
    from minio_tpu_torch.ops import gf256
    from minio_tpu_torch.runtime.dispatch import global_queue
    from minio_tpu_torch.storage.xlstorage import XLStorage
    from minio_tpu_torch.utils import errors

    algo = BitrotAlgorithm.MUR3X256S
    er = Erasure(K, M, BLOCK, device=device)
    chunk = pick_bitrot_chunk(er.shard_size(), CHUNK)
    check(chunk == CHUNK, f"bitrot chunk {chunk} != {CHUNK}")
    root = _disk_root("mur3")
    disks = [XLStorage(os.path.join(root, f"d{i:02d}"))
             for i in range(K + M)]
    backup = os.path.join(root, "removed")
    gen = np.random.default_rng(seed)
    objs = [gen.bytes(obj_bytes) for _ in range(n_objects)]
    total = n_objects * obj_bytes
    till = er.shard_file_size(obj_bytes)
    lost = (0, 1)  # two data shards of every object
    q = global_queue(device)
    result = {"objects": n_objects, "object_bytes": obj_bytes,
              "geometry": f"{K}+{M}", "block": BLOCK, "chunk": chunk,
              "algo": algo.value, "threads": n_objects, "disk_root": root}

    def path(j):
        return f"obj{j:04d}/part.1"

    def readers(j, drop=()):
        return [None if i in drop else new_bitrot_reader(
            disks[i].read_file_at("bucket", path(j)), algo, till, chunk)
            for i in range(K + M)]

    def put(j):
        ws = [new_bitrot_writer(d.create_file_writer("bucket", path(j)),
                                algo, chunk) for d in disks]
        n = erasure_encode(er, io.BytesIO(objs[j]), ws, K)
        for w in ws:
            w.close()
        return n

    def get(j, drop=()):
        out = BufferSink()
        st = erasure_decode(er, out, readers(j, drop), 0, obj_bytes,
                            obj_bytes)
        return out.getvalue(), st

    def heal(j):
        t0 = time.monotonic()
        ws = [new_bitrot_writer(disks[i].create_file_writer(
            "bucket", path(j)), algo, chunk) if i in lost else None
            for i in range(K + M)]
        erasure_heal(er, ws, readers(j, lost), obj_bytes)
        return time.monotonic() - t0

    def run(fn, label):
        q.reset_stats()
        t0 = time.monotonic()
        with ThreadPoolExecutor(max_workers=n_objects) as ex:
            res = list(ex.map(fn, range(n_objects)))
        result[label] = _phase_row(q, total, time.monotonic() - t0)
        return res

    reset_launches()

    counts = run(put, "put")
    check(counts == [obj_bytes] * n_objects, "PUT consumed a wrong size")

    got = run(lambda j: get(j)[0], "get")
    bad = [j for j in range(n_objects) if got[j] != objs[j]]
    check(not bad, f"GET mismatch on objects {bad[:5]}")
    del got

    # one object's first block against the host reference math: parity
    # via gf256.gf_matmul_ref, digests via the pure-Python MUR3X256
    blk = np.frombuffer(objs[0][:BLOCK], dtype=np.uint8).reshape(K, -1)
    ref_par = gf256.gf_matmul_ref(er.codec.parity_rows, blk)
    for i in range(K + M):
        raw = disks[i].read_file_at("bucket", path(0)).read_at(
            0, 32 + chunk)
        shard = blk[i] if i < K else ref_par[i - K]
        check(raw[32:] == shard[:chunk].tobytes(),
              f"shard {i} block 0 disagrees with the host reference")
        check(raw[:32] == mur3py.digest256_py(
            HIGHWAY_KEY, shard[:chunk].tobytes()),
              f"shard {i} digest disagrees with the host reference")

    os.makedirs(backup, exist_ok=True)
    for j in range(n_objects):
        for i in lost:
            src = os.path.join(disks[i].root, "bucket", path(j))
            dst = os.path.join(backup, f"d{i:02d}_{j:04d}")
            os.replace(src, dst)

    got = run(lambda j: get(j, lost)[0], "degraded_get")
    bad = [j for j in range(n_objects) if got[j] != objs[j]]
    check(not bad, f"degraded GET mismatch on objects {bad[:5]}")
    del got

    # flip one payload byte of a surviving data shard of object 0
    victim = 2
    vpath = os.path.join(disks[victim].root, "bucket", path(0))
    with open(vpath, "r+b") as f:
        f.seek(32 + 1000)
        byte = f.read(1)
        f.seek(32 + 1000)
        f.write(bytes([byte[0] ^ 0x5A]))
    data0, st = get(0, lost)
    check(data0 == objs[0], "GET of the corrupted object is not exact")
    check(isinstance(st.errs[victim], errors.FileCorrupt),
          f"corrupt source not reported: {st.errs[victim]!r}")
    result["corruption"] = {"object": 0, "shard": victim,
                            "reported": type(st.errs[victim]).__name__,
                            "get_exact": True}

    lat = run(heal, "heal")
    result["heal"]["p50_ms"] = _percentile(lat, 0.50) * 1e3
    result["heal"]["p99_ms"] = _percentile(lat, 0.99) * 1e3
    for j in range(n_objects):
        for i in lost:
            with open(os.path.join(backup, f"d{i:02d}_{j:04d}"), "rb") as f:
                want = f.read()
            with open(os.path.join(disks[i].root, "bucket", path(j)),
                      "rb") as f:
                check(f.read() == want,
                      f"healed shard {i} of object {j} differs")
    result["heal"]["byte_identical"] = True

    launches = read_launches()
    result["launches"] = launches
    flushes = [result[p]["max_items_per_flush"]
               for p in ("put", "get", "degraded_get", "heal")]
    result["max_items_per_flush"] = max(flushes)
    if device.type == "cuda":
        for name in ("gf_matmul_batched", "gf_encode_batched",
                     "mur3x256_chunks"):
            check(launches[name] > 0,
                  f"kernel {name} never launched on the MUR3X256S path")
    check(max(flushes) > 1, "no flush coalesced more than one item")
    shutil.rmtree(root, ignore_errors=True)
    return result


class _Clock:
    """Time spent inside one module function, summed over every thread that
    calls it while installed: wall seconds (waits for the interpreter lock
    included) and the calling threads' CPU seconds (the host Poly1305 of
    the SSE path)."""

    def __init__(self, module, name: str):
        import threading
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.wall_s = self.cpu_s = 0.0
        self._lock = threading.Lock()

        def timed(*a, **kw):
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return self.fn(*a, **kw)
            finally:
                dt, dc = time.perf_counter() - t0, time.thread_time() - c0
                with self._lock:
                    self.wall_s += dt
                    self.cpu_s += dc
        self.timed = timed

    def __enter__(self):
        setattr(self.module, self.name, self.timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def phase_sse(device, n_objects: int, plain_bytes: int, seed: int) -> dict:
    """SSE-C ChaCha20-Poly1305 objects on HighwayHash256S erasure shards:
    each object, under its own customer key, is sealed by EncryptReader
    (sse_xor flushes, K4) into erasure_encode (encode_hashed: K2 + K5),
    read back whole and ranged through DecryptWriter (verify: K5), read
    with two data shards gone (fused: K1 + K5) and healed. Every plaintext
    byte is compared with the source; the launch counts are reset before
    and read after each sub-phase."""
    import base64
    import hashlib
    import numpy as np
    from minio_tpu_torch.crypto import chacha20poly1305 as ccp
    from minio_tpu_torch.crypto import sse
    from minio_tpu_torch.erasure import (BitrotAlgorithm, Erasure,
                                         new_bitrot_reader, new_bitrot_writer)
    from minio_tpu_torch.erasure.bitrot import (DEFAULT_BITROT_ALGO,
                                                pick_bitrot_chunk)
    from minio_tpu_torch.erasure.streaming import (BufferSink,
                                                   erasure_decode,
                                                   erasure_encode,
                                                   erasure_heal)
    from minio_tpu_torch.runtime.dispatch import global_queue
    from minio_tpu_torch.storage.xlstorage import XLStorage

    algo = BitrotAlgorithm.HIGHWAYHASH256S
    check(DEFAULT_BITROT_ALGO is algo, f"default bitrot algorithm is "
          f"{DEFAULT_BITROT_ALGO}, not {algo}")
    er = Erasure(K, M, BLOCK, device=device)
    chunk = pick_bitrot_chunk(er.shard_size(), CHUNK)
    check(chunk == CHUNK, f"bitrot chunk {chunk} != {CHUNK}")
    root = _disk_root("sse")
    disks = [XLStorage(os.path.join(root, f"d{i:02d}"))
             for i in range(K + M)]
    backup = os.path.join(root, "removed")
    gen = np.random.default_rng(seed + 1)
    # every second object ends in a short package (TAIL_SHORT bytes short
    # of whole packages), sealed and opened on the card as well
    sizes = [plain_bytes - (TAIL_SHORT if j % 2 else 0)
             for j in range(n_objects)]
    plains = [gen.bytes(n) for n in sizes]
    keys = [gen.bytes(32) for _ in range(n_objects)]
    enc_totals = [sse.enc_size(n) for n in sizes]
    lost = (0, 1)  # two data shards of every object
    bucket = "sse-bucket"
    meta: list = [None] * n_objects
    q = global_queue(device)
    total = sum(sizes)
    result = {"objects": n_objects, "plain_bytes": sorted(set(sizes)),
              "cipher_bytes": sorted(set(enc_totals)),
              "geometry": f"{K}+{M}",
              "block": BLOCK, "chunk": chunk, "algo": algo.value,
              "scheme": "SSE-C", "cipher": sse.CIPHER_CHACHA20,
              "threads": n_objects, "disk_root": root}

    def headers(j):
        return {
            "x-amz-server-side-encryption-customer-algorithm": "AES256",
            "x-amz-server-side-encryption-customer-key":
                base64.b64encode(keys[j]).decode(),
            "x-amz-server-side-encryption-customer-key-md5":
                base64.b64encode(hashlib.md5(keys[j]).digest()).decode()}

    def path(j):
        return f"obj{j:04d}/part.1"

    def readers(j, drop=(), till_offset=None):
        if till_offset is None:
            till_offset = er.shard_file_size(enc_totals[j])
        return [None if i in drop else new_bitrot_reader(
            disks[i].read_file_at(bucket, path(j)), algo, till_offset,
            chunk) for i in range(K + M)]

    def put(j):
        info = sse.parse_sse_headers(headers(j), bucket, path(j))
        meta[j] = {}
        reader, size, _ = sse.encrypt_setup(
            info, io.BytesIO(plains[j]), sizes[j], meta[j], bucket,
            path(j), device=device)
        ws = [new_bitrot_writer(d.create_file_writer(bucket, path(j)),
                                algo, chunk) for d in disks]
        n = erasure_encode(er, reader, ws, K)
        for w in ws:
            w.close()
        return n == size == enc_totals[j]

    def get(j, offset=0, length=-1, drop=()):
        enc_total = enc_totals[j]
        oek, iv, plain_size, _, cipher = sse.sse_read_ctx(
            meta[j], headers(j), bucket, path(j), enc_total, device=device)
        enc_off, enc_len, seq0, skip = sse.decrypt_range_bounds(
            offset, length, plain_size)
        out = BufferSink()
        dw = sse.DecryptWriter(out, oek, iv, seq0, skip,
                               length if length >= 0 else plain_size,
                               bucket, path(j), cipher, device=device)
        erasure_decode(er, dw, readers(
            j, drop, er.shard_file_offset(enc_off, enc_len, enc_total)),
            enc_off, enc_len, enc_total)
        dw.close()
        return out.getvalue()

    def ranged(j):
        # an odd offset 4,097 bytes before a package boundary, 300,001
        # bytes long: several packages, the boundary mid-range
        pkgs = sizes[j] // sse.PKG_SIZE
        off = sse.PKG_SIZE * (1 + j % max(1, pkgs - 5)) - 4097
        ln = min(300001, sizes[j] - off)
        return get(j, off, ln) == plains[j][off: off + ln]

    def heal(j):
        t0 = time.monotonic()
        ws = [new_bitrot_writer(disks[i].create_file_writer(
            bucket, path(j)), algo, chunk) if i in lost else None
            for i in range(K + M)]
        erasure_heal(er, ws, readers(j, lost), enc_totals[j])
        return time.monotonic() - t0

    launched = {}

    def run(fn, label, kernels):
        q.reset_stats()
        reset_launches()
        with _Clock(ccp, "poly1305_tags") as poly:
            t0, c0 = time.monotonic(), time.process_time()
            with ThreadPoolExecutor(max_workers=n_objects) as ex:
                res = list(ex.map(fn, range(n_objects)))
            wall = time.monotonic() - t0
            cpu = time.process_time() - c0
        row = _phase_row(q, total, wall)
        row["launches"] = read_launches()
        # host CPU seconds of the whole process, and those inside Poly1305
        # (its wall seconds add the calling threads' waits for the lock)
        row["host_cpu_s"] = cpu
        row["poly1305_cpu_s"] = poly.cpu_s
        row["poly1305_cpu_share_of_wall"] = poly.cpu_s / wall
        row["poly1305_thread_wall_s"] = poly.wall_s
        result[label] = row
        if device.type == "cuda":
            for name in kernels:
                check(row["launches"][name] > 0,
                      f"kernel {name} never launched in SSE {label}")
        for name, n in row["launches"].items():
            launched[name] = launched.get(name, 0) + n
        return res

    ok = run(put, "put", ("chacha20_xor", "highwayhash256_chunks",
                          "gf_encode_batched"))
    check(all(ok), "an SSE PUT consumed a wrong size")

    got = run(get, "get", ("chacha20_xor", "highwayhash256_chunks"))
    bad = [j for j in range(n_objects) if got[j] != plains[j]]
    check(not bad, f"SSE GET plaintext mismatch on objects {bad[:5]}")
    del got

    ok = run(ranged, "ranged_get", ("chacha20_xor", "highwayhash256_chunks"))
    bad = [j for j in range(n_objects) if not ok[j]]
    check(not bad, f"SSE ranged GET mismatch on objects {bad[:5]}")

    os.makedirs(backup, exist_ok=True)
    for j in range(n_objects):
        for i in lost:
            os.replace(os.path.join(disks[i].root, bucket, path(j)),
                       os.path.join(backup, f"d{i:02d}_{j:04d}"))

    got = run(lambda j: get(j, drop=lost), "degraded_get",
              ("chacha20_xor", "highwayhash256_chunks", "gf_matmul_batched"))
    bad = [j for j in range(n_objects) if got[j] != plains[j]]
    check(not bad, f"SSE degraded GET mismatch on objects {bad[:5]}")
    del got

    lat = run(heal, "heal", ("highwayhash256_chunks", "gf_matmul_batched"))
    result["heal"]["p50_ms"] = _percentile(lat, 0.50) * 1e3
    result["heal"]["p99_ms"] = _percentile(lat, 0.99) * 1e3
    for j in range(n_objects):
        for i in lost:
            with open(os.path.join(backup, f"d{i:02d}_{j:04d}"), "rb") as f:
                want = f.read()
            with open(os.path.join(disks[i].root, bucket, path(j)),
                      "rb") as f:
                check(f.read() == want,
                      f"healed shard {i} of SSE object {j} differs")
    result["heal"]["byte_identical"] = True
    # the healed files serve the plaintext again
    check(get(0) == plains[0], "GET after heal is not exact")
    result["launches"] = launched
    shutil.rmtree(root, ignore_errors=True)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase at a tiny size on the host with "
                    "the plain versions; exits 3 and never prints ok")
    ap.add_argument("--seed", type=int, default=20261016,
                    help="seed of the objects and the customer keys")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import minio_tpu_torch  # noqa: F401 — the port must be beside us
    except ImportError:
        print("minio_tpu_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    rehearsal = args.cpu_rehearsal
    device = torch.device("cpu" if rehearsal else "cuda")
    # the rehearsal's MUR3 objects of 2.1 MiB still hold an unaligned tail;
    # its 1 MiB SSE objects end in a 256-byte ciphertext block (those 333
    # bytes short, in a short package)
    n_obj, obj_bytes, sse_bytes = (4, int(2.1 * 2**20), 1 << 20) \
        if rehearsal else (N_OBJECTS, OBJECT_BYTES, OBJECT_BYTES)
    phase = "build"
    try:
        phase_build(rehearsal)
        phase = "card"
        card = phase_card(rehearsal)
        phase = "kernels"
        rows = phase_kernels(device, rehearsal)
        phase = "main_path"
        res = phase_main(device, n_obj, obj_bytes, args.seed)
        if rehearsal:
            res["cut"] = f"{n_obj} objects of {obj_bytes} bytes"
        emit({"phase": "main_path", "card": card, **res})
        phase = "sse_path"
        sres = phase_sse(device, n_obj, sse_bytes, args.seed)
        if rehearsal:
            sres["cut"] = f"{n_obj} objects of {sse_bytes} bytes"
        emit({"phase": "sse_path", "card": card, **sres})
        for name, row in rows.items():
            by_path = {"mur3x256s_path": res["launches"][name],
                       "sse_hh256s_path": sres["launches"][name]}
            row["launches"] = sum(by_path.values())
            row["launches_by_path"] = by_path
    except Exception as e:  # noqa: BLE001 — report the phase, exit non-zero
        import traceback
        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    finally:
        from minio_tpu_torch.erasure.streaming import shutdown_pools
        from minio_tpu_torch.runtime.dispatch import shutdown_global
        shutdown_global()
        shutdown_pools()
    emit({"kernels": list(rows.values())})
    if rehearsal:
        print("cpu rehearsal done; no result", file=sys.stderr)
        return 3
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
