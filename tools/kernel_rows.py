#!/usr/bin/env python3
"""K1 (csrc/gf_matmul.cu) and K4 (csrc/chacha20.cu) alone on one card:
chip_smoke.py's rows of both kernels, at the batches the paths launch
(``SMALL_B`` x ``SMALL_O``, ``SMALL_I``) and at the 128-element flush
shapes, without the paths. Each row is held word for word to its plain
version and timed as chip_smoke.py times it (``ms``, ``bound_ms``,
``copy_ms``, ``floor_ms``, and for K4 ``earlier_design_ms`` where the
plan is not one thread per block). With ``--sweep`` each small row is also
timed at every geometry the kernels take (``sweep`` lines), so the plans'
switch points can be read off one run.

    python3 tools/kernel_rows.py [--sweep]

Needs a CUDA card; builds only the two libraries.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chacha_candidates(items: int, pkgs: int, words: int):
    """K4's two layouts at one shape: one and four threads per block."""
    from minio_tpu_torch.ops import chacha_cuda
    return [chacha_cuda.one_lane_plan(items, pkgs, words),
            chacha_cuda.four_lane_plan(items, pkgs, words)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_rows.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from minio_tpu_torch.ops import (chacha_cuda, chacha_torch, cuda_build,
                                     rs_cuda)
    from minio_tpu_torch.ops.rs_torch import get_codec

    took = cuda_build.build(["gf_matmul", "chacha20"])
    cs.emit({"phase": "build", "per_library_s": took, "ptxas": {
        lib: [ln.strip() for ln in cuda_build.build_log(lib).splitlines()
              if "registers" in ln or "spill" in ln]
        for lib in ("gf_matmul", "chacha20")}})
    for lib, sym in (("gf_matmul", "gf_matmul_batched_kernelILi16ELi4E"),
                     ("gf_matmul", "gf_matmul_batched_kernelILi8ELi1E"),
                     ("gf_matmul", "gf_matmul_batched_kernelILi16ELi2E"),
                     ("chacha20", "chacha20_kernelILb1E"),
                     ("chacha20", "chacha20_quad_kernel")):
        cs.emit({"phase": "sass", "kernel": sym, **cs.sass_mix(lib, sym)})
    card = cs.phase_card(False)
    device = torch.device("cuda")
    gen = np.random.default_rng(7)
    B, W = cs.N_OBJECTS, cs.BLOCK // cs.K // 4
    x = cs._words(gen, (B, cs.K, W), device)
    codec = get_codec(cs.K, cs.M, device=device)
    small_mm = [(b, o) for b in cs.SMALL_B for o in cs.SMALL_O]
    mm = cs.matmul_rows(device, gen, x, codec, [
        (B, 2, "minio_tpu/ops/rs_pallas.py:147"),
        (B, cs.K + cs.M, "minio_tpu/ops/rs_pallas.py:147")] + [
        (b, o, "minio_tpu/ops/rs_pallas.py:" + ("89" if b == 1 else "147"))
        for b, o in small_mm])
    items, pkgs, pw = cs.N_OBJECTS, 16, 16384
    keys = cs._words(gen, (items, 8), device)
    nonces = cs._words(gen, (items, pkgs, 3), device)
    nonces[:, :, 2] = -1 - torch.arange(pkgs, dtype=torch.int32,
                                        device=device)
    keys[:, 0] |= -2**31
    payload = cs._words(gen, (items, pkgs, pw), device)
    ch = cs.chacha_rows(device, [
        (keys[:i], nonces[:i], payload[:i],
         "minio_tpu/ops/chacha_pallas.py:" + ("92" if i == 1 else "210"))
        for i in (items,) + cs.SMALL_I])
    if args.sweep:
        for b, o in small_mm + [(1, 20), (16, 2), (32, 2), (64, 2), (B, 2),
                                (B, cs.K + cs.M)]:
            mk = torch.from_numpy(cs.rebuild_masks(gen, codec, b, o)).to(
                device)
            xb = x[:b]
            for plan in rs_cuda.candidate_plans(b, o, cs.K, W):
                out = torch.empty((b, o, W), dtype=torch.int32,
                                  device=device)
                got = rs_cuda.launch_matmul(mk, xb, out, plan)
                err = cs._err(got, rs_cuda.gf_matmul_batched_ref(mk, xb))
                ms = cs.time_ms(lambda m, xx, p=plan: rs_cuda.launch_matmul(
                    m, xx, torch.empty((b, o, W), dtype=torch.int32,
                                       device=device), p),
                    (mk, xb), cs.REPS, device)
                cs.emit({"phase": "sweep", "kernel": "gf_matmul_batched",
                         "shape": f"B={b} o={o}", "ms": ms,
                         "max_abs_err": err,
                         **cs.matmul_geometry(plan)})
        for i in (1, 2, 3) + cs.SMALL_I[1:] + (32, items):
            args_ = (keys[:i], nonces[:i], payload[:i])
            for plan in chacha_candidates(i, pkgs, pw):
                def run(k, n, d, p=plan):
                    return chacha_cuda.launch(
                        k, n, d, torch.empty_like(d),
                        torch.empty((d.shape[0], pkgs, 8), dtype=torch.int32,
                                    device=device), p)
                err = cs._err(run(*args_), chacha_torch.multi_xor(*args_))
                ms = cs.time_ms(run, args_, cs.REPS, device)
                cs.emit({"phase": "sweep", "kernel": "chacha20_xor",
                         "shape": f"I={i}", "ms": ms, "max_abs_err": err,
                         **cs.chacha_geometry(plan)})
    cs.emit({"phase": "rows", "gf_matmul_batched": [
        {k: r.get(k) for k in ("shape", "ms", "earlier_design_ms",
                               "bound_ms", "bound_by", "copy_ms",
                               "floor_ms", "plain_ms", "max_abs_err")}
        for r in mm], "chacha20_xor": [
        {k: r.get(k) for k in ("shape", "ms", "earlier_design_ms",
                               "bound_ms", "bound_by", "copy_ms",
                               "floor_ms", "plain_ms", "max_abs_err")}
        for r in ch]})
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
