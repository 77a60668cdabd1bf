"""Build and load the port's CUDA kernels: one shared library with a plain C
interface per source under ``minio_tpu_torch/csrc/``, compiled by ``nvcc``
for ``sm_90a`` and loaded with ctypes.

Libraries land in ``build/minio_tpu_torch/`` at the repository root, named
by a content hash of their source and flags, so a changed source rebuilds
and an unchanged one loads at once. ``build()`` starts one ``nvcc`` per
missing library, all at the same time. Nothing is compiled at import: the
CPU tests import every module on hosts without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "minio_tpu_torch")

#: sm_90a keeps Hopper's wgmma/setmaxnreg open to later kernels; -Xptxas -v
#: writes registers, shared memory and spills per kernel into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint
_ULL = ctypes.c_ulonglong

#: the C entry points of each library: name -> (argtypes, restype)
SIGNATURES = {
    "gf_matmul": {
        "gfk_matmul_batched": ([_P, _P, _P, _I, _I, _I, _LL, _P], _I),
        "gfk_encode_batched": ([_I, _P, _P, _I, _I, _I, _LL, _P], _I),
        "gfk_set_encode_masks": ([_P, _I, _I], _I),
        "gfk_const_capacity": ([], _I),
    },
    "mur3x256": {
        "mur3_chunks": ([_P, _P, _LL, _I, _I, _I, _I, _I, _I, _U, _U, _P],
                        _I),
    },
    "chacha20": {
        "chacha20_xor": ([_P, _P, _P, _P, _P, _LL, _I, _I, _P], _I),
    },
    "highwayhash": {
        "hh256_chunks": ([_P, _P, _LL, _I, _I, _I, _I, _I, _I, _ULL, _ULL,
                          _ULL, _ULL, _P], _I),
    },
    "scan": {
        "scan_codes": ([_P, _P, _P, _I, _P, _P, _I, _I, _LL, _I, _I, _P, _P],
                       _I),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a host with the CUDA toolkit")
    return path


def target(name: str) -> tuple[str, str]:
    """(source path, library path) of one kernel library. The name hashes
    the source, the shared headers of csrc/ and the flags."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=None) -> dict[str, float]:
    """Compile every missing library of ``names`` (default: all), one
    ``nvcc`` each, all started together. Returns seconds per library built
    (absent when it was already built); raises with the compiler's output
    when one fails."""
    names = list(SIGNATURES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in names:
        src, lib = target(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.tmp{os.getpid()}"
        log = open(lib[:-3] + ".log", "wb")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=log,
            stderr=subprocess.STDOUT), tmp, lib, log)
    took = {}
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        took[name] = time.monotonic() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, lib)
    if failed:
        msgs = []
        for name in failed:
            with open(target(name)[1][:-3] + ".log", "rb") as f:
                msgs.append(f"{name}: {f.read()[-3000:].decode(errors='replace')}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return took


def build_log(name: str) -> str:
    """The compiler's output for one library (ptxas register/spill lines)."""
    path = target(name)[1][:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path, "rb") as f:
        return f.read().decode(errors="replace")


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(target(name)[1])
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a non-zero cudaError_t."""
    if err:
        raise RuntimeError(f"{what} failed: cudaError {err}")
