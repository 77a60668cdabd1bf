"""Build and load the port's CUDA kernels: one shared library with a plain C
interface per source under ``minio_tpu_torch/csrc/``, compiled by ``nvcc``
for ``sm_90a`` and loaded with ctypes.

A library is named by a key: a source name, or a pair (name, defines) for a
source built once per set of preprocessor values (``VARIANTS``: K2
``gf_encode``, one library per encode matrix). Libraries land in
``build/minio_tpu_torch/`` at the repository root, named by a content hash
of their source, the shared headers, the flags and the defines, so a
changed source rebuilds and an unchanged one loads at once. ``build()``
starts one ``nvcc`` per missing library, all at the same time. Nothing is
compiled at import: the CPU tests import every module on hosts without
``nvcc``. Every library built is reported to ``obs/device`` (a timed
``compile`` row, timeline event and stage charge).
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

from ..utils.errors import BuildError

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
        "gfk_matmul_batched": ([_P, _P, _P, _I, _I, _I, _LL, _I, _I, _I,
                                _U, _I, _P], _I),
        "gfk_empty": ([_U, _U, _I, _I, _P], _I),
    },
    "gf_encode": {
        "gfk_encode": ([_P, _P, _I, _I, _I, _LL, _P], _I),
    },
    "mur3x256": {
        "mur3_chunks": ([_P, _P, _LL, _I, _I, _I, _I, _I, _I, _U, _U, _P],
                        _I),
    },
    "chacha20": {
        "chacha20_xor": ([_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _U, _P],
                         _I),
        "chacha20_empty": ([_U, _I, _P], _I),
    },
    "highwayhash": {
        "hh256_chunks": ([_P, _P, _LL, _I, _I, _I, _I, _I, _I, _ULL, _ULL,
                          _ULL, _ULL, _P], _I),
    },
    "scan": {
        "scan_codes": ([_P, _P, _P, _I, _P, _I, _P, _I, _I, _LL, _I, _I, _I,
                        _I, _P, _P], _I),
    },
}

#: sources built once per set of preprocessor values: name -> the tag of a
#: build's defines in its file name (gf_encode-<o>x<i>-<sha>.so)
VARIANTS = {
    "gf_encode": lambda d: f"{d['GFK_O']}x{d['GFK_I']}",
}

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise BuildError("nvcc not found: the CUDA kernels build only on "
                           "a host with the CUDA toolkit")
    return path


def _split(key) -> tuple[str, tuple]:
    """A library key (a name, or (name, defines)) -> (name, defines), the
    defines a tuple of (macro, value) string pairs."""
    if isinstance(key, str):
        return key, ()
    name, defines = key
    return name, tuple((str(k), str(v)) for k, v in defines)


def target(name: str, defines: tuple = ()) -> tuple[str, str]:
    """(source path, library path) of one kernel library. The name hashes
    the source, the shared headers of csrc/, the flags and the defines; a
    variant's name also carries the tag of its defines."""
    if bool(defines) != (name in VARIANTS):
        raise ValueError(f"library {name} takes "
                         f"{'defines' if name in VARIANTS else 'no defines'}")
    src = os.path.join(CSRC_DIR, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for k, v in defines:
        digest.update(f" -D{k}={v}".encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(
        BUILD_DIR, f"{label((name, defines))}-{digest.hexdigest()[:16]}.so")


def label(key) -> str:
    """A library's name with its variant tag: gf_encode-4x16, scan."""
    name, defines = _split(key)
    return f"{name}-{VARIANTS[name](dict(defines))}" if defines else name


def build(keys=None) -> dict[str, float]:
    """Compile every missing library of ``keys`` (names, or (name, defines)
    pairs; default: every source that takes no defines), one ``nvcc``
    each, all started together. Returns seconds per library built, by
    ``label`` (absent when it was already built); raises with the
    compiler's output when one fails."""
    keys = [n for n in SIGNATURES if n not in VARIANTS] if keys is None \
        else [_split(k) for k in keys]
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for key in keys:
        name, defines = _split(key)
        src, lib = target(name, defines)
        if os.path.exists(lib) or lib in procs:
            continue
        tmp = f"{lib}.tmp{os.getpid()}"
        log = open(lib[:-3] + ".log", "wb")
        flags = [f"-D{k}={v}" for k, v in defines]
        procs[lib] = (label(key), subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, src], stdout=log,
            stderr=subprocess.STDOUT), tmp, log)
    took = {}
    failed = []
    for lib, (lab, proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        took[lab] = time.monotonic() - t0
        if rc != 0:
            failed.append((lab, lib))
            continue
        os.replace(tmp, lib)
        from ..obs import device as _dev
        _dev.note_build(lab, took[lab])
    if failed:
        msgs = []
        for lab, lib in failed:
            with open(lib[:-3] + ".log", "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            msgs.append(f"{lab}: {tail}")
        raise BuildError("nvcc failed:\n" + "\n".join(msgs))
    return took


def build_log(name: str, defines: tuple = ()) -> str:
    """The compiler's output for one library (ptxas register/spill lines)."""
    path = target(name, defines)[1][:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path, "rb") as f:
        return f.read().decode(errors="replace")


def library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library ``name`` (built with ``defines``), built first if
    needed."""
    key = _split((name, defines))
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build([key])
            lib = ctypes.CDLL(target(*key)[1])
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[key] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a non-zero cudaError_t."""
    if err:
        raise RuntimeError(f"{what} failed: cudaError {err}")
