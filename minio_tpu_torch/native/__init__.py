"""Native (C++) host engines: one ``libnative.so`` built by g++ at first
use and loaded through ctypes — the port of minio_tpu/native/__init__.py.

``pipeline.cpp`` includes ``gf256_simd.cpp``, ``highwayhash.cpp``,
``mur3.cpp`` and ``md5_simd.cpp`` (verbatim copies of the JAX package's
sources) and is linked with ``aesgcm.cpp`` (the port's own: the JAX package
takes AES-GCM from the ``cryptography`` wheel) and ``s2.cpp`` (the
port's own: the JAX package runs snappy and CRC32C in pure Python), so one
library serves:

- the CPU GF(256) codec (``cpu_encode``: the salvage route of a failed
  flush on a CPU queue),
- AVX2 HighwayHash-256 and MUR3X256 (``hh256*``, ``mur3x256*``: every host
  bitrot digest of the port's paths — tail blocks, host-verified reads —
  and the CPU queue's salvage route's hashes),
- the fused per-block calls ``put_block`` / ``get_block`` /
  ``verify_framed`` (split+encode+hash+frame, verify+assemble),
- AES-256-GCM with AES-NI and PCLMULQDQ (``aesgcm_*``: the SSE package
  cipher AES256-GCM, one call per block of packages, its OEK envelope and
  the KMS's data-key seal). A CPU without those instructions gets
  ``AESUnavailable`` at the first call, never a portable AES,
- the multi-lane MD5 server's rounds (``md5_multi_segments``: the ETag of
  large MD5-only bodies, ``utils/md5simd.py``),
- snappy blocks and CRC32C (``snappy_compress``, ``snappy_decompress``,
  ``crc32c``: the S2 frames of transparent compression,
  ``utils/compress.py``), byte for byte the JAX package's Python.

Every entry point releases the interpreter lock (plain ``ctypes.CDLL``
calls), so concurrent requests hash on as many cores as the host has.

The library lands in ``build/minio_tpu_torch/`` at the repository root
(git-ignored), named by a hash of the sources, the compiler's version and
this host's CPU (model and flags), so a ``-march=native`` build made on one
machine is never loaded on another. The build tries ``-march=native``, then
``-mavx2``, then no target flags. A failed build raises ``BuildError``,
cached so later calls raise at once; there is no numpy fallback
(``hhpy.py`` and ``mur3py.py`` are the tests' independent references).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..utils.errors import BuildError

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "minio_tpu_torch")
_SOURCES = ("pipeline.cpp", "gf256_simd.cpp", "highwayhash.cpp", "mur3.cpp",
            "md5_simd.cpp", "aesgcm.cpp", "s2.cpp")
#: the translation units g++ links into the library
_UNITS = ("pipeline.cpp", "aesgcm.cpp", "s2.cpp")
#: the g++ flag ladder: the first set that compiles is kept
FLAG_LADDER = (("-O3", "-march=native"), ("-O3", "-mavx2"), ("-O3",))

#: Bitrot algorithm ids shared with pipeline.cpp hash_many() and the device
#: hashes (ops/fused.py).
ALGO_HIGHWAY = 0
ALGO_MUR3 = 1

_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_error: BuildError | None = None
#: the flags the loaded library was built with (None until loaded)
build_flags: tuple | None = None


def _host_id() -> bytes:
    """This host's compiler version and CPU identity (model name and flags
    of the first processor), which a -march=native build depends on."""
    try:
        cc = subprocess.run(["g++", "--version"], capture_output=True,
                            check=True).stdout.splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError) as e:
        raise BuildError(f"g++ is not usable: {e}") from e
    cpu = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"model name", b"flags")):
                    cpu += line
                elif not line.strip() and cpu:
                    break
    except OSError:
        pass
    return cc + b"\n" + cpu


def library_path() -> str:
    """Where this host's build of the sources lives."""
    h = hashlib.sha256(_host_id())
    for s in _SOURCES:
        with open(os.path.join(_DIR, s), "rb") as f:
            h.update(f.read())
    h.update(repr(FLAG_LADDER).encode())
    return os.path.join(BUILD_DIR, f"libnative-{h.hexdigest()[:16]}.so")


def _compile(out: str) -> tuple:
    """Build the units into ``out`` (atomically: a temp file renamed, so
    concurrent processes never load a half-written library); returns the
    flags that compiled."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    last = ""
    for flags in FLAG_LADDER:
        r = subprocess.run(["g++", *flags, "-shared", "-fPIC",
                            *(os.path.join(_DIR, u) for u in _UNITS),
                            "-o", tmp],
                           capture_output=True)
        if r.returncode == 0:
            os.replace(tmp, out)
            with open(out[:-3] + ".flags", "w") as f:
                f.write(" ".join(flags))
            return flags
        last = r.stderr.decode(errors="replace")[-2000:]
    raise BuildError(f"native build failed: {last}")


def load_native() -> ctypes.CDLL:
    """Build (once per host and source set) and load the library. A
    failure is cached and raised again at once; lock-free once loaded."""
    global _lib, _load_error
    lib = _lib
    if lib is not None:
        return lib
    with _LOCK:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise _load_error
        try:
            # the one-time build runs under the lock on purpose: concurrent
            # first callers wait for the single compile
            _lib = _load_locked()
        except BuildError as e:
            _load_error = e
            raise
        except OSError as e:
            _load_error = BuildError(f"native library did not load: {e}")
            raise _load_error from e
    return _lib


def _load_locked() -> ctypes.CDLL:
    global build_flags
    out = library_path()
    if os.path.exists(out):
        try:
            with open(out[:-3] + ".flags") as f:
                build_flags = tuple(f.read().split())
        except OSError:
            build_flags = ()
    else:
        build_flags = _compile(out)
    lib = ctypes.CDLL(out)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    cp, ci, cl = ctypes.c_char_p, ctypes.c_int, ctypes.c_long
    vpp, lp = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_long)
    ip, u32p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32)
    # every entry of the JAX package's binding (the fd and pread entries
    # have no wrapper: the native host routes are not ported), the AES-GCM
    # engine's and the S2 unit's
    sigs = {
        "gf256_encode": ([cp, ci, ci, cp, cp, cl], None),
        "gf256_has_avx2": ([], ci),
        "hh256": ([cp, cp, cl, cp], None),
        "hh256_batch": ([cp, cp, ci, cl, cl, cp], None),
        "hh256_multi": ([cp, vpp, lp, ci, cp], None),
        "hh256_ref": ([cp, cp, cl, cp], None),
        "hh64": ([cp, cp, cl], ctypes.c_uint64),
        "mur3x256": ([cp, cp, cl, cp], None),
        "mur3x256_batch": ([cp, cp, ci, cl, cl, cp], None),
        "mur3x256_many": ([cp, vpp, lp, ci, cp], None),
        "mt_framed_len": ([cl, cl], cl),
        "mt_put_block": ([c_u8p, cl, cp, ci, ci, cl, cl, cp, c_u8p, ci],
                         None),
        "mt_put_block_fds": ([c_u8p, cl, cp, ci, ci, cl, cl, cp, c_u8p, ci,
                              ip, cl, ip, ctypes.POINTER(ctypes.c_double)],
                             None),
        "mt_get_block": ([vpp, ci, cl, cl, cp, c_u8p, ci], ci),
        "mt_get_block_pread": ([ip, lp, ci, cl, cl, cp, c_u8p, c_u8p, ci],
                               cl),
        "mt_verify_framed": ([c_u8p, cl, cl, cp, ci], cl),
        "md5_multi_segments": ([u32p, vpp, lp, ip, ci], None),
        "md5_init_state": ([u32p], None),
        "md5_finish": ([u32p, cp, cl, ctypes.c_ulonglong, c_u8p], None),
        "aesgcm_cpu_ok": ([], ci),
        "aesgcm_seal": ([cp, cp, cp, cl, cp, cl, cp], None),
        "aesgcm_open": ([cp, cp, cp, cl, cp, cl, cp], ci),
        "aesgcm_seal_pkgs": ([cp, cp, ctypes.c_uint32, vpp, lp, ci, vpp],
                             None),
        "aesgcm_open_pkgs": ([cp, cp, ctypes.c_uint32, vpp, lp, ci, vpp],
                             ci),
        "crc32c": ([cp, cl], ctypes.c_uint32),
        "snappy_max_compressed": ([cl], cl),
        "snappy_compress": ([cp, cl, cp], cl),
        "snappy_uncompressed_length": ([cp, cl], cl),
        "snappy_decompress": ([cp, cl, cp, cl], cl),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _key(key: bytes) -> bytes:
    if len(key) != 32:
        raise ValueError("bitrot keys are 32 bytes")
    return bytes(key)


def _rows(chunks) -> np.ndarray:
    chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
    if chunks.ndim != 2:
        raise ValueError(f"chunks must be [n, L], got {chunks.shape}")
    return chunks


def _ptrs(datas: list) -> tuple:
    """(kept arrays, void* array, long array) for the *_multi entries; the
    arrays must stay referenced while the call runs."""
    arrs = [np.frombuffer(d, dtype=np.uint8) if not isinstance(d, np.ndarray)
            else np.ascontiguousarray(d, dtype=np.uint8).reshape(-1)
            for d in datas]
    n = len(arrs)
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
    lens = (ctypes.c_long * n)(*[a.size for a in arrs])
    return arrs, ptrs, lens


def hh256(key: bytes, data) -> bytes:
    """HighwayHash-256 of ``data`` (any byte length) under ``key``."""
    lib = load_native()
    src = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data, np.uint8).ravel()
    out = ctypes.create_string_buffer(32)
    lib.hh256(_key(key), src.ctypes.data_as(ctypes.c_char_p), src.size, out)
    return out.raw


def hh256_batch(key: bytes, chunks) -> np.ndarray:
    """HighwayHash-256 of every row of uint8 [n, L] -> uint8 [n, 32]."""
    lib = load_native()
    chunks = _rows(chunks)
    n, length = chunks.shape
    out = np.empty((n, 32), dtype=np.uint8)
    lib.hh256_batch(_key(key), chunks.ctypes.data_as(ctypes.c_char_p), n,
                    length, length, out.ctypes.data_as(ctypes.c_char_p))
    return out


def hh256_multi(key: bytes, datas: list) -> np.ndarray:
    """HighwayHash-256 of buffers of any lengths -> uint8 [n, 32]."""
    lib = load_native()
    arrs, ptrs, lens = _ptrs(datas)
    out = np.empty((len(arrs), 32), dtype=np.uint8)
    lib.hh256_multi(_key(key), ptrs, lens, len(arrs),
                    out.ctypes.data_as(ctypes.c_char_p))
    return out


def mur3x256(key: bytes, data) -> bytes:
    """MUR3X256 of ``data`` (any byte length) under ``key``."""
    return mur3x256_many(key, [data]).tobytes()


def mur3x256_batch(key: bytes, chunks) -> np.ndarray:
    """MUR3X256 of every row of uint8 [n, L] -> uint8 [n, 32]."""
    lib = load_native()
    chunks = _rows(chunks)
    n, length = chunks.shape
    out = np.empty((n, 32), dtype=np.uint8)
    lib.mur3x256_batch(_key(key), chunks.ctypes.data_as(ctypes.c_char_p), n,
                       length, length, out.ctypes.data_as(ctypes.c_char_p))
    return out


def mur3x256_many(key: bytes, datas: list) -> np.ndarray:
    """MUR3X256 of buffers of any lengths -> uint8 [n, 32]."""
    lib = load_native()
    arrs, ptrs, lens = _ptrs(datas)
    out = np.empty((len(arrs), 32), dtype=np.uint8)
    lib.mur3x256_many(_key(key), ptrs, lens, len(arrs),
                      out.ctypes.data_as(ctypes.c_char_p))
    return out


def batch_hasher(algo_id: int):
    """The native batch hash of an ALGO_* id: (key, uint8 [n, L]) ->
    uint8 [n, 32]."""
    if algo_id == ALGO_HIGHWAY:
        return hh256_batch
    if algo_id == ALGO_MUR3:
        return mur3x256_batch
    raise ValueError(f"no native hash for algorithm id {algo_id}")


class Mur3x256:
    """hashlib-shaped MUR3X256 (buffers updates, hashes once at digest();
    bitrot chunks are at most a shard, so the buffer is bounded)."""

    digest_size = 32

    def __init__(self, key: bytes):
        self._key = _key(key)
        load_native()  # fail here, not at the first digest()
        self._buf = bytearray()

    def update(self, b) -> None:
        self._buf += b

    def digest(self) -> bytes:
        return mur3x256(self._key, self._buf)

    def hexdigest(self) -> str:
        return self.digest().hex()


def cpu_encode(matrix, data, rows_out: int) -> np.ndarray:
    """GF(256) product on the host: matrix uint8 [o, i] x data uint8
    [i, S] -> [o, S]."""
    lib = load_native()
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if matrix.shape != (rows_out, data.shape[0]):
        raise ValueError(f"matrix {matrix.shape} does not map "
                         f"{data.shape[0]} rows to {rows_out}")
    out = np.empty((rows_out, data.shape[1]), dtype=np.uint8)
    lib.gf256_encode(
        matrix.ctypes.data_as(ctypes.c_char_p), rows_out, data.shape[0],
        data.ctypes.data_as(ctypes.c_char_p),
        out.ctypes.data_as(ctypes.c_char_p), data.shape[1])
    return out


def framed_len(shard_len: int, chunk: int) -> int:
    """Bytes of one shard of ``shard_len`` framed as [digest][chunk]..."""
    return load_native().mt_framed_len(shard_len, chunk)


_u8p = ctypes.POINTER(ctypes.c_uint8)


def put_block(data, data_len: int, pmat: np.ndarray, k: int, m: int,
              shard_len: int, chunk: int, key: bytes,
              algo: int = ALGO_HIGHWAY, out: np.ndarray | None = None
              ) -> np.ndarray:
    """Fused split+encode+hash+frame of one erasure block: ``data`` (a
    buffer of ``data_len`` bytes) -> uint8 [(k+m) * framed_len]; shard i's
    framed bytes are ``out[i*framed_len:(i+1)*framed_len]``. ``out``, when
    given, must have exactly that size."""
    lib = load_native()
    if k + m > 256 or k <= 0 or m < 0 or chunk <= 0:
        raise ValueError(f"unsupported geometry k={k} m={m} chunk={chunk}")
    if shard_len * k < data_len:
        raise ValueError(f"{k} shards of {shard_len} cannot hold {data_len}")
    fl = lib.mt_framed_len(shard_len, chunk)
    if out is None:
        out = np.empty((k + m) * fl, dtype=np.uint8)
    elif out.nbytes != (k + m) * fl:
        raise ValueError("put_block: out buffer size mismatch")
    src = np.frombuffer(data, dtype=np.uint8, count=data_len)
    pmat = np.ascontiguousarray(pmat, dtype=np.uint8)
    if pmat.shape != (m, k):
        raise ValueError(f"parity matrix {pmat.shape} is not ({m}, {k})")
    lib.mt_put_block(src.ctypes.data_as(_u8p), data_len,
                     pmat.ctypes.data_as(ctypes.c_char_p), k, m, shard_len,
                     chunk, _key(key), out.ctypes.data_as(_u8p), algo)
    return out


def get_block(framed: list, k: int, plen: int, chunk: int, key: bytes,
              algo: int = ALGO_HIGHWAY, out: np.ndarray | None = None
              ) -> tuple[np.ndarray, int]:
    """Fused verify+assemble: k framed shard buffers -> (block uint8
    [k*plen], bad_shard), bad_shard -1 when every digest matched."""
    lib = load_native()
    if k <= 0 or k > 256 or chunk <= 0 or len(framed) != k:
        raise ValueError(f"unsupported geometry k={k} chunk={chunk}")
    fl = lib.mt_framed_len(plen, chunk)
    arrs = [np.frombuffer(f, dtype=np.uint8) for f in framed]
    if any(a.size < fl for a in arrs):
        raise ValueError(f"a framed shard is shorter than {fl} bytes")
    ptrs = (ctypes.c_void_p * k)(*[a.ctypes.data for a in arrs])
    if out is None:
        out = np.empty(k * plen, dtype=np.uint8)
    elif out.nbytes != k * plen:
        raise ValueError("get_block: out buffer size mismatch")
    bad = lib.mt_get_block(ptrs, k, plen, chunk, _key(key),
                           out.ctypes.data_as(_u8p), algo)
    return out, bad


def verify_framed(framed, plen: int, chunk: int, key: bytes,
                  algo: int = ALGO_HIGHWAY) -> int:
    """Verify one framed span; -1 when every digest matched, else the index
    of the first corrupt chunk."""
    lib = load_native()
    arr = np.frombuffer(framed, dtype=np.uint8)
    if arr.size < lib.mt_framed_len(plen, chunk):
        raise ValueError("verify_framed: span shorter than its framing")
    return lib.mt_verify_framed(arr.ctypes.data_as(_u8p), plen, chunk,
                                _key(key), algo)


class AESUnavailable(RuntimeError):
    """This CPU lacks AES-NI or PCLMULQDQ: the AES-256-GCM engine has no
    portable fallback (a table-driven AES leaks timing)."""


def _aes_lib() -> ctypes.CDLL:
    lib = load_native()
    if not lib.aesgcm_cpu_ok():
        raise AESUnavailable(
            "AES-256-GCM needs AES-NI, PCLMULQDQ and SSE4.1, which this CPU "
            "lacks; objects sealed with AES256-GCM cannot be read or "
            "written here (ChaCha20-Poly1305 objects can)")
    return lib


def _aes_args(key: bytes, nonce: bytes) -> None:
    if len(key) != 32:
        raise ValueError("AES-256-GCM keys are 32 bytes")
    if len(nonce) != 12:
        raise ValueError("AES-256-GCM nonces are 12 bytes")


def _buf(data) -> np.ndarray:
    """A uint8 view of any C-contiguous buffer (bytes, memoryview, array)."""
    return np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)


def aesgcm_seal(key: bytes, nonce: bytes, aad: bytes, data) -> bytes:
    """AES-256-GCM seal: ciphertext || 16-byte tag."""
    lib = _aes_lib()
    _aes_args(key, nonce)
    src = _buf(data)
    out = ctypes.create_string_buffer(src.size + 16)
    lib.aesgcm_seal(bytes(key), bytes(nonce), bytes(aad), len(aad),
                    src.ctypes.data_as(ctypes.c_char_p), src.size, out)
    return out.raw


def aesgcm_open(key: bytes, nonce: bytes, aad: bytes, sealed) -> bytes | None:
    """AES-256-GCM open of ciphertext || tag; None when the tag does not
    verify (then nothing was decrypted)."""
    lib = _aes_lib()
    _aes_args(key, nonce)
    src = _buf(sealed)
    if src.size < 16:
        return None
    out = ctypes.create_string_buffer(max(src.size - 16, 1))
    rc = lib.aesgcm_open(bytes(key), bytes(nonce), bytes(aad), len(aad),
                         src.ctypes.data_as(ctypes.c_char_p), src.size - 16,
                         out)
    return None if rc else out.raw[:src.size - 16]


def _pkg_call(fn, key: bytes, base_iv: bytes, seq0: int, bufs: list,
              out_lens: list):
    """(return value, [out views]) of a package entry: every input is
    passed by pointer, every output lands in one array."""
    if len(key) != 32 or len(base_iv) < 8:
        raise ValueError("AES-256-GCM packages take a 32-byte key and a "
                         "base IV of at least 8 bytes")
    arrs, ptrs, lens = _ptrs(bufs)
    out = np.empty(sum(out_lens), dtype=np.uint8)
    offs = [int(o) for o in np.cumsum([0, *out_lens])[:-1]]
    dst = (ctypes.c_void_p * len(arrs))(*[out.ctypes.data + o for o in offs])
    rc = fn(bytes(key), bytes(base_iv[:8]), seq0 & 0xFFFFFFFF, ptrs, lens,
            len(arrs), dst)
    views = [memoryview(out[o:o + n]) for o, n in zip(offs, out_lens)]
    return rc, views


def aesgcm_seal_pkgs(key: bytes, base_iv: bytes, seq0: int,
                     pkgs: list) -> list:
    """Seal a block of SSE packages in one call (nonces and AADs derived
    from ``base_iv[:8]`` and the sequence numbers ``seq0 + i``): a
    memoryview per package, ciphertext || tag."""
    lib = _aes_lib()
    _, views = _pkg_call(lib.aesgcm_seal_pkgs, key, base_iv, seq0, pkgs,
                         [len(p) + 16 for p in pkgs])
    return views


def aesgcm_open_pkgs(key: bytes, base_iv: bytes, seq0: int,
                     sealed: list) -> tuple[int, list]:
    """Open a block of sealed SSE packages in one call: (-1, plaintext
    views) when every tag verifies, else (index of the first failing
    package, []) with nothing decrypted."""
    lib = _aes_lib()
    rc, views = _pkg_call(lib.aesgcm_open_pkgs, key, base_iv, seq0, sealed,
                          [max(len(c) - 16, 0) for c in sealed])
    return (-1, views) if rc < 0 else (rc, [])


#: snappy_decompress's negative codes, as utils/snappy.py words them
_SNAPPY_ERRORS = {-1: "truncated varint", -2: "truncated literal",
                  -3: "truncated copy offset", -4: "invalid copy offset",
                  -5: "length mismatch"}


def crc32c(data) -> int:
    """CRC-32/Castagnoli of ``data`` (any C-contiguous buffer)."""
    src = _buf(data)
    return load_native().crc32c(src.ctypes.data_as(ctypes.c_char_p),
                                src.size)


def snappy_compress(data) -> bytes:
    """The snappy block of ``data``: utils/snappy.py ``compress``'s bytes."""
    lib = load_native()
    src = _buf(data)
    if src.size >= 1 << 31:
        raise ValueError("snappy blocks are below 2 GiB")
    out = ctypes.create_string_buffer(lib.snappy_max_compressed(src.size))
    n = lib.snappy_compress(src.ctypes.data_as(ctypes.c_char_p), src.size,
                            out)
    return out.raw[:n]


def snappy_decompress(data) -> bytes:
    """Decode one snappy block; a malformed one raises utils.snappy.
    SnappyError, as utils/snappy.py ``decompress`` does."""
    from ..utils.snappy import SnappyError
    lib = load_native()
    src = _buf(data)
    p = src.ctypes.data_as(ctypes.c_char_p)
    total = lib.snappy_uncompressed_length(p, src.size)
    if total < 0:
        raise SnappyError("truncated varint")
    out = ctypes.create_string_buffer(max(total, 1))
    n = lib.snappy_decompress(p, src.size, out, total)
    if n < 0:
        raise SnappyError(_SNAPPY_ERRORS.get(n, f"snappy error {n}"))
    return out.raw[:n]
