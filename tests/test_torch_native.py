"""The port's native host engines (minio_tpu_torch.native: libnative.so
built by g++ from the port's own copies of the C++ sources) held byte for
byte to the JAX package's library (minio_tpu.native) and to the numpy
references hhpy/mur3py, on numpy inputs from a seed, at lengths with and
without a remainder; the fused block calls against the JAX package's; and
the interpreter lock released while a hash runs."""
import ctypes
import os
import threading
import time

import numpy as np
import pytest

from minio_tpu import native as jnative
from minio_tpu.native import highwayhash as jhh
from minio_tpu.native import mur3py as jmur3
from minio_tpu_torch import native
from minio_tpu_torch.native import highwayhash, hhpy, mur3py
from minio_tpu_torch.erasure.bitrot import HIGHWAY_KEY

#: remainders of every kind: empty, < one word, < one packet, whole packets,
#: a packet plus a tail, the paths' chunk, a chunk plus one byte
LENGTHS = [0, 1, 3, 31, 32, 33, 1028, 16384, 16385]


def chunks(n: int, length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, length),
                                                dtype=np.uint8)


def test_library_builds_outside_the_sources():
    lib = native.load_native()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert not path.startswith(os.path.dirname(native.__file__))
    assert native.build_flags in native.FLAG_LADDER
    assert native.load_native() is lib


@pytest.mark.parametrize("length", LENGTHS)
def test_hh256_matches_reference_and_numpy(length):
    c = chunks(5, length, length)
    got = native.hh256_batch(HIGHWAY_KEY, c)
    assert np.array_equal(got, jhh.hash256_batch(HIGHWAY_KEY, c))
    assert np.array_equal(got, hhpy.hash256_batch(HIGHWAY_KEY, c))
    assert native.hh256(HIGHWAY_KEY, c[2].tobytes()) == got[2].tobytes()
    h = highwayhash.HighwayHash256(HIGHWAY_KEY)
    h.update(c[3, : length // 2].tobytes())
    h.update(c[3, length // 2:].tobytes())
    assert h.digest() == got[3].tobytes()


@pytest.mark.parametrize("length", LENGTHS)
def test_mur3x256_matches_reference_and_numpy(length):
    c = chunks(5, length, 1000 + length)
    got = native.mur3x256_batch(HIGHWAY_KEY, c)
    assert np.array_equal(got, jmur3.hash256_batch(HIGHWAY_KEY, c))
    assert np.array_equal(got, mur3py.hash256_batch(HIGHWAY_KEY, c))
    assert native.mur3x256(HIGHWAY_KEY, c[1].tobytes()) == got[1].tobytes()
    h = native.Mur3x256(HIGHWAY_KEY)
    h.update(c[4].tobytes())
    assert h.digest() == mur3py.digest256_py(HIGHWAY_KEY, c[4].tobytes())


def test_multi_hashes_buffers_of_any_length():
    g = np.random.default_rng(3)
    bufs = [g.bytes(n) for n in LENGTHS]
    hh = native.hh256_multi(HIGHWAY_KEY, bufs)
    mu = native.mur3x256_many(HIGHWAY_KEY, bufs)
    for i, b in enumerate(bufs):
        assert hh[i].tobytes() == jhh.hash256(HIGHWAY_KEY, b)
        assert mu[i].tobytes() == mur3py.digest256_py(HIGHWAY_KEY, b)


@pytest.mark.parametrize("k,m,n", [(4, 2, 1000), (16, 4, 4096), (6, 3, 7)])
def test_cpu_encode_matches_reference(k, m, n):
    g = np.random.default_rng(k * n)
    mat = g.integers(0, 256, (m, k), dtype=np.uint8)
    data = g.integers(0, 256, (k, n), dtype=np.uint8)
    assert np.array_equal(native.cpu_encode(mat, data, m),
                          jnative.cpu_encode(mat, data, m))
    with pytest.raises(ValueError):
        native.cpu_encode(mat, data[:-1], m)


@pytest.mark.parametrize("algo", [native.ALGO_HIGHWAY, native.ALGO_MUR3])
@pytest.mark.parametrize("data_len,chunk", [(4 * 4096, 1024),
                                            (4 * 4096 - 5, 1024),
                                            (3000, 512)])
def test_fused_block_calls_match_reference(algo, data_len, chunk):
    k, m = 4, 2
    g = np.random.default_rng(data_len + algo)
    data = g.bytes(data_len)
    shard_len = -(-data_len // k)
    pmat = g.integers(0, 256, (m, k), dtype=np.uint8)
    fl = native.framed_len(shard_len, chunk)
    assert fl == jnative.framed_len(shard_len, chunk)
    out = native.put_block(data, data_len, pmat, k, m, shard_len, chunk,
                           HIGHWAY_KEY, algo)
    want = jnative.put_block(data, data_len, pmat, k, m, shard_len, chunk,
                             HIGHWAY_KEY, algo)
    assert np.array_equal(out, want)
    framed = [out[i * fl:(i + 1) * fl].tobytes() for i in range(k)]
    block, bad = native.get_block(framed, k, shard_len, chunk, HIGHWAY_KEY,
                                  algo)
    assert bad == -1
    assert block.tobytes()[:data_len] == data
    assert native.verify_framed(framed[1], shard_len, chunk, HIGHWAY_KEY,
                                algo) == -1
    hurt = bytearray(framed[2])
    hurt[-1] ^= 0x40  # the last chunk's payload
    framed[2] = bytes(hurt)
    _, bad = native.get_block(framed, k, shard_len, chunk, HIGHWAY_KEY, algo)
    assert bad == 2 == jnative.get_block(framed, k, shard_len, chunk,
                                         HIGHWAY_KEY, algo)[1]
    last = -(-shard_len // chunk) - 1
    assert native.verify_framed(framed[2], shard_len, chunk, HIGHWAY_KEY,
                                algo) == last
    with pytest.raises(ValueError):
        native.put_block(data, data_len, pmat, k, m, shard_len - 1, chunk,
                         HIGHWAY_KEY, algo)


def _longest_stall(fn) -> tuple[float, float]:
    """(the call's wall seconds, the longest stretch of it in which this
    thread, spinning meanwhile, did not get to run) for ``fn`` run on
    another thread."""
    span = []
    done = threading.Event()

    def run():
        t0 = time.perf_counter()
        fn()
        span[:] = [t0, time.perf_counter()]
        done.set()

    turns = []
    t = threading.Thread(target=run)
    t.start()
    while not done.is_set():
        turns.append(time.perf_counter())
    t.join(30)
    assert not t.is_alive()
    t0, t1 = span
    inside = [t0] + [x for x in turns if t0 < x < t1] + [t1]
    return t1 - t0, max(b - a for a, b in zip(inside, inside[1:]))


def test_hash_releases_the_interpreter_lock():
    """While a long native hash runs on one thread, this thread keeps
    running: its longest stall is far below the call's wall. The same
    call through a lock-holding ctypes.PyDLL stalls it for most of the
    call, so the check does not depend on how loaded the host is."""
    lib = native.load_native()
    held = ctypes.PyDLL(native.library_path())
    held.hh256_batch.argtypes = lib.hh256_batch.argtypes
    buf = chunks(1, 16 << 20, 7)
    out = np.empty((128, 32), dtype=np.uint8)

    def call(dll):
        # the same 16 MiB chunk 128 times (stride 0)
        return lambda: dll.hh256_batch(
            HIGHWAY_KEY, buf.ctypes.data_as(ctypes.c_char_p), 128, 0,
            buf.shape[1], out.ctypes.data_as(ctypes.c_char_p))

    wall, gap = _longest_stall(call(lib))
    assert out[0].tobytes() == jhh.hash256(HIGHWAY_KEY, buf.tobytes())
    hwall, hgap = _longest_stall(call(held))
    assert hgap > 0.5 * hwall  # the contrast: a held lock is seen
    assert gap < 0.5 * wall, (wall, gap)
