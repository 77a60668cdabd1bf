"""The port's dispatch runtime (minio_tpu_torch.runtime) on the CPU queue,
held to the behaviours of tests/test_dispatch.py and
tests/test_interactive_lane.py that apply to it: items bucket and coalesce;
masked/fused ride the interactive lane (MINIO_TPU_DISPATCH_INTERACTIVE_LANE
=0 turns it off) and complete head-first per bucket; a failed launch or
readback is salvaged on the host with bit-identical results and counted on
a CPU queue, and fails its waiters on a queue on the card; a build failure
raises and is not salvaged; a pinned staging buffer is not handed out
again before its copy's event completed. Every result is exact bytes
against the JAX package (its native library, its numpy ChaCha20 and its
reference scan) and the queue's own unfailed run."""
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from minio_tpu import native as jnative
from minio_tpu.crypto import chacha20poly1305 as jccp
from minio_tpu.native import highwayhash as jhh
from minio_tpu.native import mur3py as jmur3
from minio_tpu.ops import scan_pallas as jscan
from minio_tpu_torch.erasure.bitrot import HIGHWAY_KEY
from minio_tpu_torch.ops.rs_torch import get_codec, pack_shards, \
    unpack_shards
from minio_tpu_torch.runtime import completion
from minio_tpu_torch.runtime.bufpool import BufferPool, StagingPool
from minio_tpu_torch.runtime.dispatch import (DispatchQueue, _AsyncCompleter,
                                              _Bucket, _Flight)
from minio_tpu_torch.utils.errors import BuildError

CHUNK = 256


def shards(k: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (k, n),
                                                dtype=np.uint8)


def rebuild_case(codec, seed: int, lost=(1,), n: int = 512):
    """(gathered words, masks, full shards) of one masked rebuild item."""
    data = shards(codec.k, n, seed)
    full = np.concatenate([data, jnative.cpu_encode(
        codec.parity_rows, data, codec.m)])
    present = tuple(i for i in range(codec.k + codec.m)
                    if i not in lost)[:codec.k]
    masks = codec.target_masks_np(present, lost)
    return pack_shards(np.stack([full[j] for j in present])), masks, full


@pytest.fixture
def queue():
    qs = []

    def make(**kw):
        q = DispatchQueue(device="cpu", **kw)
        qs.append(q)
        return q
    yield make
    for q in qs:
        q.stop()


def test_encode_items_bucket_and_coalesce(queue):
    q = queue(max_batch=8, max_delay=0.05)
    codec = get_codec(4, 2, device="cpu")
    datas = [shards(4, 1024, i) for i in range(20)]
    futs = [q.encode(codec, pack_shards(d)) for d in datas]
    for d, f in zip(datas, futs):
        assert np.array_equal(unpack_shards(f.result(timeout=30)),
                              jnative.cpu_encode(codec.parity_rows, d, 2))
    st = q.stats()
    assert st["ops"]["encode"] == {"batches": st["batches"], "items": 20}
    assert st["batches"] >= 3 and st["max_items"] <= 8
    assert st["avg_batch"] > 1
    assert st["lanes"]["bulk"]["items"] == 20
    assert st["lanes"]["interactive"]["items"] == 0


def test_masked_mixed_loss_patterns_in_one_batch(queue):
    q = queue(max_batch=64, max_delay=0.05)
    codec = get_codec(6, 3, device="cpu")
    cases = []
    for i in range(12):
        lost = tuple(sorted({i % 6, (i * 2 + 1) % 9}))
        words, masks, full = rebuild_case(codec, 100 + i, lost)
        cases.append((q.masked(codec, words, masks), lost, full))
    for f, lost, full in cases:
        out = unpack_shards(f.result(timeout=30))
        for row, t in enumerate(lost):
            assert np.array_equal(out[row], full[t])


@pytest.mark.parametrize("lane_on", ["1", "0"])
def test_rebuilds_take_the_interactive_lane(queue, monkeypatch, lane_on):
    """masked/fused ride the interactive lane; encode stays bulk; with
    MINIO_TPU_DISPATCH_INTERACTIVE_LANE=0 everything rides bulk."""
    monkeypatch.setenv("MINIO_TPU_DISPATCH_INTERACTIVE_LANE", lane_on)
    q = queue(max_batch=64, max_delay=0.005)
    codec = get_codec(4, 2, device="cpu")
    words, masks, full = rebuild_case(codec, 0)
    futs = [q.masked(codec, words, masks) for _ in range(6)]
    for f in futs:
        assert np.array_equal(unpack_shards(f.result(timeout=30))[0],
                              full[1])
    q.encode(codec, pack_shards(shards(4, 512, 3))).result(timeout=30)
    st = q.stats()["lanes"]
    assert st["interactive"]["enabled"] is (lane_on == "1")
    if lane_on == "1":
        assert st["interactive"]["items"] == 6
        assert st["interactive"]["flushes"] >= 1
        assert st["bulk"]["items"] == 1
        assert st["interactive"]["async_completions"] == \
            st["interactive"]["flushes"]
    else:
        assert st["interactive"]["items"] == 0
        assert st["bulk"]["items"] == 7


def test_interactive_completions_in_submission_order(queue):
    """Batch cap 2 forces >= 5 interactive flushes for 10 items of one
    bucket; their futures resolve in submission order."""
    q = queue(max_batch=64, max_delay=0.005, interactive_batch=2)
    codec = get_codec(4, 2, device="cpu")
    order, futs = [], []
    for i in range(10):
        words, masks, full = rebuild_case(codec, i)
        f = q.masked(codec, words, masks)
        f.add_done_callback(lambda _f, i=i: order.append(i))
        futs.append((f, full))
    for f, full in futs:
        assert np.array_equal(unpack_shards(f.result(timeout=30))[0],
                              full[1])
    assert order == sorted(order)
    st = q.stats()["lanes"]["interactive"]
    assert st["flushes"] >= 5 and st["async_completions"] >= 5
    assert st["batch_cap"] == 2


class StandInEvent:
    """A CPU stand-in for torch.cuda.Event: query() is what the test sets;
    synchronize() raises when told to (a failed readback)."""

    def __init__(self, done: bool = False, fail: bool = False):
        self.done = done
        self.fail = fail

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        if self.fail:
            raise RuntimeError("stand-in readback failure")


def wait_for(cond, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        threading.Event().wait(0.001)


def test_async_completer_is_head_first_per_bucket():
    """A later flush of a bucket whose event landed first waits for the
    earlier one; another bucket's flush is not held up by it."""
    done: list = []

    class Q:
        ia_async_completions = 0

        def _complete(self, f):
            done.append(f.hosts[0])

    c = _AsyncCompleter(Q())
    ev = [StandInEvent() for _ in range(3)]
    a, b = _Bucket(None, "masked", key=("a",)), _Bucket(None, "masked",
                                                           key=("b",))
    c.start()
    try:
        c.submit(_Flight(a, [], ["a0"], ev[0]))
        c.submit(_Flight(a, [], ["a1"], ev[1]))
        c.submit(_Flight(b, [], ["b0"], ev[2]))
        ev[1].done = ev[2].done = True
        wait_for(lambda: done)
        threading.Event().wait(0.05)  # many poll intervals
        assert done == ["b0"]
        ev[0].done = True
        wait_for(lambda: len(done) == 3)
        assert done == ["b0", "a0", "a1"]
    finally:
        c.stop()
    assert not c.is_alive()


def _hh_words(rows: np.ndarray) -> np.ndarray:
    """The JAX package's HighwayHash-256 of every CHUNK of uint8 [r, n]
    rows -> uint32 [r, n // CHUNK * 8]."""
    d = jhh.hash256_batch(HIGHWAY_KEY, rows.reshape(-1, CHUNK))
    return d.reshape(rows.shape[0], -1).view(np.uint32)


def _items(codec, op: str, n: int):
    """n submissions of ``op`` on one bucket as (method, args, want): want
    is the item's result from the JAX package (its native library, numpy
    ChaCha20 and reference scan), or from the known shards."""
    out = []
    for i in range(n):
        data = shards(codec.k, 2 * CHUNK, 50 + i)
        words = pack_shards(data)
        if op in ("encode", "encode_hashed"):
            parity = jnative.cpu_encode(codec.parity_rows, data, codec.m)
            if op == "encode":
                out.append(("encode", (codec, words), pack_shards(parity)))
            else:
                out.append(("encode_hashed", (codec, words, HIGHWAY_KEY,
                                              CHUNK, 0),
                            (pack_shards(parity), _hh_words(
                                np.concatenate([data, parity])))))
        elif op in ("masked", "fused"):
            w, masks, full = rebuild_case(codec, 60 + i, (0, 5), 2 * CHUNK)
            rebuilt = full[[0, 5]]
            if op == "masked":
                out.append(("masked", (codec, w, masks),
                            pack_shards(rebuilt)))
            else:
                d = _hh_words(unpack_shards(w)).view(np.uint8).copy()
                valid = np.ones(codec.k, bool)
                if i == 1:
                    d[2, 5] ^= 1  # one corrupt source digest
                    valid[2] = False
                want = (pack_shards(rebuilt), valid) + (
                    (_hh_words(rebuilt),) if i % 2 == 0 else ())
                out.append(("fused", (codec, w, masks, d.view(np.uint32),
                                      HIGHWAY_KEY, CHUNK, 0, i % 2 == 0),
                            want))
        elif op == "verify":
            d = jmur3.hash256_batch(HIGHWAY_KEY, data.reshape(-1, CHUNK))
            d = d.reshape(codec.k, -1).copy()
            d[i % codec.k, 0] ^= i % 2
            valid = np.ones(codec.k, bool)
            valid[i % codec.k] = i % 2 == 0
            out.append(("verify", (codec, words, d.view(np.uint32),
                                   HIGHWAY_KEY, CHUNK, 1), valid))
        elif op == "sse_xor":
            g = np.random.default_rng(70 + i)
            pk = g.integers(0, 2**32, (3, 64), dtype=np.uint32)
            nonces = np.array([[7, 9, s] for s in (0, 1, 2 ** 32 - 1)],
                              dtype=np.uint32)
            key = g.bytes(32)
            ct, poly = jccp.keystream_xor(key, nonces,
                                          pk.view(np.uint8).reshape(3, -1))
            out.append(("sse_xor", (pk, key, nonces),
                        (ct.view(np.uint32), poly.view(np.uint32))))
        else:  # select_scan
            rows = b"".join(b"%d|%d|x\n" % (r, 90 + r * (i + 1))
                            for r in range(40))
            rows += b"\n" * (-len(rows) % 4)
            w = np.frombuffer(rows, dtype=np.uint32)[None]
            args = (w, (("num", 0, "lt", 100), ("num", 1, "ge", 0),
                        ("and",)), (1, 0), ord("|"), 64)
            want = jscan.scan_blocks_reference(
                w.view(np.uint8), *args[1:])[0].astype(np.int32)
            # rows past the block's newlines read RESIDUAL on the device
            # paths, where the reference leaves 0 (test_torch_scan.py)
            want[rows.count(b"\n"):] = jscan.RESIDUAL
            out.append(("select_scan", args, want))
    return out


def _results(q, subs):
    futs = [getattr(q, m)(*a) for m, a, _ in subs]
    return [f.result(timeout=60) for f in futs]


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


OPS = ["encode", "encode_hashed", "masked", "fused", "verify", "sse_xor",
       "select_scan"]


def _inject_failure(q, where: str) -> None:
    if where == "launch":
        def boom(*a, **kw):
            raise RuntimeError("injected launch failure")
        q._launch = boom
    else:
        real = q._flush

        def failing(lane, b, items):
            f = real(lane, b, items)
            f.event = StandInEvent(done=True, fail=True)
            return f
        q._flush = failing


@pytest.mark.parametrize("where", ["launch", "readback"])
@pytest.mark.parametrize("op", OPS)
def test_failed_flush_is_salvaged_bit_identical(queue, op, where,
                                                caplog):
    """On a CPU queue: the salvaged results equal the JAX package's and an
    unfailed queue's, byte for byte."""
    codec = get_codec(4, 2, device="cpu")
    subs = _items(codec, op, 4)
    unfailed = _results(queue(max_delay=0.05), subs)
    q = queue(max_delay=0.05)
    _inject_failure(q, where)
    got = _results(q, subs)
    for g, u, (_, _, w) in zip(got, unfailed, subs):
        assert _same(u, w)
        assert _same(g, w)
    st = q.stats()
    assert st["salvaged_items"] == 4 and st["failed_items"] == 0
    assert st["salvaged_batches"] == st["batches"] >= 1
    assert f"dispatch {op} flush" in caplog.text
    assert ("injected launch failure" if where == "launch"
            else "stand-in readback failure") in caplog.text


@pytest.mark.parametrize("where", ["launch", "readback"])
def test_failed_flush_on_the_card_fails_its_waiters(queue, where, caplog):
    """A queue on the card (here a CPU queue with the card's policy) never
    recomputes a failed flush on the host: every waiter gets the
    exception, and the failure is counted and logged."""
    q = queue(max_delay=0.05)
    q.host_salvage = False
    _inject_failure(q, where)
    codec = get_codec(4, 2, device="cpu")
    futs = [getattr(q, m)(*a) for m, a, _ in _items(codec, "encode", 3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="injected launch failure"
                           if where == "launch" else "stand-in readback"):
            f.result(timeout=30)
    st = q.stats()
    assert st["failed_items"] == 3 and st["salvaged_items"] == 0
    assert st["failed_batches"] == st["batches"] >= 1
    assert "its waiters get the error" in caplog.text


def test_build_failure_raises_and_is_not_salvaged(queue):
    q = queue(max_delay=0.005)

    def no_build(*a, **kw):
        raise BuildError("nvcc failed: stand-in")
    q._launch = no_build
    codec = get_codec(4, 2, device="cpu")
    f = q.encode(codec, pack_shards(shards(4, 512, 1)))
    with pytest.raises(BuildError):
        f.result(timeout=30)
    st = q.stats()
    assert st["salvaged_batches"] == 0 and st["failed_items"] == 1


def test_staging_buffer_waits_for_its_copy():
    """Overlapping flushes: a buffer whose copy is still in flight is never
    handed out; it comes back once its event completed."""
    pool = StagingPool(pin=False, per_key=2)
    shape = (4, 16)
    first = pool.get("encode.words", shape, torch.int32)
    ev1 = StandInEvent()
    pool.release("encode.words", first, ev1)
    second = pool.get("encode.words", shape, torch.int32)
    assert second is not first  # first's copy is in flight
    ev2 = StandInEvent()
    pool.release("encode.words", second, ev2)
    third = pool.get("encode.words", shape, torch.int32)
    assert third is not first and third is not second
    assert pool.stats()["busy"] == 2
    ev2.done = True
    assert pool.get("encode.words", shape, torch.int32) is second
    assert pool.get("encode.words", (8, 16), torch.int32) is not first
    ev1.done = True
    assert pool.get("encode.words", shape, torch.int32) is first
    st = pool.stats()
    assert st["hits"] == 2 and st["retained"] == 0


def test_buffer_pool_recycles_exact_sizes():
    pool = BufferPool(max_retained=3 << 20, min_pooled=1 << 20)
    a = pool.get(1 << 20)
    pool.put(a)
    assert pool.get(1 << 20) is a
    assert pool.get(2 << 20) is not a
    small = pool.get(100)
    pool.put(small)
    assert 100 not in pool.stats()["buckets"]
    assert pool.stats()["hits"] == 1


def test_await_result_counts_and_passes_through():
    completion.reset_stats()
    f = Future()
    f.set_result(41)
    assert completion.await_result(f, "rebuild") == 41
    g = Future()
    g.set_exception(ValueError("boom"))
    with pytest.raises(ValueError):
        completion.await_result(g, "rebuild")
    st = completion.stats()
    assert st["rebuild"]["waits"] == 2 and st["rebuild"]["seconds"] >= 0


def test_stop_drains_pending_items(queue):
    q = queue(max_batch=128, max_delay=30.0)
    codec = get_codec(4, 2, device="cpu")
    d = shards(4, 512, 9)
    f = q.encode(codec, pack_shards(d))
    q.stop()
    assert np.array_equal(unpack_shards(f.result(timeout=1)),
                          jnative.cpu_encode(codec.parity_rows, d, 2))
    with pytest.raises(RuntimeError):
        q.encode(codec, pack_shards(d))
