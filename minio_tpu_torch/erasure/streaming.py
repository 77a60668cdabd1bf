"""Streaming blockwise erasure pipeline — the port of erasure/streaming.py:
encode (write fan-out), decode (minimal-read gather + rebuild), heal.

Shard I/O runs on a shared thread pool (it overlaps across disks); the
GF(256) math and the bitrot hash of full blocks ride the dispatch queue,
which batches concurrent requests' blocks into single device launches:

- PUT: blocks whose shards are whole bitrot chunks, or one short tail
  chunk the device hash takes, go through ``encode_hashed`` (parity +
  digests of all k+m shards in one flush), and the host only interleaves
  ``[digest][chunk]`` frames; other tail blocks go through ``encode`` with
  the digests computed on the host.
- GET: the k source shards are read raw and their digests checked on the
  device — together with the rebuild of missing data shards (``fused``)
  for a degraded read, alone (``verify``) for a healthy one. A mismatch
  drops the corrupt source and redoes the block from host-verified
  replacement reads.
- Heal: only the target shards are rebuilt (``fused``, or ``masked`` for
  blocks that are not whole chunks), so heals of many objects coalesce.

Every wait on the queue goes through ``runtime.completion.await_result``
(counted per op), and a PUT's framed block comes from the buffer pool. The
JAX package verifies a healthy GET on the host, in native C++; the port
keeps the device hash there (the ``verify`` op).

Stage attribution (``obs/stages``, free when no collector is armed): a
PUT charges ``body_read``, ``encode_hash`` (the queue wait and the host
digests of a tail block), ``etag`` and ``shard_write``; a GET
``shard_read``, ``decode`` and ``write_out``; a heal ``shard_read``,
``rebuild`` and ``shard_write``. Every shard read and write submitted to
the IO pool carries the caller's context (``obs.spans.wrap_ctx``), so its
storage span lands in the request's trace.

Hedged reads (Dean and Barroso, "The Tail at Scale", CACM 2013): a block
read launches exactly k shard reads; when none of those in flight
completes within the hedge threshold, one more (parity) read is fired
without declaring the straggler dead, and the first k distinct shards to
arrive make the block (missing data shards rebuilt by ``fused`` on the
card). The threshold is 3x the p95 of the last minute's shard reads,
clamped to [``fault.hedge_floor_ms``, ``fault.hedge_ceil_ms``] and cached
0.5 s, or ``fault.hedge_ms`` when set; ``fault.hedge=0`` turns hedging off
(the config registry: env > stored > default).

A PUT reads its body into pooled block buffers through the stream's
``readinto`` when it has one (no ``bytes`` object per block). Left out
for a later slice: the native-fd host routes.
"""
from __future__ import annotations

import io
import os
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, \
    wait
from dataclasses import dataclass, field

import numpy as np

from ..obs import spans as _spans
from ..obs import stages as _stages
from ..runtime.bufpool import global_pool
from ..runtime.completion import await_result
from ..utils import errors
from .codec import Erasure, ceil_div

_io_pool: ThreadPoolExecutor | None = None
_io_lock = threading.Lock()

#: blocks in flight per stream: deep enough to fill a dispatch batch from
#: one hot PUT, shallow enough to bound buffering (window * block bytes)
ENCODE_WINDOW = 16


def io_pool() -> ThreadPoolExecutor:
    """Shared pool for shard reads and writes."""
    global _io_pool
    if _io_pool is None:
        with _io_lock:
            if _io_pool is None:
                # shard I/O is blocking but short: a few threads per core
                workers = min(64, max(8, 4 * (os.cpu_count() or 1)))
                _io_pool = ThreadPoolExecutor(
                    max_workers=workers, thread_name_prefix="minio-torch-io")
    return _io_pool


def shutdown_pools() -> None:
    """Drain and drop the shared IO pool (rebuilt lazily on next use)."""
    global _io_pool
    with _io_lock:
        pool, _io_pool = _io_pool, None
    if pool is not None:
        pool.shutdown(wait=True)


def _framed_writers(erasure: Erasure, writers: list):
    """(chunk, algo_id) when every live writer is a StreamingBitrotWriter
    on one device-hash algorithm with one chunk size dividing the
    full-block shard — the precondition for framing blocks with digests
    computed beside the parity. None otherwise."""
    from .bitrot import StreamingBitrotWriter, native_algo_id
    live = [w for w in writers if w is not None]
    if not live:
        return None
    if not all(isinstance(w, StreamingBitrotWriter)
               and native_algo_id(w.algo) is not None
               and not w._buf for w in live):
        return None
    chunks = {w.shard_size for w in live}
    if len(chunks) != 1:
        return None
    (chunk,) = chunks
    if erasure.shard_size() % chunk:
        return None
    return chunk, native_algo_id(live[0].algo)


@dataclass
class DecodeStats:
    """Per-call telemetry: which shard sources failed (for heal-on-read)."""
    errs: list = field(default_factory=list)  # per-reader exception or None
    bytes_written: int = 0
    hedged: int = 0  # hedge reads fired across the call's blocks


# --- hedged reads -------------------------------------------------------------

#: threshold = max(floor, MULT * p95 of the shard-read window): the
#: multiple keeps normal jitter from firing wasted parity reads
HEDGE_P95_MULT = 3.0
#: the latency-window family every shard read feeds (one unlabelled
#: series: the threshold is global, per-disk skew is what hedging routes
#: around)
_HEDGE_FAMILY = "hedge"
#: the adaptive threshold is recomputed at most this often
_THRESHOLD_TTL_S = 0.5
_threshold_cache: tuple[float, float] = (0.0, -1.0)


def _hedge_knob(key: str) -> str:
    """A ``fault.hedge*`` knob through the config registry (its
    environment names: ``MINIO_TPU_HEDGE``, ``_HEDGE_MS``,
    ``_HEDGE_FLOOR_MS``, ``_HEDGE_CEIL_MS``)."""
    from ..config import get_config_sys
    return get_config_sys().get("fault", key)


def hedging_enabled() -> bool:
    return _hedge_knob("hedge") not in ("0", "off")


def hedge_threshold_s() -> float:
    """The current hedge trigger in seconds."""
    global _threshold_cache
    ms = _hedge_knob("hedge_ms")
    if ms:
        try:
            return max(1e-3, float(ms) / 1e3)
        except ValueError:
            pass
    val, stamp = _threshold_cache
    now = time.monotonic()
    if 0.0 <= now - stamp < _THRESHOLD_TTL_S:
        return val
    from ..obs import latency as _lat
    win = _lat.get_window(_HEDGE_FAMILY, op="shard_read")
    p95 = win.percentiles((0.95,))[0.95]
    # the clamp is read at each refresh, so a config change moves it
    try:
        floor = float(_hedge_knob("hedge_floor_ms"))
        ceil = float(_hedge_knob("hedge_ceil_ms"))
    except ValueError:
        floor, ceil = 25.0, 1000.0
    val = min(ceil / 1e3, max(floor / 1e3, HEDGE_P95_MULT * p95))
    _threshold_cache = (val, now)
    return val


def _observe_shard_read(dur_s: float, nbytes: int) -> None:
    from ..obs import latency as _lat
    _lat.observe(_HEDGE_FAMILY, dur_s, nbytes, op="shard_read")


class _OrderedWriter:
    """Serializes one shard writer's writes while different writers (and
    blocks) proceed concurrently: each write chains onto the previous one's
    future, so no disk barriers on another between blocks."""

    def __init__(self, writer):
        self.writer = writer
        self._last: Future | None = None
        self._dead: BaseException | None = None

    def write_async(self, data: bytes) -> Future:
        return self._chain(lambda: self.writer.write(data))

    def write_framed_async(self, framed) -> Future:
        return self._chain(lambda: self.writer.write_framed(framed))

    def _chain(self, op) -> Future:
        out: Future = Future()
        if self._dead is not None:
            # a prior write on this disk failed: skip the doomed ones
            out.set_exception(self._dead)
            return out

        def run():
            try:
                out.set_result(op())
            except Exception as e:  # noqa: BLE001 — a vote for quorum
                self._dead = e
                out.set_exception(e)

        # contextvars do not follow executor submits: the write's storage
        # span joins the request's trace through the captured context
        run = _spans.wrap_ctx(run)
        prev, self._last = self._last, out
        if prev is None:
            io_pool().submit(run)
        else:
            # always hop to the pool: a done prev would run the callback
            # inline on the encoder thread and serialize the fan-out
            prev.add_done_callback(lambda _f: io_pool().submit(run))
        return out


def _read_full(stream, n: int) -> bytes:
    """Read up to n bytes, looping over short reads (io.ReadFull)."""
    chunks = []
    got = 0
    while got < n:
        b = stream.read(n - got)
        if not b:
            break
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def _read_full_into(stream, arr: np.ndarray) -> int:
    """readinto form of _read_full: fill ``arr`` from the stream, looping
    over short reads; returns the bytes read."""
    mv = memoryview(arr)
    got = 0
    n = len(mv)
    while got < n:
        r = stream.readinto(mv[got:])
        if not r:
            break
        got += r
    return got


def _vote(e: Exception) -> errors.StorageError:
    return e if isinstance(e, errors.StorageError) \
        else errors.FaultyDisk(str(e))


def erasure_encode(erasure: Erasure, stream, writers: list,
                   write_quorum: int, etag=None) -> int:
    """Read the stream block by block, erasure-encode on the device, fan
    shards out to ``writers`` (bitrot writers, None for offline disks).
    Returns the bytes consumed (reference Erasure.Encode).

    Up to ENCODE_WINDOW blocks are in flight through the dispatch queue,
    and shard writes ride per-disk ordered chains; write-quorum errors are
    harvested per block as its writes drain. A stream with ``readinto``
    fills pooled block buffers (each back in the pool once its block's
    shards are framed or copied for their writes); others are read into
    ``bytes``.

    ``etag``, when given, is a utils.hashreader.PipelineETag collector:
    every block's data-shard chunk digests are folded into it in stream
    order (blocks are started in submission order, whatever order their
    flushes complete in), whether the device flush or the host hash made
    them, so the fused ETag is the JAX package's on every route. Callers
    arm it only for framed writers whose chunk divides the shard (the
    object layer's gate)."""
    from .bitrot import device_chunk
    total = 0
    stc = _stages.active()
    owriters = [None if w is None else _OrderedWriter(w) for w in writers]
    enc_window: deque = deque()    # [kind, future, shard_len]
    write_window: deque = deque()  # {writer index: write future}
    k = erasure.data_blocks
    framed = _framed_writers(erasure, writers)
    chunk = algo_id = None
    if framed is not None:
        chunk, algo_id = framed

    def encode_block(buf, buf_arr=None):
        entry = _encode_entry(buf)
        entry.append(buf_arr)
        return entry

    def _encode_entry(buf):
        shard_len = ceil_div(len(buf), k) if len(buf) else 0
        dchunk = None if framed is None \
            else device_chunk(shard_len, chunk, algo_id)
        if dchunk is not None:
            # device hash lane: parity + all-shard digests in one flush (a
            # tail block whose shards are one short chunk included)
            return ["pyh", erasure.encode_hashed_async(buf, dchunk, algo_id),
                    shard_len]
        if framed is not None and len(buf):
            # a tail (or unaligned) block: host digests, same framing
            return ["pyf", erasure.encode_data_async(buf), shard_len]
        return ["py", erasure.encode_data_async(buf), shard_len]

    def start_writes(entry):
        kind, fut, shard_len, buf_arr = entry
        with _stages.timed(stc, "encode_hash"):
            res = await_result(fut, "encode")
        try:
            _start_writes(kind, res, shard_len)
        finally:
            # the block's shards are copied (framed, or tobytes) by now
            global_pool().put(buf_arr)

    def _start_writes(kind, res, shard_len):
        futs = {}
        if kind == "py":
            if etag is not None and shard_len and chunk:
                # framed writers without a device route for this block
                from .bitrot import shard_chunk_digests
                with _stages.timed(stc, "encode_hash"):
                    digs = shard_chunk_digests(np.stack(res[:k]), chunk,
                                               algo_id)
                with _stages.timed(stc, "etag"):
                    etag.add_digests(digs.data)
            for i, ow in enumerate(owriters):
                if ow is not None and writers[i] is not None:
                    futs[i] = ow.write_async(res[i].tobytes())
            write_window.append((futs, None))
            return
        from .bitrot import frame_block_shards, shard_chunk_digests
        if kind == "pyh":
            data2d, parity2d, digs = res
        else:
            with _stages.timed(stc, "encode_hash"):
                data2d, parity2d = np.stack(res[:k]), np.stack(res[k:])
                digs = np.concatenate([
                    shard_chunk_digests(data2d, chunk, algo_id),
                    shard_chunk_digests(parity2d, chunk, algo_id)])
        if etag is not None:
            with _stages.timed(stc, "etag"):
                etag.add_digests(np.ascontiguousarray(digs[:k]).data)
        shape = (len(writers), digs.shape[1] + shard_len)
        buf = global_pool().get(shape[0] * shape[1])
        framed_all = buf.reshape(shape)
        frame_block_shards(data2d, digs[:k], chunk, out=framed_all[:k])
        frame_block_shards(parity2d, digs[k:], chunk, out=framed_all[k:])
        for i, ow in enumerate(owriters):
            if ow is not None and writers[i] is not None:
                futs[i] = ow.write_framed_async(framed_all[i])
        write_window.append((futs, buf))

    def harvest_writes():
        futs, buf = write_window.popleft()
        errs: list = [None] * len(writers)
        for i in range(len(writers)):
            if writers[i] is None:
                errs[i] = errors.DiskNotFound()
        with _stages.timed(stc, "shard_write"):
            for i, f in futs.items():
                try:
                    f.result()
                except Exception as e:  # noqa: BLE001 — disk errors are votes
                    errs[i] = _vote(e)
                    writers[i] = None
        # every write of the block has returned: its framed buffer is free
        global_pool().put(buf)
        err = errors.reduce_write_quorum_errs(
            errs, errors.BASE_IGNORED_ERRS, write_quorum)
        if err is not None:
            raise err

    bs = erasure.block_size
    use_readinto = hasattr(stream, "readinto")

    def read_block():
        """One block's payload: (buffer, its pooled array or None)."""
        if not use_readinto:
            with _stages.timed(stc, "body_read"):
                return _read_full(stream, bs), None
        arr = global_pool().get(bs)
        try:
            with _stages.timed(stc, "body_read"):
                got = _read_full_into(stream, arr)
        except BaseException:
            global_pool().put(arr)
            raise
        if got == 0:
            global_pool().put(arr)
            return b"", None
        from ..obs import metrics as _mx
        _mx.inc("minio_tpu_pipeline_zero_copy_bytes_total", got, path="put")
        return arr[:got], arr

    eof = False
    try:
        while not eof or enc_window or write_window:
            while not eof and len(enc_window) < ENCODE_WINDOW:
                buf, buf_arr = read_block()
                if not len(buf):
                    eof = True
                    if total == 0 and not enc_window:
                        # empty object: one empty block for quorum
                        enc_window.append(encode_block(b""))
                    break
                if len(buf) < bs:
                    eof = True
                total += len(buf)
                enc_window.append(encode_block(buf, buf_arr))
            if enc_window:
                start_writes(enc_window.popleft())
            while len(write_window) > (ENCODE_WINDOW if enc_window or not eof
                                       else 0):
                harvest_writes()
    except BaseException:
        # quiesce in-flight writes before propagating: the caller aborts
        # the writers next, and a write racing an abort corrupts them
        for futs, _ in write_window:
            for f in futs.values():
                try:
                    f.result()
                except Exception:  # noqa: BLE001 — already failing
                    pass
        raise
    return total


class _ParallelReader:
    """Minimal-read shard gather: exactly ``data_blocks`` concurrent reads,
    replacement reads fired on failure or, hedged, when none in flight
    completes within the hedge threshold, preferring earlier (data) shards
    (reference parallelReader)."""

    def __init__(self, readers: list, erasure: Erasure):
        self.readers = list(readers)
        self.erasure = erasure
        self.errs: list = [None] * len(readers)
        self.last_digests: list = [None] * len(readers)
        self.hedged = 0  # hedge reads fired across this reader's blocks
        for i, r in enumerate(self.readers):
            if r is None:
                self.errs[i] = errors.DiskNotFound()

    def fusable(self, shard_len: int) -> bool:
        """True when this block's source digests can be checked on the
        device: every live reader supports raw chunk reads, all share one
        chunk size and algorithm, and the read covers whole chunks (or is
        one short tail chunk the device hash takes)."""
        live = [r for r in self.readers if r is not None]
        if not live or not all(getattr(r, "fusable", False) for r in live):
            return False
        if len({r.shard_size for r in live}) != 1 or \
                len({r.algo for r in live}) != 1:
            return False
        return self.fuse_chunk(shard_len) is not None

    def fuse_chunk(self, shard_len: int) -> int | None:
        """The device-hash chunk size of a block's shards (bitrot.
        device_chunk)."""
        from .bitrot import device_chunk
        c = next(r.shard_size for r in self.readers if r is not None)
        return device_chunk(shard_len, c, self.fuse_algo())

    def fuse_algo(self) -> int:
        from .bitrot import native_algo_id
        return native_algo_id(
            next(r.algo for r in self.readers if r is not None))

    def read_block(self, shard_offset: int, shard_len: int,
                   raw: bool = False) -> list:
        """A k+m shard list with >= k filled entries, or ErasureReadQuorum.
        With raw=True the chunk digests are not checked here; they land in
        self.last_digests for the device check. A hedged straggler is
        neither declared dead nor voted into ``errs``: its read is simply
        not consumed."""
        k = self.erasure.data_blocks
        n = len(self.readers)
        shards: list = [None] * n
        digests: list = [None] * n
        pending: dict = {}  # future -> reader index
        t_launch: dict = {}
        next_idx = 0

        def launch_one() -> int | None:
            nonlocal next_idx
            while next_idx < n:
                i = next_idx
                next_idx += 1
                if self.readers[i] is None:
                    continue
                fn = self.readers[i].read_at_raw if raw \
                    else self.readers[i].read_at
                f = io_pool().submit(_spans.wrap_ctx(fn), shard_offset,
                                     shard_len)
                pending[f] = i
                t_launch[f] = time.monotonic()
                return i
            return None

        for _ in range(k):
            if launch_one() is None:
                break
        done = 0
        hedge_t = hedge_threshold_s() if hedging_enabled() else None
        hedged_idx: set = set()
        while pending and done < k:
            # first-completed order: a fast failure fires its replacement
            # while slower disks are still in flight
            ready, _ = wait(list(pending), timeout=hedge_t,
                            return_when=FIRST_COMPLETED)
            if not ready:
                # the hedge: nothing completed within the threshold, so
                # one more read goes out and the first k shards win
                i = launch_one()
                if i is None:
                    hedge_t = None  # nothing left to hedge with: wait
                    continue
                hedged_idx.add(i)
                self.hedged += 1
                self._note_hedge(i)
                continue
            for f in ready:
                i = pending.pop(f)
                try:
                    data = f.result()
                    _observe_shard_read(
                        time.monotonic() - t_launch.pop(f), shard_len)
                    if raw:
                        digests[i], data = data
                    shards[i] = np.frombuffer(data, dtype=np.uint8)
                    done += 1
                except Exception as e:  # noqa: BLE001 — a vote, then retry
                    t_launch.pop(f, None)
                    self.errs[i] = _vote(e)
                    self.readers[i] = None
                    launch_one()
        if done < k:
            err = errors.reduce_read_quorum_errs(
                self.errs, errors.BASE_IGNORED_ERRS, k)
            raise err if err is not None else errors.ErasureReadQuorum()
        if hedged_idx:
            from ..obs import metrics as mx
            won = any(shards[i] is not None for i in hedged_idx)
            mx.inc("minio_tpu_hedged_reads_total",
                   outcome="won" if won else "lost")
        self.last_digests = digests
        return shards

    @staticmethod
    def _note_hedge(idx: int) -> None:
        """Count the fired hedge and put a ``hedge.read`` span into the
        live request's trace."""
        from ..obs import metrics as mx
        mx.inc("minio_tpu_hedged_reads_total", outcome="fired")
        try:
            ctx = _spans.current()
            if ctx is None or not ctx.sampled:
                return
            _spans.record({
                "name": "hedge.read", "trace_id": ctx.trace_id,
                "span_id": _spans.new_span_id(),
                "parent_span_id": ctx.span_id, "time": time.time(),
                "duration_s": 0.0, "error": "", "attrs": {"shard": idx}})
        except Exception:  # noqa: BLE001 — obs must never break reads
            pass

    def drop_corrupt(self, corrupt: tuple[int, ...]) -> None:
        """Mark sources whose device-checked digests mismatched as failed,
        so later blocks read replacements."""
        for i in corrupt:
            self.errs[i] = errors.FileCorrupt("bitrot hash mismatch")
            self.readers[i] = None


def erasure_decode(erasure: Erasure, writer, readers: list, offset: int,
                   length: int, total_length: int) -> DecodeStats:
    """Gather-and-rebuild read path (reference Erasure.Decode): stream
    [offset, offset+length) of the object into ``writer``; readers are
    bitrot shard readers (None = offline). Returns per-reader errors for
    heal-on-read."""
    if offset < 0 or length < 0 or offset + length > total_length:
        raise ValueError("invalid decode range")
    stats = DecodeStats()
    preader = _ParallelReader(readers, erasure)
    stats.errs = preader.errs
    if length == 0:
        return stats
    k = erasure.data_blocks
    bs = erasure.block_size
    start_block = offset // bs
    end_block = (offset + length) // bs
    window: deque = deque()
    stc = _stages.active()

    def submit(b: int):
        """Read block b's shards and return a window entry, or None when
        the block adds no bytes to the requested range."""
        block_data_len = min(bs, total_length - b * bs)
        if block_data_len <= 0:
            return None
        boff = offset % bs if b == start_block else 0
        if b == end_block:
            blen = (offset + length) - b * bs - boff
        else:
            blen = block_data_len - boff
        if blen <= 0:
            return None
        shard_len = ceil_div(block_data_len, k)
        shard_offset = b * erasure.shard_size()
        if preader.fusable(shard_len):
            with _stages.timed(stc, "shard_read"):
                shards = preader.read_block(shard_offset, shard_len,
                                            raw=True)
            fut = erasure.decode_data_blocks_verified_async(
                shards, preader.last_digests, preader.fuse_chunk(shard_len),
                preader.fuse_algo())
            return ["verified", fut, b, block_data_len, boff, blen]
        with _stages.timed(stc, "shard_read"):
            shards = preader.read_block(shard_offset, shard_len)
        return ["plain", erasure.decode_data_blocks_async(shards), b,
                block_data_len, boff, blen]

    def redo_block(corrupt: tuple[int, ...], b: int,
                   block_data_len: int) -> list:
        """Bitrot mismatch: the block's output is garbage. Drop the
        corrupt sources, redo this block from host-verified replacement
        reads, then resubmit the pending device-verified entries (their
        raw reads carried the corrupt shard too)."""
        preader.drop_corrupt(corrupt)
        with _stages.timed(stc, "shard_read"):
            shards = preader.read_block(b * erasure.shard_size(),
                                        ceil_div(block_data_len, k))
        blocks = erasure.decode_data_blocks(shards)
        pending = list(window)
        window.clear()
        for e in pending:
            if e[0] == "plain":
                window.append(e)
                continue
            try:
                await_result(e[1], "decode")  # drain the abandoned flush
            except Exception:  # noqa: BLE001 — redone either way
                pass
            window.append(submit(e[2]))
        return blocks

    def emit(entry):
        kind, fut, b, block_data_len, boff, blen = entry
        with _stages.timed(stc, "decode"):
            res = await_result(fut, "decode")
        if kind == "verified":
            blocks, corrupt = res
            if corrupt:
                blocks = redo_block(corrupt, b, block_data_len)
        else:
            blocks = res
        block = np.concatenate(blocks[:k])
        with _stages.timed(stc, "write_out"):
            writer.write(memoryview(block)[boff: boff + blen])
        stats.bytes_written += blen

    for b in range(start_block, end_block + 1):
        entry = submit(b)
        if entry is None:
            break
        window.append(entry)
        if len(window) >= ENCODE_WINDOW:
            emit(window.popleft())
    while window:
        emit(window.popleft())
    stats.hedged = preader.hedged
    return stats


def erasure_heal(erasure: Erasure, writers: list, readers: list,
                 total_length: int) -> list:
    """Rebuild the shards owned by the non-None writers (the disks being
    healed) blockwise and stream them out, write quorum 1 (reference
    Erasure.Heal). Returns the per-reader error votes.

    Only the target shards are computed, and rebuilds ride the dispatch
    queue, so concurrent heals of many objects coalesce into batched
    launches."""
    if total_length == 0:
        _close_heal_writers(writers)
        return [None] * len(readers)
    k = erasure.data_blocks
    bs = erasure.block_size
    targets = tuple(i for i, w in enumerate(writers) if w is not None)
    if not targets:
        return [None] * len(readers)
    preader = _ParallelReader(readers, erasure)
    n_blocks = ceil_div(total_length, bs)
    window: deque = deque()
    # framed heal writers on the sources' chunk size get the rebuilt
    # shards' digests from the same flush, so the host hashes nothing
    from .bitrot import device_chunk
    framed = _framed_writers(erasure, writers)
    stc = _stages.active()

    def submit(b: int):
        block_data_len = min(bs, total_length - b * bs)
        shard_len = ceil_div(block_data_len, k)
        shard_offset = b * erasure.shard_size()
        if preader.fusable(shard_len):
            chunk = preader.fuse_chunk(shard_len)
            hashed = framed is not None and \
                framed[1] == preader.fuse_algo() and \
                device_chunk(shard_len, *framed) == chunk
            with _stages.timed(stc, "shard_read"):
                shards = preader.read_block(shard_offset, shard_len,
                                            raw=True)
            fut = erasure.rebuild_targets_verified_async(
                shards, preader.last_digests, targets, chunk,
                preader.fuse_algo(), hash_out=hashed)
            return ["fused", fut, b, hashed]
        with _stages.timed(stc, "shard_read"):
            shards = preader.read_block(shard_offset, shard_len)
        return ["plain", erasure.rebuild_targets_async(shards, targets), b,
                False]

    def emit(entry):
        kind, fut, b, hashed = entry
        with _stages.timed(stc, "rebuild"):
            res = await_result(fut, "rebuild")
        frames = None
        if kind == "fused":
            rebuilt, corrupt = res[0], res[1]
            if hashed and not corrupt:
                from .bitrot import frame_block_shards
                frames = frame_block_shards(np.stack(rebuilt), res[2],
                                            framed[0])
            if corrupt:
                # drop corrupt sources, redo this block from host-verified
                # replacement reads, resubmit the pending fused entries
                preader.drop_corrupt(corrupt)
                block_data_len = min(bs, total_length - b * bs)
                with _stages.timed(stc, "shard_read"):
                    shards = preader.read_block(b * erasure.shard_size(),
                                                ceil_div(block_data_len, k))
                with _stages.timed(stc, "rebuild"):
                    rebuilt = await_result(erasure.rebuild_targets_async(
                        shards, targets), "rebuild")
                pending = list(window)
                window.clear()
                for e in pending:
                    window.append(e if e[0] == "plain" else submit(e[2]))
        else:
            rebuilt = res
        errs: list = [None] * len(writers)
        wrote = 0
        for row, (t, arr) in enumerate(zip(targets, rebuilt)):
            w = writers[t]
            if w is None:
                continue
            try:
                with _stages.timed(stc, "shard_write"):
                    if frames is not None:
                        w.write_framed(frames[row])
                    else:
                        w.write(arr.tobytes())
                wrote += 1
            except Exception as e:  # noqa: BLE001 — a per-disk vote
                errs[t] = e
                writers[t] = None
        if wrote == 0:
            err = errors.reduce_write_quorum_errs(
                errs, errors.BASE_IGNORED_ERRS, 1)
            raise err if err is not None else errors.ErasureWriteQuorum()

    for b in range(n_blocks):
        window.append(submit(b))
        if len(window) >= ENCODE_WINDOW:
            emit(window.popleft())
    while window:
        emit(window.popleft())
    _close_heal_writers(writers)
    return preader.errs


def _close_heal_writers(writers: list) -> None:
    """Per-writer close: one disk's failed close stays that disk's vote
    (its slot is nulled) instead of aborting the other targets."""
    for t, w in enumerate(writers):
        if w is None:
            continue
        try:
            w.close()
        except Exception:  # noqa: BLE001 — demoted to a per-disk vote
            writers[t] = None


class BufferSink:
    """In-memory byte sink with the writer interface."""

    def __init__(self):
        self.buf = io.BytesIO()
        self.closed = False

    def write(self, b):
        self.buf.write(b)

    def close(self):
        self.closed = True

    def getvalue(self) -> bytes:
        return self.buf.getvalue()


class PreallocSink:
    """In-memory sink over one buffer allocated up front: ``get_object``
    calls ``hint_total(n)`` once the object's length is known, so the
    blocks land in place without the growing copies of a BytesIO and
    ``getbuffer()`` hands the bytes out without a final copy. Without the
    hint the buffer doubles as needed."""

    def __init__(self, nbytes: int | None = None):
        self.arr = np.empty(nbytes, np.uint8) if nbytes is not None \
            else None
        self.pos = 0
        self.closed = False

    def hint_total(self, n: int) -> None:
        """Called by the read path once the object size is known."""
        if self.arr is None:
            self.arr = np.empty(n, np.uint8)

    def _ensure(self, n: int) -> None:
        if self.arr is not None and self.pos + n <= self.arr.nbytes:
            return
        if self.arr is None:
            self.arr = np.empty(max(n, 64 << 10), np.uint8)
        else:
            grown = np.empty(max(self.arr.nbytes * 2, self.pos + n),
                             np.uint8)
            grown[:self.pos] = self.arr[:self.pos]
            self.arr = grown

    def write(self, b) -> None:
        n = len(b)
        if n == 0:
            return
        self._ensure(n)
        self.arr[self.pos: self.pos + n] = np.frombuffer(b, dtype=np.uint8)
        self.pos += n

    def close(self):
        self.closed = True

    def getvalue(self) -> bytes:
        if self.arr is None:
            return b""
        return self.arr[: self.pos].tobytes()

    def getbuffer(self) -> memoryview:
        """Zero-copy view of the filled buffer."""
        if self.arr is None:
            return memoryview(b"")
        return memoryview(self.arr)[: self.pos]


class BufferSource:
    """read_at over an in-memory bytes blob."""

    def __init__(self, data: bytes):
        self.data = data

    def read_at(self, offset: int, length: int) -> bytes:
        if offset >= len(self.data):
            raise errors.FileCorrupt("read past end of shard file")
        return self.data[offset: offset + length]
