"""DispatchQueue — batches GF(256) shard work from concurrent requests into
single device launches; the port of runtime/dispatch.py.

Mechanics (as in the JAX package):
- a submit returns a ``concurrent.futures.Future``; items bucket by
  (op, geometry, shard words, hash key, chunk, algo);
- two lanes, each a dispatcher thread with its own buckets and (on the
  card) its own CUDA stream:
  - the **bulk lane** flushes a bucket when it holds ``max_batch`` items
    (128 by default) or its oldest item has waited ``max_delay`` (1 ms), as
    ONE launch over the stacked [B, ...] batch;
  - the **interactive lane** takes ``_INTERACTIVE_LANE_OPS`` (``masked``,
    ``fused``: heal rebuilds and degraded-GET reconstruct) in small batches
    (``dispatch.interactive_batch``, 8) after a short window
    (``dispatch.interactive_delay_us``, 200 us), so a rebuild never queues
    behind a bulk flush's staging and launches. ``dispatch.interactive_lane
    =0`` (``MINIO_TPU_DISPATCH_INTERACTIVE_LANE``) sends every op down the
    bulk lane (read at construction and on every submit);
- a flush stacks its items' inputs into pinned staging buffers
  (``bufpool.StagingPool``), copies them with ``non_blocking=True`` on the
  lane's stream, launches, enqueues the copy of the outputs into pinned
  host buffers and records a CUDA event. The dispatcher never waits on the
  card: a bulk flush's readback (the event's synchronize and
  ``set_result``) runs on a pool of ``COMPLETERS`` threads; the interactive
  lane's on one poller thread (``_AsyncCompleter``) that checks
  ``Event.query()`` and completes flushes head-first per bucket, so
  results arrive in submission order;
- a flush whose launch or readback raises on a queue on the card fails its
  futures with that exception: work never moves from the card to the host.
  On a CPU queue it is **salvaged**: its items are recomputed on the host —
  the GF(256) math and the bitrot hashes on the native library (native/),
  ``sse_xor`` and ``select_scan`` on the plain PyTorch versions — with the
  same bytes. A ``kernel`` rule of the fault plane (``fault/``) fails or
  delays a flush at its start the same way. Both are counted
  (``stats()["failed_batches"]``/
  ``["failed_items"]``, ``["salvaged_batches"]``/``["salvaged_items"]``)
  and logged with the op and the exception. A library that fails to build
  (``BuildError``) fails the futures on either queue;
- flushes and items are counted per op and per lane (a lane's busy
  seconds are the flight recorder's, obs/timeline).

Ops, with the meaning of the JAX ``_flush_device`` branches:
``encode`` (parity of [k, W] words), ``encode_hashed`` (parity + per-chunk
digests of all k+m shards), ``masked`` (rebuild o rows from per-item
[8, o, k] masks), ``fused`` (masked + digest check of the k sources),
``verify`` (the digest check alone, for the healthy GET, whose rebuild-free
verify the JAX package runs in native C++ on the host), ``sse_xor`` (the
ChaCha20 keystream XOR of SSE packages, many objects each under its own key,
in one launch per flush) and ``select_scan`` (the S3 Select row codes of CSV
blocks under one compiled WHERE program: K6 on a CUDA queue, its plain
version on a CPU queue; concurrent selects with the same SQL share a
flush).

A CPU queue (``device="cpu"``) runs the same lanes on the plain versions,
with no staging and no events.

Instruments (``obs/``), at the JAX queue's sites: an item's QoS class and
stream come from ``qos.current_class()``/``current_stream()`` (the stream
override picks the lane, ``_INTERACTIVE_LANE_OPS`` otherwise; both ride
the bucket key); the flight recorder gets ``enqueue``, ``flush_start``,
``flush_end``, ``complete`` and ``salvage`` events and the sampled queue
depth; every item's wall through the queue feeds the ``kernel``, ``qos``
and ``lane`` latency windows and its stage collector's ``queue_wait``; a
flush publishes one ``kernel`` trace (while someone listens) and one
kernel span per traced request, linked to every coalesced item's span;
the device ledger holds a flush's bytes from launch to readback; and on
the card a flush's copies and launches sit between two CUDA events on its
lane's stream, read by the completer into ``obs/device``'s device time,
busy shares and roofline. None of it synchronizes the card or waits on
the dispatcher. The profiler sees a dispatcher thread tagged with the
flush's class and op while it flushes; ``lockrank.note_blocking`` reports
a tracked lock held across a flush; the SLO plane gets every background
item's outcome (a failed one burns the class's availability budget).
Left out for later slices: the QoS planner,
``LinkProfile`` and spill-to-CPU, the device mesh and per-lane placement,
input donation, and batch padding (it bounded XLA recompiles; PyTorch
runs eagerly).
"""
from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import fault as _fault
from .. import native
from .. import qos as _qos
from ..obs import device as _dev
from ..obs import latency as _lat
from ..obs import lockrank as _lr
from ..obs import profiler as _prof
from ..obs import slo as _slo
from ..obs import spans as _sp
from ..obs import stages as _stages
from ..obs import timeline as _tl
from ..obs import trace as _trc
from ..ops import chacha_cuda, rs_cuda, scan_cuda
from ..ops import fused as _fused
from ..ops.chacha_torch import check_shared_nonce
from ..ops.rs_torch import words_to_device
from ..qos.budget import _config_float
from ..utils.device import resolve_device
from ..utils.errors import BuildError
from .bufpool import StagingPool

log = logging.getLogger("minio_tpu_torch.dispatch")

MAX_BATCH = 128
MAX_DELAY_S = 1e-3
#: readback threads of the bulk lane (and of failed flushes), sized to the
#: host
COMPLETERS = max(4, os.cpu_count() or 4)
#: defaults of the interactive lane's knobs (config subsystem
#: ``dispatch``, read when a queue is built): items per flush at most
#: (``interactive_batch``), the coalescing window, which trades batch fill
#: for latency (``interactive_delay_us``), and the interval at which the
#: lane's completer polls its events (``interactive_poll_us``)
INTERACTIVE_BATCH = 8
INTERACTIVE_DELAY_S = 200e-6
INTERACTIVE_POLL_S = 100e-6

OPS = ("encode", "encode_hashed", "masked", "fused", "verify", "sse_xor",
       "select_scan")

#: ops that ride the interactive lane: heal-shard rebuilds and degraded-GET
#: reconstruct, plus their fused verify+rebuild twin
_INTERACTIVE_LANE_OPS = frozenset({"masked", "fused"})

#: op labels of the timeline, traces, spans and metrics (the JAX queue's)
_OP_NAME = {"encode": "encode", "masked": "reconstruct", "fused": "fused",
            "encode_hashed": "encode_hashed", "verify": "verify",
            "select_scan": "select_scan", "sse_xor": "sse_xor"}


def interactive_lane_enabled() -> bool:
    """dispatch.interactive_lane / MINIO_TPU_DISPATCH_INTERACTIVE_LANE: 0
    sends every op down the bulk lane."""
    return _config_float("dispatch", "interactive_lane",
                         "MINIO_TPU_DISPATCH_INTERACTIVE_LANE", 1.0) != 0.0


def interactive_batch_cap() -> int:
    """Bound on items per interactive-lane flush."""
    return max(1, int(_config_float(
        "dispatch", "interactive_batch",
        "MINIO_TPU_DISPATCH_INTERACTIVE_BATCH", INTERACTIVE_BATCH)))


def interactive_delay_s() -> float:
    """Max coalescing wait on the interactive lane."""
    return max(0.0, _config_float(
        "dispatch", "interactive_delay_us",
        "MINIO_TPU_DISPATCH_INTERACTIVE_DELAY_US",
        INTERACTIVE_DELAY_S * 1e6)) / 1e6


def interactive_poll_s() -> float:
    """Poll interval of the interactive lane's completer."""
    return max(1e-6, _config_float(
        "dispatch", "interactive_poll_us",
        "MINIO_TPU_DISPATCH_INTERACTIVE_POLL_US",
        INTERACTIVE_POLL_S * 1e6)) / 1e6


@dataclass
class _Pending:
    words: np.ndarray                   # [k, W] uint32 packed input shards
    masks: np.ndarray | None = None     # [8, o, k] rebuild masks
    digests: np.ndarray | None = None   # [k, nc*8] expected digest words
    nonces: np.ndarray | None = None    # sse_xor: [P, 3] package nonces
    cipher_key: bytes = b""              # sse_xor: the object's package key
    future: Future = field(default_factory=Future)
    t: float = field(default_factory=time.monotonic)
    ctx: object = None                   # the submitter's sampled span
    stc: object = None                   # the submitter's stage collector


@dataclass
class _Bucket:
    codec: object
    op: str
    hash_key: bytes | None = None
    chunk_size: int = 0
    hash_algo: int = 0
    hash_out: bool = False
    params: tuple = ()                  # select_scan: program, cols, ...
    items: list = field(default_factory=list)
    key: tuple = ()
    cls: str = _qos.CLASS_INTERACTIVE   # the submitters' QoS class


class _Lane:
    """One dispatcher thread: its buckets (under its own condition), its
    flush parameters, its CUDA stream and its counters."""

    def __init__(self, name: str, max_batch: int, max_delay: float, device):
        self.name = name
        self.max_batch = max_batch
        self.max_delay = max_delay
        self.cv = threading.Condition(threading.Lock())
        self.buckets: dict[tuple, _Bucket] = {}
        self.stream = torch.cuda.Stream(device=device) \
            if device.type == "cuda" else None
        self.flushes = 0
        self.items = 0
        self.thread: threading.Thread | None = None


@dataclass
class _Flight:
    """A launched flush awaiting its readback."""
    b: _Bucket
    items: list
    hosts: list                          # host outputs (pinned on the card)
    event: object = None                 # torch.cuda.Event, None when ready
    lane: str = "bulk"
    t0: float = 0.0                      # flush start, host monotonic
    nbytes: int = 0                      # inputs + outputs of the flush
    flush_id: int = 0                    # timeline pairing (0: recorder off)
    start: object = None                 # CUDA event before the copies in
    origin: object = None                # obs.device clock origin
    token: object = None                 # device ledger charge

    def ready(self) -> bool:
        if self.event is None:
            return True
        try:
            return self.event.query()
        except RuntimeError:  # a sticky device error: fail its waiters
            return True


def _stage(arrays: list[np.ndarray], device, staging: StagingPool | None
           = None, role: str = "") -> tuple[torch.Tensor, torch.Tensor | None]:
    """The items' uint32 arrays stacked as one int32 tensor: on the card
    into a pinned buffer of ``staging`` (the host half only: the caller
    copies it over with ``non_blocking``), elsewhere on ``device``
    itself. Returns (tensor, the staging buffer to release after its
    copy, or None)."""
    if staging is None or device.type != "cuda":
        return words_to_device(np.stack(arrays), device), None
    buf = staging.get(role, (len(arrays),) + arrays[0].shape, torch.int32)
    # one call, not one per item: under many request threads every
    # release of the interpreter lock costs the dispatcher a wait
    np.stack(arrays, out=buf.numpy().view(np.uint32), casting="unsafe")
    return buf, buf


def _inputs(b: _Bucket, items: list) -> dict[str, list]:
    """The arrays a flush stacks, by role."""
    roles = {"words": [p.words for p in items]}
    if b.op == "sse_xor":
        roles["keys"] = [np.frombuffer(p.cipher_key, "<u4") for p in items]
        roles["nonces"] = [p.nonces for p in items]
    if b.op in ("masked", "fused"):
        roles["masks"] = [p.masks for p in items]
    if b.op in ("fused", "verify"):
        roles["digests"] = [p.digests for p in items]
    return roles


def _rows_from_masks(masks: np.ndarray) -> np.ndarray:
    """uint32 [8, o, k] bit-plane masks -> uint8 [o, k] coefficients
    (masks[b] is all-ones where bit b of the coefficient is set)."""
    return ((masks & 1).astype(np.uint8)
            << np.arange(8, dtype=np.uint8)[:, None, None]).sum(
                axis=0, dtype=np.uint8)


def _host_result(b: _Bucket, p: _Pending):
    """One item's result computed on the host, with the bytes of the
    kernels: the GF(256) product and the bitrot hashes on the native
    library, ``sse_xor`` and ``select_scan`` on the plain versions."""
    if b.op == "select_scan":
        x = torch.from_numpy(np.array(p.words, np.uint32).view(
            np.int32).reshape(1, -1))
        return scan_cuda.scan_codes(x, *b.params)[0].numpy()
    if b.op == "sse_xor":
        key = torch.from_numpy(np.frombuffer(p.cipher_key, "<u4").astype(
            np.uint32).view(np.int32))
        out, pk = chacha_cuda.chacha20_xor(
            key[None], torch.from_numpy(p.nonces.astype(np.uint32).view(
                np.int32))[None],
            torch.from_numpy(np.array(p.words, np.uint32).view(
                np.int32))[None])
        return out[0].numpy().view(np.uint32), pk[0].numpy().view(np.uint32)
    u8 = np.ascontiguousarray(p.words, np.uint32).view(np.uint8)
    k = u8.shape[0]
    if b.op == "verify":
        out = None
    else:
        rows = b.codec.parity_rows if b.op in ("encode", "encode_hashed") \
            else _rows_from_masks(p.masks)
        out = native.cpu_encode(rows, u8, rows.shape[0])
    if b.op in ("encode", "masked"):
        return out.view(np.uint32)
    hash_fn = native.batch_hasher(b.hash_algo)
    if b.op == "encode_hashed":
        both = np.concatenate([u8, out])
        digs = hash_fn(b.hash_key, both.reshape(-1, b.chunk_size))
        return out.view(np.uint32), \
            digs.reshape(both.shape[0], -1).view(np.uint32)
    digs = hash_fn(b.hash_key, u8.reshape(-1, b.chunk_size)).reshape(k, -1)
    want = np.ascontiguousarray(p.digests, np.uint32).view(np.uint8)
    valid = np.all(digs == want.reshape(k, -1), axis=1)
    if b.op == "verify":
        return valid
    if not b.hash_out:
        return out.view(np.uint32), valid
    odigs = hash_fn(b.hash_key, out.reshape(-1, b.chunk_size))
    return out.view(np.uint32), valid, \
        odigs.reshape(out.shape[0], -1).view(np.uint32)


class _AsyncCompleter(threading.Thread):
    """The interactive lane's completer: launched flushes register here,
    and ONE thread polls their events, completing a flush only once its
    readback has landed — no thread parks inside a device wait. Flushes are
    kept in per-bucket FIFOs and completed head-first, so flush k+1's
    futures never resolve before flush k's (the heal writer window relies
    on block order)."""

    def __init__(self, q: "DispatchQueue"):
        super().__init__(name="minio-tpu-torch-ia-complete", daemon=True)
        self.q = q
        self.poll_s = interactive_poll_s()
        self._cv = threading.Condition()
        self._pending: dict[tuple, deque] = {}
        self._stopping = False

    def submit(self, f: _Flight) -> None:
        with self._cv:
            self._pending.setdefault(f.b.key, deque()).append(f)
            self._cv.notify()

    def stop(self) -> None:
        """Complete everything still pending (blocking readbacks are fine at
        shutdown) and join."""
        with self._cv:
            self._stopping = True
            self._cv.notify()
        self.join(timeout=30)

    def run(self):
        while True:
            ready: list[_Flight] = []
            with self._cv:
                while not self._stopping and not self._pending:
                    self._cv.wait()
                if self._stopping and not self._pending:
                    return
                for key in list(self._pending):
                    dq = self._pending[key]
                    while dq and (self._stopping or dq[0].ready()):
                        ready.append(dq.popleft())
                    if not dq:
                        del self._pending[key]
                poll = bool(self._pending) and not ready
            for f in ready:
                self.q.ia_async_completions += 1
                self.q._complete(f)
            if poll:
                time.sleep(self.poll_s)


class DispatchQueue:
    def __init__(self, device=None, max_batch: int = MAX_BATCH,
                 max_delay: float = MAX_DELAY_S, completers: int = COMPLETERS,
                 interactive_batch: int | None = None):
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_delay = max_delay
        self._stop = False
        self._stats_lock = threading.Lock()
        self.batches = {op: 0 for op in OPS}
        self.items = {op: 0 for op in OPS}
        self.max_items = 0
        #: seconds completers spent reading flushes back (event waits,
        #: results handed out, their callbacks)
        self.completer_seconds = 0.0
        self.ia_async_completions = 0
        self.failed_batches = 0
        self.failed_items = 0
        self.salvaged_batches = 0
        self.salvaged_items = 0
        #: instruments (obs/) that raised; never fatal to a flush
        self.obs_errors = 0
        #: a failed flush is recomputed on the host only on a CPU queue
        self.host_salvage = self.device.type != "cuda"
        self.staging = StagingPool() if self.device.type == "cuda" else None
        #: the traces' route label (the JAX queue's "device"/"cpu")
        self.route = "device" if self.device.type == "cuda" else "cpu"
        self._clock = None
        if self.device.type == "cuda":
            _dev.note_card(torch.cuda.get_device_name(self.device))
            self._clock = _dev.clock(self.device)
        self._completers = ThreadPoolExecutor(
            max_workers=completers,
            thread_name_prefix="minio-tpu-torch-complete")
        self._bulk = _Lane("bulk", max_batch, max_delay, self.device)
        if interactive_batch is None:
            interactive_batch = interactive_batch_cap()
        self._ia = _Lane("interactive", interactive_batch,
                         interactive_delay_s(), self.device) \
            if interactive_lane_enabled() else None
        self._ia_completer = _AsyncCompleter(self) if self._ia else None
        if self._ia_completer is not None:
            self._ia_completer.start()
        for lane in self._lanes():
            lane.thread = threading.Thread(
                target=self._loop, args=(lane,), daemon=True,
                name=f"minio-tpu-torch-dispatch-{lane.name}")
            lane.thread.start()

    def _lanes(self) -> list[_Lane]:
        return [self._bulk] + ([self._ia] if self._ia else [])

    # --- submission ---------------------------------------------------------

    def encode(self, codec, words: np.ndarray) -> Future:
        """words uint32 [k, W] -> Future[uint32 [m, W]] (parity)."""
        key = ("encode", codec.k, codec.m, words.shape[-1], id(codec))
        return self._submit(key, _Bucket(codec, "encode"), _Pending(words))

    def encode_hashed(self, codec, words: np.ndarray, hash_key: bytes,
                      chunk_size: int, hash_algo: int = 0) -> Future:
        """words uint32 [k, W] -> Future[(parity uint32 [m, W], digests
        uint32 [k+m, nc*8])]: the per-chunk bitrot digests of every data
        and parity shard come back with the parity."""
        key = ("encode_hashed", codec.k, codec.m, words.shape[-1], id(codec),
               hash_key, chunk_size, hash_algo)
        return self._submit(
            key, _Bucket(codec, "encode_hashed", hash_key, chunk_size,
                         hash_algo), _Pending(words))

    def masked(self, codec, words: np.ndarray, masks: np.ndarray) -> Future:
        """words uint32 [k, W] + masks uint32 [8, o, k] -> Future[[o, W]].
        Per-item masks let one batch mix loss patterns; batches key on o."""
        key = ("masked", codec.k, masks.shape[1], words.shape[-1])
        return self._submit(key, _Bucket(codec, "masked"),
                            _Pending(words, masks))

    def fused(self, codec, words: np.ndarray, masks: np.ndarray,
              digests: np.ndarray, hash_key: bytes, chunk_size: int,
              hash_algo: int = 0, hash_out: bool = False) -> Future:
        """masked() plus the digest check of the k sources against
        ``digests`` uint32 [k, nc*8] -> Future[(out [o, W], valid bool
        [k])]; with ``hash_out`` a third element, the digests of the
        rebuilt rows, uint32 [o, nc*8]."""
        key = ("fused", codec.k, masks.shape[1], words.shape[-1], hash_key,
               chunk_size, hash_algo, hash_out)
        return self._submit(
            key, _Bucket(codec, "fused", hash_key, chunk_size, hash_algo,
                         hash_out), _Pending(words, masks, digests))

    def verify(self, codec, words: np.ndarray, digests: np.ndarray,
               hash_key: bytes, chunk_size: int, hash_algo: int = 0
               ) -> Future:
        """The digest check alone: words uint32 [k, W] + digests uint32
        [k, nc*8] -> Future[valid bool [k]]."""
        key = ("verify", words.shape[0], words.shape[-1], hash_key,
               chunk_size, hash_algo)
        return self._submit(
            key, _Bucket(codec, "verify", hash_key, chunk_size, hash_algo),
            _Pending(words, None, digests))

    def sse_xor(self, words: np.ndarray, cipher_key: bytes,
                nonces: np.ndarray) -> Future:
        """SSE ChaCha20 package crypto (ops/chacha_cuda.py, K4): one
        object's packages uint32 [P, pkg//4] under its 32-byte key and
        per-package nonces uint32 [P, 3] -> Future[(xored uint32
        [P, pkg//4], poly_keys uint32 [P, 8])]. Items of many objects, each
        with its own key, share one launch per flush."""
        if len(cipher_key) != 32:
            raise ValueError("ChaCha20 keys are 32 bytes")
        if nonces.shape != (words.shape[0], 3):
            raise ValueError(f"nonces {nonces.shape} do not match "
                             f"{words.shape[0]} packages")
        check_shared_nonce(nonces)
        key = ("sse_xor", words.shape)
        return self._submit(key, _Bucket(None, "sse_xor"),
                            _Pending(words, nonces=nonces,
                                     cipher_key=cipher_key))

    def select_scan(self, words: np.ndarray, program: tuple, cols: tuple,
                    delim: int, max_rows: int) -> Future:
        """S3 Select predicate scan (ops/scan_cuda.py, K6): one CSV block
        as uint32 words [1, L//4] (newline-terminated, newline-padded) ->
        Future[codes int32 [max_rows]]. Blocks of one request, and of
        concurrent requests running the same compiled program, bucket
        together into one launch."""
        key = ("select_scan", words.shape[-1], program, cols, delim,
               max_rows)
        return self._submit(
            key, _Bucket(None, "select_scan",
                         params=(program, cols, delim, max_rows)),
            _Pending(words))

    def _submit(self, key: tuple, new_bucket: _Bucket, p: _Pending) -> Future:
        # the QoS class and the stream ride the bucket key: a flush is one
        # class's, on one lane (an explicit qos.device_stream wins over
        # the per-op default; with the interactive lane off every op is
        # the bulk lane's)
        cls = _qos.current_class()
        stream = _qos.current_stream()
        if stream is None:
            stream = _qos.STREAM_INTERACTIVE \
                if new_bucket.op in _INTERACTIVE_LANE_OPS else _qos.STREAM_BULK
        lane = self._ia if self._ia is not None and \
            stream == _qos.STREAM_INTERACTIVE and \
            interactive_lane_enabled() else self._bulk
        ctx = _sp.current()
        p.ctx = ctx if ctx is not None and ctx.sampled else None
        p.stc = _stages.active()
        new_bucket.key = key + (cls, lane.name)
        new_bucket.cls = cls
        with lane.cv:
            if self._stop:
                raise RuntimeError("dispatch queue stopped")
            b = lane.buckets.setdefault(new_bucket.key, new_bucket)
            b.items.append(p)
            depth = len(b.items)
            lane.cv.notify()
        # flight recorder: the item entered its bucket (sampled event type,
        # recorded outside the lane's lock)
        _tl.record("enqueue", op=_OP_NAME[new_bucket.op],
                   trace_id=p.ctx.trace_id if p.ctx is not None else "",
                   bytes=p.words.nbytes, bucket_depth=depth,
                   stream=lane.name, **{"class": cls})
        return p.future

    # --- dispatchers --------------------------------------------------------

    def _loop(self, lane: _Lane):
        while True:
            to_flush: list[tuple[_Bucket, list[_Pending]]] = []
            with lane.cv:
                while not self._stop:
                    now = time.monotonic()
                    deadline = None
                    for key in list(lane.buckets):
                        b = lane.buckets[key]
                        if not b.items:
                            del lane.buckets[key]
                            continue
                        age = now - b.items[0].t
                        if len(b.items) >= lane.max_batch or \
                                age >= lane.max_delay:
                            items = b.items[:lane.max_batch]
                            b.items = b.items[lane.max_batch:]
                            to_flush.append((b, items))
                        else:
                            d = b.items[0].t + lane.max_delay
                            deadline = d if deadline is None \
                                else min(deadline, d)
                    if to_flush:
                        break
                    lane.cv.wait(timeout=None if deadline is None
                                 else max(0.0, deadline - time.monotonic()))
                stopping = self._stop
                if stopping:
                    # drain everything still queued so no waiter hangs
                    for b in lane.buckets.values():
                        while b.items:
                            items = b.items[:lane.max_batch]
                            b.items = b.items[lane.max_batch:]
                            to_flush.append((b, items))
                    lane.buckets.clear()
                # the lane's queue depth when flushes are collected, the
                # collected items included
                depth = sum(len(b.items) for b in lane.buckets.values()) + \
                    sum(len(items) for _, items in to_flush)
            _tl.note_queue_depth(depth)
            for b, items in to_flush:
                self._run_flush(lane, b, items)
            if stopping:
                return

    def _run_flush(self, lane: _Lane, b: _Bucket, items: list[_Pending]):
        # the sampling profiler joins this dispatcher thread's samples to
        # the batch's class and op for the duration of the flush
        _prof.set_task_tag(b.cls, _OP_NAME[b.op])
        try:
            self._run_flush_tagged(lane, b, items)
        finally:
            _prof.clear_task_tag()

    def _run_flush_tagged(self, lane: _Lane, b: _Bucket,
                          items: list[_Pending]):
        t0 = time.monotonic()
        n = len(items)
        for p in items:
            if p.stc is not None:
                p.stc.add("queue_wait", t0 - p.t)
        fid = 0
        if _tl.enabled():
            fid = _tl.next_flush_id()
            _tl.record("flush_start", op=_OP_NAME[b.op], lane=lane.name,
                       flush_id=fid, batch=n, capacity=lane.max_batch,
                       bytes=sum(p.words.nbytes for p in items),
                       route=self.route, stream=lane.name,
                       **{"class": b.cls})
        flight = failed = None
        try:
            flight = self._flush(lane, b, items)
        except Exception as e:  # noqa: BLE001 — handed on below
            failed = e
        # counted before any item completes, so a waiter sees its flush
        with self._stats_lock:
            lane.flushes += 1
            lane.items += n
            self.batches[b.op] += 1
            self.items[b.op] += n
            self.max_items = max(self.max_items, n)
        if failed is not None:
            self._completers.submit(self._failed, b, items, failed, "launch",
                                    _Flight(b, items, [], lane=lane.name,
                                            t0=t0, flush_id=fid))
            return
        flight.t0, flight.flush_id = t0, fid
        if lane is self._ia:
            self._ia_completer.submit(flight)
        else:
            self._completers.submit(self._complete, flight)

    def _flush(self, lane: _Lane, b: _Bucket, items: list[_Pending]
               ) -> _Flight:
        """Stage, launch and enqueue the readback of one flush. On the card
        every input is stacked into its pinned buffer first, so the two
        CUDA events around the copies and launches leave the host's
        staging out (the stream's waits for the host to enqueue the next
        copy or launch stay in)."""
        # a lock held across a flush's copies and launches is a convoy
        # generator even when it never deadlocks: lockrank reports it
        _lr.note_blocking(f"device_flush:{b.op}")
        if _fault.armed("kernel"):
            # the per-flush injection point (the JAX package's target
            # "device"): a delay holds the flush, an error fails it exactly
            # as a failed launch does (``_failed``: salvaged on a CPU
            # queue, its waiters get the error on the card)
            _fault.inject("kernel", "device", b.op)
        dev = self.device
        roles = _inputs(b, items)
        nbytes = sum(a.nbytes for arrs in roles.values() for a in arrs)
        _dev.note_launch(_OP_NAME[b.op], f"{len(items)}x"
                         f"{'x'.join(map(str, items[0].words.shape))}")
        if dev.type != "cuda":
            outs = self._launch(b, len(items), {
                r: _stage(arrs, dev)[0] for r, arrs in roles.items()})
            f = _Flight(b, items, [o.numpy() for o in outs], lane=lane.name)
        else:
            staged = {r: _stage(arrs, dev, self.staging, f"{b.op}.{r}")
                      for r, arrs in roles.items()}
            timed = _dev.enabled()
            origin = start = None
            with torch.cuda.stream(lane.stream):
                if timed:
                    origin = self._clock.origin(lane.stream)
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(lane.stream)
                outs = self._launch(b, len(items), {
                    r: host.to(dev, non_blocking=True)
                    for r, (host, _) in staged.items()})
                hosts = []
                for o in outs:
                    h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    h.copy_(o, non_blocking=True)
                    hosts.append(h)
                event = torch.cuda.Event(blocking=True, enable_timing=timed)
                event.record(lane.stream)
            for r, (_, buf) in staged.items():
                self.staging.release(f"{b.op}.{r}", buf, event)
            f = _Flight(b, items, hosts, event, lane=lane.name, start=start,
                        origin=origin)
        f.nbytes = nbytes + sum(o.nbytes for o in outs)
        f.token = _dev.ledger_acquire(lane.name, f.nbytes)
        return f

    def _launch(self, b: _Bucket, n: int, t: dict) -> tuple[torch.Tensor, ...]:
        """The kernels of one flush over its inputs ``t`` (by role, on the
        queue's device)."""
        words = t["words"]
        shard_nbytes = int(words.shape[-1]) * 4
        if b.op == "select_scan":
            return (scan_cuda.scan_codes(words.reshape(n, -1), *b.params),)
        if b.op == "sse_xor":
            return chacha_cuda.chacha20_xor(t["keys"], t["nonces"], words)
        if b.op == "encode":
            return (b.codec.encode_words_batch(words),)
        if b.op == "encode_hashed":
            return _fused.encode_hashed_fn_for(
                b.hash_key, shard_nbytes, b.codec.encode_words_batch,
                b.chunk_size, b.hash_algo)(words)
        if b.op == "masked":
            return (rs_cuda.gf_matmul_batched(t["masks"], words),)
        if b.op == "fused":
            return _fused.fused_fn_for(
                b.hash_key, shard_nbytes, rs_cuda.gf_matmul_batched,
                b.chunk_size, b.hash_algo, b.hash_out)(
                    t["masks"], words, t["digests"])
        return (_fused.verify_fn_for(  # verify
            b.hash_key, shard_nbytes, b.chunk_size, b.hash_algo)(
                words, t["digests"]),)

    # --- completion ---------------------------------------------------------

    def _complete(self, f: _Flight) -> None:
        """Wait for a flush's readback and hand each item its result; a
        readback that raises goes to ``_failed``. The device time and the
        flush's trace and span are recorded before any waiter wakes."""
        t0 = time.monotonic()
        try:
            if f.event is not None:
                f.event.synchronize()
            host = [h.numpy() if isinstance(h, torch.Tensor) else h
                    for h in f.hosts]
            if f.b.op != "select_scan":  # words travel as int32 bits
                host = [h.view(np.uint32) if h.dtype == np.int32 else h
                        for h in host]
            self._observe(self._note_device_time, f)
            self._observe(self._flush_done, f)
            # the flush's device buffers are done with: released before any
            # waiter wakes, so a drained queue reads balanced
            _dev.ledger_release(f.token)
            for i, p in enumerate(f.items):
                # sse_xor results are whole payloads: each item gets a
                # copy, so one slow consumer does not pin the flush's batch
                res = tuple(h[i].copy() if f.b.op == "sse_xor" else h[i]
                            for h in host)
                p.future.set_result(res if len(res) > 1 else res[0])
            self._observe(self._items_done, f)
        except Exception as e:  # noqa: BLE001 — handed on to the waiters
            self._failed(f.b, f.items, e, "readback", f)
        finally:
            _dev.ledger_release(f.token)
            with self._stats_lock:
                self.completer_seconds += time.monotonic() - t0

    def _observe(self, record, *args, **kwargs) -> None:
        """Run one instrument; one that raises never fails the flush's
        waiters: it is counted (``stats()["obs_errors"]``) and logged."""
        try:
            record(*args, **kwargs)
        except Exception:  # noqa: BLE001 — counted, logged, never fatal
            with self._stats_lock:
                self.obs_errors += 1
            log.exception("dispatch instrument %s failed", record.__name__)

    def _note_device_time(self, f: _Flight) -> None:
        """The flush's CUDA-event interval (its events have completed) into
        obs/device: device seconds by op, the lane's busy seconds and the
        card's union."""
        if f.start is None:
            return
        secs = f.start.elapsed_time(f.event) / 1e3
        start = self._clock.position(f.origin, f.start)
        _dev.note_device_time(_OP_NAME[f.b.op], secs, f.nbytes, lane=f.lane,
                              device=str(self.device), start_s=start,
                              end_s=start + secs)

    def _flush_done(self, f: _Flight, error: str = "") -> None:
        """One flush's own records: the timeline's ``flush_end`` (which
        feeds the lane's busy ratio), the ``kernel`` trace while someone
        listens, and one kernel span per traced request, linked to every
        coalesced item's span."""
        op = _OP_NAME[f.b.op]
        n = len(f.items)
        now = time.monotonic()
        dur = now - f.t0
        if f.flush_id:
            _tl.record("flush_end", op=op, lane=f.lane, flush_id=f.flush_id,
                       batch=n, capacity=self._lane_cap(f.lane),
                       bytes=f.nbytes, route=self.route, stream=f.lane,
                       dur=round(dur, 6))
        if not n:
            return
        if _trc.subscribed():
            _trc.publish_kernel(
                op=op, route=self.route, batch=n,
                queue_wait_s=f.t0 - min(p.t for p in f.items),
                duration_s=dur, input_bytes=f.nbytes, error=error)
        traced = [p for p in f.items if p.ctx is not None]
        if not traced or not _sp.enabled():
            return
        groups: dict[str, list[_Pending]] = {}
        links = []
        seen: set[tuple[str, str]] = set()
        for p in traced:
            groups.setdefault(p.ctx.trace_id, []).append(p)
            key = (p.ctx.trace_id, p.ctx.span_id)
            if key not in seen:
                seen.add(key)
                links.append({"trace_id": p.ctx.trace_id,
                              "span_id": p.ctx.span_id})
        span_id = _sp.new_span_id()
        wall0 = time.time() - dur
        for tid, ps in groups.items():
            _sp.record({
                "name": f"kernel.{op}", "trace_id": tid, "span_id": span_id,
                "parent_span_id": ps[0].ctx.span_id, "time": wall0,
                "duration_s": round(dur, 6), "error": error,
                "links": links,
                "attrs": {"route": self.route, "lane": f.lane, "batch": n,
                          "batch_id": f.flush_id, "items": len(ps),
                          "queue_wait_s": round(
                              f.t0 - min(p.t for p in ps), 6)}})

    def _items_done(self, f: _Flight) -> None:
        """Each completed item's wall through the queue (submit to result)
        into the ``kernel``, ``qos`` and ``lane`` latency windows, and its
        ``complete`` event; a background item's into the SLO plane (the
        request plane feeds the interactive and control classes)."""
        op = _OP_NAME[f.b.op]
        now = time.monotonic()
        for p in f.items:
            wall = now - p.t
            nbytes = p.words.nbytes
            tid = p.ctx.trace_id if p.ctx is not None else ""
            if f.b.cls == _qos.CLASS_BACKGROUND:
                _slo.record(f.b.cls, wall, trace_id=tid)
            _lat.observe("kernel", wall, nbytes, op=op, trace_id=tid)
            _lat.observe("qos", wall, nbytes, trace_id=tid,
                         **{"class": f.b.cls})
            _lat.observe("lane", wall, nbytes, trace_id=tid, stream=f.lane)
            _tl.record("complete", op=op, trace_id=tid, wall=round(wall, 6),
                       stream=f.lane, **{"class": f.b.cls})

    def _lane_cap(self, name: str) -> int:
        return self._ia.max_batch if name == "interactive" and self._ia \
            else self._bulk.max_batch

    def _failed(self, b: _Bucket, items: list[_Pending], exc: Exception,
                where: str, f: _Flight | None = None) -> None:
        """A flush whose launch or readback raised: on a CPU queue its items
        are recomputed on the host (``_host_result``); on the card, or when
        a library failed to build, its waiters get the exception. Counted,
        logged and put on the timeline either way."""
        items = [p for p in items if not p.future.done()]
        if not items:
            return
        salvage = self.host_salvage and not isinstance(exc, BuildError)
        with self._stats_lock:
            if salvage:
                self.salvaged_batches += 1
                self.salvaged_items += len(items)
            else:
                self.failed_batches += 1
                self.failed_items += len(items)
        log.warning("dispatch %s flush of %d items failed at its %s (%s: "
                    "%s); %s", b.op, len(items), where, type(exc).__name__,
                    exc, "salvaged on the host" if salvage
                    else "its waiters get the error")
        if salvage:
            _tl.record("salvage", op=_OP_NAME[b.op], lane="cpu", reason=where,
                       batch=len(items))
        if f is not None:
            self._observe(self._flush_done, f, f"{type(exc).__name__}: {exc}")
            _dev.ledger_release(f.token)
        for p in items:
            if salvage:
                try:
                    p.future.set_result(_host_result(b, p))
                except Exception as e:  # noqa: BLE001 — the waiter gets it
                    p.future.set_exception(e)
            else:
                p.future.set_exception(exc)
            if b.cls == _qos.CLASS_BACKGROUND:
                # a failed background item burns the class's availability
                # budget; a salvaged one is an outcome like any other
                self._observe(
                    _slo.record, b.cls, time.monotonic() - p.t,
                    error=p.future.exception() is not None,
                    trace_id=p.ctx.trace_id if p.ctx is not None else "")

    # --- lifecycle and counters ---------------------------------------------

    def stop(self):
        """Drain both lanes, complete every flush in flight, join."""
        for lane in self._lanes():
            with lane.cv:
                self._stop = True
                lane.cv.notify_all()
        for lane in self._lanes():
            lane.thread.join(timeout=30)
        if self._ia_completer is not None:
            self._ia_completer.stop()
        self._completers.shutdown(wait=True)

    def reset_stats(self) -> None:
        with self._stats_lock:
            for op in OPS:
                self.batches[op] = 0
                self.items[op] = 0
            self.max_items = 0
            self.completer_seconds = 0.0
            self.ia_async_completions = 0
            self.failed_batches = self.failed_items = 0
            self.salvaged_batches = self.salvaged_items = 0
            self.obs_errors = 0
            for lane in self._lanes():
                lane.flushes = lane.items = 0

    def stats(self) -> dict:
        with self._stats_lock:
            batches = sum(self.batches.values())
            items = sum(self.items.values())
            lanes = {lane.name: {"flushes": lane.flushes,
                                 "items": lane.items}
                     for lane in self._lanes()}
            lanes.setdefault("interactive", {"flushes": 0, "items": 0})
            lanes["interactive"].update(
                enabled=self._ia is not None,
                batch_cap=self._ia.max_batch if self._ia else 0,
                async_completions=self.ia_async_completions)
            return {"batches": batches, "items": items,
                    "ops": {op: {"batches": self.batches[op],
                                 "items": self.items[op]} for op in OPS},
                    "max_items": self.max_items,
                    "avg_batch": items / batches if batches else 0.0,
                    "lanes": lanes,
                    "completer_seconds": self.completer_seconds,
                    "failed_batches": self.failed_batches,
                    "failed_items": self.failed_items,
                    "salvaged_batches": self.salvaged_batches,
                    "salvaged_items": self.salvaged_items,
                    "obs_errors": self.obs_errors,
                    "staging": self.staging.stats() if self.staging
                    else None}


_queues: dict[str, DispatchQueue] = {}
_queues_lock = threading.Lock()


def global_queue(device=None) -> DispatchQueue:
    """The process-wide queue of one device (created on first use)."""
    dev = str(resolve_device(device))
    q = _queues.get(dev)
    if q is None:
        with _queues_lock:
            q = _queues.get(dev)
            if q is None:
                q = _queues[dev] = DispatchQueue(dev)
    return q


def shutdown_global() -> None:
    """Stop every global queue (draining pending work) and forget them."""
    with _queues_lock:
        qs = list(_queues.values())
        _queues.clear()
    for q in qs:
        q.stop()
