"""DispatchQueue — batches GF(256) shard work from concurrent requests into
single device launches; the port of runtime/dispatch.py.

Mechanics (as in the JAX package):
- a submit returns a ``concurrent.futures.Future``; items bucket by
  (op, geometry, shard words, hash key, chunk, algo);
- a dispatcher thread flushes a bucket when it holds ``max_batch`` items
  (128 by default) or its oldest item has waited ``max_delay`` (1 ms), as
  ONE launch over the stacked [B, ...] batch;
- batches and items are counted per op (``stats()``).

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

Left out for later slices: the QoS planner and spill-to-CPU (a failed
launch fails its futures; no flush is salvaged on the host), the
interactive lane, the device mesh and per-lane placement, input donation,
and batch padding (it bounded XLA recompiles; PyTorch runs eagerly).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import chacha_cuda, rs_cuda, scan_cuda
from ..ops import fused as _fused
from ..ops.chacha_torch import check_shared_nonce
from ..ops.rs_torch import words_to_device
from ..utils.device import resolve_device

MAX_BATCH = 128
MAX_DELAY_S = 1e-3

OPS = ("encode", "encode_hashed", "masked", "fused", "verify", "sse_xor",
       "select_scan")


@dataclass
class _Pending:
    words: np.ndarray                   # [k, W] uint32 packed input shards
    masks: np.ndarray | None = None     # [8, o, k] rebuild masks
    digests: np.ndarray | None = None   # [k, nc*8] expected digest words
    nonces: np.ndarray | None = None    # sse_xor: [P, 3] package nonces
    cipher_key: bytes = b""              # sse_xor: the object's package key
    future: Future = field(default_factory=Future)
    t: float = field(default_factory=time.monotonic)


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


def _stack(arrays: list[np.ndarray], device) -> torch.Tensor:
    return words_to_device(np.stack(arrays), device)


class DispatchQueue:
    def __init__(self, device=None, max_batch: int = MAX_BATCH,
                 max_delay: float = MAX_DELAY_S):
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_delay = max_delay
        self._cv = threading.Condition(threading.Lock())
        self._buckets: dict[tuple, _Bucket] = {}
        self._stop = False
        self.batches = {op: 0 for op in OPS}
        self.items = {op: 0 for op in OPS}
        #: wall seconds inside flushes, per op
        self.seconds = {op: 0.0 for op in OPS}
        self.max_items = 0
        #: wall seconds the dispatcher spent inside flushes (stack, host->
        #: device copy, launches, readback): its busy share of a run
        self.flush_seconds = 0.0
        self._thread = threading.Thread(
            target=self._loop, name="minio-tpu-torch-dispatch", daemon=True)
        self._thread.start()

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
        with self._cv:
            if self._stop:
                raise RuntimeError("dispatch queue stopped")
            b = self._buckets.setdefault(key, new_bucket)
            b.items.append(p)
            self._cv.notify()
        return p.future

    # --- dispatcher ---------------------------------------------------------

    def _loop(self):
        while True:
            to_flush: list[tuple[_Bucket, list[_Pending]]] = []
            with self._cv:
                while not self._stop:
                    now = time.monotonic()
                    deadline = None
                    for key in list(self._buckets):
                        b = self._buckets[key]
                        if not b.items:
                            del self._buckets[key]
                            continue
                        age = now - b.items[0].t
                        if len(b.items) >= self.max_batch or \
                                age >= self.max_delay:
                            items = b.items[:self.max_batch]
                            b.items = b.items[self.max_batch:]
                            to_flush.append((b, items))
                        else:
                            d = b.items[0].t + self.max_delay
                            deadline = d if deadline is None \
                                else min(deadline, d)
                    if to_flush:
                        break
                    self._cv.wait(timeout=None if deadline is None
                                  else max(0.0, deadline - time.monotonic()))
                stopping = self._stop
                if stopping:
                    # drain everything still queued so no waiter hangs
                    for b in self._buckets.values():
                        while b.items:
                            items = b.items[:self.max_batch]
                            b.items = b.items[self.max_batch:]
                            to_flush.append((b, items))
                    self._buckets.clear()
            for b, items in to_flush:
                t0 = time.monotonic()
                try:
                    self._flush(b, items)
                except Exception as e:  # noqa: BLE001 — fail the batch
                    for p in items:
                        if not p.future.done():
                            p.future.set_exception(e)
                dt = time.monotonic() - t0
                self.flush_seconds += dt
                self.seconds[b.op] += dt
            if stopping:
                return

    def _flush(self, b: _Bucket, items: list[_Pending]):
        dev = self.device
        n = len(items)
        words = _stack([p.words for p in items], dev)
        shard_nbytes = int(words.shape[-1]) * 4
        if b.op == "select_scan":
            outs = (scan_cuda.scan_codes(words.reshape(n, -1), *b.params),)
        elif b.op == "sse_xor":
            keys = np.stack([np.frombuffer(p.cipher_key, "<u4")
                             for p in items])
            outs = chacha_cuda.chacha20_xor(
                words_to_device(keys, dev),
                _stack([p.nonces for p in items], dev), words)
        elif b.op == "encode":
            outs = (b.codec.encode_words_batch(words),)
        elif b.op == "encode_hashed":
            outs = _fused.encode_hashed_fn_for(
                b.hash_key, shard_nbytes, b.codec.encode_words_batch,
                b.chunk_size, b.hash_algo)(words)
        elif b.op == "masked":
            outs = (rs_cuda.gf_matmul_batched(
                _stack([p.masks for p in items], dev), words),)
        elif b.op == "fused":
            outs = _fused.fused_fn_for(
                b.hash_key, shard_nbytes, rs_cuda.gf_matmul_batched,
                b.chunk_size, b.hash_algo, b.hash_out)(
                    _stack([p.masks for p in items], dev), words,
                    _stack([p.digests for p in items], dev))
        else:  # verify
            outs = (_fused.verify_fn_for(
                b.hash_key, shard_nbytes, b.chunk_size, b.hash_algo)(
                    words, _stack([p.digests for p in items], dev)),)
        host = [o.cpu().numpy() for o in outs]
        if b.op != "select_scan":   # words travel as int32 holding uint32
            host = [h.view(np.uint32) if h.dtype == np.int32 else h
                    for h in host]
        self.batches[b.op] += 1
        self.items[b.op] += n
        self.max_items = max(self.max_items, n)
        for i, p in enumerate(items):
            # sse_xor results are whole payloads: each item gets a copy, so
            # one slow consumer's slice does not pin the flush's batch
            res = tuple(h[i].copy() if b.op == "sse_xor" else h[i]
                        for h in host)
            p.future.set_result(res if len(res) > 1 else res[0])

    def stop(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30)

    def reset_stats(self) -> None:
        for op in OPS:
            self.batches[op] = 0
            self.items[op] = 0
            self.seconds[op] = 0.0
        self.max_items = 0
        self.flush_seconds = 0.0

    def stats(self) -> dict:
        batches = sum(self.batches.values())
        items = sum(self.items.values())
        return {"batches": batches, "items": items,
                "ops": {op: {"batches": self.batches[op],
                             "items": self.items[op]} for op in OPS},
                "seconds_by_op": dict(self.seconds),
                "max_items": self.max_items,
                "flush_seconds": self.flush_seconds,
                "avg_batch": items / batches if batches else 0.0}


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
