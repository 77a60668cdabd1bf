"""Recycled host buffers — the port of runtime/bufpool.py, plus the pinned
staging of the dispatch queue's host->device copies.

``BufferPool``: exact-size free lists of uint8 numpy arrays for the few
block-sized buffers the data plane allocates per erasure geometry; retained
bytes are bounded, and get() never blocks (a miss is a fresh allocation).

``StagingPool``: page-locked (``pin_memory``) tensors, reused per (role,
shape, dtype), into which a flush stacks its items' inputs before one
``non_blocking`` copy to the card. A buffer goes back to the pool with the
event recorded after its copy, and is handed out again only once that event
has completed, so a copy still in flight never reads a buffer that the next
flush is filling. The event is anything with ``query()`` (a
``torch.cuda.Event`` on the card; the tests pass a stand-in).

Both pools put every acquire and release of a pooled size on the flight
recorder (``buf_acquire``/``buf_release``, sampled) and into the device
plane's host-buffer high-water (``obs.device.note_host_buf``).
"""
from __future__ import annotations

import threading
from collections import defaultdict, deque

import numpy as np
import torch

from ..obs import device as _dev
from ..obs import timeline as _tl

#: Retained-bytes cap across all buckets (not a cap on live buffers).
MAX_RETAINED = 256 << 20
#: Allocations below this are cheap malloc traffic; pooling them only adds
#: lock crossings.
MIN_POOLED = 128 << 10


class BufferPool:
    def __init__(self, max_retained: int = MAX_RETAINED,
                 min_pooled: int = MIN_POOLED):
        self.max_retained = max_retained
        self.min_pooled = min_pooled
        self._lock = threading.Lock()
        self._free: dict[int, list[np.ndarray]] = defaultdict(list)
        self._retained = 0
        self.hits = 0
        self.misses = 0

    def get(self, nbytes: int) -> np.ndarray:
        """A uint8 array of exactly ``nbytes``; contents are undefined."""
        if nbytes >= self.min_pooled:
            with self._lock:
                lst = self._free.get(nbytes)
                if lst:
                    self._retained -= nbytes
                    self.hits += 1
                    arr = lst.pop()
                else:
                    self.misses += 1
                    arr = None
            # recorded outside the pool lock
            _tl.record("buf_acquire", bytes=nbytes, hit=arr is not None)
            _dev.note_host_buf(nbytes, acquired=True)
            if arr is not None:
                return arr
        return np.empty(nbytes, dtype=np.uint8)

    def put(self, arr: np.ndarray | None) -> None:
        """Return a buffer obtained from get(). The caller must not touch
        the array afterwards (views included). None is ignored."""
        if arr is None or arr.nbytes < self.min_pooled \
                or not arr.flags.owndata:
            return
        _tl.record("buf_release", bytes=arr.nbytes)
        _dev.note_host_buf(arr.nbytes, acquired=False)
        with self._lock:
            if self._retained + arr.nbytes > self.max_retained:
                return
            self._free[arr.nbytes].append(arr)
            self._retained += arr.nbytes

    def stats(self) -> dict:
        with self._lock:
            return {"retained": self._retained, "hits": self.hits,
                    "misses": self.misses,
                    "buckets": {k: len(v) for k, v in self._free.items()}}


_global: BufferPool | None = None
_global_lock = threading.Lock()


def global_pool() -> BufferPool:
    global _global
    if _global is None:
        with _global_lock:
            if _global is None:
                _global = BufferPool()
    return _global


#: staging buffers kept per (role, shape, dtype) key
STAGING_PER_KEY = 4
#: staging bytes kept across all keys (buffers past it are dropped when
#: released; torch's pinned allocator keeps a dropped buffer's block until
#: its copy has finished)
STAGING_MAX_RETAINED = 1 << 30


class StagingPool:
    """Pinned host tensors reused per key, each guarded by the event of the
    copy that last read it (see the module docstring)."""

    def __init__(self, pin: bool = True, per_key: int = STAGING_PER_KEY,
                 max_retained: int = STAGING_MAX_RETAINED):
        self.pin = pin
        self.per_key = per_key
        self.max_retained = max_retained
        self._lock = threading.Lock()
        self._free: dict[tuple, deque] = {}
        self._retained = 0
        self.hits = 0
        self.misses = 0
        #: handed-out misses taken because every pooled buffer of the key
        #: still had its copy in flight
        self.busy = 0

    def get(self, key, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """A host tensor of ``shape``/``dtype`` whose last copy (if any)
        has completed; contents are undefined."""
        k = (key, tuple(shape), dtype)
        buf = None
        with self._lock:
            q = self._free.get(k)
            if q:
                for _ in range(len(q)):
                    cand, ev = q[0]
                    if ev is None or ev.query():
                        q.popleft()
                        self._retained -= cand.nbytes
                        self.hits += 1
                        buf = cand
                        break
                    q.rotate(-1)
                else:
                    self.busy += 1
            if buf is None:
                self.misses += 1
        hit = buf is not None
        if not hit:
            buf = torch.empty(shape, dtype=dtype, pin_memory=self.pin)
        _tl.record("buf_acquire", bytes=buf.nbytes, hit=hit, pinned=self.pin)
        _dev.note_host_buf(buf.nbytes, acquired=True)
        return buf

    def release(self, key, buf: torch.Tensor, event) -> None:
        """Return ``buf`` (from get) once its copy was enqueued; ``event``
        completes when the copy has read it."""
        k = (key, tuple(buf.shape), buf.dtype)
        _tl.record("buf_release", bytes=buf.nbytes, pinned=self.pin)
        _dev.note_host_buf(buf.nbytes, acquired=False)
        with self._lock:
            q = self._free.setdefault(k, deque())
            if len(q) >= self.per_key or \
                    self._retained + buf.nbytes > self.max_retained:
                return
            q.append((buf, event))
            self._retained += buf.nbytes

    def stats(self) -> dict:
        with self._lock:
            return {"retained": self._retained, "hits": self.hits,
                    "misses": self.misses, "busy": self.busy}
