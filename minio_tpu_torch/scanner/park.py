"""DebtQueue, the port of minio_tpu/scanner/park.py: the bounded-queue +
backoff-park + journal core of the async debt planes. It serves two
consumers, the MRF heal queue (``scanner/mrf.py``: objects a
degraded read or partial write flagged for rebuild) and the replication
queue (``bucket/replicate.py``: acked writes whose off-node copy has not
landed yet).


* **Bounded drop-oldest queue** — debt is best-effort bounded memory;
  overflow evicts the OLDEST entry (the scanner's sweep re-finds what
  was shed), never the entry a request just charged.
* **Exponential-backoff retry park** — a failed attempt parks with
  ``min(cap, base * 2^attempt)`` delay instead of being forgotten: the
  usual failure is a whole peer being down, and dropped debt would sit
  invisible until the next deep scanner cycle.
* **kick()** — a rejoining peer promotes every parked retry to runnable
  NOW (in the JAX package, ``dist.node.Node._on_peer_reconnect``).
* **Persisted journal** — the queued key set mirrors into a small JSON
  document committed via ``durable_write``, so debt recorded before a
  crash is re-enqueued on restart. All journal IO runs on the consumer's
  drain thread (throttled by ``FLUSH_INTERVAL_S``, forced on idle);
  producers never pay serialization + fsyncs. The accepted crash window
  is the marks since the last flush.

Queue entries are 4-tuples ``(bucket, object, version_id, mode)``;
retry promotions append a 5th element (the attempt count) — consumers
slice, not unpack. ``mode`` is plane-specific (MRF: scan_mode
normal/deep; replication: op put/delete) and the journal field name is
configurable so each plane's on-disk format stays self-describing."""
from __future__ import annotations

import json
import os
import queue
import threading
import time

#: min seconds between journal rewrites (an add storm must not turn
#: into a fsync storm); the consumer's drain loop flushes pending dirt
#: on idle passes
FLUSH_INTERVAL_S = 0.25


class DebtQueue:
    def __init__(self, max_queue: int = 10_000,
                 mode_field: str = "scan_mode",
                 sticky_modes: tuple = ("deep",),
                 dropped_metric: str = ""):
        self.q: queue.Queue = queue.Queue(maxsize=max_queue)
        self.dropped = 0
        #: the journal's field for an entry's mode
        self._mode_field = mode_field
        #: a mode in this tuple wins a journal dedupe collision (MRF:
        #: "deep" — bitrot evidence must not be downgraded by a later
        #: normal-mode charge; replication: "delete" — a delete
        #: obligation supersedes the put it follows)
        self._sticky = tuple(sticky_modes)
        self._dropped_metric = dropped_metric
        self._persist_path: str | None = None
        self._plock = threading.Lock()
        #: (bucket, object, version_id) -> mode, mirroring queued
        #: entries for the journal; bounded by the queue: dequeues AND
        #: drop-oldest evictions both forget their key
        self._persist_entries: dict[tuple, str] = {}
        self._pdirty = False
        self._last_flush = 0.0
        #: single-writer flush gate: two overlapping snapshots would
        #: race their durable_replace and a stale journal could land
        #: LAST with the dirty flag already cleared
        self._flushing = False
        #: failed attempts awaiting retry: [(due_monotonic, item, attempt)]
        self._retry: list[tuple[float, tuple, int]] = []
        self._retry_lock = threading.Lock()

    # -- enqueue --------------------------------------------------------------

    def add(self, bucket: str, object: str, version_id: str = "",
            mode: str = "normal") -> None:
        """Charge one debt entry. Overflow policy is drop-OLDEST,
        retried once: racing producers can refill the freed slot
        between get and put, and the single-try fallback used to drop
        the NEWEST entry — the one a request just flagged. Every lost
        entry counts in ``stats()['dropped']`` (and the configured
        dropped metric)."""
        item = (bucket, object, version_id, mode)
        landed = False
        dropped = 0
        evicted: list[tuple] = []
        for attempt in range(3):  # initial put + drop-oldest + one retry
            try:
                self.q.put_nowait(item)
                landed = True
                break
            except queue.Full:
                if attempt == 2:
                    break
                try:
                    evicted.append(self.q.get_nowait())
                    dropped += 1  # an older entry made room
                except queue.Empty:
                    pass
        if not landed:
            dropped += 1  # both retries lost the race: the NEW entry
        if dropped:
            self.dropped += dropped
            if self._dropped_metric:
                from ..obs import metrics as mx
                mx.inc(self._dropped_metric, dropped)
        if self._persist_path is not None:
            key = (bucket, object, version_id)
            if landed:
                with self._plock:
                    if mode in self._sticky or \
                            key not in self._persist_entries:
                        self._persist_entries[key] = mode
                    self._pdirty = True
            # drop-oldest evictions leave the journal too, or the
            # persisted set outgrows the queue forever and resurrects
            # debt the queue already shed — unless an identical-key
            # duplicate is still queued (the queue does not dedupe):
            # the journal mirrors the queue's KEY SET, and debt the
            # queue still holds must survive a crash. Slice, don't
            # unpack: retry promotions are 5-tuples (attempt count)
            for ev in evicted:
                b, o, v = ev[:3]
                if (b, o, v) != key and not self.queued((b, o, v)):
                    with self._plock:
                        self._persist_entries.pop((b, o, v), None)
                        self._pdirty = True
            # NO inline flush: add() runs on foreground threads and
            # must not pay JSON serialization + strict fsyncs — the
            # consumer's drain loop owns all journal IO; the marks stay
            # dirty until its next pass

    # -- persistence ----------------------------------------------------------

    def attach_persistence(self, path: str, load: bool = True) -> int:
        """Point the queue at its on-disk journal; an existing file's
        entries are re-enqueued (restart recovery). Returns the number
        of entries recovered.

        The journal mirror is pre-populated with EVERY loaded entry
        before the first replay add can flush — otherwise that first
        flush rewrites the on-disk journal as a 1-entry snapshot and a
        crash mid-replay loses the rest of the recovered debt. A torn
        journal (crash mid-rename left invalid JSON) loads as empty:
        the debt it held is re-found by the scanner sweep, never a
        startup crash."""
        self._persist_path = path
        if not load:
            return 0
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return 0
        loaded = []
        for e in doc.get("entries", []):
            try:
                loaded.append((e["bucket"], e["object"],
                               e.get("version_id", ""),
                               e.get(self._mode_field, "normal")))
            except (KeyError, TypeError):
                continue
        with self._plock:
            for b, o, v, m in loaded:
                if m in self._sticky or \
                        (b, o, v) not in self._persist_entries:
                    self._persist_entries[(b, o, v)] = m
        for b, o, v, m in loaded:
            self.add(b, o, v, mode=m)
        return len(loaded)

    def queued(self, key: tuple) -> bool:
        """Best-effort 'is this key still in the queue (or parked for
        retry)' (snapshot under the GIL; evictions and post-settle
        forgets are rare, the queue is bounded, so the O(n) scan is
        fine). Retry entries carry an attempt count as a 5th element —
        slice, don't unpack."""
        if any(tuple(e[:3]) == key for e in list(self.q.queue)):
            return True
        with self._retry_lock:
            return any(tuple(item[:3]) == key
                       for _due, item, _a in self._retry)

    def forget(self, key: tuple) -> None:
        """Drop one key from the journal mirror — the debt is paid (or
        moot: the object was deleted). A duplicate still queued keeps
        the journal entry."""
        if self._persist_path is None or self.queued(key):
            return
        with self._plock:
            self._persist_entries.pop(key, None)
            self._pdirty = True

    def flush(self, force: bool = False) -> None:
        """Throttled single-writer journal rewrite via durable_write:
        the snapshot is taken under the lock, the IO happens outside
        it, and only ONE flush is ever in flight — a second snapshot
        racing the first's rename could land a STALE journal last. A
        skipped flush leaves the dirty flag set; the consumer's idle
        pass settles it."""
        path = self._persist_path
        if path is None:
            return
        now = time.monotonic()
        with self._plock:
            if not self._pdirty or self._flushing:
                return
            if not force and now - self._last_flush < FLUSH_INTERVAL_S:
                return  # stays dirty; the drain loop flushes on idle
            self._flushing = True
            self._pdirty = False
            self._last_flush = now
            entries = [{"bucket": b, "object": o, "version_id": v,
                        self._mode_field: m}
                       for (b, o, v), m in self._persist_entries.items()]
        from ..storage.durability import durable_write
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            durable_write(path, json.dumps(
                {"entries": entries}).encode("utf-8"))
        except OSError:
            # best-effort, but RETRYABLE: leave the state dirty so the
            # drain loop's idle pass rewrites once the disk recovers —
            # otherwise this snapshot is silently gone from the journal
            with self._plock:
                self._pdirty = True
        finally:
            with self._plock:
                self._flushing = False

    # -- retry park -----------------------------------------------------------

    def kick(self) -> None:
        """Promote every backoff-parked retry to runnable NOW — called
        when a peer node rejoins (rpc on_reconnect): the debt its
        absence created should drain immediately, not wait out the
        exponential backoff."""
        with self._retry_lock:
            self._retry = [(0.0, item, attempt)
                           for _due, item, attempt in self._retry]

    def park(self, item: tuple, attempt: int, base_s: float,
             cap_s: float) -> None:
        """Park a failed item for retry with exponential backoff:
        ``min(cap_s, base_s * 2^min(attempt, 5))``."""
        delay = min(cap_s, base_s * (1 << min(attempt, 5)))
        with self._retry_lock:
            self._retry.append((time.monotonic() + delay, item, attempt))

    def _promote_due_retries(self, repark_s: float) -> None:
        now = time.monotonic()
        with self._retry_lock:
            due = [e for e in self._retry if e[0] <= now]
            if not due:
                return
            self._retry = [e for e in self._retry if e[0] > now]
        for _due, item, attempt in due:
            try:
                self.q.put_nowait((*item, attempt))
            except queue.Full:
                # queue refilled under load: park it again shortly
                with self._retry_lock:
                    self._retry.append((now + repark_s, item, attempt))

    # -- consumer side --------------------------------------------------------

    def pop(self, timeout: float = 0.5, repark_s: float = 1.0):
        """One drain-loop step: promote due retries, then dequeue. On
        an idle pass (queue empty) the throttled journal dirt is
        flushed and ``None`` is returned. The returned entry is a
        4-tuple, or a 5-tuple when it came through the retry park."""
        self._promote_due_retries(repark_s)
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            self.flush(force=True)  # idle: settle throttled dirt
            return None

    def settle(self, key: tuple) -> None:
        """Debt paid (or moot): forget the journal entry and flush on
        the consumer's thread, throttled by FLUSH_INTERVAL_S."""
        self.forget(key)
        self.flush()

    def stats(self) -> dict:
        with self._retry_lock:
            retry_pending = len(self._retry)
        return {"queued": self.q.qsize() + retry_pending,
                "retry_pending": retry_pending, "dropped": self.dropped}

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the queue AND the retry park are empty
        (tests / shutdown). Returns True when drained."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._retry_lock:
                parked = len(self._retry)
            if self.q.empty() and parked == 0:
                return True
            time.sleep(0.05)
        return False
