"""Crash-safe per-target event queue, the port of
minio_tpu/event/queuestore.py (reference
pkg/event/target/queuestore.go): one JSON file per pending event under the
target's directory; a sender thread drains oldest-first with exponential
backoff and deletes on confirmed delivery, so events written before a
restart are retried after it."""
from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid

log = logging.getLogger("minio_tpu_torch.event")

DEFAULT_LIMIT = 10000


class QueueStore:
    def __init__(self, directory: str, send, limit: int = DEFAULT_LIMIT,
                 retry_base_s: float = 0.5, retry_max_s: float = 30.0):
        """``send`` is a callable(record_dict) raising on failure."""
        self.dir = directory
        self.send = send
        self.limit = limit
        self.retry_base = retry_base_s
        self.retry_max = retry_max_s
        os.makedirs(directory, exist_ok=True)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.delivered = 0
        self.failed_puts = 0
        #: delivery attempts that raised (target down / wire error) —
        #: surfaced by the notification metrics group
        self.send_failures = 0
        # pending counter kept in memory so put() never scans the
        # directory on the request path (initialized from one listdir;
        # the sender decrements as it drains)
        self._count_lock = threading.Lock()
        try:
            self._count = sum(1 for n in os.listdir(directory)
                              if n.endswith(".event"))
        except OSError:
            self._count = 0

    # -- producer -------------------------------------------------------------

    def put(self, record: dict) -> bool:
        """Persist one event; False when the store is full (the reference
        errors the same way rather than buffering unboundedly). Commits
        through ``durable_replace`` so a queued event survives a crash
        under the configured fsync policy; a failed write unlinks its
        tmp file instead of leaking it into the store dir forever."""
        from ..storage.durability import durable_write
        with self._count_lock:
            if self._count >= self.limit:
                self.failed_puts += 1
                return False
            self._count += 1
        name = f"{time.time_ns():020d}-{uuid.uuid4().hex}.event"
        try:
            # durable_write commits under the fsync policy and unlinks
            # its tmp on failure — nothing strands in the store dir
            # (the tmp name never matches the sender's *.event filter)
            durable_write(os.path.join(self.dir, name),
                          json.dumps(record,
                                     separators=(",", ":")).encode())
        except OSError:
            with self._count_lock:
                self._count -= 1
                self.failed_puts += 1
            return False
        self._wake.set()
        return True

    def _dec(self):
        with self._count_lock:
            self._count = max(0, self._count - 1)

    # -- sender ---------------------------------------------------------------

    def start(self) -> "QueueStore":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="minio-tpu-event-sender")
        self._thread.start()
        return self

    def _pending(self) -> list[str]:
        try:
            return sorted(n for n in os.listdir(self.dir)
                          if n.endswith(".event"))
        except OSError:
            return []

    def _loop(self):
        delay = self.retry_base
        while not self._stop.is_set():
            names = self._pending()
            if not names:
                self._wake.wait(timeout=1.0)
                self._wake.clear()
                continue
            progressed = False
            for name in names:
                if self._stop.is_set():
                    return
                path = os.path.join(self.dir, name)
                try:
                    with open(path, encoding="utf-8") as f:
                        record = json.load(f)
                except (OSError, ValueError):
                    # raced with a competing sender or corrupt: drop it
                    if _try_unlink(path):
                        self._dec()
                    continue
                try:
                    self.send(record)
                except Exception as e:  # noqa: BLE001 — target down: retry
                    self.send_failures += 1
                    log.warning("event delivery failed (%s); retrying in "
                                "%.1fs", e, delay)
                    break
                if _try_unlink(path):
                    self._dec()
                self.delivered += 1
                progressed = True
            if progressed:
                delay = self.retry_base
                continue
            self._stop.wait(timeout=delay)
            delay = min(delay * 2, self.retry_max)

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def _try_unlink(path: str) -> bool:
    try:
        os.unlink(path)
        return True
    except OSError:
        return False
