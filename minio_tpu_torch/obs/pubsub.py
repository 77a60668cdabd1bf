"""Tiny in-process pub/sub, the port of minio_tpu/obs/pubsub.py (reference pkg/pubsub/pubsub.go:40-55): non-
blocking publish, per-subscriber bounded queues (slow subscribers drop,
the hot path never waits)."""
from __future__ import annotations

import queue
import threading


class PubSub:
    def __init__(self, maxsize: int = 1024):
        self._subs: list[queue.Queue] = []
        self._lock = threading.Lock()
        self.maxsize = maxsize
        #: lock-free mirror of len(_subs) so hot paths can gate trace
        #: generation on "is anyone listening" without taking the lock
        self.subscriber_count = 0

    def subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=self.maxsize)
        with self._lock:
            self._subs.append(q)
            self.subscriber_count = len(self._subs)
        return q

    def unsubscribe(self, q: queue.Queue):
        with self._lock:
            try:
                self._subs.remove(q)
            except ValueError:
                pass
            self.subscriber_count = len(self._subs)

    def publish(self, item) -> int:
        """Non-blocking fan-out; returns how many slow subscribers
        DROPPED the item (callers surface that as a counter instead of
        losing it silently)."""
        with self._lock:
            subs = list(self._subs)
        dropped = 0
        for q in subs:
            try:
                q.put_nowait(item)
            except queue.Full:
                dropped += 1  # slow subscriber: never block the hot path
        return dropped

    @property
    def num_subscribers(self) -> int:
        with self._lock:
            return len(self._subs)
