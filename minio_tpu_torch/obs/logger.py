"""Structured logging and the audit plane, the port of
minio_tpu/obs/logger.py (reference cmd/logger/: console and HTTP webhook
targets, audit-webhook, logOnce dedup). The console path rides Python's
logging; webhook targets get JSON documents through a bounded background
sender, so a dead endpoint never blocks a request.

No silent drops: every place an entry can be lost increments an exported
counter: ``minio_tpu_log_pubsub_dropped_total`` for slow console-stream
subscribers, ``minio_tpu_log_target_dropped_total`` /
``minio_tpu_log_target_sent_total`` per webhook target (labelled
``target="log"|"audit"``). A failed send gets one bounded retry with a
jittered backoff before it counts as a drop.

Fed by the S3 request hook (one audit entry per request, joined to its
trace by ``request_id``) and by the object layer, storage, durability,
scanner, auto-heal and fault planes' warnings; read by the admin ``logs``
op (``?type=audit`` for the audit ring)."""
from __future__ import annotations

import json
import logging
import os
import queue
import random
import threading
import time
import urllib.request

_console = logging.getLogger("minio_tpu_torch")

#: one retry after a failed POST, backed off by this base ± jitter —
#: bounded so a dead endpoint still drains the queue at ~2 entries/s
#: worst case instead of stalling behind unbounded retries
RETRY_BACKOFF_S = 0.25


def _count(name: str, value: float = 1.0, **labels) -> None:
    """Exported drop/sent counters, shielded: the logging plane must
    keep working when the metrics store is unavailable (early boot,
    bare library use)."""
    try:
        from . import metrics as mx
        mx.inc(name, value, **labels)
    except Exception:  # noqa: BLE001 — counting must never break logging
        pass


class HTTPLogTarget:
    """POST one JSON document per entry to an endpoint (reference
    cmd/logger/target/http): bounded queue, background sender, drops on
    overflow (the reference drops too — logging must not backpressure).
    ``kind`` labels this target's sent/dropped counters (log|audit)."""

    def __init__(self, endpoint: str, auth_token: str = "",
                 maxsize: int = 4096, kind: str = "log"):
        self.endpoint = endpoint
        self.auth_token = auth_token
        self.kind = kind
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)
        self.dropped = 0
        self.sent = 0
        self.retries = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True,
                                   name="minio-tpu-log-sender")
        self._t.start()

    def enqueue(self, entry: dict) -> None:
        try:
            self.q.put_nowait(entry)
        except queue.Full:
            self.dropped += 1
            _count("minio_tpu_log_target_dropped_total",
                   target=self.kind, reason="queue_full")

    def _post(self, entry: dict) -> None:
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(entry).encode(),
            headers={"Content-Type": "application/json"},
            method="POST")
        if self.auth_token:
            req.add_header("Authorization",
                           f"Bearer {self.auth_token}")
        with urllib.request.urlopen(req, timeout=5):
            pass

    def _loop(self):
        while not self._stop.is_set():
            try:
                entry = self.q.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                self._post(entry)
                self.sent += 1
                _count("minio_tpu_log_target_sent_total",
                       target=self.kind)
                continue
            except Exception:  # noqa: BLE001 — retry once, then count
                self.retries += 1
            # one bounded retry with jittered backoff: a transient
            # connect error must not lose the entry, a dead endpoint
            # must not stall the queue behind endless retries
            self._stop.wait(RETRY_BACKOFF_S * (0.5 + random.random()))
            if self._stop.is_set():
                self.dropped += 1
                _count("minio_tpu_log_target_dropped_total",
                       target=self.kind, reason="send_failed")
                continue
            try:
                self._post(entry)
                self.sent += 1
                _count("minio_tpu_log_target_sent_total",
                       target=self.kind)
            except Exception:  # noqa: BLE001 — endpoint down: drop, count
                self.dropped += 1
                _count("minio_tpu_log_target_dropped_total",
                       target=self.kind, reason="send_failed")

    def stop(self):
        self._stop.set()
        self._t.join(timeout=2)


class LogSys:
    """Process log/audit fan-out. Targets from env:
    MINIO_TPU_LOGGER_WEBHOOK_ENDPOINT (error/info log entries),
    MINIO_TPU_AUDIT_WEBHOOK_ENDPOINT (one entry per API request). A ring
    of recent entries backs the admin logs endpoint (the reference's
    console-log history, cmd/consolelogger.go)."""

    def __init__(self):
        from collections import deque

        from .pubsub import PubSub
        self.log_target: HTTPLogTarget | None = None
        self.audit_target: HTTPLogTarget | None = None
        self.ring: deque = deque(maxlen=512)
        #: audit history rides its OWN ring: one entry per request would
        #: otherwise churn error/warning history out of the console ring
        #: within seconds under normal traffic
        self.audit_ring: deque = deque(maxlen=512)
        #: live subscribers (admin console streaming across peers —
        #: reference cmd/consolelogger.go:66-126 pubsub)
        self.pubsub = PubSub()
        self._once: set[str] = set()
        ep = os.environ.get("MINIO_TPU_LOGGER_WEBHOOK_ENDPOINT", "")
        if ep:
            self.log_target = HTTPLogTarget(
                ep, os.environ.get(
                    "MINIO_TPU_LOGGER_WEBHOOK_AUTH_TOKEN", ""),
                kind="log")
        ep = os.environ.get("MINIO_TPU_AUDIT_WEBHOOK_ENDPOINT", "")
        if ep:
            self.audit_target = HTTPLogTarget(
                ep, os.environ.get(
                    "MINIO_TPU_AUDIT_WEBHOOK_AUTH_TOKEN", ""),
                kind="audit")

    def event(self, level: str, subsystem: str, message: str, **fields):
        rec = {"level": level, "subsystem": subsystem, "message": message,
               "time": time.time(), **fields}
        self.ring.append(rec)
        dropped = self.pubsub.publish(rec)
        if dropped:
            _count("minio_tpu_log_pubsub_dropped_total", dropped,
                   stream="log")
        getattr(_console, level if level != "fatal" else "critical",
                _console.info)("%s: %s", subsystem, message)
        if self.log_target is not None:
            self.log_target.enqueue(rec)

    def log_once(self, key: str, level: str, subsystem: str, message: str):
        """Dedup noisy repeated errors (reference logger/logonce.go)."""
        if key in self._once:
            return
        self._once.add(key)
        if len(self._once) > 4096:
            self._once.clear()
        self.event(level, subsystem, message)

    def audit(self, entry: dict):
        """One entry per completed API request (reference audit-webhook;
        entry shape mirrors the trace record — trace_id/request_id,
        response status and duration included — plus identity). Entries
        mirror into the admin console plane like the reference does:
        the live pubsub (console streaming) plus a dedicated audit ring
        served by ``/minio/admin/v3/logs?type=audit``, so `mc admin
        logs`-style consumers see the audit stream without a webhook —
        without churning error history out of the log ring."""
        rec = {"version": "1", "deploymentid": "minio-tpu",
               "type": "audit", "time": time.time(), **entry}
        self.audit_ring.append(rec)
        dropped = self.pubsub.publish(rec)
        if dropped:
            _count("minio_tpu_log_pubsub_dropped_total", dropped,
                   stream="audit")
        if self.audit_target is not None:
            self.audit_target.enqueue(rec)

    def stop(self):
        for t in (self.log_target, self.audit_target):
            if t is not None:
                t.stop()


_sys: LogSys | None = None
_sys_lock = threading.Lock()


def log_sys() -> LogSys:
    global _sys
    if _sys is None:
        with _sys_lock:
            if _sys is None:
                _sys = LogSys()
    return _sys


def reset() -> None:
    """Stop the process LogSys's targets and drop it: the next
    ``log_sys()`` reads the webhook endpoints from the environment again
    (tests and measurement isolation)."""
    global _sys
    with _sys_lock:
        old, _sys = _sys, None
    if old is not None:
        old.stop()
