"""The one blocking point of the request paths on the dispatch queue's
futures — the port of runtime/completion.py.

The dispatch lanes never block on a readback (completers and the
interactive lane's poller do); the consumer side — a heal's rebuilt
shards, a GET's decoded block — does need the value on its own thread.
Each such wait goes through ``await_result``, counted and timed per op in
this module's counters (``stats()``, reset per measured phase) and in the
metrics store's ``minio_tpu_lane_await_total{op}`` and
``minio_tpu_lane_await_seconds_total{op}`` (cumulative, as the JAX
package exports them), so the time requests spend waiting on the card has
a standing answer.
"""
from __future__ import annotations

import threading
import time

from ..obs import metrics as _mx

_lock = threading.Lock()
_waits: dict[str, int] = {}
_seconds: dict[str, float] = {}


def await_result(fut, op: str = "", timeout: float | None = None):
    """Wait for ``fut`` and return its result (or raise its exception).
    ``op`` labels the wait ("rebuild", "decode", ...)."""
    t0 = time.monotonic()
    try:
        return fut.result(timeout)
    finally:
        dt = time.monotonic() - t0
        label = op or "other"
        with _lock:
            _waits[label] = _waits.get(label, 0) + 1
            _seconds[label] = _seconds.get(label, 0.0) + dt
        _mx.inc("minio_tpu_lane_await_total", op=label)
        _mx.inc("minio_tpu_lane_await_seconds_total", dt, op=label)


def stats() -> dict:
    """{op: {"waits": n, "seconds": s}} since the last reset."""
    with _lock:
        return {op: {"waits": n, "seconds": _seconds[op]}
                for op, n in _waits.items()}


def reset_stats() -> None:
    with _lock:
        _waits.clear()
        _seconds.clear()
