"""QoS subsystem, the port of minio_tpu/qos/: work classes and S3
admission control.

* ``qos.budget`` — per-class latency budgets (interactive 100 ms,
  background 5000 ms), the yardstick of the span plane's tail sampling.
* ``qos.admission`` — per-class token buckets + a bounded-wait
  concurrency gate behind the HTTP server that answer ``503 SlowDown``
  with ``Retry-After`` under overload instead of piling threads.

Work class rides a context variable: request handlers run as
``interactive`` (the default); healers tag themselves ``background``
(``with qos.background(): ...``), and dispatch items submitted inside
carry the class into the flush's timeline events and the per-class
latency window. The device stream rides another: the dispatch queue sends
``masked``/``fused`` to its interactive lane by default, and
``device_stream`` pins a block's submissions to one lane.

Left out: the JAX package's scheduler (``qos/scheduler.py``: spill to the
CPU, per-route queued-bytes caps) and ``budget.CostModel`` (the link
profile's route estimates). The port's queue never moves work off the
card by choice; reconciling that with the reference's spill is a slice of
its own.
"""
from __future__ import annotations

import contextlib
import contextvars

CLASS_INTERACTIVE = "interactive"
CLASS_BACKGROUND = "background"

_current: contextvars.ContextVar[str] = contextvars.ContextVar(
    "minio_tpu_qos_class", default=CLASS_INTERACTIVE)


def current_class() -> str:
    """The QoS class of the calling context (default: interactive)."""
    return _current.get()


@contextlib.contextmanager
def work_class(cls: str):
    """Run a block under a QoS class; dispatch items submitted inside
    inherit it."""
    tok = _current.set(cls)
    try:
        yield
    finally:
        _current.reset(tok)


def background():
    """Sugar for the healers: ``with qos.background(): ...``."""
    return work_class(CLASS_BACKGROUND)


#: device-lane disciplines: the bulk lane coalesces toward max-batch
#: flushes (PUT encode, Select scans, SSE); the interactive lane runs
#: small bounded batches on a dispatcher of its own (heal-shard rebuilds,
#: degraded-GET reconstruct). Which stream an op rides defaults by op in
#: runtime/dispatch (``_INTERACTIVE_LANE_OPS``); this context variable
#: overrides it.
STREAM_INTERACTIVE = "interactive"
STREAM_BULK = "bulk"

_stream: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "minio_tpu_qos_stream", default=None)


def current_stream() -> str | None:
    """The explicit device-stream override of the calling context, or
    None (= the dispatch queue picks by op)."""
    return _stream.get()


@contextlib.contextmanager
def device_stream(stream: str | None):
    """Run a block with dispatch submissions pinned to one device-lane
    discipline (STREAM_INTERACTIVE / STREAM_BULK); None restores the
    per-op default."""
    tok = _stream.set(stream)
    try:
        yield
    finally:
        _stream.reset(tok)


from .admission import AdmissionController, classify_request  # noqa: E402

__all__ = [
    "CLASS_INTERACTIVE", "CLASS_BACKGROUND",
    "current_class", "work_class", "background",
    "STREAM_INTERACTIVE", "STREAM_BULK", "current_stream",
    "device_stream", "AdmissionController", "classify_request",
    "qos_status",
]


def qos_status(server=None) -> dict:
    """One JSON-able snapshot of the QoS plane as far as it is ported:
    admission state from ``server`` (when given) and the per-class
    last-minute latency percentiles of dispatch items — the admin ``qos``
    op and tests read this."""
    from ..obs import latency as lat
    out: dict = {"classes": {}}
    adm = getattr(server, "qos_admission", None) if server is not None \
        else None
    if adm is not None:
        out["admission"] = adm.stats()
    for labels, w in lat.snapshot("qos"):
        st = w.stats((0.5, 0.99))
        out["classes"][labels.get("class", "")] = {
            "p50_ms": round(st["percentiles"][0.5] * 1e3, 3),
            "p99_ms": round(st["percentiles"][0.99] * 1e3, 3),
            "last_minute": st["count"],
        }
    return out
