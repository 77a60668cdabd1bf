"""Layered tracing, the port of minio_tpu/obs/trace.py (reference cmd/http-tracer.go:164 +
pkg/trace/trace.go:26-40, trace types http/storage/os): every traced
event publishes a TraceInfo to the global pubsub and into a ring buffer;
`mc admin trace` style consumers subscribe (live) or fetch the ring
(peers, one-shot).

Four layers publish here, distinguished by ``trace_type``:

* ``http``    — every S3/admin request (server/s3api.py _handle)
* ``storage`` — per-op disk calls: read/write/stat/rename with bytes and
                duration (storage/xlstorage.py)
* ``kernel``  — per-flush dispatch-queue launches: op, cpu/device route,
                batch size, queue wait (runtime/dispatch.py)
* ``scanner`` — MRF heals (scanner/mrf.py) and the object layer's
                shard heals

Non-http layers are hot paths, so (as in the reference, which only
generates storage/os traces when a matching subscriber exists) they
publish ONLY while somebody is listening — their latency numbers always
flow into obs/latency.py regardless. Drops are never silent:
ring evictions and slow-subscriber drops increment
``minio_tpu_trace_dropped_total``.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field

from .pubsub import PubSub

TRACE_HTTP = "http"
TRACE_STORAGE = "storage"
TRACE_KERNEL = "kernel"
TRACE_SCANNER = "scanner"
TRACE_TYPES = (TRACE_HTTP, TRACE_STORAGE, TRACE_KERNEL, TRACE_SCANNER)


@dataclass
class TraceInfo:
    node: str = ""
    func: str = ""              # api name, e.g. s3.PutObject
    method: str = ""
    path: str = ""
    query: str = ""
    status: int = 0
    time: float = field(default_factory=time.time)
    duration_s: float = 0.0
    ttfb_s: float = 0.0
    input_bytes: int = 0
    output_bytes: int = 0
    remote: str = ""
    error: str = ""
    trace_type: str = TRACE_HTTP
    #: request-scoped span identity (obs/spans.py): empty outside a
    #: traced request — flat trace consumers can join events to span
    #: trees (and to the x-amz-request-id the server stamped) by these
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""

    def to_dict(self) -> dict:
        return asdict(self)


def _ring_capacity() -> int:
    """Ring size from MINIO_TPU_TRACE_RING, clamped to [16, 65536]
    (reference defaultLogBufferCount-style bound)."""
    try:
        n = int(os.environ.get("MINIO_TPU_TRACE_RING", "256"))
    except ValueError:
        n = 256
    return max(16, min(n, 65536))


trace_pubsub = PubSub()
_ring: deque = deque(maxlen=_ring_capacity())
_ring_lock = threading.Lock()


def publish(info: TraceInfo) -> None:
    with _ring_lock:
        evicted = len(_ring) == _ring.maxlen
        _ring.append(info)
    dropped = trace_pubsub.publish(info)
    if evicted or dropped:
        from . import metrics as mx
        if evicted:
            mx.inc("minio_tpu_trace_dropped_total", reason="ring_evict")
        if dropped:
            mx.inc("minio_tpu_trace_dropped_total", float(dropped),
                   reason="slow_subscriber")


def subscribed() -> bool:
    """Cheap is-anyone-listening check gating the non-http layers."""
    return trace_pubsub.subscriber_count > 0


def _span_ids() -> tuple[str, str]:
    """(trace_id, span_id) of the calling context — joins the flat
    trace stream to the span plane without importing it on module
    load."""
    from . import spans
    ctx = spans.current()
    if ctx is None or not ctx.sampled:
        return "", ""
    return ctx.trace_id, ctx.span_id


def publish_storage(node: str, op: str, path: str, duration_s: float,
                    input_bytes: int = 0, output_bytes: int = 0,
                    error: str = "") -> None:
    if not subscribed():
        return
    tid, sid = _span_ids()
    publish(TraceInfo(trace_type=TRACE_STORAGE, node=node,
                      func=f"storage.{op}", path=path,
                      duration_s=duration_s, input_bytes=input_bytes,
                      output_bytes=output_bytes, error=error,
                      trace_id=tid, parent_span_id=sid))


def publish_kernel(op: str, route: str, batch: int, queue_wait_s: float,
                   duration_s: float, input_bytes: int = 0,
                   output_bytes: int = 0, error: str = "") -> None:
    """One dispatch-queue flush: method carries the cpu/device route,
    query the batch size, ttfb the queue wait."""
    if not subscribed():
        return
    publish(TraceInfo(trace_type=TRACE_KERNEL, func=f"kernel.{op}",
                      method=route, query=f"batch={batch}",
                      ttfb_s=queue_wait_s, duration_s=duration_s,
                      input_bytes=input_bytes, output_bytes=output_bytes,
                      error=error))


def publish_scanner(func: str, path: str, duration_s: float,
                    input_bytes: int = 0, error: str = "") -> None:
    if not subscribed():
        return
    tid, sid = _span_ids()
    publish(TraceInfo(trace_type=TRACE_SCANNER, func=func, path=path,
                      duration_s=duration_s, input_bytes=input_bytes,
                      error=error, trace_id=tid, parent_span_id=sid))


def recent(n: int = 256) -> list[TraceInfo]:
    with _ring_lock:
        items = list(_ring)
    return items[-n:]
