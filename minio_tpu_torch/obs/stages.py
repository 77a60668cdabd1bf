"""Per-request pipeline stage accounting — where a PUT's wall time goes;
the port of minio_tpu/obs/stages.py.

A ``StageTimes`` collector rides a contextvar for the duration of one
object operation (armed by ``attribution.observed`` for every object
operation, and by tests); the data-plane hot paths charge seconds to named stages ONLY when
a collector is armed, so production requests pay one contextvar read per
block and nothing else. Pool workers receive the collector by closure
(contextvars don't follow executor submits), and ``add`` is a GIL-atomic
float accumulate, so concurrent shard writers can charge the same stage.

Stages used by the PUT path: ``body_read`` (socket/stream -> block
buffer), ``etag`` (the fused-ETag digest-stream fold), ``encode_hash``
(erasure encode + bitrot digests: the dispatch-queue wait and the
framing), ``shard_write`` (writer chain harvest). GET: ``shard_read``,
``decode`` (the queue wait of the verify/rebuild flush), ``write_out``.
Heal: ``shard_read``, ``rebuild``, ``shard_write``. Every item that rides
a dispatch flush also charges ``queue_wait`` (submit to flush start). Overlapped stages (the pipelined windows) charge their
own wall time, so the summed seconds can exceed the PUT's wall clock —
the ratio is the attribution signal, not a latency decomposition.
"""
from __future__ import annotations

import contextlib
import contextvars
import time

_current: contextvars.ContextVar = contextvars.ContextVar(
    "minio_tpu_stage_times", default=None)


class StageTimes:
    """Float seconds per stage name; adds are GIL-atomic enough for the
    data plane (worst case a lost update skews attribution, never
    correctness). ``parent`` chains collectors: the always-on
    attribution layer (obs/attribution.py) arms a per-request collector
    INSIDE whatever an outer caller armed, and every charge
    flows to both — arming never starves the outer one."""

    def __init__(self, parent: "StageTimes | None" = None):
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.parent = parent

    def add(self, stage: str, dt: float) -> None:
        self.seconds[stage] = self.seconds.get(stage, 0.0) + dt
        self.counts[stage] = self.counts.get(stage, 0) + 1
        if self.parent is not None:
            self.parent.add(stage, dt)

    def snapshot(self) -> dict[str, float]:
        return {k: round(v, 6) for k, v in sorted(self.seconds.items())}


def active() -> StageTimes | None:
    """The armed collector, or None (the common, zero-cost case)."""
    return _current.get()


@contextlib.contextmanager
def collect(st: StageTimes | None = None):
    """Arm ``st`` (or a fresh collector) for the with-body; yields it."""
    st = st or StageTimes()
    tok = _current.set(st)
    try:
        yield st
    finally:
        _current.reset(tok)


@contextlib.contextmanager
def timed(st: StageTimes | None, stage: str):
    """Charge the with-body's wall time to ``stage`` when a collector is
    armed; free when not."""
    if st is None:
        yield
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        st.add(stage, time.monotonic() - t0)
