"""Standing gap-attribution, the port of minio_tpu/obs/attribution.py:
per-op pipeline stage breakdowns across ALL requests.

``obs/stages.py`` gives one request a ``StageTimes`` collector; this
module arms one for EVERY object operation and aggregates the results
into standing per-op reports:

* per-stage p50/p99 seconds over the last minute (the same
  ``obs/latency.Window`` class behind every other online percentile in
  this tree, so methods can never diverge),
* per-stage share of wall — cumulative stage seconds divided by the
  op's cumulative wall seconds (overlapped/pipelined stages each charge
  their own wall time, so shares can sum past 1.0; the RATIO is the
  attribution signal: where a PUT's wall goes beyond its kernels,
  answered continuously).

Ops tracked: ``put`` / ``get`` (the objectlayer wrappers) and ``heal``
(heal_object). Surfaced as ``?attribution=1`` on the metrics and admin
timeline endpoints (``minio_tpu_stage_*`` families). Enabled with the flight recorder (``timeline.enable``); one
contextvar set + a handful of monotonic reads per block when on.
"""
from __future__ import annotations

import contextlib
import threading
import time

from . import latency as _lat
from . import stages as _stages
from . import timeline as _tl

#: ops with standing breakdowns
OPS = ("put", "get", "heal")

_lock = threading.Lock()
#: cumulative seconds per (op, stage) + wall seconds / op count per op
_stage_seconds: dict[tuple[str, str], float] = {}
_wall_seconds: dict[str, float] = {}
_op_count: dict[str, int] = {}


def enabled() -> bool:
    """Attribution rides the flight recorder's enable switch — one
    subsystem (`timeline`) turns the whole observability tentpole on or
    off."""
    return _tl.enabled()


def record(op: str, st: _stages.StageTimes, wall_s: float) -> None:
    """Fold one finished operation's stage collector into the standing
    aggregates (cumulative shares + last-minute percentile windows)."""
    with _lock:
        _wall_seconds[op] = _wall_seconds.get(op, 0.0) + wall_s
        _op_count[op] = _op_count.get(op, 0) + 1
        for stage, secs in st.seconds.items():
            key = (op, stage)
            _stage_seconds[key] = _stage_seconds.get(key, 0.0) + secs
    # last-minute percentile windows live outside the lock (the Window
    # has its own); one observation per stage per op
    _lat.observe("stage", wall_s, op=op, stage="wall")
    for stage, secs in st.seconds.items():
        _lat.observe("stage", secs, op=op, stage=stage)


@contextlib.contextmanager
def observed(op: str):
    """Arm a per-request stage collector for the with-body and record
    the result. A collector already armed by an outer caller keeps receiving every charge via
    ``StageTimes`` chaining — arming here never starves it."""
    if not enabled():
        yield None
        return
    outer = _stages.active()
    st = _stages.StageTimes(parent=outer)
    t0 = time.monotonic()
    try:
        with _stages.collect(st):
            yield st
    finally:
        try:
            record(op, st, time.monotonic() - t0)
        except Exception:  # noqa: BLE001 — obs never fails the work
            pass


def report() -> dict:
    """The standing attribution report: per op, total wall seconds /
    count, and per stage {p50_s, p99_s (last minute), seconds_total,
    share_of_wall (cumulative)}."""
    with _lock:
        stage_secs = dict(_stage_seconds)
        walls = dict(_wall_seconds)
        counts = dict(_op_count)
    windows = {(lab.get("op", ""), lab.get("stage", "")): w
               for lab, w in _lat.snapshot("stage")}
    out: dict = {}
    for op in sorted(set(walls) | {o for o, _ in stage_secs}):
        wall = walls.get(op, 0.0)
        wall_w = windows.get((op, "wall"))
        wall_ps = wall_w.percentiles((0.5, 0.99)) if wall_w is not None \
            else {0.5: 0.0, 0.99: 0.0}
        stages: dict = {}
        for (o, stage), secs in sorted(stage_secs.items()):
            if o != op:
                continue
            w = windows.get((op, stage))
            ps = w.percentiles((0.5, 0.99)) if w is not None else \
                {0.5: 0.0, 0.99: 0.0}
            stages[stage] = {
                "p50_s": round(ps[0.5], 6),
                "p99_s": round(ps[0.99], 6),
                "seconds_total": round(secs, 6),
                "share_of_wall": round(secs / wall, 4) if wall else 0.0,
            }
        out[op] = {"count": counts.get(op, 0),
                   "wall_seconds_total": round(wall, 6),
                   "wall_p50_s": round(wall_ps[0.5], 6),
                   "wall_p99_s": round(wall_ps[0.99], 6),
                   "stages": stages}
    return out


def reset() -> None:
    """Clear the cumulative aggregates AND the last-minute percentile
    windows (tests, measurement isolation) — a suite's earlier traffic must
    not bleed into a fixture's percentiles through a still-warm
    window."""
    with _lock:
        _stage_seconds.clear()
        _wall_seconds.clear()
        _op_count.clear()
    for labels, _w in _lat.snapshot("stage"):
        _lat.reset_window("stage", **labels)
