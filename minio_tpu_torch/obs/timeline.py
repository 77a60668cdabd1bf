"""Dispatch-plane flight recorder, the port of minio_tpu/obs/timeline.py:
an always-on, bounded, lock-light ring of typed events covering the life
of every dispatch item — enqueue, flush start/end, CPU-queue salvage,
completion, bufpool acquire/release, library builds — stamped with
monotonic time, the active trace_id and the dispatch LANE, so "how full
is each lane, how long do items wait, and which stage eats the wall
time" has a continuous answer.

Design constraints, in order:

* **Overhead first.** ``record()`` early-outs on one module-level bool
  when the recorder is off; when on, the hot path pays one tuple build
  and a two-statement critical section (slot store + counter bump) on a
  dedicated lock nothing else contends. High-frequency event types
  (``enqueue``/``complete``/``buf_acquire``/``buf_release``) additionally
  honor a sampling stride; structural events (flush/salvage/compile) are
  always recorded — a timeline with holes in its flushes is not a
  timeline.
* **Bounded.** The ring holds ``MINIO_TPU_TIMELINE_RING`` events;
  overflow overwrites the oldest and counts
  ``minio_tpu_timeline_dropped_total``.
* **Lanes.** Every flush event names the dispatch lane it ran on — the
  port's two, ``bulk`` and ``interactive``, each a dispatcher thread with
  its own CUDA stream. The same events feed per-lane utilization
  accounting: the dispatcher's busy-ratio integration over a last-minute
  window (flush start to readback landed, on the host clock),
  batch-occupancy (fill vs capacity) distributions, and sampled dispatch
  queue depth. The card's own busy time per lane (CUDA events) is
  ``obs/device.py``'s.
* **Exportable.** ``export_chrome()`` renders the ring as Chrome-trace/
  Perfetto JSON (one pid per lane, paired flush start/end as complete
  events, everything else as instants) behind
  ``GET /minio/admin/v3/timeline?fmt=chrome``.

Switches (config subsystem ``timeline``, env > stored > default):
``enable`` / ``MINIO_TPU_TIMELINE`` (0 turns the recorder and stage
attribution off), ``ring`` / ``MINIO_TPU_TIMELINE_RING`` (ring size),
``sample`` / ``MINIO_TPU_TIMELINE_SAMPLE`` (fraction of high-frequency
events kept). ``configure()`` rereads them; a set-config-kv of the
subsystem calls it.
"""
from __future__ import annotations

import os
import threading
import time

#: event taxonomy — structural events bypass sampling, high-frequency
#: ones honor it (``plan`` and ``spill`` belong to the QoS scheduler,
#: not ported: the port's queue never moves work off the card by choice)
STRUCTURAL = frozenset({"plan", "spill", "flush_start", "flush_end",
                        "salvage", "compile"})
SAMPLED = frozenset({"enqueue", "complete", "buf_acquire", "buf_release"})
EVENT_TYPES = tuple(sorted(STRUCTURAL | SAMPLED))

DEFAULT_RING = 8192
#: busy-ratio integration window (matches obs/latency.py's last minute)
WINDOW_S = 60

_lock = threading.Lock()
_ring: list = [None] * DEFAULT_RING
_ring_size = DEFAULT_RING
_n = 0                       # events ever recorded (ring index = _n % size)
_seq = 0                     # flush id sequence
_sample_ctr = 0              # stride counter for SAMPLED event types

_enabled = True
_stride = 1                  # record every Nth SAMPLED event
_cfg_loaded = False


# --------------------------------------------------------------------------
# config


def _cfg(key: str, env: str) -> str:
    """timeline.<key>: the environment, else the registry's stored value or
    default."""
    v = os.environ.get(env)
    if v is not None:
        return v
    from ..config import get_config_sys
    return get_config_sys().get_stored_or_default("timeline", key)


def configure() -> None:
    """(Re)read the ``timeline`` config subsystem: enable flag, ring size,
    sampling stride. Called lazily on first record and by the registry on
    every dynamic ``timeline`` change; tests and measurements call it
    again after changing the environment."""
    global _enabled, _stride, _ring, _ring_size, _n, _cfg_loaded
    enable = _cfg("enable", "MINIO_TPU_TIMELINE")
    try:
        ring = max(64, int(_cfg("ring", "MINIO_TPU_TIMELINE_RING")))
    except ValueError:
        ring = DEFAULT_RING
    try:
        sample = float(_cfg("sample", "MINIO_TPU_TIMELINE_SAMPLE"))
    except ValueError:
        sample = 1.0
    with _lock:
        if ring != _ring_size:
            _ring = [None] * ring
            _ring_size = ring
            _n = 0
        if sample <= 0:
            _stride = 0      # drop EVERY sampled-type event (structural
        elif sample < 1:     # events still record)
            _stride = max(1, round(1.0 / sample))
        else:
            _stride = 1
        _enabled = enable != "0"
        _cfg_loaded = True
    _register_apply()


_apply_registered = False


def _register_apply() -> None:
    """Re-run configure() on every dynamic ``timeline`` change
    (idempotent)."""
    global _apply_registered
    if _apply_registered:
        return
    from ..config import get_config_sys
    get_config_sys().on_apply("timeline", lambda _cfg_sys: configure())
    _apply_registered = True


def enabled() -> bool:
    if not _cfg_loaded:
        configure()
    return _enabled


# --------------------------------------------------------------------------
# lane utilization accounting


class _LaneStats:
    """Per-lane accounting derived from flush events: busy-seconds
    integration over a last-minute ring (per-second slots, recycled in
    place like obs/latency.Window), lifetime flush/item/byte totals, and
    a batch-occupancy (fill vs capacity) running distribution."""

    __slots__ = ("busy", "epoch", "flushes", "items", "bytes",
                 "busy_total", "fill_sum", "fill_n", "fill_hist", "_lk")

    #: occupancy histogram upper bounds (fraction of max_batch)
    FILL_EDGES = (0.25, 0.5, 0.75, 1.0)

    def __init__(self):
        self.busy = [0.0] * WINDOW_S
        self.epoch = [-1] * WINDOW_S
        self.flushes = 0
        self.items = 0
        self.bytes = 0
        self.busy_total = 0.0
        self.fill_sum = 0.0
        self.fill_n = 0
        self.fill_hist = [0] * (len(self.FILL_EDGES) + 1)
        # per-lane lock (same rule as obs/latency.Window): a bulk lane's
        # flush_end events fire on concurrent completer threads — an
        # unlocked epoch check-then-reset would let one thread wipe
        # another's just-integrated busy second
        self._lk = threading.Lock()

    def note_flush(self, dur_s: float, batch: int, capacity: int,
                   nbytes: int, now: float) -> None:
        with self._lk:
            self.flushes += 1
            self.items += batch
            self.bytes += nbytes
            self.busy_total += dur_s
            fill = batch / capacity if capacity else 0.0
            self.fill_sum += fill
            self.fill_n += 1
            for i, edge in enumerate(self.FILL_EDGES):
                if fill <= edge:
                    self.fill_hist[i] += 1
                    break
            else:
                self.fill_hist[-1] += 1
            # integrate busy seconds backwards from `now` across the
            # per-second slots the flush actually spanned — clamped to
            # the window: a dur past WINDOW_S would wrap the 60-slot
            # ring and zero the very slots it just filled (a saturated
            # lane reading near-idle)
            remaining = min(dur_s, float(WINDOW_S))
            sec = int(now)
            while remaining > 0:
                slot = sec % WINDOW_S
                if self.epoch[slot] != sec:
                    self.epoch[slot] = sec
                    self.busy[slot] = 0.0
                frac = min(remaining, 1.0)
                self.busy[slot] += frac
                remaining -= frac
                sec -= 1

    def busy_ratio(self, now: float) -> float:
        sec = int(now)
        lo = sec - WINDOW_S + 1
        with self._lk:
            total = sum(self.busy[s] for s in range(WINDOW_S)
                        if lo <= self.epoch[s] <= sec)
        return min(1.0, total / WINDOW_S)

    def snapshot(self, now: float) -> dict:
        ratio = self.busy_ratio(now)
        with self._lk:
            return {
                "busy_ratio": round(ratio, 4),
                "flushes": self.flushes,
                "items": self.items,
                "bytes": self.bytes,
                "busy_seconds_total": round(self.busy_total, 6),
                "batch_fill_avg": round(self.fill_sum / self.fill_n, 4)
                if self.fill_n else 0.0,
                "batch_fill_hist": {
                    (f"le_{edge}" if i < len(self.FILL_EDGES)
                     else "gt_1.0"): self.fill_hist[i]
                    for i, edge in enumerate(
                        list(self.FILL_EDGES) + [None])},
            }


_lanes: dict[str, _LaneStats] = {}
_lanes_lock = threading.Lock()

# sampled dispatch queue depth: pow2-bucketed distribution + last value
_DEPTH_EDGES = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
_depth_hist = [0] * (len(_DEPTH_EDGES) + 1)
_depth_last = 0
_depth_n = 0


def _lane(name: str) -> _LaneStats:
    st = _lanes.get(name)
    if st is None:
        with _lanes_lock:
            st = _lanes.setdefault(name, _LaneStats())
    return st


def note_queue_depth(depth: int) -> None:
    """Sample the dispatch queue depth (called by the dispatch loop at
    flush-collection time — not per event, so the cost is per flush)."""
    global _depth_last, _depth_n
    if not enabled():
        return
    for i, edge in enumerate(_DEPTH_EDGES):
        if depth <= edge:
            _depth_hist[i] += 1
            break
    else:
        _depth_hist[-1] += 1
    _depth_last = depth
    _depth_n += 1


def queue_depth_percentile(q: float) -> int:
    """Percentile of the sampled queue-depth distribution (upper bucket
    bound; 0 when nothing sampled)."""
    n = sum(_depth_hist)
    if not n:
        return 0
    rank = q * n
    cum = 0
    for i, c in enumerate(_depth_hist):
        cum += c
        if cum >= rank:
            return _DEPTH_EDGES[i] if i < len(_DEPTH_EDGES) \
                else _DEPTH_EDGES[-1] * 2
    return _DEPTH_EDGES[-1] * 2


def utilization() -> dict:
    """Per-lane utilization snapshot + queue-depth distribution — what
    the ``minio_tpu_device_*`` metric group and the admin timeline
    endpoint read."""
    now = time.monotonic()
    with _lanes_lock:
        lanes = dict(_lanes)
    return {
        "lanes": {name: st.snapshot(now)
                  for name, st in sorted(lanes.items())},
        "queue_depth": {
            "last": _depth_last,
            "samples": _depth_n,
            "p50": queue_depth_percentile(0.5),
            "p99": queue_depth_percentile(0.99),
        },
    }


# --------------------------------------------------------------------------
# the ring


def next_flush_id() -> int:
    """Monotone flush sequence pairing flush_start/flush_end events."""
    global _seq
    with _lock:
        _seq += 1
        return _seq


def record(etype: str, op: str = "", lane=("",), trace_id: str = "",
           **attrs) -> None:
    """Record one event. ``lane`` is a tuple of lane names or a single
    string. Cheap no-op when the recorder is disabled; SAMPLED event types
    honor the ``MINIO_TPU_TIMELINE_SAMPLE`` stride."""
    global _n, _sample_ctr
    if not _cfg_loaded:
        configure()
    if not _enabled:
        return
    if _stride != 1 and etype in SAMPLED:
        if _stride == 0:     # sample<=0: shed the whole sampled class
            return
        _sample_ctr += 1     # GIL-atomic enough: a lost bump skews the
        if _sample_ctr % _stride:  # stride, never correctness
            return
    if isinstance(lane, str):
        lane = (lane,)
    ev = (time.monotonic(), etype, op, lane, trace_id,
          attrs or None)
    with _lock:
        _ring[_n % _ring_size] = ev
        _n += 1
    if etype == "flush_end":
        # lane accounting rides the same event stream so the utilization
        # numbers and the exported timeline can never disagree
        dur = float(attrs.get("dur", 0.0))
        batch = int(attrs.get("batch", 0))
        cap = int(attrs.get("capacity", 0))
        nbytes = int(attrs.get("bytes", 0))
        now = ev[0]
        for ln in lane:
            if ln:
                _lane(ln).note_flush(dur, batch, cap, nbytes, now)


def events_total() -> int:
    return _n


def dropped_total() -> int:
    """Events overwritten by ring overflow (oldest dropped first)."""
    return max(0, _n - _ring_size)


def snapshot(since: float = 0.0, limit: int = 0) -> list[dict]:
    """Chronological event dicts still in the ring, optionally filtered
    to ``ts > since`` (monotonic seconds) and truncated to the newest
    ``limit``."""
    with _lock:
        size, n = _ring_size, _n
        if n <= size:
            raw = [e for e in _ring[:n]]
        else:
            cut = n % size
            raw = _ring[cut:] + _ring[:cut]
    out = []
    for ev in raw:
        if ev is None or ev[0] <= since:
            continue
        ts, etype, op, lane, tid, attrs = ev
        d = {"ts": ts, "type": etype}
        if op:
            d["op"] = op
        if lane and lane[0]:
            d["lanes"] = list(lane)
        if tid:
            d["trace_id"] = tid
        if attrs:
            d.update(attrs)
        out.append(d)
    if limit and len(out) > limit:
        out = out[-limit:]
    return out


def reset() -> None:
    """Clear the ring + lane accounting (tests, bench isolation)."""
    global _n, _seq, _sample_ctr, _depth_last, _depth_n
    with _lock:
        for i in range(_ring_size):
            _ring[i] = None
        _n = 0
        _seq = 0
        _sample_ctr = 0
    with _lanes_lock:
        _lanes.clear()
    for i in range(len(_depth_hist)):
        _depth_hist[i] = 0
    _depth_last = 0
    _depth_n = 0


# --------------------------------------------------------------------------
# Chrome-trace / Perfetto export


def export_chrome(since: float = 0.0, limit: int = 0) -> dict:
    """The ring as a Chrome-trace JSON object (load in Perfetto /
    chrome://tracing): one pid per lane (named via process_name
    metadata), flush_start/flush_end pairs merged into "X" complete
    events, every other event an "i" instant. ts/dur are microseconds
    on the process monotonic clock."""
    evs = snapshot(since, limit)
    lanes: list[str] = []
    for d in evs:
        for ln in d.get("lanes", ()) or ("queue",):
            if ln not in lanes:
                lanes.append(ln)
    if "queue" not in lanes:
        lanes.append("queue")
    pid_of = {ln: i + 1 for i, ln in enumerate(sorted(lanes))}
    out = [{"ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": f"lane:{ln}"}}
           for ln, pid in sorted(pid_of.items())]
    # pair flushes by flush_id (start may have been overwritten: the
    # orphan end renders as an instant, truthfully)
    starts: dict[int, dict] = {}
    for d in evs:
        fid = d.get("flush_id")
        if d["type"] == "flush_start" and fid is not None:
            starts[fid] = d
            continue
        if d["type"] == "flush_end" and fid is not None and fid in starts:
            s = starts.pop(fid)
            for ln in d.get("lanes", ("queue",)):
                out.append({
                    "ph": "X", "name": f"flush.{d.get('op', '')}",
                    "pid": pid_of.get(ln, 0), "tid": 1,
                    "ts": round(s["ts"] * 1e6, 1),
                    "dur": round((d["ts"] - s["ts"]) * 1e6, 1),
                    "args": {k: v for k, v in d.items()
                             if k not in ("ts", "type", "lanes")}})
            continue
        for ln in d.get("lanes", ("queue",)):
            out.append({
                "ph": "i", "s": "t",
                "name": f"{d['type']}.{d.get('op', '')}".rstrip("."),
                "pid": pid_of.get(ln, pid_of["queue"]), "tid": 1,
                "ts": round(d["ts"] * 1e6, 1),
                "args": {k: v for k, v in d.items()
                         if k not in ("ts", "type", "lanes")}})
    # unmatched starts (end still in flight) render as instants too
    for s in starts.values():
        for ln in s.get("lanes", ("queue",)):
            out.append({
                "ph": "i", "s": "t",
                "name": f"flush_start.{s.get('op', '')}",
                "pid": pid_of.get(ln, 0), "tid": 1,
                "ts": round(s["ts"] * 1e6, 1),
                "args": {k: v for k, v in s.items()
                         if k not in ("ts", "type", "lanes")}})
    out.sort(key=lambda e: e.get("ts", 0))
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"clock": "monotonic",
                          "dropped": dropped_total()}}


def status() -> dict:
    """Recorder state for the admin endpoint."""
    if not _cfg_loaded:
        configure()
    return {"enabled": _enabled, "ring": _ring_size,
            "sample_stride": _stride, "events_total": _n,
            "dropped_total": dropped_total()}
