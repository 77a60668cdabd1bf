"""Device-plane observability, the port of minio_tpu/obs/device.py
rewritten for the CUDA card. Four pillars:

* **Live-buffer ledger.** Every flush is charged, per dispatch lane
  (``bulk``, ``interactive``), the bytes its inputs and outputs hold on
  the device, acquired at its launch and released when its readback
  lands or fails. After a drain every lane must be back to zero
  (``ledger_balanced()``): the leak gate. It works on every queue, the
  CPU queue included. ``note_host_buf`` mirrors the host buffer pools.
* **Builds and first launches** (in place of the JAX package's
  ``tracked_jit``). Every library ``ops/cuda_build.build`` compiles is a
  ``compile`` row per library (source and defines), timed, with a
  ``compile`` event on the flight recorder and a ``compile`` charge to
  the armed stage collector; more than ``storm_threshold`` builds inside
  ``storm_window_s`` count a storm, which kicks one burst capture of the
  profiler (``profiler.note_breach("compile_storm")``, cooldown-limited).
  A K2 build inside a PUT is the trap:
  a set on the card prepares its codecs at construction. The first
  launch of each (op, shape signature) of the dispatch queue is counted
  too, and every launch of it after.
* **Memory.** ``device_memory()`` reads ``torch.cuda.memory_stats()`` and
  ``mem_get_info()``. A metrics scrape never initialises CUDA: without
  ``touch`` it reads nothing unless ``torch.cuda.is_initialized()``.
* **Device time and roofline.** ``note_device_time`` takes the time
  between two CUDA events the dispatch queue records on the lane's stream
  around a flush's copies and launches, read with ``Event.elapsed_time``
  by the completer once the readback is ready — never a host wall, never
  a synchronize on the dispatcher. The interval is the stream's span of
  the flush: its copies to the card, its kernels and its copy back, and
  any wait of the stream for the host to enqueue the next of them within
  the flush. Those waits dominate (the dispatcher thread enqueues under
  the interpreter lock), so the interval is the flush's *stream
  occupancy*, not the card's work: an upper bound on the kernels' own
  time. The same intervals, placed on the card's clock (``DeviceClock``),
  give each lane's occupied seconds and their union across lanes, and
  ``status()`` reports them as ``stream_occupancy`` shares — never as the
  card's busy share, and unclamped, so an overcount shows. The per-op
  achieved GiB/s and roofline ratio divide a flush's bytes by the same
  intervals (a lower bound on the rate). ``roofline_gibs`` is the card's
  own memory bound, 3.35 TB/s for an ``NVIDIA H100 80GB HBM3`` (the data
  sheet's rate; ``chip_smoke.py``'s ``HBM_BYTES_S``); for any other card,
  and on the CPU, the ratio is null. The card's own busy time comes only
  from ``capture_trace``: one bounded ``torch.profiler`` session whose
  CUPTI records of kernels and copies give the card's busy and idle share
  over its window.

Served at ``GET /minio/admin/v3/device`` and as the
``minio_tpu_device_obs_*`` metric families. Switches (config subsystem
``device_obs``, env > stored > default): ``enable`` /
``MINIO_TPU_DEVICE_OBS`` (0 turns the plane off: no ledger, no event
pairs, no device time), ``storm_threshold`` /
``MINIO_TPU_DEVICE_OBS_STORM_THRESHOLD``, ``storm_window_s`` /
``MINIO_TPU_DEVICE_OBS_STORM_WINDOW_S``. The calibrated roofline keys of
the JAX package's table are not read: the port's ceiling is the card's
memory bound.

Importing this module touches no device: ``torch.cuda`` is read only when
a CUDA queue reports to it or an operator asks.
"""
from __future__ import annotations

import bisect
import collections
import os
import threading
import time

import torch

#: build-storm defaults
DEFAULT_STORM_THRESHOLD = 8.0
DEFAULT_STORM_WINDOW_S = 30.0
#: memory bandwidth of each card whose bound the port knows, bytes/s
#: (NVIDIA's data sheet, SXM part, full power limit)
CARD_HBM_BYTES_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
#: cap on distinct (op, signature) rows of the build and launch tables;
#: overflow folds into "<other>"
MAX_ROWS = 512
#: bound on the torch.profiler session an operator can request
MAX_TRACE_S = 30.0
#: the window of ``status()``'s stream occupancy shares, seconds
WINDOW_S = 60
#: how far back the union of the intervals is kept: an interval ending
#: earlier than this before the newest one is forgotten
UNION_HORIZON_S = 120.0

_GIB = float(1 << 30)
_LANES = ("bulk", "interactive")

_lock = threading.Lock()


_apply_registered = False


def _register_apply() -> None:
    """Drop the ``device_obs`` entries of the registry cache on every
    dynamic change, so a set-config-kv applies on the next read.
    Idempotent."""
    global _apply_registered
    if _apply_registered:
        return
    from ..config import get_config_sys

    def _invalidate(_cfg) -> None:
        from ..qos.budget import _cfg_cache
        for key in [k for k in list(_cfg_cache) if k[0] == "device_obs"]:
            _cfg_cache.pop(key, None)

    get_config_sys().on_apply("device_obs", _invalidate)
    _apply_registered = True


def _cfg(key: str, env: str, default: float) -> float:
    """device_obs.<key> through the config registry (env > stored >
    default)."""
    from ..qos.budget import _config_float
    _register_apply()
    return _config_float("device_obs", key, env, default)


def enabled() -> bool:
    return _cfg("enable", "MINIO_TPU_DEVICE_OBS", 1.0) != 0.0


def storm_threshold() -> int:
    return max(2, int(_cfg("storm_threshold",
                           "MINIO_TPU_DEVICE_OBS_STORM_THRESHOLD",
                           DEFAULT_STORM_THRESHOLD)))


def storm_window_s() -> float:
    return max(1.0, _cfg("storm_window_s",
                         "MINIO_TPU_DEVICE_OBS_STORM_WINDOW_S",
                         DEFAULT_STORM_WINDOW_S))


# -- the card ----------------------------------------------------------------

#: name of the card the CUDA queues run on (noted by the first CUDA queue;
#: empty on a host that has only CPU queues)
_card = ""


def note_card(name: str) -> None:
    """Called by a CUDA dispatch queue at construction with
    ``torch.cuda.get_device_name``."""
    global _card
    _card = name


def roofline_gibs(op: str = "") -> float | None:
    """The card's memory bound in GiB/s, the ceiling of every op (each
    flush's bytes are read or written once); None for a card whose bound
    the port does not know and on the CPU."""
    rate = CARD_HBM_BYTES_S.get(_card)
    return rate / _GIB if rate else None


# -- builds and first launches -----------------------------------------------

#: (op, signature) -> {"count": int, "seconds": float, "last_at": float}
_compiles: dict[tuple[str, str], dict] = {}
_compiles_total = 0
_compile_seconds_total = 0.0
_storm_times: collections.deque = collections.deque(maxlen=4096)
_storms_total = 0
_last_storm_mono = 0.0
#: (op, signature) -> launches of that shape
_launches: dict[tuple[str, str], int] = {}
_first_launches_total = 0
_launches_total = 0


def note_build(label: str, seconds: float) -> None:
    """Record one library build (``ops/cuda_build.build``): table row,
    totals, timeline ``compile`` event, ``compile`` stage charge, storm
    detector. ``label`` names the source and its defines
    (``gf_encode-4x16``)."""
    global _compiles_total, _compile_seconds_total, _storms_total, \
        _last_storm_mono
    now = time.monotonic()
    window = storm_window_s()
    threshold = storm_threshold()
    storm = False
    with _lock:
        _compiles_total += 1
        _compile_seconds_total += seconds
        key = (label, "build")
        if key not in _compiles and len(_compiles) >= MAX_ROWS:
            key = (label, "<other>")
        row = _compiles.setdefault(key, {"count": 0, "seconds": 0.0,
                                         "last_at": 0.0})
        row["count"] += 1
        row["seconds"] += seconds
        row["last_at"] = time.time()
        _storm_times.append(now)
        while _storm_times and now - _storm_times[0] > window:
            _storm_times.popleft()
        if len(_storm_times) >= threshold \
                and now - _last_storm_mono >= window:
            storm = True
            _storms_total += 1
            _last_storm_mono = now
    from . import timeline as _tl
    _tl.record("compile", op=label, sig="build", seconds=round(seconds, 6))
    from . import stages as _stages
    stc = _stages.active()
    if stc is not None:
        stc.add("compile", seconds)
    if storm:
        from . import profiler as _prof
        _prof.note_breach("compile_storm")
        from . import metrics as mx
        mx.inc("minio_tpu_device_obs_compile_storms_total")


def note_launch(op: str, sig: str) -> bool:
    """Count one dispatch flush of ``op`` at shape ``sig``; True on the
    first of that (op, signature)."""
    global _first_launches_total, _launches_total
    if not enabled():
        return False
    with _lock:
        key = (op, sig)
        if key not in _launches and len(_launches) >= MAX_ROWS:
            key = (op, "<other>")
        n = _launches.get(key, 0)
        _launches[key] = n + 1
        _launches_total += 1
        if n == 0:
            _first_launches_total += 1
        return n == 0


def compiles_total() -> int:
    with _lock:
        return _compiles_total


def compile_snapshot() -> dict:
    """The build plane: totals plus the per-library table, rows sorted by
    cumulative seconds descending, and the launch table per (op, shape
    signature)."""
    with _lock:
        rows = [{"op": op, "signature": sig, "count": r["count"],
                 "seconds": round(r["seconds"], 6),
                 "last_at": r["last_at"]}
                for (op, sig), r in _compiles.items()]
        launches = [{"op": op, "signature": sig, "launches": n}
                    for (op, sig), n in sorted(_launches.items())]
        total, secs, storms = (_compiles_total, _compile_seconds_total,
                               _storms_total)
        firsts, n_launches = _first_launches_total, _launches_total
    rows.sort(key=lambda r: -r["seconds"])
    return {"compiles_total": total,
            "compile_seconds_total": round(secs, 6),
            "storms_total": storms,
            "storm_threshold": storm_threshold(),
            "storm_window_s": storm_window_s(),
            "table": rows,
            "first_launches_total": firsts,
            "launches_total": n_launches,
            "launches": launches}


# -- live-buffer ledger ------------------------------------------------------


class _LaneLedger:
    """Per-lane live device-buffer accounting. ``bytes`` are the flush's
    inputs and outputs — a lower bound on what the allocator reserved, but
    it moves 1:1 with the tensors the dispatch queue holds, which is what
    the leak gate and the per-lane gauges need."""

    __slots__ = ("live_buffers", "live_bytes", "peak_bytes",
                 "peak_buffers", "acquired_total", "released_total")

    def __init__(self):
        self.live_buffers = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_buffers = 0
        self.acquired_total = 0
        self.released_total = 0

    def snapshot(self) -> dict:
        return {"live_buffers": self.live_buffers,
                "live_bytes": self.live_bytes,
                "peak_bytes": self.peak_bytes,
                "peak_buffers": self.peak_buffers,
                "acquired_total": self.acquired_total,
                "released_total": self.released_total}


_ledgers: dict[str, _LaneLedger] = {ln: _LaneLedger() for ln in _LANES}


class _LedgerToken:
    """Release handle for one ledger acquisition; release is idempotent."""

    __slots__ = ("lane", "nbytes", "released")

    def __init__(self, lane: str, nbytes: int):
        self.lane = lane
        self.nbytes = nbytes
        self.released = False


def ledger_acquire(lane: str, nbytes: int) -> _LedgerToken | None:
    """Charge ``nbytes`` of live device buffers to ``lane``; returns the
    token to ``ledger_release`` when the readback lands. None when the
    plane is off (callers pass None through unconditionally)."""
    if not enabled():
        return None
    led = _ledgers.get(lane) or _ledgers["bulk"]
    nbytes = int(nbytes)
    with _lock:
        led.live_buffers += 1
        led.live_bytes += nbytes
        led.acquired_total += 1
        led.peak_bytes = max(led.peak_bytes, led.live_bytes)
        led.peak_buffers = max(led.peak_buffers, led.live_buffers)
    return _LedgerToken(lane, nbytes)


def ledger_release(tok: _LedgerToken | None) -> None:
    if tok is None:
        return
    with _lock:
        if tok.released:
            return
        tok.released = True
        led = _ledgers.get(tok.lane) or _ledgers["bulk"]
        led.live_buffers -= 1
        led.live_bytes -= tok.nbytes
        led.released_total += 1


def ledger_snapshot() -> dict:
    with _lock:
        return {ln: led.snapshot() for ln, led in _ledgers.items()}


def ledger_balanced() -> bool:
    """The leak gate: after a drain every lane's live count and byte
    balance must be back to zero."""
    with _lock:
        return all(led.live_buffers == 0 and led.live_bytes == 0
                   for led in _ledgers.values())


_host_buf = {"acquired_total": 0, "released_total": 0, "live": 0,
             "live_bytes": 0, "peak_bytes": 0}


def note_host_buf(nbytes: int, acquired: bool) -> None:
    """Host buffer traffic from ``runtime/bufpool.py`` (the block pool and
    the pinned staging of the copies to the card)."""
    if not enabled():
        return
    with _lock:
        if acquired:
            _host_buf["acquired_total"] += 1
            _host_buf["live"] += 1
            _host_buf["live_bytes"] += nbytes
            _host_buf["peak_bytes"] = max(_host_buf["peak_bytes"],
                                          _host_buf["live_bytes"])
        else:
            _host_buf["released_total"] += 1
            _host_buf["live"] = max(0, _host_buf["live"] - 1)
            _host_buf["live_bytes"] = max(0,
                                          _host_buf["live_bytes"] - nbytes)


# -- device memory -----------------------------------------------------------


def device_memory(touch: bool = False) -> list[dict]:
    """Per-card rows from ``torch.cuda.memory_stats()`` (the caching
    allocator's current and peak bytes) and ``mem_get_info()`` (the card's
    free and total bytes). Without ``touch`` (metrics scrapes) this reads
    nothing unless CUDA is already initialised; the admin endpoint passes
    ``touch=True`` (an operator's explicit request may initialise it).
    Empty without CUDA."""
    if not torch.cuda.is_available():
        return []
    if not touch and not torch.cuda.is_initialized():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({"id": i, "name": torch.cuda.get_device_name(i),
                    "bytes_in_use": int(st.get(
                        "allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(st.get(
                        "allocated_bytes.all.peak", 0)),
                    "reserved_bytes": int(st.get(
                        "reserved_bytes.all.current", 0)),
                    "bytes_limit": int(total), "free_bytes": int(free)})
    return out


# -- the card's clock --------------------------------------------------------


class _Origin:
    __slots__ = ("event", "offset_s", "prev", "host_t")

    def __init__(self, event, prev: "_Origin | None", host_t: float):
        self.event = event
        self.prev = prev
        self.offset_s = 0.0 if prev is None else None
        self.host_t = host_t


class DeviceClock:
    """Places CUDA events of one card on one time axis, in seconds.

    ``Event.elapsed_time`` returns float milliseconds, whose resolution
    falls with the distance between the two events (a 20-minute span is
    0.1 ms apart). So positions are taken against an origin event that is
    re-recorded every ``ROTATE_S``, each origin's own offset measured once
    against the one before it and summed in float64. ``origin`` runs on a
    dispatcher thread when it records a flush (a new origin is one event
    record on the lane's stream); ``position`` runs on a completer once
    the flush's events have completed."""

    ROTATE_S = 30.0

    def __init__(self):
        self._lock = threading.Lock()
        self._cur: _Origin | None = None

    def origin(self, stream) -> _Origin:
        now = time.monotonic()
        with self._lock:
            cur = self._cur
            if cur is None or now - cur.host_t > self.ROTATE_S:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(stream)
                cur = self._cur = _Origin(ev, cur, now)
            return cur

    def _offset(self, o: _Origin) -> float:
        chain = []
        while True:
            prev = o.prev  # read before the check: cleared after it
            if o.offset_s is not None:
                break
            chain.append(o)
            o = prev
        for later in reversed(chain):
            prev = later.prev  # read before the check: cleared after it
            if later.offset_s is not None:
                continue
            # origins may sit on the other lane's stream: wait for both
            # (a completer, never a dispatcher, runs this; they were
            # recorded seconds ago)
            prev.event.synchronize()
            later.event.synchronize()
            later.offset_s = prev.offset_s + \
                prev.event.elapsed_time(later.event) / 1e3
            later.prev = None
        return chain[0].offset_s if chain else o.offset_s

    def position(self, o: _Origin, event) -> float:
        """Seconds of ``event`` (completed) on this card's axis."""
        return self._offset(o) + o.event.elapsed_time(event) / 1e3


_clocks: dict[str, DeviceClock] = {}


def clock(device) -> DeviceClock:
    """The clock of one card (shared by every queue on it)."""
    key = str(device)
    c = _clocks.get(key)
    if c is None:
        with _lock:
            c = _clocks.setdefault(key, DeviceClock())
    return c


# -- device time, stream occupancy and roofline -----------------------------


class _Intervals:
    """Covered seconds of a set of intervals on one card's clock: per lane
    (a lane's stream runs its flushes one after another, so its intervals
    never overlap) and their union across lanes, cumulative and in a
    last-minute window of per-second slots (placed backwards from the
    completion's host time)."""

    def __init__(self):
        self.lanes: dict[str, float] = {}
        self.union_s = 0.0
        self.merged: list[list[float]] = []   # disjoint, sorted [s, e]
        self.newest_end = 0.0
        self.slots: dict[str, list] = {}      # lane|"union" -> [secs, epoch]

    def _slot_add(self, name: str, secs: float, now: float) -> None:
        covered, epoch = self.slots.setdefault(
            name, ([0.0] * WINDOW_S, [-1] * WINDOW_S))
        remaining = min(secs, float(WINDOW_S))
        sec = int(now)
        while remaining > 0:
            i = sec % WINDOW_S
            if epoch[i] != sec:
                epoch[i] = sec
                covered[i] = 0.0
            frac = min(remaining, 1.0)
            covered[i] += frac
            remaining -= frac
            sec -= 1

    def add(self, lane: str, start: float, end: float, now: float) -> None:
        self.lanes[lane] = self.lanes.get(lane, 0.0) + (end - start)
        self._slot_add(lane, end - start, now)
        m = self.merged
        i = bisect.bisect_left(m, [start, start])
        if i > 0 and m[i - 1][1] >= start:
            i -= 1
        j = i
        covered = 0.0
        lo, hi = start, end
        while j < len(m) and m[j][0] <= end:
            covered += min(end, m[j][1]) - max(start, m[j][0])
            lo, hi = min(lo, m[j][0]), max(hi, m[j][1])
            j += 1
        m[i:j] = [[lo, hi]]
        added = (end - start) - covered
        self.union_s += added
        self._slot_add("union", added, now)
        self.newest_end = max(self.newest_end, end)
        cut = bisect.bisect_left(m, [self.newest_end - UNION_HORIZON_S, 0.0])
        if cut > 1:
            del m[:cut - 1]

    def share(self, name: str, now: float) -> float:
        covered, epoch = self.slots.get(name, ((), ()))
        sec = int(now)
        return sum(c for c, e in zip(covered, epoch)
                   if sec - WINDOW_S < e <= sec) / WINDOW_S


#: op -> {"seconds": float, "bytes": int, "flushes": int}
_device_time: dict[str, dict] = {}
#: device -> the flushes' CUDA-event intervals
_occupancy: dict[str, _Intervals] = {}


def note_device_time(op: str, seconds: float, nbytes: int, lane: str = "",
                     device: str = "", start_s: float | None = None,
                     end_s: float | None = None) -> None:
    """Charge one flush's device time (the CUDA-event interval around its
    copies and launches) and the bytes its inputs and outputs hold to
    ``op``; with ``start_s``/``end_s`` (the interval on the card's clock)
    also to the lane's stream occupancy and the union across lanes."""
    if not enabled() or seconds <= 0:
        return
    now = time.monotonic()
    with _lock:
        row = _device_time.setdefault(op, {"seconds": 0.0, "bytes": 0,
                                           "flushes": 0})
        row["seconds"] += seconds
        row["bytes"] += int(nbytes)
        row["flushes"] += 1
        if start_s is not None and end_s is not None:
            _occupancy.setdefault(device, _Intervals()).add(
                lane, start_s, end_s, now)


def occupancy_totals() -> dict:
    """Cumulative seconds the flushes' CUDA-event intervals cover, per
    card: {device: {"union_s": s, "lanes": {lane: s}}}. A caller takes two
    readings around a phase and divides the differences by its wall."""
    with _lock:
        return {dev: {"union_s": o.union_s, "lanes": dict(o.lanes)}
                for dev, o in _occupancy.items()}


def occupancy_share(before: dict, after: dict, wall_s: float) -> dict:
    """The streams' occupancy over a phase of ``wall_s`` seconds from two
    ``occupancy_totals`` readings: {"union": share, "lanes": {lane:
    share}} per card (the card's work plus the streams' waits for the
    host inside each flush; not the card's busy share). Null on a host
    without a timed (CUDA) queue."""
    out = {}
    for dev, a in after.items():
        b = before.get(dev, {"union_s": 0.0, "lanes": {}})
        out[dev] = {"union": (a["union_s"] - b["union_s"]) / wall_s,
                    "lanes": {ln: (s - b["lanes"].get(ln, 0.0)) / wall_s
                              for ln, s in sorted(a["lanes"].items())}}
    return out or {"": {"union": None, "lanes": {}}}


def occupancy_snapshot() -> dict:
    """Per card: the streams' union occupancy share over the last
    ``WINDOW_S`` seconds and each lane's, with the cumulative seconds.
    A host without a timed queue reports one row of nulls."""
    now = time.monotonic()
    with _lock:
        out = {}
        for dev, o in _occupancy.items():
            out[dev] = {"window_s": WINDOW_S,
                        "union_share": round(o.share("union", now), 6),
                        "union_seconds_total": round(o.union_s, 6),
                        "lanes": {ln: {"share": round(o.share(ln, now), 6),
                                       "seconds_total": round(s, 6)}
                                  for ln, s in sorted(o.lanes.items())}}
    return out or {"": {"window_s": WINDOW_S, "union_share": None,
                        "union_seconds_total": None, "lanes": {}}}


def roofline_snapshot() -> dict:
    """Per-op achieved GiB/s (bytes over the flushes' CUDA-event
    intervals, which hold the streams' waits for the host: a lower bound
    on the kernels' rate) and its ratio against the card's bound (null
    where the bound is unknown)."""
    with _lock:
        rows = {op: dict(r) for op, r in _device_time.items()}
    ceiling = roofline_gibs()
    out = {}
    for op, r in rows.items():
        secs = r["seconds"]
        achieved = r["bytes"] / _GIB / secs if secs > 0 else 0.0
        out[op] = {"basis": "flush_event_interval",
                   "device_seconds": round(secs, 6),
                   "bytes": r["bytes"],
                   "flushes": r["flushes"],
                   "achieved_gibs": round(achieved, 6),
                   "ceiling_gibs": ceiling,
                   "roofline_ratio": round(achieved / ceiling, 8)
                   if ceiling else None}
    return out


# -- on-demand torch.profiler sessions ---------------------------------------

_trace_running = False


def capture_trace(seconds: float = 1.0) -> dict:
    """One on-demand ``torch.profiler`` session over the card's activity
    (the host's ops without a card) (admin plane:
    ``GET /minio/admin/v3/device?trace=<seconds>``): the
    Chrome trace lands in a fresh temporary directory, whose path comes
    back with the device's own activity records over the session (every
    kernel and copy CUPTI saw): their seconds by name and the union of
    their intervals (``device_busy_s``), the card's busy time, and its
    busy and idle share of the window (null without a card), beside the streams' occupancy by
    the flushes that completed in the same window
    (``flush_stream_occupancy_s``). One session at a time; bounded
    duration."""
    global _trace_running
    if not enabled():
        return {"error": "device_obs disabled"}
    seconds = min(max(float(seconds), 0.05), MAX_TRACE_S)
    with _lock:
        if _trace_running:
            return {"error": "a trace session is already running"}
        _trace_running = True
    try:
        import tempfile

        from torch.profiler import ProfilerActivity, profile
        # on a card the device's activity only: recording every CPU-side
        # op of a busy server's threads costs the session a minute of
        # post-processing
        on_card = torch.cuda.is_available()
        acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
        logdir = tempfile.mkdtemp(prefix="minio-tpu-torch-devtrace-")
        t0 = time.monotonic()
        with profile(activities=acts) as prof:
            before = occupancy_totals()
            time.sleep(seconds)
            after = occupancy_totals()
        wall = time.monotonic() - t0
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        # the device's own activity records (kernels, copies): their time
        # by name and the union of their intervals
        by_name: dict[str, float] = {}
        spans = []
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            start, end = ev.time_range.start, ev.time_range.end
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (end - start)
            spans.append((start, end))
        busy = _Intervals()
        for start, end in sorted(spans):
            busy.add("all", start / 1e6, end / 1e6, 0.0)
        # the dispatch queues' own CUDA-event intervals over the same
        # window, for comparison
        occupied = sum(
            a["union_s"] - before.get(dev, {"union_s": 0.0})["union_s"]
            for dev, a in after.items())
        share = busy.union_s / seconds if on_card else None
        return {"logdir": logdir, "files": ["trace.json"],
                "seconds": round(wall, 3), "window_s": seconds,
                "device_events": len(spans),
                "device_busy_s": round(busy.union_s, 6),
                "device_busy_share": share,
                "device_idle_share": None if share is None else 1.0 - share,
                "flush_stream_occupancy_s": round(occupied, 6),
                "device_seconds_by_name": {
                    k: round(v / 1e6, 6) for k, v in sorted(
                        by_name.items(), key=lambda kv: -kv[1])}}
    finally:
        with _lock:
            _trace_running = False


# -- status / reset ----------------------------------------------------------


def status(touch_backend: bool = False) -> dict:
    """The whole device plane in one dict (admin endpoint, metrics)."""
    with _lock:
        host = dict(_host_buf)
    return {
        "enabled": enabled(),
        "card": _card,
        "ledger": ledger_snapshot(),
        "ledger_balanced": ledger_balanced(),
        "host_bufpool": host,
        "compile": compile_snapshot(),
        "roofline": roofline_snapshot(),
        "stream_occupancy": occupancy_snapshot(),
        "device_memory": device_memory(touch=touch_backend),
    }


def reset() -> None:
    """Test hook: forget every count (the card's name and clocks stay)."""
    global _compiles_total, _compile_seconds_total, _storms_total, \
        _last_storm_mono, _first_launches_total, _launches_total
    with _lock:
        _compiles.clear()
        _compiles_total = 0
        _compile_seconds_total = 0.0
        _storm_times.clear()
        _storms_total = 0
        _last_storm_mono = 0.0
        _launches.clear()
        _first_launches_total = 0
        _launches_total = 0
        for ln in _LANES:
            _ledgers[ln] = _LaneLedger()
        _device_time.clear()
        _occupancy.clear()
        for k in _host_buf:
            _host_buf[k] = 0
