"""Per-bucket analytics, the port of minio_tpu/obs/bucketstats.py:
bounded-cardinality tenant stats (reference cmd/metrics-v2.go bucket
families ``minio_bucket_usage_*``, ``minio_bucket_requests_*``,
``minio_bucket_traffic_*``; cmd/bucket-stats.go per-bucket counters
behind the admin plane).

A registry tracks at most ``bucketstats.top_n`` buckets (first come by
traffic, idle slots evicted at the scanner's reconcile) and folds every
other bucket into one ``_overflow_`` row, so ten thousand buckets cannot
explode a scrape. ``fold_label()`` is the gate every request-derived
metric label goes through.

Charged from four directions:

* ``server/s3api.py`` per finished request: request counts per
  (api class, status class), bytes in and out, TTFB and wall latency
  through ``obs/latency.Window``;
* the object layer's PUT and delete: live usage deltas (objects,
  versions, bytes) between scanner cycles;
* the scanner: ``reconcile()`` each cycle snaps the live numbers back to
  the scanned usage, records the drift it zeroes, and appends a usage
  sample to the history behind ``projection()`` (per-bucket and cluster
  GiB/day over 1 h and 24 h), persisted through the config plane;
* ``obs/slo.py``: per-(bucket, class) minute rings of total, failed and
  slow outcomes, so a class breach names its top offending buckets
  (``top_offenders``).

Served as the ``minio_tpu_bucket_*`` metric group (obs/metrics.py),
``GET /minio/admin/v3/bucketstats`` and the dynamic ``bucketstats`` config
subsystem. The report, the metric lines and the persisted history are the
JAX package's for the same charges."""
from __future__ import annotations

import json
import threading
import time

from .latency import Window

#: the fold row every untracked bucket collapses into — reference bounds
#: its bucket families the same way (a constant sink label, not a new
#: series per tenant)
OVERFLOW = "_overflow_"

#: defaults for the dynamic ``bucketstats`` config subsystem
DEF_TOP_N = 32
DEF_FOLD_IDLE_CYCLES = 4
DEF_HISTORY_SAMPLES = 288

#: config-plane path the usage-snapshot history persists under (same
#: plane as scanner/usage.py's trees, so a restart keeps projecting)
HISTORY_PATH = "bucketstats/history.json"

#: growth-projection windows: (label, span seconds)
PROJ_WINDOWS = (("1h", 3600.0), ("24h", 86400.0))

#: request api-classes the per-bucket latency windows key on — a fixed
#: taxonomy, NOT the ~40 raw api names (cardinality bound is
#: top_n x len(API_CLASSES))
API_CLASSES = ("read", "write", "list", "delete", "other")

#: per-(bucket, slo-class) ring span: 60 one-minute slots covers both
#: SLO windows (5m exact, 1h exact) in 180 ints per class — a
#: Window(3600) pair here would cost ~300k ints per cell
RING_MINUTES = 60

_lock = threading.Lock()
_entries: dict[str, "_Entry"] = {}
_folds = 0          # label folds into OVERFLOW (admission refused)
_evictions = 0      # idle entries dropped at reconcile
_reconciles = 0
_last_drift: dict[str, int] = {}   # bucket -> signed byte drift zeroed
_cluster_bytes = 0                 # authoritative totals, last reconcile
_cluster_objects = 0
_history: list[dict] = []          # usage snapshots for projection()
_history_loaded = False


class _Entry:
    """One tracked bucket's counters. Plain ints mutate under the module
    lock (GIL-cheap); latency Windows carry their own locks."""

    __slots__ = ("name", "requests", "bytes_in", "bytes_out", "ttfb",
                 "wall", "rings", "d_objects", "d_versions", "d_bytes",
                 "base_objects", "base_versions", "base_bytes",
                 "idle_cycles", "touched")

    def __init__(self, name: str):
        self.name = name
        self.requests: dict[tuple[str, str], int] = {}
        self.bytes_in = 0
        self.bytes_out = 0
        self.ttfb: dict[str, Window] = {}
        self.wall: dict[str, Window] = {}
        #: slo class -> {"epoch": [minute], "total": [n], "err": [n],
        #: "slow": [n]} — RING_MINUTES slots each
        self.rings: dict[str, dict[str, list]] = {}
        self.d_objects = 0
        self.d_versions = 0
        self.d_bytes = 0
        self.base_objects = 0
        self.base_versions = 0
        self.base_bytes = 0
        self.idle_cycles = 0
        self.touched = False


# -- config ------------------------------------------------------------------


_apply_registered = False


def _register_apply() -> None:
    """Invalidate the shared config cache on a dynamic ``bucketstats``
    apply (same shape as obs/slo.py: the 5 s TTL is fine per-request but
    must not lag an operator's set-config-kv). Idempotent, best
    effort."""
    global _apply_registered
    if _apply_registered:
        return
    try:
        from ..config import get_config_sys

        def _invalidate(_cfg) -> None:
            from ..qos.budget import _cfg_cache
            for key in [k for k in list(_cfg_cache)
                        if k[0] == "bucketstats"]:
                _cfg_cache.pop(key, None)

        get_config_sys().on_apply("bucketstats", _invalidate)
        _apply_registered = True
    except Exception:  # noqa: BLE001 — config plane absent
        pass


def _cfg_float(key: str, env: str, default: float) -> float:
    from ..qos.budget import _config_float
    _register_apply()
    return _config_float("bucketstats", key, env, default)


def enabled() -> bool:
    return _cfg_float("enable", "MINIO_TPU_BUCKETSTATS", 1.0) != 0.0


def top_n() -> int:
    return max(1, int(_cfg_float(
        "top_n", "MINIO_TPU_BUCKETSTATS_TOP_N", DEF_TOP_N)))


def fold_idle_cycles() -> int:
    return max(1, int(_cfg_float(
        "fold_idle_cycles", "MINIO_TPU_BUCKETSTATS_FOLD_IDLE_CYCLES",
        DEF_FOLD_IDLE_CYCLES)))


def history_samples() -> int:
    return max(2, int(_cfg_float(
        "history_samples", "MINIO_TPU_BUCKETSTATS_HISTORY_SAMPLES",
        DEF_HISTORY_SAMPLES)))


# -- the fold gate -----------------------------------------------------------


def _entry_locked(bucket: str, admit: bool) -> _Entry:
    """Caller holds ``_lock``. The ONE admission point: a tracked bucket
    returns its entry; an unknown one is admitted while slots remain
    (first-come — traffic order IS the ranking between evictions), else
    folded into OVERFLOW and counted."""
    global _folds
    e = _entries.get(bucket)
    if e is not None:
        return e
    if bucket != OVERFLOW and admit and \
            len(_entries) - (OVERFLOW in _entries) < top_n():
        e = _Entry(bucket)
        _entries[bucket] = e
        return e
    _folds += 1
    ov = _entries.get(OVERFLOW)
    if ov is None:
        ov = _Entry(OVERFLOW)
        _entries[OVERFLOW] = ov
    return ov


def fold_label(bucket: str, admit: bool = True) -> str:
    """Bound a request-derived metric label: the tracked bucket name, or
    ``_overflow_`` once the registry is full. Every Prometheus label
    value derived from a request (bucket, key, user) flows through
    here."""
    if not bucket or not enabled():
        return OVERFLOW
    with _lock:
        return _entry_locked(bucket, admit).name


# -- charge paths ------------------------------------------------------------


def api_class(api: str) -> str:
    """Fixed api-class taxonomy for one s3api api name (the lowercase
    names ``_api_name`` produces: getobject, putobjectpart, ...)."""
    a = (api or "").lower()
    if a.startswith("list"):
        return "list"
    if a.startswith(("delete", "abortmultipart")):
        return "delete"
    if a.startswith(("put", "post", "copy", "completemultipart",
                     "newmultipart", "select", "restore")):
        return "write"
    if a.startswith(("get", "head")):
        return "read"
    return "other"


def record_request(bucket: str, api: str, status: int, duration_s: float,
                   ttfb_s: float = 0.0, bytes_in: int = 0,
                   bytes_out: int = 0, now: float | None = None) -> None:
    """Fold one finished S3 request into its bucket's counters +
    latency windows (called from the s3api serving loop's finally — must
    stay cheap and never raise)."""
    if not bucket or not enabled():
        return
    acls = api_class(api)
    ccls = f"{min(max(status // 100, 1), 5)}xx"
    with _lock:
        e = _entry_locked(bucket, True)
        key = (acls, ccls)
        e.requests[key] = e.requests.get(key, 0) + 1
        e.bytes_in += max(0, bytes_in)
        e.bytes_out += max(0, bytes_out)
        e.touched = True
        wall = e.wall.get(acls)
        if wall is None:
            wall = e.wall.setdefault(acls, Window())
        tt = e.ttfb.get(acls)
        if tt is None:
            tt = e.ttfb.setdefault(acls, Window())
    wall.observe(duration_s, bytes_out, now)
    if ttfb_s > 0:
        tt.observe(ttfb_s, 0, now)


def record_slo(bucket: str, cls: str, err: bool, slow: bool,
               now: float | None = None) -> None:
    """Charge one SLO outcome to its bucket's minute ring (called from
    obs/slo.record with err/slow already decided there — one judgement,
    two ledgers)."""
    if not bucket or not enabled():
        return
    minute = int(time.monotonic() if now is None else now) // 60
    slot = minute % RING_MINUTES
    with _lock:
        e = _entry_locked(bucket, True)
        r = e.rings.get(cls)
        if r is None:
            r = e.rings.setdefault(cls, {
                "epoch": [-1] * RING_MINUTES,
                "total": [0] * RING_MINUTES,
                "err": [0] * RING_MINUTES,
                "slow": [0] * RING_MINUTES})
        if r["epoch"][slot] != minute:
            r["epoch"][slot] = minute
            r["total"][slot] = 0
            r["err"][slot] = 0
            r["slow"][slot] = 0
        r["total"][slot] += 1
        if err:
            r["err"][slot] += 1
        elif slow:
            r["slow"][slot] += 1
        e.touched = True


def _ring_eval(r: dict[str, list], span_s: float,
               now: float | None) -> tuple[int, int, int]:
    """(total, err, slow) over the ring slots inside ``span_s``."""
    minute = int(time.monotonic() if now is None else now) // 60
    lo = minute - max(1, int(span_s // 60)) + 1
    total = err = slow = 0
    for i in range(RING_MINUTES):
        if lo <= r["epoch"][i] <= minute:
            total += r["total"][i]
            err += r["err"][i]
            slow += r["slow"][i]
    return total, err, slow


def on_put(bucket: str, nbytes: int, versions: int = 1,
           objects: int = 1) -> None:
    """Live usage delta for one stored object version (object-layer put
    / multipart-complete path). A delete-marker write is
    ``on_put(b, 0, versions=1, objects=0)``."""
    if not bucket or not enabled():
        return
    with _lock:
        e = _entry_locked(bucket, True)
        e.d_objects += objects
        e.d_versions += versions
        e.d_bytes += nbytes
        e.touched = True


def on_delete(bucket: str, nbytes: int = 0, versions: int = 1,
              objects: int = 1) -> None:
    """Live usage delta for one removed object version."""
    if not bucket or not enabled():
        return
    with _lock:
        e = _entry_locked(bucket, True)
        e.d_objects -= objects
        e.d_versions -= versions
        e.d_bytes -= nbytes
        e.touched = True


# -- scanner reconcile + projection history ----------------------------------


def reconcile(snapshot: dict, objlayer=None,
              now: float | None = None) -> dict[str, int]:
    """Snap live usage back to the scanner's authoritative snapshot:
    per tracked bucket, the signed byte drift ``(base + delta) -
    authoritative`` is recorded (the drift gauge) and zeroed — base
    becomes the tree's numbers, deltas reset. Entries idle for
    ``fold_idle_cycles`` scanner cycles are evicted so a quiet tenant's
    slot goes back to the pool. Appends one usage sample to the
    projection history (persisted best-effort through ``objlayer``).
    Returns the drift map."""
    global _reconciles, _last_drift, _evictions
    global _cluster_bytes, _cluster_objects
    auth = snapshot.get("buckets", {}) or {}
    idle_max = fold_idle_cycles()
    with _lock:
        drift: dict[str, int] = {}
        tracked = sum(v.get("size", 0) for k, v in auth.items()
                      if k in _entries)
        for name, e in list(_entries.items()):
            if name == OVERFLOW:
                # overflow's authoritative base = everything untracked
                ab = snapshot.get("size_total", 0) - tracked
                a = {"size": max(0, ab), "objects": 0, "versions": 0}
            else:
                a = auth.get(name) or {}
            d = (e.base_bytes + e.d_bytes) - a.get("size", 0)
            if d:
                drift[name] = d
            e.base_bytes = a.get("size", 0)
            e.base_objects = a.get("objects", 0)
            e.base_versions = a.get("versions", a.get("objects", 0))
            e.d_objects = e.d_versions = e.d_bytes = 0
            if e.touched:
                e.idle_cycles = 0
                e.touched = False
            elif name != OVERFLOW:
                e.idle_cycles += 1
                if e.idle_cycles >= idle_max:
                    del _entries[name]
                    _evictions += 1
        _last_drift = drift
        _reconciles += 1
        _cluster_bytes = snapshot.get("size_total", 0)
        _cluster_objects = snapshot.get("objects_total", 0)
        ts = snapshot.get("last_update") or time.time()
        _append_history_locked(ts, snapshot, objlayer)
    return drift


def _append_history_locked(ts: float, snapshot: dict, objlayer) -> None:
    """Caller holds ``_lock``: one {ts, total_bytes, buckets} sample
    onto the bounded history, loading any persisted history first so a
    restart keeps its 24h window."""
    global _history, _history_loaded
    if not _history_loaded and objlayer is not None:
        _history_loaded = True
        try:
            doc = json.loads(objlayer.get_config(HISTORY_PATH))
            if doc.get("v") == 1:
                _history = list(doc.get("samples", []))[
                    -history_samples():]
        except Exception:  # noqa: BLE001 — first boot / no history yet
            pass
    if _history and ts <= _history[-1]["ts"]:
        return  # duplicate / out-of-order cycle
    _history.append({
        "ts": float(ts),
        "total_bytes": snapshot.get("size_total", 0),
        "buckets": {b: st.get("size", 0) for b, st in
                    (snapshot.get("buckets", {}) or {}).items()
                    if b in _entries},
    })
    _history = _history[-history_samples():]
    if objlayer is not None:
        try:
            objlayer.put_config(HISTORY_PATH, json.dumps(
                {"v": 1, "samples": _history}).encode())
        except Exception:  # noqa: BLE001 — persistence is best-effort
            pass


def projection(now: float | None = None) -> dict:
    """Capacity growth from the persisted usage history: per window,
    cluster GiB/day plus per-tracked-bucket GiB/day computed from the
    oldest sample still inside the window vs the newest (two-point
    slope — the scanner cadence is far coarser than either window, so a
    fit buys nothing over the endpoints)."""
    gib = float(1 << 30)
    with _lock:
        samples = list(_history)
    out: dict = {}
    ts_now = samples[-1]["ts"] if samples else (
        time.time() if now is None else now)
    for label, span in PROJ_WINDOWS:
        inside = [s for s in samples if s["ts"] >= ts_now - span]
        win: dict = {"samples": len(inside), "span_s": 0.0,
                     "cluster_gib_per_day": 0.0, "buckets": {}}
        if len(inside) >= 2:
            first, last = inside[0], inside[-1]
            dt = last["ts"] - first["ts"]
            if dt > 0:
                win["span_s"] = round(dt, 3)
                rate = (last["total_bytes"] - first["total_bytes"]) / dt
                win["cluster_gib_per_day"] = round(
                    rate * 86400.0 / gib, 6)
                for b in last.get("buckets", {}):
                    if b not in first.get("buckets", {}):
                        continue
                    br = (last["buckets"][b] - first["buckets"][b]) / dt
                    win["buckets"][b] = round(br * 86400.0 / gib, 6)
        out[label] = win
    return out


# -- SLO attribution ---------------------------------------------------------


def top_offenders(cls: str, kind: str, span_s: float,
                  now: float | None = None, k: int = 3) -> list[dict]:
    """The buckets contributing most bad outcomes to one (class, slo
    kind) window: ``kind`` "availability" counts errors, "latency"
    counts slow-but-good. Share is of ALL bad outcomes recorded for the
    class in the window (tracked + overflow), so the listed shares are
    honest even when the offender folded."""
    rows = []
    total_bad = 0
    with _lock:
        cells = [(name, e.rings.get(cls)) for name, e in _entries.items()]
    for name, r in cells:
        if r is None:
            continue
        total, err, slow = _ring_eval(r, span_s, now)
        bad = err if kind == "availability" else slow
        total_bad += bad
        if bad > 0:
            rows.append({"bucket": name, "bad": bad, "requests": total})
    rows.sort(key=lambda x: (-x["bad"], x["bucket"]))
    for row in rows:
        row["share"] = round(row["bad"] / total_bad, 4) if total_bad \
            else 0.0
    return rows[:k]


# -- reads -------------------------------------------------------------------


def _usage_live(e: _Entry) -> dict:
    return {"objects": e.base_objects + e.d_objects,
            "versions": e.base_versions + e.d_versions,
            "bytes": e.base_bytes + e.d_bytes}


def report(now: float | None = None) -> dict:
    """The admin ``bucketstats`` document: registry state, per-bucket
    request/traffic/latency/usage/SLO-ring numbers, last-reconcile
    drift, and the growth projection."""
    qs = (0.5, 0.99)
    with _lock:
        entries = list(_entries.items())
        folds, evictions, reconciles = _folds, _evictions, _reconciles
        drift = dict(_last_drift)
    buckets: dict[str, dict] = {}
    for name, e in entries:
        req: dict[str, dict[str, int]] = {}
        with _lock:
            pairs = list(e.requests.items())
            bi, bo = e.bytes_in, e.bytes_out
            usage = _usage_live(e)
            rings = {c: {k: list(v) for k, v in r.items()}
                     for c, r in e.rings.items()}
            wall = dict(e.wall)
            ttfb = dict(e.ttfb)
        total = errors = 0
        for (acls, ccls), n in pairs:
            req.setdefault(acls, {})[ccls] = n
            total += n
            if ccls == "5xx":
                errors += n
        lat: dict[str, dict] = {}
        for acls, w in wall.items():
            st = w.stats(qs, now)
            row = {"count": st["count"],
                   "wall_p50_s": round(st["percentiles"][0.5], 6),
                   "wall_p99_s": round(st["percentiles"][0.99], 6)}
            tw = ttfb.get(acls)
            if tw is not None:
                ts = tw.stats(qs, now)
                row["ttfb_p50_s"] = round(ts["percentiles"][0.5], 6)
                row["ttfb_p99_s"] = round(ts["percentiles"][0.99], 6)
            lat[acls] = row
        slo_rows: dict[str, dict] = {}
        for cls, r in rings.items():
            t5, e5, s5 = _ring_eval(r, 300.0, now)
            t60, e60, s60 = _ring_eval(r, 3600.0, now)
            slo_rows[cls] = {
                "5m": {"requests": t5, "errors": e5, "slow": s5},
                "1h": {"requests": t60, "errors": e60, "slow": s60}}
        buckets[name] = {
            "requests_total": total,
            "errors_5xx": errors,
            "requests": req,
            "bytes_in": bi,
            "bytes_out": bo,
            "latency": lat,
            "usage": usage,
            "slo": slo_rows,
        }
    return {
        "enabled": enabled(),
        "top_n": top_n(),
        "tracked": sum(1 for n, _ in entries if n != OVERFLOW),
        "folds": folds,
        "evictions": evictions,
        "reconciles": reconciles,
        "drift_bytes": drift,
        "buckets": buckets,
        "projection": projection(now),
    }


def metric_lines(now: float | None = None) -> list[str]:
    """The ``minio_tpu_bucket_*`` exposition lines (cardinality ≤
    (top_n + 1 fold row) x the fixed api/class taxonomies). Label
    values are registry keys, already folded at admission."""
    from .metrics import _esc
    qs = (0.5, 0.99)
    with _lock:
        entries = list(_entries.items())
        folds, evictions = _folds, _evictions
        drift = dict(_last_drift)
        tracked = sum(1 for n, _ in entries if n != OVERFLOW)
    lines = [
        "# TYPE minio_tpu_bucket_stats_tracked gauge",
        f"minio_tpu_bucket_stats_tracked {tracked}",
        "# TYPE minio_tpu_bucket_stats_folds_total counter",
        f"minio_tpu_bucket_stats_folds_total {folds}",
        "# TYPE minio_tpu_bucket_stats_evictions_total counter",
        f"minio_tpu_bucket_stats_evictions_total {evictions}",
    ]
    if not entries:
        return lines
    lines += [
        "# TYPE minio_tpu_bucket_requests_total counter",
        "# TYPE minio_tpu_bucket_traffic_received_bytes_total counter",
        "# TYPE minio_tpu_bucket_traffic_sent_bytes_total counter",
        "# TYPE minio_tpu_bucket_requests_ttfb_seconds gauge",
        "# TYPE minio_tpu_bucket_requests_latency_seconds gauge",
        "# TYPE minio_tpu_bucket_usage_live_bytes gauge",
        "# TYPE minio_tpu_bucket_usage_live_objects gauge",
        "# TYPE minio_tpu_bucket_usage_live_versions gauge",
        "# TYPE minio_tpu_bucket_slo_bad_total gauge",
    ]
    for name, e in sorted(entries):
        b = _esc(name)
        with _lock:
            pairs = list(e.requests.items())
            bi, bo = e.bytes_in, e.bytes_out
            usage = _usage_live(e)
            rings = {c: {k: list(v) for k, v in r.items()}
                     for c, r in e.rings.items()}
            wall = dict(e.wall)
            ttfb = dict(e.ttfb)
        for (acls, ccls), n in sorted(pairs):
            lines.append(
                f'minio_tpu_bucket_requests_total{{bucket="{b}",'
                f'api_class="{acls}",code="{ccls}"}} {n}')
        lines.append(
            f'minio_tpu_bucket_traffic_received_bytes_total'
            f'{{bucket="{b}"}} {bi}')
        lines.append(
            f'minio_tpu_bucket_traffic_sent_bytes_total'
            f'{{bucket="{b}"}} {bo}')
        for acls, w in sorted(wall.items()):
            st = w.stats(qs, now)
            for q, ql in ((0.5, "0.5"), (0.99, "0.99")):
                lines.append(
                    f'minio_tpu_bucket_requests_latency_seconds'
                    f'{{bucket="{b}",api_class="{acls}",'
                    f'quantile="{ql}"}} '
                    f'{st["percentiles"][q]:.6f}')
        for acls, w in sorted(ttfb.items()):
            st = w.stats(qs, now)
            for q, ql in ((0.5, "0.5"), (0.99, "0.99")):
                lines.append(
                    f'minio_tpu_bucket_requests_ttfb_seconds'
                    f'{{bucket="{b}",api_class="{acls}",'
                    f'quantile="{ql}"}} '
                    f'{st["percentiles"][q]:.6f}')
        lines.append(
            f'minio_tpu_bucket_usage_live_bytes{{bucket="{b}"}} '
            f'{usage["bytes"]}')
        lines.append(
            f'minio_tpu_bucket_usage_live_objects{{bucket="{b}"}} '
            f'{usage["objects"]}')
        lines.append(
            f'minio_tpu_bucket_usage_live_versions{{bucket="{b}"}} '
            f'{usage["versions"]}')
        for cls, r in sorted(rings.items()):
            t5, e5, s5 = _ring_eval(r, 300.0, now)
            if e5:
                lines.append(
                    f'minio_tpu_bucket_slo_bad_total{{bucket="{b}",'
                    f'class="{cls}",kind="availability"}} {e5}')
            if s5:
                lines.append(
                    f'minio_tpu_bucket_slo_bad_total{{bucket="{b}",'
                    f'class="{cls}",kind="latency"}} {s5}')
    if drift:
        lines.append("# TYPE minio_tpu_bucket_usage_drift_bytes gauge")
        for name, d in sorted(drift.items()):
            lines.append(
                f'minio_tpu_bucket_usage_drift_bytes'
                f'{{bucket="{_esc(name)}"}} {d}')
    proj = projection(now)
    emitted_growth = False
    for label, win in sorted(proj.items()):
        if win["samples"] < 2:
            continue
        if not emitted_growth:
            lines += [
                "# TYPE minio_tpu_cluster_growth_gib_per_day gauge",
                "# TYPE minio_tpu_bucket_growth_gib_per_day gauge",
            ]
            emitted_growth = True
        lines.append(
            f'minio_tpu_cluster_growth_gib_per_day'
            f'{{window="{label}"}} {win["cluster_gib_per_day"]}')
        for bname, rate in sorted(win["buckets"].items()):
            lines.append(
                f'minio_tpu_bucket_growth_gib_per_day'
                f'{{bucket="{_esc(bname)}",window="{label}"}} {rate}')
    return lines


def reset() -> None:
    """Drop the whole registry (tests and measurement isolation)."""
    global _folds, _evictions, _reconciles, _last_drift
    global _cluster_bytes, _cluster_objects, _history, _history_loaded
    with _lock:
        _entries.clear()
        _folds = _evictions = _reconciles = 0
        _last_drift = {}
        _cluster_bytes = _cluster_objects = 0
        _history = []
        _history_loaded = False
