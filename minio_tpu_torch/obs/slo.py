"""SLO plane, the port of minio_tpu/obs/slo.py — standing per-QoS-class
objectives with multi-window error-budget burn rates (the Google SRE
workbook's multiwindow, multi-burn-rate alerting shape, evaluated
in-process).

* Each QoS class (``interactive`` / ``control`` request classes,
  ``background`` dispatch work) carries an **availability objective**
  (fraction of requests that must not fail server-side) and a **latency
  objective** (fraction of good requests that must finish under the
  class threshold, seeded from the ``qos.budget`` latency budgets).
* Outcomes are recorded into paired fast/slow sliding windows (5 m /
  1 h) built from ``obs/latency.Window`` — the same percentile machinery
  behind every other online latency metric of the port.
* Reads compute per-window compliance ratios and **burn rates** —
  observed bad-fraction divided by the objective's error budget; a burn
  rate of 1.0 spends the budget exactly at the sustainable pace, 14.4
  exhausts a 30-day budget in ~2 days (the SRE workbook's page
  threshold). A class is in **breach** when BOTH windows burn above
  ``slo.burn_alert`` — the fast window confirms "now", the slow window
  confirms "not a blip" — and a breach kicks one burst capture of the
  profiler (``profiler.note_breach``).
* The worst latency breach keeps its trace_id, linking the verdict
  straight into the slow-trace store (``trace?trace_id=``).

Objectives resolve env > stored > default through the dynamic ``slo``
config subsystem; latency thresholds left empty are seeded from
``qos.interactive_budget_ms`` / ``qos.background_budget_ms``.

Fed by the request plane (``server/s3api.py``, every admitted request,
each S3 one also charged to its bucket's minute ring in
``obs/bucketstats``, so a class breach names its top offending buckets in
``top_buckets``) and by the dispatch queue (background items, failed ones
included); the async planes register their objectives as probes
(``register_async_probe``: the replication lag of
``S3Server.enable_cross_replication``), relayed under ``async``. Surfaced
as the ``minio_tpu_slo_*`` metric family, the admin ``slo`` op and inside
``GET /minio/admin/v3/health``.
"""
from __future__ import annotations

import threading
import time

from . import bucketstats
from .latency import Window

#: objective classes
CLASSES = ("interactive", "control", "background")

#: fast/slow evaluation window pair: (label, span seconds). 5 m is the
#: "is it happening now" window, 1 h the "is it sustained" window.
WINDOWS = (("5m", 300), ("1h", 3600))
FAST, SLOW = "5m", "1h"

#: default objectives per class; latency thresholds default to "" =
#: seeded from the qos.budget class budgets at evaluation time
_DEF_AVAILABILITY = {"interactive": 99.9, "control": 99.9,
                     "background": 99.0}
_DEF_LATENCY_TARGET = {"interactive": 99.0, "control": 99.0,
                       "background": 95.0}
#: qos.budget key each class seeds its latency threshold from
_BUDGET_CLASS = {"interactive": "interactive", "control": "interactive",
                 "background": "background"}

#: breach verdicts require at least this many outcomes in the FAST
#: window — a single 5xx on an otherwise idle class must not page
#: (standard multiwindow practice pairs burn thresholds with a
#: minimum-traffic floor)
BREACH_MIN_REQUESTS = 10

#: the 1h evaluation is cached this long on live (now=None) reads: a
#: filled Window(3600) merge walks 3600 slots under the window lock
#: (~tens of ms), and every scrape / health snapshot / peer fan-out
#: re-running it for 3 classes would stall concurrent record() callers
_SLOW_EVAL_TTL_S = 3.0

_lock = threading.Lock()
#: (class, window label) -> {"total": Window, "err": Window,
#: "slow": Window}: total observes every outcome's duration, err only
#: server-side failures, slow only good-but-over-threshold outcomes
#: (each keeps its own worst sample + trace_id)
_windows: dict[tuple[str, str], dict[str, Window]] = {}
#: cls -> (monotonic expiry, cached 1h evaluation) — reads/writes under
#: _lock; _gen fences a report() that computed its evaluation from
#: pre-reset windows out of repopulating the cache after reset()
_slow_cache: dict[str, tuple[float, dict]] = {}
_gen = 0


_apply_registered = False


def _register_apply() -> None:
    """Hook dynamic ``slo`` config changes: the shared qos.budget
    config cache holds stored-registry lookups for ~5 s, which is fine
    for per-request reads but would make an operator's set-config-kv
    invisibly lag — invalidate the subsystem's entries on every apply.
    Idempotent."""
    global _apply_registered
    if _apply_registered:
        return
    from ..config import get_config_sys

    def _invalidate(_cfg) -> None:
        from ..qos.budget import _cfg_cache
        for key in [k for k in list(_cfg_cache) if k[0] == "slo"]:
            _cfg_cache.pop(key, None)

    get_config_sys().on_apply("slo", _invalidate)
    _apply_registered = True


def _cfg_float(key: str, env: str, default: float) -> float:
    from ..qos.budget import _config_float
    _register_apply()
    return _config_float("slo", key, env, default)


def enabled() -> bool:
    return _cfg_float("enable", "MINIO_TPU_SLO", 1.0) != 0.0


def objective(cls: str) -> dict:
    """Effective objective for one class: availability target fraction,
    latency threshold seconds (seeded from qos.budget when unset) and
    latency target fraction."""
    from ..qos.budget import budget_s
    avail = _cfg_float(f"{cls}_availability",
                       f"MINIO_TPU_SLO_{cls.upper()}_AVAILABILITY",
                       _DEF_AVAILABILITY.get(cls, 99.0)) / 100.0
    lat_ms = _cfg_float(f"{cls}_latency_ms",
                        f"MINIO_TPU_SLO_{cls.upper()}_LATENCY_MS", 0.0)
    if lat_ms > 0:
        threshold_s = lat_ms / 1e3
        source = "slo"
    else:
        threshold_s = budget_s(_BUDGET_CLASS.get(cls, cls))
        source = "qos.budget"
    lat_target = _cfg_float(
        f"{cls}_latency_target",
        f"MINIO_TPU_SLO_{cls.upper()}_LATENCY_TARGET",
        _DEF_LATENCY_TARGET.get(cls, 99.0)) / 100.0
    return {
        "availability": avail,
        "latency_threshold_s": threshold_s,
        "latency_threshold_source": source,
        "latency_target": lat_target,
    }


def burn_alert() -> float:
    """Burn-rate factor above which (in BOTH windows) a class is in
    breach — 14.4 is the SRE workbook's page threshold (budget gone in
    ~2 days at that pace)."""
    return _cfg_float("burn_alert", "MINIO_TPU_SLO_BURN_ALERT", 14.4)


def _cell(cls: str, win: str, span: int) -> dict[str, Window]:
    key = (cls, win)
    cell = _windows.get(key)
    if cell is None:
        with _lock:
            cell = _windows.setdefault(key, {
                "total": Window(span), "err": Window(span),
                "slow": Window(span)})
    return cell


def record(cls: str, duration_s: float, status: int = 200,
           error: bool = False, trace_id: str = "",
           now: float | None = None, bucket: str = "") -> None:
    """Fold one finished request/work item into the class's SLO windows.
    Server-side failures (5xx, including admission 503 SlowDown, or
    ``error=True``) burn availability budget; good outcomes over the
    class latency threshold burn latency budget. 4xx are the client's
    fault and count as good. A non-empty ``bucket`` also charges the
    outcome to that bucket's ring (obs/bucketstats): one judgement feeds
    both ledgers, so the class verdict and its attribution agree."""
    if cls not in CLASSES or not enabled():
        return
    err = error or status >= 500
    slow = not err and \
        duration_s > objective(cls)["latency_threshold_s"]
    for win, span in WINDOWS:
        cell = _cell(cls, win, span)
        cell["total"].observe(duration_s, 0, now, trace_id)
        if err:
            cell["err"].observe(duration_s, 0, now, trace_id)
        elif slow:
            cell["slow"].observe(duration_s, 0, now, trace_id)
    if bucket:
        bucketstats.record_slo(bucket, cls, err, slow, now)
    from . import metrics as mx
    outcome = "error" if err else ("slow" if slow else "ok")
    mx.inc("minio_tpu_slo_requests_total", outcome=outcome,
           **{"class": cls})


def _window_eval(cls: str, obj: dict, win: str, span: int,
                 now: float | None) -> dict:
    cell = _cell(cls, win, span)
    st = cell["total"].stats((0.5, 0.99), now)
    total = st["count"]
    errs = cell["err"].count(now)
    slow_w = cell["slow"]
    slow = slow_w.count(now)
    good = max(0, total - errs)
    avail = 1.0 - (errs / total) if total else 1.0
    lat_ok = 1.0 - (slow / good) if good else 1.0
    avail_budget = max(1e-9, 1.0 - obj["availability"])
    lat_budget = max(1e-9, 1.0 - obj["latency_target"])
    worst_slow_s, worst_slow_tid = slow_w.worst(now)
    return {
        "requests": total,
        "errors": errs,
        "slow": slow,
        "availability": round(avail, 6),
        "latency_ok_ratio": round(lat_ok, 6),
        "availability_burn": round((1.0 - avail) / avail_budget, 4),
        "latency_burn": round((1.0 - lat_ok) / lat_budget, 4),
        "p50_s": round(st["percentiles"][0.5], 6),
        "p99_s": round(st["percentiles"][0.99], 6),
        "worst_slow_s": round(worst_slow_s, 6),
        "worst_slow_trace_id": worst_slow_tid,
    }


#: async-plane objectives (replication lag): name -> a zero-argument probe
#: returning a verdict dict with at least {"ok": bool}. The percentile
#: math stays inside the owning plane (``ReplicationSys.lag_report``);
#: this module only relays the verdict
_async_probes: dict = {}


def register_async_probe(name: str, fn) -> None:
    """Attach an async-plane objective to the SLO report (the latest
    registration wins: a restarted subsystem registers again)."""
    _async_probes[name] = fn


def unregister_async_probe(name: str) -> None:
    _async_probes.pop(name, None)


def report(now: float | None = None) -> dict:
    """The standing SLO verdict: per class, the effective objective,
    both windows' compliance + burn rates, the breach verdicts (both
    windows burning above ``slo.burn_alert``) and the worst latency
    breach's trace link (``stored`` says whether ``trace?trace_id=``
    will serve its span tree)."""
    from . import profiler
    from . import spans as _sp
    alert = burn_alert()
    out: dict = {"enabled": enabled(), "burn_alert": alert,
                 "classes": {}}
    for cls in CLASSES:
        obj = objective(cls)
        wins: dict = {}
        for win, span in WINDOWS:
            if win == SLOW and now is None:
                with _lock:
                    gen0 = _gen
                    hit = _slow_cache.get(cls)
                if hit is not None and time.monotonic() < hit[0]:
                    wins[win] = hit[1]
                    continue
                ev = _window_eval(cls, obj, win, span, None)
                with _lock:
                    if _gen == gen0:  # no reset raced the evaluation
                        _slow_cache[cls] = (
                            time.monotonic() + _SLOW_EVAL_TTL_S, ev)
                wins[win] = ev
            else:
                wins[win] = _window_eval(cls, obj, win, span, now)
        # breach = burning in BOTH windows AND enough traffic in the
        # fast window that the burn is a trend, not one sample
        floored = wins[FAST]["requests"] >= BREACH_MIN_REQUESTS
        breach = {
            slo_kind: floored and
            wins[FAST][f"{slo_kind}_burn"] > alert and
            wins[SLOW][f"{slo_kind}_burn"] > alert
            for slo_kind in ("availability", "latency")}
        # breach-triggered profiling: a class entering breach kicks one
        # async high-rate capture keyed by the class (cooldown-limited in
        # the profiler), fetched via admin profile?breach=<class>; the
        # summary link rides this report so the verdict names its
        # evidence
        profile_link: dict = {}
        if any(breach.values()):
            profiler.note_breach(cls)
        stored_prof = profiler.breach_profiles_summary().get(cls)
        if stored_prof is not None:
            profile_link = {"captured": True, **stored_prof}
        # the (seconds, trace_id) PAIR comes from whichever window
        # holds the larger breach — mixing one window's trace with the
        # other's duration would advertise a link whose span tree
        # doesn't match the number next to it
        worst_win = max((wins[w] for w, _ in WINDOWS),
                        key=lambda w: w["worst_slow_s"])
        worst_tid = worst_win["worst_slow_trace_id"]
        # the fast window's top offending buckets per slo kind, so a
        # breach names the tenant causing it
        top_buckets: dict = {}
        for slo_kind in ("availability", "latency"):
            rows = bucketstats.top_offenders(cls, slo_kind, WINDOWS[0][1],
                                             now)
            if rows:
                top_buckets[slo_kind] = rows
        out["classes"][cls] = {
            "objective": {
                # rounded: 99.9/100 is 0.9990000000000001 in binary
                # and the report is an operator-facing JSON document
                "availability": round(obj["availability"], 6),
                "latency_threshold_s": round(
                    obj["latency_threshold_s"], 6),
                "latency_threshold_source":
                    obj["latency_threshold_source"],
                "latency_target": round(obj["latency_target"], 6),
            },
            "windows": wins,
            "breach": breach,
            "breach_profile": profile_link,
            "top_buckets": top_buckets,
            "worst_breach": {
                "trace_id": worst_tid,
                "seconds": worst_win["worst_slow_s"],
                "stored": bool(worst_tid) and
                _sp.store().contains(worst_tid),
            },
        }
    probes: dict = {}
    for name, fn in list(_async_probes.items()):
        try:
            probes[name] = fn()
        except Exception:  # noqa: BLE001 — a dying subsystem must not
            # take the whole report down with it
            probes[name] = {"ok": False, "error": "probe failed"}
    if probes:
        out["async"] = probes
    return out


def reset() -> None:
    """Drop every window (tests / measurement isolation): earlier
    traffic must not bleed into a fresh measurement's ratios."""
    global _gen
    with _lock:
        _windows.clear()
        _slow_cache.clear()
        _gen += 1
