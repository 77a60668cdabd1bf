"""Online last-minute latency, the port of minio_tpu/obs/latency.py (reference cmd/last-minute.go
``lastMinuteLatency`` + the p50/p95/p99 drive rows of cmd/metrics-v2.go):
a sliding window of per-second buckets, each second holding a coarse
log-spaced latency histogram, merged on read into online percentiles and
a bytes-throughput rate.

Writes are O(1) and lock-cheap: one bisect into the static edge table,
one slot index, a handful of increments under a per-window lock that is
never held across I/O. Reads (metrics scrapes, admin endpoints) merge at
most ``window_s`` slots. This is the window behind
``minio_tpu_disk_latency_seconds`` and
``minio_tpu_kernel_op_latency_seconds`` — and every other percentile of
the port (stage attribution, the QoS classes, the dispatch lanes) goes
through the very same class, so no two reports can diverge in method.
Pure Python: no torch, no device.

Every time-taking function accepts an explicit ``now`` (monotonic
seconds) so tests can fake timestamps and verify bucket expiry.
"""
from __future__ import annotations

import bisect
import threading
import time

#: window span in seconds (reference lastMinuteLatency: 60 one-second
#: slots).
WINDOW_S = 60


def _build_edges() -> tuple[float, ...]:
    """Log-spaced latency bucket upper bounds, 50 us .. ~200 s at 20%
    steps (~85 buckets) — <=20% quantization error at any percentile,
    fixed memory."""
    out = []
    v = 50e-6
    while v < 200.0:
        out.append(v)
        v *= 1.2
    return tuple(out)


EDGES = _build_edges()
_NB = len(EDGES) + 1  # final bucket is +Inf

#: coarsened edge subset for Prometheus histogram exposition
#: (every 4th log-spaced edge, ~22 buckets — cumulative counts stay
#: EXACT because each coarse bucket sums whole fine buckets)
HIST_EDGES = EDGES[::4]


class Window:
    """One sliding-window histogram: per-second slots recycled in place
    (a slot whose epoch second fell out of the window is reset on the
    next write to that slot and ignored by reads)."""

    def __init__(self, window_s: int = WINDOW_S):
        self.window_s = window_s
        self._lock = threading.Lock()
        self._epoch = [-1] * window_s      # absolute second each slot holds
        self._counts = [[0] * _NB for _ in range(window_s)]
        self._total = [0.0] * window_s     # sum of observed seconds
        self._bytes = [0] * window_s       # payload bytes (throughput)
        self._n = [0] * window_s
        # worst observation per slot + the trace that caused it, so the
        # percentile rows can link straight to an offending span tree
        self._worst = [0.0] * window_s
        self._worst_tid = [""] * window_s

    # -- write path ----------------------------------------------------------

    def observe(self, seconds: float, nbytes: int = 0,
                now: float | None = None, trace_id: str = "") -> None:
        sec = int(time.monotonic() if now is None else now)
        slot = sec % self.window_s
        i = bisect.bisect_left(EDGES, seconds)
        with self._lock:
            if self._epoch[slot] != sec:
                self._epoch[slot] = sec
                self._counts[slot] = [0] * _NB
                self._total[slot] = 0.0
                self._bytes[slot] = 0
                self._n[slot] = 0
                self._worst[slot] = 0.0
                self._worst_tid[slot] = ""
            self._counts[slot][i] += 1
            self._total[slot] += seconds
            self._bytes[slot] += nbytes
            self._n[slot] += 1
            if seconds >= self._worst[slot]:
                self._worst[slot] = seconds
                self._worst_tid[slot] = trace_id

    # -- read path -----------------------------------------------------------

    def _merge(self, now: float | None = None
               ) -> tuple[list[int], int, float, int, int, float, str]:
        """(bucket counts, n, total seconds, total bytes, active seconds,
        worst seconds, worst trace_id) over the slots still inside the
        window."""
        sec = int(time.monotonic() if now is None else now)
        lo = sec - self.window_s + 1
        counts = [0] * _NB
        n = 0
        total = 0.0
        nbytes = 0
        active = 0
        worst = 0.0
        worst_tid = ""
        with self._lock:
            for s in range(self.window_s):
                if not (lo <= self._epoch[s] <= sec) or not self._n[s]:
                    continue
                c = self._counts[s]
                for i in range(_NB):
                    counts[i] += c[i]
                n += self._n[s]
                total += self._total[s]
                nbytes += self._bytes[s]
                active += 1
                if self._worst[s] >= worst:
                    worst = self._worst[s]
                    worst_tid = self._worst_tid[s]
        return counts, n, total, nbytes, active, worst, worst_tid

    def stats(self, qs: tuple[float, ...] = (0.5, 0.95, 0.99),
              now: float | None = None) -> dict:
        """One merge serving a whole metrics row: ``{"percentiles":
        {q: v}, "count": n, "rate_gibs": r, "worst_s": w,
        "worst_trace_id": t}`` — cheaper and internally consistent vs
        calling percentiles()/count()/rate_gibs() separately (each takes
        its own merge at its own now)."""
        counts, n, _, nbytes, active, worst, worst_tid = self._merge(now)
        return {
            "percentiles": self._percentiles_from(counts, n, qs),
            "count": n,
            "rate_gibs": nbytes / active / (1 << 30) if active else 0.0,
            "worst_s": worst,
            "worst_trace_id": worst_tid,
        }

    def hist(self, now: float | None = None) -> dict:
        """Prometheus-histogram view of the window: cumulative counts at
        the coarse ``HIST_EDGES`` bounds (exact — each coarse bucket
        sums whole fine buckets), total count, sum of observed seconds,
        and the worst sample + its trace_id for OpenMetrics exemplars.
        Feeds the ``*_duration_seconds`` histogram families beside the
        p50/p99 summary gauges."""
        counts, n, total, _, _, worst, worst_tid = self._merge(now)
        cum: list[int] = []
        acc = 0
        j = 0
        for i, edge in enumerate(EDGES):
            acc += counts[i]
            if j < len(HIST_EDGES) and edge == HIST_EDGES[j]:
                cum.append(acc)
                j += 1
        acc += counts[len(EDGES)]  # +Inf bucket
        return {"edges": HIST_EDGES, "cum": cum, "count": n,
                "sum": total, "worst_s": worst,
                "worst_trace_id": worst_tid}

    def percentiles(self, qs: tuple[float, ...] = (0.5, 0.95, 0.99),
                    now: float | None = None) -> dict[float, float]:
        """Online percentiles, linearly interpolated inside the matched
        bucket; 0.0 when the window is empty."""
        counts, n, *_ = self._merge(now)
        return self._percentiles_from(counts, n, qs)

    def worst(self, now: float | None = None) -> tuple[float, str]:
        """(worst observed seconds, trace_id of that sample) inside the
        window — the exemplar linking a percentile row to the span tree
        that produced its tail."""
        *_, worst, worst_tid = self._merge(now)
        return worst, worst_tid

    @staticmethod
    def _percentiles_from(counts: list[int], n: int,
                          qs: tuple[float, ...]) -> dict[float, float]:
        out: dict[float, float] = {}
        for q in qs:
            if n == 0:
                out[q] = 0.0
                continue
            rank = q * n
            cum = 0
            val = EDGES[-1] * 1.2
            for i, c in enumerate(counts):
                if c and cum + c >= rank:
                    b_lo = EDGES[i - 1] if i > 0 else 0.0
                    b_hi = EDGES[i] if i < len(EDGES) else EDGES[-1] * 1.2
                    frac = (rank - cum) / c
                    val = b_lo + (b_hi - b_lo) * min(1.0, max(0.0, frac))
                    break
                cum += c
            out[q] = val
        return out

    def count(self, now: float | None = None) -> int:
        return self._merge(now)[1]

    def rate_gibs(self, now: float | None = None) -> float:
        """Observed payload GiB/s averaged over the window's ACTIVE
        seconds (idle seconds don't dilute a burst's rate)."""
        _, _, _, nbytes, active, _, _ = self._merge(now)
        if not active:
            return 0.0
        return nbytes / active / (1 << 30)

    def mean(self, now: float | None = None) -> float:
        _, n, total, *_ = self._merge(now)
        return total / n if n else 0.0

    def reset(self) -> None:
        with self._lock:
            for s in range(self.window_s):
                self._epoch[s] = -1
                self._n[s] = 0


# -- process-wide registry ---------------------------------------------------
#
# Families in use:
#   "disk"    labels disk=<endpoint>, op=<storage op>   (xlstorage)
#   "kernel"  labels op=encode|reconstruct|fused|heal_shard  (dispatch +
#             the heal path)

_registry: dict[tuple, Window] = {}
_reg_lock = threading.Lock()


def _key(family: str, labels: dict) -> tuple:
    return (family,) + tuple(sorted(labels.items()))


def get_window(family: str, **labels) -> Window:
    key = _key(family, labels)
    w = _registry.get(key)
    if w is None:
        with _reg_lock:
            w = _registry.setdefault(key, Window())
    return w


def reset_window(family: str, **labels) -> Window:
    """Swap in a fresh window for this series and return it (a
    measurement reads a clean window this way — the same object the
    metrics exposition would serve)."""
    key = _key(family, labels)
    w = Window()
    with _reg_lock:
        _registry[key] = w
    return w


def observe(family: str, seconds: float, nbytes: int = 0,
            now: float | None = None, trace_id: str = "",
            **labels) -> None:
    get_window(family, **labels).observe(seconds, nbytes, now, trace_id)


def snapshot(family: str) -> list[tuple[dict, Window]]:
    """(labels, window) pairs for one family, label-sorted — the metrics
    groups iterate this."""
    with _reg_lock:
        items = [(dict(k[1:]), w) for k, w in _registry.items()
                 if k[0] == family]
    return sorted(items, key=lambda it: sorted(it[0].items()))
