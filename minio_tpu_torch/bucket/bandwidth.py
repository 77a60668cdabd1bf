"""Per-bucket replication bandwidth throttling and measurement, the port
of minio_tpu/bucket/bandwidth.py (reference
pkg/bucket/bandwidth: throttle.go token windows, reader.go MonitoredReader,
monitor.go/measurement.go per-bucket moving average, surfaced over the
admin API as a Report).

The throttle refills a byte budget every 250 ms window; readers consume
from it and block (condition variable) when the window is spent. The
monitor keeps an exponentially-weighted bytes/sec per bucket so the admin
report shows actual consumption against the configured limit."""
from __future__ import annotations

import threading
import time

WINDOW_S = 0.25          # throttleInternal, pkg/bucket/bandwidth/throttle.go
EWMA_BETA = 0.1          # betaBucket weighting, measurement.go


class Throttle:
    """Token-bucket limiter: ``bytes_per_second`` budget granted in
    WINDOW_S slices. take(want) returns how many bytes the caller may
    move now (blocking while the window is exhausted)."""

    def __init__(self, bytes_per_second: int):
        self.bps = int(bytes_per_second)
        self._per_window = max(1, int(self.bps * WINDOW_S))
        self._free = self._per_window
        self._cond = threading.Condition()
        self._last_refill = time.monotonic()

    def take(self, want: int) -> int:
        if want <= 0 or self.bps <= 0:
            return want
        with self._cond:
            while True:
                self._refill_locked()
                if self._free > 0:
                    send = min(want, self._free)
                    self._free -= send
                    return send
                # sleep until the next window opens; wait with timeout so
                # refill progresses even with no other waker
                self._cond.wait(WINDOW_S / 2)

    def release(self, unused: int):
        """Return bytes taken but not actually sent."""
        if unused <= 0 or self.bps <= 0:
            return
        with self._cond:
            self._free += unused
            self._cond.notify_all()

    def set_bandwidth(self, bytes_per_second: int):
        with self._cond:
            self.bps = int(bytes_per_second)
            self._per_window = max(1, int(self.bps * WINDOW_S))
            self._cond.notify_all()

    def _refill_locked(self):
        now = time.monotonic()
        if now - self._last_refill >= WINDOW_S:
            self._free = self._per_window
            self._last_refill = now
            self._cond.notify_all()


class _Measurement:
    """Exponentially-weighted bytes/sec (measurement.go): one-second
    buckets folded into an EWMA so short bursts don't whipsaw the
    report."""

    def __init__(self):
        self._lock = threading.Lock()
        self._window_start = time.monotonic()
        self._window_bytes = 0
        self.ewma_bps = 0.0

    def add(self, n: int):
        with self._lock:
            now = time.monotonic()
            elapsed = now - self._window_start
            if elapsed >= 1.0:
                rate = self._window_bytes / elapsed
                self.ewma_bps = rate if self.ewma_bps == 0 else (
                    EWMA_BETA * self.ewma_bps + (1 - EWMA_BETA) * rate)
                self._window_start = now
                self._window_bytes = 0
            self._window_bytes += n

    def current_bps(self) -> float:
        """EWMA, falling back to the in-progress window so short bursts
        (transfers under a second) still show up in the report."""
        with self._lock:
            if self.ewma_bps:
                return self.ewma_bps
            elapsed = time.monotonic() - self._window_start
            if self._window_bytes and elapsed > 0.05:
                return self._window_bytes / elapsed
            return 0.0


class Monitor:
    """Tracks per-bucket replication bandwidth: configured limit + the
    measured moving average (monitor.go GetReport)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._throttles: dict[str, Throttle] = {}
        self._meas: dict[str, _Measurement] = {}

    def throttle(self, bucket: str, bytes_per_second: int) -> Throttle:
        """Get/create the bucket throttle, updating the limit if it
        changed (SetBandwidthLimit)."""
        with self._lock:
            t = self._throttles.get(bucket)
            if t is None:
                t = self._throttles[bucket] = Throttle(bytes_per_second)
            elif t.bps != bytes_per_second:
                t.set_bandwidth(bytes_per_second)
            self._meas.setdefault(bucket, _Measurement())
            return t

    def track(self, bucket: str, n: int):
        with self._lock:
            m = self._meas.setdefault(bucket, _Measurement())
        m.add(n)

    def delete_bucket(self, bucket: str):
        with self._lock:
            self._throttles.pop(bucket, None)
            self._meas.pop(bucket, None)

    def report(self, buckets: list[str] | None = None) -> dict:
        """madmin-compatible Report (pkg/bandwidth/bandwidth.go)."""
        stats = {}
        with self._lock:
            items = list(self._meas.items())
            limits = {b: t.bps for b, t in self._throttles.items()}
        for b, m in items:
            if buckets and b not in buckets:
                continue
            stats[b] = {
                "limitInBits": limits.get(b, 0),
                "currentBandwidth": round(m.current_bps(), 2)}
        return {"bucketStats": stats}


class MonitoredReader:
    """File-like read() wrapper enforcing the bucket throttle and feeding
    the monitor (reader.go MonitoredReader). Wraps replication upload
    bodies; requests streams from any object with read()."""

    def __init__(self, monitor: Monitor, bucket: str, stream,
                 bytes_per_second: int = 0, total_size: int | None = None):
        self.monitor = monitor
        self.bucket = bucket
        self.stream = stream
        self.throttle = monitor.throttle(bucket, bytes_per_second) \
            if bytes_per_second > 0 else None
        # requests uses __len__/len to set Content-Length for file-likes
        # it can't fstat; remember it so chunked encoding isn't forced
        self._total = total_size

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = 1 << 20
        if self.throttle is not None:
            n = self.throttle.take(n)
        b = self.stream.read(n)
        if self.throttle is not None and len(b) < n:
            self.throttle.release(n - len(b))
        if b:
            self.monitor.track(self.bucket, len(b))
        return b

    def __len__(self):
        if self._total is None:
            raise TypeError("size unknown")
        return self._total


#: process-wide monitor (the reference's globalBucketMonitor)
_monitor: Monitor | None = None
_monitor_lock = threading.Lock()


def global_monitor() -> Monitor:
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = Monitor()
        return _monitor
