"""Self-adapting operation timeouts, the port of
minio_tpu/utils/dyntimeout.py (reference cmd/dynamic-timeouts.go):
keep a small log of recent operation outcomes; if more than 33% hit the
timeout, raise it 25%; if fewer than 10% did, decay toward 125% of the
slowest recent success. Used where a fixed timeout is either too twitchy
(slow disks under load) or too lax (fast local cluster): dsync lock
acquisition and storage RPC calls."""
from __future__ import annotations

import threading

LOG_SIZE = 16
INCREASE_PCT = 0.33
DECREASE_PCT = 0.10
MAX_TIMEOUT_S = 24 * 3600.0
_FAILURE = float("inf")


class DynamicTimeout:
    def __init__(self, timeout_s: float, minimum_s: float):
        if timeout_s <= 0 or minimum_s <= 0:
            raise ValueError("timeouts must be positive")
        self._timeout = float(timeout_s)
        self._min = min(float(minimum_s), float(timeout_s))
        self._log: list[float] = []
        self._lock = threading.Lock()

    def timeout(self) -> float:
        return self._timeout

    def log_success(self, duration_s: float) -> None:
        self._log_entry(duration_s)

    def log_failure(self) -> None:
        """The operation hit (or would have hit) the timeout."""
        self._log_entry(_FAILURE)

    def _log_entry(self, duration_s: float) -> None:
        if duration_s < 0:
            return
        with self._lock:
            self._log.append(duration_s)
            if len(self._log) < LOG_SIZE:
                return
            entries, self._log = self._log, []
        self._adjust(entries)

    def _adjust(self, entries: list[float]) -> None:
        failures = sum(1 for d in entries if d == _FAILURE)
        slowest = max((d for d in entries if d != _FAILURE), default=0.0)
        fail_pct = failures / len(entries)
        if fail_pct > INCREASE_PCT:
            self._timeout = min(self._timeout * 1.25, MAX_TIMEOUT_S)
        elif fail_pct < DECREASE_PCT:
            # decay toward 125% of the slowest recent success, never
            # below the configured floor
            target = max(slowest * 1.25, self._min)
            if target < self._timeout:
                self._timeout = target
