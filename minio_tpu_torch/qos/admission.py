"""S3 admission control, the port of minio_tpu/qos/admission.py:
per-class token buckets + a bounded-wait
concurrency gate in front of the request handlers.

Replaces the bare 256-permit semaphore the server carried (reference
cmd/handler-api.go per-node request throttle): instead of letting every
connection park a handler thread behind the limit forever, a request
that cannot get a slot within ``max_wait_ms`` — or whose class token
bucket is empty — is answered with the S3-semantic ``503 SlowDown`` plus
a ``Retry-After`` header, so well-behaved SDKs back off and the thread
pool stays bounded under overload.

Classes (see ``classify_request``): object-data traffic is
``interactive``, bucket/metadata/console traffic is ``control``; the
health/readiness, metrics, admin and internal-RPC planes are EXEMPT — an
overloaded server must stay observable and steerable.

Knobs (config subsystem ``qos``, env > stored > default, read per admit):

* ``MINIO_TPU_QOS_MAX_WAIT_MS`` (default 500) — how long a request may
  wait for a concurrency slot before SlowDown.
* ``MINIO_TPU_QOS_INTERACTIVE_RPS`` / ``MINIO_TPU_QOS_CONTROL_RPS``
  (default 0 = unlimited) — per-class token-bucket refill rates; burst
  is 2 s of refill (min 8).
* ``S3Server(..., max_requests=)`` (default 256) — total concurrent
  in-flight requests.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass

CLASS_CONTROL = "control"

def plane_exempt(path: str, internal=()) -> bool:
    """True for the observability/data planes every wrapper must leave
    alone: health/readiness + metrics probes and internal-RPC paths for
    the mounted ``internal`` services. Shared by admission control
    (classify_request) and the span tracer (s3api._span_exempt) so the
    two exemption lists cannot drift."""
    if path.startswith("/minio/health/") or \
            path.startswith("/minio/metrics") or \
            path.startswith("/minio/v2/metrics"):
        return True
    if path.startswith("/minio/"):
        parts = path.split("/", 3)  # ['', 'minio', <service>, rest]
        if len(parts) > 2 and internal and parts[2] in internal:
            return True
    return False

_RPS_ENV = {"interactive": "MINIO_TPU_QOS_INTERACTIVE_RPS",
            CLASS_CONTROL: "MINIO_TPU_QOS_CONTROL_RPS"}
_RPS_KEY = {"interactive": "interactive_rps",
            CLASS_CONTROL: "control_rps"}


def classify_request(method: str, path: str,
                     internal=()) -> str | None:
    """QoS class for one HTTP request; None = exempt from admission.
    ``internal`` is the set of mounted internal-RPC service names
    (storage/lock/peer): only /minio/<service>/... paths for THOSE
    services are exempt — throttling the cluster's own data plane under
    overload would turn congestion into quorum loss, but the console
    plane (webrpc/upload/download/zip) must stay throttled on
    distributed nodes too."""
    p = path.split("?", 1)[0]
    if p.startswith("/minio/admin/") or plane_exempt(p, internal):
        return None
    if p.startswith("/minio/"):
        return CLASS_CONTROL  # console webrpc/upload/download/zip
    parts = p.lstrip("/").split("/", 1)
    has_key = len(parts) > 1 and parts[1] != ""
    if has_key and method in ("GET", "PUT", "HEAD", "POST", "DELETE"):
        return "interactive"
    return CLASS_CONTROL


class TokenBucket:
    """Classic token bucket; ``take()`` returns 0.0 on success or the
    seconds until a token will be available (the Retry-After hint)."""

    def __init__(self, rate: float, burst: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.t = time.monotonic()
        self._lock = threading.Lock()

    def take(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            # clamp: a caller-supplied (test) clock earlier than the
            # construction time must not drain the bucket negative
            elapsed = max(0.0, now - self.t)
            self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
            self.t = now
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return 0.0
            return (1.0 - self.tokens) / self.rate

    def refund(self) -> None:
        """Return a taken token (the request was never admitted — e.g.
        it timed out on the concurrency gate after passing the rate
        check); without this, concurrency saturation silently burns the
        configured rate budget."""
        with self._lock:
            self.tokens = min(self.burst, self.tokens + 1.0)


@dataclass
class Grant:
    ok: bool
    cls: str = ""
    reason: str = ""          # "" | "concurrency" | "rate"
    retry_after_s: float = 0.0


class AdmissionController:
    """Bounded-wait concurrency gate + per-class token buckets."""

    def __init__(self, max_requests: int = 256,
                 max_wait_s: float | None = None,
                 rates: dict[str, float] | None = None):
        self.max_requests = max(1, max_requests)
        self._max_wait_s = max_wait_s
        self._rates_override = rates
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._inflight_total = 0
        self._inflight: dict[str, int] = {}
        self._buckets: dict[str, TokenBucket] = {}
        # telemetry
        self.admitted: dict[str, int] = {}
        self.rejected: dict[str, int] = {}

    # -- knobs (resolved per admit: the qos subsystem is dynamic) ------------

    def _wait_s(self) -> float:
        if self._max_wait_s is not None:
            return self._max_wait_s
        from .budget import _config_float
        return _config_float("qos", "max_wait_ms",
                             "MINIO_TPU_QOS_MAX_WAIT_MS", 500.0) / 1e3

    def _bucket_for(self, cls: str) -> TokenBucket | None:
        if self._rates_override is not None:
            rate = self._rates_override.get(cls, 0.0)
        else:
            from .budget import _config_float
            rate = _config_float("qos", _RPS_KEY.get(cls, ""),
                                 _RPS_ENV.get(cls, ""), 0.0)
        # mutations happen under the lock: stats() iterates _buckets
        # there, and two racing admits must share ONE bucket's tokens
        with self._lock:
            if rate <= 0:
                self._buckets.pop(cls, None)
                return None
            b = self._buckets.get(cls)
            if b is None or b.rate != rate:
                b = self._buckets[cls] = TokenBucket(rate,
                                                     max(8.0, rate * 2.0))
            return b

    def reconfigure(self, max_requests: int) -> None:
        """Change the capacity; it takes effect for waiters at once."""
        with self._cv:
            self.max_requests = max(1, max_requests)
            self._cv.notify_all()

    # -- the gate -------------------------------------------------------------

    def admit(self, cls: str) -> Grant:
        bucket = self._bucket_for(cls)
        if bucket is not None:
            retry = bucket.take()
            if retry > 0.0:
                with self._lock:
                    self.rejected[cls] = self.rejected.get(cls, 0) + 1
                return Grant(False, cls, "rate", retry)
        deadline = time.monotonic() + self._wait_s()
        with self._cv:
            while self._inflight_total >= self.max_requests:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(timeout=remaining):
                    if self._inflight_total < self.max_requests:
                        break  # woken at the wire: slot freed
                    self.rejected[cls] = self.rejected.get(cls, 0) + 1
                    if bucket is not None:
                        # never admitted: give the rate token back
                        bucket.refund()
                    return Grant(False, cls, "concurrency",
                                 max(1.0, self._wait_s()))
            self._inflight_total += 1
            self._inflight[cls] = self._inflight.get(cls, 0) + 1
            self.admitted[cls] = self.admitted.get(cls, 0) + 1
        return Grant(True, cls)

    def release(self, grant: Grant) -> None:
        if not grant.ok:
            return
        with self._cv:
            self._inflight_total = max(0, self._inflight_total - 1)
            self._inflight[grant.cls] = \
                max(0, self._inflight.get(grant.cls, 0) - 1)
            self._cv.notify()

    @staticmethod
    def retry_after_header(grant: Grant) -> str:
        return str(max(1, math.ceil(grant.retry_after_s)))

    def stats(self) -> dict:
        with self._lock:
            return {
                "max_requests": self.max_requests,
                "max_wait_ms": round(self._wait_s() * 1e3, 1),
                "inflight_total": self._inflight_total,
                "inflight": dict(self._inflight),
                "admitted": dict(self.admitted),
                "rejected": dict(self.rejected),
                "rates": {c: b.rate for c, b in self._buckets.items()},
            }
