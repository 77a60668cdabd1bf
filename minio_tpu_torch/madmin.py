"""AdminClient, the port of minio_tpu/madmin.py (reference pkg/madmin, the
Go client ``mc admin`` drives): a typed programmatic surface over
/minio/admin/v3/..., signed with SigV4 by the port's server/auth.py, over
the standard library's urllib only.

The JAX client's calls of planes the port has not (replication, tiers,
bandwidth, update) and the ``peers`` fan-outs, which wait for the port of
``dist/``, are left out. Group membership (``add-user-to-group``), which
the JAX client reaches only through its raw transport, has a call of its
own here."""
from __future__ import annotations

import hashlib
import json
import urllib.parse
import urllib.request


class AdminError(Exception):
    def __init__(self, status: int, body: str):
        self.status = status
        self.body = body
        super().__init__(f"admin API {status}: {body[:200]}")


class AdminClient:
    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 region: str = "us-east-1"):
        self.endpoint = endpoint.rstrip("/")
        self.ak = access_key
        self.sk = secret_key
        self.region = region

    # -- transport ------------------------------------------------------------

    def _request(self, method: str, op: str,
                 query: dict[str, str] | None = None,
                 body: bytes = b"") -> bytes:
        from .server.auth import SigV4Verifier
        path = f"/minio/admin/v3/{op}"
        q = {k: [v] for k, v in (query or {}).items()}
        host = self.endpoint.split("//", 1)[1]
        headers = {"host": host}
        payload_hash = hashlib.sha256(body).hexdigest()
        signer = SigV4Verifier(lambda a: None, self.region)
        headers["authorization"] = signer.sign_request(
            self.ak, self.sk, method, path, q, headers, payload_hash)
        qs = urllib.parse.urlencode({k: v for k, v in (query or {}).items()})
        url = self.endpoint + path + (f"?{qs}" if qs else "")
        req = urllib.request.Request(url, data=body or None, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            raise AdminError(e.code, e.read().decode("utf-8", "replace")) \
                from None

    def _json(self, method: str, op: str, query=None, body: bytes = b""):
        out = self._request(method, op, query, body)
        return json.loads(out) if out.strip() else {}

    # -- info / health --------------------------------------------------------

    def server_info(self) -> dict:
        return self._json("GET", "info")

    def storage_info(self) -> dict:
        return self._json("GET", "storageinfo")

    def data_usage_info(self) -> dict:
        return self._json("GET", "datausageinfo")

    # -- heal -----------------------------------------------------------------

    @staticmethod
    def _heal_op(bucket: str, prefix: str) -> str:
        if prefix and not bucket:
            raise ValueError("heal prefix requires a bucket")
        return "heal" + (f"/{bucket}" if bucket else "") + \
            (f"/{prefix}" if prefix else "")

    def heal(self, bucket: str = "", prefix: str = "",
             dry_run: bool = False) -> dict:
        return self._json("POST", self._heal_op(bucket, prefix),
                          {"dryRun": "true"} if dry_run else None)

    def heal_status(self, token: str, bucket: str = "",
                    prefix: str = "") -> dict:
        return self._json("POST", self._heal_op(bucket, prefix),
                          {"clientToken": token})

    # -- IAM ------------------------------------------------------------------

    def add_user(self, access_key: str, secret_key: str,
                 policies: list[str] | None = None) -> None:
        self._json("PUT", "add-user", {"accessKey": access_key},
                   json.dumps({"secretKey": secret_key,
                               "policies": policies or []}).encode())

    def remove_user(self, access_key: str) -> None:
        self._json("DELETE", "remove-user", {"accessKey": access_key})

    def list_users(self) -> dict:
        return self._json("GET", "list-users")

    def set_user_status(self, access_key: str, status: str) -> None:
        self._json("PUT", "set-user-status",
                   {"accessKey": access_key, "status": status})

    def add_canned_policy(self, name: str, policy_json: bytes) -> None:
        self._json("PUT", "add-canned-policy", {"name": name}, policy_json)

    def list_canned_policies(self) -> dict:
        return self._json("GET", "list-canned-policies")

    def set_policy(self, user_or_group: str, policy_names: list[str],
                   group: bool = False) -> None:
        self._json("PUT", "set-user-or-group-policy",
                   {"userOrGroup": user_or_group,
                    "policyName": ",".join(policy_names),
                    "isGroup": "true" if group else "false"})

    def add_user_to_group(self, group: str, members: list[str]) -> None:
        self._json("PUT", "add-user-to-group", None,
                   json.dumps({"group": group,
                               "members": members}).encode())

    def add_service_account(self, parent: str = "",
                            policy: str = "") -> dict:
        return self._json("PUT", "add-service-account", None,
                          json.dumps({"parent": parent,
                                      "policy": policy}).encode())

    # -- quota / config -------------------------------------------------------

    def set_bucket_quota(self, bucket: str, quota_bytes: int) -> None:
        self._json("PUT", "set-bucket-quota", {"bucket": bucket},
                   json.dumps({"quota": quota_bytes}).encode())

    def get_bucket_quota(self, bucket: str) -> dict:
        return self._json("GET", "get-bucket-quota", {"bucket": bucket})

    def get_config(self) -> dict:
        return self._json("GET", "get-config")

    def set_config_kv(self, subsys: str, key: str, value: str) -> None:
        self._json("PUT", "set-config-kv",
                   {"subsys": subsys, "key": key, "value": value})

    def del_config_kv(self, subsys: str, key: str) -> None:
        self._json("DELETE", "del-config-kv",
                   {"subsys": subsys, "key": key})

    def profile(self, fmt: str = "top", seconds: float = 0.0,
                hz: float = 0.0, breach: str = "") -> dict | bytes:
        """Continuous profiling plane (`GET /minio/admin/v3/profile`,
        docs/observability.md "Continuous profiling"): the always-on
        sampler's aggregate as a JSON top report (``fmt="top"``), or
        raw bytes for ``fmt="folded"`` (flamegraph.pl collapsed
        stacks) / ``fmt="speedscope"``. ``seconds > 0`` captures a
        fresh high-rate window (``hz`` overrides the burst rate),
        ``breach="interactive"`` fetches the stored SLO-breach
        capture for that QoS class."""
        q: dict[str, str] = {"fmt": fmt}
        if seconds:
            q["seconds"] = str(seconds)
        if hz:
            q["hz"] = str(hz)
        if breach:
            q["breach"] = breach
        if fmt == "folded":
            return self._request("GET", "profile", q)
        return self._json("GET", "profile", q)

    def device_status(self, trace_seconds: float = 0.0) -> dict:
        """Device-plane snapshot (`GET /minio/admin/v3/device`): the
        per-lane live-buffer ledger, builds and first launches, per-op
        device seconds and roofline ratios, the allocator's memory.
        ``trace_seconds > 0`` additionally runs one torch.profiler
        session on the server."""
        q: dict[str, str] = {}
        if trace_seconds:
            q["trace"] = str(trace_seconds)
        return self._json("GET", "device", q or None)

    def start_profiling(self, profiler_type: str = "cpu") -> dict:
        return self._json("POST", "profiling/start",
                          {"profilerType": profiler_type})

    def download_profiling(self) -> bytes:
        return self._request("GET", "profiling/download")

    def thread_dump(self) -> str:
        return self._request("GET", "profiling/threads").decode()

    def health_info(self) -> dict:
        return self._json("GET", "healthinfo")

    def cluster_health(self) -> dict:
        """Health snapshot (`GET /minio/admin/v3/health`): disk health
        states and trip counts, dispatch lane utilization, QoS admission
        saturation, MRF/heal backlog and SLO verdicts, plus the cluster
        rollup."""
        return self._json("GET", "health")

    def slo_report(self) -> dict:
        """The standing per-class SLO verdict report: objectives,
        5m/1h window compliance, error-budget burn rates, breach
        verdicts, per-bucket burn attribution and worst-breach trace
        links (docs/observability.md "SLO plane & health snapshot")."""
        return self._json("GET", "slo")

    def bucket_stats(self) -> dict:
        """Per-bucket analytics report (`GET /minio/admin/v3/
        bucketstats`): the bounded top-N registry's per-bucket request
        counts, traffic bytes, TTFB/wall latency, live usage and
        reconcile drift, SLO burn contribution and capacity
        projection."""
        return self._json("GET", "bucketstats")

    def list_config_history(self) -> list:
        return self._json("GET", "list-config-history")

    def restore_config_history(self, restore_id: str) -> None:
        self._json("PUT", "restore-config-history",
                   {"restoreId": restore_id})

    def clear_config_history(self) -> None:
        self._json("DELETE", "clear-config-history")

    def service_restart(self) -> None:
        self._json("POST", "service", {"action": "restart"})

    def service_stop(self) -> None:
        self._json("POST", "service", {"action": "stop"})

    # -- fault injection (chaos harness) --------------------------------------

    def durability_status(self) -> dict:
        """Durability plane: fsync policy, flusher state, crash-step
        catalogue, recovery counters, last janitor sweep
        (docs/durability.md)."""
        return self._json("GET", "durability")

    def fault_status(self) -> dict:
        """Armed fault rules + per-disk health tracker states."""
        return self._json("GET", "fault")

    def fault_arm(self, rule) -> str:
        """Arm one fault rule; ``rule`` is a compact-grammar string
        (``disk:*:read_at:delay(200)@ttl=60``, docs/fault.md) or a dict
        of FaultRule fields. Returns the rule id."""
        body = {"rule": rule} if isinstance(rule, str) else dict(rule)
        return self._json("POST", "fault", None,
                          json.dumps(body).encode())["id"]

    def fault_disarm(self, rule_id: str) -> None:
        self._json("DELETE", "fault", {"id": rule_id})

    def fault_clear(self) -> None:
        self._json("DELETE", "fault")

    # -- kms ------------------------------------------------------------------

    def kms_status(self) -> dict:
        return self._json("GET", "kms/status")

    def kms_key_status(self, key_id: str = "") -> dict:
        q = {"key-id": key_id} if key_id else None
        return self._json("GET", "kms/key/status", q)

    def kms_create_key(self, key_id: str) -> None:
        self._json("POST", "kms/key/create", {"key-id": key_id})

    # -- observability --------------------------------------------------------

    def top_locks(self) -> dict:
        return self._json("GET", "top/locks")

    def top_api(self) -> dict:
        """Per-API call counts + latency percentiles."""
        return self._json("GET", "top/api")

    def qos_status(self) -> dict:
        """Live QoS status: dispatch scheduler spill/hold counters +
        device queue state, admission control inflight/reject totals,
        per-class last-minute latency percentiles."""
        return self._json("GET", "qos")

    def timeline(self, since: float = 0.0, count: int = 0,
                 fmt: str = "", attribution: bool = False) -> dict:
        """Dispatch-plane flight recorder (docs/observability.md):
        event ring + per-lane utilization. ``since`` filters to events
        newer than that monotonic timestamp (pair with the returned
        ``now`` for incremental polls), ``count`` keeps the newest N,
        ``fmt="chrome"`` returns Chrome-trace/Perfetto JSON,
        ``attribution`` embeds the standing per-op stage breakdown."""
        q: dict[str, str] = {}
        if since:
            q["since"] = str(since)
        if count:
            q["count"] = str(count)
        if fmt:
            q["fmt"] = fmt
        if attribution:
            q["attribution"] = "1"
        return self._json("GET", "timeline", q)

    def trace(self, count: int = 50, timeout: float = 5.0,
              trace_type: str = "", threshold: str = "",
              errors_only: bool = False) -> list[dict]:
        """`mc admin trace` analogue. ``trace_type`` is a csv of
        http|storage|kernel|scanner (or "all"; server default: http),
        ``threshold`` a minimum duration ("100ms", "1.5s" or bare
        seconds), ``errors_only`` keeps only failed calls."""
        q = {"count": str(count), "timeout": str(timeout)}
        if trace_type:
            q["type"] = trace_type
        if threshold:
            q["threshold"] = str(threshold)
        if errors_only:
            q["err"] = "1"
        raw = self._request("GET", "trace", q)
        return [json.loads(ln) for ln in raw.splitlines() if ln.strip()]

    def trace_tree(self, trace_id: str) -> dict:
        """Stored span tree for one trace id (tail-sampled slow/error
        traces): {"trace_id", "spans": [...], "tree": [...]}."""
        return self._json("GET", "trace", {"trace_id": trace_id})

    def slow_traces(self, count: int = 50) -> list[dict]:
        """Newest-first summaries of the tail-sampled slow-trace store:
        requests that breached their QoS class latency budget or
        errored. Full trees via ``trace_tree``."""
        return self._json("GET", "trace",
                          {"slow": "1", "count": str(count)})

    def recent_logs(self, n: int = 100, kind: str = "") -> list[dict]:
        """Recent structured log entries (console-log history analogue);
        ``kind="audit"`` returns the per-request audit mirror ring."""
        q = {"n": str(n)}
        if kind:
            q["type"] = kind
        return self._json("GET", "logs", q)
