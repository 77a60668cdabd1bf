"""Peer REST service, the port of minio_tpu/dist/peer.py — the
node-to-node control plane (reference
cmd/peer-rest-{client,server}.go: 35 methods for config/bucket-metadata
sync, server info, trace...; the subset here covers cluster coherence:
bucket-metadata invalidation, server info, bootstrap verification). The
streaming methods (live trace and console) answer chunked NDJSON with
bare-newline keep-alives; the client reads the records off its own
connection (``dist/rpc.py``)."""
from __future__ import annotations

import json
import platform

from .rpc import RPCClient


class PeerRESTClient:
    def __init__(self, node_url: str, secret: str, src: str = ""):
        self.url = node_url
        self.rpc = RPCClient(node_url, "peer", secret, src=src)

    def is_online(self) -> bool:
        return self.rpc.is_online()

    def load_bucket_metadata(self, bucket: str) -> None:
        self.rpc.call("loadbucketmetadata", {"bucket": bucket})

    def delete_bucket_metadata(self, bucket: str) -> None:
        self.rpc.call("deletebucketmetadata", {"bucket": bucket})

    def server_info(self) -> dict:
        return json.loads(self.rpc.call("serverinfo"))

    def get_local_disk_ids(self) -> list[str]:
        return json.loads(self.rpc.call("getlocaldiskids"))

    def verify_config(self, config: dict) -> bool:
        """Bootstrap cross-check (reference bootstrap-peer-server.go:162):
        every node must agree on the endpoint layout."""
        out = self.rpc.call("verifyconfig", body=json.dumps(config).encode())
        return out == b"ok"

    def signal_service(self, sig: str) -> None:
        self.rpc.call("signalservice", {"signal": sig})

    # --- IAM sync (reference peer-rest-common.go:33-44) ---------------------

    def load_iam(self, entity: str = "", name: str = "") -> None:
        """Tell the peer to reload IAM state; entity/name narrow the
        reload for the reference's method parity (LoadUser, LoadPolicy,
        LoadGroup, LoadServiceAccount) — the state is one shared document
        so the peer reloads it whole either way."""
        self.rpc.call("loadiam", {"entity": entity, "name": name})

    def load_user(self, access_key: str) -> None:
        self.load_iam("user", access_key)

    def load_policy(self, name: str) -> None:
        self.load_iam("policy", name)

    def load_group(self, name: str) -> None:
        self.load_iam("group", name)

    def load_service_account(self, access_key: str) -> None:
        self.load_iam("service-account", access_key)

    def trace_recent(self, n: int = 256) -> list[dict]:
        """The peer's recent trace ring (one-shot history dump)."""
        import json as _json
        return _json.loads(self.rpc.call("tracerecent", {"n": str(n)}))

    def trace_tree(self, trace_id: str) -> dict:
        """The peer's stored span fragment (or slow trace) for one
        trace_id — {} when the peer holds nothing for it. The admin
        ?trace_id=...&peers=1 query merges these into the caller's
        tree."""
        import json as _json
        out = self.rpc.call("tracetree", {"trace_id": trace_id})
        return _json.loads(out) if out else {}

    def trace_stream(self, timeout_s: float = 10.0, count: int = 1000):
        """LIVE trace events from the peer as they happen (reference
        peerRESTMethodTrace streaming, cmd/peer-rest-common.go:54):
        yields dicts; keepalive newlines are filtered out here."""
        yield from self._stream("tracestream", timeout_s, count)

    def console_stream(self, timeout_s: float = 10.0, count: int = 1000):
        """LIVE console log entries from the peer (reference
        cmd/consolelogger.go peer streaming)."""
        yield from self._stream("consolestream", timeout_s, count)

    def _stream(self, method: str, timeout_s: float, count: int):
        import json as _json
        r = self.rpc.call(method,
                          {"timeout": str(timeout_s), "count": str(count)},
                          stream=True, timeout=timeout_s + 10)
        try:
            for line in r.iter_lines():
                if not line:
                    continue  # keepalive
                yield _json.loads(line)
        finally:
            r.close()

    # --- observability / OBD fan-out (reference peer-rest-common.go:
    # CPULoadInfo, MemUsageInfo, DriveOBDInfo, Log, GetBandwidth,
    # GetLocks, StartProfiling, DownloadProfilingData,
    # BackgroundHealStatus) --------------------------------------------------

    def proc_info(self) -> dict:
        """Peer cpu/mem/drive OBD report."""
        return json.loads(self.rpc.call("procinfo"))

    def metrics(self) -> dict:
        """Peer's raw counter store for cluster-level aggregation."""
        return json.loads(self.rpc.call("metrics"))

    def get_locks(self) -> list:
        return json.loads(self.rpc.call("getlocks"))

    def get_bandwidth(self) -> dict:
        return json.loads(self.rpc.call("getbandwidth"))

    def console_log(self, n: int = 100) -> list:
        """Peer's recent structured log entries (reference
        peerRESTMethodLog console streaming, one-shot)."""
        return json.loads(self.rpc.call("consolelog", {"n": str(n)}))

    def start_profiling(self, kind: str = "cpu") -> None:
        self.rpc.call("startprofiling", {"profilerType": kind})

    def download_profiling(self) -> bytes:
        return self.rpc.call("downloadprofiling")

    def background_heal_status(self) -> dict:
        return json.loads(self.rpc.call("backgroundhealstatus"))

    def health_snapshot(self) -> dict:
        """The peer's node health snapshot (obs/health.node_snapshot):
        disk states, lane utilization, QoS saturation, heal backlog,
        SLO verdicts — the admin ``GET /minio/admin/v3/health``
        aggregation fans this out."""
        return json.loads(self.rpc.call("healthsnapshot"))

    def profile(self, seconds: float = 0.0) -> dict:
        """The peer's continuous-profiler top report (obs/profiler.py);
        ``seconds > 0`` captures a fresh high-rate window on the peer —
        the admin ``profile?peers=1`` aggregation fans this out."""
        return json.loads(self.rpc.call(
            "profile", {"seconds": str(seconds)},
            timeout=max(10.0, seconds + 10.0)))

    def device_status(self) -> dict:
        """The peer's device-plane snapshot (obs/device.status): HBM
        ledger, compile table, roofline ratios — the admin
        ``device?peers=1`` aggregation fans this out."""
        return json.loads(self.rpc.call("devicestatus"))

    def bucket_stats(self) -> dict:
        """The peer's per-bucket analytics report (obs/bucketstats):
        bounded per-bucket request/traffic/latency/usage numbers — the
        admin ``bucketstats?peers=1`` aggregation fans this out."""
        return json.loads(self.rpc.call("bucketstats"))

    # --- cross-node replication (bucket/replicate.py; reference
    # cmd/bucket-replication.go replicateObject target write) ----------------

    def replicate_object(self, bucket: str, key: str, body,
                         meta: dict | None = None, version_id: str = "",
                         timeout: float = 10.0) -> None:
        """Land one replica object on this peer. The body is the
        PLAINTEXT source bytes; the peer stamps the REPLICA marker so
        its own write events can never loop back. Timeout is mandatory
        (GL019): a wedged target must park the obligation for retry,
        not hang the replication worker."""
        self.rpc.call("replicateobject",
                      {"bucket": bucket, "object": key,
                       "version_id": version_id,
                       "meta": json.dumps(meta or {})},
                      body=bytes(body), timeout=timeout)

    def replicate_delete(self, bucket: str, key: str,
                         version_id: str = "",
                         timeout: float = 10.0) -> None:
        """Propagate a delete obligation to this peer's replica
        bucket. Missing objects are success (idempotent — replays
        after a crash re-send deletes)."""
        self.rpc.call("replicatedelete",
                      {"bucket": bucket, "object": key,
                       "version_id": version_id},
                      timeout=timeout)

    def replication_stats(self, timeout: float = 10.0) -> dict:
        """The peer's replication-plane stats (backlog, lag, counts) —
        the admin ``replication?peers=1`` aggregation fans this out."""
        return json.loads(self.rpc.call("replicationstats",
                                        timeout=timeout))


def _stream_pubsub(pubsub, timeout_s: float, count: int, to_dict=None):
    """Generator of NDJSON event lines from a live pubsub subscription,
    with bare-newline keepalives while idle (SURVEY.md A.7 / reference
    cmd/storage-rest-server.go:740-760 keepalive-byte framing): events
    stream to the peer AS THEY HAPPEN instead of via ring polling."""
    import queue as qmod
    import time as _t

    def gen():
        sub = pubsub.subscribe()
        sent = 0
        deadline = _t.monotonic() + timeout_s
        try:
            while sent < count:
                left = deadline - _t.monotonic()
                if left <= 0:
                    return
                try:
                    item = sub.get(timeout=min(1.0, left))
                except qmod.Empty:
                    yield b"\n"  # keepalive: connection alive, no event
                    continue
                rec = to_dict(item) if to_dict is not None else item
                yield json.dumps(rec).encode() + b"\n"
                sent += 1
        finally:
            pubsub.unsubscribe(sub)
    return gen()


class PeerRESTService:
    def __init__(self, node):
        self.node = node  # dist.node.Node

    def handle(self, method: str, params: dict, body: bytes) -> bytes:
        if method in ("loadbucketmetadata", "deletebucketmetadata"):
            bucket = params.get("bucket", "")
            if self.node.bucket_meta is not None:
                self.node.bucket_meta.invalidate(bucket)
            notifier = getattr(getattr(self.node, "server", None),
                               "_notifier", None)
            if notifier is not None:
                # notification rules are derived from bucket metadata;
                # drop this node's cached routing too
                notifier.invalidate(bucket)
            return b""
        if method == "serverinfo":
            return json.dumps({
                "endpoint": self.node.local_url,
                "uptime": self.node.uptime(),
                "version": "minio-tpu/0.1",
                "platform": platform.platform(),
                "disks": [d.endpoint() for d in
                          self.node.local_disks.values()],
            }).encode()
        if method == "getlocaldiskids":
            return json.dumps([
                d.get_disk_id() for d in
                self.node.local_disks.values()]).encode()
        if method == "verifyconfig":
            mine = self.node.layout_fingerprint()
            theirs = json.loads(body or b"{}")
            return b"ok" if mine == theirs else \
                json.dumps(mine).encode()
        if method == "signalservice":
            return b""
        if method == "loadiam":
            srv = getattr(self.node, "server", None)
            if srv is not None and getattr(srv, "iam", None) is not None:
                srv.iam.load()
            return b""
        if method == "tracerecent":
            from ..obs.trace import recent
            n = int(params.get("n", "256"))
            return json.dumps(
                [t.to_dict() for t in recent(n)]).encode()
        if method == "tracetree":
            from ..obs import spans as _sp
            ent = _sp.store().get(params.get("trace_id", ""))
            return json.dumps(ent or {}).encode()
        if method == "tracestream":
            from ..obs.trace import trace_pubsub
            return _stream_pubsub(
                trace_pubsub,
                float(params.get("timeout", "10")),
                int(params.get("count", "1000")),
                to_dict=lambda t: t.to_dict())
        if method == "consolestream":
            from ..obs.logger import log_sys
            return _stream_pubsub(
                log_sys().pubsub,
                float(params.get("timeout", "10")),
                int(params.get("count", "1000")))
        if method == "procinfo":
            from ..obs.profiling import health_info
            srv = getattr(self.node, "server", None)
            if srv is None:
                return b"{}"
            return json.dumps(health_info(srv)).encode()
        if method == "metrics":
            from ..obs.metrics import counters_snapshot
            return json.dumps(counters_snapshot()).encode()
        if method == "getlocks":
            srv = getattr(self.node, "server", None)
            locker = getattr(srv, "local_locker", None)
            return json.dumps(
                locker.dump() if locker is not None else []).encode()
        if method == "getbandwidth":
            from ..bucket.bandwidth import global_monitor
            return json.dumps(global_monitor().report()).encode()
        if method == "consolelog":
            from ..obs.logger import log_sys
            n = int(params.get("n", "100"))
            return json.dumps(list(log_sys().ring)[-n:]).encode()
        if method == "startprofiling":
            from ..obs import profiling
            try:
                profiling.start(params.get("profilerType", "cpu"))
            except ValueError:
                pass  # idempotent across fan-out retries
            return b""
        if method == "downloadprofiling":
            from ..obs import profiling
            try:
                _, data = profiling.stop_and_dump()
            except ValueError:
                data = b""
            return data
        if method == "backgroundhealstatus":
            from ..scanner import background_heal_stats
            srv = getattr(self.node, "server", None)
            return json.dumps(
                background_heal_stats(srv) if srv is not None else {}
            ).encode()
        if method == "healthsnapshot":
            from ..obs.health import node_snapshot
            srv = getattr(self.node, "server", None)
            return json.dumps(
                node_snapshot(srv) if srv is not None else {}).encode()
        if method == "profile":
            from ..obs import profiler
            seconds = float(params.get("seconds", "0") or "0")
            try:
                agg = profiler.capture_window(min(seconds, 60.0)) \
                    if seconds > 0 else profiler.base_agg()
                rep = profiler.report_top(agg)
            except ValueError as e:  # profiler disabled on this node
                rep = {"error": str(e)}
            rep["endpoint"] = self.node.local_url
            return json.dumps(rep).encode()
        if method == "devicestatus":
            from ..obs import device
            rep = device.status(touch_backend=True)
            rep["endpoint"] = self.node.local_url
            return json.dumps(rep).encode()
        if method == "bucketstats":
            from ..obs import bucketstats
            rep = bucketstats.report()
            rep["endpoint"] = self.node.local_url
            return json.dumps(rep).encode()
        if method == "replicateobject":
            return self._replicate_object(params, body)
        if method == "replicatedelete":
            return self._replicate_delete(params)
        if method == "replicationstats":
            rs = getattr(getattr(self.node, "server", None),
                         "replication_sys", None)
            rep = rs.stats() if rs is not None else {}
            rep["endpoint"] = self.node.local_url
            return json.dumps(rep).encode()
        from ..utils import errors
        raise errors.MethodNotSupported(method)

    def _replicate_object(self, params: dict, body: bytes) -> bytes:
        """Target-side replica landing (reference replicateObject's
        target PutObject): write the shipped bytes with the REPLICA
        marker, auto-creating the destination bucket — a rebuilt
        target starts empty and the first replica must not bounce."""
        import io

        from ..bucket.replicate import META_REPLICA, REPLICA
        from ..objectlayer import datatypes as _dt
        from ..objectlayer.datatypes import ObjectOptions
        bucket = params.get("bucket", "")
        key = params.get("object", "")
        meta = json.loads(params.get("meta") or "{}")
        ud = dict(meta.get("user_defined") or {})
        ud[META_REPLICA] = REPLICA
        opts = ObjectOptions(user_defined=ud)
        body = body or b""
        for attempt in range(2):
            try:
                self.node.obj.put_object(bucket, key, io.BytesIO(body),
                                         len(body), opts)
                break
            except _dt.BucketNotFound:
                if attempt:
                    raise
                self.node.obj.make_bucket(bucket)
        return b""

    def _replicate_delete(self, params: dict) -> bytes:
        from ..objectlayer import datatypes as _dt
        bucket = params.get("bucket", "")
        key = params.get("object", "")
        try:
            self.node.obj.delete_object(bucket, key)
        except (_dt.ObjectNotFound, _dt.BucketNotFound):
            pass  # idempotent: journal replay re-sends deletes
        return b""
