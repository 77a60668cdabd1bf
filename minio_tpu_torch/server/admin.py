"""Admin API, the port of the ops of minio_tpu/server/admin.py whose planes
are ported (reference cmd/admin-router.go subset). Routes live under
/minio/admin/v3/... and require the root credentials, signed with SigV4
like any S3 request.

Ops: ``info``, ``storageinfo``, ``trace`` (the live JSON-line stream,
``?trace_id=`` for one stored span tree, ``?slow=1`` for the slow-trace
store), ``timeline`` (the flight recorder, ``?attribution=1``,
``?fmt=chrome``), ``top/api``, ``device`` (the device plane,
``?trace=<seconds>`` for one torch.profiler session), ``qos``, the heal
sequences (``heal[/bucket[/prefix]]``: start one, or poll it with
``?clientToken=``, stop it with ``&forceStop=1``), ``datausageinfo``
(``?depth=``: the scanner's snapshot with per-prefix breakdowns) and
``bg-heal-status`` (the auto-heal monitor's and the MRF's stats),
``set-bucket-quota`` / ``get-bucket-quota`` (``?bucket=``, the hard quota
the PUT path checks), ``durability`` (the fsync policy and flusher, the
crash-point catalogue, the ``minio_tpu_durability_*`` counters, the
janitor's last sweep), ``service`` (``?action=restart|stop`` through the
server's ``on_service_signal`` hook, which the CLI installs), and the KMS's
``kms/status``, ``kms/key/create`` and ``kms/key/status`` (``?key-id=``),
the config registry's ``get-config``, ``set-config-kv`` /
``del-config-kv`` (``?subsys=&key=&value=``) and its history
(``list-config-history``, ``restore-config-history?restoreId=``,
``clear-config-history``), the profiler's ``profile`` (``fmt=top|folded|
speedscope``, ``seconds=`` and ``hz=`` for a fresh window, ``breach=<class>``
for a stored breach capture), ``profiling/start`` (``?profilerType=cpu|
mem|threads``), ``profiling/download`` and ``profiling/threads``,
``healthinfo`` / ``obdinfo``, ``top/locks`` (the node's dsync lock
table; empty on a standalone server), the SLO plane's ``slo`` and the health
snapshot ``health``, the fault plane's ``fault`` (GET lists the armed
rules and the disks' health, POST arms one, DELETE ``?id=`` disarms one or,
without an id, clears them all), the bucket analytics report
``bucketstats``, the log rings ``logs`` (``?n=``, ``?type=audit`` for the
audit ring), and, once ``S3Server.enable_iam()`` has run, the IAM ops
(``add-user``, ``remove-user``, ``list-users``, ``set-user-status``,
``add-canned-policy``, ``remove-canned-policy``, ``list-canned-policies``,
``set-user-or-group-policy``, ``add-user-to-group``, ``remove-group``,
``list-groups``, ``add-service-account``), the tier registry's ``tier``
(GET lists the tiers without their secrets, POST adds one from its JSON,
DELETE ``?name=`` removes one), the replication bandwidth report
``bandwidth`` (``?buckets=a,b``) and the cross-node replication plane's
``replication`` (GET its stats and lag verdict, POST ``?resync=<bucket>``
with ``&force=1`` to re-ship everything), with the JAX server's statuses
and JSON bodies.
On a distributed node (``dist/node.py`` sets the server's ``peers``) the
JAX server's fan-outs reach every peer over the peer RPC, with its JSON
keys: ``health`` (unless ``?peers=0``) and ``bg-heal-status`` always,
``bucketstats``, ``device`` and ``profile`` (``fmt=top``) as ``{"nodes":
[...]}`` with ``?peers=1``, ``bandwidth`` (merged per bucket),
``replication`` (a ``peers`` list), ``top/locks`` (merged) and ``trace``
(``?trace_id=`` merges every peer's fragment of the trace; the stream
dumps every peer's ring, then follows their live events) with
``?peers=1``. A peer that fails answers an ``error`` row or is skipped,
as in the JAX server.
Every other admin op (the IAM ops without IAM, update) answers ``501
NotImplemented`` in the reference's error XML: those planes are not
ported.
"""
from __future__ import annotations

import json
import time

from ..objectlayer import datatypes as dt
from .auth import AuthError


def handle_admin(h) -> None:
    """``h`` is the S3 handler. Admin calls authenticate like S3 and must
    carry the root credentials."""
    try:
        ak = h._authenticate()
    except AuthError as e:
        return h._error(e.code, e.message, e.status)
    if h.s3.lookup_secret(ak) != h.s3.secret_key:
        return h._error("AccessDenied", "admin requires root credentials",
                        403)
    path = h.url_path[len("/minio/admin/"):]
    _, _, op = path.partition("/")  # strip the version segment
    try:
        _dispatch_admin(h, op)
    except dt.ObjectAPIError as e:
        h._api_error(e)
    except Exception as e:  # noqa: BLE001 — the boundary: answer 500
        h._error("InternalError", str(e), 500)


def _json(h, obj) -> None:
    h._send(200, json.dumps(obj).encode(), "application/json")


def _fanout(h, call, timeout: float = 10.0) -> list:
    """``call(peer)`` on every peer of the node at once: the answers in
    peer order, an ``{"endpoint", "error"}`` row for a peer that
    failed."""
    import threading
    peers = list(h.s3.peers())
    rows: list = [None] * len(peers)

    def fetch(i, p):
        try:
            rows[i] = call(p)
        except Exception as e:  # noqa: BLE001 — peer down: report it
            rows[i] = {"endpoint": p.url, "error": str(e)}

    threads = [threading.Thread(target=fetch, args=(i, p), daemon=True,
                                name="admin-peer-fanout")
               for i, p in enumerate(peers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    return [r if r is not None else
            {"endpoint": p.url, "error": "peer did not answer"}
            for r, p in zip(rows, peers)]


def _dispatch_admin(h, op: str) -> None:
    if op == "info":
        return _json(h, {"mode": "online", "backend": h.s3.obj.backend_type(),
                         "region": h.s3.region, **h.s3.obj.storage_info()})
    if op == "storageinfo":
        return _json(h, h.s3.obj.storage_info())
    if op == "trace":
        return _trace(h)
    if op == "timeline":
        return _timeline(h)
    if op == "top/api":
        return _top_api(h)
    if op == "device":
        return _device(h)
    if op == "qos":
        # admission in-flight/reject totals and the per-class last-minute
        # latency percentiles
        from ..qos import qos_status
        return _json(h, qos_status(h.s3))
    if op == "heal" or op.startswith("heal/"):
        return _heal(h, op)
    if op == "datausageinfo":
        from ..scanner.usage import data_usage_info
        try:
            depth = int(h.q("depth", "2"))
        except ValueError:
            depth = 2
        return _json(h, data_usage_info(h.s3.obj, depth))
    if op == "bg-heal-status":
        from ..scanner import background_heal_stats
        out = background_heal_stats(h.s3)
        rows = [r for r in _fanout(h, lambda p: p.background_heal_status())
                if "error" not in r]
        if rows:
            out["peers"] = rows
        return _json(h, out)
    if op.startswith("service"):
        return _service(h)
    if op == "set-bucket-quota":
        body = json.loads(h._read_body() or b"{}")
        bucket = h.q("bucket")
        h.s3.obj.get_bucket_info(bucket)
        h.s3.bucket_meta.update(bucket, quota=int(body.get("quota", 0)))
        return _json(h, {})
    if op == "get-bucket-quota":
        meta = h.s3.bucket_meta.get(h.q("bucket"))
        return _json(h, {"quota": meta.quota, "quotatype": "hard"})
    if op == "durability":
        return _durability(h)
    if op == "kms/status":
        from ..crypto import get_kms
        return _json(h, get_kms().info())
    if op == "kms/key/create":
        from ..crypto import KMSError, get_kms
        key_id = h.q("key-id")
        if not key_id:
            return h._error("InvalidArgument", "missing key-id", 400)
        try:
            get_kms().create_key(key_id)
        except KMSError as e:
            return h._error("XMinioKMSError", str(e), 500)
        return _json(h, {})
    if op == "kms/key/status":
        return _kms_key_status(h)
    if op == "health":
        # per-node disk states, lane utilization, admission saturation,
        # heal backlog and SLO verdicts, rolled up
        from ..obs.health import cluster_snapshot
        return _json(h, cluster_snapshot(h.s3,
                                         peers=h.q("peers") != "0"))
    if op == "slo":
        from ..obs import slo
        return _json(h, slo.report())
    if op == "top/locks":
        # the node's dsync lock table, merged across the peers with
        # ?peers=1 (reference TopLocksHandler)
        locker = h.s3.local_locker
        entries = locker.dump() if locker is not None else []
        if h.q("peers") == "1":
            for rows in _fanout(h, lambda p: p.get_locks()):
                if isinstance(rows, list):
                    entries.extend(rows)
        return _json(h, {"locks": entries})
    if op in _CONFIG_OPS:
        return _config_op(h, op)
    if op == "profile":
        return _profile(h)
    if op == "fault":
        return _fault_op(h)
    if op.startswith("profiling/") or op in ("healthinfo", "obdinfo"):
        return _profiling_obd(h, op)
    if op == "bucketstats":
        # the bounded per-bucket registry: requests, traffic, latency,
        # live usage and drift, SLO burn contribution, growth projection;
        # ?peers=1 adds every peer's (each node charges the requests it
        # served)
        from ..obs import bucketstats
        mine = {**bucketstats.report(),
                "endpoint": f"{h.s3.address}:{h.s3.port}"}
        if h.q("peers") != "1":
            return _json(h, mine)
        return _json(h, {"nodes": [mine, *_fanout(
            h, lambda p: p.bucket_stats())]})
    if op == "logs":
        # recent structured log entries; ?type=audit serves the
        # per-request audit ring
        from ..obs.logger import log_sys
        n = int(h.q("n", "100"))
        ring = log_sys().audit_ring if h.q("type") == "audit" \
            else log_sys().ring
        return _json(h, list(ring)[-n:])
    if op == "tier":
        return _tier_op(h)
    if op == "bandwidth":
        return _bandwidth(h)
    if op == "replication":
        return _replication_op(h)
    if _iam_op(h, op):
        return
    h._not_implemented(f"admin {op} is not implemented")


def _bandwidth(h) -> None:
    """The replication bandwidth report (``?buckets=a,b``); ``?peers=1``
    adds every peer's current bandwidth per bucket (reference
    peerRESTMethodGetBandwidth fan-out)."""
    from ..bucket.bandwidth import global_monitor
    buckets = [b for b in h.q("buckets").split(",") if b]
    rep = global_monitor().report(buckets or None)
    if h.q("peers") == "1":
        for theirs in _fanout(h, lambda p: p.get_bandwidth()):
            for b, st in theirs.get("bucketStats", {}).items():
                if buckets and b not in buckets:
                    continue
                mine = rep["bucketStats"].setdefault(
                    b, {"limitInBits": st.get("limitInBits", 0),
                        "currentBandwidth": 0.0})
                mine["currentBandwidth"] = round(
                    mine["currentBandwidth"] +
                    st.get("currentBandwidth", 0.0), 2)
    _json(h, rep)


def _tier_op(h) -> None:
    """The tier registry (reference cmd/tier-handlers.go): GET lists the
    tiers (secrets left out), DELETE ``?name=`` removes one, PUT or POST
    adds one from its JSON (``kind`` ``fs`` with ``dir``, or ``s3`` with
    ``endpoint``, ``bucket``, ``access_key``, ``secret_key`` and the
    optional ``prefix`` and ``region``)."""
    if h.command == "GET":
        return _json(h, h.s3.tiers.list())
    if h.command == "DELETE":
        h.s3.tiers.remove(h.q("name"))
        return _json(h, {})
    body = json.loads(h._read_body() or b"{}")
    from ..bucket.tiers import TierFS, TierS3
    try:
        if body.get("kind") == "fs":
            tier = TierFS(body["name"], body["dir"])
        elif body.get("kind") == "s3":
            tier = TierS3(body["name"], body["endpoint"], body["bucket"],
                          body["access_key"], body["secret_key"],
                          body.get("prefix", ""),
                          body.get("region", "us-east-1"))
        else:
            return h._error("InvalidArgument",
                            f"unknown tier kind {body.get('kind')!r}", 400)
        h.s3.tiers.add(tier)
    except (KeyError, ValueError) as e:
        return h._error("InvalidArgument", str(e), 400)
    return _json(h, {})


def _replication_op(h) -> None:
    """The cross-node replication plane: GET reports its backlog, lag and
    counts (an empty object when the plane is off); POST
    ``?resync=<bucket>`` replays the bucket's backlog against its target
    (``&force=1`` re-ships every object: a target rebuilt from
    scratch)."""
    rs = h.s3.replication_sys
    if h.command == "POST":
        bucket = h.q("resync")
        if not bucket:
            return h._error("InvalidArgument",
                            "resync needs ?resync=<bucket>", 400)
        if rs is None:
            return h._error("InvalidArgument",
                            "replication plane not enabled", 400)
        return _json(h, {"scheduled": rs.resync(
            bucket, force=h.q("force") == "1")})
    out: dict = {}
    if rs is not None:
        out = rs.stats()
        out["lag"] = rs.lag_report()
    if h.q("peers") == "1":
        # replication debt lives on whichever node took the write
        rows = [r for r in _fanout(h, lambda p: p.replication_stats())
                if "error" not in r]
        if rows:
            out["peers"] = rows
    return _json(h, out)


def _iam_op(h, op: str) -> bool:
    """The IAM admin surface (reference admin-handlers-users.go), JSON in
    and out, root credentials only (``handle_admin``); False when IAM is
    off or the op is not one of its."""
    iam = h.s3.iam
    if iam is None:
        return False
    q = {k: v[0] for k, v in h.query.items()}
    out: dict = {}
    if op == "add-user":
        body = json.loads(h._read_body() or b"{}")
        iam.add_user(q["accessKey"], body.get("secretKey", ""),
                     body.get("policies", []))
    elif op == "remove-user":
        iam.remove_user(q["accessKey"])
    elif op == "list-users":
        out = {ak: {"status": u.status, "policies": u.policies,
                    "groups": u.groups, "parent": u.parent}
               for ak, u in iam.users.items()}
    elif op == "set-user-status":
        iam.set_user_status(q["accessKey"], q.get("status", "enabled"))
    elif op == "add-canned-policy":
        iam.set_policy(q["name"], h._read_body())
    elif op == "remove-canned-policy":
        iam.delete_policy(q["name"])
    elif op == "list-canned-policies":
        out = {name: json.loads(p.dump())
               for name, p in iam.policies.items()}
    elif op == "set-user-or-group-policy":
        names = [n for n in q.get("policyName", "").split(",") if n]
        if q.get("isGroup", "") == "true":
            iam.set_group_policy(q["userOrGroup"], names)
        else:
            iam.set_user_policy(q["userOrGroup"], names)
    elif op == "add-user-to-group":
        body = json.loads(h._read_body() or b"{}")
        iam.add_group(body["group"], body.get("members", []))
    elif op == "remove-group":
        iam.remove_group(q["group"])
    elif op == "list-groups":
        out = iam.groups
    elif op == "add-service-account":
        body = json.loads(h._read_body() or b"{}")
        u = iam.new_service_account(body.get("parent", h.s3.access_key),
                                    body.get("policy", "").encode())
        out = {"accessKey": u.access_key, "secretKey": u.secret_key}
    else:
        return False
    _json(h, out)
    return True


_CONFIG_OPS = ("get-config", "set-config-kv", "del-config-kv",
               "list-config-history", "restore-config-history",
               "clear-config-history")


def _config_op(h, op: str) -> None:
    """The config registry (reference admin-handlers-config-kv.go): the
    effective config with each key's source, set/delete of one key, and
    the history of snapshots taken before every change."""
    from ..config import get_config_sys
    cfg = get_config_sys(h.s3.obj)
    q = {k: v[0] for k, v in h.query.items()}
    if op == "get-config":
        return _json(h, cfg.dump())
    if op == "set-config-kv":
        try:
            cfg.set(q["subsys"], q["key"], q.get("value", ""))
        except KeyError as e:
            return h._error("InvalidArgument", str(e), 400)
    elif op == "del-config-kv":
        cfg.delete(q.get("subsys", ""), q.get("key", ""))
    elif op == "list-config-history":
        return _json(h, cfg.list_history())
    elif op == "restore-config-history":
        rid = q.get("restoreId", "")
        if not rid:
            return h._error("InvalidArgument", "missing restoreId", 400)
        try:
            cfg.restore_history(rid)
        except Exception as e:  # noqa: BLE001 — a bad id is the caller's
            return h._error("InvalidArgument", f"restore {rid}: {e}", 400)
    else:  # clear-config-history
        cfg.clear_history()
    _json(h, {})


def _fault_op(h) -> None:
    """The fault-injection control plane: GET lists the armed rules and
    the disks' health states; POST arms one rule (a JSON body
    ``{"rule": "<compact grammar>"}`` or the rule's fields); DELETE
    ``?id=<rule id>`` disarms one, no id clears all."""
    from .. import fault
    if h.command == "GET":
        from ..obs.metrics import _all_disks
        disks = [{"endpoint": d.endpoint(), **d.health_stats()}
                 for d in _all_disks(h.s3.obj) if hasattr(d, "health_stats")]
        return _json(h, {"rules": fault.rules(), "disks": disks})
    if h.command == "DELETE":
        rid = h.q("id")
        if not rid:
            fault.clear()
            return _json(h, {})
        if not fault.disarm(rid):
            return h._error("InvalidArgument", f"unknown fault rule {rid!r}",
                            400)
        return _json(h, {})
    try:
        body = json.loads(h._read_body() or b"{}")
        if "rule" in body:
            rid = fault.arm(body["rule"])
        else:
            rid = fault.arm(fault.FaultRule(**{
                k: v for k, v in body.items()
                if k in ("layer", "target", "op", "action", "error",
                         "delay_ms", "jitter_ms", "prob", "hang_s",
                         "count", "ttl_s", "seed")}))
    except (ValueError, TypeError) as e:
        return h._error("InvalidArgument", f"bad fault rule: {e}", 400)
    _json(h, {"id": rid})


def _profile(h) -> None:
    """The continuous profiler (obs/profiler.py): the always-on sampler's
    aggregate, or a fresh high-rate window. ``fmt=top`` (default, the JSON
    attribution report) | ``folded`` (flamegraph.pl collapsed stacks) |
    ``speedscope``; ``seconds=N`` captures a fresh window at the burst rate
    (``hz=`` overrides); ``breach=<class>`` serves the stored SLO-breach
    capture of that QoS class."""
    from ..obs import profiler
    q = {k: v[0] for k, v in h.query.items()}
    breach_cls = q.get("breach", "")
    if breach_cls:
        rep = profiler.breach_profile(breach_cls)
        if rep is None:
            return h._error(
                "XMinioProfileNotFound",
                f"no stored breach profile for class {breach_cls!r} "
                "(captures are triggered by SLO burn-rate breaches)", 404)
        return _json(h, rep)
    try:
        seconds = float(q.get("seconds", "0"))
        hz = float(q["hz"]) if "hz" in q else None
    except ValueError:
        return h._error("InvalidArgument",
                        "bad seconds/hz profile parameter", 400)
    fmt = q.get("fmt", "top")
    if fmt not in ("top", "folded", "speedscope"):
        return h._error("InvalidArgument", f"unknown profile fmt {fmt!r}",
                        400)
    if not profiler.ensure_started() and seconds > 0:
        # a fresh window against a halted sampler would block the full
        # duration and return an all-zero report
        return h._error("XMinioProfilerDisabled",
                        "profiler.enable=0 — enable the profiler before "
                        "requesting a capture window", 409)
    peer_rows: list = []
    fan = None
    if q.get("peers") == "1" and fmt == "top":
        # the peers capture their windows while this node captures its own
        import threading
        fan = threading.Thread(
            target=lambda: peer_rows.extend(_fanout(
                h, lambda p: p.profile(seconds=seconds),
                timeout=max(10.0, seconds + 10.0))),
            daemon=True, name="admin-profile-fanout")
        fan.start()
    agg = profiler.capture_window(min(seconds, 60.0), hz) if seconds > 0 \
        else profiler.base_agg()
    if fmt == "folded":
        return h._send(200, profiler.render_folded(agg), "text/plain")
    if fmt == "speedscope":
        return h._send(200, profiler.render_speedscope(agg),
                       "application/json")
    rep = profiler.report_top(agg)
    rep["endpoint"] = f"{h.s3.address}:{h.s3.port}"
    if fan is not None:
        fan.join(timeout=max(10.0, seconds + 10.0) + 1.0)
        rep = {"nodes": [rep] + peer_rows}
    _json(h, rep)


def _profiling_obd(h, op: str) -> None:
    """Profiling start/download (reference StartProfilingHandler,
    DownloadProfilingDataHandler), the thread dump, and the OBD health
    report (HealthInfoHandler)."""
    from ..obs import profiling
    if op == "profiling/start":
        try:
            info = profiling.start(h.q("profilerType", "cpu"))
        except ValueError as e:
            return h._error("InvalidArgument", str(e), 400)
        return _json(h, info)
    if op == "profiling/download":
        try:
            kind, data = profiling.stop_and_dump()
        except ValueError as e:
            return h._error("InvalidArgument", str(e), 400)
        return h._send(200, data, "application/octet-stream", headers={
            "Content-Disposition":
                f'attachment; filename="profile-{kind}.txt"'})
    if op == "profiling/threads":
        return h._send(200, profiling.thread_dump(), "text/plain")
    if op in ("healthinfo", "obdinfo"):
        return _json(h, profiling.health_info(h.s3))
    h._not_implemented(f"admin {op} is not implemented")


def _service(h) -> None:
    """Service signals (reference cmd/service.go): restart re-executes the
    process, stop exits. The answer goes out first; the server's
    ``on_service_signal`` hook (the CLI's, or None: acknowledged, nothing
    done) runs 0.2 s later so the socket can flush."""
    action = h.q("action", "restart")
    if action not in ("restart", "stop"):
        return h._error("InvalidArgument",
                        f"unknown service action {action!r}", 400)
    hook = h.s3.on_service_signal
    h._send(200, b"{}", "application/json")
    if hook is not None:
        import threading
        threading.Timer(0.2, hook, args=(action,)).start()


def _durability(h) -> None:
    """The durability plane: the fsync policy and flusher state, the
    crash-point catalogue, the recovery/quarantine/purge counters and the
    janitor's last sweep."""
    from ..obs.metrics import counters_snapshot
    from ..storage import durability
    from ..storage.xlstorage import WRITE_STEPS
    janitor = getattr(h.s3.scanner, "janitor", None)
    counters = {k: v for k, v in counters_snapshot().items()
                if k.startswith("minio_tpu_durability_")}
    _json(h, {**durability.status(), "write_steps": list(WRITE_STEPS),
              "counters": counters,
              "last_sweep": getattr(janitor, "last_stats", {}) or {}})


def _kms_key_status(h) -> None:
    """Round-trip check of a KMS master key (reference
    cmd/admin-handlers.go KMSKeyStatusHandler): generate a data key under
    the key id, unseal it back, and report each step's outcome."""
    from ..crypto import get_kms
    kms = get_kms()
    key_id = h.q("key-id") or kms.key_id
    status: dict = {"key-id": key_id}
    try:
        dk, blob = kms.generate_key("admin-kms-check", key_id=key_id)
        status["encryption-err"] = ""
    except Exception as e:  # noqa: BLE001 — reported, not raised
        status["encryption-err"] = str(e)
        return _json(h, status)
    try:
        dk2 = kms.unseal(blob, "admin-kms-check", key_id=key_id)
        status["decryption-err"] = "" if dk2 == dk else \
            "decrypted key does not match generated key"
    except Exception as e:  # noqa: BLE001
        status["decryption-err"] = str(e)
    _json(h, status)


def _heal(h, op: str) -> None:
    """Heal sequences (reference admin-heal-ops.go): a call starts a
    background sequence (or re-attaches to the running one of the same
    path) and returns its token and snapshot; ``?clientToken=<t>`` polls
    it, ``&forceStop=1`` stops it."""
    parts = op.split("/")  # heal[/bucket[/prefix...]]
    bucket = parts[1] if len(parts) > 1 else ""
    prefix = "/".join(parts[2:]) if len(parts) > 2 else ""
    mgr = h.s3._heal_seqs
    token = h.q("clientToken")
    if token:
        seq = mgr.get(token)
        if seq is None:
            return h._error("InvalidArgument", "unknown heal token", 400)
        if h.q("forceStop") == "1":
            seq.stop()
        return _json(h, seq.summary())
    try:
        seq = mgr.start(bucket, prefix, dry_run=h.has_q("dryRun"))
    except ValueError as e:
        return h._error("XMinioHealOverlappingPaths", str(e), 409)
    # give short sequences a moment so small heals return complete
    deadline = time.monotonic() + 2.0
    while seq.status == "running" and time.monotonic() < deadline:
        time.sleep(0.05)
    _json(h, seq.summary())


def _device(h) -> None:
    """Device plane (obs/device.py): per-lane live-buffer ledger, builds
    and first launches, per-op seconds of the flushes' CUDA-event
    intervals with the GiB/s and roofline ratios over them, the streams'
    occupancy, the caching allocator's memory. ``trace=<seconds>``
    additionally runs one torch.profiler session and returns its logdir
    and the card's own busy and idle share under ``trace``."""
    from ..obs import device
    q = {k: v[0] for k, v in h.query.items()}
    rep = device.status(touch_backend=True)
    rep["endpoint"] = f"{h.s3.address}:{h.s3.port}"
    if "trace" in q:
        try:
            seconds = float(q["trace"])
        except ValueError:
            return h._error("InvalidArgument",
                            "bad trace seconds parameter", 400)
        rep["trace"] = device.capture_trace(seconds)
    if q.get("peers") == "1":
        rep = {"nodes": [rep, *_fanout(h, lambda p: p.device_status())]}
    _json(h, rep)


def _parse_duration(s: str) -> float:
    """Duration query param -> seconds: bare float seconds or with an
    us/ms/s suffix (madmin-style '?threshold=100ms')."""
    s = s.strip().lower()
    if not s:
        return 0.0
    for suf, mult in (("us", 1e-6), ("ms", 1e-3), ("s", 1.0)):
        if s.endswith(suf):
            return float(s[:-len(suf)]) * mult
    return float(s)


def _trace_filter(q: dict):
    """Predicate over trace dicts from ?type= (csv of
    http|storage|kernel|scanner, or 'all'; default http), ?threshold=<dur>
    (only events at least this slow) and ?err=1 (only failures: error set
    or status >= 400). Raises ValueError on an unknown type so a typo gets
    a 400 instead of a silent empty stream."""
    from ..obs.trace import TRACE_TYPES
    types = {t for t in q.get("type", "").split(",") if t}
    unknown = types - set(TRACE_TYPES) - {"all"}
    if unknown:
        raise ValueError(f"unknown trace type {sorted(unknown)!r}")
    if not types:
        types = {"http"}
    if "all" in types:
        types = None
    threshold = _parse_duration(q.get("threshold", ""))
    err_only = q.get("err") == "1"

    def want(d: dict) -> bool:
        if types is not None and d.get("trace_type", "http") not in types:
            return False
        if threshold and d.get("duration_s", 0.0) < threshold:
            return False
        if err_only and not (d.get("error") or d.get("status", 0) >= 400):
            return False
        return True

    return want


def _trace_tree(h, q: dict) -> None:
    """Stored span tree by trace id (tail-sampled slow/error traces and
    RPC fragments): ?trace_id=<id>, with ?peers=1 merging every peer's
    fragment of the same trace into one tree."""
    from ..obs import spans as sp
    tid = q.get("trace_id", "")
    entry = sp.store().get(tid)
    spans_list = list(entry.get("spans", ())) if entry else []
    meta = {k: v for k, v in (entry or {}).items() if k != "spans"}
    if q.get("peers") == "1":
        for frag in _fanout(h, lambda p: p.trace_tree(tid)):
            if not frag or "error" in frag:
                continue
            spans_list.extend(frag.get("spans", ()))
            if not meta:
                meta = {k: v for k, v in frag.items() if k != "spans"}
        # a kept trace already holds the fragments it collected: dedup by
        # span id, first occurrence kept
        seen: set = set()
        spans_list = [s for s in spans_list
                      if not (s.get("span_id", "") in seen
                              or seen.add(s.get("span_id", "")))]
    if not spans_list:
        return h._error("XMinioTraceNotFound",
                        f"no stored trace {tid!r} (only slow/error "
                        "traces and RPC fragments are kept)", 404)
    _json(h, {**meta, "trace_id": tid, "spans": spans_list,
              "tree": sp.assemble(spans_list)})


def _trace_slow(h, q: dict) -> None:
    """Newest-first summaries of the slow-trace store (?slow=1&count=N):
    requests that breached their QoS class budget or errored; fetch a
    full tree with ?trace_id=."""
    from ..obs import spans as sp
    try:
        n = int(q.get("count", "50"))
    except ValueError:
        n = 50
    _json(h, sp.store().list_slow(n))


def _trace(h) -> None:
    """`mc admin trace` analogue: streams JSON-line trace events — the
    newest matches of the ring, then live events — bounded by ?count and
    ?timeout; ?type/?threshold/?err filter both. ?peers=1 dumps every
    peer's ring first and follows their live events too (one streaming
    peer RPC each). ?trace_id= returns one stored span tree, ?slow=1
    lists the slow-trace store."""
    import queue as qmod
    import threading
    import time as _t

    from ..obs.trace import recent, trace_pubsub
    from .s3api import _ChunkedWriter
    q = {k: v[0] for k, v in h.query.items()}
    if q.get("trace_id"):
        return _trace_tree(h, q)
    if q.get("slow") == "1":
        return _trace_slow(h, q)
    try:
        count = int(q.get("count", "50"))
        timeout = float(q.get("timeout", "10"))
        want = _trace_filter(q)
    except ValueError as e:
        return h._error("InvalidArgument", f"bad trace query: {e}", 400)
    peers = list(h.s3.peers()) if q.get("peers") == "1" else []
    merged: qmod.Queue = qmod.Queue(maxsize=2048)
    # subscribe before the ring dump so no event falls between the two
    sub = trace_pubsub.subscribe()
    try:
        h.send_response(200)
        h.send_header("Content-Type", "application/x-ndjson")
        h.send_header("Transfer-Encoding", "chunked")
        h.end_headers()
        out = _ChunkedWriter(h.wfile)
        sent = 0
        for peer in peers:
            try:
                ring = peer.trace_recent()
            except Exception:  # noqa: BLE001 — peer down: skip it
                continue
            for d in ring:
                if want(d):
                    out.write((json.dumps(d) + "\n").encode())
                    sent += 1
        # filter over the FULL ring, then keep the newest `count` matches
        hist = [d for d in (t.to_dict() for t in recent()) if want(d)]
        for d in hist[max(0, len(hist) - max(0, count - sent)):]:
            out.write((json.dumps(d) + "\n").encode())
            sent += 1
        if sent < count:
            for peer in peers:
                threading.Thread(
                    target=_pump_trace, daemon=True,
                    args=(peer, timeout, count - sent, want, merged),
                    name="admin-trace-pump").start()
        deadline = _t.monotonic() + timeout
        while sent < count and _t.monotonic() < deadline:
            try:
                while sent < count:
                    out.write((json.dumps(merged.get_nowait())
                               + "\n").encode())
                    sent += 1
            except qmod.Empty:
                pass
            if sent >= count:
                break
            try:
                d = sub.get(timeout=0.05 if peers else 0.2).to_dict()
            except qmod.Empty:
                continue
            if want(d):
                out.write((json.dumps(d) + "\n").encode())
                sent += 1
        out.close()
    except (BrokenPipeError, ConnectionResetError, OSError):
        # the client hung up mid-stream: the normal end of a follow
        h.close_connection = True
    finally:
        trace_pubsub.unsubscribe(sub)


def _pump_trace(peer, timeout: float, budget: int, want, merged) -> None:
    """One peer's live trace events into the merged queue of a follow.
    Never blocks: a slow or gone consumer drops events (trace is lossy by
    design, as the pubsub is), counted like the pubsub's drops."""
    import queue as qmod

    from ..obs import metrics as mx
    try:
        for d in peer.trace_stream(timeout_s=timeout, count=budget):
            if not want(d):
                continue
            try:
                merged.put_nowait(d)
            except qmod.Full:
                mx.inc("minio_tpu_trace_dropped_total",
                       reason="slow_subscriber")
    except Exception:  # noqa: BLE001 — the peer died mid-stream
        mx.inc("minio_tpu_trace_dropped_total", reason="peer_stream_error")


def _timeline(h) -> None:
    """The dispatch flight recorder: the event ring + per-lane
    utilization. ``since=<monotonic seconds>`` filters to newer events
    (pair with the returned ``now``), ``count=N`` keeps the newest N,
    ``fmt=chrome`` exports Chrome-trace/Perfetto JSON instead,
    ``attribution=1`` embeds the standing per-op stage breakdown."""
    import time as _t

    from ..obs import attribution, timeline
    q = {k: v[0] for k, v in h.query.items()}
    try:
        since = float(q.get("since", "0"))
    except ValueError:
        return h._error("InvalidArgument",
                        f"bad since {q.get('since')!r}", 400)
    try:
        count = int(q.get("count", "0"))
    except ValueError:
        count = 0
    if q.get("fmt") == "chrome":
        return _json(h, timeline.export_chrome(since, count))
    out = {"now": _t.monotonic(), **timeline.status(),
           "utilization": timeline.utilization(),
           "events": timeline.snapshot(since, count)}
    if q.get("attribution") == "1":
        out["attribution"] = attribution.report()
    _json(h, out)


def _top_api(h) -> None:
    """`mc admin top api` analogue: per-API call counts and latency
    percentiles from the request histograms the handler records, and per
    S3 API name the worst last-minute sample with its trace id."""
    from ..obs import latency as lat
    from ..obs import spans as sp
    from ..obs.metrics import counters_snapshot, histograms_snapshot
    out: dict = {}

    def labels(key: str) -> dict:
        if "{" not in key:
            return {}
        return {k: v.strip('"') for k, _, v in
                (p.partition("=") for p in key[key.index("{") + 1:-1]
                 .split(","))}

    for key, v in counters_snapshot().items():
        if not key.startswith("minio_tpu_requests_total"):
            continue
        lab = labels(key)
        entry = out.setdefault(lab.get("api") or "unknown",
                               {"calls": 0, "errors": 0})
        entry["calls"] += int(v)
        if lab.get("code") and not lab["code"].startswith("2"):
            entry["errors"] += int(v)
    for key, vals in histograms_snapshot().items():
        if not key.startswith("minio_tpu_request_duration_seconds") or \
                not vals:
            continue
        api = labels(key).get("api", "unknown")
        vals.sort()
        entry = out.setdefault(api, {"calls": len(vals), "errors": 0})
        entry["p50_ms"] = round(vals[len(vals) // 2] * 1e3, 2)
        entry["p99_ms"] = round(vals[min(len(vals) - 1,
                                         int(len(vals) * 0.99))] * 1e3, 2)
        entry["max_ms"] = round(vals[-1] * 1e3, 2)
    for lab, w in lat.snapshot("api"):
        st = w.stats(())
        worst_tid = st["worst_trace_id"]
        if not worst_tid:
            continue
        entry = out.setdefault(lab.get("api", ""),
                               {"calls": st["count"], "errors": 0})
        entry["worst_ms"] = round(st["worst_s"] * 1e3, 2)
        entry["worst_trace_id"] = worst_tid
        entry["worst_trace_stored"] = sp.store().contains(worst_tid)
    _json(h, out)
