"""Cluster health snapshot, the port of minio_tpu/obs/health.py — the
``mc admin top`` / madmin HealthInfo analogue: one JSON document
answering "is every node healthy, are the dispatch lanes busy, is
anything burning error budget".

``node_snapshot`` samples ONE node's live planes (no probes, no I/O
beyond in-memory state):

* disk health tracker states + trip counts (``storage/health.py``),
* per-peer RPC health (``dist/rpc.py`` client scores: online flag,
  success-latency EWMA, failure streaks) — partition and slow-peer
  injections land HERE, so a sick peer degrades the snapshot even when
  every local disk is fine,
* dispatch lane utilization + queue depth from the flight recorder
  (``obs/timeline.py``),
* admission saturation — inflight vs capacity, per-class rejects,
* MRF/autoheal backlog (``scanner.background_heal_stats``),
* scanner cycle progress,
* the standing SLO verdicts (``obs/slo.py``).

``cluster_snapshot`` merges the local snapshot with every dist peer's
(``PeerRESTClient.health_snapshot`` — a peer down becomes an ``error``
row, never a failed call) and rolls the per-node state up into cluster
verdicts: disks online/faulty, heal backlog, any class in SLO breach.
Served by ``GET /minio/admin/v3/health``. The QoS scheduler's block
(``qos.scheduler``) waits for the scheduler's port.
"""
from __future__ import annotations

import time


def _disk_rows(server) -> list[dict]:
    from .metrics import _all_disks
    rows = []
    for d in _all_disks(server.obj):
        stats_fn = getattr(d, "health_stats", None)
        if stats_fn is None:
            rows.append({"endpoint": d.endpoint(), "state": "untracked"})
            continue
        try:
            rows.append({"endpoint": d.endpoint(), **stats_fn()})
        except Exception:  # noqa: BLE001 — one disk row must not kill
            continue      # the snapshot
    return rows


def _peer_rows(server) -> dict:
    """This node's live view of every dist peer, from the RPC client
    health scores (no probe I/O): a peer whose control-plane OR
    storage-plane client is offline/degraded shows up within one
    probe interval of the wire noticing. Rows merge the peer client
    and any storage clients pointing at the same node URL."""
    rows: dict[str, dict] = {}
    for peer in getattr(server, "peers", lambda: [])():
        rpc = getattr(peer, "rpc", None)
        if rpc is None:
            continue
        rows[getattr(peer, "url", rpc.base)] = dict(rpc.health_stats())
    # storage REST clients carry the data-plane view of the same peers
    # (disks ride health wrappers — unwrap to reach the RPC client)
    from .metrics import _all_disks
    for d in _all_disks(server.obj):
        inner = getattr(d, "inner", d)
        rpc = getattr(inner, "rpc", None)
        if rpc is None or getattr(inner, "is_local", lambda: True)():
            continue
        row = rows.get(rpc.base)
        st = rpc.health_stats()
        if row is None:
            rows[rpc.base] = dict(st)
            continue
        # the worse verdict wins per field
        row["online"] = row["online"] and st["online"]
        row["degraded"] = row["degraded"] or st["degraded"]
        row["ewma_ms"] = max(row["ewma_ms"], st["ewma_ms"])
        row["failures_total"] += st["failures_total"]
        row["consecutive_failures"] = max(row["consecutive_failures"],
                                          st["consecutive_failures"])
        row["reconnects_total"] += st["reconnects_total"]
    out_rows = [{"url": u, **r} for u, r in sorted(rows.items())]
    return {
        "rows": out_rows,
        "total": len(out_rows),
        "unreachable": sum(1 for r in out_rows if not r["online"]),
        "degraded": sum(1 for r in out_rows if r["degraded"]),
    }


def node_snapshot(server) -> dict:
    """One node's live health planes as a JSON-able dict."""
    from . import slo, timeline
    from ..scanner import background_heal_stats
    out: dict = {
        "endpoint": f"{server.address}:{server.port}",
        "ts": time.time(),
    }
    disks = _disk_rows(server)
    out["disks"] = {
        "rows": disks,
        "total": len(disks),
        "faulty": sum(1 for d in disks if d.get("state") == "faulty"),
        "trips_total": sum(int(d.get("trips", 0)) for d in disks),
    }
    out["peers"] = _peer_rows(server)
    util = timeline.utilization()
    out["lanes"] = util["lanes"]
    out["queue_depth"] = util["queue_depth"]
    st = server.qos_admission.stats()
    st["saturation"] = round(
        st["inflight_total"] / max(1, st["max_requests"]), 4)
    out["qos"] = {"admission": st}
    out["heal"] = background_heal_stats(server)
    scanner = server.scanner
    if scanner is not None:
        out["scanner"] = {
            "cycle": getattr(scanner, "cycle", 0),
            "interval_s": getattr(scanner, "interval", 0),
        }
    out["slo"] = slo.report()
    return out


def _rollup(nodes: list[dict]) -> dict:
    """Cluster verdict over every reachable node's snapshot. Disk counts
    are deduplicated by endpoint (a node lists every set disk it mounts,
    local and remote clients sharing the ``http://host:port/path``
    endpoint string); a disk is faulty when any node's view says so."""
    disks: dict[str, dict] = {}   # endpoint -> merged row
    heal_backlog = 0
    breaches: list[dict] = []
    peers_unreachable = peers_degraded = 0
    for n in nodes:
        if "error" in n:
            continue
        for row in n.get("disks", {}).get("rows", []):
            ep = row.get("endpoint", "")
            cur = disks.setdefault(ep, {"faulty": False, "trips": 0})
            if row.get("state") == "faulty":
                cur["faulty"] = True
            cur["trips"] = max(cur["trips"], int(row.get("trips", 0)))
        peers = n.get("peers", {})
        peers_unreachable += int(peers.get("unreachable", 0))
        peers_degraded += int(peers.get("degraded", 0))
        mrf = n.get("heal", {}).get("mrf", {})
        heal_backlog += int(mrf.get("queued", 0))
        for cls, ent in n.get("slo", {}).get("classes", {}).items():
            for kind, hit in ent.get("breach", {}).items():
                if hit:
                    row = {"node": n.get("endpoint", ""),
                           "class": cls, "slo": kind}
                    # the top offending bucket of the slo report's
                    # attribution: the verdict points at a tenant
                    tops = ent.get("top_buckets", {}).get(kind) or []
                    if tops:
                        row["top_bucket"] = tops[0].get("bucket", "")
                        row["top_bucket_share"] = tops[0].get("share", 0.0)
                    breaches.append(row)
    disks_faulty = sum(1 for d in disks.values() if d["faulty"])
    return {
        "nodes": len(nodes),
        "nodes_offline": sum(1 for n in nodes if "error" in n),
        "disks_total": len(disks),
        "disks_faulty": disks_faulty,
        "disk_trips_total": sum(d["trips"] for d in disks.values()),
        "peers_unreachable": peers_unreachable,
        "peers_degraded": peers_degraded,
        "heal_backlog": heal_backlog,
        "slo_breaches": breaches,
        "healthy": disks_faulty == 0 and not breaches and
        peers_unreachable == 0 and peers_degraded == 0 and
        not any("error" in n for n in nodes),
    }


def cluster_snapshot(server, peers: bool = True) -> dict:
    """The ``GET /minio/admin/v3/health`` payload: this node's snapshot,
    every peer's (when ``peers``), and the cluster rollup."""
    nodes = [node_snapshot(server)]
    if peers:
        for peer in server.peers():
            try:
                nodes.append(peer.health_snapshot())
            except Exception as e:  # noqa: BLE001 — peer down: report
                nodes.append({"endpoint": getattr(peer, "url", ""),
                              "error": str(e)})
    return {"cluster": _rollup(nodes), "nodes": nodes}
