"""Cluster health snapshot, the port of minio_tpu/obs/health.py — the
``mc admin top`` / madmin HealthInfo analogue: one JSON document
answering "is every node healthy, are the dispatch lanes busy, is
anything burning error budget".

``node_snapshot`` samples ONE node's live planes (no probes, no I/O
beyond in-memory state):

* disk health tracker states + trip counts (``storage/health.py``),
* dispatch lane utilization + queue depth from the flight recorder
  (``obs/timeline.py``),
* admission saturation — inflight vs capacity, per-class rejects,
* MRF/autoheal backlog (``scanner.background_heal_stats``),
* scanner cycle progress,
* the standing SLO verdicts (``obs/slo.py``).

``cluster_snapshot`` rolls the node snapshots up into cluster verdicts:
disks online/faulty, heal backlog, any class in SLO breach. Served by
``GET /minio/admin/v3/health``. Until the distributed plane is ported a
node has no peers: the ``peers`` block is empty and the cluster is this
node; the QoS scheduler's block (``qos.scheduler``) waits for the
scheduler's port.
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
    out["peers"] = {"rows": [], "total": 0, "unreachable": 0,
                    "degraded": 0}
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
    """Cluster verdict over every node's snapshot. Disk counts are
    deduplicated by endpoint (a node lists every set disk it mounts); a
    disk is faulty when any node's view says so."""
    disks: dict[str, dict] = {}   # endpoint -> merged row
    heal_backlog = 0
    breaches: list[dict] = []
    peers_unreachable = peers_degraded = 0
    for n in nodes:
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
        "nodes_offline": 0,
        "disks_total": len(disks),
        "disks_faulty": disks_faulty,
        "disk_trips_total": sum(d["trips"] for d in disks.values()),
        "peers_unreachable": peers_unreachable,
        "peers_degraded": peers_degraded,
        "heal_backlog": heal_backlog,
        "slo_breaches": breaches,
        "healthy": disks_faulty == 0 and not breaches and
        peers_unreachable == 0 and peers_degraded == 0,
    }


def cluster_snapshot(server) -> dict:
    """The ``GET /minio/admin/v3/health`` payload: this node's snapshot
    and the cluster rollup (``?peers=0``, the JAX server's switch off its
    fan-out, changes nothing here)."""
    nodes = [node_snapshot(server)]
    return {"cluster": _rollup(nodes), "nodes": nodes}
