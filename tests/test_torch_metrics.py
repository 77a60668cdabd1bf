"""The port's metrics and admin observability planes (minio_tpu_torch.obs.
metrics, minio_tpu_torch.server.admin) on the CPU, held to the JAX
package's server after the same signed requests: the port's exposition
passes the naming lint of tests/test_obs_naming.py, every family both
servers emit has the same TYPE and label names, and the families only one
side emits are pinned here with the reason for each. Then the admin ops
the port serves (trace tree with the kernel span linked to its request,
timeline, device, top/api, qos, info) and the ones it answers 501. The
config, profiler, SLO and health ops are held to the JAX server in
tests/test_torch_config.py, test_torch_profiler.py and test_torch_slo.py."""
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from s3client import S3Client  # noqa: E402

AK, SK = "mtak", "mt-secret-key"
SEED = 20261017
NAME_RE = re.compile(r"^minio_tpu_[a-z0-9]+(_[a-z0-9]+)*$")
HIST_SUFFIXES = ("_bucket", "_count", "_sum")

_NOT_PORTED = {
    "the QoS scheduler (spill to the CPU, deadline sizing, lane model)": (
        "minio_tpu_lane_backlog_seconds",
        "minio_tpu_lane_deadline_cuts_total",
        "minio_tpu_lane_queued_bytes", "minio_tpu_qos_class_items_total",
        "minio_tpu_qos_deadline_misses_total",
        "minio_tpu_qos_device_queued_bytes",
        "minio_tpu_qos_lane_diverts_total",
        "minio_tpu_qos_spilled_batches_total",
        "minio_tpu_qos_spilled_items_total",
        "minio_tpu_qos_spill_reason_total",
        "minio_tpu_device_lane_queued_bytes"),
    "input donation (the port donates no buffers)": (
        "minio_tpu_device_obs_ledger_donated_total",),
    "the native PUT and GET routes": (
        "minio_tpu_pipeline_get_blocks_total",),
    "the scan lane's gauge (the port has no workloads.scan switch)": (
        "minio_tpu_workloads_scan_lane",),
}
#: families the JAX server may emit and the port does not, with the reason
JAX_ONLY = {fam: f"not ported: {why}" for why, fams in _NOT_PORTED.items()
            for fam in fams}
#: families only the port emits, with the reason
PORT_ONLY = {
    "minio_tpu_device_obs_first_launches_total":
        "first launches per (op, shape) stand in for the JAX package's "
        "per-signature compile rows",
    "minio_tpu_device_obs_stream_occupancy_ratio":
        "the streams' occupancy by the flushes' CUDA-event intervals (on a "
        "card only)",
}
#: the JAX server on its dispatch routes, as the port's only routes
DISPATCH_ENV = {"MINIO_TPU_DISPATCH_MODE": "cpu",
                "MINIO_TPU_PUT_PATH": "dispatch",
                "MINIO_TPU_GET_PATH": "dispatch"}
#: the probe's interactive budget, above either server's slowest request
#: (the port's CPU PUT takes ~1.6 s): no request of the probe crosses it,
#: so neither scrape carries a family that only a budget crossing emits
#: (the stored trace's minio_tpu_slo_worst_breach_seconds, a bucket's
#: latency minio_tpu_bucket_slo_bad_total), whichever side ran slower
PROBE_BUDGET_MS = "600000"


def _sample_name(line: str) -> str:
    cut = len(line)
    for sep in ("{", " "):
        i = line.find(sep)
        if i != -1:
            cut = min(cut, i)
    return line[:cut]


def lint(text: str) -> dict[str, tuple[str, frozenset]]:
    """tests/test_obs_naming.py's lint over one exposition; returns
    {family: (type, label names)}."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    assert lines
    helps: dict[str, int] = {}
    types: dict[str, tuple[int, str]] = {}
    samples: list[tuple[int, str, str]] = []
    for i, ln in enumerate(lines):
        if ln.startswith("# HELP "):
            helps.setdefault(ln.split()[2], i)
            continue
        if ln.startswith("# TYPE "):
            fam = ln.split()[2]
            assert fam not in types, f"duplicate # TYPE for {fam}"
            assert ln.split()[3] in ("gauge", "counter", "histogram",
                                     "summary", "untyped"), ln
            types[fam] = (i, ln.split()[3])
            continue
        assert not ln.startswith("#"), f"unknown comment line: {ln}"
        samples.append((i, _sample_name(ln), ln))
    hist = {n[:-len("_bucket")] for _, n, _ in samples
            if n.endswith("_bucket")}

    def family(name: str) -> str:
        for suf in HIST_SUFFIXES:
            if name.endswith(suf) and name[:-len(suf)] in hist:
                return name[:-len(suf)]
        return name

    fams: dict[str, set] = {}
    for i, name, ln in samples:
        fam = family(name)
        assert NAME_RE.match(fam), f"not snake_case/minio_tpu_: {name}"
        assert fam in types and fam in helps, f"{name} lacks TYPE/HELP"
        assert types[fam][0] < i and helps[fam] < i, name
        labels = set(re.findall(r'([a-z_]+)="', ln.split(" ", 1)[0]
                                if "{" in ln.split(" ", 1)[0] else ""))
        labels.discard("le")
        labels.discard("quantile")
        fams.setdefault(fam, set()).update(labels)
    return {f: (types[f][1], frozenset(fams.get(f, ())))
            for f in types if f in fams}


def _server(pkg: str, root):
    if pkg == "port":
        from minio_tpu_torch.objectlayer import ErasureObjects
        from minio_tpu_torch.server import S3Server
        from minio_tpu_torch.storage import XLStorage
        obj = ErasureObjects([XLStorage(str(root / f"d{i}"))
                              for i in range(6)], default_parity=2,
                             block_size=1 << 16, device="cpu")
        srv = S3Server(obj, "127.0.0.1", 0, access_key=AK, secret_key=SK,
                       device="cpu")
    else:
        from minio_tpu.objectlayer import ErasureObjects
        from minio_tpu.server import S3Server
        from minio_tpu.storage import XLStorage
        obj = ErasureObjects([XLStorage(str(root / f"d{i}"))
                              for i in range(6)], default_parity=2,
                             block_size=1 << 16)
        srv = S3Server(obj, "127.0.0.1", 0, access_key=AK, secret_key=SK)
    srv.start_background()
    return srv


BODY = np.random.default_rng(SEED).integers(0, 256, 150_001,
                                            dtype=np.uint8).tobytes()


def _drive(srv) -> S3Client:
    """The same signed requests on either server: a bucket, a PUT, a GET,
    a ranged GET, a miss, a listing, a HEAD."""
    c = S3Client(srv.endpoint(), AK, SK)
    assert c.request("PUT", "/mb").status_code == 200
    assert c.request("PUT", "/mb/o", body=BODY).status_code == 200
    assert c.request("GET", "/mb/o").content == BODY
    assert c.request("GET", "/mb/o", headers={"Range": "bytes=7-70000"}
                     ).content == BODY[7:70001]
    assert c.request("GET", "/mb/missing").status_code == 404
    assert c.request("GET", "/mb").status_code == 200
    assert c.request("HEAD", "/mb/o").status_code == 200
    return c


#: both servers' scrapes in a fresh interpreter: families appear as
#: earlier tests in a process leave state (windows, counters, queues), so
#: the comparison runs where only these requests have been made
_PROBE = r"""
import json, pathlib, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
import test_torch_metrics as t
out = {}
for pkg in ("jax", "port"):
    srv = t._server(pkg, pathlib.Path(sys.argv[2]) / pkg)
    c = t._drive(srv)
    out[pkg] = {scope: c.request("GET", f"/minio/v2/metrics/{scope}",
                                 query={"attribution": "1"}).content.decode()
                for scope in ("node", "cluster")}
    srv.shutdown()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def scrapes(tmp_path_factory):
    """Each server's node and cluster scrapes (attribution on) after the
    same requests, from a fresh interpreter (the JAX server on its
    dispatch routes), and an in-process port server driven alike for the
    admin tests."""
    import pathlib
    import subprocess
    root = tmp_path_factory.mktemp("metrics")
    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, **DISPATCH_ENV, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(here.parent),
               MINIO_TPU_QOS_INTERACTIVE_BUDGET_MS=PROBE_BUDGET_MS)
    r = subprocess.run([sys.executable, "-c", _PROBE, str(here),
                        str(root / "fresh")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.splitlines()[-1])
    # the port's bucket registry is process-wide: buckets of earlier tests
    # in this worker would fold this server's bucket into _overflow_
    from minio_tpu_torch.obs import bucketstats
    bucketstats.reset()
    srv = _server("port", root / "port")
    out["srv"], out["client"] = srv, _drive(srv)
    yield out
    srv.shutdown()
    bucketstats.reset()


@pytest.mark.parametrize("scope", ["node", "cluster"])
def test_port_exposition_passes_the_naming_lint(scrapes, scope):
    fams = lint(scrapes["port"][scope])
    for need in ("minio_tpu_kernel_op_latency_seconds",
                 "minio_tpu_lane_flushes_total",
                 "minio_tpu_dispatch_batches_total",
                 "minio_tpu_device_hbm_used",
                 "minio_tpu_qos_admission_inflight",
                 "minio_tpu_disk_latency_seconds",
                 "minio_tpu_stage_share_of_wall",
                 "minio_tpu_requests_total"):
        assert need in fams, need
    if scope == "cluster":
        assert "minio_tpu_cluster_disk_online_total" in fams


@pytest.mark.parametrize("scope", ["node", "cluster"])
def test_shared_families_have_the_same_type_and_labels(scrapes, scope):
    """Every family both servers emit has the same TYPE and label names;
    every family one side lacks is pinned with its reason."""
    jf, pf = lint(scrapes["jax"][scope]), lint(scrapes["port"][scope])
    for fam in sorted(set(jf) & set(pf)):
        assert pf[fam] == jf[fam], fam
    assert set(jf) - set(pf) <= set(JAX_ONLY), \
        sorted(set(jf) - set(pf) - set(JAX_ONLY))
    assert set(pf) - set(jf) <= set(PORT_ONLY), \
        sorted(set(pf) - set(jf) - set(PORT_ONLY))
    # the data path's families are on both sides
    for fam in ("minio_tpu_kernel_op_latency_seconds",
                "minio_tpu_lane_flushes_total",
                "minio_tpu_dispatch_batches_total",
                "minio_tpu_device_busy_ratio",
                "minio_tpu_qos_class_latency_seconds",
                "minio_tpu_pipeline_etag_total",
                "minio_tpu_disk_state", "minio_tpu_durability_fsync_mode",
                "minio_tpu_durability_recovery_runs_total"):
        assert fam in jf and fam in pf, fam
    if scope == "cluster":
        for fam in ("minio_tpu_cluster_usage_object_total",
                    "minio_tpu_heal_disks_healing"):
            assert fam in jf and fam in pf, fam


def test_scrape_never_initialises_cuda(scrapes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the card tests check this")
    assert not torch.cuda.is_initialized()
    assert "minio_tpu_device_hbm_bytes_in_use" not in scrapes["port"]["node"]


def _admin(c, op, **query):
    return c.request("GET", f"/minio/admin/v3/{op}", query=query or None)


def test_trace_tree_holds_the_kernel_span_of_its_request(scrapes):
    """A slow PUT's tree, fetched by its request id: the root, the object
    layer's span, storage spans and kernel spans whose links name the
    request's spans."""
    c = scrapes["client"]
    r = c.request("PUT", "/mb/traced", body=BODY)
    rid = r.headers["x-amz-request-id"]
    tree = _admin(c, "trace", trace_id=rid)
    if tree.status_code == 404:
        pytest.fail("the PUT's trace was not kept (it took "
                    f"{r.elapsed.total_seconds()} s)")
    t = tree.json()
    names = [s["name"] for s in t["spans"]]
    assert "s3.putobject" in names and "objectlayer.put_object" in names
    assert any(n.startswith("storage.") for n in names)
    kernels = [s for s in t["spans"] if s["name"].startswith("kernel.")]
    assert kernels
    ids = {s["span_id"] for s in t["spans"]}
    for k in kernels:
        assert {ln["trace_id"] for ln in k["links"]} == {rid}
        assert {ln["span_id"] for ln in k["links"]} <= ids
    assert len(t["tree"]) == 1 and t["tree"][0]["name"] == "s3.putobject"
    slow = _admin(c, "trace", slow="1").json()
    assert rid in {e["trace_id"] for e in slow}


def test_trace_stream_and_filters(scrapes):
    c = scrapes["client"]
    r = _admin(c, "trace", count="3", timeout="0.2", type="http,storage")
    assert r.status_code == 200
    events = [json.loads(ln) for ln in r.content.splitlines() if ln]
    assert 1 <= len(events) <= 3
    assert {e["trace_type"] for e in events} <= {"http", "storage"}
    assert _admin(c, "trace", type="nope").status_code == 400


def test_timeline_device_top_qos_and_info(scrapes):
    c = scrapes["client"]
    tl = _admin(c, "timeline", attribution="1").json()
    assert tl["enabled"] and tl["events"]
    assert set(tl["utilization"]["lanes"]) <= {"bulk", "interactive"}
    assert tl["utilization"]["lanes"]["bulk"]["flushes"] >= 1
    assert {"put", "get"} <= set(tl["attribution"])
    chrome = _admin(c, "timeline", fmt="chrome").json()
    assert any(e["ph"] == "X" for e in chrome["traceEvents"])
    dev = _admin(c, "device").json()
    assert dev["ledger_balanced"] and dev["card"] == ""
    assert dev["compile"]["first_launches_total"] >= 1
    assert all(r["roofline_ratio"] is None for r in dev["roofline"].values())
    top = _admin(c, "top/api").json()
    assert top["s3.PUT"]["calls"] >= 1 and "p99_ms" in top["s3.GET"]
    qos = _admin(c, "qos").json()
    assert qos["admission"]["max_requests"] == 256
    assert qos["classes"]["interactive"]["last_minute"] >= 1
    info = _admin(c, "info").json()
    assert info["disks_online"] == 6 and info["backend"] == "Erasure"
    assert _admin(c, "storageinfo").json()["disks_online"] == 6


@pytest.mark.parametrize("op,query", [
    ("list-users", {}), ("update", {})], ids=["list-users", "update"])
def test_unported_admin_ops_answer_not_implemented(scrapes, op, query):
    """Ops of planes the port has not: the IAM ops on a server without
    IAM (as the JAX server answers) and the update plane."""
    r = _admin(scrapes["client"], op, **query)
    assert r.status_code == 501
    assert b"<Code>NotImplemented</Code>" in r.content


@pytest.mark.parametrize("op", ["bucketstats", "replication", "bandwidth"],
                         ids=["bucketstats", "replication-peers",
                              "bandwidth-peers"])
def test_peer_fanouts_of_a_standalone_server(scrapes, op):
    """A server with no peers answers ``?peers=1`` as the JAX server does:
    bucketstats as its own one-row ``nodes`` list, replication and
    bandwidth as its local report (the fan-outs of a cluster are held to
    the JAX cluster's in tests/test_torch_dist_cluster.py)."""
    r = _admin(scrapes["client"], op, peers="1")
    assert r.status_code == 200, r.content
    out = r.json()
    if op == "bucketstats":
        assert len(out["nodes"]) == 1 and out["nodes"][0]["endpoint"]
    elif op == "bandwidth":
        assert "bucketStats" in out
    else:
        assert "peers" not in out


@pytest.fixture(scope="module")
def plane_servers(tmp_path_factory):
    """A JAX and a port server in this process, each with the feature
    planes enabled alike: a ReplicationPool with a target, the cross-node
    ReplicationSys, a webhook event target (closed loopback port), an FS
    tier and a throttled bucket in each package's bandwidth monitor."""
    from minio_tpu.bucket import bandwidth as jbw
    from minio_tpu.bucket import replicate as jrepl
    from minio_tpu.bucket import replication as jrep
    from minio_tpu.bucket import tiers as jtiers
    from minio_tpu.event import targets as jtargets
    from minio_tpu.obs import slo as jslo
    from minio_tpu_torch.bucket import bandwidth as pbw
    from minio_tpu_torch.bucket import replicate as prepl
    from minio_tpu_torch.bucket import replication as prep
    from minio_tpu_torch.bucket import tiers as ptiers
    from minio_tpu_torch.event import targets as ptargets
    from minio_tpu_torch.obs import slo as pslo
    root = tmp_path_factory.mktemp("planes")
    mp = pytest.MonkeyPatch()
    out = {}
    for pkg, rep, repl, tiers, targets, bw in (
            ("jax", jrep, jrepl, jtiers, jtargets, jbw),
            ("port", prep, prepl, ptiers, ptargets, pbw)):
        mp.setattr(bw, "_monitor", None)
        srv = _server(pkg, root / pkg)
        pool = rep.ReplicationPool(srv.obj, workers=1)
        pool.targets["mb"] = rep.S3Target(srv.endpoint(), AK, SK, "mb")
        srv.enable_replication(pool)
        srv.enable_cross_replication(
            repl.ReplicationSys(srv.obj, srv.bucket_meta))
        srv.enable_events([targets.WebhookTarget("t1",
                                                 "http://127.0.0.1:9/h")],
                          queue_root=str(root / f"q-{pkg}"))
        srv.tiers.add(tiers.TierFS("COLD", str(root / f"cold-{pkg}")))
        bw.global_monitor().throttle("mb", 1 << 20)
        out[pkg] = (srv, S3Client(srv.endpoint(), AK, SK))
    yield out
    for pkg, slo in (("jax", jslo), ("port", pslo)):
        slo.unregister_async_probe("replication")
        srv = out[pkg][0]
        srv.shutdown()
        srv._notifier.stop()
    mp.undo()


#: the feature planes' families, emitted once the planes are enabled
PLANE_FAMILIES = (
    "minio_tpu_replication_completed_total",
    "minio_tpu_replication_failed_total", "minio_tpu_replication_queued",
    "minio_tpu_replication_backlog", "minio_tpu_replication_retry_pending",
    "minio_tpu_replication_resynced_total",
    "minio_tpu_replication_lag_seconds",
    "minio_tpu_bucket_bandwidth_limit_bytes",
    "minio_tpu_bucket_bandwidth_current_bytes",
    "minio_tpu_notify_events_queued", "minio_tpu_notify_events_queue_limit",
    "minio_tpu_notify_events_sent_total",
    "minio_tpu_notify_events_send_failures_total",
    "minio_tpu_notify_events_skipped_total",
    "minio_tpu_ilm_tiers_configured")


def test_feature_plane_families_match_jax(plane_servers):
    """With the planes on, both cluster scrapes carry every replication,
    bandwidth, notification and ILM family with the same TYPE and label
    names (and the same values where no traffic moved them)."""
    got = {}
    for pkg, (srv, c) in plane_servers.items():
        text = c.request("GET", "/minio/v2/metrics/cluster").content.decode()
        fams = lint(text)
        got[pkg] = {f: fams[f] for f in PLANE_FAMILIES if f in fams}
        got[pkg + "-values"] = sorted(
            ln for ln in text.splitlines()
            if ln.startswith(("minio_tpu_bucket_bandwidth_limit",
                              "minio_tpu_ilm_tiers", "minio_tpu_notify_"
                              "events_queue_limit")))
    assert set(got["port"]) == set(PLANE_FAMILIES)
    assert got["port"] == got["jax"]
    assert got["port-values"] == got["jax-values"]


@pytest.mark.parametrize("method,op,query,body", [
    ("GET", "replication", {}, b""),
    ("POST", "replication", {}, b""),
    ("POST", "replication", {"resync": "mb"}, b""),
    ("GET", "tier", {}, b""),
    ("PUT", "tier", {}, b'{"kind": "tape", "name": "X"}'),
    ("GET", "bandwidth", {}, b""),
    ("GET", "bandwidth", {"buckets": "mb,zz"}, b""),
], ids=["replication", "replication-no-resync", "replication-resync",
        "tier", "tier-bad-kind", "bandwidth", "bandwidth-buckets"])
def test_feature_plane_admin_ops_match_jax(plane_servers, method, op, query,
                                           body):
    """The replication, tier and bandwidth admin ops answer as the JAX
    server does (the status and JSON, or the error XML with its request
    id masked); the replication report's lag block is compared by keys
    (its percentiles are each package's own windows)."""
    got = {}
    for pkg, (_srv, c) in plane_servers.items():
        r = c.request(method, f"/minio/admin/v3/{op}", query=query,
                      body=body)
        if r.headers.get("content-type", "").startswith("application/json"):
            doc = r.json()
            if isinstance(doc, dict) and "lag" in doc:
                doc["lag"] = sorted(doc["lag"])
            if isinstance(doc, list):
                for t in doc:
                    t.pop("dir", None)
            got[pkg] = (r.status_code, doc)
        else:
            got[pkg] = (r.status_code, re.sub(
                rb"<RequestId>[^<]*</RequestId>", b"", r.content))
    assert got["port"] == got["jax"]
    assert got["port"][0] in (200, 400)


def test_bucketstats_and_logs_admin_ops(scrapes):
    """The bucket analytics report holds the fixture's bucket with its
    requests, and the audit ring one entry per request, joined to the
    trace by its request id."""
    c = scrapes["client"]
    rep = _admin(c, "bucketstats").json()
    assert rep["enabled"] and "mb" in rep["buckets"]
    assert rep["buckets"]["mb"]["requests_total"] >= 7
    r = c.request("GET", "/mb/o")
    rid = r.headers["x-amz-request-id"]
    audit = _admin(c, "logs", type="audit", n="50").json()
    mine = [e for e in audit if e["request_id"] == rid]
    assert len(mine) == 1 and mine[0]["trace_id"] == rid
    assert mine[0]["api"] == "s3.getobject" and mine[0]["status"] == 200
    assert isinstance(_admin(c, "logs").json(), list)


def test_admin_needs_a_signature(scrapes):
    import requests
    r = requests.get(scrapes["srv"].endpoint() + "/minio/admin/v3/info",
                     timeout=30)
    assert r.status_code == 403
