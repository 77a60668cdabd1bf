"""The port's per-bucket analytics (minio_tpu_torch.obs.bucketstats) held
to the JAX package's on the CPU: tests/test_bucketstats.py's thirteen
cases run the same calls on both packages under the same fixed clock and
compare what comes out exactly (reports, drift maps, projections,
offender rows, ``metric_lines()`` text), then check the JAX suite's own
expectations on the port. Beyond them: the capacity history each package
persists through the config plane is read by the other, and the same
requests on both servers, followed by one scanner cycle each, give the
same per-bucket counts, bytes and zero-drift reconcile.

Both registries (and both SLO planes) start and end empty."""
import os
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from minio_tpu.obs import bucketstats as jbs  # noqa: E402
from minio_tpu.obs import health as jhealth  # noqa: E402
from minio_tpu.obs import metrics as jmx  # noqa: E402
from minio_tpu.obs import slo as jslo  # noqa: E402
from minio_tpu.qos import budget as jbudget  # noqa: E402
from minio_tpu_torch.obs import bucketstats as pbs  # noqa: E402
from minio_tpu_torch.obs import health as phealth  # noqa: E402
from minio_tpu_torch.obs import logger as plog  # noqa: E402
from minio_tpu_torch.obs import metrics as pmx  # noqa: E402
from minio_tpu_torch.obs import slo as pslo  # noqa: E402
from minio_tpu_torch.qos import budget as pbudget  # noqa: E402

NOW = 1_000_000.0  # fixed clock: ring minutes and Window slots determinate
SEED = 20261018
GIB = 1 << 30
BS = {"jax": jbs, "port": pbs}
SLO = {"jax": jslo, "port": pslo}
HEALTH = {"jax": jhealth, "port": phealth}
MX = {"jax": jmx, "port": pmx}


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for var in [v for v in os.environ
                if v.startswith(("MINIO_TPU_BUCKETSTATS",
                                 "MINIO_TPU_SLO_", "MINIO_TPU_QOS_"))]:
        monkeypatch.delenv(var)
    for mod in (jbudget, pbudget):
        monkeypatch.setattr(mod, "_cfg_cache", {})
    for mod in (*BS.values(), *SLO.values()):
        mod.reset()
    yield monkeypatch
    for mod in (*BS.values(), *SLO.values()):
        mod.reset()


def both(fn) -> dict:
    """fn(package's bucketstats) on each package, from an empty registry;
    the two results must be equal, and the port's is returned."""
    got = {}
    for pkg, bs in BS.items():
        bs.reset()
        got[pkg] = fn(bs)
    assert got["port"] == got["jax"]
    return got["port"]


def _snapshot(buckets: dict, ts: float) -> dict:
    return {
        "size_total": sum(v["size"] for v in buckets.values()),
        "objects_total": sum(v.get("objects", 0)
                             for v in buckets.values()),
        "last_update": ts,
        "buckets": buckets,
    }


def _labels(lines) -> set:
    return {line.split('bucket="', 1)[1].split('"', 1)[0]
            for line in lines if 'bucket="' in line}


# --- fold / cardinality bound ------------------------------------------------


def test_fold_storm_bounds_cardinality(fresh):
    """4096 distinct buckets against top_n=4: exactly 4 tracked rows, the
    rest in _overflow_, at most top_n + 1 label values in the lines."""
    fresh.setenv("MINIO_TPU_BUCKETSTATS_TOP_N", "4")

    def run(bs):
        for i in range(4096):
            bs.record_request(f"b{i:04d}", "getobject", 200, 0.001,
                              bytes_out=64, now=NOW)
        return bs.report(now=NOW), bs.metric_lines(now=NOW)

    rep, lines = both(run)
    assert rep["tracked"] == 4 and rep["folds"] == 4096 - 4
    assert set(rep["buckets"]) == {"b0000", "b0001", "b0002", "b0003",
                                   pbs.OVERFLOW}
    assert rep["buckets"][pbs.OVERFLOW]["requests_total"] == 4092
    assert rep["buckets"][pbs.OVERFLOW]["bytes_out"] == 4092 * 64
    assert len(_labels(lines)) <= 5


def test_fold_label_is_the_admission_gate(fresh):
    fresh.setenv("MINIO_TPU_BUCKETSTATS_TOP_N", "2")

    def run(bs):
        out = [bs.fold_label(b) for b in ("alpha", "beta", "gamma")]
        bs.reset()
        out.append(bs.fold_label("alpha", admit=False))
        out.append(bs.fold_label(""))
        return out

    assert both(run) == ["alpha", "beta", pbs.OVERFLOW, pbs.OVERFLOW,
                         pbs.OVERFLOW]
    fresh.setenv("MINIO_TPU_BUCKETSTATS", "0")
    assert both(lambda bs: (bs.fold_label("alpha"), bs.enabled())) == \
        (pbs.OVERFLOW, False)


def test_idle_eviction_frees_slot_for_active_tenant(fresh):
    fresh.setenv("MINIO_TPU_BUCKETSTATS_TOP_N", "2")
    fresh.setenv("MINIO_TPU_BUCKETSTATS_FOLD_IDLE_CYCLES", "1")

    def run(bs):
        for b in ("kept", "idle", "newcomer"):
            bs.record_request(b, "getobject", 200, 0.001, now=NOW)
        refused = bs.fold_label("newcomer", admit=False)
        snap = _snapshot({"kept": {"size": 10, "objects": 1}}, NOW)
        d1 = bs.reconcile(snap, now=NOW)
        bs.record_request("kept", "getobject", 200, 0.001, now=NOW)
        d2 = bs.reconcile(_snapshot({"kept": {"size": 10, "objects": 1}},
                                    NOW + 60), now=NOW)
        return refused, d1, d2, bs.report(now=NOW), bs.fold_label("newcomer")

    refused, _d1, _d2, rep, after = both(run)
    assert refused == pbs.OVERFLOW
    assert "idle" not in rep["buckets"] and rep["evictions"] >= 1
    assert after == "newcomer"


# --- live usage + drift reconcile -------------------------------------------


def test_usage_deltas_move_live_and_drift_reconciles_to_zero():
    def run(bs):
        out = []
        bs.on_put("data", 1000)
        bs.on_put("data", 500)
        bs.on_delete("data", 200)
        out.append(bs.report(now=NOW)["buckets"]["data"]["usage"])
        snap = _snapshot({"data": {"size": 1250, "objects": 2,
                                   "versions": 2}}, NOW)
        out.append(bs.reconcile(snap, now=NOW))
        out.append(bs.report(now=NOW)["buckets"]["data"]["usage"])
        bs.record_request("data", "getobject", 200, 0.001, now=NOW)
        out.append(bs.reconcile(_snapshot(
            {"data": {"size": 1250, "objects": 2, "versions": 2}},
            NOW + 60), now=NOW))
        bs.on_put("data", 0, versions=1, objects=0)
        out.append(bs.report(now=NOW)["buckets"]["data"]["usage"])
        out.append(bs.metric_lines(now=NOW))
        return out

    u1, d1, u2, d2, u3, lines = both(run)
    assert u1 == {"objects": 1, "versions": 1, "bytes": 1300}
    assert d1 == {"data": 50}
    assert u2 == {"objects": 2, "versions": 2, "bytes": 1250}
    assert d2.get("data", 0) == 0
    assert u3["versions"] == 3 and u3["objects"] == 2
    assert 'minio_tpu_bucket_usage_live_bytes{bucket="data"} 1250' in lines


class FakeLayer:
    def __init__(self):
        self.store = {}

    def get_config(self, path):
        return self.store[path]

    def put_config(self, path, data):
        self.store[path] = data


def test_history_persists_through_config_plane():
    def run(bs):
        layer = FakeLayer()
        bs.reconcile(_snapshot({"a": {"size": 100}}, NOW), objlayer=layer,
                     now=NOW)
        first = layer.store[bs.HISTORY_PATH]
        bs.reset()
        bs.reconcile(_snapshot({"a": {"size": 200}}, NOW + 3600),
                     objlayer=layer, now=NOW)
        return first, layer.store[bs.HISTORY_PATH], bs.projection(now=NOW)

    first, second, proj = both(run)
    assert pbs.HISTORY_PATH == jbs.HISTORY_PATH
    assert proj["24h"]["samples"] == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_history(writer):
    """One package's persisted history, loaded by the other at its first
    reconcile, continues the same projection."""
    reader = "port" if writer == "jax" else "jax"
    layer = FakeLayer()
    w, r = BS[writer], BS[reader]
    w.record_request("grow", "putobject", 200, 0.001, now=NOW)
    w.reconcile(_snapshot({"grow": {"size": GIB}}, NOW), objlayer=layer,
                now=NOW)
    w.record_request("grow", "putobject", 200, 0.001, now=NOW)
    w.reconcile(_snapshot({"grow": {"size": 2 * GIB}}, NOW + 1800),
                objlayer=layer, now=NOW)
    written = layer.store[w.HISTORY_PATH]
    r.record_request("grow", "putobject", 200, 0.001, now=NOW)
    r.reconcile(_snapshot({"grow": {"size": 3 * GIB}}, NOW + 3600),
                objlayer=layer, now=NOW)
    w.record_request("grow", "putobject", 200, 0.001, now=NOW)
    w.reconcile(_snapshot({"grow": {"size": 3 * GIB}}, NOW + 3600),
                objlayer=FakeLayer(), now=NOW)
    assert r.projection(now=NOW) == w.projection(now=NOW)
    assert r.projection(now=NOW)["1h"]["samples"] == 3
    assert r.projection(now=NOW)["1h"]["cluster_gib_per_day"] == \
        pytest.approx(48.0)
    assert layer.store[r.HISTORY_PATH].startswith(written[:-2])


# --- SLO burn attribution ----------------------------------------------------


def test_breach_attribution_names_offending_bucket():
    """One bucket throwing 5xx while others stay clean: the slo report's
    class entry and the health rollup built from it name that bucket."""
    got = {}
    for pkg, slo in SLO.items():
        for _ in range(20):
            slo.record("interactive", 0.001, status=503, bucket="victim",
                       now=NOW)
        for _ in range(80):
            slo.record("interactive", 0.001, bucket="innocent", now=NOW)
        rep = slo.report(now=NOW)
        roll = HEALTH[pkg]._rollup([{"endpoint": "127.0.0.1:9000",
                                     "slo": rep}])
        got[pkg] = (rep["classes"]["interactive"]["top_buckets"],
                    roll["slo_breaches"])
    assert got["port"] == got["jax"]
    tops, breaches = got["port"]
    assert tops["availability"][0] == {"bucket": "victim", "bad": 20,
                                       "requests": 20, "share": 1.0}
    brow = [b for b in breaches if b["slo"] == "availability"]
    assert brow and brow[0]["top_bucket"] == "victim"
    assert brow[0]["top_bucket_share"] == pytest.approx(1.0)


def test_top_offenders_share_includes_overflow(fresh):
    fresh.setenv("MINIO_TPU_BUCKETSTATS_TOP_N", "1")

    def run(bs):
        for b in ("tracked", "folded-a", "folded-b"):
            bs.record_slo(b, "interactive", True, False, now=NOW)
        return bs.top_offenders("interactive", "availability", 300.0,
                                now=NOW)

    byname = {r["bucket"]: r for r in both(run)}
    assert byname[pbs.OVERFLOW]["bad"] == 2
    assert byname[pbs.OVERFLOW]["share"] == pytest.approx(2 / 3, abs=1e-3)
    assert byname["tracked"]["share"] == pytest.approx(1 / 3, abs=1e-3)


def test_latency_kind_counts_slow_not_errors():
    def run(bs):
        bs.record_slo("b", "interactive", False, True, now=NOW)
        bs.record_slo("b", "interactive", True, False, now=NOW)
        return (bs.top_offenders("interactive", "latency", 300.0, now=NOW),
                bs.top_offenders("interactive", "availability", 300.0,
                                 now=NOW))

    lat, avail = both(run)
    assert lat[0]["bad"] == 1 and avail[0]["bad"] == 1


# --- capacity projection -----------------------------------------------------


def test_projection_math_on_synthetic_snapshots():
    def run(bs):
        bs.record_request("grow", "putobject", 200, 0.001, now=NOW)
        bs.reconcile(_snapshot({"grow": {"size": GIB}}, NOW), now=NOW)
        p1 = bs.projection(now=NOW)
        bs.record_request("grow", "putobject", 200, 0.001, now=NOW)
        bs.reconcile(_snapshot({"grow": {"size": 2 * GIB}}, NOW + 3600),
                     now=NOW)
        return p1, bs.projection(now=NOW), bs.report(now=NOW), \
            bs.metric_lines(now=NOW)

    p1, p2, rep, lines = both(run)
    assert p1["1h"]["cluster_gib_per_day"] == 0.0
    for win in ("1h", "24h"):
        assert p2[win]["samples"] == 2
        assert p2[win]["cluster_gib_per_day"] == pytest.approx(24.0)
        assert p2[win]["buckets"]["grow"] == pytest.approx(24.0)
    assert rep["projection"]["1h"]["cluster_gib_per_day"] == \
        pytest.approx(24.0)
    assert any("minio_tpu_cluster_growth_gib_per_day" in line
               for line in lines)


def test_projection_out_of_order_cycles_deduped():
    def run(bs):
        bs.reconcile(_snapshot({"a": {"size": 100}}, NOW), now=NOW)
        bs.reconcile(_snapshot({"a": {"size": 999}}, NOW), now=NOW)
        bs.reconcile(_snapshot({"a": {"size": 999}}, NOW - 60), now=NOW)
        return bs.projection(now=NOW)

    assert both(run)["24h"]["samples"] == 1


# --- request charging / api classes -----------------------------------------


def test_request_charging_and_api_taxonomy():
    def run(bs):
        bs.record_request("b", "getobject", 200, 0.010, ttfb_s=0.002,
                          bytes_out=4096, now=NOW)
        bs.record_request("b", "putobject", 200, 0.020, bytes_in=8192,
                          now=NOW)
        bs.record_request("b", "listobjectsv2", 200, 0.005, now=NOW)
        bs.record_request("b", "deleteobject", 204, 0.003, now=NOW)
        bs.record_request("b", "getobject", 503, 0.001, now=NOW)
        bs.record_request("b", "putobject", 0, 0.001, now=NOW)
        names = ("headobject", "copyobject", "completemultipartupload",
                 "abortmultipartupload", "listmultipartuploads",
                 "selectobjectcontent", "assumerole", "", "getbucketpolicy",
                 "putbucketpolicy", "deletebucketpolicy", "postpolicybucket")
        return bs.report(now=NOW)["buckets"]["b"], \
            [bs.api_class(a) for a in names]

    row, classes = both(run)
    assert row["requests_total"] == 6 and row["errors_5xx"] == 1
    assert row["requests"]["read"] == {"2xx": 1, "5xx": 1}
    assert row["requests"]["write"] == {"2xx": 1, "1xx": 1}
    assert row["requests"]["list"]["2xx"] == 1
    assert row["requests"]["delete"]["2xx"] == 1
    assert row["bytes_in"] == 8192 and row["bytes_out"] == 4096
    assert row["latency"]["read"]["count"] == 2
    assert row["latency"]["read"]["ttfb_p50_s"] > 0
    assert classes == ["read", "write", "write", "delete", "list", "write",
                       "other", "other", "read", "write", "delete", "write"]


# --- rendering hygiene -------------------------------------------------------


def test_metric_lines_families_documented_and_well_formed():
    def run(bs):
        bs.record_request("doc", "getobject", 200, 0.01, ttfb_s=0.001,
                          bytes_in=1, bytes_out=1, now=NOW)
        bs.record_request('q"uo\\te', "putobject", 200, 0.01, now=NOW)
        bs.record_slo("doc", "interactive", True, False, now=NOW)
        bs.record_slo("doc", "interactive", False, True, now=NOW)
        bs.reconcile(_snapshot({"doc": {"size": 1 << 30}}, NOW), now=NOW)
        bs.on_put("doc", 7)
        bs.reconcile(_snapshot({"doc": {"size": 2 << 30}}, NOW + 3600),
                     now=NOW)
        return bs.metric_lines(now=NOW)

    lines = both(run)
    docs = open(os.path.join(os.path.dirname(__file__), "..", "docs",
                             "observability.md")).read()
    fam_re = re.compile(r"^[a-z][a-z0-9_]*$")
    families = set()
    for line in lines:
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        families.add(re.sub(r"_(bucket|sum|count)$", "", name))
    for fam in families:
        assert fam.startswith("minio_tpu_") and fam_re.match(fam), fam
        assert fam in docs, f"{fam} missing from docs/observability.md"
    declared = {line.split()[2] for line in lines
                if line.startswith("# TYPE ")}
    sampled = {line.split("{", 1)[0].split(" ", 1)[0] for line in lines
               if not line.startswith("#")}
    assert declared <= sampled, declared - sampled
    assert 'bucket="q\\"uo\\\\te"' in "\n".join(lines)
    assert "minio_tpu_bucket_usage_drift_bytes" in declared


def test_metrics_group_scrape_carries_bucket_families():
    """The bucket group is in the exposition: a node scrape against a bare
    server stand-in (the server-bound groups fail shielded) still shows
    the registry, with the same bucket lines on both packages."""
    class _Srv:  # a bare object() is not weak-referenceable
        pass

    got = {}
    for pkg, bs in BS.items():
        bs.record_request("scraped", "getobject", 200, 0.01, now=NOW)
        text = MX[pkg].render_prometheus(_Srv(), scope="node").decode()
        got[pkg] = sorted(ln for ln in text.splitlines()
                          if "minio_tpu_bucket_" in ln and
                          "latency" not in ln and "ttfb" not in ln)
    assert got["port"] == got["jax"]
    assert any('bucket="scraped"' in ln for ln in got["port"])
    assert "# TYPE minio_tpu_bucket_stats_tracked gauge" in got["port"]


# --- the feeds on live servers -----------------------------------------------


def test_servers_charge_the_same_requests_and_reconcile_to_zero(tmp_path):
    """The same signed requests on both servers (PUTs, GETs, a ranged GET,
    a miss, a listing, a delete, a multipart upload): the same request
    counts and bytes per bucket, the same live usage, and after one
    scanner cycle each the same usage with a reconcile drift of 0. Then an
    overwrite and an aws-chunked PUT: both packages charge the overwrite
    as a new object (the next cycle's drift is the replaced version's
    size, the one after finds none) and the chunked PUT's bytes in as the
    handler's can't-drain sentinel (2**62), the JAX package's
    accounting."""
    from minio_tpu.scanner.scanner import DataScanner as JScanner
    from minio_tpu_torch.scanner.scanner import DataScanner as PScanner
    from test_torch_s3server import Server
    gen = np.random.default_rng(SEED)
    bodies = [gen.bytes(n) for n in (0, 1000, 70_001, 130_000)]
    part = gen.bytes(65_536)
    got = {}
    for pkg in ("jax", "port"):
        BS[pkg].reset()
        s = Server(pkg, tmp_path / pkg)
        try:
            c = s.cl
            for b in ("alpha", "beta"):
                assert c.put_bucket(b).status_code == 200
            for i, data in enumerate(bodies):
                assert c.put_object("alpha", f"o{i}", data).status_code \
                    == 200
                assert c.get_object("alpha", f"o{i}").content == data
            assert c.put_object("beta", "x", bodies[2]).status_code == 200
            assert c.get_object("beta", "x", headers={
                "Range": "bytes=5-500"}).status_code == 206
            assert c.get_object("beta", "missing").status_code == 404
            assert c.request("GET", "/alpha",
                             query={"list-type": "2"}).status_code == 200
            assert c.delete_object("alpha", "o1").status_code == 204
            r = c.request("POST", "/beta/mp", query={"uploads": ""})
            uid = re.search(rb"<UploadId>([^<]+)<", r.content).group(1)
            r = c.request("PUT", "/beta/mp", query={
                "partNumber": "1", "uploadId": uid.decode()}, body=part)
            etag = r.headers["ETag"]
            done = (f"<CompleteMultipartUpload><Part><PartNumber>1"
                    f"</PartNumber><ETag>{etag}</ETag></Part>"
                    f"</CompleteMultipartUpload>").encode()
            assert c.request("POST", "/beta/mp", query={
                "uploadId": uid.decode()}, body=done).status_code == 200
            live = {b: r["usage"] for b, r in
                    BS[pkg].report()["buckets"].items()}
            scanner = (PScanner if pkg == "port" else JScanner)(
                s.srv.obj, sleep_per_object=0)
            scanner.scan_cycle()
            rep = BS[pkg].report()
            assert c.put_object("beta", "x", bodies[3]).status_code == 200
            assert s.chunked_put("/beta/chunked", bodies[2]).status_code \
                == 200
            drifts = [scanner.scan_cycle() and BS[pkg].report()[
                "drift_bytes"] for _ in range(2)]
            chunked_in = BS[pkg].report()["buckets"]["beta"]["bytes_in"]
        finally:
            s.close()
        got[pkg] = {"live": live, "drift": rep["drift_bytes"],
                    "later_drifts": drifts, "chunked_in": chunked_in,
                    "reconciles": rep["reconciles"],
                    "rows": {b: {k: r[k] for k in (
                        "requests_total", "errors_5xx", "requests",
                        "bytes_in", "bytes_out", "usage")}
                        for b, r in rep["buckets"].items()}}
    assert got["port"] == got["jax"]
    rows = got["port"]["rows"]
    assert rows["alpha"]["requests"]["write"]["2xx"] == 5
    assert rows["alpha"]["bytes_in"] == sum(map(len, bodies))
    assert rows["alpha"]["bytes_out"] > sum(map(len, bodies))
    assert rows["beta"]["requests"]["read"] == {"2xx": 1, "4xx": 1}
    assert got["port"]["drift"] == {} and got["port"]["reconciles"] == 1
    assert rows["alpha"]["usage"]["objects"] == 3
    # the overwritten version's bytes stay charged until the reconcile
    assert got["port"]["later_drifts"] == [{"beta": len(bodies[2])}, {}]
    assert got["port"]["chunked_in"] == rows["beta"]["bytes_in"] + \
        len(bodies[3]) + (1 << 62)


def test_audit_and_bucket_planes_reset():
    pbs.record_request("b", "getobject", 200, 0.001, now=NOW)
    plog.log_sys().audit({"request_id": "x"})
    assert pbs.report(now=NOW)["buckets"]
    pbs.reset()
    plog.reset()
    assert not pbs.report(now=NOW)["buckets"]
    assert not plog.log_sys().audit_ring
