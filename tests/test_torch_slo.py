"""The port's SLO plane and health snapshot (minio_tpu_torch.obs.{slo,
health}, the ``slo``, ``health``, ``healthinfo`` and ``obdinfo`` admin
ops) held to the JAX package's on the CPU: the same ``record`` sequence on
a faked clock gives identical ``report(now=)`` documents and, recorded
live, identical ``minio_tpu_slo_*`` lines; the node and cluster snapshots
of the same deployment after the same requests agree apart from times and
endpoints; ``healthinfo`` has the JAX server's keys.

Both registries start empty (``fresh``): the objectives are read through
each package's config registry."""
import os
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from minio_tpu.config import kvs as jkvs  # noqa: E402
from minio_tpu.obs import bucketstats as jbucketstats  # noqa: E402
from minio_tpu.obs import metrics as jmx  # noqa: E402
from minio_tpu.obs import profiler as jprof  # noqa: E402
from minio_tpu.obs import slo as jslo  # noqa: E402
from minio_tpu.qos import budget as jbudget  # noqa: E402
from minio_tpu_torch.config import kvs as pkvs  # noqa: E402
from minio_tpu_torch.obs import bucketstats as pbucketstats  # noqa: E402
from minio_tpu_torch.obs import metrics as pmx  # noqa: E402
from minio_tpu_torch.obs import profiler as pprof  # noqa: E402
from minio_tpu_torch.obs import slo as pslo  # noqa: E402
from minio_tpu_torch.qos import budget as pbudget  # noqa: E402
from test_torch_s3server import Server  # noqa: E402

SEED = 20261019
SLO = {"jax": jslo, "port": pslo}
MX = {"jax": jmx, "port": pmx}


@pytest.fixture
def fresh(monkeypatch):
    """Empty SLO windows, registries and stored-read caches on both sides,
    no SLO or QoS knob from the environment, no async-plane objective an
    earlier test registered on the JAX side (the port has no replication
    plane to probe), and the profiler off so no breach starts a capture
    that a later report would link."""
    for mod in (jkvs, pkvs):
        monkeypatch.setattr(mod, "_global", None)
    for mod in (jbudget, pbudget):
        monkeypatch.setattr(mod, "_cfg_cache", {})
    for keys in (pkvs.SUB_SYSTEMS["slo"], pkvs.SUB_SYSTEMS["qos"]):
        for kv in keys.values():
            monkeypatch.delenv(kv.env, raising=False)
    monkeypatch.setattr(jslo, "_async_probes", {})
    monkeypatch.setenv("MINIO_TPU_PROFILER", "0")
    for prof in (jprof, pprof):
        prof.reset()
    for bs in (jbucketstats, pbucketstats):
        bs.reset()
    for slo in SLO.values():
        slo.reset()
    yield monkeypatch
    for slo in SLO.values():
        slo.reset()
    for bs in (jbucketstats, pbucketstats):
        bs.reset()


def _outcomes(n: int) -> list[tuple]:
    """(class, seconds, status, error, trace id, clock) rows from a seed:
    every class, good and slow and failed outcomes (no failed interactive
    one), a 4xx, an unknown class, spread over 40 minutes."""
    gen = np.random.default_rng(SEED)
    classes = ("interactive", "control", "background", "nope")
    statuses = (200, 200, 200, 206, 404, 500, 503)
    rows = []
    for i in range(n):
        cls = classes[int(gen.integers(0, len(classes)))]
        secs = float(gen.choice((0.004, 0.03, 0.09, 0.2, 3.0, 7.5)))
        status = statuses[int(gen.integers(0, 7))]
        err = bool(gen.integers(0, 30) == 0)
        if cls == "interactive":  # within budget: breaches come only
            status, err = min(status, 404), False  # from a burst
        rows.append((cls, secs, status, err, f"t{i:04d}",
                     1_000_000.0 + i * 2400.0 / n))
    return rows


@pytest.mark.parametrize("burst", [False, True], ids=["steady", "breach"])
def test_report_on_a_faked_clock_matches_jax(fresh, burst):
    rows = _outcomes(600)
    if burst:  # a 5xx storm at the end: both windows burn past the alert
        rows += [("interactive", 0.01, 500, False, "", 1_002_400.0 + i)
                 for i in range(60)]
    got = {}
    for pkg, slo in SLO.items():
        for cls, secs, status, err, tid, now in rows:
            slo.record(cls, secs, status=status, error=err, trace_id=tid,
                       now=now)
        got[pkg] = [slo.report(now=t) for t in (1_001_500.0, 1_002_461.0)]
    assert got["port"] == got["jax"]
    rep = got["port"][1]
    assert set(rep["classes"]) == {"interactive", "control", "background"}
    w = rep["classes"]["background"]["windows"]
    assert w["1h"]["requests"] > w["5m"]["requests"] > 0
    assert rep["classes"]["interactive"]["breach"]["availability"] is burst


def test_live_slo_lines_match_jax(fresh):
    """Recorded on the live clock, both expositions carry the same
    ``minio_tpu_slo_*`` lines, and each package's outcome counter moved
    by the same counts."""
    rows = _outcomes(200)
    key = "minio_tpu_slo_requests_total"
    got = {}
    for pkg, slo in SLO.items():
        before = {k: v for k, v in MX[pkg].counters_snapshot().items()
                  if k.startswith(key)}
        for cls, secs, status, err, _tid, _now in rows:
            slo.record(cls, secs, status=status, error=err)
        after = {k: v - before.get(k, 0)
                 for k, v in MX[pkg].counters_snapshot().items()
                 if k.startswith(key)}
        got[pkg] = (MX[pkg]._g_slo(None), after)
    assert got["port"] == got["jax"]
    assert 'minio_tpu_slo_burn_rate{class="interactive",slo="latency",' \
           'window="5m"}' in "\n".join(got["port"][0])


#: fields of a snapshot that hold times, trace ids or timing-dependent
#: counts (a request over its class's 100 ms budget on one package may be
#: under it on the other)
_TIMING = {"ts", "p50_s", "p99_s", "worst_slow_s", "worst_slow_trace_id",
           "slow", "latency_ok_ratio", "latency_burn", "worst_breach",
           "ewma_ms", "last_error", "max_wait_ms"}
#: the JAX snapshot's block of the QoS scheduler (once an earlier test in
#: the process built the JAX package's dispatch queue): the scheduler is
#: not ported
_UNPORTED = {"scheduler"}


def _untimed(doc, root: str):
    if isinstance(doc, dict):
        return {k: _untimed(v, root) for k, v in doc.items()
                if k not in _TIMING | _UNPORTED and
                not (k == "latency" and isinstance(v, bool))}
    if isinstance(doc, list):
        return [_untimed(v, root) for v in doc]
    if isinstance(doc, str):
        return doc.replace(root, "<root>")
    return doc


def _settle(srv, slo) -> None:
    """Wait until the last request left the handler: a client has its
    answer before the server releases the admission slot and records the
    outcome."""
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        w = slo.report()["classes"]
        if srv.qos_admission.stats()["inflight_total"] == 0 and \
                w["interactive"]["windows"]["5m"]["requests"] == 3 and \
                w["control"]["windows"]["5m"]["requests"] == 1:
            # the polls cached an early 1h evaluation (3 s on live
            # reads): drop it so the snapshots read the settled windows
            slo._slow_cache.clear()
            return
        time.sleep(0.01)
    raise AssertionError("the requests did not settle")


def _admin(c, op, **query):
    return c.request("GET", f"/minio/admin/v3/{op}", query=query or None)


def test_snapshots_and_health_ops_match_jax(fresh, tmp_path):
    from minio_tpu.obs import health as jhealth
    from minio_tpu_torch.obs import health as phealth
    # an interactive budget above either server's slowest request (the
    # port's CPU PUT takes ~1.6 s): no request crosses it on either side,
    # so the bucket attribution's latency rows (top_buckets) cannot differ
    # by which server ran slower
    fresh.setenv("MINIO_TPU_QOS_INTERACTIVE_BUDGET_MS", "600000")
    got = {}
    for pkg in ("jax", "port"):
        for slo in SLO.values():
            slo.reset()
        s = Server(pkg, tmp_path / pkg)
        try:
            c = s.cl
            assert c.put_bucket("slob").status_code == 200
            body = np.random.default_rng(SEED).bytes(70_000)
            assert c.put_object("slob", "k", body).status_code == 200
            assert c.get_object("slob", "k").content == body
            assert c.get_object("slob", "missing").status_code == 404
            _settle(s.srv, SLO[pkg])
            node = (jhealth if pkg == "jax" else phealth).node_snapshot(
                s.srv)
            if pkg == "jax":
                cluster = jhealth.cluster_snapshot(s.srv, peers=False)
            else:
                cluster = phealth.cluster_snapshot(s.srv)
            ops = {op: _admin(c, op) for op in ("slo", "health",
                                                "healthinfo", "obdinfo")}
        finally:
            s.close()
        root = str(tmp_path / pkg)
        lanes = node.pop("lanes")
        qd = node.pop("queue_depth")
        got[pkg] = {
            "node": _untimed({k: v for k, v in node.items()
                              if k != "endpoint"}, root),
            "rollup": _untimed(cluster["cluster"], root),
            "status": {op: r.status_code for op, r in ops.items()},
            "slo": _untimed(ops["slo"].json(), root),
            "health": _untimed(ops["health"].json()["cluster"], root),
            "healthinfo": sorted(ops["healthinfo"].json()),
            "drive_keys": sorted({k for d in ops["obdinfo"].json()["drives"]
                                  for k in d}),
            "lanes": (sorted(lanes), sorted(qd))}
        assert node["endpoint"] == f"127.0.0.1:{s.srv.port}"
    jax, port = got["jax"], got["port"]
    # the port's two dispatch lanes stand where the JAX queue's are (the
    # recorder is process-wide: earlier tests' lanes may be there too)
    assert "bulk" in port.pop("lanes")[0]
    jax.pop("lanes")
    # the dispatch block: the JAX package's process-global queue exists
    # once any test built one, the port's once this server's queue ran
    assert "dispatch" in port["healthinfo"]
    for doc in (jax, port):
        if "dispatch" in doc["healthinfo"]:
            doc["healthinfo"].remove("dispatch")
    assert port == jax
    n = port["node"]
    assert n["disks"]["total"] == 6 and n["disks"]["faulty"] == 0
    assert n["slo"]["classes"]["interactive"]["windows"]["5m"][
        "requests"] == 3
    assert port["rollup"]["healthy"] and port["rollup"]["disks_total"] == 6
    assert port["status"] == {"slo": 200, "health": 200, "healthinfo": 200,
                              "obdinfo": 200}
    assert {"path", "total_bytes", "free_bytes", "write_256k_ms",
            "read_256k_ms"} <= set(port["drive_keys"])


def test_failed_background_items_burn_availability(fresh):
    """The dispatch queue's background items feed the SLO plane: a flush
    that fails on a queue without host salvage (the card's policy) burns
    the class's availability budget; a good one does not."""
    from minio_tpu_torch import qos
    from minio_tpu_torch.ops.rs_torch import ReedSolomon
    from minio_tpu_torch.runtime.dispatch import DispatchQueue
    q = DispatchQueue("cpu", max_delay=1e-4)
    q.host_salvage = False
    codec = ReedSolomon(4, 2, device="cpu")
    words = np.random.default_rng(SEED).integers(
        0, 2 ** 32, (4, 256), dtype=np.uint32)
    try:
        with qos.background():
            q.encode(codec, words).result(timeout=30)
            q._launch = lambda *a: (_ for _ in ()).throw(
                RuntimeError("injected launch failure"))
            with pytest.raises(RuntimeError, match="injected"):
                q.encode(codec, words).result(timeout=30)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            w = pslo.report()["classes"]["background"]["windows"]["5m"]
            if w["requests"] == 2:
                break
            time.sleep(0.02)
    finally:
        q.stop()
    assert (w["requests"], w["errors"]) == (2, 1)
    assert pslo.report()["classes"]["interactive"]["windows"]["5m"][
        "requests"] == 0
