"""The port's config registry (minio_tpu_torch.config) held to the JAX
package's (minio_tpu.config) on the CPU: the same table resolves alike
with nothing stored and under environment overrides; the same set /
delete / restore sequence, with the clock and the ids pinned, leaves
byte-identical ``.minio.sys/config`` trees on copies of one deployment;
each package loads the other's stored config and history; on_apply fires
as the reference's does; the admin config ops answer the same JSON from
a JAX and a port S3Server; a stored value holds on a port server over
drives a JAX server configured, and the environment still wins.

Both packages keep one process-global registry (``kvs._global``) and a
TTL cache of stored reads (``budget._cfg_cache``): every test here starts
both from nothing (``fresh``)."""
import contextlib
import itertools
import json
import os
import sys
import time
import uuid

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from minio_tpu.config import kvs as jkvs  # noqa: E402
from minio_tpu.objectlayer import ErasureObjects as JObjects  # noqa: E402
from minio_tpu.qos import budget as jbudget  # noqa: E402
from minio_tpu.storage import XLStorage as JXLStorage  # noqa: E402
from minio_tpu_torch.config import kvs as pkvs  # noqa: E402
from minio_tpu_torch.objectlayer import ErasureObjects  # noqa: E402
from minio_tpu_torch.qos import budget as pbudget  # noqa: E402
from minio_tpu_torch.storage import XLStorage  # noqa: E402
from test_torch_s3server import Server  # noqa: E402

N, PARITY, BLOCK = 6, 2, 1 << 16
#: environment knobs set by the override case, of several subsystems
ENV = {"MINIO_TPU_QOS_INTERACTIVE_BUDGET_MS": "40",
       "MINIO_TPU_PROFILER_HZ": "23",
       "MINIO_TPU_FSYNC": "batched",
       "MINIO_TPU_SLO_BURN_ALERT": "6"}
KVS = {"jax": jkvs, "port": pkvs}


@pytest.fixture
def fresh(monkeypatch):
    """Both registries and both stored-read caches start empty, and no
    knob of the table comes from this process's environment."""
    for mod in (jkvs, pkvs):
        monkeypatch.setattr(mod, "_global", None)
    for mod in (jbudget, pbudget):
        monkeypatch.setattr(mod, "_cfg_cache", {})
    for keys in pkvs.SUB_SYSTEMS.values():
        for kv in keys.values():
            if kv.env:
                monkeypatch.delenv(kv.env, raising=False)
    return monkeypatch


def layer(pkg: str, root):
    disks = [(XLStorage if pkg == "port" else JXLStorage)(
        os.path.join(str(root), f"d{i:02d}")) for i in range(N)]
    if pkg == "port":
        return ErasureObjects(disks, default_parity=PARITY, block_size=BLOCK,
                              device="cpu")
    return JObjects(disks, default_parity=PARITY, block_size=BLOCK)


@contextlib.contextmanager
def pinned_clock(monkeypatch):
    """History ids and times from counters: ``time.time_ns``,
    ``time.time`` and ``uuid.uuid4`` as both registries read them inside
    ``_snapshot_locked``, for the duration of one package's sequence.
    Other callers keep the real clock and ids, so what earlier tests in
    the process left behind (a sampled span context that gives every
    storage call a span id) cannot advance the counters."""
    ns = itertools.count(1_700_000_000_000_000_000, 1_000_000_007)
    ids = itertools.count(1)
    real_ns, real_time, real_uuid4 = time.time_ns, time.time, uuid.uuid4

    def snapshot(pinned, real):
        def draw():
            caller = sys._getframe(1).f_code.co_name
            return pinned() if caller == "_snapshot_locked" else real()
        return draw

    with monkeypatch.context() as m:
        m.setattr(time, "time_ns", snapshot(lambda: next(ns), real_ns))
        m.setattr(time, "time", snapshot(lambda: 1.7e9, real_time))
        m.setattr(uuid, "uuid4", snapshot(
            lambda: uuid.UUID(int=next(ids) << 96), real_uuid4))
        yield


def config_tree(root) -> dict:
    out = {}
    for d, _dirs, files in os.walk(str(root)):
        rel = os.path.relpath(d, str(root))
        if "/.minio.sys/config" not in "/" + rel:
            continue
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out


@pytest.mark.parametrize("env", [False, True], ids=["defaults", "env"])
def test_dump_matches_jax(fresh, env):
    if env:
        for k, v in ENV.items():
            fresh.setenv(k, v)
    j, p = jkvs.ConfigSys(), pkvs.ConfigSys()
    assert p.dump() == j.dump()
    assert pkvs.DYNAMIC == jkvs.DYNAMIC
    assert list(pkvs.SUB_SYSTEMS) == list(jkvs.SUB_SYSTEMS)
    for subsys, keys in jkvs.SUB_SYSTEMS.items():
        for key in keys:
            assert p.get(subsys, key) == j.get(subsys, key)
            assert p.source(subsys, key) == j.source(subsys, key)
    if env:
        assert p.dump()["qos"]["interactive_budget_ms"] == {
            "value": "40", "source": "env",
            "env": "MINIO_TPU_QOS_INTERACTIVE_BUDGET_MS",
            "help": "latency budget for interactive dispatch items"}


def _sequence(cfg) -> list:
    """set, set, delete, restore the newest snapshot, set: the history
    each step leaves, newest first."""
    out = []
    cfg.set("qos", "interactive_budget_ms", "250")
    cfg.set("profiler", "hz", "31")
    cfg.delete("qos", "interactive_budget_ms")
    out.append(cfg.list_history())
    cfg.restore_history(out[-1][0]["restore_id"])
    cfg.set("slo", "burn_alert", "9.5")
    out.append(cfg.list_history())
    out.append(cfg.dump())
    return out


def test_sequence_leaves_identical_config_trees(fresh, tmp_path):
    got = {}
    for pkg in ("jax", "port"):
        cfg = KVS[pkg].ConfigSys(layer(pkg, tmp_path / pkg))
        with pinned_clock(fresh):
            got[pkg] = _sequence(cfg)
    assert got["port"] == got["jax"]
    hist = got["port"][1]
    assert [h["cause"] for h in hist] == [
        "set slo.burn_alert", "restore " + got["port"][0][0]["restore_id"],
        "del qos.interactive_budget_ms", "set profiler.hz",
        "set qos.interactive_budget_ms"]
    assert got["port"][2]["qos"]["interactive_budget_ms"]["source"] == \
        "stored"
    jt, pt = config_tree(tmp_path / "jax"), config_tree(tmp_path / "port")
    assert len(pt) == N * (1 + len(hist))
    assert pt == jt


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_others_config(fresh, tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    w = KVS[writer].ConfigSys(layer(writer, tmp_path))
    w.set("api", "requests_max", "7")
    w.set("durability", "fsync", "always")
    w.set("timeline", "ring", "4096")
    r = KVS[reader].ConfigSys(layer(reader, tmp_path))
    assert r.dump() == w.dump()
    assert r.get("api", "requests_max") == "7"
    assert r.source("timeline", "ring") == "stored"
    assert r.list_history() == w.list_history()
    r.restore_history(r.list_history()[-1]["restore_id"])  # the empty one
    w.load()
    assert w.dump() == KVS[writer].ConfigSys().dump()


def test_on_apply_fires_as_the_reference(fresh, tmp_path):
    got = {}
    for pkg in ("jax", "port"):
        cfg = KVS[pkg].ConfigSys(layer(pkg, tmp_path / pkg))
        calls = []
        for subsys in ("qos", "storage_class", "timeline"):
            cfg.on_apply(subsys, lambda c, s=subsys: calls.append(
                (s, c.get("qos", "interactive_budget_ms"))))
        cfg.set("qos", "interactive_budget_ms", "75")
        cfg.set("storage_class", "standard_parity", "EC:3")  # not dynamic
        cfg.delete("qos", "interactive_budget_ms")
        cfg.restore_history(cfg.list_history()[1]["restore_id"])
        got[pkg] = calls[:2] + sorted(calls[2:])
    assert got["port"] == got["jax"]
    assert got["port"][:2] == [("qos", "75"), ("qos", "100")]
    assert ("timeline", "75") in got["port"][2:]


def test_durability_policy_follows_the_registry(fresh, tmp_path):
    from minio_tpu_torch.storage import durability
    cfg = pkvs.get_config_sys(layer("port", tmp_path))
    assert durability.fsync_mode() == "off"
    cfg.set("durability", "fsync", "batched")
    assert durability.fsync_mode() == "batched"
    fresh.setenv("MINIO_TPU_FSYNC", "always")
    assert durability.fsync_mode() == "always"
    fresh.delenv("MINIO_TPU_FSYNC")
    cfg.delete("durability", "fsync")
    assert durability.fsync_mode() == "off"


def _admin(c, method, op, **query):
    return c.request(method, f"/minio/admin/v3/{op}", query=query or None)


def test_config_admin_ops_match_jax(fresh, tmp_path):
    got = {}
    for pkg in ("jax", "port"):
        for mod in (jkvs, pkvs):
            fresh.setattr(mod, "_global", None)
        s = Server(pkg, tmp_path / pkg)
        try:
            c = s.cl
            out = [_admin(c, "GET", "get-config").json()]
            with pinned_clock(fresh):
                for q in ({"subsys": "qos", "key": "interactive_budget_ms",
                           "value": "250"},
                          {"subsys": "profiler", "key": "hz",
                           "value": "31"},
                          {"subsys": "qos", "key": "nope", "value": "1"},
                          {"subsys": "qos"}):
                    r = _admin(c, "PUT", "set-config-kv", **q)
                    out.append((r.status_code, r.content if r.ok else
                                b"<Code>InvalidArgument</Code>" in r.content))
                r = _admin(c, "PUT", "del-config-kv", subsys="profiler",
                           key="hz")
                out.append((r.status_code, r.content))
                hist = _admin(c, "GET", "list-config-history").json()
                out.append(hist)
                for rid in (hist[0]["restore_id"], "nope"):
                    r = _admin(c, "PUT", "restore-config-history",
                               restoreId=rid)
                    out.append(r.status_code)
                out.append(_admin(c, "GET", "get-config").json())
                out.append(len(_admin(c, "GET",
                                      "list-config-history").json()))
                out.append(_admin(c, "PUT", "clear-config-history")
                           .status_code)
                out.append(_admin(c, "GET", "list-config-history").json())
            out.append(config_tree(s.root))
        finally:
            s.close()
        got[pkg] = out
    assert got["port"] == got["jax"]
    doc = got["port"][9]
    assert doc["qos"]["interactive_budget_ms"]["source"] == "stored"
    assert doc["profiler"]["hz"]["source"] == "stored"  # restored
    assert got["port"][3] == got["port"][4] == (400, True)
    assert got["port"][7:9] == [200, 400]
    assert got["port"][12] == []


def test_jax_stored_config_holds_on_a_port_server(fresh, tmp_path):
    """A JAX server stores ``api.requests_max`` and the interactive
    budget; a port server over the same drives takes both, and the
    environment wins over the stored budget."""
    j = Server("jax", tmp_path)
    try:
        for key, value in (("interactive_budget_ms", "250"),):
            r = _admin(j.cl, "PUT", "set-config-kv", subsys="qos", key=key,
                       value=value)
            assert r.status_code == 200
        assert _admin(j.cl, "PUT", "set-config-kv", subsys="api",
                      key="requests_max", value="7").status_code == 200
    finally:
        j.close()
    fresh.setattr(pkvs, "_global", None)
    p = Server("port", tmp_path)
    try:
        assert p.srv.qos_admission.max_requests == 7
        from minio_tpu_torch.obs import slo
        from minio_tpu_torch.qos import CLASS_INTERACTIVE
        assert pbudget.budget_s(CLASS_INTERACTIVE) == 0.25
        assert slo.objective("interactive")["latency_threshold_s"] == 0.25
        fresh.setenv("MINIO_TPU_QOS_INTERACTIVE_BUDGET_MS", "40")
        assert pbudget.budget_s(CLASS_INTERACTIVE) == 0.04
        cfg = _admin(p.cl, "GET", "get-config").json()
        assert cfg["qos"]["interactive_budget_ms"]["source"] == "env"
        assert cfg["api"]["requests_max"] == {
            "value": "7", "source": "stored", "env": "",
            "help": "max in-flight API requests"}
        # a dynamic change reaches the running gate
        assert _admin(p.cl, "PUT", "set-config-kv", subsys="api",
                      key="requests_max", value="9").status_code == 200
        assert p.srv.qos_admission.max_requests == 9
        stored = json.loads(p.srv.obj.get_config(pkvs.CONFIG_PATH))
        assert stored == {"qos": {"interactive_budget_ms": "250"},
                          "api": {"requests_max": "9"}}
    finally:
        p.close()
