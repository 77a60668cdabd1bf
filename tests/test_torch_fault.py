"""The port's fault-injection plane (minio_tpu_torch.fault) and what it
arms, held to the JAX package's (minio_tpu.fault) on the CPU: the rule
grammar's dicts, hit budgets and TTLs, the ``flaky`` draws per seed; an
error fault that PUT and GET ride out within quorum, a bitrot fault that
a GET catches and a deep heal repairs, the deterministic hedged GET
behind a 5 s straggler, a kernel fault salvaged on a CPU queue with the
JAX package's bytes (and failing its waiters under the card's policy), the
admin ``fault`` op and the metric families, the ``fault`` config
subsystem, and for every write step of the commit protocol a crash
followed by startup recovery that leaves the JAX package's tree.

Geometry: 4+2 with 64 KiB blocks, objects of a few hundred KiB (the CPU
queue's plain HighwayHash costs ~0.2 s per flush here)."""
import io
import json
import os
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from minio_tpu import fault as jfault  # noqa: E402
from minio_tpu.objectlayer import ErasureObjects as JObjects  # noqa: E402
from minio_tpu.scanner.janitor import DurabilityJanitor as JJanitor  # noqa
from minio_tpu.storage import XLStorage as JXLStorage  # noqa: E402
from minio_tpu.storage import xlstorage as jxl  # noqa: E402
from minio_tpu.utils import errors as jerrors  # noqa: E402
from minio_tpu_torch import fault  # noqa: E402
from minio_tpu_torch.objectlayer import ErasureObjects  # noqa: E402
from minio_tpu_torch.objectlayer.metadata import hash_order  # noqa: E402
from minio_tpu_torch.obs.metrics import counters_snapshot  # noqa: E402
from minio_tpu_torch.scanner.janitor import DurabilityJanitor  # noqa: E402
from minio_tpu_torch.storage import XLStorage  # noqa: E402
from minio_tpu_torch.storage import xlstorage as pxl  # noqa: E402
from minio_tpu_torch.utils import errors  # noqa: E402
from test_torch_objectlayer import pin, tree  # noqa: E402,F401

N, PARITY, BLOCK = 6, 2, 1 << 16
SEED = 20261018
OBJ = 200_001


@pytest.fixture(autouse=True)
def _clean_faults():
    fault.clear()
    jfault.clear()
    yield
    fault.clear()
    jfault.clear()


def _body(n: int = OBJ, seed: int = 0) -> bytes:
    return np.random.default_rng(SEED + seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _layer(root, pkg: str = "port"):
    # zero-padded directories: fault targets match by substring
    if pkg == "port":
        disks = [XLStorage(os.path.join(str(root), f"d{i:02d}"))
                 for i in range(N)]
        return ErasureObjects(disks, default_parity=PARITY, block_size=BLOCK,
                              device="cpu")
    disks = [JXLStorage(os.path.join(str(root), f"d{i:02d}"))
             for i in range(N)]
    return JObjects(disks, default_parity=PARITY, block_size=BLOCK)


def _shard_disk(ol, obj: str, shard_idx: int = 1):
    """The disk holding data shard ``shard_idx`` of ``b/obj``."""
    return ol.disks[hash_order(f"b/{obj}", N).index(shard_idx)]


def _count(name: str, **labels) -> float:
    want = [f'{k}="{v}"' for k, v in labels.items()]
    return sum(v for k, v in counters_snapshot().items()
               if k.startswith(name) and all(w in k for w in want))


# --- the registry -------------------------------------------------------------

SPECS = (
    "disk:*:read_at:delay(200,50)@ttl=30",
    "disk:/data/d3:*:error(FaultyDisk)@count=8",
    "disk:d01:read_at:bitrot@count=1",
    "disk:*:pre_meta_write:crash",
    "disk:*:pre_replace:torn@seed=7",
    "disk:*:stat:hang",
    "disk:*:stat:hang(2.5)",
    "disk:*:read_all:flaky(0.3,42)",
    "disk:*:read_all:flaky(0.25,9,DiskNotFound)@count=3@ttl=4",
    "disk:::error",
    "rpc:http://peer:9000:readversion:flaky(0.3,42)",
    "rpc:*:*:delay(10)",
    "kernel:*:encode:error(FaultyDisk)@count=1",
    "kernel:device:*:delay(50)@count=8",
    "kernel:*::error(FileCorrupt)@count=2",
    "node:http://b:9000:*:partition",
    "node:http://b:9000:*:partition(http://a:9000)",
)
BAD_SPECS = ("disk:*:x:explode", "disk:*:x:error(NoSuchError)", "nolayer",
             "gpu:*:*:error", "disk:*:x:delay", "disk:*:x:flaky",
             "disk:*:x:flaky(1.5)", "disk:*:x:error@when=now", "disk:*")


@pytest.mark.parametrize("spec", SPECS)
def test_parse_rule_gives_the_jax_dicts(spec):
    assert fault.parse_rule(spec).to_dict() == \
        jfault.parse_rule(spec).to_dict()


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_rules_are_refused_alike(spec):
    with pytest.raises(ValueError):
        jfault.parse_rule(spec)
    with pytest.raises(ValueError):
        fault.parse_rule(spec)


def _run(mod, errs, spec: str, calls: int, target: str = "/d0",
         op: str = "stat") -> list:
    """What ``calls`` injections of one fresh rule do: 0 pass, 1 a typed
    error, 2 BITROT; and the rules left."""
    reg = mod.FaultRegistry()
    reg.arm(spec)
    out = []
    for _ in range(calls):
        try:
            res = reg.inject("disk", target, op)
            out.append(2 if res is mod.BITROT else 0)
        except errs.StorageError:
            out.append(1)
    return out, [{k: v for k, v in r.items() if k != "id"}
                 for r in reg.rules()]


@pytest.mark.parametrize("spec", [
    "disk:*:stat:error(FaultyDisk)@count=2", "disk:*:stat:bitrot@count=3",
    "disk:/d0:stat:error", "disk:/d9:stat:error", "disk:*:walk:error",
    "disk:*:stat:flaky(0.5,1234)", "disk:*:stat:flaky(0.2,7)@count=5",
    "disk:*:*:flaky(0.9,99,DiskFull)"])
def test_hit_counts_and_flaky_draws_match_the_jax_registry(spec):
    assert _run(fault, errors, spec, 40) == _run(jfault, jerrors, spec, 40)
    got, _ = _run(fault, errors, spec, 40)
    if "flaky(0.5" in spec:
        assert 0 < sum(got) < 40


def test_ttl_disarms_and_clear_interrupts_a_hang():
    fault.arm("disk:*:stat:error(FaultyDisk)@ttl=0.05")
    time.sleep(0.08)
    assert fault.inject("disk", "/d0", "stat") is None
    assert fault.rules() == []
    fault.arm("disk:*:stat:hang(30)")
    import threading
    t0 = time.perf_counter()
    th = threading.Thread(target=fault.inject, args=("disk", "/d0", "stat"))
    th.start()
    time.sleep(0.1)
    fault.clear()
    th.join(5)
    assert not th.is_alive() and time.perf_counter() - t0 < 3
    assert not fault.armed() and not fault.armed("disk")


def test_crash_is_a_base_exception_and_torn_truncates(tmp_path):
    assert issubclass(fault.SimulatedCrash, BaseException)
    assert not issubclass(fault.SimulatedCrash, Exception)
    import random
    for mod in (fault, jfault):
        p = tmp_path / f"{mod.__name__}.bin"
        p.write_bytes(bytes(1000))
        cut = mod.torn_truncate(str(p), random.Random(5))
        assert 0 <= cut < 1000 and p.stat().st_size == cut
    assert (tmp_path / "minio_tpu_torch.fault.bin").stat().st_size == \
        (tmp_path / "minio_tpu.fault.bin").stat().st_size
    assert fault.corrupt(b"abcd") == jfault.corrupt(b"abcd") != b"abcd"
    assert fault.corrupt(b"") == b""
    assert pxl.WRITE_STEPS == jxl.WRITE_STEPS


def test_config_subsystem_arms_and_replaces_its_rules(monkeypatch):
    """``fault.rules`` arms through apply_config; a change replaces only
    the rules the config armed; ``fault.enable=0`` disarms them."""
    class Cfg:
        def __init__(self, enable, rules):
            self.v = {"enable": enable, "rules": rules}

        def get(self, sub, key):
            assert sub == "fault"
            return self.v[key]

    own = fault.arm("disk:*:stat:delay(1)")
    fault.apply_config(Cfg("1", "disk:*:read_at:bitrot;bad rule;"
                                "kernel:*:encode:error@count=1"))
    layers = sorted(r["layer"] for r in fault.rules())
    assert layers == ["disk", "disk", "kernel"]
    fault.apply_config(Cfg("1", "disk:*:read_all:error"))
    assert sorted(r["op"] for r in fault.rules()) == ["read_all", "stat"]
    fault.apply_config(Cfg("0", "disk:*:read_all:error"))
    assert [r["id"] for r in fault.rules()] == [own]


# --- the disk layer -----------------------------------------------------------


def test_error_fault_leaves_put_and_get_within_quorum(tmp_path):
    ol = _layer(tmp_path)
    ol.make_bucket("b")
    calls = []
    ol.on_partial = \
        lambda b, o, v="", scan_mode="normal": calls.append((o, scan_mode))
    body = _body()
    ol.put_object("b", "seed", io.BytesIO(body), len(body))
    before = _count("minio_tpu_fault_injected_total", layer="disk",
                    action="error")
    d1 = _shard_disk(ol, "seed", 1)
    fault.arm(f"disk:{d1.endpoint()}:*:error(FaultyDisk)")
    ol.put_object("b", "o", io.BytesIO(body), len(body))
    assert ol.get_object_bytes("b", "o") == body
    assert ol.get_object_bytes("b", "seed") == body
    assert calls
    assert _count("minio_tpu_fault_injected_total", layer="disk",
                  action="error") > before


def test_bitrot_fault_detected_and_deep_healed(tmp_path):
    ol = _layer(tmp_path)
    ol.make_bucket("b")
    calls = []
    ol.on_partial = \
        lambda b, o, v="", scan_mode="normal": calls.append(scan_mode)
    body = _body()
    ol.put_object("b", "o", io.BytesIO(body), len(body))
    d = _shard_disk(ol, "o", 1)
    fault.arm(f"disk:{d.endpoint()}:read_at:bitrot@count=1")
    assert ol.get_object_bytes("b", "o") == body
    assert "deep" in calls
    fault.clear()
    # real rot on the disk: the deep heal classifies and rewrites it
    fi = d.read_version("b", "o")
    part = f"o/{fi.data_dir}/part.1"
    blob = bytearray(d.read_all("b", part))
    blob[len(blob) // 2] ^= 0xFF
    d.write_all("b", part, bytes(blob))
    res = ol.heal_object("b", "o", scan_mode="deep")
    assert "corrupt" in res.before_state
    assert res.after_state.count("ok") == N
    assert ol.get_object_bytes("b", "o") == body


def test_hedged_get_fires_deterministic(tmp_path, monkeypatch):
    """A five-second delay on one data shard's disk and a 15 ms hedge
    threshold: the GET is right in under 4 s only if the hedged parity
    read rescued it, and ``fired`` rises."""
    ol = _layer(tmp_path)
    ol.make_bucket("b")
    body = _body(256 << 10, 1)
    ol.put_object("b", "o", io.BytesIO(body), len(body))
    d = _shard_disk(ol, "o", 1)
    assert ol.get_object_bytes("b", "o") == body  # warm the GET path
    monkeypatch.setenv("MINIO_TPU_HEDGE_MS", "15")
    fired = _count("minio_tpu_hedged_reads_total", outcome="fired")
    partial = []
    ol.on_partial = lambda *a, **kw: partial.append(a)
    fault.arm(f"disk:{d.endpoint()}:read_at:delay(5000)")
    try:
        t0 = time.perf_counter()
        assert ol.get_object_bytes("b", "o") == body
        wall = time.perf_counter() - t0
    finally:
        fault.clear()
    assert wall < 4.0, f"GET took {wall:.2f}s: no hedge rescued the read"
    assert _count("minio_tpu_hedged_reads_total", outcome="fired") > fired
    assert partial == []  # a straggler is not a failure
    from minio_tpu_torch.erasure import streaming
    assert streaming.hedge_threshold_s() == 0.015
    monkeypatch.setenv("MINIO_TPU_HEDGE", "0")
    assert not streaming.hedging_enabled()


def test_adaptive_hedge_threshold_clamps(monkeypatch):
    from minio_tpu.erasure import streaming as jst
    from minio_tpu.obs import latency as jlat
    from minio_tpu_torch.erasure import streaming as pst
    from minio_tpu_torch.obs import latency as plat
    for st, lat in ((pst, plat), (jst, jlat)):
        monkeypatch.setattr(st, "_threshold_cache", (0.0, -1.0))
        lat.reset_window("hedge", op="shard_read")
    assert pst.hedge_threshold_s() == jst.hedge_threshold_s() == 0.025
    for st, lat in ((pst, plat), (jst, jlat)):
        for _ in range(50):
            lat.observe("hedge", 0.1, 1, op="shard_read")
        monkeypatch.setattr(st, "_threshold_cache", (0.0, -1.0))
    assert pst.hedge_threshold_s() == pytest.approx(jst.hedge_threshold_s())
    assert 0.025 < pst.hedge_threshold_s() <= 1.0
    monkeypatch.setenv("MINIO_TPU_HEDGE_CEIL_MS", "40")
    for st in (pst, jst):
        monkeypatch.setattr(st, "_threshold_cache", (0.0, -1.0))
    assert pst.hedge_threshold_s() == jst.hedge_threshold_s() == 0.04


# --- the kernel layer ---------------------------------------------------------


def test_kernel_error_is_salvaged_on_a_cpu_queue_with_the_jax_bytes():
    from minio_tpu.erasure.codec import Erasure as JErasure
    from minio_tpu_torch.erasure.codec import Erasure
    from minio_tpu_torch.runtime.dispatch import DispatchQueue
    data = _body(256 << 10, 3)
    want = [s.tobytes() for s in JErasure(4, 2, 1 << 20).encode_data(data)]
    q = DispatchQueue(device="cpu")
    try:
        er = Erasure(4, 2, 1 << 20, device="cpu")
        er._queue = q
        before = _count("minio_tpu_fault_injected_total", layer="kernel",
                        action="error")
        fault.arm("kernel:*:encode:error(FaultyDisk)@count=4")
        got = [s.tobytes() for s in er.encode_data_async(data).result()]
        assert got == want
        st = q.stats()
        assert st["salvaged_batches"] >= 1 and st["failed_batches"] == 0
        assert _count("minio_tpu_fault_injected_total", layer="kernel",
                      action="error") > before
        # a delay rule holds the flush, the bytes stay right
        fault.clear()
        fault.arm("kernel:device:*:delay(30)@count=2")
        t0 = time.perf_counter()
        got = [s.tobytes() for s in er.encode_data_async(data).result()]
        assert got == want and time.perf_counter() - t0 >= 0.03
        # the card's policy: the flush's waiters get the error, counted
        fault.clear()
        q.host_salvage = False
        fault.arm("kernel:device:*:error(FaultyDisk)@count=1")
        with pytest.raises(errors.FaultyDisk):
            er.encode_data_async(data).result()
        assert q.stats()["failed_batches"] == 1
        got = [s.tobytes() for s in er.encode_data_async(data).result()]
        assert got == want
    finally:
        q.stop()


# --- the admin op and the metric families -------------------------------------


def _families(text: str, names) -> dict:
    out = {}
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, fam, typ = ln.split()
            if fam in names:
                out.setdefault(fam, [typ, set()])
        elif not ln.startswith("#"):
            name = ln.split("{", 1)[0].split(" ", 1)[0]
            if name in names and "{" in ln:
                labels = ln.split("{", 1)[1].split("}", 1)[0]
                out[name][1] |= {kv.split("=", 1)[0]
                                 for kv in labels.split(",")}
    return {k: (v[0], frozenset(v[1])) for k, v in out.items()}


def test_admin_fault_op_and_metric_families(tmp_path, monkeypatch):
    from minio_tpu.obs.metrics import render_prometheus as jrender
    from minio_tpu.server import S3Server as JServer
    from minio_tpu_torch.obs.metrics import render_prometheus
    from minio_tpu_torch.server import S3Server
    from s3client import S3Client
    ak, sk = "fak", "fsecret1"
    out = {}
    for pkg, mod in (("jax", jfault), ("port", fault)):
        obj = _layer(tmp_path / pkg, pkg)
        srv = (S3Server(obj, "127.0.0.1", 0, access_key=ak, secret_key=sk,
                        device="cpu") if pkg == "port" else
               JServer(obj, "127.0.0.1", 0, access_key=ak, secret_key=sk))
        srv.start_background()
        try:
            c = S3Client(srv.endpoint(), ak, sk)
            path = "/minio/admin/v3/fault"
            r = c.request("POST", path, body=json.dumps(
                {"rule": "disk:*:read_at:delay(1)@ttl=60"}).encode())
            rid = r.json()["id"]
            st = c.request("GET", path).json()
            assert [x["id"] for x in st["rules"]] == [rid]
            assert st["disks"] and all(x["state"] == "ok"
                                       for x in st["disks"])
            r2 = c.request("POST", path, body=json.dumps(
                {"layer": "kernel", "op": "encode", "action": "error",
                 "count": 1}).encode())
            rules = c.request("GET", path).json()["rules"]
            bad = c.request("POST", path, body=b'{"rule": "disk:*:x:boom"}')
            unknown = c.request("DELETE", path, query={"id": "f999999"})
            gone = c.request("DELETE", path, query={"id": rid})
            left = [x["id"] for x in c.request("GET", path).json()["rules"]]
            cleared = c.request("DELETE", path)
            out[pkg] = {
                "rules": [{k: v for k, v in x.items() if k != "id"}
                          for x in rules],
                "statuses": (r.status_code, r2.status_code, bad.status_code,
                             unknown.status_code, gone.status_code,
                             cleared.status_code),
                "left": left == [r2.json()["id"]],
                "after": c.request("GET", path).json()["rules"]}
            # a hedged GET and an injected error feed the families
            c.request("PUT", "/fb")
            body = _body(200_000, 4)
            c.request("PUT", "/fb/o", body=body)
            monkeypatch.setenv("MINIO_TPU_HEDGE_MS", "15")
            d = obj.disks[hash_order("fb/o", N).index(1)]
            mod.arm(f"disk:{d.endpoint()}:read_at:delay(400)")
            assert c.request("GET", "/fb/o").content == body
            mod.clear()
            monkeypatch.delenv("MINIO_TPU_HEDGE_MS")
            render = render_prometheus if pkg == "port" else jrender
            out[pkg]["families"] = _families(
                render(srv).decode(),
                ("minio_tpu_fault_injected_total",
                 "minio_tpu_hedged_reads_total",
                 "minio_tpu_hedge_threshold_seconds"))
        finally:
            srv.shutdown()
    assert out["port"] == out["jax"]
    assert out["port"]["statuses"] == (200, 200, 400, 400, 200, 200)
    fams = out["port"]["families"]
    assert fams["minio_tpu_fault_injected_total"] == \
        ("counter", frozenset({"layer", "action"}))
    assert fams["minio_tpu_hedged_reads_total"] == \
        ("counter", frozenset({"outcome"}))
    assert fams["minio_tpu_hedge_threshold_seconds"][0] == "gauge"


# --- crash points: the commit protocol's write steps -------------------------

OBJ_CRASH = 200_000  # over the inline threshold: a data dir per object


def _crash_then_recover(root, pkg: str, step: str) -> None:
    """One package's crash at ``step`` and its restart: a committed
    object, then the write that dies at the step on every disk, then a
    new layer over the same directories (startup recovery) and a zero-age
    janitor sweep."""
    mod = jfault if pkg == "jax" else fault
    ol = _layer(root, pkg)
    ol.make_bucket("b")
    body1, body2 = _body(OBJ_CRASH, 11), _body(OBJ_CRASH, 12)
    ol.put_object("b", "o", io.BytesIO(body1), OBJ_CRASH)
    if step == "pre_append":
        # no object commit appends: a disk's append_file dies before it
        mod.arm(f"disk:*:{step}:crash")
        with pytest.raises(mod.SimulatedCrash):
            ol.disks[0].append_file("b", "log.bin", b"appended")
    elif step == "pre_rename_file":
        uid = ol.new_multipart_upload("b", "m")
        part = ol.put_object_part("b", "m", uid, 1, io.BytesIO(body2),
                                  OBJ_CRASH)
        mod.arm(f"disk:*:{step}:crash")
        with pytest.raises(mod.SimulatedCrash):
            ol.complete_multipart_upload("b", "m", uid, [part])
    else:
        mod.arm(f"disk:*:{step}:crash")
        with pytest.raises(mod.SimulatedCrash):
            ol.put_object("b", "o", io.BytesIO(body2), OBJ_CRASH)
    time.sleep(0.3)  # the other disks' commits reach the step too
    mod.clear()
    ol2 = _layer(root, pkg)
    (JJanitor if pkg == "jax" else DurabilityJanitor)(ol2).sweep(
        tmp_age_s=0.0, reconcile=True, ddir_age_s=0.0)
    data = ol2.get_object_bytes("b", "o")
    assert data in (body1, body2), f"torn object after a crash at {step}"


@pytest.mark.parametrize("step", pxl.WRITE_STEPS)
def test_crash_at_each_write_step_recovers_to_the_jax_tree(tmp_path, pin,
                                                           step):
    for pkg in ("jax", "port"):
        pin.reset()
        _crash_then_recover(tmp_path / pkg, pkg, step)
    want, got = tree(tmp_path / "jax"), tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert got == want
    for pkg in ("jax", "port"):
        for d in sorted(os.listdir(tmp_path / pkg)):
            tmpdir = tmp_path / pkg / d / ".minio.sys" / "tmp"
            assert not tmpdir.exists() or os.listdir(tmpdir) == [], \
                (pkg, d)
