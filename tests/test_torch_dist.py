"""The port's distributed plane (minio_tpu_torch.dist, utils/dyntimeout,
fault/node, objectlayer/monitor) held to the JAX package's on the pieces
that need no cluster: the self-adapting timeout and the dsync lockers on
scripted sequences (dead lockers included), the lock maintenance verdicts,
endpoint parsing, the RPC bearer tokens and typed errors, the storage REST
bodies through the port's MessagePack subset against the wheel, the node
chaos rule grammar and the set disk monitor. Sequences come from a seeded
numpy generator; every answer is compared exactly."""
import os
import shutil
import threading
import time
import uuid

import msgpack
import numpy as np
import pytest

from minio_tpu import fault as jfault
from minio_tpu.dist import dsync as jdsync
from minio_tpu.dist import endpoints as jendpoints
from minio_tpu.dist import lock_rest as jlock_rest
from minio_tpu.dist import rpc as jrpc
from minio_tpu.dist.format import init_format_erasure as jinit_format
from minio_tpu.dist.format import load_format as jload_format
from minio_tpu.fault import node as jfault_node
from minio_tpu.objectlayer import monitor as jmonitor
from minio_tpu.objectlayer.sets import ErasureSets as JSets
from minio_tpu.storage import XLStorage as JXLStorage
from minio_tpu.storage.datatypes import DiskInfo as JDiskInfo
from minio_tpu.storage.datatypes import FileInfo as JFileInfo
from minio_tpu.utils import dyntimeout as jdyn
from minio_tpu.utils import errors as jerrors
from minio_tpu_torch import fault as pfault
from minio_tpu_torch.dist import dsync as pdsync
from minio_tpu_torch.dist import endpoints as pendpoints
from minio_tpu_torch.dist import lock_rest as plock_rest
from minio_tpu_torch.dist import rpc as prpc
from minio_tpu_torch.dist.format import init_format_erasure as pinit_format
from minio_tpu_torch.dist.format import load_format as pload_format
from minio_tpu_torch.fault import node as pfault_node
from minio_tpu_torch.objectlayer import monitor as pmonitor
from minio_tpu_torch.objectlayer.sets import ErasureSets as PSets
from minio_tpu_torch.storage import XLStorage as PXLStorage
from minio_tpu_torch.storage.datatypes import DiskInfo as PDiskInfo
from minio_tpu_torch.storage.datatypes import FileInfo as PFileInfo
from minio_tpu_torch.utils import dyntimeout as pdyn
from minio_tpu_torch.utils import errors as perrors
from minio_tpu_torch.utils import msgpack as pmsgpack

SEED = 20261019


@pytest.fixture(autouse=True)
def clean_faults():
    """The fault registries are process-global in both packages."""
    jfault.clear()
    pfault.clear()
    yield
    jfault.clear()
    pfault.clear()


# --- DynamicTimeout ----------------------------------------------------------


@pytest.mark.parametrize("fail_share", [0.0, 0.05, 0.2, 0.5, 0.9])
def test_dynamic_timeout_follows_the_same_script(fail_share):
    """The same outcomes logged into both timeouts give the same timeout
    after every entry: raised 25% past a third of failures, decayed
    toward 125% of the slowest success below a tenth, never under the
    floor."""
    rng = np.random.default_rng(SEED + int(fail_share * 100))
    timeouts = (jdyn.DynamicTimeout(10.0, 0.5),
                pdyn.DynamicTimeout(10.0, 0.5))
    for _ in range(16 * 12):
        fail = rng.random() < fail_share
        dur = float(rng.uniform(0.01, 3.0))
        got = []
        for t in timeouts:
            if fail:
                t.log_failure()
            else:
                t.log_success(dur)
            got.append(t.timeout())
        assert got[0] == got[1]
    with pytest.raises(ValueError):
        pdyn.DynamicTimeout(0, 1)


# --- dsync -------------------------------------------------------------------


def test_local_locker_scripted_sequence():
    """A seeded script of lock, unlock, rlock, runlock, expired and
    force_unlock over a few resources and uids: every answer and the
    final table agree."""
    rng = np.random.default_rng(SEED)
    lockers = (jdsync.LocalLocker(), pdsync.LocalLocker())
    ops = ("lock", "unlock", "rlock", "runlock", "expired", "force_unlock")
    for _ in range(2000):
        op = ops[rng.integers(len(ops))]
        res = f"b/o{rng.integers(3)}"
        uid = f"u{rng.integers(4)}"
        owner = f"http://n{rng.integers(2)}"
        answers = []
        for lk in lockers:
            if op in ("lock", "rlock"):
                answers.append(getattr(lk, op)(res, uid, owner))
            elif op == "force_unlock":
                answers.append(lk.force_unlock(res))
            else:
                answers.append(getattr(lk, op)(res, uid))
        assert answers[0] == answers[1], op

    def table(lk):
        return {r: sorted((e["uid"], e["owner"], e["writer"]) for e in es)
                for r, es in lk.snapshot().items()}

    assert table(lockers[0]) == table(lockers[1])


class _Dead:
    """A locker whose node is gone."""

    def lock(self, *a):
        raise ConnectionError("dead")

    rlock = unlock = runlock = expired = lock


@pytest.mark.parametrize("n_live,n_dead", [(5, 0), (3, 2), (2, 3), (1, 0),
                                           (2, 2), (3, 1)])
def test_drwmutex_quorum_with_dead_lockers(n_live, n_dead):
    """Write quorum n/2+1 and read quorum n/2 with dead lockers voting no:
    both packages grant and refuse alike, and hold the same entries."""
    out = []
    for ds in (jdsync, pdsync):
        lockers = [ds.LocalLocker() for _ in range(n_live)] + \
            [_Dead() for _ in range(n_dead)]
        w = ds.DRWMutex(lockers, "b/o", owner="n1")
        got_w = w.get_lock(timeout=0.2)
        held = [bool(lk.snapshot()) for lk in lockers[:n_live]]
        if got_w:
            w.unlock()
        r1 = ds.DRWMutex(lockers, "b/o", owner="n2")
        r2 = ds.DRWMutex(lockers, "b/o", owner="n3")
        got_r = (r1.get_rlock(timeout=0.2), r2.get_rlock(timeout=0.2))
        blocked = ds.DRWMutex(lockers, "b/o", owner="n4").get_lock(
            timeout=0.1)
        for m in (r1, r2):
            m.unlock()
        out.append((got_w, held, got_r, blocked))
    assert out[0] == out[1]


def test_failed_quorum_releases_partial_grants():
    """A failed write quorum releases what it was granted (asynchronously)
    in both packages, and the port's namespace map counts the timeout."""
    for ds in (jdsync, pdsync):
        lockers = [ds.LocalLocker(), ds.LocalLocker(), _Dead(), _Dead(),
                   _Dead()]
        nsl = ds.NSLockMap(lambda: lockers, owner="n1")
        m = nsl.new_lock("b", "o")
        assert not m.get_lock(timeout=0.2)
        deadline = time.monotonic() + 5
        while any(lk.snapshot() for lk in lockers[:2]) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert not any(lk.snapshot() for lk in lockers[:2])
    st = nsl.stats.snapshot()
    assert st["timed_out"] == 1 and st["acquired"] == 0


def test_namespace_lock_stats_count_acquisitions():
    lockers = [pdsync.LocalLocker() for _ in range(3)]
    nsl = pdsync.NSLockMap(lambda: lockers, owner="n1")
    for i in range(5):
        m = nsl.new_lock("b", f"o{i}")
        assert m.get_lock(timeout=1.0)
        m.unlock()
    st = nsl.stats.snapshot()
    assert st["acquired"] == 5 and st["timed_out"] == 0
    assert len(st["seconds"]) == 5 and all(s >= 0 for s in st["seconds"])


class _Owner:
    """An owner's lock client answering ``expired_info`` from a script:
    True (released), False (still held), None (unreachable)."""

    def __init__(self, verdict):
        self.verdict = verdict

    def expired_info(self, resource, uid):
        return self.verdict


@pytest.mark.parametrize("verdict", [True, False, None])
def test_lock_maintenance_verdicts(verdict, monkeypatch):
    """Released owners are reclaimed at once, held ones renewed, and
    unreachable ones after OWNER_DEAD_STRIKES passes — in both."""
    out = []
    for ds, lr in ((jdsync, jlock_rest), (pdsync, plock_rest)):
        locker = ds.LocalLocker()
        assert locker.lock("b/o", "u1", "http://peer")
        assert locker.lock("b/own", "u2", "http://me")
        svc = lr.LockRESTService(
            locker, owner_lockers_fn=lambda: {"http://peer":
                                              _Owner(verdict)},
            local_owner="http://me")
        passes = []
        for _ in range(lr.OWNER_DEAD_STRIKES + 1):
            passes.append(svc.maintenance_pass(lease_s=0.0))
        out.append((passes, sorted(locker.snapshot())))
    assert out[0] == out[1]


# --- endpoints ---------------------------------------------------------------


ENDPOINT_CASES = [
    ["/data/d1", "/data/d2"],
    ["/data/d{1...4}"],
    ["http://a:9000/d1", "http://a:9000/d2", "http://b:9000/d1"],
    ["http://h{1...3}:9000/export{1...2}"],
    ["https://a:9443/x"],
    ["http://a:9000/d1", "/local"],
    ["http://a:9000", "http://a:9000/"],
]


@pytest.mark.parametrize("args", ENDPOINT_CASES,
                         ids=[str(i) for i in range(len(ENDPOINT_CASES))])
def test_parse_endpoints(args):
    def parse(mod):
        try:
            eps = mod.parse_endpoints(args)
        except ValueError as e:
            return ("error", str(e))
        return ([(e.url, e.path, e.is_local_path, str(e)) for e in eps],
                mod.nodes_of(eps))
    assert parse(jendpoints) == parse(pendpoints)


# --- tokens and typed errors -------------------------------------------------


def test_tokens_cross_the_packages(monkeypatch):
    for make, check in ((jrpc.make_token, prpc.check_token),
                        (prpc.make_token, jrpc.check_token)):
        tok = make("cluster-secret")
        assert check("cluster-secret", tok)
        assert not check("other-secret", tok)
        assert not check("cluster-secret", tok + "0")
        assert not check("cluster-secret", "garbage")
        assert not check("cluster-secret", make("cluster-secret", -10))
    monkeypatch.setattr(jrpc.time, "time", lambda: 1.8e9)
    monkeypatch.setattr(prpc.time, "time", lambda: 1.8e9)
    assert jrpc.make_token("s", 60) == prpc.make_token("s", 60)


class _Handler:
    """What rpc_error_response writes, captured."""

    def __init__(self):
        self.lines = []
        self.body = b""
        self.wfile = self

    def send_response(self, code):
        self.lines.append(("status", code))

    def send_header(self, k, v):
        self.lines.append((k, v))

    def end_headers(self):
        self.lines.append(("end",))

    def write(self, b):
        self.body += b


@pytest.mark.parametrize("name", sorted(jrpc._ERR_BY_NAME) + ["ValueError"])
def test_typed_errors_on_the_wire(name):
    """Each typed storage error goes out as the same status, header and
    body from both packages, and each package's table maps the name to
    its own class of that name."""
    out = []
    for errs in (jerrors, perrors):
        cls = getattr(errs, name, ValueError)
        h = _Handler()
        (jrpc if errs is jerrors else prpc).rpc_error_response(
            h, cls("disk /d1: boom"))
        out.append((h.lines, h.body))
    assert out[0] == out[1]
    if name != "ValueError":
        assert prpc._ERR_BY_NAME[name] is getattr(perrors, name)


# --- the storage REST bodies through the port's MessagePack ------------------


def _fileinfos(pkg) -> list:
    fi_cls = JFileInfo if pkg == "jax" else PFileInfo
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(4):
        fi = fi_cls(volume="bkt", name=f"dir/obj-{i}", version_id=str(
            uuid.UUID(int=i + 1)) if i % 2 else "", data_dir=str(
            uuid.UUID(int=100 + i)), mod_time=1.7e9 + i / 7,
            size=int(rng.integers(0, 1 << 40)),
            metadata={"etag": f"{i:032x}", "content-type": "text/csv",
                      "x-amz-meta-ü": "välue" * i},
            deleted=i == 3, num_versions=i, fresh=i == 0)
        fi.erasure.data_blocks, fi.erasure.parity_blocks = 8, 8
        fi.erasure.block_size = 1 << 20
        fi.erasure.index = i + 1
        fi.erasure.distribution = list(range(1, 17))
        fi.data = rng.bytes(300 * i) if i else None
        out.append(fi)
    return out


def _bodies(pkg) -> list:
    fis = _fileinfos(pkg)
    di = (JDiskInfo if pkg == "jax" else PDiskInfo)(
        total=1 << 40, free=123, used=456, fs_type="ext4",
        endpoint="http://a:9000/d1", id=str(uuid.UUID(int=7)))
    return [fis[0].to_rpc(), [fi.to_rpc() for fi in fis], di.__dict__,
            {"paths": [f.name for f in fis], "fis": [f.to_rpc()
                                                     for f in fis]},
            [None, "FaultyDisk: x", None],
            [("a/b", b"\x00" * 70000), ("c", b"")],
            [f"obj-{i}/" for i in range(40)],
            [{"name": "b", "created": 1.7e9}]]


def test_storage_bodies_pack_as_the_wheel_does():
    """Every body the storage REST client and service exchange: the
    port's packb gives the wheel's bytes, and each unpacks the other's;
    both packages' FileInfo wire dicts are the same."""
    jb, pb = _bodies("jax"), _bodies("port")
    for j, p in zip(jb, pb):
        wheel = msgpack.packb(j, use_bin_type=True)
        assert pmsgpack.packb(p) == wheel
        assert pmsgpack.unpackb(wheel) == msgpack.unpackb(wheel, raw=False)
    for j, p in zip(_fileinfos("jax"), _fileinfos("port")):
        back = PFileInfo.from_rpc(pmsgpack.unpackb(
            msgpack.packb(j.to_rpc(), use_bin_type=True)))
        assert back == p
        assert JFileInfo.from_rpc(msgpack.unpackb(pmsgpack.packb(
            p.to_rpc()), raw=False)).to_rpc() == j.to_rpc()


# --- node chaos rule grammar -------------------------------------------------


def _rules(fault) -> list:
    return sorted((r["layer"], r["target"], r["op"], r["action"])
                  for r in fault.rules())


def test_node_rule_grammar():
    """partition, isolate and slow_peer arm the same node-layer rules in
    both packages; clear_node_faults drops only those."""
    for fault, fnode in ((jfault, jfault_node), (pfault, pfault_node)):
        fault.arm("disk:/d1:read_at:delay(5)")
        fnode.partition("http://b:9000", "http://a:9000")
        fnode.partition("http://c:9000", count=3)
        fnode.isolate("http://d:9000")
        fnode.slow_peer("http://e:9000", 250, jitter_ms=20, ttl=30)
    assert _rules(jfault) == _rules(pfault)
    for fault in (jfault, pfault):
        assert fault.blocked("node", "http://b:9000", "http://a:9000")
        assert not fault.blocked("node", "http://a:9000", "http://b:9000")
        with pytest.raises(perrors.RPCError if fault is pfault
                           else jerrors.RPCError):
            fault.inject("node", "http://b:9000", "http://a:9000")
    assert jfault_node.clear_node_faults() == \
        pfault_node.clear_node_faults() == 5
    assert _rules(jfault) == _rules(pfault) == [
        ("disk", "/d1", "read_at", "delay")]


def test_node_kill_of_an_unknown_node_names_the_known_ones():
    pfault_node.register_node("lc-x-n0", object())
    try:
        with pytest.raises(KeyError, match="lc-x-n0"):
            pfault_node.node_kill("nope")
        with pytest.raises(RuntimeError, match="restart spec"):
            pfault_node.node_restart("lc-x-n0")
    finally:
        pfault_node.unregister_node("lc-x-n0")


# --- the set disk monitor ----------------------------------------------------


def _monitor_run(pkg: str, root: str) -> tuple:
    disk = JXLStorage if pkg == "jax" else PXLStorage
    init = jinit_format if pkg == "jax" else pinit_format
    load = jload_format if pkg == "jax" else pload_format
    disks = [disk(os.path.join(root, f"m{i}")) for i in range(8)]
    fmt = init(disks, 2, 4)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    sets = (JSets if pkg == "jax" else PSets)(disks, 2, 4,
                                             deployment_id=fmt["id"], **kw)
    mon = (jmonitor if pkg == "jax" else pmonitor).SetDiskMonitor(
        sets, fmt, on_connect=lambda si, sl, d: connects.append((si, sl)))
    connects: list = []
    # two disks swapped across the sets (cables moved)
    a, b = sets.sets[0]._disks[1], sets.sets[1]._disks[2]
    sets.sets[0]._disks[1], sets.sets[1]._disks[2] = b, a
    first = mon.check_once()
    slots = [[load(d)["xl"]["this"] == fmt["xl"]["sets"][si][sl]
              for sl, d in enumerate(es._disks)]
             for si, es in enumerate(sets.sets)]
    # one disk wiped: re-formatted into its slot
    victim = sets.sets[1]._disks[0]
    base = victim.root if pkg == "port" else victim.base
    shutil.rmtree(base)
    os.makedirs(os.path.join(base, ".minio.sys", "tmp"))
    second = mon.check_once()
    this = load(victim)["xl"]["this"] == fmt["xl"]["sets"][1][0]
    return first, slots, second, this, connects


def test_set_disk_monitor_reslots_and_reformats(tmp_path):
    j = _monitor_run("jax", str(tmp_path / "jax"))
    p = _monitor_run("port", str(tmp_path / "port"))
    assert j == p
    assert p[2] == {"reslotted": 0, "reformatted": 1} and p[3]


def test_monitor_thread_stops(tmp_path):
    disks = [PXLStorage(str(tmp_path / f"m{i}")) for i in range(4)]
    fmt = pinit_format(disks, 1, 4)
    sets = PSets(disks, 1, 4, deployment_id=fmt["id"], device="cpu")
    passes = threading.Event()
    mon = pmonitor.SetDiskMonitor(sets, fmt, interval_s=0.01)
    real = mon.check_once

    def counted():
        passes.set()
        return real()

    mon.check_once = counted
    mon.start()
    assert passes.wait(10)
    mon.stop()
    assert not mon._thread.is_alive()


def test_node_answers_ready_only_once_attached(tmp_path, monkeypatch):
    """A node's server answers ready (and serves the admin plane) once
    ``obj`` is set: by then its heal sequences, bucket metadata and peer
    hooks already reach the object layer, so an admin heal sent as soon
    as the node is ready walks the namespace."""
    from minio_tpu_torch.dist import node as pnode
    from minio_tpu_torch.dist.harness import free_port
    seen = []

    class Watched(pnode.S3Server):
        def __setattr__(self, name, value):
            if name == "obj" and value is not None:
                seen.append((self._heal_seqs.obj is value,
                             getattr(self, "bucket_meta", None) is not None,
                             getattr(self, "local_locker", None) is not None))
            super().__setattr__(name, value)

    monkeypatch.setattr(pnode, "S3Server", Watched)
    dirs = [str(tmp_path / f"d{i}") for i in range(4)]
    node = pnode.Node(dirs, address="127.0.0.1", port=free_port(),
                      access_key="ak", secret_key="sk-secret",
                      device="cpu")
    try:
        node.start()
        assert seen == [(True, True, True)]
    finally:
        node.shutdown()
