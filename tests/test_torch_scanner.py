"""The port's data scanner plane (minio_tpu_torch.scanner: the change
tracker, the usage tree, the scanner's cycles and its deep scan, the
durability janitor) held to the JAX package's (minio_tpu.scanner, run as
tests/test_usage.py, tests/test_background.py and tests/test_recovery.py
run it) on numpy-made inputs, in exact bytes and in both directions:
``tracker.bin`` and the usage trees are byte-identical and each package
reads the other's; over the same objects the scanners' snapshots agree
apart from ``last_update``; a deep cycle queues and heals a corrupted
shard in both; the janitors leave identical trees from copies of one crash
residue. Geometry: 4+2 with 64 KiB blocks, objects of a few KiB (the plain
HighwayHash of the CPU queue is slow here)."""
import io
import json
import os
import shutil
import time

import msgpack
import numpy as np
import pytest

from minio_tpu.objectlayer import ErasureObjects as JObjects
from minio_tpu.scanner import janitor as jjan
from minio_tpu.scanner import usage as jusage
from minio_tpu.scanner.mrf import MRFHealer as JMRF
from minio_tpu.scanner.scanner import DataScanner as JScanner
from minio_tpu.scanner.tracker import UpdateTracker as JTracker
from minio_tpu.storage import XLStorage as JXLStorage
from minio_tpu_torch.objectlayer import ErasureObjects
from minio_tpu_torch.scanner import janitor as pjan
from minio_tpu_torch.scanner import usage as pusage
from minio_tpu_torch.scanner.mrf import MRFHealer
from minio_tpu_torch.scanner.scanner import DataScanner
from minio_tpu_torch.scanner.tracker import UpdateTracker, global_tracker
from minio_tpu_torch.storage import XLStorage
from minio_tpu_torch.storage.datatypes import FileInfo
from minio_tpu_torch.utils import msgpack as pmsgpack

SEED = 20261018
N, PARITY, BLOCK = 6, 2, 64 << 10
PKGS = ("jax", "port")


def layer(pkg: str, root):
    """One package's 4+2 erasure set over ``root``/d00..d05."""
    dirs = [os.path.join(str(root), f"d{i:02d}") for i in range(N)]
    if pkg == "port":
        return ErasureObjects([XLStorage(d) for d in dirs],
                              default_parity=PARITY, block_size=BLOCK,
                              device="cpu")
    return JObjects([JXLStorage(d) for d in dirs], default_parity=PARITY,
                    block_size=BLOCK)


def body(n: int, tag: int = 0) -> bytes:
    return np.random.default_rng(SEED + n + tag).bytes(n)


def put(ol, bucket: str, name: str, data: bytes):
    return ol.put_object(bucket, name, io.BytesIO(data), len(data))


def files(root, skip=(".minio.sys",)) -> dict:
    """Every file under ``root`` whose path holds none of ``skip``."""
    out = {}
    for d, _dirs, names in os.walk(str(root)):
        for n in names:
            p = os.path.relpath(os.path.join(d, n), str(root))
            if any(s in p for s in skip):
                continue
            with open(os.path.join(d, n), "rb") as f:
                out[p] = f.read()
    return out


def wait_for(cond, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def no_time(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "last_update"}


# --- the change tracker ------------------------------------------------------


def _drive_tracker(t, marks):
    for b, o in marks[:20]:
        t.mark(b, o)
    g = t.begin_cycle()
    for b, o in marks[20:]:
        t.mark(b, o)
    t.begin_cycle()
    t.end_cycle(g)
    t.mark("late", "")
    t.save()


def test_tracker_bin_identical_and_loaded_across_packages(tmp_path):
    rng = np.random.default_rng(SEED)
    marks = [(f"b{rng.integers(4)}", f"p{rng.integers(6)}/o{i}")
             for i in range(40)]
    paths = {pkg: str(tmp_path / pkg / "tracker.bin") for pkg in PKGS}
    _drive_tracker(JTracker(paths["jax"]), marks)
    _drive_tracker(UpdateTracker(paths["port"]), marks)
    blobs = {pkg: open(paths[pkg], "rb").read() for pkg in PKGS}
    assert blobs["port"] == blobs["jax"]
    for writer, cls in (("jax", UpdateTracker), ("port", JTracker)):
        t = cls()
        t.attach_persistence(paths[writer])
        assert t.generation == 2
        for b, o in marks[20:]:
            assert t.bucket_dirty(b) and t.prefix_dirty(b, o.split("/")[0])
        assert t.bucket_dirty("late")
        assert not t.bucket_dirty("never-marked")
        out = tmp_path / f"{writer}-reloaded.bin"
        t.attach_persistence(str(out), load=False)
        t.save()
        assert out.read_bytes() == blobs[writer]


def test_tracker_persisted_on_a_port_disk_after_a_cycle(tmp_path):
    """The scanner finds its state directory through the disk's ``root``
    (the JAX package's disks call it ``base``): tracker.bin lands under
    the first disk's .minio.sys after one cycle."""
    ol = layer("port", tmp_path)
    ol.make_bucket("trk")
    put(ol, "trk", "a/o", body(3000))
    DataScanner(ol, sleep_per_object=0).scan_cycle()
    p = tmp_path / "d00" / ".minio.sys" / "tracker.bin"
    assert p.is_file()
    assert global_tracker()._persist_path == str(p)
    t = JTracker()
    t.attach_persistence(str(p))
    assert t.generation == global_tracker().generation


# --- the usage tree ----------------------------------------------------------

TREE_CASES = {
    "flat": (40, 1, 1 << 20, None),
    "nested": (200, 6, 700 << 20, None),
    # more folders than the node budget: compaction collapses subtrees
    "compacted": (300, 4, 5 << 30, (3, 24)),
}


def _tree_inputs(case):
    n, depth, max_size, _ = TREE_CASES[case]
    rng = np.random.default_rng(SEED + n)
    out = []
    for i in range(n):
        parts = [f"d{rng.integers(5)}" for _ in range(rng.integers(depth + 1))]
        out.append(("/".join(parts + [f"o{i}"]),
                    int(rng.integers(0, max_size)), int(rng.integers(1, 4))))
    return out


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_usage_tree_bytes_match_the_jax_package(case):
    trees = {"jax": jusage.UsageTree(), "port": pusage.UsageTree()}
    for t in trees.values():
        for name, size, versions in _tree_inputs(case):
            t.add(name, size, versions)
        compact = TREE_CASES[case][3]
        if compact is not None:
            t.compact(*compact)
    blob = trees["jax"].to_bytes()
    assert trees["port"].to_bytes() == blob
    assert msgpack.unpackb(blob, raw=False, strict_map_key=False) == \
        pmsgpack.unpackb(blob)
    assert trees["port"].node_count() == trees["jax"].node_count()
    if TREE_CASES[case][3] is not None:
        assert trees["port"].node_count() <= TREE_CASES[case][3][1]
    assert pusage.UsageTree.from_bytes(blob).to_bytes() == blob
    assert jusage.UsageTree.from_bytes(trees["port"].to_bytes()
                                       ).to_bytes() == blob
    for depth in (1, 2, 3):
        assert trees["port"].prefixes(depth) == trees["jax"].prefixes(depth)
    assert trees["port"].histogram() == trees["jax"].histogram()


def test_usage_tree_refuses_a_bad_blob():
    with pytest.raises(ValueError):
        pusage.UsageTree.from_bytes(pmsgpack.packb({"v": 2, "root": []}))
    with pytest.raises(ValueError):
        pusage.UsageTree.from_bytes(b"\x82\xa1v")


# --- the scanner -------------------------------------------------------------

SCAN_OBJECTS = {
    "scan-a": {"x/1": 100, "x/y/2": 2000, "x/y/3": 3000, "z": 0,
               "w/v/u/4": 1500},
    "scan-b": {"k/1": 700, "k/2": 1100},
}


def _scan_run(pkg, root):
    ol = layer(pkg, root)
    for b, objs in SCAN_OBJECTS.items():
        ol.make_bucket(b)
        for name, n in objs.items():
            put(ol, b, name, body(n))
    cls = DataScanner if pkg == "port" else JScanner
    sc = cls(ol, sleep_per_object=0)
    first = sc.scan_cycle()
    put(ol, "scan-b", "k/3", body(900))
    second = sc.scan_cycle()
    return first, second


def test_scan_cycles_match_and_read_across_packages(tmp_path):
    snaps = {pkg: _scan_run(pkg, tmp_path / pkg) for pkg in PKGS}
    for a, b in zip(snaps["jax"], snaps["port"]):
        assert no_time(b) == no_time(a)
    assert snaps["port"][1]["buckets"]["scan-b"]["objects"] == 3
    assert snaps["port"][1]["objects_total"] == 8
    cfg = os.path.join("d00", ".minio.sys", "config", "data-usage")
    for name in sorted(os.listdir(tmp_path / "jax" / cfg)):
        a = (tmp_path / "jax" / cfg / name).read_bytes()
        b = (tmp_path / "port" / cfg / name).read_bytes()
        if name == "usage.json":
            assert no_time(json.loads(b)) == no_time(json.loads(a))
        else:
            assert b == a, name
    # each package's admin document over the other's files
    for writer in PKGS:
        docs = {}
        for reader, mod in (("jax", jusage), ("port", pusage)):
            docs[reader] = no_time(mod.data_usage_info(
                layer(reader, tmp_path / writer), depth=3))
        assert docs["port"] == docs["jax"]
        assert docs["port"]["buckets"]["scan-a"]["prefixes"]["x/y/"] == \
            {"objects": 2, "size": 5000, "versions": 2}


def test_tracker_skip_walks_only_the_written_bucket(tmp_path):
    from minio_tpu_torch.obs import metrics as mx
    ol = layer("port", tmp_path)
    for b in ("skip-a", "skip-b"):
        ol.make_bucket(b)
        for i in range(3):
            put(ol, b, f"o{i}", body(500 + i))
    sc = DataScanner(ol, sleep_per_object=0)
    sc.scan_cycle()
    key = "minio_tpu_scanner_objects_scanned_total"
    before = mx.counters_snapshot().get(key, 0)
    put(ol, "skip-b", "o9", body(800))
    snap = sc.scan_cycle()
    assert mx.counters_snapshot()[key] - before == 4
    assert snap["buckets"]["skip-b"]["objects"] == 4
    assert snap["buckets"]["skip-a"]["objects"] == 3


def _deep_run(pkg, root):
    ol = layer(pkg, root)
    mrf = (MRFHealer if pkg == "port" else JMRF)(ol).start()
    try:
        sc = (DataScanner if pkg == "port" else JScanner)(
            ol, mrf=mrf, sleep_per_object=0)
        sc.cycle = 15  # the next cycle is a deep one
        snap = sc.scan_cycle()
        wait_for(lambda: mrf.healed + mrf.failed >= 1)
        assert (mrf.healed, mrf.failed) == (1, 0)
        disk = ol.disks[3]
        disk.verify_file("deep", "o", disk.read_version("deep", "o"))
    finally:
        mrf.stop()
    return snap


def test_deep_cycle_queues_and_heals_a_corrupt_shard(tmp_path):
    src = tmp_path / "src"
    ol = layer("port", src)
    ol.make_bucket("deep")
    data = body(150_000)
    put(ol, "deep", "o", data)
    original = files(src)
    obj = src / "d03" / "deep" / "o"
    ddir = next(e for e in os.listdir(obj) if e != "xl.meta")
    p = obj / ddir / "part.1"
    raw = bytearray(p.read_bytes())
    raw[32 + 1000] ^= 0x41
    p.write_bytes(bytes(raw))
    for pkg in PKGS:
        shutil.copytree(src, tmp_path / pkg)
    snaps = {pkg: _deep_run(pkg, tmp_path / pkg) for pkg in PKGS}
    assert snaps["port"]["deep"] and no_time(snaps["port"]) == \
        no_time(snaps["jax"])
    assert files(tmp_path / "port") == files(tmp_path / "jax") == original


# --- the durability janitor --------------------------------------------------

DAY = 86400.0


def _residue(root) -> None:
    """The same crash residue on a copy: aged and fresh tmp staging on
    every disk, an orphan data dir on two disks, a torn xl.meta on one."""
    old = time.time() - 2 * DAY
    for i in range(N):
        tmp = os.path.join(str(root), f"d{i:02d}", ".minio.sys", "tmp")
        for name, age in (("crash-aged", old), ("crash-fresh", None)):
            os.makedirs(os.path.join(tmp, name, "ddir"))
            with open(os.path.join(tmp, name, "ddir", "part.1"), "wb") as f:
                f.write(b"stranded")
            if age is not None:
                os.utime(os.path.join(tmp, name), (age, age))
    for i in (1, 4):
        orphan = os.path.join(str(root), f"d{i:02d}", "jan", "keep",
                              "0a0a0a0a-0000-4000-8000-000000000000")
        os.makedirs(orphan)
        with open(os.path.join(orphan, "part.1"), "wb") as f:
            f.write(b"orphan")
        os.utime(orphan, (old, old))
    meta = os.path.join(str(root), "d02", "jan", "torn", "xl.meta")
    raw = open(meta, "rb").read()
    with open(meta, "wb") as f:
        f.write(raw[:len(raw) // 2])


def _janitor_src(root, monkeypatch):
    """Objects of one bucket, written by the port, and an upload whose
    initiation journal is two days old."""
    ol = layer("port", root)
    ol.make_bucket("jan")
    for name in ("keep", "torn", "n/deep"):
        put(ol, "jan", name, body(2500, len(name)))
    with monkeypatch.context() as m:
        m.setattr(FileInfo, "now", staticmethod(lambda: time.time() - 2 * DAY))
        ol.new_multipart_upload("jan", "mp")


def test_janitors_leave_identical_trees(tmp_path, monkeypatch):
    src = tmp_path / "src"
    _janitor_src(src, monkeypatch)
    for pkg in PKGS:
        shutil.copytree(src, tmp_path / pkg)
    stats = {}
    for pkg, mod in (("jax", jjan), ("port", pjan)):
        ol = layer(pkg, tmp_path / pkg)  # built before the residue lands
        _residue(tmp_path / pkg)
        stats[pkg] = mod.DurabilityJanitor(ol).sweep(
            tmp_age_s=DAY, multipart_expiry_s=DAY, ddir_age_s=60.0)
    assert stats["port"] == stats["jax"]
    assert stats["port"]["tmp_swept"] == N
    assert stats["port"]["orphan_ddirs"] == 2
    assert stats["port"]["quarantined"] == 1
    assert stats["port"]["partial"] == 1
    assert files(tmp_path / "port", skip=()) == \
        files(tmp_path / "jax", skip=())
    for i in range(N):
        tmp = tmp_path / "port" / f"d{i:02d}" / ".minio.sys" / "tmp"
        assert sorted(os.listdir(tmp)) == ["crash-fresh"]
    assert (tmp_path / "port" / "d02" / "jan" / "torn" /
            "xl.meta.corrupt").is_file()


def test_startup_recovery_and_upload_expiry_match(tmp_path, monkeypatch):
    """Building a set over a crashed process's directories sweeps every
    tmp entry of any age and expires the aged upload, in both packages."""
    from minio_tpu_torch.objectlayer import erasure_objects as peo
    src = tmp_path / "src"
    _janitor_src(src, monkeypatch)
    stats = {}
    for pkg, mod, site in (("jax", jjan, jjan), ("port", pjan, peo)):
        shutil.copytree(src, tmp_path / pkg)
        _residue(tmp_path / pkg)

        def recorded(ol, _pkg=pkg, _run=mod.startup_recovery):
            stats[_pkg] = _run(ol)
            return stats[_pkg]

        monkeypatch.setattr(site, "startup_recovery", recorded)
        layer(pkg, tmp_path / pkg)
    assert stats["port"] == stats["jax"] == {"tmp_swept": 2 * N,
                                              "uploads_expired": 1}
    assert files(tmp_path / "port", skip=()) == \
        files(tmp_path / "jax", skip=())
    mp = tmp_path / "port" / "d00" / ".minio.sys" / "multipart"
    assert not any(names for _d, _s, names in os.walk(mp))
