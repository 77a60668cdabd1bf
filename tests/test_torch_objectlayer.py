"""The port's object layer (minio_tpu_torch.objectlayer over
minio_tpu_torch.storage, on ``device="cpu"``: the CPU dispatch queue and
the plain versions of the kernels) held to the JAX package's
(minio_tpu.objectlayer, run as tests/test_objectlayer.py runs it), in exact
bytes and in both directions: what one package writes the other reads,
lists and heals.

With the persisted ids and ``FileInfo.now`` pinned (the same sequence
for both packages, see Pin), the same calls leave byte-identical trees: every
``part.N`` and every ``xl.meta``. ETags agree: the fused ETag (bodies of
1 MiB or more, folded from the data shards' bitrot digests) equals
``pipeline_etag_reference``, smaller bodies keep the MD5, a multipart
object gets ``etag_from_parts``. Geometries are toy sizes: 4+2 with
64 KiB blocks and 8+4 with 1 MiB blocks."""
import hashlib
import io
import itertools
import os
import shutil
import sys
import types
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from minio_tpu.erasure.streaming import BufferSink as JSink
from minio_tpu.objectlayer import ErasureObjects as JObjects
from minio_tpu.objectlayer import ErasureSets as JSets
from minio_tpu.objectlayer import ServerPools as JPools
from minio_tpu.objectlayer import datatypes as jdt
from minio_tpu.objectlayer import erasure_objects as jeo
from minio_tpu.objectlayer import metacache as jmc
from minio_tpu.objectlayer import multipart as jmp
from minio_tpu.storage.datatypes import FileInfo as JFileInfo
from minio_tpu.storage.xlstorage import XLStorage as JXLStorage
from minio_tpu_torch.erasure.streaming import BufferSink
from minio_tpu_torch.objectlayer import (ErasureObjects, ErasureSets,
                                         ServerPools)
from minio_tpu_torch.objectlayer import datatypes as dt
from minio_tpu_torch.objectlayer import erasure_objects as peo
from minio_tpu_torch.objectlayer import metacache as pmc
from minio_tpu_torch.objectlayer import multipart as pmp
from minio_tpu_torch.objectlayer.metadata import hash_order
from minio_tpu_torch.storage.datatypes import FileInfo
from minio_tpu_torch.storage.xlstorage import XLStorage
from minio_tpu_torch.utils.hashreader import (etag_from_parts,
                                              pipeline_etag_reference)

#: (disks, parity, block size, object sizes): below 1 MiB the ETag is the
#: MD5, from 1 MiB on the fused one; a tail shorter than one chunk
#: included
GEOMETRIES = {
    "4+2/64KiB": (6, 2, 64 << 10, [0, 1, 200_003, (1 << 20) + 70_001]),
    "8+4/1MiB": (12, 4, 1 << 20, [100, 300_000, (1 << 20) + 4099]),
}
CHUNK = 16384
SEED = 20261017


class Pin:
    """The ids and times both packages persist (data dirs, version and
    upload ids: ``uuid.uuid4`` as the object layers' modules and
    ``FileInfo.new_version_id`` see it; ``FileInfo.now``) on one counter
    each; ``reset()`` before each package's run gives both the same ids
    and times. Staging ids, which no file keeps, are left alone."""

    def __init__(self, monkeypatch):
        self.reset()
        fake = types.SimpleNamespace(uuid4=self._uuid, UUID=uuid.UUID)
        for mod in (jeo, jmp, peo, pmp):
            monkeypatch.setattr(mod, "uuid", fake)
        for cls in (JFileInfo, FileInfo):
            monkeypatch.setattr(cls, "now", staticmethod(self._now))
            monkeypatch.setattr(cls, "new_version_id",
                                staticmethod(lambda: str(self._uuid())))

    def _uuid(self):
        return uuid.UUID(int=next(self._ids))

    def _now(self):
        return 1.7e9 + next(self._times) / 8

    def reset(self):
        self._ids = itertools.count(1)
        self._times = itertools.count(1)


@pytest.fixture
def pin(monkeypatch):
    return Pin(monkeypatch)


class Side:
    """One package's erasure set (or sets and pool) over a root."""

    def __init__(self, pkg: str, root, n: int, parity: int, block: int,
                 sets: int = 1, deployment_id: str = ""):
        self.port = pkg == "port"
        self.root = str(root)
        disk = XLStorage if self.port else JXLStorage
        self.disks = [disk(os.path.join(self.root, f"d{i:02d}"))
                      for i in range(n)]
        self.dt = dt if self.port else jdt
        kw = {"device": "cpu"} if self.port else {}
        if sets > 1:
            cls = ErasureSets if self.port else JSets
            self.ol = cls(self.disks, sets, n // sets, deployment_id,
                          default_parity=parity, block_size=block, **kw)
        else:
            cls = ErasureObjects if self.port else JObjects
            self.ol = cls(self.disks, default_parity=parity,
                          block_size=block, **kw)

    def opts(self, **kw):
        return self.dt.ObjectOptions(**kw)

    def put(self, bucket, name, data, **kw):
        return self.ol.put_object(bucket, name, io.BytesIO(data), len(data),
                                  self.opts(**kw))

    def get(self, bucket, name, offset=0, length=-1, **kw):
        sink = BufferSink() if self.port else JSink()
        self.ol.get_object(bucket, name, sink, offset, length,
                           self.opts(**kw))
        return sink.getvalue()


def both(pin, fn):
    """fn("jax") and fn("port") from the same pinned ids and times."""
    pin.reset()
    a = fn("jax")
    pin.reset()
    b = fn("port")
    return a, b


def tree(root) -> dict:
    """Every file under root but the staging area, path -> bytes."""
    out = {}
    for d, _dirs, files in os.walk(str(root)):
        rel = os.path.relpath(d, str(root))
        if ".minio.sys/tmp" in rel or "/.metacache" in rel:
            continue
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out


def body(size: int, tag: int = 0) -> bytes:
    return np.random.default_rng(SEED + size + tag).bytes(size)


def expected_etag(data: bytes, k: int, block: int) -> str:
    if len(data) < 1 << 20:
        return hashlib.md5(data).hexdigest()
    return pipeline_etag_reference(data, k, block, CHUNK, 0)


@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_put_get_identical_in_both_directions(tmp_path, pin, geo):
    n, parity, block, sizes = GEOMETRIES[geo]
    objs = {f"dir/o{s}": body(s) for s in sizes}

    def write(pkg):
        s = Side(pkg, tmp_path / pkg, n, parity, block)
        s.ol.make_bucket("b")
        return {k: s.put("b", k, v).etag for k, v in objs.items()}

    jetags, petags = both(pin, write)
    assert petags == jetags
    for k, v in objs.items():
        assert petags[k] == expected_etag(v, n - parity, block), k
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    # the reader package on the writer's tree: whole and ranged GETs,
    # one range across a block boundary
    for writer, reader in (("jax", "port"), ("port", "jax")):
        s = Side(reader, tmp_path / writer, n, parity, block)
        for k, v in objs.items():
            assert s.get("b", k) == v, (writer, k)
            info = s.ol.get_object_info("b", k)
            assert (info.size, info.etag) == (len(v), jetags[k])
            if len(v) > block:
                off = block - 1000
                assert s.get("b", k, off, 3000) == v[off:off + 3000]


def test_versions_and_delete_markers(tmp_path, pin):
    n, parity, block = 6, 2, 64 << 10
    v1, v2 = body(30_000, 1), body(20_000, 2)

    def write(pkg):
        s = Side(pkg, tmp_path / pkg, n, parity, block)
        s.ol.make_bucket("b")
        a = s.put("b", "o", v1, versioned=True).version_id
        b = s.put("b", "o", v2, versioned=True).version_id
        g = s.put("b", "gone", v1, versioned=True).version_id
        dm = s.ol.delete_object("b", "gone", s.opts(versioned=True))
        p1 = s.put("b", "pruned", v1, versioned=True).version_id
        p2 = s.put("b", "pruned", v2, versioned=True).version_id
        s.ol.delete_object("b", "pruned", s.opts(version_id=p1))
        return a, b, g, dm.version_id, dm.delete_marker, p1, p2

    jids, pids = both(pin, write)
    assert pids == jids and jids[4]
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    a, b, g, dm, _, p1, p2 = jids
    for writer, reader in (("jax", "port"), ("port", "jax")):
        s = Side(reader, tmp_path / writer, n, parity, block)
        assert s.get("b", "o") == v2
        assert s.get("b", "o", version_id=a) == v1
        assert s.get("b", "o", version_id=b) == v2
        with pytest.raises(s.dt.ObjectNotFound):
            s.get("b", "gone")
        with pytest.raises(s.dt.MethodNotAllowed):
            s.ol.get_object_info("b", "gone", s.opts(version_id=dm))
        assert s.get("b", "gone", version_id=g) == v1
        with pytest.raises(s.dt.VersionNotFound):
            s.get("b", "pruned", version_id=p1)
        vers = s.ol.list_object_versions("b")
        assert [(o.name, o.version_id, o.delete_marker)
                for o in vers.objects] == [
            ("gone", dm, True), ("gone", g, False), ("o", b, False),
            ("o", a, False), ("pruned", p2, False)]


LIST_NAMES = ["a/1", "a/2", "a/b/3", "a/b/4", "b", "c/d", "c!e", "z"]
LIST_CALLS = [("", "", "", 1000), ("", "/", "", 1000), ("a/", "/", "", 1000),
              ("", "/", "a/", 2), ("a/", "", "a/1", 1000), ("", "", "b", 3),
              ("c", "/", "", 1000)]


def test_listing_across_packages(tmp_path, pin):
    n, parity, block = 6, 2, 64 << 10

    def write(pkg):
        s = Side(pkg, tmp_path / pkg, n, parity, block)
        s.ol.make_bucket("b")
        for i, name in enumerate(LIST_NAMES):
            s.put("b", name, body(1000 + i))

    both(pin, write)
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")

    def listing(side, call):
        r = side.ol.list_objects("b", *call)
        return ([(o.name, o.size, o.etag) for o in r.objects], r.prefixes,
                r.is_truncated, r.next_marker)

    for writer in ("jax", "port"):
        j = Side("jax", tmp_path / writer, n, parity, block)
        p = Side("port", tmp_path / writer, n, parity, block)
        for call in LIST_CALLS:
            assert listing(p, call) == listing(j, call), (writer, call)


def test_multipart_across_packages(tmp_path, pin):
    n, parity, block = 6, 2, 1 << 20
    parts = [body(5 << 20, 1), body(333, 2)]

    def write(pkg):
        s = Side(pkg, tmp_path / pkg, n, parity, block)
        s.ol.make_bucket("b")
        uid = s.ol.new_multipart_upload("b", "mp")
        etags = [s.ol.put_object_part("b", "mp", uid, i + 1,
                                      io.BytesIO(p), len(p)).etag
                 for i, p in enumerate(parts)]
        listed = [(p.part_number, p.etag, p.size) for p in
                  s.ol.list_object_parts("b", "mp", uid).parts]
        ups = [u.object for u in s.ol.list_multipart_uploads("b").uploads]
        oi = s.ol.complete_multipart_upload(
            "b", "mp", uid,
            [s.dt.CompletePart(i + 1, e) for i, e in enumerate(etags)])
        # an aborted upload leaves nothing behind
        uid2 = s.ol.new_multipart_upload("b", "other")
        s.ol.abort_multipart_upload("b", "other", uid2)
        return etags, listed, ups, oi.etag

    jres, pres = both(pin, write)
    assert pres == jres
    etags = jres[0]
    assert etags[0] == pipeline_etag_reference(parts[0], 4, block, CHUNK, 0)
    assert etags[1] == hashlib.md5(parts[1]).hexdigest()
    assert jres[3] == etag_from_parts(etags) and jres[3].endswith("-2")
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    for writer, reader in (("jax", "port"), ("port", "jax")):
        s = Side(reader, tmp_path / writer, n, parity, block)
        assert s.get("b", "mp") == b"".join(parts)
        off = (5 << 20) - 7
        assert s.get("b", "mp", off, 100) == b"".join(parts)[off:off + 100]


@pytest.mark.parametrize("algo", ["SIPMOD+PARITY", "CRCMOD"])
def test_set_placement_matches(tmp_path, algo):
    dep = str(uuid.UUID(int=SEED))
    j = JSets([JXLStorage(str(tmp_path / f"j{i}")) for i in range(12)], 3,
              4, dep, default_parity=2, distribution_algo=algo)
    p = ErasureSets([XLStorage(str(tmp_path / f"p{i}")) for i in range(12)],
                    3, 4, dep, default_parity=2, distribution_algo=algo,
                    device="cpu")
    gen = np.random.default_rng(SEED)
    names = [f"obj/{gen.integers(0, 10**9)}/{'é' * (i % 3)}{i}"
             for i in range(200)]
    got = [p.get_hashed_set_index(x) for x in names]
    assert got == [j.get_hashed_set_index(x) for x in names]
    assert len(set(got)) == 3


def test_sets_and_pools_across_packages(tmp_path, pin):
    dep = str(uuid.UUID(int=SEED))
    names = [f"k{i:02d}" for i in range(8)]

    def write(pkg):
        s = Side(pkg, tmp_path / pkg, 12, 2, 64 << 10, sets=2,
                 deployment_id=dep)
        pool = (ServerPools if s.port else JPools)([s.ol])
        pool.make_bucket("b")
        for i, name in enumerate(names):
            pool.put_object("b", name, io.BytesIO(body(20_000, i)), 20_000)
        return [o.name for o in pool.list_objects("b").objects]

    jl, pl = both(pin, write)
    assert pl == jl == names
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    s = Side("port", tmp_path / "jax", 12, 2, 64 << 10, sets=2,
             deployment_id=dep)
    pool = ServerPools([s.ol])
    for i, name in enumerate(names):
        assert pool.get_object_info("b", name).size == 20_000
        sink = BufferSink()
        pool.get_object("b", name, sink)
        assert sink.getvalue() == body(20_000, i)
    assert [o.name for o in pool.iter_objects("b")] == names


def _finished_cache(store, bucket):
    """Build the bucket's listing cache through ``store`` and wait until
    its manifest is written."""
    names = [n for n, _raw, _m in store.iter_entries(bucket)]
    st = store._states[(bucket, "")]
    with st.cv:
        assert st.cv.wait_for(lambda: st.ended, timeout=30)
    store._builders.shutdown(wait=True)
    assert st.error is None
    return names, st


@pytest.mark.parametrize("builder", ["jax", "port"])
def test_listing_cache_blocks_across_packages(tmp_path, pin, builder):
    n, parity, block = 6, 2, 64 << 10
    s = Side("jax", tmp_path, n, parity, block)
    s.ol.make_bucket("b")
    for i in range(12):
        s.put("b", f"p/{i:03d}", body(500 + i))
    b = Side(builder, tmp_path, n, parity, block)
    names, st = _finished_cache(b.ol.metacache, "b")
    assert st.blocks
    server = "port" if builder == "jax" else "jax"
    r = Side(server, tmp_path, n, parity, block)
    served = [(nm, raw) for nm, raw, meta in
              r.ol.metacache.iter_entries("b")]
    assert r.ol.metacache.serves_cached == 1
    assert r.ol.metacache.serves_walked == 0
    assert [nm for nm, _ in served] == names
    # the block bytes either package packs are the same
    entries = [(nm, raw) for nm, raw in served]
    assert pmc._pack_block("id", entries) == jmc._pack_block("id", entries)
    assert pmc._unpack_block(jmc._pack_block("id", entries), "id") == \
        jmc._unpack_block(pmc._pack_block("id", entries), "id")


HEALS = ["missing_drives", "corrupt_shard", "delete_marker", "dangling"]


def _deploy_for_heal(side: Side, scenario: str) -> None:
    side.ol.make_bucket("b")
    side.put("b", "x", body(100_001), versioned=scenario == "delete_marker")
    side.put("b", "y/z", body(150_000, 3))
    if scenario == "delete_marker":
        side.ol.delete_object("b", "x", side.opts(versioned=True))


def _damage(root: str, scenario: str) -> None:
    d = [os.path.join(root, f"d{i:02d}", "b") for i in range(6)]
    if scenario == "missing_drives":
        for i in (0, 3):
            shutil.rmtree(d[i])
            os.makedirs(os.path.dirname(d[i]), exist_ok=True)
    elif scenario == "corrupt_shard":
        for name in ("x", "y/z"):
            obj = os.path.join(d[1], name)
            ddir = next(e for e in os.listdir(obj) if e != "xl.meta")
            p = os.path.join(obj, ddir, "part.1")
            with open(p, "r+b") as f:
                f.seek(32 + 700)
                c = f.read(1)
                f.seek(32 + 700)
                f.write(bytes([c[0] ^ 0x5A]))
    elif scenario == "delete_marker":
        shutil.rmtree(os.path.join(d[2], "x"))
    else:  # dangling: "x" survives on one disk only
        for i in range(1, 6):
            shutil.rmtree(os.path.join(d[i], "x"))


def _heal(side: Side, scenario: str) -> list:
    side.ol.heal_bucket("b")
    mode = "deep" if scenario == "corrupt_shard" else "normal"
    out = []
    for name in ("x", "y/z"):
        r = side.ol.heal_object("b", name, scan_mode=mode,
                                remove_dangling=scenario == "dangling")
        out.append((r.before_state, r.after_state))
    if scenario == "delete_marker":
        vid = [v for v in side.ol.list_object_versions("b").objects
               if v.name == "x" and not v.delete_marker][0].version_id
        r = side.ol.heal_object("b", "x", vid)
        out.append((r.before_state, r.after_state))
    return out


@pytest.mark.parametrize("scenario", HEALS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_heal_across_packages(tmp_path, pin, writer, scenario):
    """One package writes; both heal copies of the same damage; the healed
    trees are identical, and equal the undamaged one where heal restores
    it."""
    src = tmp_path / "src"
    pin.reset()
    _deploy_for_heal(Side(writer, src, 6, 2, 64 << 10), scenario)
    original = tree(src)
    _damage(str(src), scenario)
    for pkg in ("jax", "port"):
        shutil.copytree(src, tmp_path / pkg)
    jst, pst = both(pin, lambda pkg: _heal(
        Side(pkg, tmp_path / pkg, 6, 2, 64 << 10), scenario))
    assert pst == jst
    healed = tree(tmp_path / "port")
    assert healed == tree(tmp_path / "jax")
    if scenario == "dangling":
        assert not any("/x/" in p for p in healed)
        assert {p: v for p, v in healed.items() if "/y/z/" in p} == \
            {p: v for p, v in original.items() if "/y/z/" in p}
    else:
        assert healed == original
    s = Side("port", tmp_path / "jax", 6, 2, 64 << 10)
    assert s.get("b", "y/z") == body(150_000, 3)


def test_degraded_get_signals_partial(tmp_path):
    s = Side("port", tmp_path, 6, 2, 64 << 10)
    s.ol.make_bucket("b")
    data = body(100_000)
    s.put("b", "o", data)
    calls = []
    s.ol.on_partial = lambda *a, **kw: calls.append((a, kw))
    # the disk holding data shard 1, which every healthy GET reads
    disk = tmp_path / f"d{hash_order('b/o', 6).index(1):02d}" / "b" / "o"
    ddir = [e for e in os.listdir(disk) if e != "xl.meta"][0]
    p = disk / ddir / "part.1"
    raw = bytearray(p.read_bytes())
    raw[40] ^= 1
    p.write_bytes(bytes(raw))
    assert s.get("b", "o") == data
    assert calls and calls[-1][1]["scan_mode"] == "deep"
    r = s.ol.heal_object("b", "o", scan_mode="deep")
    assert r.before_state.count("corrupt") == 1
    assert set(r.after_state) == {"ok"}


def test_concurrent_puts_gets_and_heals(tmp_path):
    """More threads than cores PUT, GET and heal distinct objects of one
    set at once, with the interpreter's switch interval shortened: every
    object reads back whole, each disk holds exactly one journal and one
    data dir per object, and the heals rebuild every wiped shard."""
    s = Side("port", tmp_path, 6, 2, 64 << 10)
    s.ol.make_bucket("b")
    bodies = {f"k/{i:02d}": body(5000 + 97 * i) for i in range(24)}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=24) as ex:
            for f in [ex.submit(s.put, "b", k, v)
                      for k, v in bodies.items()]:
                f.result(timeout=120)
            got = {k: f.result(timeout=120) for k, f in
                   [(k, ex.submit(s.get, "b", k)) for k in bodies]}
            assert got == bodies
            shutil.rmtree(tmp_path / "d04" / "b" / "k")
            heals = [ex.submit(s.ol.heal_object, "b", k) for k in bodies]
            states = [f.result(timeout=120) for f in heals]
    finally:
        sys.setswitchinterval(old)
    assert all(r.before_state[4] == "missing" and set(r.after_state)
               == {"ok"} for r in states)
    for i in range(6):
        for k in bodies:
            entries = os.listdir(tmp_path / f"d{i:02d}" / "b" / k)
            assert len(entries) == 2 and "xl.meta" in entries, (i, k)
    assert {k: s.get("b", k) for k in bodies} == bodies
