"""The storage REST RPC across the packages: the port's StorageRESTClient
against a JAX node's storage service, and the JAX client against the
port's, method by method. Each script of StorageAPI calls runs once
through the remote client and once on a local disk of the serving
package: the answers (typed errors included) and every file the disks
hold are identical, and the four trees (each client over each service)
agree byte for byte. The lock and peer services are driven across the
packages too."""
import os
import uuid

import pytest

from minio_tpu.dist.dsync import LocalLocker as JLocalLocker
from minio_tpu.dist.lock_rest import LockRESTClient as JLockClient
from minio_tpu.dist.lock_rest import LockRESTService as JLockService
from minio_tpu.dist.storage_rest import StorageRESTClient as JClient
from minio_tpu.dist.storage_rest import StorageRESTService as JService
from minio_tpu.server import S3Server as JServer
from minio_tpu.storage import XLStorage as JXLStorage
from minio_tpu.storage.datatypes import FileInfo as JFileInfo
from minio_tpu.utils import errors as jerrors
from minio_tpu_torch.dist import rpc as prpc
from minio_tpu_torch.dist.dsync import LocalLocker as PLocalLocker
from minio_tpu_torch.dist.lock_rest import LockRESTClient as PLockClient
from minio_tpu_torch.dist.lock_rest import LockRESTService as PLockService
from minio_tpu_torch.dist.storage_rest import StorageRESTClient as PClient
from minio_tpu_torch.dist.storage_rest import StorageRESTService as PService
from minio_tpu_torch.server import S3Server as PServer
from minio_tpu_torch.storage import XLStorage as PXLStorage
from minio_tpu_torch.storage.datatypes import FileInfo as PFileInfo
from minio_tpu_torch.utils import errors as perrors
from test_torch_objectlayer import tree

SECRET = "rpc-cluster-secret"


class _Service:
    """One package's storage and lock services on a bare listener."""

    def __init__(self, pkg: str, root: str):
        self.pkg = pkg
        self.path = os.path.join(root, "served")
        disk = (PXLStorage if pkg == "port" else JXLStorage)(self.path)
        self.locker = (PLocalLocker if pkg == "port" else JLocalLocker)()
        if pkg == "port":
            self.srv = PServer(None, "127.0.0.1", 0, access_key="ak",
                               secret_key=SECRET, device="cpu")
            self.srv.internal = {"storage": PService({self.path: disk}),
                                 "lock": PLockService(self.locker)}
        else:
            self.srv = JServer(None, "127.0.0.1", 0, access_key="ak",
                               secret_key=SECRET)
            self.srv.internal = {"storage": JService({self.path: disk}),
                                 "lock": JLockService(self.locker)}
        self.srv.start_background()
        self.url = f"http://127.0.0.1:{self.srv.port}"

    def local(self, root: str):
        return (PXLStorage if self.pkg == "port" else JXLStorage)(root)

    def close(self):
        self.srv.shutdown()
        if self.pkg == "jax":
            self.srv._httpd.server_close()


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    root = tmp_path_factory.mktemp("rpc")
    out = {pkg: _Service(pkg, str(root / pkg)) for pkg in ("jax", "port")}
    yield out
    for s in out.values():
        s.close()


def _fi(pkg: str, name: str, **kw):
    cls = PFileInfo if pkg == "port" else JFileInfo
    fi = cls(volume="vb", name=name, mod_time=1.7e9 + len(name) / 8,
             metadata={"etag": "e" * 32, "content-type": "text/plain"},
             **kw)
    fi.erasure.data_blocks, fi.erasure.parity_blocks = 2, 2
    fi.erasure.block_size = 1 << 16
    fi.erasure.index = 1
    fi.erasure.distribution = [1, 2, 3, 4]
    return fi


def _script(d, pkg: str) -> list:
    """Every StorageAPI method the erasure layer calls, in one sequence;
    what each returns (or the name of the error it raises)."""
    out = []
    try:  # a module-scoped service ran the script before
        d.delete_vol("vb", True)
    except Exception:  # noqa: BLE001 — a fresh disk has none
        pass

    def step(name, fn, *a, **kw):
        try:
            r = fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 — the typed error is data
            # an error without a wire form (a raw OSError) reaches a
            # remote caller as the transport's RPCError
            kind = type(e).__name__
            out.append((name, "error", kind if kind in prpc._ERR_BY_NAME
                        else "untyped"))
            return None
        if isinstance(r, list) and r and hasattr(r[0], "to_rpc"):
            r = [x.to_rpc() for x in r]
        elif hasattr(r, "to_rpc"):
            r = r.to_rpc()
        elif hasattr(r, "name") and hasattr(r, "created"):
            r = r.name
        elif isinstance(r, list) and r and hasattr(r[0], "created"):
            r = sorted(v.name for v in r)
        elif isinstance(r, list):
            # delete_versions: a failed entry crosses the wire as
            # FaultyDisk carrying the message
            r = [str(x) if isinstance(x, Exception) else x for x in r]
        out.append((name, r))
        return r

    step("make_vol", d.make_vol, "vb")
    step("make_vol_again", d.make_vol, "vb")
    step("stat_vol", d.stat_vol, "vb")
    step("stat_vol_missing", d.stat_vol, "nope")
    step("list_vols", d.list_vols)
    step("write_all", d.write_all, "vb", "cfg/a.json", b'{"a": 1}')
    step("read_all", d.read_all, "vb", "cfg/a.json")
    step("read_all_missing", d.read_all, "vb", "cfg/none")
    step("append_file", d.append_file, "vb", "log/app", b"first ")
    step("append_file_2", d.append_file, "vb", "log/app", b"second")
    step("stat_file_size", d.stat_file_size, "vb", "log/app")
    r = d.read_file_at("vb", "log/app")
    step("read_at", r.read_at, 3, 7)
    r.close()
    w = d.create_file_writer("vb", "stream/s1")
    for i in range(3):
        w.write(bytes([65 + i]) * (1000 + i))
    w.close()
    step("read_stream", d.read_all, "vb", "stream/s1")
    w = d.create_file_writer("vb", "stream/empty")
    w.close()
    step("read_empty", d.read_all, "vb", "stream/empty")
    step("rename_file", d.rename_file, "vb", "stream/s1", "vb", "moved/s1")
    step("list_dir", d.list_dir, "vb", "")
    step("list_dir_count", d.list_dir, "vb", "", 2)
    step("delete_path", d.delete_path, "vb", "moved/s1")
    step("delete_path_missing", d.delete_path, "vb", "moved/s1")
    # versions: inline data, a data dir renamed in, updates and deletes
    inline = _fi(pkg, "inl", version_id="", data_dir="")
    inline.data = b"inline-bytes" * 10
    inline.size = len(inline.data)
    step("write_metadata", d.write_metadata, "vb", "inl", inline)
    step("read_version", d.read_version, "vb", "inl", "", True)
    ddir = str(uuid.UUID(int=77))
    tmp = f"tmp-{ddir}"
    w = d.create_file_writer(".minio.sys", f"tmp/{tmp}/{ddir}/part.1")
    w.write(b"p" * 4096)
    w.close()
    big = _fi(pkg, "big", version_id=str(uuid.UUID(int=5)), data_dir=ddir,
              size=4096)
    from minio_tpu.storage.datatypes import ObjectPartInfo as JPart
    from minio_tpu_torch.storage.datatypes import ObjectPartInfo as PPart
    big.parts = [(PPart if pkg == "port" else JPart)(1, "e", 4096, 4096)]
    step("rename_data", d.rename_data, ".minio.sys", f"tmp/{tmp}", big,
         "vb", "big")
    step("check_parts", d.check_parts, "vb", "big", big)
    step("verify_file", d.verify_file, "vb", "big", big)
    big.metadata = {**big.metadata, "x-amz-meta-k": "v"}
    step("update_metadata", d.update_metadata, "vb", "big", big)
    step("read_version_vid", d.read_version, "vb", "big",
         str(uuid.UUID(int=5)))
    step("read_version_missing", d.read_version, "vb", "big",
         str(uuid.UUID(int=6)))
    step("list_versions", d.list_versions, "vb", "big")
    step("walk_dir", lambda: sorted(d.walk_dir("vb")))
    step("walk_versions", lambda: list(d.walk_versions("vb")))
    step("walk_versions_marker", lambda: list(d.walk_versions(
        "vb", "", "big", 1)))
    other = _fi(pkg, "gone", version_id="", data_dir="")
    other.data = b"x"
    step("write_metadata_2", d.write_metadata, "vb", "gone", other)
    step("delete_versions", d.delete_versions, "vb", ["gone", "nothere"],
         [other, _fi(pkg, "nothere")])
    step("delete_version", d.delete_version, "vb", "big", big)
    step("read_after_delete", d.read_version, "vb", "big")
    step("set_disk_id", d.set_disk_id, str(uuid.UUID(int=9)))
    step("get_disk_id", d.get_disk_id)
    info = d.disk_info()
    out.append(("disk_info", info.fs_type, info.error, info.total > 0))
    step("make_vol_vd", d.make_vol, "vd")
    step("write_all_vd", d.write_all, "vd", "x", b"x")
    step("delete_vol_busy", d.delete_vol, "vd")
    step("delete_vol_force", d.delete_vol, "vd", True)
    return out


@pytest.mark.parametrize("client_pkg,service_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_storage_rest_across_packages(services, tmp_path, client_pkg,
                                      service_pkg):
    """The client of one package over the other's service answers and
    writes exactly what a local disk of the serving package does."""
    svc = services[service_pkg]
    cls = PClient if client_pkg == "port" else JClient
    rc = cls(svc.url, svc.path, SECRET)
    assert not rc.is_local() and rc.endpoint() == svc.url + svc.path
    remote = _script(rc, service_pkg)
    local_root = str(tmp_path / "local")
    local = _script(svc.local(local_root), service_pkg)
    assert remote == local
    assert tree(svc.path) == tree(local_root)
    rc.close()


def test_both_services_leave_the_same_tree(tmp_path):
    """The port client over a fresh JAX service and the JAX client over a
    fresh port service: the same answers, the same bytes."""
    fresh = {pkg: _Service(pkg, str(tmp_path / pkg))
             for pkg in ("jax", "port")}
    try:
        runs = []
        for client_cls, svc in ((PClient, fresh["jax"]),
                                (JClient, fresh["port"])):
            rc = client_cls(svc.url, svc.path, SECRET)
            runs.append(_script(rc, svc.pkg))
            rc.close()
        assert runs[0] == runs[1]
        trees = [{k: v for k, v in tree(svc.path).items()
                  if not k.startswith(".minio.sys")}
                 for svc in fresh.values()]
        assert trees[0] == trees[1] and "vb/inl/xl.meta" in trees[0]
    finally:
        for svc in fresh.values():
            svc.close()


def test_typed_errors_and_tokens_cross(services):
    for client_cls, errs, svc in ((PClient, perrors, services["jax"]),
                                  (JClient, jerrors, services["port"])):
        rc = client_cls(svc.url, svc.path, SECRET)
        with pytest.raises(errs.VolumeNotFound):
            rc.stat_vol("missing-vol")
        with pytest.raises(errs.DiskNotFound):
            client_cls(svc.url, "/not/served", SECRET).stat_vol("x")
        bad = client_cls(svc.url, svc.path, "wrong-secret")
        with pytest.raises(errs.StorageError):
            bad.stat_vol("x")
        rc.close()


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_lock_rest_across_packages(services, client_pkg):
    """A lock client of one package against the other's lock service:
    grants, refusals, expiry probes and force unlocks."""
    svc = services["jax" if client_pkg == "port" else "port"]
    cls = PLockClient if client_pkg == "port" else JLockClient
    a = cls(svc.url, SECRET, src="http://a")
    assert a.lock("b/o", "u1", "http://a")
    assert not a.lock("b/o", "u2", "http://b")
    assert not a.rlock("b/o", "u3", "http://b")
    assert a.expired_info("b/o", "u1") is False
    assert a.unlock("b/o", "u1")
    assert a.expired_info("b/o", "u1") is True
    assert a.rlock("b/o", "u4", "http://a") and a.rlock("b/o", "u5", "x")
    assert a.runlock("b/o", "u4")
    assert a.force_unlock("b/o")
    assert svc.locker.snapshot() == {}
    dead = cls("http://127.0.0.1:1", SECRET)
    assert dead.expired_info("b/o", "u1") is None
    assert not dead.lock("b/o", "u1", "x")


def test_keepalive_connection_survives_a_peer_restart(tmp_path):
    """One pooled connection, reused call after call and by other
    threads; a peer that restarts (its listener closes every idle
    connection) is reached again on a fresh connection, with no failed
    call and the client never marked offline."""
    import threading
    svc = _Service("port", str(tmp_path / "a"))
    port = svc.srv.port
    rc = PClient(svc.url, svc.path, SECRET)
    try:
        rc.make_vol("kv")
        for _ in range(5):
            rc.stat_vol("kv")
        assert len(rc.rpc._idle) == 1
        ths = [threading.Thread(target=rc.stat_vol, args=("kv",))
               for _ in range(3)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=30)
        assert 1 <= len(rc.rpc._idle) <= 4
        svc.srv.shutdown()
        svc.srv.hard_close_connections()
        again = PServer(None, "127.0.0.1", port, access_key="ak",
                        secret_key=SECRET, device="cpu")
        again.internal = svc.srv.internal
        again.start_background()
        svc.srv = again
        assert rc.stat_vol("kv").name == "kv"
        st = rc.rpc.health_stats()
        assert st["online"] and st["failures_total"] == 0
        calls = rc.rpc.method_stats()["statvol"]
        assert calls["calls"] == 9 and calls["errors"] == 0
        assert len(calls["seconds"]) == 9
    finally:
        rc.close()
        svc.close()


def test_short_lived_threads_leave_a_bounded_pool(tmp_path, monkeypatch):
    """Calls from a few hundred threads that each make one call and end
    (a request thread, a heal worker): 200 one after another share one
    connection, and 200 at once leave at most ``POOL_IDLE_MAX`` open
    once they are done, the rest closed after their call."""
    import threading
    opened, closed = [], []

    class Counted(prpc._Connection):
        def connect(self):
            super().connect()
            opened.append(self)

        def close(self):
            if self.sock is not None:
                closed.append(self)
            super().close()

    monkeypatch.setattr(prpc, "_Connection", Counted)
    svc = _Service("port", str(tmp_path / "a"))
    rc = PClient(svc.url, svc.path, SECRET)
    try:
        rc.make_vol("kv")
        for _ in range(200):
            t = threading.Thread(target=rc.stat_vol, args=("kv",))
            t.start()
            t.join(timeout=30)
        assert len(opened) == 1 and not closed
        n = 200
        gate = threading.Barrier(n)
        errs = []

        def one():
            gate.wait(timeout=60)
            try:
                assert rc.stat_vol("kv").name == "kv"
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ths = [threading.Thread(target=one) for _ in range(n)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert not errs and not any(t.is_alive() for t in ths)
        assert len(opened) - len(closed) <= prpc.POOL_IDLE_MAX
        assert len(rc.rpc._idle) == len(opened) - len(closed)
        assert rc.rpc.method_stats()["statvol"]["errors"] == 0
    finally:
        rc.close()
        svc.close()
    assert len(opened) == len(closed)
