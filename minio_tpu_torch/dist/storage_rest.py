"""Storage REST service — remote disks, the port of
minio_tpu/dist/storage_rest.py (reference
cmd/storage-rest-{common,client,server}.go): every StorageAPI method becomes
``POST /minio/storage/v1/<method>?disk=...&volume=...&path=...`` with
msgpack bodies for FileInfo and raw streams for shard data. The client is a
StorageAPI, so the erasure engine uses local and remote disks
interchangeably (SURVEY.md §1 L3→L2).

The bodies are the JAX package's MessagePack documents, packed and
unpacked by the port's own subset (``utils/msgpack.py``): a JAX node's
service reads the port's client and the reverse."""
from __future__ import annotations

from ..storage.datatypes import DiskInfo, FileInfo, VolInfo
from ..storage.interface import StorageAPI
from ..utils import errors, msgpack
from .rpc import RPCClient


class StorageRESTClient(StorageAPI):
    """Remote disk: one RPC client bound to (node URL, disk path)."""

    def __init__(self, node_url: str, disk_path: str, secret: str,
                 src: str = ""):
        self.rpc = RPCClient(node_url, "storage", secret, src=src)
        self.disk_path = disk_path
        self._endpoint = f"{node_url}{disk_path}"

    #: read-only methods safe to retry on transport failures (the
    #: RPC client grants these a jittered-backoff retry budget)
    IDEMPOTENT = frozenset({
        "diskinfo", "getdiskid", "listvols", "statvol", "listdir",
        "readall", "readfileat", "statfilesize", "readversion",
        "listversions", "checkparts", "verifyfile", "walkdir",
        "walkversions"})

    def _call(self, method: str, params: dict | None = None,
              body: bytes | None = None):
        p = {"disk": self.disk_path}
        p.update(params or {})
        return self.rpc.call(method, p, body,
                             idempotent=method in self.IDEMPOTENT)

    # --- identity -----------------------------------------------------------

    def endpoint(self) -> str:
        return self._endpoint

    def is_local(self) -> bool:
        return False

    def is_online(self) -> bool:
        return self.rpc.is_online()

    def close(self) -> None:
        self.rpc.close()

    def disk_info(self) -> DiskInfo:
        d = msgpack.unpackb(self._call("diskinfo"))
        return DiskInfo(**d)

    def get_disk_id(self) -> str:
        return self._call("getdiskid").decode()

    def set_disk_id(self, disk_id: str) -> None:
        self._call("setdiskid", {"id": disk_id})

    # --- volumes ------------------------------------------------------------

    def make_vol(self, volume: str) -> None:
        self._call("makevol", {"volume": volume})

    def list_vols(self) -> list[VolInfo]:
        vols = msgpack.unpackb(self._call("listvols"))
        return [VolInfo(name=v["name"], created=v["created"]) for v in vols]

    def stat_vol(self, volume: str) -> VolInfo:
        v = msgpack.unpackb(self._call("statvol", {"volume": volume}))
        return VolInfo(name=v["name"], created=v["created"])

    def delete_vol(self, volume: str, force: bool = False) -> None:
        self._call("deletevol", {"volume": volume, "force": int(force)})

    # --- raw files ----------------------------------------------------------

    def list_dir(self, volume: str, dir_path: str, count: int = -1
                 ) -> list[str]:
        return msgpack.unpackb(
            self._call("listdir", {"volume": volume, "dir": dir_path,
                                   "count": count}))

    def read_all(self, volume: str, path: str) -> bytes:
        return self._call("readall", {"volume": volume, "path": path})

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        self._call("writeall", {"volume": volume, "path": path}, data)

    def append_file(self, volume: str, path: str, data: bytes) -> None:
        self._call("appendfile", {"volume": volume, "path": path}, data)

    def create_file_writer(self, volume: str, path: str):
        return _RemoteFileWriter(self, volume, path)

    def read_file_at(self, volume: str, path: str):
        return _RemoteFileReadAt(self, volume, path)

    def rename_file(self, src_volume, src_path, dst_volume, dst_path):
        self._call("renamefile", {
            "svolume": src_volume, "spath": src_path,
            "dvolume": dst_volume, "dpath": dst_path})

    def delete_path(self, volume: str, path: str, recursive: bool = False
                    ) -> None:
        self._call("deletepath", {"volume": volume, "path": path,
                                  "recursive": int(recursive)})

    def stat_file_size(self, volume: str, path: str) -> int:
        return int(self._call("statfilesize",
                              {"volume": volume, "path": path}))

    # --- versions -----------------------------------------------------------

    def rename_data(self, src_volume, src_path, fi: FileInfo,
                    dst_volume, dst_path) -> None:
        self._call("renamedata", {
            "svolume": src_volume, "spath": src_path,
            "dvolume": dst_volume, "dpath": dst_path},
            msgpack.packb(fi.to_rpc()))

    def write_metadata(self, volume, path, fi: FileInfo) -> None:
        self._call("writemetadata", {"volume": volume, "path": path},
                   msgpack.packb(fi.to_rpc()))

    def update_metadata(self, volume, path, fi: FileInfo) -> None:
        self._call("updatemetadata", {"volume": volume, "path": path},
                   msgpack.packb(fi.to_rpc()))

    def read_version(self, volume, path, version_id="", read_data=False
                     ) -> FileInfo:
        blob = self._call("readversion", {
            "volume": volume, "path": path, "vid": version_id,
            "readdata": int(read_data)})
        return FileInfo.from_rpc(msgpack.unpackb(blob))

    def list_versions(self, volume, path) -> list[FileInfo]:
        blob = self._call("listversions", {"volume": volume, "path": path})
        return [FileInfo.from_rpc(d)
                for d in msgpack.unpackb(blob)]

    def delete_version(self, volume, path, fi: FileInfo) -> None:
        self._call("deleteversion", {"volume": volume, "path": path},
                   msgpack.packb(fi.to_rpc()))

    def delete_versions(self, volume, paths, fis) -> list:
        """Vectorized delete: ONE round trip for the whole batch
        (reference DeleteVersions RPC, cmd/storage-rest-client.go)."""
        body = msgpack.packb(
            {"paths": paths, "fis": [fi.to_rpc() for fi in fis]})
        out = msgpack.unpackb(
            self._call("deleteversions", {"volume": volume}, body))
        return [None if e is None else errors.FaultyDisk(e) for e in out]

    def check_parts(self, volume, path, fi: FileInfo) -> None:
        self._call("checkparts", {"volume": volume, "path": path},
                   msgpack.packb(fi.to_rpc()))

    def verify_file(self, volume, path, fi: FileInfo) -> None:
        self._call("verifyfile", {"volume": volume, "path": path},
                   msgpack.packb(fi.to_rpc()))

    def walk_dir(self, volume: str, dir_path: str = "",
                 recursive: bool = True):
        blob = self._call("walkdir", {"volume": volume, "dir": dir_path,
                                      "recursive": int(recursive)})
        yield from msgpack.unpackb(blob)

    #: Page size for the remote metadata walk: bounds per-RPC payload while
    #: keeping round-trips ~1 per listing page.
    WALK_PAGE = 1000

    def walk_versions(self, volume: str, prefix: str = "", marker: str = "",
                      limit: int = -1):
        """Paged remote walk: each RPC returns up to WALK_PAGE sorted
        (name, xl.meta) pairs after the rolling marker, so the remote disk
        does O(page) work per call no matter the namespace size."""
        got = 0
        cur = marker
        while True:
            page = self.WALK_PAGE if limit < 0 else min(
                self.WALK_PAGE, limit - got)
            if page <= 0:
                return
            blob = self._call("walkversions", {
                "volume": volume, "prefix": prefix, "marker": cur,
                "limit": page})
            entries = msgpack.unpackb(blob)
            for name, raw in entries:
                got += 1
                cur = name
                yield name, raw
            if len(entries) < page:
                return


class _RemoteFileWriter:
    """Streams shard blocks to the remote disk: first write truncates
    (createfile), later writes append — one RPC per erasure block, the same
    cadence as the reference's streaming CreateFile."""

    def __init__(self, client: StorageRESTClient, volume: str, path: str):
        self.c = client
        self.volume = volume
        self.path = path
        self._created = False

    def write(self, b: bytes):
        method = "appendfile" if self._created else "createfile"
        self.c._call(method, {"volume": self.volume, "path": self.path}, b)
        self._created = True

    def close(self):
        if not self._created:
            # ensure an empty file exists
            self.c._call("createfile",
                         {"volume": self.volume, "path": self.path}, b"")
            self._created = True

    def abort(self):
        try:
            self.c.delete_path(self.volume, self.path)
        except errors.StorageError:
            pass


class _RemoteFileReadAt:
    def __init__(self, client: StorageRESTClient, volume: str, path: str):
        self.c = client
        self.volume = volume
        self.path = path

    def read_at(self, offset: int, length: int) -> bytes:
        return self.c._call("readfileat", {
            "volume": self.volume, "path": self.path,
            "offset": offset, "length": length})

    def close(self):
        pass


# --- server side --------------------------------------------------------------


class StorageRESTService:
    """Serves local disks over the RPC surface. Mounted into the node's HTTP
    server under /minio/storage/v1/."""

    def __init__(self, disks: dict[str, object]):
        #: disk path -> XLStorage
        self.disks = disks

    def handle(self, method: str, params: dict, body: bytes) -> bytes:
        disk = self.disks.get(params.get("disk", ""))
        if disk is None:
            raise errors.DiskNotFound(params.get("disk", ""))
        fn = getattr(self, f"_h_{method}", None)
        if fn is None:
            raise errors.MethodNotSupported(method)
        return fn(disk, params, body)

    # each handler returns response bytes
    def _h_diskinfo(self, d, p, b):
        i = d.disk_info()
        return msgpack.packb(i.__dict__)

    def _h_getdiskid(self, d, p, b):
        return d.get_disk_id().encode()

    def _h_setdiskid(self, d, p, b):
        d.set_disk_id(p.get("id", ""))
        return b""

    def _h_makevol(self, d, p, b):
        d.make_vol(p["volume"])
        return b""

    def _h_listvols(self, d, p, b):
        return msgpack.packb(
            [{"name": v.name, "created": v.created} for v in d.list_vols()])

    def _h_statvol(self, d, p, b):
        v = d.stat_vol(p["volume"])
        return msgpack.packb({"name": v.name, "created": v.created})

    def _h_deletevol(self, d, p, b):
        d.delete_vol(p["volume"], bool(int(p.get("force", "0"))))
        return b""

    def _h_listdir(self, d, p, b):
        return msgpack.packb(
            d.list_dir(p["volume"], p.get("dir", ""),
                       int(p.get("count", "-1"))))

    def _h_readall(self, d, p, b):
        return d.read_all(p["volume"], p["path"])

    def _h_writeall(self, d, p, b):
        d.write_all(p["volume"], p["path"], b or b"")
        return b""

    def _h_appendfile(self, d, p, b):
        d.append_file(p["volume"], p["path"], b or b"")
        return b""

    def _h_createfile(self, d, p, b):
        w = d.create_file_writer(p["volume"], p["path"])
        w.write(b or b"")
        w.close()
        return b""

    def _h_readfileat(self, d, p, b):
        r = d.read_file_at(p["volume"], p["path"])
        try:
            return r.read_at(int(p["offset"]), int(p["length"]))
        finally:
            r.close()

    def _h_renamefile(self, d, p, b):
        d.rename_file(p["svolume"], p["spath"], p["dvolume"], p["dpath"])
        return b""

    def _h_deletepath(self, d, p, b):
        d.delete_path(p["volume"], p["path"],
                      bool(int(p.get("recursive", "0"))))
        return b""

    def _h_statfilesize(self, d, p, b):
        return str(d.stat_file_size(p["volume"], p["path"])).encode()

    def _h_renamedata(self, d, p, b):
        fi = FileInfo.from_rpc(msgpack.unpackb(b))
        d.rename_data(p["svolume"], p["spath"], fi, p["dvolume"], p["dpath"])
        return b""

    def _h_writemetadata(self, d, p, b):
        d.write_metadata(p["volume"], p["path"],
                         FileInfo.from_rpc(msgpack.unpackb(b)))
        return b""

    def _h_updatemetadata(self, d, p, b):
        d.update_metadata(p["volume"], p["path"],
                          FileInfo.from_rpc(msgpack.unpackb(b)))
        return b""

    def _h_readversion(self, d, p, b):
        fi = d.read_version(p["volume"], p["path"], p.get("vid", ""),
                            bool(int(p.get("readdata", "0"))))
        return msgpack.packb(fi.to_rpc())

    def _h_listversions(self, d, p, b):
        fis = d.list_versions(p["volume"], p["path"])
        return msgpack.packb([fi.to_rpc() for fi in fis])

    def _h_deleteversion(self, d, p, b):
        d.delete_version(p["volume"], p["path"],
                         FileInfo.from_rpc(msgpack.unpackb(b)))
        return b""

    def _h_deleteversions(self, d, p, b):
        req = msgpack.unpackb(b)
        fis = [FileInfo.from_rpc(x) for x in req["fis"]]
        out = d.delete_versions(p["volume"], req["paths"], fis)
        return msgpack.packb(
            [None if e is None else str(e) for e in out])

    def _h_checkparts(self, d, p, b):
        d.check_parts(p["volume"], p["path"],
                      FileInfo.from_rpc(msgpack.unpackb(b)))
        return b""

    def _h_verifyfile(self, d, p, b):
        d.verify_file(p["volume"], p["path"],
                      FileInfo.from_rpc(msgpack.unpackb(b)))
        return b""

    def _h_walkdir(self, d, p, b):
        entries = list(d.walk_dir(p["volume"], p.get("dir", ""),
                                  bool(int(p.get("recursive", "1")))))
        return msgpack.packb(entries)

    def _h_walkversions(self, d, p, b):
        entries = list(d.walk_versions(
            p["volume"], p.get("prefix", ""), p.get("marker", ""),
            int(p.get("limit", "-1"))))
        return msgpack.packb(entries)
