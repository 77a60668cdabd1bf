"""XLStorage — the local posix disk backend, the port of
storage/xlstorage.py (reference xlStorage, cmd/xl-storage.go:91): one
directory per disk, one sub-directory per volume (bucket), per object a
directory holding ``xl.meta`` plus ``<dataDir-uuid>/part.N`` shard files
(layout doc cmd/xl-storage-format-v2.go:72-80, SURVEY.md A.2). The layout
and every file's bytes are the JAX package's: a disk written by one package
is served by the other.

Write discipline mirrors the reference: shard data streams into
``.minio.sys/tmp/<id>/...`` and is committed by an atomic rename
(rename_data); xl.meta updates write-to-tmp + ``durable_replace`` (the
fsync-policy commit primitive, storage/durability.py). A shard file itself
is written beside its destination and renamed onto it on close, so a
reader never sees a half-written shard.

Every disk call is measured (``_OpSpan``): its seconds and bytes feed the
per-disk per-op last-minute latency window (``minio_tpu_disk_latency_
seconds``), a storage trace while someone listens, and a storage span in
the calling request's trace.

The fault plane (``fault/``) injects at the JAX package's sites, each one
armed-flag check when no ``disk`` rule is armed: every measured op (a
typed error raised, a delay inside the measured span), every shard
``read_at`` (``bitrot`` corrupts the returned span), ``create_file_writer``
and ``read_file_at``, the walks, and the named write steps of the commit
protocol (``WRITE_STEPS``: ``crash`` raises ``SimulatedCrash``, ``torn``
truncates the pending tmp file).
"""
from __future__ import annotations

import logging
import os
import shutil
import stat
import threading
import time
import uuid
from typing import Iterator

from .. import fault as _fault
from ..obs import latency as _lat
from ..obs import metrics as _mx
from ..obs import spans as _spans
from ..obs import trace as _trc
from ..utils import errors
from .datatypes import DiskInfo, FileInfo, VolInfo
from .durability import (FSYNC_ALWAYS, durable_replace, durable_replace_dir,
                         fsync_after_write, fsync_mode, fsync_path)
from .interface import StorageAPI
from .xlmeta import XL_META_CORRUPT_FILE, XL_META_FILE, XLMeta

#: Reserved system volume (reference minioMetaBucket ".minio.sys").
META_BUCKET = ".minio.sys"
META_TMP = f"{META_BUCKET}/tmp"
META_MULTIPART = f"{META_BUCKET}/multipart"
META_BUCKETS = f"{META_BUCKET}/buckets"
FORMAT_FILE = "format.json"


def _check_path(p: str):
    if p.startswith("/") or ".." in p.split("/"):
        raise errors.FileAccessDenied(p)
    if any(len(seg) > 255 for seg in p.split("/")):
        raise errors.FileNameTooLong(p)


def new_tmp_id() -> str:
    """pid-prefixed staging id for everything under ``.minio.sys/tmp``:
    sweep_tmp skips entries minted by a DIFFERENT still-alive process,
    while a restart — a new pid — reclaims everything the dead process
    left behind."""
    return f"{os.getpid()}-{uuid.uuid4()}"


def _minted_by_live_peer(name: str) -> bool:
    """True when a tmp entry carries another LIVE process's pid prefix."""
    pid_s = name.split("-", 1)[0]
    if not pid_s.isdigit():
        return False
    pid = int(pid_s)
    if pid == os.getpid():
        return False
    try:
        os.kill(pid, 0)
        return True
    except (ProcessLookupError, OverflowError):
        return False
    except OSError:
        return True  # EPERM etc.: exists under another uid — alive


class _FileWriter:
    """Streaming shard-file writer: bytes go to ``<path>.tmp.<pid>`` and
    ``close()`` renames it onto ``path``; ``abort()`` deletes it. Under the
    ``always`` fsync policy the bytes are fsynced before the rename: a
    commit (rename_data) of dirents whose content never hit media is the
    torn-shard case the policy exists for."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._path = path
        self._tmp = f"{path}.tmp.{os.getpid()}"
        self._f = open(self._tmp, "wb")

    def write(self, b) -> None:
        self._f.write(b)

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.close()
        if fsync_mode() == FSYNC_ALWAYS:
            # strict: a failed shard writeback fails THIS disk's write
            fsync_path(self._tmp, strict=True)
        os.replace(self._tmp, self._path)

    def abort(self) -> None:
        self._f.close()
        try:
            os.unlink(self._tmp)
        except OSError:
            pass


class _FileReadAt:
    """Positional reads over one shard file (raw os.open + pread)."""

    def __init__(self, path: str, endpoint: str = ""):
        self._fd = -1  # __del__ runs even when os.open below raises
        self._endpoint = endpoint
        try:
            self._fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError:
            raise errors.FileNotFound(path) from None
        except IsADirectoryError:
            raise errors.IsNotRegular(path) from None
        if stat.S_ISDIR(os.fstat(self._fd).st_mode):
            os.close(self._fd)
            self._fd = -1
            raise errors.IsNotRegular(path)

    def read_at(self, offset: int, length: int) -> bytes:
        out = os.pread(self._fd, length, offset)
        if _fault.armed("disk"):
            # the per-shard-read injection point: a delay or hang makes
            # this source a straggler (hedged reads route around it), an
            # error is a typed vote, bitrot corrupts the returned span
            # (the bitrot check upstairs catches it)
            if _fault.inject("disk", self._endpoint,
                             "read_at") is _fault.BITROT:
                out = _fault.corrupt(out)
        return out

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __del__(self):  # raw fds have no GC finalizer of their own
        self.close()


#: the crash-point catalogue of the commit protocol, the JAX package's
#: (the admin ``durability`` op lists it): each is a named step where a
#: ``crash`` or ``torn`` rule (``disk:<target>:<step>:crash``) can fire
WRITE_STEPS = (
    "pre_replace",        # tmp written, about to become visible
    "post_replace",       # rename landed, fsync policy applied
    "pre_data_rename",    # rename_data: before the dataDir moves
    "post_data_rename",   # dataDir visible, xl.meta not yet updated
    "pre_meta_write",     # version journal about to be rewritten
    "post_meta_write",    # journal committed, tmp/purge cleanup pending
    "pre_rename_file",    # rename_file commit (multipart part promote)
    "pre_append",         # append_file about to mutate in place
)

#: instruments of ``_OpSpan`` that raised (counted, logged, never fatal)
_obs_errors = 0
_obs_errors_lock = threading.Lock()
log = logging.getLogger(__name__)


def obs_errors() -> int:
    """How many storage-call instruments raised since the process began
    (their disk calls kept their own results)."""
    return _obs_errors


class _OpSpan:
    """One measured storage call (reference storageTrace wrapping every
    xlStorage op with trace type madmin.TraceStorage): feeds the per-disk
    last-minute latency window, publishes a storage trace only while a
    trace subscriber listens, and records a leaf span into the calling
    request's trace. An instrument that raises never replaces the disk
    call's result: it is counted (``obs_errors()``) and logged."""

    __slots__ = ("disk", "op", "path", "in_bytes", "t0")

    def __init__(self, disk: str, op: str, path: str, in_bytes: int = 0):
        self.disk = disk
        self.op = op
        self.path = path
        self.in_bytes = in_bytes

    def __enter__(self) -> "_OpSpan":
        self.t0 = time.perf_counter()
        if _fault.armed("disk"):
            # the per-op injection point: a typed error reaches the caller
            # as a real disk failure would; a delay lands inside the
            # measured span, so the latency windows and health see it
            _fault.inject("disk", self.disk, self.op)
        return self

    def __exit__(self, etype, exc, tb) -> bool:
        global _obs_errors
        dur = time.perf_counter() - self.t0
        try:
            ctx = _spans.current()
            tid = ctx.trace_id if ctx is not None and ctx.sampled else ""
            err = f"{etype.__name__}: {exc}" if etype else ""
            _lat.observe("disk", dur, self.in_bytes, disk=self.disk,
                         op=self.op, trace_id=tid)
            _trc.publish_storage(node=self.disk, op=self.op, path=self.path,
                                 duration_s=dur, input_bytes=self.in_bytes,
                                 error=err)
            if tid:
                _spans.record({
                    "name": f"storage.{self.op}", "trace_id": tid,
                    "span_id": _spans.new_span_id(),
                    "parent_span_id": ctx.span_id,
                    "time": time.time() - dur, "duration_s": round(dur, 6),
                    "error": err,
                    "attrs": {"disk": self.disk, "path": self.path,
                              "bytes": self.in_bytes}})
        except Exception:  # noqa: BLE001 — counted, logged, never fatal
            with _obs_errors_lock:
                _obs_errors += 1
            log.exception("storage instrument of %s failed", self.op)
        return False


class XLStorage(StorageAPI):
    """One disk: a root directory of volumes (see the module doc)."""

    def __init__(self, root: str, endpoint: str = ""):
        self.root = os.path.abspath(root)
        self._endpoint = endpoint or self.root
        self._disk_id = ""
        # RLock: _quarantine_meta re-verifies under the lock and is reached
        # from _load_meta calls that may already hold it. The per-disk
        # metadata read-modify-write (load xl.meta -> mutate -> durable
        # store, plus the dataDir commit rename) IS the critical section
        self._meta_lock = threading.RLock()
        for d in (META_TMP, META_MULTIPART, META_BUCKETS):
            os.makedirs(self._abs(d), exist_ok=True)

    # --- helpers ------------------------------------------------------------

    def _abs(self, *parts: str) -> str:
        for p in parts:
            _check_path(p)
        return os.path.join(self.root, *parts)

    def endpoint(self) -> str:
        return self._endpoint

    def _op(self, op: str, volume: str, path: str = "",
            in_bytes: int = 0) -> _OpSpan:
        return _OpSpan(self._endpoint, op,
                       f"{volume}/{path}" if path else volume, in_bytes)

    def _write_step(self, step: str, tmp: str | None = None) -> None:
        """A named crash point of the commit protocol (WRITE_STEPS): a
        ``crash`` rule raises SimulatedCrash here (no cleanup runs), a
        ``torn`` rule truncates the pending tmp file at a random offset
        before it becomes visible."""
        if not _fault.armed("disk"):
            return
        res = _fault.inject("disk", self._endpoint, step)
        if isinstance(res, _fault._Torn):
            if tmp:
                _fault.torn_truncate(tmp, res.rng)
            else:
                # the rule fired (and spent its budget) at a step that owns
                # no pending tmp file: say so rather than pass silently
                from ..obs.logger import log_sys
                log_sys().log_once(
                    f"torn-no-tmp:{step}", "warning", "fault",
                    f"torn rule fired at step {step!r} which owns no "
                    f"pending tmp file — nothing was torn")

    def get_disk_id(self) -> str:
        return self._disk_id

    def set_disk_id(self, disk_id: str) -> None:
        self._disk_id = disk_id

    def disk_info(self) -> DiskInfo:
        with self._op("disk_info", ""):
            st = os.statvfs(self.root)
            total = st.f_blocks * st.f_frsize
            free = st.f_bavail * st.f_frsize
            return DiskInfo(total=total, free=free, used=total - free,
                            fs_type="posix", endpoint=self._endpoint,
                            mount_path=self.root, id=self._disk_id)

    # --- volumes ------------------------------------------------------------

    def make_vol(self, volume: str) -> None:
        with self._op("make_vol", volume):
            p = self._abs(volume)
            if os.path.isdir(p):
                raise errors.VolumeExists(volume)
            os.makedirs(p, exist_ok=True)

    def list_vols(self) -> list[VolInfo]:
        with self._op("list_vols", ""):
            out = []
            for name in sorted(os.listdir(self.root)):
                if name == META_BUCKET:
                    continue
                p = os.path.join(self.root, name)
                if os.path.isdir(p):
                    out.append(VolInfo(name=name, created=os.stat(p).st_ctime))
            return out

    def stat_vol(self, volume: str) -> VolInfo:
        with self._op("stat_vol", volume):
            p = self._abs(volume)
            if not os.path.isdir(p):
                raise errors.VolumeNotFound(volume)
            return VolInfo(name=volume, created=os.stat(p).st_ctime)

    def delete_vol(self, volume: str, force: bool = False) -> None:
        with self._op("delete_vol", volume):
            p = self._abs(volume)
            if not os.path.isdir(p):
                raise errors.VolumeNotFound(volume)
            if force:
                shutil.rmtree(p)
                return
            try:
                os.rmdir(p)
            except OSError:
                raise errors.VolumeNotEmpty(volume) from None

    # --- raw files ----------------------------------------------------------

    def list_dir(self, volume: str, dir_path: str, count: int = -1
                 ) -> list[str]:
        with self._op("list", volume, dir_path):
            base = self._abs(volume, dir_path) if dir_path else self._abs(volume)
            if not os.path.isdir(self._abs(volume)):
                raise errors.VolumeNotFound(volume)
            try:
                names = sorted(os.listdir(base))
            except FileNotFoundError:
                raise errors.FileNotFound(dir_path) from None
            except NotADirectoryError:
                raise errors.IsNotRegular(dir_path) from None
            out = []
            for n in names:
                if os.path.isdir(os.path.join(base, n)):
                    n += "/"
                out.append(n)
                if 0 < count <= len(out):
                    break
            return out

    def read_all(self, volume: str, path: str) -> bytes:
        """Whole-file read (raw os.open/os.read: xl.meta reads run once per
        disk per request)."""
        with self._op("read_all", volume, path):
            return self._read_all_inner(volume, path)

    def _read_all_inner(self, volume: str, path: str) -> bytes:
        try:
            fd = os.open(self._abs(volume, path), os.O_RDONLY)
        except FileNotFoundError:
            if not os.path.isdir(self._abs(volume)):
                raise errors.VolumeNotFound(volume) from None
            raise errors.FileNotFound(path) from None
        except IsADirectoryError:
            raise errors.IsNotRegular(path) from None
        try:
            size = os.fstat(fd).st_size
            chunks = []
            got = 0
            while got < size:
                b = os.read(fd, size - got)
                if not b:
                    break
                chunks.append(b)
                got += len(b)
            return chunks[0] if len(chunks) == 1 else b"".join(chunks)
        except IsADirectoryError:
            raise errors.IsNotRegular(path) from None
        finally:
            os.close(fd)

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        """Atomic whole-file write (tmp + durable rename)."""
        with self._op("write_all", volume, path, in_bytes=len(data)):
            self._write_all_inner(volume, path, data)

    def _write_all_inner(self, volume: str, path: str, data: bytes) -> None:
        dst = self._abs(volume, path)
        if not os.path.isdir(self._abs(volume)):
            raise errors.VolumeNotFound(volume)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = self._abs(META_TMP, new_tmp_id())
        with open(tmp, "wb") as f:
            f.write(data)
        self._write_step("pre_replace", tmp=tmp)
        durable_replace(tmp, dst)
        self._write_step("post_replace")

    def append_file(self, volume: str, path: str, data: bytes) -> None:
        with self._op("append_file", volume, path, in_bytes=len(data)):
            dst = self._abs(volume, path)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            self._write_step("pre_append")
            with open(dst, "ab") as f:
                f.write(data)
            fsync_after_write(dst)

    def create_file_writer(self, volume: str, path: str) -> _FileWriter:
        if _fault.armed("disk"):
            _fault.inject("disk", self._endpoint, "create_file_writer")
        return _FileWriter(self._abs(volume, path))

    def read_file_at(self, volume: str, path: str) -> _FileReadAt:
        if _fault.armed("disk"):
            _fault.inject("disk", self._endpoint, "read_file_at")
        return _FileReadAt(self._abs(volume, path), self._endpoint)

    def rename_file(self, src_volume: str, src_path: str, dst_volume: str,
                    dst_path: str) -> None:
        with self._op("rename_file", src_volume, src_path):
            src = self._abs(src_volume, src_path)
            dst = self._abs(dst_volume, dst_path)
            if not os.path.exists(src):
                raise errors.FileNotFound(src_path)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            self._write_step("pre_rename_file", tmp=src)
            durable_replace(src, dst)

    def delete_path(self, volume: str, path: str, recursive: bool = False
                    ) -> None:
        with self._op("delete", volume, path):
            self._delete_path_inner(volume, path, recursive)

    def _delete_path_inner(self, volume: str, path: str,
                           recursive: bool = False) -> None:
        p = self._abs(volume, path)
        try:
            if os.path.isdir(p):
                if recursive:
                    shutil.rmtree(p)
                else:
                    os.rmdir(p)
            else:
                os.unlink(p)
        except FileNotFoundError:
            raise errors.FileNotFound(path) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e
        # prune now-empty parents up to the volume root (reference
        # deleteFile parent cleanup)
        parent = os.path.dirname(p)
        vol_root = self._abs(volume)
        while parent != vol_root and parent.startswith(self.root):
            try:
                os.rmdir(parent)
            except OSError:
                break
            parent = os.path.dirname(parent)

    def stat_file_size(self, volume: str, path: str) -> int:
        with self._op("stat", volume, path):
            p = self._abs(volume, path)
            try:
                st = os.stat(p)
            except FileNotFoundError:
                raise errors.FileNotFound(path) from None
            if not stat.S_ISREG(st.st_mode):
                raise errors.IsNotRegular(path)
            return st.st_size

    # --- xl.meta version ops ------------------------------------------------

    def _meta_path(self, volume: str, path: str) -> str:
        return self._abs(volume, path, XL_META_FILE)

    def _load_meta(self, volume: str, path: str) -> XLMeta:
        try:
            # an unmeasured inner read: the calling meta op owns the span
            blob = self._read_all_inner(volume, f"{path}/{XL_META_FILE}")
        except errors.FileNotFound:
            raise errors.FileNotFound(path) from None
        try:
            return XLMeta.load(blob)
        except errors.FileCorrupt:
            self._quarantine_meta(volume, path)
            raise

    def _quarantine_meta(self, volume: str, path: str) -> bool:
        """Move an unparseable/torn xl.meta aside to xl.meta.corrupt:
        forensics survive, and the slot reads FileNotFound from now on —
        which heal classifies as MISSING and rebuilds from quorum.

        Re-verifies under ``_meta_lock`` before renaming: between a lockless
        reader's torn read and this rename a writer or heal may have
        committed a VALID journal at the same path."""
        src = self._meta_path(volume, path)
        dst = self._abs(volume, path, XL_META_CORRUPT_FILE)
        with self._meta_lock:
            try:
                XLMeta.load(self.read_all(volume, f"{path}/{XL_META_FILE}"))
                return False  # valid now — a concurrent commit won
            except errors.FileCorrupt:
                pass
            except (errors.StorageError, OSError):
                return False  # gone/unreadable: nothing to move aside
            try:
                durable_replace(src, dst)
            except OSError:
                return False
        _mx.inc("minio_tpu_durability_quarantined_meta_total")
        return True

    def _store_meta(self, volume: str, path: str, meta: XLMeta) -> None:
        if not meta.versions:
            # last version removed: delete the whole object dir
            self._delete_path_inner(volume, path, recursive=True)
            return
        self._write_all_inner(volume, f"{path}/{XL_META_FILE}", meta.dump())

    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str) -> None:
        """Commit a freshly written object version: move
        ``<src>/<dataDir>`` under the object dir and add the version to
        xl.meta atomically w.r.t. this disk (reference RenameData)."""
        with self._op("rename_data", dst_volume, dst_path):
            with self._meta_lock:
                try:
                    meta = self._load_meta(dst_volume, dst_path)
                except errors.FileNotFound:
                    meta = XLMeta()
                if fi.data_dir and fi.data is None:
                    src = self._abs(src_volume, src_path, fi.data_dir)
                    if not os.path.isdir(src):
                        raise errors.FileNotFound(src_path)
                    dst = self._abs(dst_volume, dst_path, fi.data_dir)
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    if os.path.isdir(dst):
                        shutil.rmtree(dst)
                    # tmp=src: a torn rule tears a shard of the staged
                    # dataDir before it becomes visible
                    self._write_step("pre_data_rename", tmp=src)
                    durable_replace_dir(src, dst)
                    self._write_step("post_data_rename")
                self._write_step("pre_meta_write")
                old_ddirs = meta.add_version(fi)
                self._store_meta(dst_volume, dst_path, meta)
                self._write_step("post_meta_write")
                self._purge_ddirs(dst_volume, dst_path, old_ddirs)
            # the tmp parent dir; already-gone is success (a prior call won)
            shutil.rmtree(self._abs(src_volume, src_path.split("/")[0]),
                          ignore_errors=True)

    def _purge_ddirs(self, volume: str, path: str, ddirs: list[str]):
        """Remove data dirs of replaced versions (overwrite cleanup)."""
        for ddir in ddirs:
            shutil.rmtree(self._abs(volume, path, ddir), ignore_errors=True)

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        with self._op("write_metadata", volume, path):
            with self._meta_lock:
                try:
                    meta = self._load_meta(volume, path)
                except errors.FileNotFound:
                    meta = XLMeta()
                old_ddirs = meta.add_version(fi)
                self._store_meta(volume, path, meta)
                self._purge_ddirs(volume, path, old_ddirs)

    def update_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        with self._op("update_metadata", volume, path):
            with self._meta_lock:
                meta = self._load_meta(volume, path)
                meta.find_version(fi.version_id)  # must exist
                meta.add_version(fi)
                self._store_meta(volume, path, meta)

    def read_version(self, volume: str, path: str, version_id: str = "",
                     read_data: bool = False) -> FileInfo:
        # inline data (fi.data) comes ONLY from xl.meta's Data section, as
        # in the reference (cmd/xl-storage.go:1138): part.N files hold
        # bitrot-framed shard bytes, never object bytes
        with self._op("read_version", volume, path):
            return self._load_meta(volume, path).to_fileinfo(volume, path,
                                                             version_id)

    def list_versions(self, volume: str, path: str) -> list[FileInfo]:
        with self._op("list_versions", volume, path):
            return self._load_meta(volume, path).list_versions(volume, path)

    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        with self._op("delete_version", volume, path):
            with self._meta_lock:
                meta = self._load_meta(volume, path)
                ddir = meta.delete_version(fi)
                if ddir:
                    try:
                        self.delete_path(volume, f"{path}/{ddir}",
                                         recursive=True)
                    except errors.FileNotFound:
                        pass
                self._store_meta(volume, path, meta)

    def _part_geometry(self, fi: FileInfo):
        from ..erasure.bitrot import BITROT_CHUNK_KEY, BitrotAlgorithm
        algo = BitrotAlgorithm(fi.metadata.get(
            "x-minio-internal-bitrot", "blake2b256S"))
        chunk = int(fi.metadata.get(BITROT_CHUNK_KEY,
                                    str(fi.erasure.shard_size())))
        return algo, chunk

    def check_parts(self, volume: str, path: str, fi: FileInfo) -> None:
        """Verify all parts exist with the expected shard file size
        (reference CheckParts)."""
        with self._op("check_parts", volume, path):
            from ..erasure.bitrot import bitrot_shard_file_size
            if fi.data is not None:
                return
            algo, chunk = self._part_geometry(fi)
            for part in fi.parts:
                p = f"{path}/{fi.data_dir}/part.{part.number}"
                want = bitrot_shard_file_size(
                    fi.erasure.shard_file_size(part.size), chunk, algo)
                if self.stat_file_size(volume, p) != want:
                    raise errors.FileCorrupt(p)

    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        """Deep bitrot scan of every part on this disk (reference
        VerifyFile / bitrotVerify), on the host."""
        with self._op("verify_file", volume, path):
            from ..erasure.bitrot import bitrot_logical_size, new_bitrot_reader
            if fi.data is not None:
                return
            algo, chunk = self._part_geometry(fi)
            for part in fi.parts:
                p = f"{path}/{fi.data_dir}/part.{part.number}"
                logical = bitrot_logical_size(self.stat_file_size(volume, p),
                                              chunk, algo)
                if logical != fi.erasure.shard_file_size(part.size):
                    raise errors.FileCorrupt(p)
                src = self.read_file_at(volume, p)
                try:
                    r = new_bitrot_reader(src, algo, logical, chunk)
                    # multi-chunk spans keep the syscall count low
                    span = chunk * max(1, (4 << 20) // chunk)
                    off = 0
                    while off < logical:
                        n = min(span, logical - off)
                        r.read_at(off, n)
                        off += n
                finally:
                    src.close()

    # --- crash recovery -----------------------------------------------------

    def sweep_tmp(self, age_s: float = 0.0) -> int:
        """Reclaim ``.minio.sys/tmp`` entries older than ``age_s``; age 0
        sweeps everything minted by this or any DEAD process. Entries
        pid-prefixed by a different still-LIVE process are always
        skipped."""
        with self._op("sweep_tmp", META_TMP):
            base = self._abs(META_TMP)
            try:
                names = os.listdir(base)
            except OSError:
                return 0
            now = time.time()
            swept = 0
            for name in names:
                p = os.path.join(base, name)
                if _minted_by_live_peer(name):
                    continue
                try:
                    if age_s > 0 and now - os.stat(p).st_mtime < age_s:
                        continue
                    if os.path.isdir(p):
                        shutil.rmtree(p)
                    else:
                        os.unlink(p)
                    swept += 1
                except OSError:
                    continue  # raced with a concurrent commit/clean
            if swept:
                _mx.inc("minio_tpu_durability_recovered_tmp_total", swept)
            return swept

    @staticmethod
    def _subtree_has_meta(p: str) -> bool:
        """True when any descendant carries a version journal (xl.meta, or
        a quarantined one awaiting heal): object namespace, not dataDir
        residue."""
        for _root, _dirs, files in os.walk(p):
            if XL_META_FILE in files or XL_META_CORRUPT_FILE in files:
                return True
        return False

    def reconcile_object(self, volume: str, path: str,
                         age_s: float = 0.0) -> dict:
        """Reconcile one object dir against its version journal: quarantine
        a torn xl.meta (via _load_meta), then remove data dirs no version
        references — the residue of a crash between the dataDir rename and
        the journal commit, or of a failed purge. ``age_s`` guards
        in-flight overwrites (their dataDir lands moments before the
        journal does)."""
        with self._op("reconcile", volume, path):
            out = {"orphan_ddirs": 0, "quarantined": 0, "has_meta": False}
            obj_dir = self._abs(volume, path)
            now = time.time()
            with self._meta_lock:
                referenced = self._reconcile_refs(volume, path, out, age_s, now)
            try:
                names = os.listdir(obj_dir)
            except OSError:
                return out
            # the subtree walks run without the lock: nested namespaces are
            # only skipped here, and phase 3 re-verifies under it
            candidates = []
            for name in names:
                p = os.path.join(obj_dir, name)
                if not os.path.isdir(p) or name in referenced:
                    continue
                if self._subtree_has_meta(p):
                    continue
                try:
                    if age_s > 0 and now - os.stat(p).st_mtime < age_s:
                        continue
                except OSError:
                    continue
                candidates.append(name)
            trash: list[str] = []
            for name in candidates:
                p = os.path.join(obj_dir, name)
                with self._meta_lock:
                    fresh = {"orphan_ddirs": 0, "quarantined": 0,
                             "has_meta": False}
                    refs = self._reconcile_refs(volume, path, fresh, 0.0, now)
                    if name in refs or self._subtree_has_meta(p):
                        continue
                    t = self._abs(META_TMP, new_tmp_id())
                    try:
                        os.replace(p, t)
                    except OSError:
                        continue
                    trash.append(t)
                    out["orphan_ddirs"] += 1
            for t in trash:
                shutil.rmtree(t, ignore_errors=True)
            if out["orphan_ddirs"]:
                _mx.inc("minio_tpu_durability_orphan_ddirs_total",
                        out["orphan_ddirs"])
            if not out["has_meta"]:
                # journal-less slot: fold the dir away so walks stop yielding a
                # phantom object — immediately when empty, after age_s when
                # only the quarantined journal remains
                with self._meta_lock:
                    try:
                        entries = os.listdir(obj_dir)
                        if not entries:
                            self.delete_path(volume, path)
                        elif entries == [XL_META_CORRUPT_FILE] and age_s > 0:
                            cp = os.path.join(obj_dir, XL_META_CORRUPT_FILE)
                            if now - os.stat(cp).st_mtime >= age_s:
                                self.delete_path(volume, path, recursive=True)
                    except (OSError, errors.StorageError):
                        pass
            return out

    def _reconcile_refs(self, volume: str, path: str, out: dict,
                        age_s: float, now: float) -> set:
        """Locked journal snapshot for reconcile_object: referenced ddirs,
        quarantine side effects, and reclamation of a stale
        ``xl.meta.corrupt`` beside a journal heal has since rebuilt."""
        referenced: set = set()
        try:
            meta = self._load_meta(volume, path)
            out["has_meta"] = True
            for d in meta.versions:
                ddir = d.get("V", {}).get("ddir", "")
                if ddir:
                    referenced.add(ddir)
            cp = self._abs(volume, path, XL_META_CORRUPT_FILE)
            try:
                if age_s > 0 and now - os.stat(cp).st_mtime >= age_s:
                    os.unlink(cp)
            except OSError:
                pass
        except errors.FileCorrupt:
            out["quarantined"] = 1  # _load_meta moved it aside
        except errors.FileNotFound:
            pass
        return referenced

    def walk_unjournaled(self, volume: str) -> Iterator[str]:
        """Object dirs holding shard residue but NO xl.meta — the residue
        of a crash between the dataDir rename and the FIRST journal write
        of a brand-new object. A dir qualifies when it carries a
        quarantined journal or any child dir with ``part.N`` files;
        non-qualifying dirs recurse as prefixes. Validates (and consults the
        fault plane) at call time, before the first next()."""
        _fault.inject("disk", self._endpoint, "walk_unjournaled")
        base = self._abs(volume)
        if not os.path.isdir(base):
            raise errors.VolumeNotFound(volume)
        return self._walk_unjournaled_inner(base)

    @staticmethod
    def _walk_unjournaled_inner(base: str) -> Iterator[str]:

        def qualifies(d: str, names: list[str]) -> bool:
            if XL_META_CORRUPT_FILE in names:
                return True
            for n in names:
                sub = os.path.join(d, n)
                if not os.path.isdir(sub):
                    continue
                try:
                    if any(s.startswith("part.") for s in os.listdir(sub)):
                        return True
                except OSError:
                    continue
            return False

        def walk(d: str, rel: str) -> Iterator[str]:
            try:
                names = sorted(os.listdir(d))
            except OSError:
                return
            if XL_META_FILE in names:
                return  # journaled: walk_dir territory
            if rel and qualifies(d, names):
                yield rel
                return
            for n in names:
                sub = os.path.join(d, n)
                if os.path.isdir(sub):
                    yield from walk(sub, f"{rel}/{n}" if rel else n)

        yield from walk(base, "")

    # --- walk ---------------------------------------------------------------

    def walk_dir(self, volume: str, dir_path: str = "",
                 recursive: bool = True) -> Iterator[str]:
        """Sorted object paths (entries owning an xl.meta) under dir_path.
        Validates the volume (and consults the fault plane) at call time,
        before the first next()."""
        _fault.inject("disk", self._endpoint, "walk_dir")
        base = self._abs(volume)
        if not os.path.isdir(base):
            raise errors.VolumeNotFound(volume)
        root = os.path.join(base, dir_path) if dir_path else base
        return self._walk_dir_inner(root, dir_path, recursive)

    @staticmethod
    def _walk_dir_inner(root: str, dir_path: str,
                        recursive: bool) -> Iterator[str]:

        def walk(d: str, rel: str) -> Iterator[str]:
            try:
                names = sorted(os.listdir(d))
            except (FileNotFoundError, NotADirectoryError):
                return
            if XL_META_FILE in names:
                yield rel
                return
            for n in names:
                sub = os.path.join(d, n)
                if os.path.isdir(sub):
                    child = f"{rel}/{n}" if rel else n
                    if recursive:
                        yield from walk(sub, child)
                    elif os.path.isfile(os.path.join(sub, XL_META_FILE)):
                        yield child  # an object, not a prefix
                    else:
                        yield child + "/"

        yield from walk(root, dir_path)

    def walk_versions(self, volume: str, prefix: str = "", marker: str = "",
                      limit: int = -1) -> Iterator[tuple[str, bytes]]:
        """Stream (object_name, raw xl.meta bytes) in S3 lexicographic key
        order, names strictly after ``marker`` and matching ``prefix`` — the
        per-disk sorted metadata stream the metacache merge consumes
        (reference WalkDir, cmd/metacache-walk.go).

        Marker and prefix push down into the directory descent, so a page
        read touches O(page) of the namespace. Sort order treats non-leaf
        directories as ``name + "/"`` (the reference's trailing-slash
        convention). Validates the volume (and consults the fault plane)
        at call time."""
        _fault.inject("disk", self._endpoint, "walk_versions")
        base = self._abs(volume)
        if not os.path.isdir(base):
            raise errors.VolumeNotFound(volume)
        return self._walk_versions_inner(base, prefix, marker, limit)

    @staticmethod
    def _walk_versions_inner(base: str, prefix: str, marker: str,
                             limit: int) -> Iterator[tuple[str, bytes]]:
        high = "\U0010ffff"
        emitted = 0

        def walk(d: str, rel: str) -> Iterator[tuple[str, bytes]]:
            nonlocal emitted
            try:
                names = os.listdir(d)
            except (FileNotFoundError, NotADirectoryError):
                return
            ents = []
            for n in names:
                sub = os.path.join(d, n)
                if not os.path.isdir(sub):
                    continue
                leaf = os.path.isfile(os.path.join(sub, XL_META_FILE))
                ents.append((n if leaf else n + "/", n, leaf, sub))
            for _sort_key, n, leaf, sub in sorted(ents):
                if limit >= 0 and emitted >= limit:
                    return
                child = f"{rel}/{n}" if rel else n
                cmp_key = child if leaf else child + "/"
                # sorted order: once past the prefix range, nothing later
                # can match
                if prefix and cmp_key > prefix and \
                        not cmp_key.startswith(prefix) and \
                        not prefix.startswith(cmp_key):
                    return
                if leaf:
                    if child > marker and child.startswith(prefix):
                        try:
                            with open(os.path.join(sub, XL_META_FILE),
                                      "rb") as f:
                                blob = f.read()
                        except OSError:
                            continue  # raced with delete
                        emitted += 1
                        yield child, blob
                else:
                    cslash = child + "/"
                    if prefix and not (cslash.startswith(prefix)
                                       or prefix.startswith(cslash)):
                        continue
                    # skip subtrees entirely <= marker
                    if marker and marker >= cslash + high:
                        continue
                    yield from walk(sub, child)

        yield from walk(base, "")
