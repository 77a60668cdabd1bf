"""ErasureObjects — the per-set object engine, the port of
objectlayer/erasure_objects.py (reference erasureObjects, cmd/erasure.go:50
+ cmd/erasure-object.go): PutObject/GetObject/Delete/Heal for one erasure
set with the reference's quorum rules, disk shuffling by distribution, and
heal-on-read signalling.

Every GF(256) product and every full-block bitrot digest runs on the
device through erasure/streaming.py and the dispatch queue: the CUDA card
unless the caller passes ``device="cpu"``. A PUT's parity is K2's, its
digests K5's (or K3's under MUR3X256S); a degraded GET and a heal rebuild
with K1 and verify with K5. On the card, both storage classes' codecs are
prepared when the set is built, so K2's nvcc build never lands inside a
PUT or a flush.

PUT, GET and heal each run inside a span (``objectlayer.put_object``,
``objectlayer.get_object``; ``heal.object``, a root of its own when no
request is traced, under the background class) and an armed stage
collector (``obs.attribution.observed``: the standing per-op stage
report); heals pin their rebuilds to the interactive lane, feed the
``heal_shard`` latency window and ``heal_shard_seconds`` (the raw seconds
of the process's last successful shard heals, for percentiles over a whole
heal) and publish a ``heal.shard`` scanner trace.

Every disk rides a health tracker (``storage.health.wrap_disks``: N
consecutive errors or timeouts trip it to a fast-failing DiskNotFound, a
cooldown probe re-onlines it and the set forwards the transition to its
``on_disk_state`` hook); building a set runs the startup crash recovery
(``scanner.janitor.startup_recovery``: all tmp staging swept, aged
multipart uploads expired), so build every set over a directory before
traffic starts on it; PUT, delete and bucket delete mark the scanner's
change tracker, and a bucket delete drops its usage tree. A committed PUT
or multipart object and a delete charge the bucket's live usage delta
(``obs/bucketstats``), which the scanner's reconcile snaps back each
cycle.

What the JAX package's engine also does and the port does not yet: the
QoS lane affinity. The
``on_partial``, ``on_disk_state`` and ``ns_lock`` hooks are plain
attributes, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import io
import logging
import time
import uuid
from collections import deque
from dataclasses import replace

from ..erasure import Erasure, new_bitrot_reader, new_bitrot_writer
from ..erasure.bitrot import (BITROT_CHUNK_KEY, DEFAULT_BITROT_ALGO,
                              BitrotAlgorithm, default_bitrot_algo,
                              native_algo_id, pick_bitrot_chunk)
from ..erasure.streaming import (PreallocSink, erasure_decode,
                                 erasure_encode, erasure_heal)
from .. import qos as _qos
from ..obs import attribution as _attr
from ..obs import bucketstats as _bs
from ..obs import latency as _lat
from ..obs import metrics as _mx
from ..obs import spans as _spans
from ..obs import trace as _trc
from ..scanner import usage as _usage
from ..scanner.janitor import startup_recovery
from ..scanner.tracker import global_tracker
from ..storage.datatypes import ErasureInfo, FileInfo, ObjectPartInfo
from ..storage.health import wrap_disks
from ..storage.xlmeta import XLMeta
from ..storage.xlstorage import META_BUCKET, META_TMP, new_tmp_id
from ..utils import errors
from ..utils.device import resolve_device
from ..utils.hashreader import HashReader, PipelineETag
from . import datatypes as dt
from .datatypes import (DRIVE_STATE_CORRUPT, DRIVE_STATE_MISSING,
                        DRIVE_STATE_OFFLINE, DRIVE_STATE_OK, BucketInfo,
                        DeletedObject, HealResultItem, ListObjectsInfo,
                        ListObjectVersionsInfo, ObjectInfo, ObjectOptions)
from .interface import ObjectLayer
from .metacache import MetacacheStore
from .metadata import (find_file_info_in_quorum, hash_order, meta_pool,
                       object_quorum_from_meta, read_all_fileinfo,
                       shuffle_disks_by_distribution)
from .multipart import MultipartMixin

#: The JAX package's default erasure block (the reference's blockSizeV1 is
#: 10 MiB, cmd/object-api-common.go:32). Recorded per object in xl.meta, so
#: objects written under any block size stay readable.
DEFAULT_BLOCK_SIZE = 4 << 20

#: the seconds of this process's last successful shard heals, raw (the
#: ``heal_shard`` latency window keeps a last-minute histogram only)
heal_shard_seconds: deque = deque(maxlen=1 << 16)

#: The fused-ETag gate's settings, the JAX package's defaults (its
#: ``pipeline`` config: etag, etag_min_bytes): the port has no config
#: registry yet. Bodies below the minimum, multipart parts whose chunk does
#: not divide the shard, and bodies with a Content-MD5 or signed SHA256
#: keep the host MD5.
PIPELINE_ETAG_MODE = "fused"
PIPELINE_ETAG_MIN_BYTES = 1 << 20

log = logging.getLogger(__name__)

BITROT_KEY = "x-minio-internal-bitrot"
ACTUAL_SIZE_KEY = "x-minio-internal-actual-size"


def to_object_err(err: BaseException, bucket: str = "", object: str = ""):
    """Map storage errors to user-visible API errors (reference toObjectErr,
    cmd/object-api-errors.go)."""
    if isinstance(err, dt.ObjectAPIError):
        return err
    if isinstance(err, errors.VolumeNotFound):
        return dt.BucketNotFound(bucket)
    if isinstance(err, errors.VolumeNotEmpty):
        return dt.BucketNotEmpty(bucket)
    if isinstance(err, errors.VolumeExists):
        return dt.BucketExists(bucket)
    if isinstance(err, (errors.FileNotFound, errors.IsNotRegular)):
        return dt.ObjectNotFound(bucket, object)
    if isinstance(err, errors.FileVersionNotFound):
        return dt.VersionNotFound(bucket, object)
    if isinstance(err, errors.ErasureReadQuorum):
        return dt.InsufficientReadQuorum(bucket, object)
    if isinstance(err, errors.ErasureWriteQuorum):
        return dt.InsufficientWriteQuorum(bucket, object)
    if isinstance(err, errors.DiskFull):
        return dt.StorageFull(bucket, object)
    if isinstance(err, errors.LessData):
        return dt.IncompleteBody(bucket, object)
    if isinstance(err, errors.MoreData):
        return dt.IncompleteBody(bucket, object)
    return err


def check_names(bucket: str, object: str = ""):
    if not bucket or bucket.startswith(".") or "/" in bucket:
        raise dt.BucketNameInvalid(bucket)
    if object:
        if object.startswith("/") or ".." in object.split("/") \
                or object.endswith("/"):
            raise dt.ObjectNameInvalid(bucket, object)


class ErasureObjects(MultipartMixin, ObjectLayer):
    """One erasure set over a fixed list of disks (StorageAPI or None)."""

    def __init__(self, disks: list, default_parity: int | None = None,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 bitrot_algo: BitrotAlgorithm | None = None,
                 set_index: int = 0, pool_index: int = 0, device=None):
        # every disk rides a health tracker: N consecutive errors or
        # timeouts trip it to fast-fail DiskNotFound (quorum math then
        # routes around it at once), a cooldown probe re-onlines it
        self._disks = wrap_disks(list(disks))
        for d in self._disks:
            if d is not None and hasattr(d, "state_listeners"):
                # replace, don't accumulate: a set rebuilt over wrapped
                # disks must not leave the old set's listener behind
                d.state_listeners = [
                    fn for fn in d.state_listeners
                    if getattr(fn, "__func__", None)
                    is not ErasureObjects._on_disk_state]
                d.state_listeners.append(self._on_disk_state)
        n = len(disks)
        if n < 2:
            raise ValueError("erasure set needs >= 2 disks")
        self.default_parity = default_parity if default_parity is not None \
            else n // 2
        self.block_size = block_size
        self.bitrot_algo = bitrot_algo if bitrot_algo is not None \
            else default_bitrot_algo()
        self.set_index = set_index
        self.pool_index = pool_index
        #: where the set's GF(256) math and bitrot digests run
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # both storage classes' codecs, so K2 is built (nvcc, once per
            # encode matrix) now and never inside a PUT or a flush
            for parity in {self.default_parity, self._rrs_parity()}:
                Erasure(n - parity, parity, block_size, device=self.device)
        #: MRF hook — called with (bucket, object, version_id) when an op
        #: detects a partial/degraded state (cmd/erasure-object.go:1132).
        self.on_partial = None
        #: called with (disk, "ok"|"faulty") on health-tracker transitions:
        #: the server wires an auto-heal nudge here so a re-onlined disk
        #: gets the objects it missed rebuilt
        self.on_disk_state = None
        #: namespace lock map (dist.dsync.NSLockMap) — None in library use
        self.ns_lock = None
        #: persisted-listing coordinator (reference cmd/metacache.go:42)
        self.metacache = MetacacheStore(self)
        # startup crash recovery: reclaim the tmp staging a previous
        # process stranded and expire aged multipart uploads,
        # O(tmp + multipart); the scanner's janitor owns the namespace-wide
        # reconcile
        try:
            startup_recovery(self)
        except Exception as e:  # noqa: BLE001 — never blocks a boot, but
            # a pass failing on every boot must be visible
            from ..obs.logger import log_sys
            log_sys().log_once(
                f"startup-recovery:{type(e).__name__}", "warning",
                "durability", f"startup recovery failed: {e!r}")

    def _rrs_parity(self) -> int:
        """REDUCED_REDUNDANCY's parity for this set."""
        n = len(self._disks)
        return max(2, self.default_parity // 2) if n >= 4 \
            else self.default_parity

    def storage_info(self) -> dict:
        """Single-set view (reference StorageInfo for one erasure set);
        sets.py/pools.py aggregate their own."""
        online = offline = 0
        for d in self.disks:
            ok = d is not None
            if ok:
                check = getattr(d, "is_online", None)
                if callable(check):
                    try:
                        ok = check()
                    except Exception:  # noqa: BLE001
                        ok = False
            if ok:
                online += 1
            else:
                offline += 1
        return {"disks_online": online, "disks_offline": offline,
                "set_count": 1, "drives_per_set": len(self._disks),
                "parity": self.default_parity}

    def _locked(self, bucket: str, object: str, write: bool = True):
        """Context manager taking the namespace lock if configured
        (reference NSLock; PutObject locks AFTER the data upload —
        cmd/erasure-object.go:722-727 — so callers scope this to the
        commit, not the stream)."""
        @contextlib.contextmanager
        def cm():
            if self.ns_lock is None:
                yield
                return
            mtx = self.ns_lock.new_lock(bucket, object)
            ok = mtx.get_lock(10.0) if write else mtx.get_rlock(10.0)
            if not ok:
                raise dt.InsufficientWriteQuorum(bucket, object) if write \
                    else dt.InsufficientReadQuorum(bucket, object)
            try:
                yield
            finally:
                mtx.unlock()
        return cm()

    # fresh list each call — ErasureSets swaps entries on reconnect
    @property
    def disks(self) -> list:
        return list(self._disks)

    def _on_disk_state(self, disk, state: str):
        """Health-tracker transition fan-in: forwards to the server's hook
        (the auto-heal nudge on re-online)."""
        if self.on_disk_state is not None:
            try:
                self.on_disk_state(disk, state)
            except Exception:  # noqa: BLE001 — hooks are best-effort
                log.exception("on_disk_state hook failed")

    def _signal_read_faults(self, bucket, object, version_id, errs,
                            extra_degraded: bool = False):
        """The one bitrot/degraded-read funnel (every read path that saw
        shard-level trouble routes through here): corrupt
        shards enqueue a DEEP MRF heal (a normal heal's size-only check
        cannot find a corrupt-but-right-sized shard), missing/failed
        shards a normal one."""
        saw_bitrot = any(isinstance(e, errors.FileCorrupt) for e in errs)
        degraded = extra_degraded or saw_bitrot or any(
            isinstance(e, (errors.FileNotFound, errors.FaultyDisk,
                           errors.DiskNotFound))
            for e in errs)
        if degraded:
            self._notify_partial(bucket, object, version_id,
                                 scan_mode="deep" if saw_bitrot
                                 else "normal")
        return degraded

    def _notify_partial(self, bucket, object, version_id="",
                        scan_mode="normal"):
        """scan_mode='deep' when the caller saw bitrot — a normal heal's
        size-only check cannot find a corrupt-but-right-sized shard."""
        if self.on_partial is not None:
            try:
                self.on_partial(bucket, object, version_id,
                                scan_mode=scan_mode)
            except TypeError:
                self.on_partial(bucket, object, version_id)
            except Exception:  # noqa: BLE001 — MRF is best-effort
                pass

    # --- buckets ------------------------------------------------------------

    def make_bucket(self, bucket: str, opts: ObjectOptions = None) -> None:
        check_names(bucket)
        disks = self.disks
        errs: list[BaseException | None] = [None] * len(disks)
        futs = {}
        for i, d in enumerate(disks):
            if d is None:
                errs[i] = errors.DiskNotFound()
                continue
            futs[i] = meta_pool().submit(d.make_vol, bucket)
        for i, f in futs.items():
            try:
                f.result()
            except Exception as e:  # noqa: BLE001
                errs[i] = e
        write_quorum = len(disks) // 2 + 1
        err = errors.reduce_write_quorum_errs(
            errs, errors.BASE_IGNORED_ERRS, write_quorum)
        if err is not None:
            if not isinstance(err, errors.VolumeExists):
                # undo partial creates (reference undoMakeBucket)
                for i, d in enumerate(disks):
                    if d is not None and errs[i] is None:
                        try:
                            d.delete_vol(bucket)
                        except errors.StorageError:
                            pass
            raise to_object_err(err, bucket)

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        check_names(bucket)
        last: BaseException = dt.BucketNotFound(bucket)
        for d in self.disks:
            if d is None:
                continue
            try:
                v = d.stat_vol(bucket)
                return BucketInfo(name=v.name, created=v.created)
            except Exception as e:  # noqa: BLE001
                last = e
        raise to_object_err(last, bucket)

    def list_buckets(self) -> list[BucketInfo]:
        for d in self.disks:
            if d is None:
                continue
            try:
                return [BucketInfo(name=v.name, created=v.created)
                        for v in d.list_vols()]
            except errors.StorageError:
                continue
        raise dt.InsufficientReadQuorum()

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        check_names(bucket)
        disks = self.disks
        errs: list[BaseException | None] = [None] * len(disks)
        futs = {}
        for i, d in enumerate(disks):
            if d is None:
                errs[i] = errors.DiskNotFound()
                continue
            futs[i] = meta_pool().submit(d.delete_vol, bucket, force)
        for i, f in futs.items():
            try:
                f.result()
            except Exception as e:  # noqa: BLE001
                errs[i] = e
        write_quorum = len(disks) // 2 + 1
        err = errors.reduce_write_quorum_errs(
            errs, errors.BASE_IGNORED_ERRS + (errors.VolumeNotFound,),
            write_quorum)
        if err is not None:
            raise to_object_err(err, bucket)
        self.metacache.on_write(bucket)
        # drop stale accounting: a recreated bucket must not serve the
        # deleted namespace's usage tree, nor the scanner's clean-bucket
        # skip reuse its snapshot entry
        _usage.delete_tree(self, bucket)
        global_tracker().mark(bucket, "")

    # --- put ---------------------------------------------------------------

    def put_object(self, bucket: str, object: str, stream, size: int,
                   opts: ObjectOptions = None) -> ObjectInfo:
        with _spans.span("objectlayer.put_object", bucket=bucket,
                         object=object), _attr.observed("put"):
            return self._put_object_inner(bucket, object, stream, size,
                                          opts)

    def _put_object_inner(self, bucket: str, object: str, stream,
                          size: int, opts: ObjectOptions = None
                          ) -> ObjectInfo:
        opts = opts or ObjectOptions()
        check_names(bucket, object)
        self.get_bucket_info(bucket)  # BucketNotFound early

        disks = self.disks
        n = len(disks)
        parity = self.default_parity
        if opts.storage_class == "REDUCED_REDUNDANCY":
            parity = self._rrs_parity()
        data = n - parity
        write_quorum = data + 1 if data == parity else data

        fi = FileInfo(
            volume=bucket, name=object,
            version_id=FileInfo.new_version_id() if opts.versioned else "",
            data_dir=str(uuid.uuid4()),
            mod_time=opts.mod_time or FileInfo.now())
        distribution = hash_order(f"{bucket}/{object}", n)
        er = Erasure(data, parity, self.block_size, device=self.device)
        bitrot_chunk = pick_bitrot_chunk(er.shard_size())

        hr = stream if isinstance(stream, HashReader) else \
            HashReader(stream, size)
        user_defined = dict(opts.user_defined)  # never mutate caller's opts
        etag_known = bool(user_defined.get("etag")) or \
            (opts.etag_source is not None and opts.etag_source is not hr)
        # etag_source IS the ingest reader: its MD5 must keep running
        collector = None if opts.etag_source is hr else \
            self._arm_pipeline_etag(hr, size, etag_known,
                                    chunk=bitrot_chunk,
                                    shard_size=er.shard_size())
        tmp_id = new_tmp_id()
        shuffled = shuffle_disks_by_distribution(disks, distribution)
        writers = []
        for j, d in enumerate(shuffled):
            if d is None:
                writers.append(None)
                continue
            try:
                sink = d.create_file_writer(
                    META_TMP, f"{tmp_id}/{fi.data_dir}/part.1")
                writers.append(new_bitrot_writer(
                    sink, self.bitrot_algo, bitrot_chunk))
            except Exception:  # noqa: BLE001
                writers.append(None)

        try:
            total = erasure_encode(er, hr, writers, write_quorum,
                                   etag=collector)
        except Exception as e:  # noqa: BLE001
            for w in writers:
                if w is not None:
                    w.abort()
            self._cleanup_tmp(tmp_id)
            raise to_object_err(e, bucket, object) from e
        for j, w in enumerate(writers):
            if w is None:
                continue
            try:
                w.close()
            except Exception:  # noqa: BLE001
                writers[j] = None

        if size >= 0 and total != size:
            self._cleanup_tmp(tmp_id)
            raise dt.IncompleteBody(bucket, object)

        etag = user_defined.pop("etag", "")
        if not etag and opts.etag_source is not None:
            etag = opts.etag_source.etag()
        if not etag:
            if collector is not None and collector.blocks == 0 and total:
                # armed but never fed — an eligibility-gate bug, and the
                # MD5 chain was disabled: fail loudly, never serve the
                # constant empty-stream ETag for a non-empty object
                self._cleanup_tmp(tmp_id)
                raise dt.ObjectAPIError(
                    bucket, object, "fused ETag collector starved")
            etag = collector.etag() if collector is not None \
                else hr.etag()
        fi.size = total
        fi.parts = [ObjectPartInfo(number=1, etag=etag, size=total,
                                   actual_size=hr.actual_size
                                   if hr.actual_size >= 0 else total)]
        fi.metadata = {
            "etag": etag,
            "content-type": user_defined.pop(
                "content-type", "application/octet-stream"),
            BITROT_KEY: self.bitrot_algo.value,
            BITROT_CHUNK_KEY: str(bitrot_chunk),
            **user_defined,
        }
        fi.erasure = ErasureInfo(
            data_blocks=data, parity_blocks=parity,
            block_size=self.block_size, distribution=distribution)

        # commit under the namespace lock (lock-after-data-upload):
        # rename_data on every disk whose writer survived
        errs: list[BaseException | None] = [None] * n
        try:
            lock_cm = self._locked(bucket, object)
            lock_cm.__enter__()
        except dt.ObjectAPIError:
            # lock contention after the data upload: reclaim tmp shards
            self._cleanup_tmp(tmp_id)
            raise
        try:
            futs = {}
            for j, d in enumerate(shuffled):
                if d is None or writers[j] is None:
                    errs[j] = errors.DiskNotFound()
                    continue
                fij = replace(fi, erasure=replace(fi.erasure, index=j + 1),
                              metadata=dict(fi.metadata))
                # contextvars do not follow executor submits: the
                # storage span joins the PUT's trace through wrap_ctx
                futs[j] = meta_pool().submit(
                    _spans.wrap_ctx(d.rename_data), META_TMP, tmp_id, fij,
                    bucket, object)
            for j, f in futs.items():
                try:
                    f.result()
                except Exception as e:  # noqa: BLE001
                    errs[j] = e if isinstance(e, errors.StorageError) \
                        else errors.FaultyDisk(str(e))
        finally:
            lock_cm.__exit__(None, None, None)
        err = errors.reduce_write_quorum_errs(
            errs, errors.BASE_IGNORED_ERRS, write_quorum)
        if err is not None:
            # roll back: drop the partially committed version from disks
            # whose rename succeeded and reclaim tmp shards elsewhere
            for j, d in enumerate(shuffled):
                if d is not None and errs[j] is None:
                    try:
                        d.delete_version(bucket, object, fi)
                    except errors.StorageError:
                        pass
            self._cleanup_tmp(tmp_id)
            raise to_object_err(err, bucket, object)
        if any(e is not None for e in errs):
            self._cleanup_tmp(tmp_id)  # reclaim tmp on the failed minority
            self._notify_partial(bucket, object, fi.version_id)
        global_tracker().mark(bucket, object)
        self.metacache.on_write(bucket)
        oi = ObjectInfo.from_file_info(fi, bucket, object, opts.versioned)
        try:  # live usage delta, reconciled each scanner cycle
            _bs.on_put(bucket, fi.size)
        except Exception:  # noqa: BLE001 — obs must never fail a put
            log.warning("usage delta of %s/%s not charged", bucket, object,
                        exc_info=True)
        return oi

    def _arm_pipeline_etag(self, hr: HashReader, size: int,
                           etag_known: bool = False, algo=None,
                           chunk: int = 0, shard_size: int = 0):
        """Fused-pipeline ETag gate: when nothing demands a payload MD5,
        turn OFF the HashReader's payload hashing and hand erasure_encode a
        PipelineETag collector fed from the bitrot digests the encode path
        computes anyway. Returns the armed collector or None (host MD5
        stays the ETag). The port's engine is the device's dispatch queue,
        always present, so the JAX package's no-engine fallback has no
        counterpart here."""

        def fallback(reason: str):
            if etag_known:
                # a supplied/etag-source ETag: the wrapper's MD5 is dead
                # weight either way
                hr.disable_payload_hash()
                return None
            _mx.inc("minio_tpu_pipeline_host_fallback_total", reason=reason)
            _mx.inc("minio_tpu_pipeline_etag_total", mode="md5")
            return None

        if PIPELINE_ETAG_MODE != "fused":
            return fallback("config")
        algo = algo if algo is not None else self.bitrot_algo
        if not algo.streaming or native_algo_id(algo) is None:
            return fallback("algo")
        if chunk and shard_size and shard_size % chunk:
            # framing-ineligible geometry (a stored multipart chunk that
            # doesn't divide this upload's shard): erasure_encode would
            # never feed the collector — keep the MD5 chain instead
            return fallback("unaligned_chunk")
        if size < PIPELINE_ETAG_MIN_BYTES:
            # unknown sizes (-1) fall back too: the small-object MD5 is
            # the compat tax
            return fallback("small_object")
        if etag_known:
            hr.disable_payload_hash()
            return None
        if not hr.disable_payload_hash():
            # client sent Content-MD5 / signed SHA256: the payload MUST be
            # hashed to verify — it doubles as the ETag
            return fallback("content_digest")
        _mx.inc("minio_tpu_pipeline_etag_total", mode="fused")
        return PipelineETag()

    def _cleanup_tmp(self, tmp_id: str):
        for d in self.disks:
            if d is None:
                continue
            try:
                d.delete_path(META_TMP, tmp_id, recursive=True)
            except Exception:  # noqa: BLE001
                pass

    # --- get ---------------------------------------------------------------

    def _read_quorum_fileinfo(self, bucket: str, object: str,
                              version_id: str = "", read_data: bool = False
                              ) -> tuple[FileInfo, list, list]:
        """(quorum FileInfo, fis, errs) — getObjectFileInfo,
        cmd/erasure-object.go:387."""
        disks = self.disks
        # "" = latest; "null" resolves to the unversioned entry inside the
        # journal (XLMeta.find_version) — do NOT collapse it to latest here
        fis, errs = read_all_fileinfo(disks, bucket, object, version_id,
                                      read_data)
        read_quorum, _ = object_quorum_from_meta(
            fis, errs, self.default_parity)
        err = errors.reduce_read_quorum_errs(
            errs, errors.BASE_IGNORED_ERRS, read_quorum)
        if err is not None:
            raise to_object_err(err, bucket, object)
        fi = find_file_info_in_quorum(fis, read_quorum)
        return fi, fis, errs

    def get_object_info(self, bucket: str, object: str,
                        opts: ObjectOptions = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        check_names(bucket, object)
        self.get_bucket_info(bucket)
        try:
            fi, _, _ = self._read_quorum_fileinfo(
                bucket, object, opts.version_id)
        except Exception as e:  # noqa: BLE001
            raise to_object_err(e, bucket, object) from e
        if fi.deleted:
            if not opts.version_id:
                raise dt.ObjectNotFound(bucket, object)
            raise dt.MethodNotAllowed(bucket, object)
        return ObjectInfo.from_file_info(
            fi, bucket, object,
            opts.versioned or bool(opts.version_id) or bool(fi.version_id))

    def get_object(self, bucket: str, object: str, writer, offset: int = 0,
                   length: int = -1, opts: ObjectOptions = None
                   ) -> ObjectInfo:
        with _spans.span("objectlayer.get_object", bucket=bucket,
                         object=object), _attr.observed("get"):
            return self._get_object_inner(bucket, object, writer, offset,
                                          length, opts)

    def _get_object_inner(self, bucket: str, object: str, writer,
                          offset: int = 0, length: int = -1,
                          opts: ObjectOptions = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        check_names(bucket, object)
        self.get_bucket_info(bucket)
        fi, fis, errs = self._read_quorum_fileinfo(
            bucket, object, opts.version_id, read_data=True)
        if fi.deleted:
            if not opts.version_id:
                raise dt.ObjectNotFound(bucket, object)
            raise dt.MethodNotAllowed(bucket, object)
        oi = ObjectInfo.from_file_info(
            fi, bucket, object,
            opts.versioned or bool(opts.version_id) or bool(fi.version_id))
        if length < 0:
            length = fi.size - offset
        if offset < 0 or length < 0 or offset + length > fi.size:
            raise dt.InvalidRange(bucket, object)
        if fi.size == 0 or length == 0:
            return oi
        hint = getattr(writer, "hint_total", None)
        if hint is not None:
            # size-aware sinks (PreallocSink) allocate once up front
            hint(length)

        if fi.data is not None and len(fi.data) == fi.size:
            writer.write(fi.data[offset: offset + length])
            return oi

        disks = self.disks
        er = self._erasure_of(fi)
        algo = BitrotAlgorithm(fi.metadata.get(
            BITROT_KEY, DEFAULT_BITROT_ALGO.value))
        bitrot_chunk = int(fi.metadata.get(BITROT_CHUNK_KEY,
                                           str(er.shard_size())))

        # disks in shard order via each disk's stored erasure index
        per_shard_disk: list = [None] * len(disks)
        for d, dfi in zip(disks, fis):
            if d is None or dfi is None or dfi.deleted:
                continue
            if dfi.data_dir != fi.data_dir or \
                    round(dfi.mod_time, 3) != round(fi.mod_time, 3):
                continue  # outdated disk
            idx = dfi.erasure.index
            if 1 <= idx <= len(disks) and per_shard_disk[idx - 1] is None:
                per_shard_disk[idx - 1] = d

        shard_errs: list = []
        part_start = 0  # start byte of current part within the object
        for part in fi.parts:
            part_end = part_start + part.size
            if part_end <= offset:
                part_start = part_end
                continue
            if part_start >= offset + length:
                break
            part_offset = max(0, offset - part_start)
            part_length = min(part_end, offset + length) \
                - (part_start + part_offset)
            part_start = part_end
            if part_length <= 0:
                continue
            readers = []
            logical = er.shard_file_size(part.size)
            for j in range(len(disks)):
                d = per_shard_disk[j]
                if d is None:
                    readers.append(None)
                    continue
                try:
                    src = d.read_file_at(
                        bucket, f"{object}/{fi.data_dir}/part.{part.number}")
                    readers.append(new_bitrot_reader(
                        src, algo, logical, bitrot_chunk))
                except Exception:  # noqa: BLE001
                    readers.append(None)
            try:
                stats = erasure_decode(er, writer, readers, part_offset,
                                       part_length, part.size)
            except Exception as e:  # noqa: BLE001
                raise to_object_err(e, bucket, object) from e
            finally:
                for r in readers:
                    src = getattr(r, "src", None)
                    if src is not None and hasattr(src, "close"):
                        src.close()
            shard_errs.extend(stats.errs)
        # heal-on-read signal (cmd/erasure-object.go:325-336) through the
        # single bitrot/degraded funnel: corrupt shards -> deep MRF heal
        self._signal_read_faults(
            bucket, object, fi.version_id, shard_errs,
            extra_degraded=any(e is not None for e in errs)
            or any(d is None for d in per_shard_disk[
                :fi.erasure.data_blocks + fi.erasure.parity_blocks]))
        return oi

    def _erasure_of(self, fi: FileInfo) -> Erasure:
        """The codec of a stored version's geometry on this set's
        device."""
        return Erasure(fi.erasure.data_blocks, fi.erasure.parity_blocks,
                       fi.erasure.block_size, device=self.device)

    def get_object_bytes(self, bucket: str, object: str,
                         opts: ObjectOptions = None) -> bytes:
        sink = PreallocSink()
        self.get_object(bucket, object, sink, opts=opts)
        return sink.getvalue()

    def get_object_buffer(self, bucket: str, object: str,
                          opts: ObjectOptions = None) -> memoryview:
        """get_object_bytes without the final full-object copy: the
        PreallocSink's buffer is handed out as a zero-copy memoryview."""
        sink = PreallocSink()
        self.get_object(bucket, object, sink, opts=opts)
        return sink.getbuffer()

    # --- delete ------------------------------------------------------------

    def delete_object(self, bucket: str, object: str,
                      opts: ObjectOptions = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        check_names(bucket, object)
        self.get_bucket_info(bucket)
        global_tracker().mark(bucket, object)
        self.metacache.on_write(bucket)
        disks = self.disks
        write_quorum = len(disks) // 2 + 1

        vid = "" if opts.version_id in ("", "null") else opts.version_id
        mark_delete = opts.versioned and not opts.version_id
        # the size of the doomed version, read BEFORE the quorum delete
        # (the live usage delta cannot read it afterwards); a miss charges
        # 0 and the scanner's reconcile zeroes the drift
        del_size = 0
        if not mark_delete and _bs.enabled():
            try:
                del_size = self.get_object_info(
                    bucket, object, ObjectOptions(version_id=vid)).size or 0
            except Exception:  # noqa: BLE001 — an object already gone
                del_size = 0
        if mark_delete:
            fi = FileInfo(volume=bucket, name=object,
                          version_id=FileInfo.new_version_id(), deleted=True,
                          mod_time=FileInfo.now())
        else:
            fi = FileInfo(volume=bucket, name=object, version_id=vid,
                          mod_time=FileInfo.now())

        errs: list[BaseException | None] = [None] * len(disks)
        with self._locked(bucket, object):
            futs = {}
            for i, d in enumerate(disks):
                if d is None:
                    errs[i] = errors.DiskNotFound()
                    continue
                futs[i] = meta_pool().submit(d.delete_version, bucket,
                                             object, fi)
            for i, f in futs.items():
                try:
                    f.result()
                except errors.FileNotFound:
                    pass  # S3 delete is idempotent: missing object = success
                except Exception as e:  # noqa: BLE001
                    errs[i] = e if isinstance(e, errors.StorageError) \
                        else errors.FaultyDisk(str(e))
        if vid and sum(isinstance(e, errors.FileVersionNotFound)
                       for e in errs) > len(disks) - write_quorum:
            raise dt.VersionNotFound(bucket, object)
        err = errors.reduce_write_quorum_errs(
            errs, errors.BASE_IGNORED_ERRS + (errors.FileVersionNotFound,),
            write_quorum)
        if err is not None:
            raise to_object_err(err, bucket, object)
        if any(isinstance(e, (errors.DiskNotFound, errors.FaultyDisk))
               for e in errs):
            self._notify_partial(bucket, object, fi.version_id)
        # second bump AFTER the mutation landed: a cache build that
        # started between the pre-bump and the quorum delete would have
        # captured the old namespace under the new sequence
        self.metacache.on_write(bucket)
        try:  # live usage delta: a delete marker adds a version row
            if mark_delete:
                _bs.on_put(bucket, 0, versions=1, objects=0)
            else:
                _bs.on_delete(bucket, del_size)
        except Exception:  # noqa: BLE001 — obs must never fail a delete
            log.warning("usage delta of %s/%s not charged", bucket, object,
                        exc_info=True)
        return ObjectInfo(bucket=bucket, name=object,
                          version_id=fi.version_id if opts.versioned else "",
                          delete_marker=fi.deleted, mod_time=fi.mod_time)

    def delete_objects(self, bucket: str, objects: list, opts=None
                       ) -> tuple[list[DeletedObject], list]:
        """Bulk delete (reference DeleteObjects vectorizes into per-disk
        DeleteVersions RPC — cmd/erasure-object.go:877)."""
        opts = opts or ObjectOptions()
        deleted: list[DeletedObject] = []
        errs: list = []
        for obj in objects:
            name = obj if isinstance(obj, str) else obj["object"]
            vid = "" if isinstance(obj, str) else obj.get("version_id", "")
            try:
                o = ObjectOptions(version_id=vid, versioned=opts.versioned)
                oi = self.delete_object(bucket, name, o)
                deleted.append(DeletedObject(
                    object_name=name, version_id=vid,
                    delete_marker=oi.delete_marker,
                    delete_marker_version_id=oi.version_id
                    if oi.delete_marker else ""))
                errs.append(None)
            except dt.ObjectNotFound:
                deleted.append(DeletedObject(object_name=name, version_id=vid))
                errs.append(None)
            except Exception as e:  # noqa: BLE001
                # keep the key so DeleteResult <Error> can name it
                deleted.append(DeletedObject(object_name=name,
                                             version_id=vid))
                errs.append(e)
        return deleted, errs

    # --- list --------------------------------------------------------------

    def _iter_resolved(self, bucket: str, prefix: str = "",
                       marker: str = "", build: bool = True):
        """Stream (name, XLMeta) pairs through the metacache store:
        served from persisted listing blocks when a usable cache exists
        (this node's or a peer's), walking + building the cache
        otherwise — O(page) metadata touched per page consumed either
        way."""
        for name, raw, meta in self.metacache.iter_entries(bucket, prefix,
                                                           marker, build):
            if meta is None:  # block-served: parse the stored journal
                try:
                    meta = XLMeta.load(raw)
                except errors.FileCorrupt:
                    continue
            if not meta.versions:
                continue
            yield name, meta

    def iter_objects(self, bucket: str, prefix: str = ""):
        """Streaming iterator of latest-version ObjectInfo for background
        services (scanner, global heal): one pass, no paging restarts,
        delete markers skipped."""
        for name, meta in self._iter_resolved(bucket, prefix):
            try:
                fi = meta.to_fileinfo(bucket, name)
            except errors.StorageError:
                continue
            if fi.deleted:
                continue
            yield ObjectInfo.from_file_info(fi, bucket, name,
                                            bool(fi.version_id))

    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000
                     ) -> ListObjectsInfo:
        check_names(bucket)
        self.get_bucket_info(bucket)
        out = ListObjectsInfo()
        seen_prefixes: set[str] = set()
        count = 0
        last_emitted = ""  # S3 marker semantics: the LAST key returned
        # past-subtree sentinel: restarting the walk at cp+HIGH skips every
        # key under a collapsed common prefix without reading its metadata
        # (the reference forwards the metacache stream the same way) — a
        # delimiter page stays O(page), not O(largest subtree)
        high = "\U0010ffff"
        walk_from = marker
        try:
            done = False
            while not done:
                done = True
                for name, meta in self._iter_resolved(
                        bucket, prefix, walk_from,
                        build=not delimiter):
                    if delimiter:
                        rest = name[len(prefix):]
                        if delimiter in rest:
                            cp = prefix + rest.split(delimiter)[0] + delimiter
                            if cp not in seen_prefixes and \
                                    not (marker and cp <= marker):
                                if count >= max_keys:
                                    out.is_truncated = True
                                    out.next_marker = last_emitted
                                    return out
                                seen_prefixes.add(cp)
                                out.prefixes.append(cp)
                                last_emitted = cp
                                count += 1
                            walk_from = cp + high
                            done = False
                            break  # restart the merge past this subtree
                    try:
                        fi = meta.to_fileinfo(bucket, name)
                    except errors.StorageError:
                        continue
                    if fi.deleted:
                        continue  # latest is a delete marker
                    if count >= max_keys:
                        out.is_truncated = True
                        out.next_marker = last_emitted
                        return out
                    out.objects.append(ObjectInfo.from_file_info(
                        fi, bucket, name, bool(fi.version_id)))
                    last_emitted = name
                    count += 1
        except errors.VolumeNotFound:
            raise dt.BucketNotFound(bucket) from None
        return out

    def list_object_versions(self, bucket: str, prefix: str = "",
                             marker: str = "", version_marker: str = "",
                             delimiter: str = "", max_keys: int = 1000
                             ) -> ListObjectVersionsInfo:
        check_names(bucket)
        self.get_bucket_info(bucket)
        out = ListObjectVersionsInfo()
        count = 0
        seen_prefixes: set[str] = set()
        # resume at the marker key itself when a version_marker continues
        # inside it (walk markers are exclusive, so back off by one key)
        walk_marker = ""
        if marker:
            walk_marker = marker[:-1] if version_marker else marker
        for name, meta in self._iter_resolved(bucket, prefix, walk_marker,
                                              build=not delimiter):
            if marker and name < marker:
                continue
            if marker and name == marker and not version_marker:
                continue  # key fully listed on a previous page
            if delimiter:
                rest = name[len(prefix):]
                if delimiter in rest:
                    cp = prefix + rest.split(delimiter)[0] + delimiter
                    if cp not in seen_prefixes:
                        seen_prefixes.add(cp)
                        out.prefixes.append(cp)
                    continue
            vers = meta.list_versions(bucket, name)
            # resume inside the marker key: versions are mod_time-ordered,
            # so skip until the marker version id is passed (identity match,
            # not lexicographic — uuids don't sort by recency)
            skipping = bool(version_marker) and name == marker
            for fi in vers:
                if skipping:
                    # output rewrites "" to "null", so compare normalized
                    if (fi.version_id or "null") == version_marker:
                        skipping = False
                    continue
                if count >= max_keys:
                    # markers = LAST EMITTED (key, version) so the resume
                    # skip-loop always finds its anchor
                    out.is_truncated = True
                    if out.objects:
                        out.next_key_marker = out.objects[-1].name
                        out.next_version_id_marker = \
                            out.objects[-1].version_id
                    return out
                oi = ObjectInfo.from_file_info(fi, bucket, name, True)
                if not oi.version_id:
                    oi.version_id = "null"
                out.objects.append(oi)
                count += 1
        return out

    # --- copy --------------------------------------------------------------

    def copy_object(self, src_bucket, src_object, dst_bucket, dst_object,
                    src_info, src_opts, dst_opts):
        """Server-side copy: metadata-only for same-object self-copy, else
        full read→write through the erasure pipeline."""
        if src_bucket == dst_bucket and src_object == dst_object:
            new_user = dict(dst_opts.user_defined) if dst_opts else {}
            replace_dir = dst_opts is not None and dst_opts.metadata_replace

            def mutate(fi, old):
                if replace_dir:
                    # x-amz-metadata-directive: REPLACE — keep only system
                    # keys, then apply exactly the client-supplied map (S3
                    # semantics; reference CopyObjectHandler).
                    meta = {k: v for k, v in old.items()
                            if k == "etag"
                            or k.startswith("x-minio-internal-")}
                    if "content-type" not in new_user \
                            and "content-type" in old:
                        meta["content-type"] = old["content-type"]
                else:
                    meta = old
                meta.update(new_user)
                fi.mod_time = FileInfo.now()  # Last-Modified must advance
                return meta

            fi = self._rewrite_metadata(
                src_bucket, src_object,
                src_opts.version_id if src_opts else "", mutate)
            return ObjectInfo.from_file_info(
                fi, dst_bucket, dst_object, bool(fi.version_id))
        data = self.get_object_buffer(src_bucket, src_object, src_opts)
        return self.put_object(dst_bucket, dst_object, io.BytesIO(data),
                               len(data), dst_opts)

    # --- object tags --------------------------------------------------------

    TAGS_KEY = "x-minio-internal-tags"

    def _rewrite_metadata(self, bucket: str, object: str, version_id: str,
                          mutate) -> "FileInfo":
        """In-place xl.meta rewrite discipline shared by tags/self-copy:
        read the quorum FileInfo UNDER the object lock (a read before the
        lock races a concurrent overwrite and would resurrect a purged
        data_dir), apply `mutate(fi, meta) -> new_meta`, then write each
        disk its OWN FileInfo back (own erasure.index, mirroring the
        reference writing each disk's metaArr[i]); writing the quorum pick
        to every disk would make all disks claim the same shard index and
        permanently break read quorum."""
        with self._locked(bucket, object):
            fi, fis, _ = self._read_quorum_fileinfo(bucket, object,
                                                    version_id)
            if fi.deleted:
                raise dt.MethodNotAllowed(bucket, object)
            meta = mutate(fi, dict(fi.metadata))
            fi.metadata = meta
            for d, dfi in zip(self.disks, fis):
                if d is None or dfi is None:
                    continue
                fid = replace(fi, erasure=dfi.erasure, metadata=dict(meta))
                try:
                    d.update_metadata(bucket, object, fid)
                except errors.StorageError:
                    pass
        # after the journals landed: listings must not serve a cache
        # built against the pre-rewrite metadata
        self.metacache.on_write(bucket)
        return fi

    def update_object_meta(self, bucket: str, object: str, updates: dict,
                           opts: ObjectOptions = None) -> None:
        """Merge metadata keys into a version's xl.meta in place (None
        values delete keys) — object-lock retention/legal-hold writes ride
        this (reference updates xl.meta the same way)."""
        opts = opts or ObjectOptions()

        def mutate(fi, meta):
            for k, v in updates.items():
                if v is None:
                    meta.pop(k, None)
                else:
                    meta[k] = v
            return meta

        self._rewrite_metadata(bucket, object, opts.version_id, mutate)

    def put_object_tags(self, bucket: str, object: str, tags_enc: str,
                        opts: ObjectOptions = None) -> None:
        """Set (or clear, with "") the object's encoded tag set by updating
        xl.meta in place on every disk (reference PutObjectTags)."""
        opts = opts or ObjectOptions()

        def mutate(fi, meta):
            if tags_enc:
                meta[self.TAGS_KEY] = tags_enc
            else:
                meta.pop(self.TAGS_KEY, None)
            return meta

        self._rewrite_metadata(bucket, object, opts.version_id, mutate)

    def get_object_tags(self, bucket: str, object: str,
                        opts: ObjectOptions = None) -> str:
        opts = opts or ObjectOptions()
        fi, _, _ = self._read_quorum_fileinfo(bucket, object,
                                              opts.version_id)
        if fi.deleted:
            raise dt.MethodNotAllowed(bucket, object)
        return fi.metadata.get(self.TAGS_KEY, "")

    # --- internal config blobs (quorum read/write under .minio.sys) --------

    def put_config(self, path: str, data: bytes) -> None:
        disks = self.disks
        errs: list[BaseException | None] = [None] * len(disks)
        for i, d in enumerate(disks):
            if d is None:
                errs[i] = errors.DiskNotFound()
                continue
            try:
                d.write_all(META_BUCKET, f"config/{path}", data)
            except Exception as e:  # noqa: BLE001
                errs[i] = e
        err = errors.reduce_write_quorum_errs(
            errs, errors.BASE_IGNORED_ERRS, len(disks) // 2 + 1)
        if err is not None:
            raise to_object_err(err)

    def get_config(self, path: str) -> bytes:
        """Majority read: a partially failed put_config must not resurface
        the superseded blob from the disk it skipped (reference readConfig
        reads through the quorum path)."""
        counts: dict[bytes, int] = {}
        last: BaseException = errors.FileNotFound(path)
        for d in self.disks:
            if d is None:
                continue
            try:
                blob = d.read_all(META_BUCKET, f"config/{path}")
                counts[blob] = counts.get(blob, 0) + 1
            except Exception as e:  # noqa: BLE001
                last = e
        if not counts:
            raise last
        return max(counts, key=counts.get)

    def delete_config(self, path: str) -> None:
        for d in self.disks:
            if d is None:
                continue
            try:
                d.delete_path(META_BUCKET, f"config/{path}")
            except errors.StorageError:
                pass

    def list_config(self, prefix: str) -> list[str]:
        names: set[str] = set()
        for d in self.disks:
            if d is None:
                continue
            try:
                base = f"config/{prefix}".rstrip("/")
                for entry in d.list_dir(META_BUCKET, base):
                    names.add(entry)
            except errors.StorageError:
                continue
        return sorted(names)

    # --- heal --------------------------------------------------------------

    def heal_bucket(self, bucket: str, dry_run: bool = False
                    ) -> HealResultItem:
        disks = self.disks
        res = HealResultItem(heal_item_type="bucket", bucket=bucket,
                             disk_count=len(disks))
        for d in disks:
            if d is None:
                res.before_state.append(DRIVE_STATE_OFFLINE)
                res.after_state.append(DRIVE_STATE_OFFLINE)
                continue
            try:
                d.stat_vol(bucket)
                res.before_state.append(DRIVE_STATE_OK)
                res.after_state.append(DRIVE_STATE_OK)
            except errors.StorageError:
                res.before_state.append(DRIVE_STATE_MISSING)
                if dry_run:
                    res.after_state.append(DRIVE_STATE_MISSING)
                else:
                    try:
                        d.make_vol(bucket)
                        res.after_state.append(DRIVE_STATE_OK)
                    except errors.StorageError:
                        res.after_state.append(DRIVE_STATE_MISSING)
        return res

    def heal_object(self, bucket: str, object: str, version_id: str = "",
                    dry_run: bool = False, remove_dangling: bool = False,
                    scan_mode: str = "normal") -> HealResultItem:
        """Heal one object version (reference healObject,
        cmd/erasure-healing.go:233): classify per-disk state, rebuild missing
        /corrupt shards via decode→encode, rewrite xl.meta on healed disks.
        The rebuilds ride the dispatch queue's interactive lane (its
        default for the rebuild ops), so heals of many objects coalesce
        into batched launches. A heal outside a traced request opens its
        own root trace, tail-sampled against the background budget."""
        try:
            with _spans.maybe_root("heal.object", cls="background",
                                   bucket=bucket, object=object,
                                   mode=scan_mode), \
                    _attr.observed("heal"), \
                    _qos.device_stream(_qos.STREAM_INTERACTIVE):
                return self._heal_object_inner(bucket, object, version_id,
                                               dry_run, remove_dangling,
                                               scan_mode)
        finally:
            if not dry_run:
                # healed journals change quorum resolution; listings must
                # not serve a cache built before (or during) the repair
                self.metacache.on_write(bucket)

    def _heal_object_inner(self, bucket: str, object: str,
                           version_id: str = "", dry_run: bool = False,
                           remove_dangling: bool = False,
                           scan_mode: str = "normal") -> HealResultItem:
        disks = self.disks
        n = len(disks)
        vid = "" if version_id in ("", "null") else version_id
        fis, errs = read_all_fileinfo(disks, bucket, object, vid)
        read_quorum, _ = object_quorum_from_meta(fis, errs,
                                                 self.default_parity)

        avail = sum(1 for fi in fis if fi is not None)
        if avail < read_quorum:
            not_found = sum(1 for e in errs if isinstance(
                e, (errors.FileNotFound, errors.FileVersionNotFound)))
            if not_found > n - read_quorum and remove_dangling:
                # dangling VERSION: remove just that journal entry on each
                # disk (delete_version drops the object dir only when it was
                # the last version) — healthy sibling versions survive
                # (reference :328)
                purge_vid = "null" if version_id in ("", "null") else version_id
                pfi = FileInfo(volume=bucket, name=object,
                               version_id="" if purge_vid == "null"
                               else purge_vid)
                for d in disks:
                    if d is None:
                        continue
                    try:
                        d.delete_version(bucket, object, pfi)
                    except errors.StorageError:
                        pass
                return HealResultItem(bucket=bucket, object=object,
                                      version_id=version_id, disk_count=n)
            raise to_object_err(errors.ErasureReadQuorum(), bucket, object)

        fi = find_file_info_in_quorum(fis, read_quorum)
        res = HealResultItem(
            bucket=bucket, object=object, version_id=fi.version_id,
            disk_count=n, data_blocks=fi.erasure.data_blocks,
            parity_blocks=fi.erasure.parity_blocks, object_size=fi.size)

        if fi.deleted:
            # propagate the delete marker to disks missing it
            res.before_state = [
                DRIVE_STATE_OFFLINE if d is None else
                (DRIVE_STATE_OK if f is not None and f.deleted
                 else DRIVE_STATE_MISSING)
                for d, f in zip(disks, fis)]
            if not dry_run:
                for d, f in zip(disks, fis):
                    if d is not None and (f is None or not f.deleted):
                        try:
                            d.write_metadata(bucket, object, fi)
                        except errors.StorageError:
                            pass
            res.after_state = [DRIVE_STATE_OFFLINE if d is None
                               else DRIVE_STATE_OK for d in disks]
            return res

        # classify each disk (cmd/erasure-healing.go:261-331)
        latest_mod = round(fi.mod_time, 3)
        state: list[str] = []
        for i, (d, f) in enumerate(zip(disks, fis)):
            if d is None:
                state.append(DRIVE_STATE_OFFLINE)
            elif f is None:
                # FileCorrupt = a torn/quarantined journal (the read
                # already moved it to xl.meta.corrupt): rebuildable from
                # quorum exactly like MISSING, not a disk outage
                state.append(DRIVE_STATE_MISSING if isinstance(
                    errs[i], (errors.FileNotFound,
                              errors.FileVersionNotFound,
                              errors.FileCorrupt))
                    else DRIVE_STATE_OFFLINE)
            elif round(f.mod_time, 3) != latest_mod or \
                    f.data_dir != fi.data_dir:
                state.append(DRIVE_STATE_MISSING)  # outdated version
            else:
                try:
                    if scan_mode == "deep":
                        d.verify_file(bucket, object, f)
                    else:
                        d.check_parts(bucket, object, f)
                    state.append(DRIVE_STATE_OK)
                except errors.StorageError:
                    state.append(DRIVE_STATE_CORRUPT)
        res.before_state = list(state)

        to_heal = [i for i, s in enumerate(state)
                   if s in (DRIVE_STATE_MISSING, DRIVE_STATE_CORRUPT)
                   and disks[i] is not None]
        if not to_heal or dry_run:
            res.after_state = list(state)
            return res

        if fi.data is not None:
            # inlined object: just rewrite xl.meta on broken disks
            for i in to_heal:
                fih = replace(fi, metadata=dict(fi.metadata))
                try:
                    disks[i].write_metadata(bucket, object, fih)
                    state[i] = DRIVE_STATE_OK
                except errors.StorageError:
                    pass
            res.after_state = state
            return res

        er = self._erasure_of(fi)
        algo = BitrotAlgorithm(fi.metadata.get(
            BITROT_KEY, DEFAULT_BITROT_ALGO.value))
        bitrot_chunk = int(fi.metadata.get(BITROT_CHUNK_KEY,
                                           str(er.shard_size())))

        # shard-ordered source disks (state OK only) and their FileInfos
        shard_disk: list = [None] * n
        for i, (d, f) in enumerate(zip(disks, fis)):
            if state[i] != DRIVE_STATE_OK or f is None:
                continue
            idx = f.erasure.index
            if 1 <= idx <= n and shard_disk[idx - 1] is None:
                shard_disk[idx - 1] = d
        # target shard index per healed disk: reuse the quorum distribution
        dist = fi.erasure.distribution or hash_order(f"{bucket}/{object}", n)
        tmp_id = new_tmp_id()
        src_errs: list = []
        # targets whose shard write/close failed for ANY part: their tmp
        # data is incomplete or not durably written — committing it via
        # rename_data would heal in bad shards
        failed_targets: set = set()
        for part in fi.parts:
            logical = er.shard_file_size(part.size)
            readers = []
            for j in range(n):
                d = shard_disk[j]
                if d is None:
                    readers.append(None)
                    continue
                try:
                    src = d.read_file_at(
                        bucket, f"{object}/{fi.data_dir}/part.{part.number}")
                    readers.append(new_bitrot_reader(
                        src, algo, logical, bitrot_chunk))
                except Exception:  # noqa: BLE001
                    readers.append(None)
            writers = [None] * n
            for i in to_heal:
                shard_idx = dist[i]
                try:
                    sink = disks[i].create_file_writer(
                        META_TMP,
                        f"{tmp_id}/{fi.data_dir}/part.{part.number}")
                    writers[shard_idx - 1] = new_bitrot_writer(
                        sink, algo, bitrot_chunk)
                except Exception:  # noqa: BLE001
                    pass
            t0 = time.perf_counter()
            heal_err = ""
            try:
                src_errs.extend(
                    erasure_heal(er, writers, readers, part.size))
                # a None slot here means the target failed THIS part —
                # writer creation raised above, or erasure_heal nulled
                # it on a write/close error — so the disk's tmp dataDir
                # is incomplete and must not commit
                failed_targets.update(
                    i for i in to_heal if writers[dist[i] - 1] is None)
            except Exception as e:  # noqa: BLE001
                heal_err = str(e)
                raise to_object_err(e, bucket, object) from e
            finally:
                dur = time.perf_counter() - t0
                shard_bytes = logical * len(to_heal)
                if not heal_err:
                    # only successful rebuilds move the heal-shard window:
                    # fast failures must not read as heal throughput
                    heal_shard_seconds.append(dur)
                    ctx = _spans.current()
                    _lat.observe("kernel", dur, shard_bytes,
                                 op="heal_shard",
                                 trace_id=ctx.trace_id
                                 if ctx is not None and ctx.sampled else "")
                _trc.publish_scanner(
                    func="heal.shard", path=f"{bucket}/{object}",
                    duration_s=dur, input_bytes=shard_bytes,
                    error=heal_err)
                for r in readers:
                    src = getattr(r, "src", None)
                    if src is not None and hasattr(src, "close"):
                        src.close()
        for i in to_heal:
            if i in failed_targets:
                continue  # incomplete/non-durable tmp shards stay tmp
            shard_idx = dist[i]
            fih = replace(fi, erasure=replace(fi.erasure, index=shard_idx),
                          metadata=dict(fi.metadata))
            try:
                disks[i].rename_data(META_TMP, tmp_id, fih, bucket, object)
                state[i] = DRIVE_STATE_OK
            except Exception:  # noqa: BLE001
                pass
        if scan_mode != "deep" and any(
                isinstance(e, errors.FileCorrupt) for e in src_errs):
            # a SOURCE shard turned out bitrot-corrupt mid-heal: this
            # normal-mode pass did not target it (size-only check), so
            # re-enqueue the object for a deep heal via the shared funnel
            self._signal_read_faults(bucket, object, fi.version_id,
                                     src_errs)
        res.after_state = state
        return res
