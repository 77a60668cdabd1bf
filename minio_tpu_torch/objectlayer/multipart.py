"""Multipart upload engine, the port of objectlayer/multipart.py
(reference cmd/erasure-multipart.go): uploads
live under ``.minio.sys/multipart/<SHA256(bucket/object)>/<uploadID>`` with
their own xl.meta carrying the erasure geometry decided at initiation
(SURVEY.md §3.7); each part runs the same Erasure.Encode to ``part.N``;
complete validates ETags/sizes, renumbers parts, and commits via
rename_data like a regular put."""
from __future__ import annotations

import hashlib
import uuid
from dataclasses import replace

from ..erasure import Erasure, new_bitrot_writer
from ..erasure.codec import ceil_div
from ..erasure.streaming import erasure_encode
from ..obs import bucketstats as _bs
from ..scanner.tracker import global_tracker
from ..storage.datatypes import ErasureInfo, FileInfo, ObjectPartInfo
from ..storage.xlstorage import META_MULTIPART, META_TMP, new_tmp_id
from ..utils import errors, msgpack
from ..utils.hashreader import HashReader, etag_from_parts
from . import datatypes as dt
from .datatypes import (ListMultipartsInfo, ListPartsInfo, MultipartInfo,
                        ObjectInfo, ObjectOptions, PartInfo)
from .metadata import hash_order, meta_pool, read_all_fileinfo, \
    find_file_info_in_quorum, object_quorum_from_meta, \
    shuffle_disks_by_distribution

MIN_PART_SIZE = 5 << 20  # S3 minimum non-terminal part size
MAX_PARTS = 10_000


def upload_path(bucket: str, object: str, upload_id: str = "") -> str:
    h = hashlib.sha256(f"{bucket}/{object}".encode()).hexdigest()
    return f"{h}/{upload_id}" if upload_id else h


class MultipartMixin:
    """Multipart methods for ErasureObjects (mixed into the class; relies on
    self.disks / self.default_parity / self.block_size / self.bitrot_algo /
    self.device / self._read_quorum helpers)."""

    # --- initiate -----------------------------------------------------------

    def new_multipart_upload(self, bucket: str, object: str,
                             opts: ObjectOptions = None) -> str:
        from ..erasure.bitrot import BITROT_CHUNK_KEY, pick_bitrot_chunk
        from .erasure_objects import BITROT_KEY, check_names
        opts = opts or ObjectOptions()
        check_names(bucket, object)
        self.get_bucket_info(bucket)
        disks = self.disks
        n = len(disks)
        parity = self.default_parity
        if opts.storage_class == "REDUCED_REDUNDANCY":
            parity = self._rrs_parity()
        data = n - parity
        upload_id = str(uuid.uuid4())
        upath = upload_path(bucket, object, upload_id)
        fi = FileInfo(
            volume=bucket, name=object, data_dir=str(uuid.uuid4()),
            mod_time=FileInfo.now(),
            metadata={
                "x-minio-internal-object": f"{bucket}/{object}",
                BITROT_KEY: self.bitrot_algo.value,
                BITROT_CHUNK_KEY: str(pick_bitrot_chunk(
                    ceil_div(self.block_size, data))),
                "content-type": opts.user_defined.get(
                    "content-type", "application/octet-stream"),
                **{k: v for k, v in opts.user_defined.items()
                   if k != "content-type"},
            },
            erasure=ErasureInfo(
                data_blocks=data, parity_blocks=parity,
                block_size=self.block_size,
                distribution=hash_order(f"{bucket}/{object}", n)))
        write_quorum = fi.write_quorum(parity)
        errs = [None] * n
        futs = {}
        for i, d in enumerate(disks):
            if d is None:
                errs[i] = errors.DiskNotFound()
                continue
            fij = replace(fi, erasure=replace(
                fi.erasure, index=fi.erasure.distribution[i]),
                metadata=dict(fi.metadata))
            futs[i] = meta_pool().submit(d.write_metadata, META_MULTIPART,
                                         upath, fij)
        for i, f in futs.items():
            try:
                f.result()
            except Exception as e:  # noqa: BLE001
                errs[i] = e
        err = errors.reduce_write_quorum_errs(
            errs, errors.BASE_IGNORED_ERRS, write_quorum)
        if err is not None:
            from .erasure_objects import to_object_err
            raise to_object_err(err, bucket, object)
        return upload_id

    # --- helpers ------------------------------------------------------------

    def _upload_meta(self, bucket: str, object: str, upload_id: str
                     ) -> tuple[FileInfo, list, list]:
        upath = upload_path(bucket, object, upload_id)
        disks = self.disks
        fis, errs = read_all_fileinfo(disks, META_MULTIPART, upath)
        read_quorum, _ = object_quorum_from_meta(fis, errs,
                                                 self.default_parity)
        err = errors.reduce_read_quorum_errs(
            errs, errors.BASE_IGNORED_ERRS, read_quorum)
        if err is not None:
            raise dt.NoSuchUpload(bucket, object, upload_id)
        try:
            fi = find_file_info_in_quorum(fis, read_quorum)
        except errors.StorageError:
            raise dt.NoSuchUpload(bucket, object, upload_id) from None
        return fi, fis, errs

    # --- put part -----------------------------------------------------------

    def put_object_part(self, bucket: str, object: str, upload_id: str,
                        part_id: int, stream, size: int,
                        opts: ObjectOptions = None) -> PartInfo:
        from .erasure_objects import to_object_err
        if not 1 <= part_id <= MAX_PARTS:
            raise dt.InvalidPart(bucket, object, str(part_id))
        fi, fis, _ = self._upload_meta(bucket, object, upload_id)
        upath = upload_path(bucket, object, upload_id)
        disks = self.disks
        data, parity = fi.erasure.data_blocks, fi.erasure.parity_blocks
        write_quorum = fi.write_quorum(parity)
        er = Erasure(data, parity, fi.erasure.block_size,
                     device=self.device)
        from ..erasure.bitrot import BITROT_CHUNK_KEY, BitrotAlgorithm
        from .erasure_objects import BITROT_KEY
        algo = BitrotAlgorithm(fi.metadata[BITROT_KEY])
        bitrot_chunk = int(fi.metadata.get(BITROT_CHUNK_KEY,
                                           str(er.shard_size())))

        hr = stream if isinstance(stream, HashReader) else \
            HashReader(stream, size)
        # parts ride the fused-ETag pipeline exactly like single PUTs
        # (etag_from_parts folds the per-part hexes, so the final
        # multipart ETag composes either way); the stored bitrot chunk
        # is validated against THIS upload's shard geometry — a foreign
        # chunk that doesn't divide the shard keeps the MD5 chain
        collector = self._arm_pipeline_etag(hr, size, algo=algo,
                                            chunk=bitrot_chunk,
                                            shard_size=er.shard_size())
        tmp_id = new_tmp_id()
        shuffled = shuffle_disks_by_distribution(
            disks, fi.erasure.distribution)
        writers = []
        for j, d in enumerate(shuffled):
            if d is None:
                writers.append(None)
                continue
            try:
                sink = d.create_file_writer(META_TMP,
                                            f"{tmp_id}/part.{part_id}")
                writers.append(new_bitrot_writer(sink, algo, bitrot_chunk))
            except Exception:  # noqa: BLE001
                writers.append(None)
        try:
            total = erasure_encode(er, hr, writers, write_quorum,
                                   etag=collector)
        except Exception as e:  # noqa: BLE001
            for w in writers:
                if w is not None:
                    w.abort()
            raise to_object_err(e, bucket, object) from e
        for j, w in enumerate(writers):
            if w is not None:
                try:
                    w.close()
                except Exception:  # noqa: BLE001
                    writers[j] = None
        if size >= 0 and total != size:
            raise dt.IncompleteBody(bucket, object)

        if collector is not None and collector.blocks == 0 and total:
            # armed but never fed (eligibility-gate bug): loud failure
            # beats serving the constant empty-stream ETag; reclaim the
            # staged part shards like every other abort path
            self._cleanup_tmp(tmp_id)
            raise dt.ObjectAPIError(bucket, object,
                                    "fused ETag collector starved")
        etag = collector.etag() if collector is not None else hr.etag()
        # commit part shard + sidecar meta on each surviving disk
        part_meta = msgpack.packb({
            "etag": etag, "size": total,
            "actual_size": hr.actual_size if hr.actual_size >= 0 else total,
            "mtime": FileInfo.now()})
        errs = [None] * len(disks)
        for j, d in enumerate(shuffled):
            if d is None or writers[j] is None:
                errs[j] = errors.DiskNotFound()
                continue
            try:
                d.rename_file(META_TMP, f"{tmp_id}/part.{part_id}",
                              META_MULTIPART, f"{upath}/part.{part_id}")
                d.write_all(META_MULTIPART,
                            f"{upath}/part.{part_id}.meta", part_meta)
            except Exception as e:  # noqa: BLE001
                errs[j] = e
        err = errors.reduce_write_quorum_errs(
            errs, errors.BASE_IGNORED_ERRS, write_quorum)
        if err is not None:
            raise to_object_err(err, bucket, object)
        return PartInfo(part_number=part_id, etag=etag, size=total,
                        actual_size=hr.actual_size
                        if hr.actual_size >= 0 else total,
                        last_modified=FileInfo.now())

    # --- listing ------------------------------------------------------------

    def list_object_parts(self, bucket: str, object: str, upload_id: str,
                          part_marker: int = 0, max_parts: int = 1000
                          ) -> ListPartsInfo:
        self._upload_meta(bucket, object, upload_id)
        upath = upload_path(bucket, object, upload_id)
        out = ListPartsInfo(bucket=bucket, object=object,
                            upload_id=upload_id, max_parts=max_parts,
                            part_number_marker=part_marker)
        metas = self._part_metas(upath)
        nums = sorted(n for n in metas if n > part_marker)
        for n in nums[:max_parts]:
            m = metas[n]
            out.parts.append(PartInfo(
                part_number=n, etag=m["etag"], size=m["size"],
                actual_size=m["actual_size"], last_modified=m["mtime"]))
        if len(nums) > max_parts:
            out.is_truncated = True
            out.next_part_number_marker = nums[max_parts - 1]
        return out

    def _part_metas(self, upath: str) -> dict[int, dict]:
        for d in self.disks:
            if d is None:
                continue
            try:
                names = d.list_dir(META_MULTIPART, upath)
            except errors.StorageError:
                continue
            metas = {}
            for name in names:
                if name.endswith(".meta") and name.startswith("part."):
                    try:
                        num = int(name[len("part."):-len(".meta")])
                        blob = d.read_all(META_MULTIPART, f"{upath}/{name}")
                        metas[num] = msgpack.unpackb(blob)
                    except (ValueError, errors.StorageError):
                        continue
            return metas
        return {}

    def list_multipart_uploads(self, bucket: str, prefix: str = "",
                               max_uploads: int = 1000
                               ) -> ListMultipartsInfo:
        out = ListMultipartsInfo()
        for d in self.disks:
            if d is None:
                continue
            try:
                hashes = d.list_dir(META_MULTIPART, "")
            except errors.StorageError:
                continue
            for h in hashes:
                h = h.rstrip("/")
                try:
                    uploads = d.list_dir(META_MULTIPART, h)
                except errors.StorageError:
                    continue
                for uid in uploads:
                    uid = uid.rstrip("/")
                    try:
                        fi = d.read_version(META_MULTIPART, f"{h}/{uid}")
                    except errors.StorageError:
                        continue
                    tgt = fi.metadata.get("x-minio-internal-object", "")
                    if not tgt.startswith(f"{bucket}/"):
                        continue
                    objname = tgt[len(bucket) + 1:]
                    if prefix and not objname.startswith(prefix):
                        continue
                    out.uploads.append(MultipartInfo(
                        bucket=bucket, object=objname, upload_id=uid,
                        initiated=fi.mod_time,
                        user_defined=dict(fi.metadata)))
                    if len(out.uploads) >= max_uploads:
                        out.is_truncated = True
                        return out
            break
        out.uploads.sort(key=lambda u: (u.object, u.initiated))
        return out

    # --- abort / complete ---------------------------------------------------

    def abort_multipart_upload(self, bucket: str, object: str,
                               upload_id: str) -> None:
        self._upload_meta(bucket, object, upload_id)
        upath = upload_path(bucket, object, upload_id)
        for d in self.disks:
            if d is None:
                continue
            try:
                d.delete_path(META_MULTIPART, upath, recursive=True)
            except errors.StorageError:
                pass

    def complete_multipart_upload(self, bucket: str, object: str,
                                  upload_id: str, parts,
                                  opts: ObjectOptions = None) -> ObjectInfo:
        from .erasure_objects import ACTUAL_SIZE_KEY, to_object_err
        opts = opts or ObjectOptions()
        fi, fis, _ = self._upload_meta(bucket, object, upload_id)
        upath = upload_path(bucket, object, upload_id)
        disks = self.disks
        metas = self._part_metas(upath)

        if not parts:
            raise dt.InvalidPart(bucket, object, "empty part list")
        nums = [p.part_number for p in parts]
        if nums != sorted(nums) or len(set(nums)) != len(nums):
            raise dt.InvalidPartOrder(bucket, object)

        fi_parts: list[ObjectPartInfo] = []
        total = 0
        actual_total = 0
        for i, p in enumerate(parts):
            m = metas.get(p.part_number)
            if m is None or m["etag"].strip('"') != p.etag.strip('"'):
                raise dt.InvalidPart(bucket, object, str(p.part_number))
            if i < len(parts) - 1 and m["actual_size"] < MIN_PART_SIZE:
                raise dt.EntityTooSmall(bucket, object, str(p.part_number))
            fi_parts.append(ObjectPartInfo(
                number=i + 1, etag=m["etag"], size=m["size"],
                actual_size=m["actual_size"]))
            total += m["size"]
            actual_total += m["actual_size"]

        etag = etag_from_parts([p.etag for p in parts])
        fi.size = total
        fi.parts = fi_parts
        fi.mod_time = FileInfo.now()
        if opts.versioned:
            fi.version_id = FileInfo.new_version_id()
        meta = dict(fi.metadata)
        meta.pop("x-minio-internal-object", None)
        meta["etag"] = etag
        meta[ACTUAL_SIZE_KEY] = str(actual_total)
        fi.metadata = meta

        write_quorum = fi.write_quorum(fi.erasure.parity_blocks)
        tmp_id = new_tmp_id()
        errs = [None] * len(disks)
        futs = {}
        for i, d in enumerate(disks):
            if d is None or fis[i] is None:
                errs[i] = errors.DiskNotFound()
                continue
            shard_idx = fis[i].erasure.index
            futs[i] = meta_pool().submit(
                self._commit_one_disk, d, upath, tmp_id, fi, shard_idx,
                parts, bucket, object)
        for i, f in futs.items():
            try:
                f.result()
            except Exception as e:  # noqa: BLE001
                errs[i] = e if isinstance(e, errors.StorageError) \
                    else errors.FaultyDisk(str(e))
        err = errors.reduce_write_quorum_errs(
            errs, errors.BASE_IGNORED_ERRS, write_quorum)
        if err is not None:
            raise to_object_err(err, bucket, object)
        # reap the upload dir
        for d in disks:
            if d is None:
                continue
            try:
                d.delete_path(META_MULTIPART, upath, recursive=True)
            except errors.StorageError:
                pass
        global_tracker().mark(bucket, object)
        self.metacache.on_write(bucket)
        try:  # live usage delta, reconciled each scanner cycle
            _bs.on_put(bucket, fi.size)
        except Exception:  # noqa: BLE001 — obs must never fail a commit
            pass
        return ObjectInfo.from_file_info(fi, bucket, object, opts.versioned)

    def _commit_one_disk(self, d, upath: str, tmp_id: str, fi: FileInfo,
                         shard_idx: int, parts, bucket: str, object: str):
        """Move this disk's part shards into a tmp dataDir and rename_data."""
        for new_num, p in enumerate(parts, start=1):
            d.rename_file(META_MULTIPART, f"{upath}/part.{p.part_number}",
                          META_TMP, f"{tmp_id}/{fi.data_dir}/part.{new_num}")
        fid = replace(fi, erasure=replace(fi.erasure, index=shard_idx),
                      metadata=dict(fi.metadata))
        d.rename_data(META_TMP, tmp_id, fid, bucket, object)
