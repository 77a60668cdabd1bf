"""ErasureSets — the port of objectlayer/sets.py: N erasure sets of K
drives each, with consistent-hash object→set placement (reference erasureSets, cmd/erasure-sets.go:54:
sipHashMod keyed by deploymentID, crc32 legacy). Every ObjectLayer call
routes to the owning set; bucket and listing calls fan out to all sets."""
from __future__ import annotations

import uuid

from ..utils.siphash import sip_hash_mod
from .datatypes import (BucketInfo, ListObjectsInfo, ListObjectVersionsInfo,
                        ObjectOptions)
from .erasure_objects import DEFAULT_BLOCK_SIZE, ErasureObjects
from .interface import ObjectLayer

DISTRIBUTION_ALGO_V2 = "SIPMOD+PARITY"
DISTRIBUTION_ALGO_V1 = "CRCMOD"


class ErasureSets(ObjectLayer):
    def __init__(self, disks: list, set_count: int, drives_per_set: int,
                 deployment_id: str = "", default_parity: int | None = None,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 distribution_algo: str = DISTRIBUTION_ALGO_V2,
                 pool_index: int = 0, device=None):
        if len(disks) != set_count * drives_per_set:
            raise ValueError(
                f"{len(disks)} disks != {set_count} x {drives_per_set}")
        self.deployment_id = deployment_id or str(uuid.uuid4())
        self._id_bytes = uuid.UUID(self.deployment_id).bytes
        self.distribution_algo = distribution_algo
        self.set_count = set_count
        self.drives_per_set = drives_per_set
        self.sets = [
            ErasureObjects(disks[i * drives_per_set:(i + 1) * drives_per_set],
                           default_parity=default_parity,
                           block_size=block_size, set_index=i,
                           pool_index=pool_index, device=device)
            for i in range(set_count)]

    # --- placement (cmd/erasure-sets.go:663-703) ---------------------------

    def get_hashed_set(self, object: str) -> ErasureObjects:
        return self.sets[self.get_hashed_set_index(object)]

    def get_hashed_set_index(self, object: str) -> int:
        if self.distribution_algo == DISTRIBUTION_ALGO_V1:
            import zlib
            return zlib.crc32(object.encode()) % self.set_count
        return sip_hash_mod(object, self.set_count, self._id_bytes)

    # --- buckets (fan out to all sets) -------------------------------------

    def make_bucket(self, bucket: str, opts: ObjectOptions = None) -> None:
        errs = []
        for s in self.sets:
            try:
                s.make_bucket(bucket, opts)
                errs.append(None)
            except Exception as e:  # noqa: BLE001
                errs.append(e)
        for e in errs:
            if e is not None:
                raise e

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        return self.sets[0].get_bucket_info(bucket)

    def list_buckets(self) -> list[BucketInfo]:
        return self.sets[0].list_buckets()

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        for s in self.sets:
            s.delete_bucket(bucket, force)

    # --- objects (route to owning set) -------------------------------------

    def put_object(self, bucket, object, stream, size, opts=None):
        return self.get_hashed_set(object).put_object(
            bucket, object, stream, size, opts)

    def get_object(self, bucket, object, writer, offset=0, length=-1,
                   opts=None):
        return self.get_hashed_set(object).get_object(
            bucket, object, writer, offset, length, opts)

    def get_object_info(self, bucket, object, opts=None):
        return self.get_hashed_set(object).get_object_info(
            bucket, object, opts)

    def delete_object(self, bucket, object, opts=None):
        return self.get_hashed_set(object).delete_object(bucket, object, opts)

    def delete_objects(self, bucket, objects, opts=None):
        deleted, errs = [], []
        for obj in objects:
            name = obj if isinstance(obj, str) else obj["object"]
            d, e = self.get_hashed_set(name).delete_objects(
                bucket, [obj], opts)
            deleted.extend(d)
            errs.extend(e)
        return deleted, errs

    def copy_object(self, src_bucket, src_object, dst_bucket, dst_object,
                    src_info, src_opts, dst_opts):
        src_set = self.get_hashed_set(src_object)
        dst_set = self.get_hashed_set(dst_object)
        if src_set is dst_set:
            return src_set.copy_object(src_bucket, src_object, dst_bucket,
                                       dst_object, src_info, src_opts,
                                       dst_opts)
        import io
        data = src_set.get_object_bytes(src_bucket, src_object, src_opts)
        return dst_set.put_object(dst_bucket, dst_object, io.BytesIO(data),
                                  len(data), dst_opts)

    # --- listing (merge across sets) ---------------------------------------

    def list_objects(self, bucket, prefix="", marker="", delimiter="",
                     max_keys=1000) -> ListObjectsInfo:
        per_set = [s.list_objects(bucket, prefix, marker, delimiter,
                                  max_keys) for s in self.sets]
        return _merge_list_results(per_set, max_keys)

    def iter_objects(self, bucket, prefix=""):
        """Streaming merge of every set's metacache walk (names don't
        collide across sets — placement is by name hash)."""
        import heapq
        yield from heapq.merge(*(s.iter_objects(bucket, prefix)
                                 for s in self.sets),
                               key=lambda oi: oi.name)

    def list_object_versions(self, bucket, prefix="", marker="",
                             version_marker="", delimiter="", max_keys=1000
                             ) -> ListObjectVersionsInfo:
        out = ListObjectVersionsInfo()
        objects = []
        prefixes: set[str] = set()
        for s in self.sets:
            r = s.list_object_versions(bucket, prefix, marker, version_marker,
                                       delimiter, max_keys)
            objects.extend(r.objects)
            prefixes.update(r.prefixes)
        objects.sort(key=lambda o: (o.name, -o.mod_time))
        if len(objects) > max_keys:
            out.is_truncated = True
            objects = objects[:max_keys]
            out.next_key_marker = objects[-1].name
            out.next_version_id_marker = objects[-1].version_id
        out.objects = objects
        out.prefixes = sorted(prefixes)
        return out

    # --- multipart (route by object) ---------------------------------------

    def new_multipart_upload(self, bucket, object, opts=None):
        return self.get_hashed_set(object).new_multipart_upload(
            bucket, object, opts)

    def put_object_part(self, bucket, object, upload_id, part_id, stream,
                        size, opts=None):
        return self.get_hashed_set(object).put_object_part(
            bucket, object, upload_id, part_id, stream, size, opts)

    def list_object_parts(self, bucket, object, upload_id, part_marker=0,
                          max_parts=1000):
        return self.get_hashed_set(object).list_object_parts(
            bucket, object, upload_id, part_marker, max_parts)

    def list_multipart_uploads(self, bucket, prefix="", max_uploads=1000):
        out = None
        for s in self.sets:
            r = s.list_multipart_uploads(bucket, prefix, max_uploads)
            if out is None:
                out = r
            else:
                out.uploads.extend(r.uploads)
        out.uploads.sort(key=lambda u: (u.object, u.initiated))
        return out

    def abort_multipart_upload(self, bucket, object, upload_id):
        return self.get_hashed_set(object).abort_multipart_upload(
            bucket, object, upload_id)

    def complete_multipart_upload(self, bucket, object, upload_id, parts,
                                  opts=None):
        return self.get_hashed_set(object).complete_multipart_upload(
            bucket, object, upload_id, parts, opts)

    # --- object tags --------------------------------------------------------

    def update_object_meta(self, bucket, object, updates, opts=None):
        self.get_hashed_set(object).update_object_meta(bucket, object,
                                                       updates, opts)

    def put_object_tags(self, bucket, object, tags_enc, opts=None):
        self.get_hashed_set(object).put_object_tags(bucket, object,
                                                    tags_enc, opts)

    def get_object_tags(self, bucket, object, opts=None):
        return self.get_hashed_set(object).get_object_tags(bucket, object,
                                                           opts)

    # --- internal config blobs (routed like objects, by path hash) ---------

    def put_config(self, path: str, data: bytes) -> None:
        self.get_hashed_set(path).put_config(path, data)

    def get_config(self, path: str) -> bytes:
        return self.get_hashed_set(path).get_config(path)

    def delete_config(self, path: str) -> None:
        self.get_hashed_set(path).delete_config(path)

    def list_config(self, prefix: str) -> list[str]:
        names: set[str] = set()
        for s in self.sets:
            names.update(s.list_config(prefix))
        return sorted(names)

    # --- heal --------------------------------------------------------------

    def heal_object(self, bucket, object, version_id="", dry_run=False,
                    remove_dangling=False, scan_mode="normal"):
        return self.get_hashed_set(object).heal_object(
            bucket, object, version_id, dry_run, remove_dangling, scan_mode)

    def heal_bucket(self, bucket, dry_run=False):
        res = None
        for s in self.sets:
            r = s.heal_bucket(bucket, dry_run)
            if res is None:
                res = r
            else:
                res.before_state.extend(r.before_state)
                res.after_state.extend(r.after_state)
                res.disk_count += r.disk_count
        return res

    def storage_info(self) -> dict:
        disks_online = disks_offline = 0
        for s in self.sets:
            for d in s.disks:
                if d is None or not d.is_online():
                    disks_offline += 1
                else:
                    disks_online += 1
        return {"disks_online": disks_online, "disks_offline": disks_offline,
                "set_count": self.set_count,
                "drives_per_set": self.drives_per_set}


def _merge_list_results(per_set: list[ListObjectsInfo], max_keys: int
                        ) -> ListObjectsInfo:
    out = ListObjectsInfo()
    objects = []
    prefixes: set[str] = set()
    for r in per_set:
        objects.extend(r.objects)
        prefixes.update(r.prefixes)
    objects.sort(key=lambda o: o.name)
    if len(objects) > max_keys:
        out.is_truncated = True
        objects = objects[:max_keys]
        out.next_marker = objects[-1].name
    out.objects = objects
    out.prefixes = sorted(prefixes)
    out.is_truncated = out.is_truncated or any(r.is_truncated for r in per_set)
    if out.is_truncated and not out.next_marker and objects:
        out.next_marker = objects[-1].name
    return out
