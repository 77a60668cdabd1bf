"""ServerPools — the port of objectlayer/pools.py: the top-level
ObjectLayer (reference erasureServerPools,
cmd/erasure-server-pool.go:40): multiple pools for cluster expansion.
Reads look the object up in every pool; writes pick the pool that already
holds the object, else the pool with the most free space
(getPoolIdx, cmd/erasure-server-pool.go:249)."""
from __future__ import annotations

from . import datatypes as dt
from .datatypes import BucketInfo, ListObjectsInfo, ObjectOptions
from .interface import ObjectLayer
from .sets import ErasureSets, _merge_list_results


class ServerPools(ObjectLayer):
    def __init__(self, pools: list[ErasureSets]):
        if not pools:
            raise ValueError("need at least one pool")
        self.pools = pools

    # --- pool choice --------------------------------------------------------

    def _pool_with_object(self, bucket: str, object: str,
                          opts: ObjectOptions = None) -> int | None:
        for i, p in enumerate(self.pools):
            try:
                p.get_object_info(bucket, object, opts)
                return i
            except dt.ObjectAPIError:
                continue
        return None

    def get_pool_idx(self, bucket: str, object: str, size: int = -1) -> int:
        idx = self._pool_with_object(bucket, object)
        if idx is not None:
            return idx
        if len(self.pools) == 1:
            return 0
        # free-space proportional choice (deterministic: max free)
        best, best_free = 0, -1
        for i, p in enumerate(self.pools):
            free = 0
            for s in p.sets:
                for d in s.disks:
                    if d is not None:
                        try:
                            free += d.disk_info().free
                        except Exception:  # noqa: BLE001
                            pass
            if free > best_free:
                best, best_free = i, free
        return best

    # --- buckets ------------------------------------------------------------

    def make_bucket(self, bucket, opts=None):
        for p in self.pools:
            p.make_bucket(bucket, opts)

    def get_bucket_info(self, bucket):
        return self.pools[0].get_bucket_info(bucket)

    def list_buckets(self) -> list[BucketInfo]:
        return self.pools[0].list_buckets()

    def delete_bucket(self, bucket, force=False):
        for p in self.pools:
            p.delete_bucket(bucket, force)

    # --- objects ------------------------------------------------------------

    def put_object(self, bucket, object, stream, size, opts=None):
        return self.pools[self.get_pool_idx(bucket, object, size)].put_object(
            bucket, object, stream, size, opts)

    def _route(self, bucket, object, opts=None):
        idx = self._pool_with_object(bucket, object, opts)
        return self.pools[idx if idx is not None else 0]

    def get_object(self, bucket, object, writer, offset=0, length=-1,
                   opts=None):
        last = None
        for p in self.pools:
            try:
                return p.get_object(bucket, object, writer, offset, length,
                                    opts)
            except (dt.ObjectNotFound, dt.VersionNotFound) as e:
                last = e
        raise last or dt.ObjectNotFound(bucket, object)

    def get_object_info(self, bucket, object, opts=None):
        last = None
        for p in self.pools:
            try:
                return p.get_object_info(bucket, object, opts)
            except (dt.ObjectNotFound, dt.VersionNotFound) as e:
                last = e
        raise last or dt.ObjectNotFound(bucket, object)

    def delete_object(self, bucket, object, opts=None):
        last = None
        for p in self.pools:
            try:
                return p.delete_object(bucket, object, opts)
            except (dt.ObjectNotFound, dt.VersionNotFound) as e:
                last = e
        raise last or dt.ObjectNotFound(bucket, object)

    def delete_objects(self, bucket, objects, opts=None):
        from .datatypes import DeletedObject
        opts = opts or ObjectOptions()
        deleted, errs = [], []
        for obj in objects:
            name = obj if isinstance(obj, str) else obj["object"]
            vid = "" if isinstance(obj, str) else obj.get("version_id", "")
            try:
                oi = self.delete_object(
                    bucket, name,
                    ObjectOptions(version_id=vid, versioned=opts.versioned))
                deleted.append(DeletedObject(
                    object_name=name, version_id=vid,
                    delete_marker=oi.delete_marker,
                    delete_marker_version_id=oi.version_id
                    if oi.delete_marker else ""))
                errs.append(None)
            except dt.ObjectNotFound:
                deleted.append(DeletedObject(object_name=name,
                                             version_id=vid))
                errs.append(None)
            except Exception as e:  # noqa: BLE001
                deleted.append(DeletedObject(object_name=name,
                                             version_id=vid))
                errs.append(e)
        return deleted, errs

    def copy_object(self, src_bucket, src_object, dst_bucket, dst_object,
                    src_info, src_opts, dst_opts):
        src_pool = self._route(src_bucket, src_object, src_opts)
        return src_pool.copy_object(src_bucket, src_object, dst_bucket,
                                    dst_object, src_info, src_opts, dst_opts)

    # --- listing ------------------------------------------------------------

    def list_objects(self, bucket, prefix="", marker="", delimiter="",
                     max_keys=1000) -> ListObjectsInfo:
        per_pool = [p.list_objects(bucket, prefix, marker, delimiter,
                                   max_keys) for p in self.pools]
        return _merge_list_results(per_pool, max_keys)

    def iter_objects(self, bucket, prefix=""):
        """Streaming merge across pools; an object that exists in several
        pools (mid-expansion) is emitted once, newest mod_time wins."""
        import heapq
        pending = None
        for oi in heapq.merge(*(p.iter_objects(bucket, prefix)
                                for p in self.pools),
                              key=lambda o: o.name):
            if pending is not None and oi.name == pending.name:
                if oi.mod_time > pending.mod_time:
                    pending = oi
                continue
            if pending is not None:
                yield pending
            pending = oi
        if pending is not None:
            yield pending

    def list_object_versions(self, bucket, prefix="", marker="",
                             version_marker="", delimiter="", max_keys=1000):
        out = None
        for p in self.pools:
            r = p.list_object_versions(bucket, prefix, marker, version_marker,
                                       delimiter, max_keys)
            if out is None:
                out = r
            else:
                out.objects.extend(r.objects)
                out.prefixes = sorted(set(out.prefixes) | set(r.prefixes))
        out.objects.sort(key=lambda o: (o.name, -o.mod_time))
        return out

    # --- multipart ----------------------------------------------------------

    def new_multipart_upload(self, bucket, object, opts=None):
        return self.pools[self.get_pool_idx(bucket, object)] \
            .new_multipart_upload(bucket, object, opts)

    def _pool_with_upload(self, bucket, object, upload_id):
        for p in self.pools:
            try:
                p.list_object_parts(bucket, object, upload_id, max_parts=1)
                return p
            except dt.ObjectAPIError:
                continue
        raise dt.NoSuchUpload(bucket, object, upload_id)

    def put_object_part(self, bucket, object, upload_id, part_id, stream,
                        size, opts=None):
        return self._pool_with_upload(bucket, object, upload_id) \
            .put_object_part(bucket, object, upload_id, part_id, stream,
                             size, opts)

    def list_object_parts(self, bucket, object, upload_id, part_marker=0,
                          max_parts=1000):
        return self._pool_with_upload(bucket, object, upload_id) \
            .list_object_parts(bucket, object, upload_id, part_marker,
                               max_parts)

    def list_multipart_uploads(self, bucket, prefix="", max_uploads=1000):
        out = None
        for p in self.pools:
            r = p.list_multipart_uploads(bucket, prefix, max_uploads)
            if out is None:
                out = r
            else:
                out.uploads.extend(r.uploads)
        return out

    def abort_multipart_upload(self, bucket, object, upload_id):
        return self._pool_with_upload(bucket, object, upload_id) \
            .abort_multipart_upload(bucket, object, upload_id)

    def complete_multipart_upload(self, bucket, object, upload_id, parts,
                                  opts=None):
        return self._pool_with_upload(bucket, object, upload_id) \
            .complete_multipart_upload(bucket, object, upload_id, parts, opts)

    # --- object tags --------------------------------------------------------

    def update_object_meta(self, bucket, object, updates, opts=None):
        self._route(bucket, object, opts).update_object_meta(
            bucket, object, updates, opts)

    def put_object_tags(self, bucket, object, tags_enc, opts=None):
        self._route(bucket, object, opts).put_object_tags(
            bucket, object, tags_enc, opts)

    def get_object_tags(self, bucket, object, opts=None):
        return self._route(bucket, object, opts).get_object_tags(
            bucket, object, opts)

    # --- internal config blobs (pool 0 owns framework state) ---------------

    def put_config(self, path: str, data: bytes) -> None:
        self.pools[0].put_config(path, data)

    def get_config(self, path: str) -> bytes:
        return self.pools[0].get_config(path)

    def delete_config(self, path: str) -> None:
        self.pools[0].delete_config(path)

    def list_config(self, prefix: str) -> list[str]:
        return self.pools[0].list_config(prefix)

    # --- heal ---------------------------------------------------------------

    def heal_object(self, bucket, object, version_id="", dry_run=False,
                    remove_dangling=False, scan_mode="normal"):
        last = None
        for p in self.pools:
            try:
                return p.heal_object(bucket, object, version_id, dry_run,
                                     remove_dangling, scan_mode)
            except dt.ObjectAPIError as e:
                last = e
        raise last or dt.ObjectNotFound(bucket, object)

    def heal_bucket(self, bucket, dry_run=False):
        res = None
        for p in self.pools:
            r = p.heal_bucket(bucket, dry_run)
            if res is None:
                res = r
            else:
                res.before_state.extend(r.before_state)
                res.after_state.extend(r.after_state)
                res.disk_count += r.disk_count
        return res

    def storage_info(self) -> dict:
        infos = [p.storage_info() for p in self.pools]
        return {"pools": infos,
                "disks_online": sum(i["disks_online"] for i in infos),
                "disks_offline": sum(i["disks_offline"] for i in infos)}
