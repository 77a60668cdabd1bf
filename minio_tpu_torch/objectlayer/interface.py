"""ObjectLayer — the port of objectlayer/interface.py: the backend
abstraction every API handler codes against (reference
cmd/object-api-interface.go:84). Implementations: ErasureObjects (one set),
ErasureSets (N sets), ServerPools (N pools)."""
from __future__ import annotations

import abc

from .datatypes import (BucketInfo, CompletePart, DeletedObject,
                        HealResultItem, ListMultipartsInfo, ListObjectsInfo,
                        ListObjectVersionsInfo, ListPartsInfo, ObjectInfo,
                        ObjectOptions, PartInfo)


class ObjectLayer(abc.ABC):
    # --- buckets ------------------------------------------------------------

    @abc.abstractmethod
    def make_bucket(self, bucket: str, opts: ObjectOptions = None) -> None: ...

    @abc.abstractmethod
    def get_bucket_info(self, bucket: str) -> BucketInfo: ...

    @abc.abstractmethod
    def list_buckets(self) -> list[BucketInfo]: ...

    @abc.abstractmethod
    def delete_bucket(self, bucket: str, force: bool = False) -> None: ...

    # --- objects ------------------------------------------------------------

    @abc.abstractmethod
    def put_object(self, bucket: str, object: str, stream, size: int,
                   opts: ObjectOptions = None) -> ObjectInfo: ...

    @abc.abstractmethod
    def get_object(self, bucket: str, object: str, writer, offset: int = 0,
                   length: int = -1, opts: ObjectOptions = None
                   ) -> ObjectInfo: ...

    @abc.abstractmethod
    def get_object_info(self, bucket: str, object: str,
                        opts: ObjectOptions = None) -> ObjectInfo: ...

    @abc.abstractmethod
    def delete_object(self, bucket: str, object: str,
                      opts: ObjectOptions = None) -> ObjectInfo: ...

    @abc.abstractmethod
    def delete_objects(self, bucket: str, objects: list, opts=None
                       ) -> tuple[list[DeletedObject], list]: ...

    @abc.abstractmethod
    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000
                     ) -> ListObjectsInfo: ...

    def iter_objects(self, bucket: str, prefix: str = ""):
        """Streaming iterator over latest-version objects for background
        services (scanner, global heal). Default: marker paging over
        list_objects; erasure layers override with a single metacache
        walk."""
        marker = ""
        while True:
            r = self.list_objects(bucket, prefix, marker, max_keys=1000)
            yield from r.objects
            if not r.is_truncated or not r.next_marker:
                return
            marker = r.next_marker

    @abc.abstractmethod
    def list_object_versions(self, bucket: str, prefix: str = "",
                             marker: str = "", version_marker: str = "",
                             delimiter: str = "", max_keys: int = 1000
                             ) -> ListObjectVersionsInfo: ...

    def copy_object(self, src_bucket: str, src_object: str, dst_bucket: str,
                    dst_object: str, src_info: ObjectInfo,
                    src_opts: ObjectOptions, dst_opts: ObjectOptions
                    ) -> ObjectInfo:
        raise NotImplementedError

    # --- multipart ----------------------------------------------------------

    @abc.abstractmethod
    def new_multipart_upload(self, bucket: str, object: str,
                             opts: ObjectOptions = None) -> str: ...

    @abc.abstractmethod
    def put_object_part(self, bucket: str, object: str, upload_id: str,
                        part_id: int, stream, size: int,
                        opts: ObjectOptions = None) -> PartInfo: ...

    @abc.abstractmethod
    def list_object_parts(self, bucket: str, object: str, upload_id: str,
                          part_marker: int = 0, max_parts: int = 1000
                          ) -> ListPartsInfo: ...

    @abc.abstractmethod
    def list_multipart_uploads(self, bucket: str, prefix: str = "",
                               max_uploads: int = 1000
                               ) -> ListMultipartsInfo: ...

    @abc.abstractmethod
    def abort_multipart_upload(self, bucket: str, object: str,
                               upload_id: str) -> None: ...

    @abc.abstractmethod
    def complete_multipart_upload(self, bucket: str, object: str,
                                  upload_id: str, parts: list[CompletePart],
                                  opts: ObjectOptions = None
                                  ) -> ObjectInfo: ...

    # --- heal / health ------------------------------------------------------

    @abc.abstractmethod
    def heal_object(self, bucket: str, object: str, version_id: str = "",
                    dry_run: bool = False, remove_dangling: bool = False,
                    scan_mode: str = "normal") -> HealResultItem: ...

    @abc.abstractmethod
    def heal_bucket(self, bucket: str, dry_run: bool = False
                    ) -> HealResultItem: ...

    def heal_format(self, dry_run: bool = False) -> HealResultItem:
        raise NotImplementedError

    # --- object tags (reference ObjectLayer PutObjectTags/GetObjectTags/
    # DeleteObjectTags, cmd/object-api-interface.go) ------------------------

    def put_object_tags(self, bucket: str, object: str, tags_enc: str,
                        opts: ObjectOptions = None) -> None:
        raise NotImplementedError

    def get_object_tags(self, bucket: str, object: str,
                        opts: ObjectOptions = None) -> str:
        raise NotImplementedError

    def delete_object_tags(self, bucket: str, object: str,
                           opts: ObjectOptions = None) -> None:
        self.put_object_tags(bucket, object, "", opts)

    # --- internal config blobs (reference cmd/config-common.go: saveConfig/
    # readConfig persist framework state into .minio.sys via the backend) ---

    def put_config(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def get_config(self, path: str) -> bytes:
        raise NotImplementedError

    def delete_config(self, path: str) -> None:
        raise NotImplementedError

    def list_config(self, prefix: str) -> list[str]:
        return []

    def is_ready(self) -> bool:
        return True

    def storage_info(self) -> dict:
        return {}

    def backend_type(self) -> str:
        return "Erasure"

    def shutdown(self) -> None:
        pass
