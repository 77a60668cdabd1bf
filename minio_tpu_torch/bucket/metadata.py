"""BucketMetadata + BucketMetadataSys, the port of
minio_tpu/bucket/metadata.py (reference cmd/bucket-metadata.go:66,
cmd/bucket-metadata-sys.go:41): the single per-bucket record every bucket
feature hangs off — versioning, policy, tagging, lifecycle, notification,
quota, SSE config, object-lock — persisted as one MessagePack blob under
``.minio.sys/config/buckets/<bucket>/metadata`` and cached in-process.

The blob is packed by the port's own MessagePack subset
(``utils/msgpack.py``): the bytes are those of the ``msgpack`` wheel's
``packb(use_bin_type=True)`` that the JAX package writes (``created`` a
float64, the flags bools, the XML and policy fields bin, ``tags`` a nested
str map), so either package reads the other's record, its lifecycle,
notification, object-lock and replication documents byte for byte."""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field

from ..utils import errors, msgpack

log = logging.getLogger(__name__)


@dataclass
class BucketMetadata:
    name: str = ""
    created: float = field(default_factory=time.time)
    versioning_enabled: bool = False
    versioning_suspended: bool = False
    policy_json: bytes = b""
    tagging: dict[str, str] = field(default_factory=dict)
    lifecycle_xml: bytes = b""
    notification_xml: bytes = b""
    sse_xml: bytes = b""
    quota: int = 0
    object_lock_enabled: bool = False
    object_lock_xml: bytes = b""
    replication_xml: bytes = b""

    def dump(self) -> bytes:
        return msgpack.packb({
            "name": self.name, "created": self.created,
            "ver_on": self.versioning_enabled,
            "ver_susp": self.versioning_suspended,
            "policy": self.policy_json, "tags": self.tagging,
            "lifecycle": self.lifecycle_xml,
            "notification": self.notification_xml,
            "sse": self.sse_xml, "quota": self.quota,
            "lock": self.object_lock_enabled,
            "lock_cfg": self.object_lock_xml,
            "replication": self.replication_xml,
        })

    @classmethod
    def load(cls, blob: bytes) -> "BucketMetadata":
        d = msgpack.unpackb(blob)
        return cls(name=d.get("name", ""), created=d.get("created", 0.0),
                   versioning_enabled=d.get("ver_on", False),
                   versioning_suspended=d.get("ver_susp", False),
                   policy_json=d.get("policy", b""),
                   tagging=d.get("tags", {}),
                   lifecycle_xml=d.get("lifecycle", b""),
                   notification_xml=d.get("notification", b""),
                   sse_xml=d.get("sse", b""), quota=d.get("quota", 0),
                   object_lock_enabled=d.get("lock", False),
                   object_lock_xml=d.get("lock_cfg", b""),
                   replication_xml=d.get("replication", b""))


class BucketMetadataSys:
    """Process-cached bucket metadata registry; in a distributed
    deployment the nodes invalidate each other's caches through the peer
    RPC (``on_update``, set by dist.node.Node)."""

    def __init__(self, objlayer):
        self.obj = objlayer
        self._cache: dict[str, BucketMetadata] = {}
        self._lock = threading.Lock()
        #: called with the bucket after every stored update (the node's
        #: peer invalidation broadcast)
        self.on_update = None

    def _path(self, bucket: str) -> str:
        return f"buckets/{bucket}/metadata"

    def get(self, bucket: str) -> BucketMetadata:
        with self._lock:
            meta = self._cache.get(bucket)
        if meta is not None:
            return meta
        try:
            meta = BucketMetadata.load(self.obj.get_config(self._path(bucket)))
        except (errors.StorageError, ValueError):
            meta = BucketMetadata(name=bucket)
        with self._lock:
            self._cache[bucket] = meta
        return meta

    def set(self, bucket: str, meta: BucketMetadata) -> None:
        meta.name = bucket
        self.obj.put_config(self._path(bucket), meta.dump())
        with self._lock:
            self._cache[bucket] = meta
        if self.on_update is not None:
            try:
                self.on_update(bucket)
            except Exception:  # noqa: BLE001 — the broadcast is best effort
                log.warning("bucket metadata broadcast of %s failed",
                            bucket, exc_info=True)

    def update(self, bucket: str, **fields) -> BucketMetadata:
        meta = self.get(bucket)
        for k, v in fields.items():
            setattr(meta, k, v)
        self.set(bucket, meta)
        return meta

    def remove(self, bucket: str) -> None:
        self.obj.delete_config(self._path(bucket))
        with self._lock:
            self._cache.pop(bucket, None)

    def invalidate(self, bucket: str) -> None:
        with self._lock:
            self._cache.pop(bucket, None)

    def versioning_enabled(self, bucket: str) -> bool:
        return self.get(bucket).versioning_enabled
