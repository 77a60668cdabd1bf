"""Per-bucket feature subsystems, the port of minio_tpu.bucket (reference
§2.9: one BucketMetadata record carries policy/versioning/lifecycle/
tagging/notification/quota config, persisted under .minio.sys and cached
in-process): the record (``metadata``), object lock (``objectlock``),
lifecycle (``lifecycle``) with its tiers and transition (``tiers``,
``transition``), replication to an S3 target (``replication``) with its
bandwidth throttle (``bandwidth``), and the cross-node replication plane
(``replicate``)."""
from .metadata import BucketMetadata, BucketMetadataSys

__all__ = ["BucketMetadata", "BucketMetadataSys"]
