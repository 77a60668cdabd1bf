"""Per-bucket metadata, the port of minio_tpu.bucket's record (reference
§2.9: one BucketMetadata record carries policy/versioning/lifecycle/
tagging/notification/quota config, persisted under .minio.sys and cached
in-process)."""
from .metadata import BucketMetadata, BucketMetadataSys

__all__ = ["BucketMetadata", "BucketMetadataSys"]
