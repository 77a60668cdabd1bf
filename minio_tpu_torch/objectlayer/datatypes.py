"""Object-layer data types and API error taxonomy, the port of
objectlayer/datatypes.py (reference cmd/object-api-datatypes.go,
cmd/object-api-errors.go). The base ObjectAPIError and the SSE-C errors
live in utils/errors.py (the SSE-C slice raises them) and are re-exported
here, so one class stands for each S3 error code."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..storage.datatypes import FileInfo, ObjectPartInfo
from ..utils.errors import (InvalidEncryptionAlgo, InvalidSSEKey,
                            ObjectAPIError, SSEDecryptError,
                            SSEEncryptedObject, SSEKeyMD5Mismatch,
                            SSEKeyMismatch)


# --- API errors --------------------------------------------------------------


class BucketNotFound(ObjectAPIError):
    code = "NoSuchBucket"
    http_status = 404


class BucketExists(ObjectAPIError):
    code = "BucketAlreadyOwnedByYou"
    http_status = 409


class BucketNotEmpty(ObjectAPIError):
    code = "BucketNotEmpty"
    http_status = 409


class BucketNameInvalid(ObjectAPIError):
    code = "InvalidBucketName"
    http_status = 400


class ObjectNotFound(ObjectAPIError):
    code = "NoSuchKey"
    http_status = 404


class VersionNotFound(ObjectAPIError):
    code = "NoSuchVersion"
    http_status = 404


class MethodNotAllowed(ObjectAPIError):
    code = "MethodNotAllowed"
    http_status = 405


class ObjectNameInvalid(ObjectAPIError):
    code = "XMinioInvalidObjectName"
    http_status = 400


class InvalidRange(ObjectAPIError):
    code = "InvalidRange"
    http_status = 416


class BadDigest(ObjectAPIError):
    code = "BadDigest"
    http_status = 400


class InvalidDigest(ObjectAPIError):
    """Content-MD5 header is not valid base64 (reference ErrInvalidDigest)."""
    code = "InvalidDigest"
    http_status = 400


class SHA256Mismatch(ObjectAPIError):
    code = "XAmzContentSHA256Mismatch"
    http_status = 400


class IncompleteBody(ObjectAPIError):
    code = "IncompleteBody"
    http_status = 400


class EntityTooLarge(ObjectAPIError):
    code = "EntityTooLarge"
    http_status = 400


class EntityTooSmall(ObjectAPIError):
    code = "EntityTooSmall"
    http_status = 400


class NoSuchUpload(ObjectAPIError):
    code = "NoSuchUpload"
    http_status = 404


class InvalidPart(ObjectAPIError):
    code = "InvalidPart"
    http_status = 400


class InvalidPartOrder(ObjectAPIError):
    code = "InvalidPartOrder"
    http_status = 400


class PreconditionFailed(ObjectAPIError):
    code = "PreconditionFailed"
    http_status = 412


class NotModified(ObjectAPIError):
    code = "NotModified"
    http_status = 304


class InsufficientReadQuorum(ObjectAPIError):
    code = "SlowDownRead"
    http_status = 503


class InsufficientWriteQuorum(ObjectAPIError):
    code = "SlowDownWrite"
    http_status = 503


class StorageFull(ObjectAPIError):
    code = "XMinioStorageFull"
    http_status = 507


class ObjectExistsAsDirectory(ObjectAPIError):
    code = "XMinioParentIsObject"
    http_status = 400


class NotImplemented(ObjectAPIError):
    code = "NotImplemented"
    http_status = 501


class InvalidSSEContext(ObjectAPIError):
    """Malformed x-amz-server-side-encryption-context (must be base64 of
    a JSON object — cmd/crypto/sse-kms.go ParseHTTP)."""
    code = "InvalidArgument"
    http_status = 400


class KMSNotAvailable(ObjectAPIError):
    """External KMS unreachable — retryable, distinct from key mismatch."""
    code = "ServiceUnavailable"
    http_status = 503


class InvalidRequest(ObjectAPIError):
    code = "InvalidRequest"
    http_status = 400


class AccessDenied(ObjectAPIError):
    code = "AccessDenied"
    http_status = 403


class ObjectLocked(ObjectAPIError):
    """WORM: retention or legal hold forbids the operation
    (cmd/bucket-object-lock.go)."""
    code = "AccessDenied"
    http_status = 403


class QuotaExceeded(ObjectAPIError):
    code = "XMinioAdminBucketQuotaExceeded"
    http_status = 409


api_errors = {
    c.code: c for c in [
        BucketNotFound, BucketExists, BucketNotEmpty, BucketNameInvalid,
        ObjectNotFound, VersionNotFound, MethodNotAllowed, ObjectNameInvalid,
        InvalidRange, BadDigest, SHA256Mismatch, IncompleteBody,
        EntityTooLarge, EntityTooSmall, NoSuchUpload, InvalidPart,
        InvalidPartOrder, PreconditionFailed, InsufficientReadQuorum,
        InsufficientWriteQuorum, StorageFull, NotImplemented,
        InvalidEncryptionAlgo, InvalidSSEKey, SSEKeyMD5Mismatch,
        SSEKeyMismatch, SSEEncryptedObject, SSEDecryptError,
        InvalidRequest, ObjectLocked, QuotaExceeded,
    ]
}


# --- option / info records ---------------------------------------------------


@dataclass
class ObjectOptions:
    """Per-call options (reference ObjectOptions,
    cmd/object-api-interface.go:38)."""
    version_id: str = ""
    versioned: bool = False
    version_suspended: bool = False
    user_defined: dict[str, str] = field(default_factory=dict)
    mod_time: float = 0.0
    part_number: int = 0
    delete_marker: bool = False
    storage_class: str = ""
    # CopyObject x-amz-metadata-directive: REPLACE — user_defined fully
    # replaces the stored user metadata instead of merging over it.
    metadata_replace: bool = False
    no_lock: bool = False
    # ETag source override: a HashReader whose digest is the object's ETag
    # even though the stored stream differs (transparent compression
    # hashes the plaintext while storing the compressed bytes).
    etag_source: object = None


@dataclass
class BucketInfo:
    name: str
    created: float = 0.0


@dataclass
class ObjectInfo:
    """User-visible object record (reference ObjectInfo,
    cmd/object-api-datatypes.go:160)."""
    bucket: str = ""
    name: str = ""
    version_id: str = ""
    is_latest: bool = True
    delete_marker: bool = False
    mod_time: float = 0.0
    size: int = 0
    etag: str = ""
    content_type: str = ""
    user_defined: dict[str, str] = field(default_factory=dict)
    #: server-internal metadata (x-minio-internal-*): never exposed in
    #: responses, consumed by handler-layer subsystems (SSE, compression)
    internal: dict[str, str] = field(default_factory=dict)
    parts: list[ObjectPartInfo] = field(default_factory=list)
    storage_class: str = "STANDARD"
    actual_size: int = -1
    is_dir: bool = False
    num_versions: int = 0

    @classmethod
    def from_file_info(cls, fi: FileInfo, bucket: str, object: str,
                       versioned: bool) -> "ObjectInfo":
        version_id = fi.version_id if versioned else ""
        if versioned and not version_id:
            version_id = "null"
        meta = dict(fi.metadata)
        etag = meta.pop("etag", "")
        content_type = meta.pop("content-type", "")
        actual = int(meta.get("x-minio-internal-actual-size", fi.size))
        return cls(bucket=bucket, name=object, version_id=version_id,
                   is_latest=fi.is_latest, delete_marker=fi.deleted,
                   mod_time=fi.mod_time, size=fi.size, etag=etag,
                   content_type=content_type,
                   user_defined={k: v for k, v in meta.items()
                                 if not k.startswith("x-minio-internal-")},
                   internal={k: v for k, v in meta.items()
                             if k.startswith("x-minio-internal-")},
                   parts=list(fi.parts), actual_size=actual,
                   num_versions=fi.num_versions)


@dataclass
class ListObjectsInfo:
    is_truncated: bool = False
    next_marker: str = ""
    next_continuation_token: str = ""
    objects: list[ObjectInfo] = field(default_factory=list)
    prefixes: list[str] = field(default_factory=list)


@dataclass
class ListObjectVersionsInfo:
    is_truncated: bool = False
    next_key_marker: str = ""
    next_version_id_marker: str = ""
    objects: list[ObjectInfo] = field(default_factory=list)
    prefixes: list[str] = field(default_factory=list)


@dataclass
class MultipartInfo:
    bucket: str = ""
    object: str = ""
    upload_id: str = ""
    initiated: float = field(default_factory=time.time)
    user_defined: dict[str, str] = field(default_factory=dict)


@dataclass
class PartInfo:
    part_number: int = 0
    etag: str = ""
    size: int = 0
    actual_size: int = 0
    last_modified: float = 0.0


@dataclass
class CompletePart:
    part_number: int
    etag: str


@dataclass
class ListPartsInfo:
    bucket: str = ""
    object: str = ""
    upload_id: str = ""
    max_parts: int = 0
    part_number_marker: int = 0
    next_part_number_marker: int = 0
    is_truncated: bool = False
    parts: list[PartInfo] = field(default_factory=list)


@dataclass
class ListMultipartsInfo:
    uploads: list[MultipartInfo] = field(default_factory=list)
    is_truncated: bool = False
    next_key_marker: str = ""
    next_upload_id_marker: str = ""


@dataclass
class DeletedObject:
    object_name: str = ""
    version_id: str = ""
    delete_marker: bool = False
    delete_marker_version_id: str = ""


@dataclass
class HealResultItem:
    """Outcome of healing one item (reference madmin.HealResultItem)."""
    heal_item_type: str = "object"
    bucket: str = ""
    object: str = ""
    version_id: str = ""
    disk_count: int = 0
    parity_blocks: int = 0
    data_blocks: int = 0
    before_state: list[str] = field(default_factory=list)
    after_state: list[str] = field(default_factory=list)
    object_size: int = 0


DRIVE_STATE_OK = "ok"
DRIVE_STATE_OFFLINE = "offline"
DRIVE_STATE_CORRUPT = "corrupt"
DRIVE_STATE_MISSING = "missing"
