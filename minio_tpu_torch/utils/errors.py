"""Storage-layer error taxonomy and quorum reduction.

The reference threads typed sentinel errors through every disk fan-out and
reduces them against quorum (cmd/storage-errors.go, pkg/sync/errgroup;
reduceReadQuorumErrs / reduceWriteQuorumErrs — SURVEY.md Appendix A.8).
Python equivalent: a small exception hierarchy with value-equality by class,
plus the same reduction algorithm: count identical errors, return the one
meeting quorum, else an ErasureQuorumError.

A copy of minio_tpu/utils/errors.py (the port imports nothing of the JAX
package), and of the base of the object API errors of
minio_tpu/objectlayer/datatypes.py with the ones the SSE-C path raises;
objectlayer/datatypes.py holds the rest of that taxonomy.
"""
from __future__ import annotations


class BuildError(RuntimeError):
    """A kernel library (nvcc) or the host native library (g++) did not
    build. Never salvaged on another route: the program is at fault."""


class StorageError(Exception):
    """Base class for disk/storage errors. Instances of the same class with
    the same args compare equal for quorum counting."""

    def key(self):
        return (type(self), self.args)


class DiskNotFound(StorageError):
    """Disk is offline / not reachable (errDiskNotFound)."""


class FaultyDisk(StorageError):
    """Disk returned an unexpected I/O error (errFaultyDisk)."""


class DiskFull(StorageError):
    """Disk has no space (errDiskFull)."""


class DiskAccessDenied(StorageError):
    """Disk path exists but is not usable (errDiskAccessDenied)."""


class UnformattedDisk(StorageError):
    """Disk has no format.json yet (errUnformattedDisk)."""


class CorruptedFormat(StorageError):
    """format.json exists but is unparseable (errCorruptedFormat)."""


class VolumeNotFound(StorageError):
    """Bucket/volume does not exist (errVolumeNotFound)."""


class VolumeExists(StorageError):
    """Volume already exists (errVolumeExists)."""


class VolumeNotEmpty(StorageError):
    """Volume not empty on delete (errVolumeNotEmpty)."""


class FileNotFound(StorageError):
    """Object/file does not exist (errFileNotFound)."""


class FileVersionNotFound(StorageError):
    """Requested version does not exist (errFileVersionNotFound)."""


class FileNameTooLong(StorageError):
    """Path component too long (errFileNameTooLong)."""


class FileAccessDenied(StorageError):
    """Prefix/file access denied (errFileAccessDenied)."""


class FileCorrupt(StorageError):
    """Bitrot verification failed (errFileCorrupt / hashMismatchError)."""


class IsNotRegular(StorageError):
    """Path is a directory where a file was expected (errIsNotRegular)."""


class MethodNotSupported(StorageError):
    """Operation unsupported by this backend."""


class ErasureReadQuorum(StorageError):
    """Cannot satisfy read quorum (errErasureReadQuorum)."""


class ErasureWriteQuorum(StorageError):
    """Cannot satisfy write quorum (errErasureWriteQuorum)."""


class LessData(StorageError):
    """Stream ended before the declared size (errLessData)."""


class MoreData(StorageError):
    """Stream carried more bytes than declared (errMoreData)."""


class LockTimeout(StorageError):
    """A distributed lock could not be acquired within the deadline
    (reference OperationTimedOut)."""


class RPCError(StorageError):
    """Remote call transport failure — marks the remote disk offline."""


#: Errors ignored when reducing object-operation results (objectOpIgnoredErrs:
#: an offline or faulty disk should not mask the real outcome).
BASE_IGNORED_ERRS = (DiskNotFound, FaultyDisk, DiskAccessDenied, RPCError)


def count_errs(errs: list[BaseException | None], match: BaseException | None) -> int:
    """Count entries equal to ``match`` (None matches None; StorageErrors
    match by (class, args); other exceptions by identity of class+args)."""
    n = 0
    for e in errs:
        if e is None and match is None:
            n += 1
        elif e is not None and match is not None \
                and type(e) is type(match) and e.args == match.args:
            n += 1
    return n


def reduce_errs(errs: list[BaseException | None],
                ignored: tuple[type, ...] = ()) -> tuple[int, BaseException | None]:
    """Return (max_count, err) of the most frequent error value, skipping
    ``ignored`` classes (they never win the vote, mirroring reduceErrs in
    cmd/erasure-common.go)."""
    best_n, best = 0, None
    seen: list[BaseException | None] = []
    for e in errs:
        if e is not None and isinstance(e, ignored):
            continue
        if any(_same(e, s) for s in seen):
            continue
        seen.append(e)
        n = count_errs(errs, e)
        if n > best_n:
            best_n, best = n, e
    return best_n, best


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return type(a) is type(b) and a.args == b.args


def reduce_quorum_errs(errs: list[BaseException | None],
                       ignored: tuple[type, ...],
                       quorum: int,
                       quorum_err: StorageError) -> BaseException | None:
    """Reference reduceQuorumErrs: if the most frequent error value appears
    >= quorum times return it (None = overall success), else quorum_err."""
    n, err = reduce_errs(errs, ignored)
    if n >= quorum:
        return err
    return quorum_err


def reduce_read_quorum_errs(errs, ignored, read_quorum):
    return reduce_quorum_errs(errs, ignored, read_quorum, ErasureReadQuorum())


def reduce_write_quorum_errs(errs, ignored, write_quorum):
    return reduce_quorum_errs(errs, ignored, write_quorum, ErasureWriteQuorum())


# --- object API errors (minio_tpu/objectlayer/datatypes.py) ----------------


class ObjectAPIError(Exception):
    """Base of user-visible object API errors; maps to S3 error codes."""
    code = "InternalError"
    http_status = 500

    def __init__(self, bucket: str = "", object: str = "", extra: str = ""):
        self.bucket = bucket
        self.object = object
        self.extra = extra
        super().__init__(f"{self.code}: {bucket}/{object} {extra}".strip())


class InvalidEncryptionAlgo(ObjectAPIError):
    code = "InvalidEncryptionAlgorithmError"
    http_status = 400


class InvalidSSEKey(ObjectAPIError):
    code = "InvalidArgument"
    http_status = 400


class SSEKeyMD5Mismatch(ObjectAPIError):
    code = "XMinioSSECustomerKeyMD5Mismatch"
    http_status = 400


class SSEKeyMismatch(ObjectAPIError):
    code = "AccessDenied"
    http_status = 403


class SSEEncryptedObject(ObjectAPIError):
    """GET/HEAD of an SSE-C object without the customer key headers."""
    code = "InvalidRequest"
    http_status = 400


class SSEDecryptError(ObjectAPIError):
    code = "XMinioSSEDecryptFailure"
    http_status = 400


class InvalidSSEContext(ObjectAPIError):
    """Malformed x-amz-server-side-encryption-context (must be base64 of
    a JSON object — cmd/crypto/sse-kms.go ParseHTTP)."""
    code = "InvalidArgument"
    http_status = 400


class KMSNotAvailable(ObjectAPIError):
    """External KMS unreachable — retryable, distinct from key mismatch."""
    code = "ServiceUnavailable"
    http_status = 503
