"""Erasure metadata quorum helpers, the port of objectlayer/metadata.py
(reference cmd/erasure-metadata.go,
cmd/erasure-metadata-utils.go, cmd/erasure-healing-common.go): fan-out
read_version, quorum-pick the authoritative FileInfo, disk/shard ordering by
distribution."""
from __future__ import annotations

import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

from ..storage.datatypes import FileInfo
from ..utils import errors

_meta_pool: ThreadPoolExecutor | None = None
_meta_lock = threading.Lock()


def meta_pool() -> ThreadPoolExecutor:
    """The shared pool of the per-disk metadata fan-outs (commits, bucket
    calls), host-scaled like erasure.streaming.io_pool. The JAX package's
    MINIO_TPU_META_THREADS knob is for remote disks, which the port does
    not have yet."""
    global _meta_pool
    if _meta_pool is None:
        with _meta_lock:
            if _meta_pool is None:
                workers = min(64, max(8, 4 * (os.cpu_count() or 1)))
                _meta_pool = ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="minio-torch-meta")
    return _meta_pool


def hash_order(key: str, cardinality: int) -> list[int]:
    """Shard distribution permutation seeded by the object name: a rotation
    of [1..cardinality] starting at crc32(key)%cardinality (reference
    hashOrder, cmd/erasure-metadata-utils.go:52)."""
    if cardinality <= 0:
        return []
    start = zlib.crc32(key.encode()) % cardinality
    return [1 + (start + i) % cardinality for i in range(cardinality)]


def read_all_fileinfo(disks: list, bucket: str, object: str,
                      version_id: str = "", read_data: bool = False
                      ) -> tuple[list[FileInfo | None], list]:
    """Fan out read_version to every disk (reference readAllFileInfo,
    cmd/erasure-metadata-utils.go:~120). Returns (fis, errs) index-aligned
    with disks.

    The reads run inline in the caller's thread: a local xl.meta read is a
    page-cache parse, and a pool hop would cost two thread wake-ups per
    disk under concurrent requests. (The JAX package fans remote disks out
    on the pool; the port has no remote disks yet.)"""
    fis: list[FileInfo | None] = [None] * len(disks)
    errs: list[BaseException | None] = [None] * len(disks)
    for i, d in enumerate(disks):
        if d is None:
            errs[i] = errors.DiskNotFound()
            continue
        try:
            fis[i] = d.read_version(bucket, object, version_id, read_data)
        except Exception as e:  # noqa: BLE001
            errs[i] = e if isinstance(e, errors.StorageError) \
                else errors.FaultyDisk(str(e))
    return fis, errs


def find_file_info_in_quorum(fis: list[FileInfo | None], quorum: int
                             ) -> FileInfo:
    """Pick the FileInfo agreeing on (mod_time, version_id, data_dir) across
    >= quorum disks (reference findFileInfoInQuorum,
    cmd/erasure-metadata.go:300)."""
    counts: dict[tuple, int] = {}
    for fi in fis:
        if fi is None:
            continue
        key = (round(fi.mod_time, 3), fi.version_id, fi.data_dir, fi.deleted)
        counts[key] = counts.get(key, 0) + 1
    best = None
    for fi in fis:
        if fi is None:
            continue
        key = (round(fi.mod_time, 3), fi.version_id, fi.data_dir, fi.deleted)
        if counts[key] >= quorum and (best is None
                                      or fi.mod_time > best.mod_time):
            best = fi
    if best is None:
        raise errors.ErasureReadQuorum()
    return best


def object_quorum_from_meta(fis: list[FileInfo | None], errs: list,
                            default_parity: int) -> tuple[int, int]:
    """(read_quorum, write_quorum) from stored erasure geometry (reference
    objectQuorumFromMeta, cmd/erasure-multipart.go:414)."""
    for fi in fis:
        if fi is not None and fi.erasure.data_blocks:
            d, p = fi.erasure.data_blocks, fi.erasure.parity_blocks
            return d, (d + 1 if d == p else d)
    n = len(fis)
    d = n - default_parity
    return d, (d + 1 if d == default_parity else d)


def list_online_disks(disks: list, fis: list[FileInfo | None], errs: list
                      ) -> tuple[list, float]:
    """Disks agreeing with the quorum mod_time; others nulled (reference
    listOnlineDisks, cmd/erasure-healing-common.go)."""
    mod_counts: dict[float, int] = {}
    for fi in fis:
        if fi is not None:
            t = round(fi.mod_time, 3)
            mod_counts[t] = mod_counts.get(t, 0) + 1
    if not mod_counts:
        return [None] * len(disks), 0.0
    latest = max(mod_counts, key=lambda t: (mod_counts[t], t))
    online = [d if fi is not None and round(fi.mod_time, 3) == latest else None
              for d, fi in zip(disks, fis)]
    return online, latest


def shuffle_disks_by_distribution(disks: list, distribution: list[int]
                                  ) -> list:
    """out[distribution[i]-1] = disks[i] (reference shuffleDisks,
    cmd/erasure-metadata-utils.go:90)."""
    if not distribution:
        return list(disks)
    out = [None] * len(disks)
    for i, d in enumerate(disks):
        out[distribution[i] - 1] = d
    return out
