"""ILM transition and restore, the port of minio_tpu/bucket/transition.py
(reference cmd/bucket-lifecycle.go:113-161
transitionState workers, :365 transitionObject, restoreTransitionedObject):
cold objects move their stored bytes to an admin-configured tier and leave
a metadata stub behind; GETs read through; POST ?restore brings a copy
back for N days and the scanner re-stubs it after expiry.

Scope note (vs the reference): transition applies to the latest version
of unversioned buckets — per-version transition inside the version
journal is not wired yet."""
from __future__ import annotations

import io
import time
import uuid

from ..objectlayer import datatypes as dt
from ..objectlayer.datatypes import ObjectOptions
from ..obs import metrics
from ..utils import errors

META_TIER = "x-minio-internal-transition-tier"
META_KEY = "x-minio-internal-transition-key"
META_SIZE = "x-minio-internal-transition-size"
#: unix ts while a restored copy lives (internal prefix so it rides
#: ObjectInfo.internal like the other transition pointers)
META_RESTORE = "x-minio-internal-restore-expiry"


def is_transitioned(oi) -> bool:
    return bool(oi.internal.get(META_TIER))


def is_restored(oi) -> bool:
    try:
        return float(oi.internal.get(META_RESTORE, "0")) > time.time()
    except ValueError:
        return False


def transitioned_size(oi) -> int:
    try:
        return int(oi.internal.get(META_SIZE, oi.size))
    except ValueError:
        return oi.size


class TransitionSys:
    def __init__(self, objlayer, tiers, bucket_meta=None):
        self.obj = objlayer
        self.tiers = tiers
        self.bucket_meta = bucket_meta
        self.transitioned = 0
        self.restored = 0

    def _versioned(self, bucket: str) -> bool:
        return self.bucket_meta is not None and \
            self.bucket_meta.versioning_enabled(bucket)

    def transition(self, bucket: str, oi, tier_name: str) -> bool:
        """Move the object's stored bytes to the tier, replace the object
        with a stub carrying the pointer. Returns True when moved."""
        if is_transitioned(oi) or self._versioned(bucket):
            return False
        if oi.internal.get("x-minio-internal-sse-scheme"):
            # SSE objects: the stored bytes are ciphertext and the server
            # may not even hold the key (SSE-C) — archiving them would
            # orphan the crypto metadata. The reference transitions
            # ciphertext+metadata together; until that is wired, skip.
            return False
        tier = self.tiers.get(tier_name)
        if tier is None:
            return False
        from ..utils.compress import logical_bytes
        # the tier holds PLAINTEXT: stored bytes may be deflate (transparent
        # compression) and the tier/destination doesn't know our markers
        data = logical_bytes(oi, self.obj.get_object_bytes(bucket, oi.name))
        key = f"{bucket}/{oi.name}/{uuid.uuid4().hex}"
        tier.put(key, data)
        meta = dict(oi.user_defined)
        meta.update({
            "etag": oi.etag,
            "content-type": oi.content_type,
            META_TIER: tier_name,
            META_KEY: key,
            META_SIZE: str(len(data)),
        })
        try:
            self.obj.put_object(bucket, oi.name, io.BytesIO(b""), 0,
                                ObjectOptions(user_defined=meta))
        except Exception:
            tier.remove(key)  # stub write failed: don't leak tier data
            raise
        self.transitioned += 1
        metrics.inc("minio_tpu_ilm_transitioned_total", tier=tier_name)
        return True

    def read(self, oi) -> bytes:
        """The transitioned object's bytes, fetched from its tier
        (read-through for GET; reference streams from the tier client)."""
        tier = self.tiers.get(oi.internal.get(META_TIER, ""))
        if tier is None:
            raise errors.FileNotFound(
                f"tier {oi.internal.get(META_TIER)!r} not configured")
        return tier.get(oi.internal.get(META_KEY, ""))

    def restore(self, bucket: str, oi, days: int) -> None:
        """POST ?restore: materialize a local copy for ``days`` days; the
        transition pointer stays so the scanner can re-stub on expiry."""
        if not is_transitioned(oi):
            raise dt.InvalidRequest(bucket, oi.name,
                                    "object is not transitioned")
        data = self.read(oi)
        meta = dict(oi.user_defined)
        meta.update({
            "etag": oi.etag,
            "content-type": oi.content_type,
            META_TIER: oi.internal[META_TIER],
            META_KEY: oi.internal[META_KEY],
            META_SIZE: oi.internal.get(META_SIZE, str(len(data))),
            META_RESTORE: str(time.time() + max(1, days) * 86400),
        })
        self.obj.put_object(bucket, oi.name, io.BytesIO(data), len(data),
                            ObjectOptions(user_defined=meta))
        self.restored += 1
        metrics.inc("minio_tpu_ilm_restored_total")

    def extend_restore(self, bucket: str, oi, days: int) -> None:
        """An already-restored copy only needs its expiry metadata bumped
        — no tier round-trip."""
        self.obj.update_object_meta(
            bucket, oi.name,
            {META_RESTORE: str(time.time() + max(1, days) * 86400)})

    def delete_remote(self, oi) -> None:
        """Drop the tier copy when its owning object is expired/deleted —
        the tier key lives only in the stub's metadata, so this is the
        last chance to reclaim the tier space."""
        tier = self.tiers.get(oi.internal.get(META_TIER, ""))
        if tier is not None:
            tier.remove(oi.internal.get(META_KEY, ""))

    def maybe_restub(self, bucket: str, oi) -> bool:
        """Scanner hook: a restored copy whose window lapsed goes back to
        a stub (the tier still holds the bytes — no re-upload)."""
        if not is_transitioned(oi) or oi.size == 0:
            return False
        if is_restored(oi):
            return False
        if META_RESTORE not in oi.internal:
            return False  # a stub or a non-restored copy
        meta = dict(oi.user_defined)
        meta.update({
            "etag": oi.etag,
            "content-type": oi.content_type,
            META_TIER: oi.internal[META_TIER],
            META_KEY: oi.internal[META_KEY],
            META_SIZE: oi.internal.get(META_SIZE, str(oi.size)),
        })
        self.obj.put_object(bucket, oi.name, io.BytesIO(b""), 0,
                            ObjectOptions(user_defined=meta))
        return True
