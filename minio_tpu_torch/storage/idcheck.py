"""Disk-ID-checking StorageAPI wrapper, the port of
minio_tpu/storage/idcheck.py (reference
cmd/xl-storage-disk-id-check.go): every call first verifies the disk still
carries the identity its slot expects — a disk that was swapped, wiped, or
re-slotted behind the process's back fails fast as DiskNotFound instead of
silently serving another slot's shards — and tracks a rolling health
state so callers can route around a flapping disk."""
from __future__ import annotations

import threading
import time

from ..utils import errors
from .interface import StorageAPI

#: consecutive failures before the disk reports unhealthy
FAULT_THRESHOLD = 8
#: seconds between physical disk-id re-reads (the check itself must not
#: double every call's IO)
ID_CHECK_INTERVAL_S = 5.0

_DELEGATED = [
    "disk_info", "endpoint", "is_local", "is_online", "close",
    "make_vol", "make_vols", "list_vols", "stat_vol", "delete_vol",
    "list_dir", "read_all", "write_all", "append_file",
    "create_file_writer", "read_file_at", "rename_file", "delete_path",
    "stat_file_size", "rename_data", "write_metadata", "update_metadata",
    "read_version", "list_versions", "delete_version", "delete_versions",
    "check_parts", "verify_file", "walk_dir", "walk_versions",
]


class DiskIDCheck(StorageAPI):
    """Wrap ``inner`` so every operation is gated on the stored disk id
    matching ``expected_id``."""

    def __init__(self, inner, expected_id: str = ""):
        self.inner = inner
        self.expected_id = expected_id or inner.get_disk_id()
        self._lock = threading.Lock()
        self._last_check = 0.0
        self._last_ok = True
        self._consecutive_failures = 0
        self.total_errors = 0

    # -- identity -------------------------------------------------------------

    def get_disk_id(self) -> str:
        return self.inner.get_disk_id()

    def set_disk_id(self, disk_id: str) -> None:
        self.inner.set_disk_id(disk_id)
        self.expected_id = disk_id

    def _physical_id(self) -> str:
        """The identity actually ON the disk (format.json's xl.this) — an
        in-memory attribute would miss a disk swapped or wiped behind the
        process's back, which is this wrapper's whole purpose."""
        from ..dist.format import load_format
        try:
            return load_format(self.inner).get("xl", {}).get("this", "")
        except errors.UnformattedDisk:
            return ""  # wiped

    def _check_id(self):
        if not self.expected_id:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_check < ID_CHECK_INTERVAL_S:
                if not self._last_ok:
                    raise errors.DiskNotFound(
                        f"{self.inner.endpoint()}: stale disk id")
                return
            self._last_check = now
        ok = self._physical_id() == self.expected_id
        with self._lock:
            self._last_ok = ok
        if not ok:
            raise errors.DiskNotFound(
                f"{self.inner.endpoint()}: disk id changed "
                f"(expected {self.expected_id})")

    # -- health ---------------------------------------------------------------

    def healthy(self) -> bool:
        with self._lock:
            return self._consecutive_failures < FAULT_THRESHOLD and \
                self._last_ok

    def _record(self, ok: bool):
        with self._lock:
            if ok:
                self._consecutive_failures = 0
            else:
                self._consecutive_failures += 1
                self.total_errors += 1


def _make_delegate(name: str):
    def call(self, *args, **kwargs):
        self._check_id()
        try:
            out = getattr(self.inner, name)(*args, **kwargs)
        except Exception:
            self._record(False)
            raise
        self._record(True)
        return out

    call.__name__ = name
    return call


for _name in _DELEGATED:
    setattr(DiskIDCheck, _name, _make_delegate(_name))
# the delegates land after class creation, so the ABC machinery computed
# abstractmethods before they existed — clear it now that they do
DiskIDCheck.__abstractmethods__ = frozenset()
