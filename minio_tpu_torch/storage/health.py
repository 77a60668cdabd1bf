"""Per-disk health tracking, the port of minio_tpu/storage/health.py
(reference cmd/xl-storage-disk-id-check.go's ``diskHealthTracker`` /
``diskHealthCheckOK``): a StorageAPI wrapper that scores every operation
(consecutive non-benign errors, a post-hoc op deadline: an op slower than
the deadline counts as a timeout, and a latency EWMA) and **trips** the
disk to ``faulty`` after N consecutive failures. A tripped disk answers
every call with ``DiskNotFound`` at once (no inner I/O), so quorum math
and the metadata fan-outs route around it in microseconds instead of
stalling a whole GET or PUT on one sick drive. A cooldown probe (stat,
small write, delete: the reference's ``diskHealthCheckOK``) re-onlines the
disk and fires the registered state listeners (the server nudges the
auto-heal monitor from one, so objects written while the disk was down get
rebuilt).

Semantic errors (FileNotFound, VolumeExists, FileCorrupt, ...) are
*benign*: the disk answered, the answer was just "no". Only transport or
media failures (FaultyDisk, DiskAccessDenied, DiskNotFound raised below
us, unexpected exceptions) and deadline breaches count toward the trip.
FileCorrupt is benign here: bitrot is the data's problem and goes to the
MRF's deep heal, not a reason to fence the drive.

Every disk call of the data path passes through one delegate here, and
each shard reader through ``_ScoredReadAt``, whose ``read_at`` is scored
and whose other attributes (``close``) pass through to the disk's reader.

Knobs, config subsystem ``health`` (env > stored > default), read when a
disk is wrapped:

* ``MINIO_TPU_HEALTH``             -- "0" disables wrapping entirely.
* ``MINIO_TPU_HEALTH_TRIP``        -- consecutive failures to trip (4).
* ``MINIO_TPU_HEALTH_DEADLINE_MS`` -- per-op deadline (2000).
* ``MINIO_TPU_HEALTH_COOLDOWN_S``  -- probe cadence while tripped (5).
"""
from __future__ import annotations

import threading
import time
import uuid

from ..obs import metrics as _mx
from ..obs import trace as _trc
from ..utils import errors
from .interface import StorageAPI
from .xlstorage import META_BUCKET

STATE_OK = "ok"
STATE_FAULTY = "faulty"

#: errors that mean "the disk answered": they never count toward a trip
BENIGN_ERRS = (
    errors.FileNotFound, errors.FileVersionNotFound,
    errors.FileNameTooLong, errors.FileAccessDenied, errors.FileCorrupt,
    errors.IsNotRegular, errors.VolumeNotFound, errors.VolumeExists,
    errors.VolumeNotEmpty, errors.MethodNotSupported, errors.LessData,
    errors.MoreData,
)

_DELEGATED = [
    "disk_info", "make_vol", "make_vols", "list_vols", "stat_vol",
    "delete_vol", "list_dir", "read_all", "write_all", "append_file",
    "create_file_writer", "rename_file", "delete_path",
    "stat_file_size", "rename_data", "write_metadata", "update_metadata",
    "read_version", "list_versions", "delete_version", "delete_versions",
    "check_parts", "verify_file", "walk_dir", "walk_versions",
]  # read_file_at is overridden explicitly: its reads need scoring too

#: EWMA smoothing for the per-disk latency score (~20-op memory)
_EWMA_ALPHA = 0.1


def _knob(key: str) -> str:
    """health.<key> through the config registry (env > stored > default),
    so admin-set values hold for every layer wrapped after config load."""
    from ..config import get_config_sys
    return get_config_sys().get("health", key)


class DiskHealthCheck(StorageAPI):
    """Health-scoring StorageAPI wrapper. Transparent passthrough while
    healthy; fast-fail ``DiskNotFound`` while tripped."""

    def __init__(self, inner, trip_threshold: int | None = None,
                 deadline_s: float | None = None,
                 cooldown_s: float | None = None):
        self.inner = inner
        self.trip_threshold = trip_threshold if trip_threshold is not None \
            else int(_knob("trip_threshold"))
        self.deadline_s = deadline_s if deadline_s is not None \
            else float(_knob("deadline_ms")) / 1e3
        self.cooldown_s = cooldown_s if cooldown_s is not None \
            else float(_knob("cooldown_s"))
        self._lock = threading.Lock()
        self._state = STATE_OK
        self._consecutive = 0
        self._tripped_at = 0.0
        self._probe_thread: threading.Thread | None = None
        self._closed = threading.Event()
        self.ewma_s = 0.0
        self.total_errors = 0
        self.total_timeouts = 0
        self.trips = 0
        #: fns called with (self, new_state) on trip / re-online
        self.state_listeners: list = []

    # -- identity / passthrough -----------------------------------------------

    def endpoint(self) -> str:
        return self.inner.endpoint()

    def is_local(self) -> bool:
        return self.inner.is_local()

    def is_online(self) -> bool:
        return self._state == STATE_OK and self.inner.is_online()

    def get_disk_id(self) -> str:
        return self.inner.get_disk_id()

    def set_disk_id(self, disk_id: str) -> None:
        self.inner.set_disk_id(disk_id)

    def close(self) -> None:
        self._closed.set()
        self.inner.close()

    def read_file_at(self, volume: str, path: str):
        """Scored like any delegated op, and the returned reader's
        per-shard ``read_at`` calls are scored too (_ScoredReadAt)."""
        if self._state != STATE_OK:
            self._fail_fast()
        t0 = time.monotonic()
        try:
            reader = self.inner.read_file_at(volume, path)
        except BENIGN_ERRS:
            self._record(True, time.monotonic() - t0, False)
            raise
        except BaseException:
            dur = time.monotonic() - t0
            self._record(False, dur, dur > self.deadline_s)
            raise
        self._record(True, time.monotonic() - t0, False)
        return _ScoredReadAt(reader, self)

    def __getattr__(self, name: str):
        # anything not delegated or overridden (XLStorage.root, sweep_tmp,
        # reconcile_object, walk_unjournaled) falls through to the disk
        if name == "inner":  # not set yet: avoid recursing into ourselves
            raise AttributeError(name)
        return getattr(self.inner, name)

    # -- health score ---------------------------------------------------------

    def health_state(self) -> str:
        return self._state

    def healthy(self) -> bool:
        return self._state == STATE_OK

    def health_stats(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive,
                    "ewma_ms": round(self.ewma_s * 1e3, 3),
                    "total_errors": self.total_errors,
                    "total_timeouts": self.total_timeouts,
                    "trips": self.trips}

    def _fail_fast(self):
        raise errors.DiskNotFound(
            f"{self.endpoint()}: health-tripped "
            f"({self._consecutive} consecutive failures)")

    def _record(self, ok: bool, dur_s: float, timeout: bool):
        fire = False
        with self._lock:
            self.ewma_s += _EWMA_ALPHA * (dur_s - self.ewma_s)
            if ok and not timeout:
                self._consecutive = 0
                return
            if timeout:
                self.total_timeouts += 1
            else:
                self.total_errors += 1
            self._consecutive += 1
            if self._consecutive >= self.trip_threshold and \
                    self._state == STATE_OK:
                self._state = STATE_FAULTY
                self._tripped_at = time.monotonic()
                self.trips += 1
                fire = True
        if fire:
            self._on_trip()

    def _on_trip(self):
        _mx.inc("minio_tpu_disk_trips_total", disk=self.endpoint())
        try:
            _trc.publish_storage(node=self.endpoint(), op="health.trip",
                                 path="", duration_s=0.0,
                                 error="disk tripped to faulty")
        except Exception:  # noqa: BLE001
            pass
        self._notify(STATE_FAULTY)
        t = threading.Thread(target=self._probe_loop, daemon=True,
                             name=f"disk-health-{self.endpoint()}")
        self._probe_thread = t
        t.start()

    def _notify(self, state: str):
        for fn in list(self.state_listeners):
            try:
                fn(self, state)
            except Exception:  # noqa: BLE001 — listeners are best-effort
                pass

    # -- cooldown probe -------------------------------------------------------

    def _probe_ok(self) -> bool:
        """The reference's diskHealthCheckOK: stat the disk, then prove
        writes land (a write and delete under the system volume). The
        probe file sits at the volume's top: the JAX package's probe
        writes under ``tmp/``, and the delete's pruning of empty parents
        then removes ``.minio.sys/tmp``, where every later write_all
        stages, so the re-onlined disk's healing tracker cannot be set."""
        try:
            self.inner.disk_info()
            name = f".health-probe-{uuid.uuid4().hex[:8]}"
            self.inner.write_all(META_BUCKET, name, b"health-check")
            self.inner.delete_path(META_BUCKET, name)
            return True
        except Exception:  # noqa: BLE001 — still sick
            return False

    def _probe_loop(self):
        while not self._closed.wait(self.cooldown_s):
            if self._state == STATE_OK:
                return
            if not self._probe_ok():
                continue
            with self._lock:
                self._state = STATE_OK
                self._consecutive = 0
            _mx.inc("minio_tpu_disk_reonline_total", disk=self.endpoint())
            self._notify(STATE_OK)
            return


class _ScoredReadAt:
    """Wraps the reader ``read_file_at`` returns, so the per-shard
    ``read_at`` calls (the dominant data-path I/O) feed the same deadline,
    EWMA and consecutive-failure score as every other op. Everything else
    (``close``) passes through."""

    __slots__ = ("_inner", "_h")

    def __init__(self, inner, health: DiskHealthCheck):
        self._inner = inner
        self._h = health

    def read_at(self, offset: int, length: int) -> bytes:
        h = self._h
        if h._state != STATE_OK:
            h._fail_fast()
        t0 = time.monotonic()
        try:
            out = self._inner.read_at(offset, length)
        except BENIGN_ERRS:
            h._record(True, time.monotonic() - t0, False)
            raise
        except BaseException:
            dur = time.monotonic() - t0
            h._record(False, dur, dur > h.deadline_s)
            raise
        dur = time.monotonic() - t0
        h._record(True, dur, dur > h.deadline_s)
        return out

    def __getattr__(self, name: str):
        return getattr(self._inner, name)


def _make_delegate(name: str):
    def call(self, *args, **kwargs):
        if self._state != STATE_OK:
            self._fail_fast()
        t0 = time.monotonic()
        try:
            out = getattr(self.inner, name)(*args, **kwargs)
        except BENIGN_ERRS:
            self._record(True, time.monotonic() - t0, False)
            raise
        except BaseException:
            dur = time.monotonic() - t0
            self._record(False, dur, dur > self.deadline_s)
            raise
        dur = time.monotonic() - t0
        self._record(True, dur, dur > self.deadline_s)
        return out

    call.__name__ = name
    return call


for _name in _DELEGATED:
    setattr(DiskHealthCheck, _name, _make_delegate(_name))
# the delegates land after class creation, so the ABC machinery computed
# abstractmethods before they existed: clear it now that they do
DiskHealthCheck.__abstractmethods__ = frozenset()


def enabled() -> bool:
    return _knob("enable") not in ("0", "off")


def wrap_disks(disks: list) -> list:
    """Wrap each live disk in a DiskHealthCheck (idempotent: an already
    wrapped disk passes through; None slots stay None). Off with
    MINIO_TPU_HEALTH=0."""
    if not enabled():
        return list(disks)
    return [d if d is None or isinstance(d, DiskHealthCheck)
            else DiskHealthCheck(d) for d in disks]
