"""dsync, the port of minio_tpu/dist/dsync.py — distributed RW locks by
quorum consensus (reference pkg/dsync:
DRWMutex broadcasts Lock RPCs to ALL lockers; write lock needs quorum
n/2+1, read lock n/2; on failed quorum every acquired lock is released
asynchronously; lock maintenance expires orphans by asking the owner
(drwmutex.go:49-348, cmd/lock-rest-server.go:257). ``NSLockMap`` also
keeps the wall seconds of its locks' acquisitions (``LockStats``), which
the distributed node reports."""
from __future__ import annotations

import random
import threading
import time
import uuid
from collections import deque

from ..utils.dyntimeout import DynamicTimeout

#: shared lock-acquisition timeout (reference globalOperationTimeout,
#: cmd/server-main.go: 10 min default, 5 min floor). The generous floor
#: matters: decay is driven by *successful* acquisition times (usually
#: milliseconds), and a floor near that would make any lock legitimately
#: held longer than the floor fail its competitors spuriously.
OPERATION_TIMEOUT = DynamicTimeout(600.0, 300.0)

#: reference quorum rule (drwmutex.go:160-171)


def write_quorum(n: int) -> int:
    return n // 2 + 1


def read_quorum(n: int) -> int:
    return n // 2


class LocalLocker:
    """Per-node lock table (reference cmd/local-locker.go): entries keyed by
    resource, each holding owner/uid/rw state. NetLocker surface: lock,
    unlock, rlock, runlock, expired, force_unlock.

    Entries carry two clocks: ``ts`` (wall — display ordering in
    ``dump``) and ``ts_mono`` (monotonic — ALL age math: lease checks
    and the stale sweep), so an NTP step can never mass-expire live
    locks (GL001's duration rule)."""

    def __init__(self):
        self._lock = threading.Lock()
        #: resource -> list of {uid, owner, writer: bool, ts, ts_mono}
        self._table: dict[str, list[dict]] = {}

    @staticmethod
    def _entry(uid: str, owner: str, writer: bool) -> dict:
        # ts_mono is the LEASE clock (touch() renews it); acq_mono is
        # the acquisition instant and never moves — it caps how long
        # maintenance will keep renewing, so a leaked lock self-heals
        now = time.monotonic()
        return {"uid": uid, "owner": owner, "writer": writer,
                "ts": time.time(), "ts_mono": now, "acq_mono": now}

    def lock(self, resource: str, uid: str, owner: str) -> bool:
        with self._lock:
            if self._table.get(resource):
                return False
            self._table[resource] = [self._entry(uid, owner, True)]
            return True

    def unlock(self, resource: str, uid: str) -> bool:
        with self._lock:
            entries = self._table.get(resource, [])
            keep = [e for e in entries if e["uid"] != uid or not e["writer"]]
            if len(keep) == len(entries):
                return False
            if keep:
                self._table[resource] = keep
            else:
                self._table.pop(resource, None)
            return True

    def rlock(self, resource: str, uid: str, owner: str) -> bool:
        with self._lock:
            entries = self._table.get(resource, [])
            if any(e["writer"] for e in entries):
                return False
            entries = self._table.setdefault(resource, [])
            entries.append(self._entry(uid, owner, False))
            return True

    def runlock(self, resource: str, uid: str) -> bool:
        with self._lock:
            entries = self._table.get(resource, [])
            for i, e in enumerate(entries):
                if e["uid"] == uid and not e["writer"]:
                    entries.pop(i)
                    if not entries:
                        self._table.pop(resource, None)
                    return True
            return False

    def expired(self, resource: str, uid: str) -> bool:
        """Does this node still hold (resource, uid)? Used by peers'
        maintenance loops."""
        with self._lock:
            return not any(e["uid"] == uid
                           for e in self._table.get(resource, []))

    def dump(self) -> list[dict]:
        """Current lock table, oldest first (admin top-locks,
        cmd/admin-handlers.go TopLocksHandler)."""
        with self._lock:
            out = [{"resource": r,
                    **{k: v for k, v in e.items() if k != "ts_mono"}}
                   for r, entries in self._table.items() for e in entries]
        return sorted(out, key=lambda e: e["ts"])

    def force_unlock(self, resource: str) -> bool:
        with self._lock:
            return self._table.pop(resource, None) is not None

    # -- maintenance surface (dist.lock_rest.LockRESTService) ---------------

    def entries_older_than(self, age_s: float) -> list[tuple]:
        """(resource, uid, owner) of entries held longer than ``age_s``
        (monotonic age) — the maintenance loop's lease-check set."""
        cutoff = time.monotonic() - age_s
        with self._lock:
            return [(r, e["uid"], e["owner"])
                    for r, entries in self._table.items()
                    for e in entries if e["ts_mono"] <= cutoff]

    def touch(self, resource: str, uid: str) -> bool:
        """Renew an entry's lease (its owner confirmed it still holds).
        The acquisition instant (``acq_mono``) is deliberately NOT
        moved — ``held_longer_than`` measures total hold time."""
        now = time.monotonic()
        with self._lock:
            hit = False
            for e in self._table.get(resource, []):
                if e["uid"] == uid:
                    e["ts_mono"] = now
                    hit = True
            return hit

    def held_longer_than(self, resource: str, uid: str,
                         age_s: float) -> bool:
        """Has (resource, uid) been held — across all lease renewals —
        longer than ``age_s``? Caps maintenance renewals so a LEAKED
        lock (holder died without unlock) still self-heals."""
        cutoff = time.monotonic() - age_s
        with self._lock:
            return any(e["uid"] == uid and
                       e.get("acq_mono", e["ts_mono"]) <= cutoff
                       for e in self._table.get(resource, []))

    def remove_entry(self, resource: str, uid: str) -> bool:
        """Reclaim one entry regardless of rw state (maintenance only —
        the normal paths go through unlock/runlock)."""
        with self._lock:
            entries = self._table.get(resource, [])
            keep = [e for e in entries if e["uid"] != uid]
            if len(keep) == len(entries):
                return False
            if keep:
                self._table[resource] = keep
            else:
                self._table.pop(resource, None)
            return True

    def stale_sweep(self, max_age_s: float = 300.0) -> int:
        """Age-only backstop for entries with no routable owner: drop
        entries older than max_age_s (MONOTONIC age — an NTP step
        cannot mass-expire live locks). Returns the number dropped."""
        cutoff = time.monotonic() - max_age_s
        dropped = 0
        with self._lock:
            for res in list(self._table):
                keep = [e for e in self._table[res]
                        if e["ts_mono"] > cutoff]
                dropped += len(self._table[res]) - len(keep)
                if keep:
                    self._table[res] = keep
                else:
                    del self._table[res]
        return dropped

    def snapshot(self) -> dict:
        with self._lock:
            return {k: list(v) for k, v in self._table.items()}


class DRWMutex:
    """Distributed RW mutex over N lockers (local or lock-REST clients with
    the NetLocker surface). Usage:

        mtx = DRWMutex(lockers, "bucket/object", owner="node1")
        if mtx.get_lock(timeout=5.0): ... mtx.unlock()
    """

    def __init__(self, lockers: list, resource: str, owner: str = "",
                 stats: "LockStats | None" = None):
        self.lockers = lockers
        self.resource = resource
        self.owner = owner or str(uuid.uuid4())
        #: where acquisitions are recorded (the namespace map's)
        self.stats = stats
        self.uid = ""
        self._held: list[int] = []
        self._is_write = False
        #: set by refresh() when the held quorum evaporated (the
        #: minority side of a partition) — the holder must abort
        self.lost = False
        self._refresh_stop: threading.Event | None = None

    # -- acquisition ---------------------------------------------------------

    def get_lock(self, timeout: float | None = None) -> bool:
        return self._acquire(timeout, writer=True)

    def get_rlock(self, timeout: float | None = None) -> bool:
        return self._acquire(timeout, writer=False)

    def _acquire(self, timeout: float | None, writer: bool) -> bool:
        # no explicit timeout -> the self-adapting operation timeout
        # (reference globalOperationTimeout, cmd/dynamic-timeouts.go):
        # raised 25% when >33% of recent acquisitions time out, decayed
        # toward the slowest recent success otherwise
        dyn = OPERATION_TIMEOUT if timeout is None else None
        if timeout is None:
            timeout = dyn.timeout()
        start = time.monotonic()
        deadline = start + timeout
        n = len(self.lockers)
        quorum = write_quorum(n) if writer else read_quorum(n)
        quorum = max(quorum, 1)
        tries = 0
        while True:
            uid = str(uuid.uuid4())
            granted: list[int] = []
            for i, lk in enumerate(self.lockers):
                try:
                    ok = (lk.lock(self.resource, uid, self.owner) if writer
                          else lk.rlock(self.resource, uid, self.owner))
                except Exception:  # noqa: BLE001 — offline locker = no vote
                    ok = False
                if ok:
                    granted.append(i)
            if len(granted) >= quorum:
                self.uid = uid
                self._held = granted
                self._is_write = writer
                self.lost = False
                if dyn is not None:
                    dyn.log_success(time.monotonic() - start)
                if self.stats is not None:
                    self.stats.record(time.monotonic() - start, True)
                return True
            # failed quorum: release every acquired lock ASYNC
            # (drwmutex.go:297) — a slow/offline locker must not stall
            # the retry cadence while the partial grant blocks peers
            if granted:
                threading.Thread(
                    target=self._release, args=(granted, uid, writer),
                    daemon=True, name="dsync-release").start()
            if time.monotonic() >= deadline:
                if dyn is not None:
                    dyn.log_failure()
                if self.stats is not None:
                    self.stats.record(time.monotonic() - start, False)
                return False
            # jittered exponential backoff (reference lock retry:
            # drwmutex.go lockRetryMinInterval ramp): contenders
            # de-synchronize AND back off a partitioned majority
            tries += 1
            delay = min(0.25, 0.008 * (1 << min(tries, 5)))
            time.sleep(delay * (0.5 + random.random()))

    def _release(self, indices: list[int], uid: str, writer: bool):
        for i in indices:
            try:
                if writer:
                    self.lockers[i].unlock(self.resource, uid)
                else:
                    self.lockers[i].runlock(self.resource, uid)
            except Exception:  # noqa: BLE001 — an unreachable locker
                # keeps its entry; the owner-driven maintenance loop
                # reclaims it, and the counter keeps the leak visible
                from ..obs import metrics as mx
                mx.inc("minio_tpu_dsync_release_failures_total")

    def unlock(self):
        self.stop_refresh()
        self._release(self._held, self.uid, self._is_write)
        self._held = []

    runlock = unlock

    # -- lease refresh (release-on-partition) --------------------------------

    def refresh(self) -> bool:
        """Verify the held lock still commands quorum (reference
        drwmutex.go startContinuousLockRefresh): every held locker is
        asked whether (resource, uid) survives — an unreachable locker
        is NO vote. Below quorum the holder is on the minority side of
        a partition (or its entries were reclaimed): every reachable
        entry is released, ``lost`` is set, and the caller must abort
        rather than keep writing under a phantom lock."""
        if not self._held:
            return False
        alive: list[int] = []
        for i in self._held:
            lk = self.lockers[i]
            probe = getattr(lk, "expired_info", None)
            try:
                if probe is not None:
                    exp = probe(self.resource, self.uid)
                    still = exp is False  # None (unreachable) = no vote
                else:
                    still = not lk.expired(self.resource, self.uid)
            except Exception:  # noqa: BLE001 — unreachable = no vote
                still = False
            if still:
                alive.append(i)
        n = len(self.lockers)
        quorum = max(write_quorum(n) if self._is_write
                     else read_quorum(n), 1)
        if len(alive) >= quorum:
            return True
        from ..obs import metrics as mx
        mx.inc("minio_tpu_dsync_refresh_lost_total")
        held, uid, writer = self._held, self.uid, self._is_write
        self._held = []
        self.lost = True
        self.stop_refresh()
        # release whatever is still reachable so the majority side
        # never waits out a lease on OUR phantom entries
        threading.Thread(target=self._release, args=(held, uid, writer),
                         daemon=True, name="dsync-release").start()
        return False

    def start_refresh(self, interval_s: float = 5.0) -> None:
        """Background lease refresher for long-held locks (heal walks,
        admin ops): calls :meth:`refresh` every ``interval_s`` until
        unlock/lost. Short-lived commit locks don't need one."""
        if self._refresh_stop is not None:
            return
        stop = threading.Event()
        self._refresh_stop = stop

        def loop():
            while not stop.wait(interval_s):
                if not self._held or not self.refresh():
                    return
        threading.Thread(target=loop, daemon=True,
                         name="dsync-refresh").start()

    def stop_refresh(self) -> None:
        stop = self._refresh_stop
        if stop is not None:
            self._refresh_stop = None
            stop.set()


class LockStats:
    """Acquisition walls of one namespace map's locks: the last
    ``window`` successful acquisitions' seconds, and the counts of
    acquisitions and of timed-out attempts."""

    def __init__(self, window: int = 8192):
        self._lock = threading.Lock()
        self._seconds: deque = deque(maxlen=window)
        self.acquired = 0
        self.timed_out = 0

    def record(self, seconds: float, ok: bool) -> None:
        with self._lock:
            if ok:
                self.acquired += 1
                self._seconds.append(seconds)
            else:
                self.timed_out += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"acquired": self.acquired, "timed_out": self.timed_out,
                    "seconds": list(self._seconds)}


class NSLockMap:
    """Namespace lock map (reference cmd/namespace-lock.go): bucket/object →
    DRWMutex over the configured lockers (local-only list in standalone
    mode, lock-REST clients in distributed mode)."""

    def __init__(self, lockers_fn, owner: str):
        self.lockers_fn = lockers_fn  # () -> list of NetLockers
        self.owner = owner
        self.stats = LockStats()

    def new_lock(self, bucket: str, *objects: str) -> DRWMutex:
        resource = "/".join([bucket, *objects])
        return DRWMutex(self.lockers_fn(), resource, self.owner, self.stats)
