"""Lock REST service and client, the port of minio_tpu/dist/lock_rest.py
(reference cmd/lock-rest-server.go /
lock-rest-client.go): the NetLocker surface over the generic RPC transport,
plus the maintenance loop that expires orphaned locks by checking back with
their owners (lock-rest-server.go:257 lockMaintenance): an entry older
than the lease interval is verified against its OWNER — still held
renews the lease, released reclaims immediately, and an unreachable
owner is reclaimed after ``OWNER_DEAD_STRIKES`` consecutive failed
checks, so a SIGKILL'd node's locks free up within one lease interval
instead of pinning the namespace for the stale-sweep age."""
from __future__ import annotations

import os
import threading

from .dsync import LocalLocker
from .rpc import RPCClient

LOCK_MAINTENANCE_INTERVAL_S = float(os.environ.get(
    "MINIO_TPU_LOCK_MAINT_S", "10"))
#: consecutive owner-unreachable maintenance checks before reclaim; the
#: effective lease interval for a dead owner's locks is
#: maintenance interval x (1 + OWNER_DEAD_STRIKES)
OWNER_DEAD_STRIKES = 2
#: renewal cap: maintenance stops renewing an entry held longer than
#: this, so a LEAKED lock (holder died without unlock — exception path
#: bug, killed thread) self-heals via the stale sweep instead of
#: pinning the namespace forever; size it above the longest legitimate
#: hold (heal walks, admin ops)
MAX_HOLD_S = float(os.environ.get("MINIO_TPU_LOCK_MAX_HOLD_S", "3600"))


class LockRESTClient:
    """NetLocker over RPC."""

    def __init__(self, node_url: str, secret: str, src: str = ""):
        self.url = node_url.rstrip("/")
        self.rpc = RPCClient(node_url, "lock", secret, src=src)

    def _call(self, method, resource, uid, owner="") -> bool:
        try:
            out = self.rpc.call(method, {"resource": resource, "uid": uid,
                                         "owner": owner})
            return out == b"1"
        except Exception:  # noqa: BLE001 — offline locker grants nothing
            return False

    def lock(self, resource, uid, owner):
        return self._call("lock", resource, uid, owner)

    def unlock(self, resource, uid):
        return self._call("unlock", resource, uid)

    def rlock(self, resource, uid, owner):
        return self._call("rlock", resource, uid, owner)

    def runlock(self, resource, uid):
        return self._call("runlock", resource, uid)

    def expired(self, resource, uid):
        return self._call("expired", resource, uid)

    def expired_info(self, resource, uid) -> bool | None:
        """Tri-state expiry probe for the maintenance loop: True = the
        owner no longer holds (reclaim now), False = still held
        (renew the lease), None = owner unreachable (strike)."""
        try:
            return self.rpc.call(
                "expired", {"resource": resource, "uid": uid,
                            "owner": ""}) == b"1"
        except Exception:  # noqa: BLE001 — transport-class: unknown
            return None

    def force_unlock(self, resource):
        return self._call("forceunlock", resource, "")

    def is_online(self):
        return self.rpc.is_online()


class LockRESTService:
    """Server side: the node's LocalLocker over RPC + maintenance.

    ``owner_lockers_fn`` (set by the Node) returns ``{owner_url:
    NetLocker}`` clients so the maintenance loop can ask an entry's
    owner whether it still holds — ``local_owner`` names this node's
    own URL (its entries are authoritative and never checked)."""

    def __init__(self, locker: LocalLocker | None = None,
                 owner_lockers_fn=None, local_owner: str = ""):
        self.locker = locker or LocalLocker()
        self.owner_lockers_fn = owner_lockers_fn
        self.local_owner = local_owner.rstrip("/")
        self._stop = threading.Event()
        self._maint_thread: threading.Thread | None = None
        #: (resource, uid) -> consecutive owner-unreachable checks
        self._strikes: dict[tuple, int] = {}

    def handle(self, method: str, params: dict, body: bytes) -> bytes:
        res = params.get("resource", "")
        uid = params.get("uid", "")
        owner = params.get("owner", "")
        if method == "lock":
            ok = self.locker.lock(res, uid, owner)
        elif method == "unlock":
            ok = self.locker.unlock(res, uid)
        elif method == "rlock":
            ok = self.locker.rlock(res, uid, owner)
        elif method == "runlock":
            ok = self.locker.runlock(res, uid)
        elif method == "expired":
            ok = self.locker.expired(res, uid)
        elif method == "forceunlock":
            ok = self.locker.force_unlock(res)
        elif method == "toplocks":
            import json
            return json.dumps(self.locker.snapshot()).encode()
        else:
            from ..utils import errors
            raise errors.MethodNotSupported(method)
        return b"1" if ok else b"0"

    def start_maintenance(self, interval_s: float | None = None):
        if interval_s is None:
            interval_s = LOCK_MAINTENANCE_INTERVAL_S

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.maintenance_pass(interval_s)
                except Exception as e:  # noqa: BLE001 — the loop must
                    # survive a flaky peer, but not silently (GL007)
                    from ..obs.logger import log_sys
                    log_sys().log_once(
                        f"lock-maint:{type(e).__name__}", "warning",
                        "dsync", f"lock maintenance pass failed: {e!r}")
        t = threading.Thread(target=loop, daemon=True,
                             name="lock-maintenance")
        self._maint_thread = t
        t.start()

    def maintenance_pass(self, lease_s: float | None = None) -> int:
        """One maintenance sweep (reference lockMaintenance): verify
        every entry older than ``lease_s`` with its owner. Returns the
        number of entries reclaimed. Owner verdicts:

        * released (``expired`` -> True): reclaim now,
        * still held: renew the entry's lease (its age resets — a
          long-lived legitimate lock is never stale-swept),
        * unreachable: strike; ``OWNER_DEAD_STRIKES`` consecutive
          strikes reclaim (the dead-node path).

        Entries whose owner has no locker client (standalone /
        library topologies) fall back to the age-only stale sweep.
        """
        from ..obs import metrics as mx
        if lease_s is None:
            lease_s = LOCK_MAINTENANCE_INTERVAL_S
        owners = {}
        if self.owner_lockers_fn is not None:
            try:
                owners = {u.rstrip("/"): c
                          for u, c in self.owner_lockers_fn().items()}
            except Exception:  # noqa: BLE001 — topology mid-rebuild
                owners = {}
        reclaimed = 0
        live_keys = set()
        for res, uid, owner in self.locker.entries_older_than(lease_s):
            owner = (owner or "").rstrip("/")
            key = (res, uid)
            live_keys.add(key)
            if owner and owner == self.local_owner:
                # our own entry: we ARE the authority, and its presence
                # in the table means the lock is still held (unlock
                # removes it) — renew the lease so the age-only stale
                # sweep below can never reclaim a live local lock and
                # cascade owner_released reclaims across the peers.
                # Renewal is CAPPED at MAX_HOLD_S total hold time: a
                # leaked entry (holder died without unlock) must still
                # self-heal via the stale sweep
                if not self.locker.held_longer_than(res, uid, MAX_HOLD_S):
                    self.locker.touch(res, uid)
                continue
            client = owners.get(owner)
            if client is None:
                # no route to the owner (standalone lockers, unknown
                # owner string): age-only reclaim at the stale age
                continue
            exp = client.expired_info(res, uid)
            if exp is False:
                self.locker.touch(res, uid)  # lease renewed
                self._strikes.pop(key, None)
                continue
            if exp is True:
                if self.locker.remove_entry(res, uid):
                    reclaimed += 1
                    mx.inc("minio_tpu_dsync_reclaimed_total",
                           reason="owner_released")
                self._strikes.pop(key, None)
                continue
            # unreachable owner: strike toward the dead-node reclaim
            n = self._strikes.get(key, 0) + 1
            if n >= OWNER_DEAD_STRIKES:
                if self.locker.remove_entry(res, uid):
                    reclaimed += 1
                    mx.inc("minio_tpu_dsync_reclaimed_total",
                           reason="owner_dead")
                self._strikes.pop(key, None)
            else:
                self._strikes[key] = n
        # forget strikes for entries that vanished on their own
        for key in [k for k in self._strikes if k not in live_keys]:
            self._strikes.pop(key, None)
        # age-only backstop for ownerless/unroutable entries
        swept = self.locker.stale_sweep()
        if swept:
            mx.inc("minio_tpu_dsync_reclaimed_total", swept,
                   reason="stale_age")
        return reclaimed + swept

    def stop(self):
        self._stop.set()
