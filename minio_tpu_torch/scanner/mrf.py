"""MRF, the port of minio_tpu/scanner/mrf.py — the "most recently failed"
heal queue (reference cmd/erasure.go:74
mrfOpCh + addPartial, cmd/erasure-object.go:1132): operations that detect a
partial/degraded write or read enqueue the object here; a background worker
heals them. Queue is bounded and drop-oldest (heal is best-effort; the
scanner sweeps anything missed).

The queue optionally persists to a small journal
(``attach_persistence``) committed through ``durable_replace``, so heal
debt recorded before a crash is re-enqueued after reconstruction instead
of waiting for the next deep scanner cycle to rediscover it.

The queue + backoff-park + journal machinery is ``scanner.park.DebtQueue``;
this module keeps the heal worker (what "paying the debt" means for heal)
and the MRF-specific retry policy knobs. The journal's JSON is the JAX
package's, so either package recovers the other's ``mrf.json``. Heals run
on the object layer's device under ``qos.background()`` (background-class
dispatch work, tail-sampled against the background budget), and each
publishes an ``mrf.heal`` scanner trace while someone listens."""
from __future__ import annotations

import os
import threading
import time

from .. import qos
from ..obs import trace as _trc

from .park import FLUSH_INTERVAL_S, DebtQueue  # noqa: F401 — re-export

#: failed heals re-enqueue with exponential backoff instead of being
#: forgotten: a whole NODE being down fails every heal touching its
#: shards, and debt dropped after one attempt would sit invisible
#: until the next deep scanner cycle instead of draining on rejoin
RETRY_MAX = 8
RETRY_BASE_S = float(os.environ.get("MINIO_TPU_MRF_RETRY_BASE_S", "1.0"))
RETRY_CAP_S = 30.0


class _IncompleteHeal(Exception):
    """A heal pass finished but drives stayed offline/missing — the
    debt is unpaid (routes the result into the retry park)."""


def _debt_moot(e: BaseException) -> bool:
    """The object/bucket no longer exists: nothing to heal, retrying
    would only ladder through the full backoff for a churn-deleted
    key. (Typed object errors from objectlayer.datatypes.)"""
    return type(e).__name__ in ("ObjectNotFound", "VersionNotFound",
                                "BucketNotFound")


class MRFHealer:
    def __init__(self, objlayer, max_queue: int = 10_000):
        self.obj = objlayer
        self.dq = DebtQueue(max_queue=max_queue)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.healed = 0
        self.failed = 0

    @property
    def q(self):
        return self.dq.q

    @property
    def dropped(self) -> int:
        return self.dq.dropped

    def add_partial(self, bucket: str, object: str, version_id: str = "",
                    scan_mode: str = "normal"):
        """scan_mode='deep' when the enqueuer saw bitrot (a normal heal's
        size-only check would classify the disk as healthy). Overflow is
        drop-oldest; every lost entry counts in ``stats()['dropped']``."""
        self.dq.add(bucket, object, version_id, mode=scan_mode)

    def attach_persistence(self, path: str, load: bool = True) -> int:
        """Point the heal queue at its on-disk journal; an existing
        file's entries are re-enqueued (restart recovery). Returns the
        number of entries recovered."""
        return self.dq.attach_persistence(path, load=load)

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mrf-healer")
        self._thread.start()
        return self

    def stats(self) -> dict:
        return {"healed": self.healed, "failed": self.failed,
                **self.dq.stats()}

    def kick(self) -> None:
        """Promote every backoff-parked retry to runnable NOW — called
        when a peer node rejoins (rpc on_reconnect): the heal debt its
        absence created should drain immediately, not wait out the
        exponential backoff."""
        self.dq.kick()

    def _loop(self):
        while not self._stop.is_set():
            entry = self.dq.pop(timeout=0.5, repark_s=RETRY_BASE_S)
            if entry is None:
                continue
            # queue entries are 4-tuples; retry promotions carry a 5th
            # element with the attempt count
            bucket, object, version_id, scan_mode = entry[:4]
            attempt = entry[4] if len(entry) > 4 else 0
            t0 = time.perf_counter()
            err = ""
            try:
                # remove_dangling: an object deleted while a node was
                # down leaves quorum-lost junk that can never heal —
                # purging it IS paying the debt (reference healObject
                # dangling handling)
                with qos.background():
                    res = self.obj.heal_object(bucket, object, version_id,
                                               scan_mode=scan_mode,
                                               remove_dangling=True)
                # a heal that left any drive offline/missing/corrupt
                # did NOT pay the debt — a dead node's shards cannot be
                # rebuilt until it rejoins, so the entry must survive
                after = getattr(res, "after_state", None) or []
                if any(s != "ok" for s in after):
                    raise _IncompleteHeal(
                        [s for s in after if s != "ok"])
                self.healed += 1
            except Exception as e:  # noqa: BLE001
                self.failed += 1
                err = f"{type(e).__name__}: {e}"
                if attempt + 1 <= RETRY_MAX and not _debt_moot(e):
                    # park with backoff, KEEP the journal entry: the
                    # failure is usually an offline target (a dead
                    # node), and the debt must survive until rejoin
                    self.dq.park((bucket, object, version_id, scan_mode),
                                 attempt + 1, RETRY_BASE_S, RETRY_CAP_S)
                    self.dq.flush()
                    continue
            finally:
                _trc.publish_scanner(
                    func="mrf.heal", path=f"{bucket}/{object}",
                    duration_s=time.perf_counter() - t0, error=err)
                # retries exhausted (or the object is gone): the deep
                # scanner cycle re-finds anything still genuinely
                # degraded
            self.dq.settle((bucket, object, version_id))

    def flush_journal(self) -> None:
        """Force the persistence journal onto disk (tests/shutdown)."""
        self.dq.flush(force=True)

    def drain(self, timeout: float = 30.0):
        """Block until the queue AND the retry park are empty
        (tests / shutdown)."""
        self.dq.drain(timeout)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.dq.flush(force=True)
