"""Auto-heal, the port of minio_tpu/scanner/autoheal.py: fresh-disk
detection and the global heal (reference
cmd/background-newdisks-heal-ops.go:44-113 + cmd/global-heal.go:123).

A persisted per-disk healing tracker (``.minio.sys/healing.bin``, the JAX
package's JSON, so either package resumes the other's) marks a disk as
under heal, so healing resumes across restarts; the global healer walks
every bucket and heals objects concurrently (128 workers, a bounded
in-flight window): the concurrent heal_object calls' shard rebuilds
coalesce in the dispatch queue into batched K1 launches and their verifies
into K5 launches (``BASELINE.json`` config 5: 128 concurrent objects).

The heals run under ``qos.background()``. In the JAX package that class
spills to the CPU first under device backlog; the port's queue on the card
never moves work to the host, so background heals stay on the card.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from .. import qos
from ..obs import spans as _spans
from ..obs import trace as _trc
from ..storage.xlstorage import META_BUCKET
from ..utils import errors

HEALING_TRACKER = "healing.bin"


def set_healing_tracker(disk, info: dict | None = None):
    disk.write_all(META_BUCKET, HEALING_TRACKER, json.dumps({
        "started": time.time(), **(info or {})}).encode())


def get_healing_tracker(disk) -> dict | None:
    try:
        return json.loads(disk.read_all(META_BUCKET, HEALING_TRACKER))
    except (errors.StorageError, ValueError):
        return None


def clear_healing_tracker(disk):
    try:
        disk.delete_path(META_BUCKET, HEALING_TRACKER)
    except errors.StorageError:
        pass


class GlobalHealer:
    """healErasureSet analogue: heal every bucket and object, with bounded
    concurrency so rebuild work batches on the card."""

    def __init__(self, objlayer, concurrency: int = 128):
        self.obj = objlayer
        self.concurrency = concurrency
        self.objects_healed = 0
        self.objects_failed = 0

    def heal_all(self, scan_mode: str = "normal",
                 resume_from: tuple[str, str] | None = None,
                 progress_cb=None, progress_every: int = 64) -> dict:
        """Full-namespace heal pass. ``resume_from`` = (bucket, object)
        marker of an interrupted pass: earlier buckets and covered objects
        are skipped (the namespace walk is sorted, so the skip is a plain
        comparison). ``progress_cb`` fires every ``progress_every`` objects
        with (bucket, object, results): the healing tracker persists it so
        a restarted node resumes instead of re-walking."""
        results = {"buckets": 0, "objects_healed": 0, "objects_failed": 0}
        pool = ThreadPoolExecutor(max_workers=self.concurrency,
                                  thread_name_prefix="global-heal")
        # bounded in-flight window: memory stays O(concurrency) even on
        # namespaces with millions of objects
        futs: deque = deque()  # (future, bucket, object)
        max_inflight = self.concurrency * 4
        rb, ro = resume_from if resume_from else ("", "")
        state = {"since": 0}

        def reap():
            # reap order == submit order == walk order, so the marker only
            # ever advances past objects whose heal completed: a resume
            # cannot skip work that was merely in flight
            f, bkt, name = futs.popleft()
            if f.result():
                results["objects_healed"] += 1
            else:
                results["objects_failed"] += 1
            state["since"] += 1
            if progress_cb is not None and \
                    state["since"] >= progress_every:
                state["since"] = 0
                progress_cb(bkt, name, dict(results))

        try:
            for b in sorted(self.obj.list_buckets(), key=lambda x: x.name):
                if rb and b.name < rb:
                    continue  # healed before the interruption
                self.obj.heal_bucket(b.name)
                results["buckets"] += 1
                for oi in self.obj.iter_objects(b.name):
                    if rb == b.name and ro and oi.name <= ro:
                        continue
                    futs.append((pool.submit(
                        _spans.wrap_ctx(self._heal_one), b.name, oi.name,
                        scan_mode), b.name, oi.name))
                    if len(futs) >= max_inflight:
                        reap()
            while futs:
                reap()
        finally:
            pool.shutdown(wait=True)
        self.objects_healed += results["objects_healed"]
        self.objects_failed += results["objects_failed"]
        return results

    def _heal_one(self, bucket: str, name: str, scan_mode: str) -> bool:
        t0 = time.perf_counter()
        err = ""
        try:
            with qos.background():
                self.obj.heal_object(bucket, name, scan_mode=scan_mode)
            return True
        except Exception as e:  # noqa: BLE001
            err = str(e)
            return False
        finally:
            _trc.publish_scanner(func="heal.object",
                                 path=f"{bucket}/{name}",
                                 duration_s=time.perf_counter() - t0,
                                 error=err)


class AutoHealMonitor:
    """monitorLocalDisksAndHeal analogue: watches for disks carrying a
    healing tracker (set when a fresh or replaced disk is formatted, or
    when a health-tracked disk re-onlines) and runs a global heal pass."""

    def __init__(self, objlayer, local_disks: list, interval_s: float = 10.0):
        self.obj = objlayer
        self.local_disks = local_disks
        self.interval = interval_s
        self.healer = GlobalHealer(objlayer)
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._thread: threading.Thread | None = None
        self.heal_passes = 0

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="auto-heal")
        self._thread.start()
        return self

    def kick(self) -> None:
        """Run the next check now (a health-tracked disk just re-onlined)
        instead of waiting out the poll interval."""
        self._kick.set()

    def stats(self) -> dict:
        return {"heal_passes": self.heal_passes,
                "disks_watched": len(self.local_disks)}

    def _loop(self):
        while True:
            self._kick.wait(self.interval)
            self._kick.clear()
            if self._stop.is_set():
                return
            try:
                self.check_and_heal()
            except Exception as e:  # noqa: BLE001 — the loop survives
                from ..obs.logger import log_sys
                log_sys().log_once(
                    f"autoheal:{type(e).__name__}", "warning", "autoheal",
                    f"background heal cycle failed: {e!r}")

    def check_and_heal(self) -> bool:
        tracked = [(d, t) for d in self.local_disks
                   if (t := get_healing_tracker(d)) is not None]
        if not tracked:
            return False
        pending = [d for d, _ in tracked]
        # resume from the most conservative persisted marker (a restart
        # mid-pass continues instead of re-walking the whole namespace)
        markers = [(t.get("bucket", ""), t.get("object", ""))
                   for _, t in tracked if isinstance(t, dict)]
        resume = min(markers) if markers and all(
            m != ("", "") for m in markers) else None
        # failures recorded before the interruption: the pre-marker part of
        # a resumed pass skipped them, so a clean remainder must not
        # declare the disk healed
        prior_failed = max((t.get("objects_failed", 0)
                            for _, t in tracked if isinstance(t, dict)),
                           default=0) if resume else 0

        def save_progress(bucket, obj, res):
            for d in pending:
                try:
                    t = get_healing_tracker(d) or {}
                    t.update({"bucket": bucket, "object": obj,
                              "objects_healed": res["objects_healed"],
                              "objects_failed": res["objects_failed"]
                              + prior_failed})
                    set_healing_tracker(d, t)
                except errors.StorageError:
                    continue  # a flaky tracker disk (the fresh ones!) must
                    # not abort the whole heal pass

        res = self.healer.heal_all(resume_from=resume,
                                   progress_cb=save_progress)
        self.heal_passes += 1
        if res["objects_failed"] + prior_failed == 0:
            # only a clean pass clears the trackers: a partial pass must
            # resume on the next cycle
            for d in pending:
                clear_healing_tracker(d)
        else:
            # failures mean skipped objects: reset the marker so the next
            # pass re-walks from the start
            for d in pending:
                try:
                    t = get_healing_tracker(d) or {}
                    t.pop("bucket", None)
                    t.pop("object", None)
                    t.pop("objects_failed", None)
                    set_healing_tracker(d, t)
                except errors.StorageError:
                    continue
        return True

    def stop(self):
        self._stop.set()
        self._kick.set()  # wake the loop so stop doesn't wait a cycle
        if self._thread is not None:
            self._thread.join(timeout=5)
