"""Data scanner, the port of minio_tpu/scanner/scanner.py (reference
cmd/data-scanner.go:65): a periodic namespace crawl with per-object
throttling; refreshes the data-usage accounting (``scanner.usage``), skips
buckets the update tracker saw no writes in, verifies object health every
``DEEP_SCAN_EVERY``-th cycle (a deep bitrot scan: ``heal_object(dry_run=
True, scan_mode="deep")``, K5 on the card, whose findings go to the MRF)
and runs the durability janitor's sweep each cycle.

Each cycle's snapshot also reconciles the per-bucket analytics
(``obs/bucketstats.reconcile``: the live usage deltas snap back to the
scanned usage, the drift is recorded, and the capacity history takes a
sample). Every object walked goes first through the lifecycle rules
(``lifecycle``, a ``bucket.lifecycle.LifecycleSys``: expiry, and
transition to a tier, whose read is a GET through the erasure path), then
the replication sweep (``replication``, a ``bucket.replicate.
ReplicationSys``: an object still PENDING or FAILED is charged again). A
bucket with lifecycle or replication rules is walked every cycle, writes
or not: its actions trigger on age and on debt. A failed cycle or sweep
is reported once per error type through the log plane (``obs/logger``).

Cycles run under ``qos.background()``. In the JAX package that class
spills to the CPU first under device backlog; the port's queue on the card
never moves work to the host, so the deep scan's verifies stay on the
card.
"""
from __future__ import annotations

import logging
import os
import threading
import time

from .. import qos
from ..obs import bucketstats
from ..obs import metrics as _mx
from ..obs import trace as _trc
from ..obs.logger import log_sys
from ..storage.xlstorage import META_BUCKET
from . import usage as usage_mod
from .janitor import DurabilityJanitor
from .tracker import global_tracker

DEEP_SCAN_EVERY = 16  # healDeepScanCycleMultiplier (cmd/data-scanner.go:48)

log = logging.getLogger("minio_tpu_torch.scanner")


class DataScanner:
    def __init__(self, objlayer, interval_s: float = 60.0,
                 mrf=None, lifecycle=None, sleep_per_object: float = 0.001,
                 replication=None):
        self.obj = objlayer
        self.interval = interval_s
        self.mrf = mrf
        self.lifecycle = lifecycle
        #: the cross-node replication plane: a cycle re-charges objects
        #: stuck PENDING or FAILED (missed charge, exhausted retries, debt
        #: shed under queue overflow)
        self.replication = replication
        self.sleep_per_object = sleep_per_object
        self.cycle = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_usage: dict = {}
        # persist the update tracker beside the first local disk's system
        # state so the skip state survives restarts. The port's disks name
        # their directory ``root`` (the JAX package's ``base``)
        from ..obs.metrics import _all_disks
        disk = next((d for d in _all_disks(objlayer)
                     if getattr(d, "root", "")), None)
        if disk is not None:
            global_tracker().attach_persistence(
                os.path.join(disk.root, META_BUCKET, "tracker.bin"))
        # crash-residue janitor: aged tmp and stale multipart every cycle,
        # the namespace reconcile on deep cycles
        self.janitor = DurabilityJanitor(objlayer)

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="data-scanner")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.scan_cycle()
            except Exception as e:  # noqa: BLE001 — the scanner never dies
                log_sys().log_once(
                    f"scanner:{type(e).__name__}", "warning", "scanner",
                    f"scan cycle failed: {e!r}")

    def scan_cycle(self) -> dict:
        """One crawl; returns the usage snapshot (also persisted). Buckets
        untouched since the last sweep (per the update tracker) reuse their
        previous stats instead of re-walking. Deep cycles always walk. Runs
        as the ``background`` class, so a cycle forced by a caller gets the
        treatment of a scheduled one."""
        with qos.background():
            return self._scan_cycle_inner()

    def _scan_cycle_inner(self) -> dict:
        self.cycle += 1
        deep = (self.cycle % DEEP_SCAN_EVERY == 0)
        _mx.inc("minio_tpu_scanner_cycles_total", deep=str(deep).lower())
        t_cycle = time.perf_counter()
        try:
            # the cheap jobs every cycle; the O(namespace) reconcile only on
            # deep cycles, the cadence of the bitrot verify walk
            self.janitor.sweep(reconcile=deep)
        except Exception as e:  # noqa: BLE001 — best-effort, but logged
            log_sys().log_once(
                f"janitor:{type(e).__name__}", "warning", "scanner",
                f"durability sweep failed: {e!r}")
        tracker = global_tracker()
        gen = tracker.begin_cycle()
        prev_buckets = self.last_usage.get("buckets", {}) \
            if self.last_usage else usage_mod.load_usage(
                self.obj).get("buckets", {})
        buckets = {}
        total_objects = total_size = 0
        for b in self.obj.list_buckets():
            prev = prev_buckets.get(b.name)
            # the skip holds only without time-based actions: lifecycle
            # rules trigger on age and replication debt must be re-found,
            # writes or not
            has_lifecycle = self.lifecycle is not None and \
                bool(self.lifecycle.rules_for(b.name))
            has_replication = self.replication is not None and \
                bool(self.replication.rules_for(b.name))
            if prev is not None and not deep and not has_lifecycle and \
                    not has_replication and \
                    not tracker.bucket_dirty(b.name):
                buckets[b.name] = prev
                total_objects += prev.get("objects", 0)
                total_size += prev.get("size", 0)
                continue
            count = size = versions = 0
            tree = usage_mod.UsageTree()
            # one streaming metacache pass per bucket
            for oi in self.obj.iter_objects(b.name):
                if self._stop.is_set():
                    return self.last_usage
                nv = max(1, oi.num_versions)
                count += 1
                size += oi.size
                versions += nv
                tree.add(oi.name, oi.size, nv)
                _mx.inc("minio_tpu_scanner_objects_scanned_total")
                _mx.inc("minio_tpu_scanner_bytes_scanned_total", oi.size)
                self._check_object(b.name, oi, deep)
                if self.sleep_per_object:
                    time.sleep(self.sleep_per_object)
            tree.compact()
            try:
                usage_mod.save_tree(self.obj, b.name, tree)
            except Exception:  # noqa: BLE001 — accounting is best-effort
                log.warning("usage tree of %s not saved", b.name,
                            exc_info=True)
            buckets[b.name] = {"objects": count, "size": size,
                               "versions": versions,
                               "prefixes": tree.prefixes(1),
                               "histogram": tree.histogram()}
            total_objects += count
            total_size += size
        tracker.end_cycle(gen)
        snapshot = {"last_update": time.time(),
                    "objects_total": total_objects,
                    "size_total": total_size, "buckets": buckets,
                    "cycle": self.cycle, "deep": deep}
        try:
            usage_mod.save_usage(self.obj, snapshot)
        except Exception:  # noqa: BLE001
            log.warning("usage snapshot not saved", exc_info=True)
        try:
            # the live usage deltas snap back to this tree (drift measured
            # and zeroed) and the capacity history takes a sample
            bucketstats.reconcile(snapshot, objlayer=self.obj)
        except Exception:  # noqa: BLE001 — accounting is best-effort
            log.warning("bucket analytics not reconciled", exc_info=True)
        _trc.publish_scanner(func="scanner.cycle",
                             path=f"cycle={self.cycle} deep={deep}",
                             duration_s=time.perf_counter() - t_cycle,
                             input_bytes=total_size)
        self.last_usage = snapshot
        return snapshot

    def _check_object(self, bucket: str, oi, deep: bool):
        # lifecycle first: an expired object needs no heal
        if self.lifecycle is not None:
            try:
                if self.lifecycle.apply(bucket, oi):
                    return
            except Exception:  # noqa: BLE001 — retried next cycle
                log.warning("lifecycle of %s/%s failed", bucket, oi.name,
                            exc_info=True)
        # the replication sweep: anything still PENDING or FAILED is
        # charged again (the safety net under the journal)
        if self.replication is not None:
            try:
                self.replication.sweep(bucket, oi)
            except Exception:  # noqa: BLE001 — retried next cycle
                log.warning("replication sweep of %s/%s failed", bucket,
                            oi.name, exc_info=True)
        if deep and self.mrf is not None:
            try:
                res = self.obj.heal_object(bucket, oi.name, dry_run=True,
                                           scan_mode="deep")
                if any(s != "ok" for s in res.before_state):
                    self.mrf.add_partial(bucket, oi.name, "",
                                         scan_mode="deep")
            except Exception:  # noqa: BLE001
                pass

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
