"""Durability janitor, the port of minio_tpu/scanner/janitor.py: the
startup and periodic recovery sweep that makes a crash's residue converge
back to a clean namespace (reference: the ``.minio.sys/tmp`` format at
server start, cmd/erasure-multipart.go cleanupStaleUploads, and the
dangling-object checks the scanner performs).

Four jobs, each counted in the ``minio_tpu_durability_*`` families:

1. **tmp sweep**: crash-stranded ``.minio.sys/tmp`` staging dirs are
   reclaimed (all ages at startup, ``durability.tmp_expiry_s``-aged on
   periodic sweeps, so in-flight uploads in a live process survive).
2. **stale multipart expiry**: uploads initiated longer than
   ``durability.multipart_expiry_s`` ago are aborted on every disk.
3. **xl.meta quarantine**: torn or unparseable journals move aside to
   ``xl.meta.corrupt`` (through XLStorage._load_meta) and the object is
   kicked to the MRF for a rebuild from quorum.
4. **orphan dataDir reconcile**: data dirs no version references (a crash
   between the dataDir rename and the journal commit) are removed;
   objects present on only some disks are kicked to the MRF.

``ErasureObjects.__init__`` runs :func:`startup_recovery` (jobs 1 and 2:
O(tmp + multipart), never O(namespace)); the data scanner runs
:meth:`DurabilityJanitor.sweep` each cycle, reconciling the namespace
(jobs 3 and 4) only on deep cycles.

The windows and the startup gate (``durability.startup_recovery``) are
read through the config registry (env > stored > default) at each run.
"""
from __future__ import annotations

import time

from ..obs import metrics as _mx
from ..storage.xlstorage import META_MULTIPART
from ..utils import errors


#: the windows' fallback when a configured value is not a number
DEFAULT_EXPIRY_S = 86400.0


def _cfg_float(key: str) -> float:
    """durability.<key> as a float (env > stored > default)."""
    from ..config import get_config_sys
    try:
        return float(get_config_sys().get("durability", key))
    except ValueError:
        return DEFAULT_EXPIRY_S


def _layers(objlayer) -> list:
    """Every erasure set under any ObjectLayer shape: the quorum unit the
    reconcile jobs reason about (an object lives on one set's disks)."""
    if hasattr(objlayer, "pools"):
        return [s for p in objlayer.pools for s in _layers(p)]
    if hasattr(objlayer, "sets"):
        return list(objlayer.sets)
    return [objlayer] if hasattr(objlayer, "disks") else []


def _disks(objlayer) -> list:
    return [d for d in getattr(objlayer, "disks", []) if d is not None]


class DurabilityJanitor:
    def __init__(self, objlayer):
        self.obj = objlayer
        self.last_stats: dict = {}

    # -- jobs -----------------------------------------------------------------

    def sweep_tmp(self, age_s: float | None = None) -> int:
        if age_s is None:
            age_s = _cfg_float("tmp_expiry_s")
        swept = 0
        for layer in _layers(self.obj):
            for d in _disks(layer):
                try:
                    swept += d.sweep_tmp(age_s)
                except Exception:  # noqa: BLE001 — per-disk best effort
                    continue
        return swept

    def expire_multipart(self, expiry_s: float | None = None) -> int:
        """Abort uploads whose initiation xl.meta is older than the expiry
        window, on every disk (the reference reaps the same way: list the
        multipart namespace, check the mod time, purge)."""
        if expiry_s is None:
            expiry_s = _cfg_float("multipart_expiry_s")
        return sum(self._expire_multipart_layer(layer, expiry_s)
                   for layer in _layers(self.obj))

    def _expire_multipart_layer(self, layer, expiry_s: float) -> int:
        disks = _disks(layer)
        now = time.time()
        # the namespace is the union of every disk's listing: a crash
        # during initiation can leave the upload journal on any subset of
        # disks, and a first-disk-only view would leak those forever
        upaths: set[str] = set()
        for d in disks:
            try:
                hashes = d.list_dir(META_MULTIPART, "")
            except errors.StorageError:
                continue
            for h in hashes:
                h = h.rstrip("/")
                try:
                    uploads = d.list_dir(META_MULTIPART, h)
                except errors.StorageError:
                    continue
                upaths.update(f"{h}/{u.rstrip('/')}" for u in uploads)
        stale: list[str] = []
        for upath in sorted(upaths):
            newest = None
            for d in disks:
                try:
                    fi = d.read_version(META_MULTIPART, upath)
                except errors.StorageError:
                    # incl. FileCorrupt: the read just quarantined a torn
                    # journal; the surviving copies age the upload
                    continue
                newest = fi.mod_time if newest is None \
                    else max(newest, fi.mod_time)
            # journal-less dirs are left alone: reaping them would race an
            # initiation whose journal commit is mid-flight
            if newest is not None and now - newest > expiry_s:
                stale.append(upath)
        reaped = 0
        for upath in stale:
            for d in disks:
                try:
                    d.delete_path(META_MULTIPART, upath, recursive=True)
                except errors.StorageError:
                    continue
            reaped += 1
        if reaped:
            _mx.inc("minio_tpu_durability_expired_uploads_total", reaped)
        return reaped

    def reconcile_namespace(self, age_s: float = 60.0) -> dict:
        """Jobs 3 and 4 over every bucket: per-disk journal and dataDir
        reconcile, plus a cross-disk presence check that kicks the MRF for
        partially committed objects (some disks crashed before their
        journal write, the rest carry the version)."""
        out = {"objects": 0, "orphan_ddirs": 0, "quarantined": 0,
               "partial": 0}
        for layer in _layers(self.obj):
            self._reconcile_layer(layer, age_s, out)
        return out

    def _reconcile_layer(self, layer, age_s: float, out: dict) -> None:
        disks = _disks(layer)
        try:
            buckets = [b.name for b in layer.list_buckets()]
        except Exception:  # noqa: BLE001 — no quorum: nothing to do
            return
        for bucket in buckets:
            names: set[str] = set()
            for d in disks:
                try:
                    names.update(d.walk_dir(bucket))
                except errors.StorageError:
                    continue
                # journal-less residue (a crash before a new object's first
                # journal write) is invisible to walk_dir: union in the
                # dedicated orphan walk (local disks only)
                wu = getattr(d, "walk_unjournaled", None)
                if wu is not None:
                    try:
                        names.update(wu(bucket))
                    except errors.StorageError:
                        pass
            for name in sorted(names):
                out["objects"] += 1
                holders = 0
                quarantined_here = False
                # reconcile every disk, not just the ones whose walk
                # yielded the name: a disk whose journal was quarantined
                # no longer walks as an object but still holds strays
                for d in disks:
                    try:
                        res = d.reconcile_object(bucket, name, age_s)
                    except Exception:  # noqa: BLE001
                        continue
                    out["orphan_ddirs"] += res["orphan_ddirs"]
                    out["quarantined"] += res["quarantined"]
                    quarantined_here |= bool(res["quarantined"])
                    holders += 1 if res["has_meta"] else 0
                if 0 < holders < len(disks):
                    out["partial"] += 1
                    self._kick_heal(layer, bucket, name,
                                    deep=quarantined_here)

    @staticmethod
    def _kick_heal(layer, bucket: str, name: str, deep: bool = False):
        notify = getattr(layer, "_notify_partial", None)
        if notify is None:
            return
        try:
            notify(bucket, name, "",
                   scan_mode="deep" if deep else "normal")
        except Exception:  # noqa: BLE001 — MRF is best-effort
            pass

    # -- entry points ---------------------------------------------------------

    def sweep(self, tmp_age_s: float | None = None,
              multipart_expiry_s: float | None = None,
              reconcile: bool = True,
              ddir_age_s: float = 60.0) -> dict:
        """One full janitor pass (the scanner's periodic entry point; tests
        drive it with age 0 to model post-restart recovery)."""
        _mx.inc("minio_tpu_durability_recovery_runs_total", phase="sweep")
        stats = {"tmp_swept": self.sweep_tmp(tmp_age_s),
                 "uploads_expired": self.expire_multipart(
                     multipart_expiry_s)}
        if reconcile:
            stats.update(self.reconcile_namespace(ddir_age_s))
        self.last_stats = stats
        return stats


def startup_recovery(objlayer) -> dict:
    """The ErasureObjects init pass: reclaim all tmp staging (nothing in
    flight survives a restart) and expire aged multipart uploads.
    Deliberately O(tmp + multipart), not O(namespace): quarantine and
    reconcile run lazily on read and in the scanner's janitor. Gated by
    ``durability.startup_recovery``. Build every
    layer over a set of directories before traffic starts on any of them:
    a layer built over live directories sweeps the first's in-flight
    staging."""
    from ..config import get_config_sys
    if get_config_sys().get("durability", "startup_recovery") in (
            "0", "off", "false"):
        return {}
    _mx.inc("minio_tpu_durability_recovery_runs_total", phase="startup")
    j = DurabilityJanitor(objlayer)
    return {"tmp_swept": j.sweep_tmp(age_s=0.0),
            "uploads_expired": j.expire_multipart()}
