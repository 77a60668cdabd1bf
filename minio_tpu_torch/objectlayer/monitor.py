"""Set disk monitor, the port of minio_tpu/objectlayer/monitor.py
(reference monitorAndConnectEndpoints + connectDisks,
cmd/erasure-sets.go:196-300): a background pass over every set slot that

- re-slots disks whose format identity says they belong elsewhere in the
  topology (cables/mounts swapped: data is still valid, just misplaced),
- detects wiped/fresh disks, re-formats them into their slot and hands
  them to the auto-heal tracker (HealFormat analogue),
- fires an ``on_connect`` callback whenever a slot transitions back to
  usable so healing starts without waiting for a read to trip over it.
"""
from __future__ import annotations

import logging
import threading

from ..dist.format import find_disk_slot, load_format, save_format
from ..utils import errors

log = logging.getLogger("minio_tpu_torch.monitor")


class SetDiskMonitor:
    def __init__(self, sets, fmt: dict, interval_s: float = 10.0,
                 on_connect=None):
        """``sets`` is an ErasureSets (or anything with .sets of
        ErasureObjects); ``fmt`` the reference format.json document."""
        self.sets = sets
        self.fmt = fmt
        self.interval = interval_s
        #: called with (set_index, slot, disk) when a slot becomes usable
        self.on_connect = on_connect
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.reslotted = 0
        self.reformatted = 0

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "SetDiskMonitor":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="minio-tpu-disk-monitor")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — monitor must never die
                log.warning("disk monitor pass failed", exc_info=True)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- one pass -------------------------------------------------------------

    def check_once(self) -> dict:
        """Inspect every slot; returns {reslotted, reformatted} deltas."""
        before = (self.reslotted, self.reformatted)
        drives_per_set = len(self.fmt["xl"]["sets"][0])
        # collect current placement: (set, slot) -> disk
        misplaced: list[tuple] = []
        for si, eset in enumerate(self.sets.sets):
            for slot in range(drives_per_set):
                d = eset._disks[slot]
                if d is None:
                    continue
                want = self.fmt["xl"]["sets"][si][slot]
                state = self._inspect(d, want)
                if state == "ok":
                    continue
                if state == "fresh":
                    self._reformat(eset, si, slot, d, want)
                elif state == "foreign":
                    misplaced.append((si, slot, d))
        # re-slot misplaced disks to wherever their identity belongs
        for si, slot, d in misplaced:
            self._reslot(si, slot, d)
        return {"reslotted": self.reslotted - before[0],
                "reformatted": self.reformatted - before[1]}

    def _inspect(self, d, want_uuid: str) -> str:
        """'ok' | 'fresh' (wiped/unformatted) | 'foreign' (belongs to a
        different slot) | 'offline'."""
        try:
            fmt = load_format(d)
        except errors.UnformattedDisk:
            return "fresh"
        except errors.StorageError:
            return "offline"
        this = fmt.get("xl", {}).get("this", "")
        if this == want_uuid:
            if d.get_disk_id() != want_uuid:
                d.set_disk_id(want_uuid)
            return "ok"
        return "foreign"

    def _reformat(self, eset, si: int, slot: int, d, want_uuid: str):
        """A wiped disk comes back empty: write its slot identity and hand
        it to healing (reference HealFormat, cmd/erasure-sets.go:1281)."""
        mine = dict(self.fmt)
        mine["xl"] = dict(self.fmt["xl"])
        mine["xl"]["this"] = want_uuid
        try:
            save_format(d, mine)
            d.set_disk_id(want_uuid)
        except errors.StorageError:
            return
        self.reformatted += 1
        log.info("disk %s reformatted into set %d slot %d",
                 d.endpoint(), si, slot)
        if self.on_connect is not None:
            self.on_connect(si, slot, d)

    def _reslot(self, si: int, slot: int, d):
        """Move a disk carrying another slot's identity to where the
        topology says it belongs; both slots end up consistent."""
        if self.sets.sets[si]._disks[slot] is not d:
            return  # an earlier swap this pass already re-homed it
        try:
            this = load_format(d)["xl"]["this"]
        except errors.StorageError:
            return
        home = find_disk_slot(self.fmt, this)
        if home is None:
            log.warning("disk %s carries unknown identity %s; taking "
                        "it offline", d.endpoint(), this)
            self.sets.sets[si]._disks[slot] = None
            return
        hsi, hslot = home
        if (hsi, hslot) == (si, slot):
            return
        dest_set = self.sets.sets[hsi]
        displaced = dest_set._disks[hslot]
        dest_set._disks[hslot] = d
        self.sets.sets[si]._disks[slot] = displaced
        d.set_disk_id(this)
        self.reslotted += 1
        log.info("disk %s re-slotted %d/%d -> %d/%d", d.endpoint(),
                 si, slot, hsi, hslot)
        if self.on_connect is not None:
            self.on_connect(hsi, hslot, d)
