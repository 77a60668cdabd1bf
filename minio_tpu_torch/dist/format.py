"""format.json v3 lifecycle, the port of minio_tpu/dist/format.py (pure
helpers; reference cmd/format-erasure.go:110 +
cmd/prepare-storage.go:214-331): every disk carries its identity (``this``
uuid), the full ``sets`` topology and the deployment id. On startup fresh
disks are formatted (first node wins), mismatched disks rejected, and
reconnected disks re-slotted by uuid. The JSON is the JAX package's, so
either package reads the other's ``format.json``."""
from __future__ import annotations

import json
import uuid as uuidlib

from ..storage.xlstorage import META_BUCKET
from ..utils import errors

FORMAT_FILE = "format.json"


def new_format(set_count: int, drives_per_set: int,
               deployment_id: str = "") -> dict:
    return {
        "version": "1",
        "format": "xl",
        "id": deployment_id or str(uuidlib.uuid4()),
        "xl": {
            "version": "3",
            "this": "",
            "sets": [[str(uuidlib.uuid4()) for _ in range(drives_per_set)]
                     for _ in range(set_count)],
            "distributionAlgo": "SIPMOD+PARITY",
        },
    }


def load_format(disk) -> dict:
    try:
        blob = disk.read_all(META_BUCKET, FORMAT_FILE)
    except errors.FileNotFound:
        raise errors.UnformattedDisk(disk.endpoint()) from None
    try:
        return json.loads(blob)
    except ValueError as e:
        raise errors.CorruptedFormat(str(e)) from e


def save_format(disk, fmt: dict) -> None:
    disk.write_all(META_BUCKET, FORMAT_FILE,
                   json.dumps(fmt, indent=1).encode())


def init_format_erasure(disks: list, set_count: int, drives_per_set: int,
                        may_init: bool = True) -> dict:
    """Format fresh disks / validate existing ones; returns the reference
    format. Disks are ordered set-major (disk i belongs to set
    i // drives_per_set, slot i % drives_per_set).

    ``may_init=False``: when EVERY disk is unformatted, raise
    UnformattedDisk (retryable) instead of stamping a new deployment —
    in a fresh cluster only the node owning the first endpoint
    initializes (reference cmd/prepare-storage.go: firstDisk), otherwise
    two nodes race to write different deployment ids and the format is
    permanently split."""
    fmts: list[dict | None] = []
    for d in disks:
        if d is None:
            fmts.append(None)
            continue
        try:
            fmts.append(load_format(d))
        except errors.UnformattedDisk:
            fmts.append(None)
    ref = next((f for f in fmts if f is not None), None)
    if ref is None:
        if not may_init:
            raise errors.UnformattedDisk(
                "fresh cluster: waiting for the first node to write the "
                "reference format")
        ref = new_format(set_count, drives_per_set)
    sets = ref["xl"]["sets"]
    if len(sets) != set_count or len(sets[0]) != drives_per_set:
        raise errors.CorruptedFormat(
            f"format topology {len(sets)}x{len(sets[0])} != "
            f"{set_count}x{drives_per_set}")
    for i, (d, fmt) in enumerate(zip(disks, fmts)):
        if d is None:
            continue
        want_uuid = sets[i // drives_per_set][i % drives_per_set]
        if fmt is None:
            mine = dict(ref)
            mine["xl"] = dict(ref["xl"])
            mine["xl"]["this"] = want_uuid
            save_format(d, mine)
            d.set_disk_id(want_uuid)
        else:
            if fmt["id"] != ref["id"]:
                raise errors.CorruptedFormat(
                    f"disk {d.endpoint()} belongs to deployment "
                    f"{fmt['id']}, expected {ref['id']}")
            d.set_disk_id(fmt["xl"]["this"])
    return ref


def find_disk_slot(fmt: dict, disk_uuid: str) -> tuple[int, int] | None:
    """(set_index, slot) of a disk uuid inside the topology — how a
    reconnected disk is re-slotted (reference cmd/erasure-sets.go:196)."""
    for si, s in enumerate(fmt["xl"]["sets"]):
        for di, u in enumerate(s):
            if u == disk_uuid:
                return si, di
    return None
