"""Erasure set layout choice, the port of minio_tpu/dist/topology.py
(reference cmd/endpoint-ellipses.go:44-160):
set sizes 4-16, greatest divisor of the drive count within that range,
with the reference's node-affinity symmetry filter
(possibleSetCountsWithSymmetry :91-132): in multi-host topologies prefer
set sizes that spread each set evenly across hosts, so losing one host
never takes more than drives_per_set/host_count shards of any set."""
from __future__ import annotations

import math

SET_SIZES = tuple(range(4, 17))  # setSizes, cmd/endpoint-ellipses.go:44


def pick_set_layout(n_drives: int,
                    host_drive_counts: list[int] | None = None
                    ) -> tuple[int, int]:
    """(set_count, drives_per_set). Drive counts 2-3 form one undersized
    set (standalone erasure, reference ErasureSD); larger counts must be
    divisible by a set size in 4..16, preferring the largest symmetric
    size. ``host_drive_counts`` (drives per host) activates the symmetry
    filter."""
    if n_drives < 2:
        raise ValueError("erasure mode needs >= 2 drives")
    if n_drives <= 3:
        return 1, n_drives
    candidates = [s for s in SET_SIZES if n_drives % s == 0]
    if not candidates:
        raise ValueError(
            f"drive count {n_drives} not divisible by any set size 4-16")
    counts = host_drive_counts or []
    if len(counts) > 1:
        # GCD of per-host drive counts: a set size dividing it keeps every
        # set within whole per-host groups; a size divisible by the host
        # count stripes each set evenly across hosts. Either is symmetric
        # (cmd/endpoint-ellipses.go:91-132).
        g = math.gcd(*counts)
        n_hosts = len(counts)
        symmetric = [s for s in candidates
                     if s % n_hosts == 0 or g % s == 0]
        if symmetric:
            candidates = symmetric
    best = max(candidates)
    return n_drives // best, best
