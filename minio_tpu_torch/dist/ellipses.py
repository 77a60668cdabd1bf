"""Ellipses pattern expansion, the port of minio_tpu/dist/ellipses.py
(reference pkg/ellipses +
cmd/endpoint-ellipses.go): ``/data/disk{1...8}`` → 8 paths;
``http://host{1...4}/disk{1...4}`` → 16 endpoints (host-major order,
matching the reference's argument expansion)."""
from __future__ import annotations

import re

_PATTERN = re.compile(r"\{(\d+)\.\.\.(\d+)\}")


def has_ellipses(arg: str) -> bool:
    return _PATTERN.search(arg) is not None


def expand(arg: str) -> list[str]:
    """Expand every {a...b} range in ``arg`` (cartesian, left-major)."""
    m = _PATTERN.search(arg)
    if not m:
        return [arg]
    lo, hi = int(m.group(1)), int(m.group(2))
    if hi < lo:
        raise ValueError(f"invalid ellipses range in {arg!r}")
    width = len(m.group(1)) if m.group(1).startswith("0") else 0
    out = []
    for i in range(lo, hi + 1):
        s = str(i).zfill(width) if width else str(i)
        out.extend(expand(arg[:m.start()] + s + arg[m.end():]))
    return out


def expand_endpoints(args: list[str]) -> list[str]:
    out = []
    for a in args:
        out.extend(expand(a))
    return out
