"""Object lock, retention and legal hold, the port of
minio_tpu/bucket/objectlock.py (reference
cmd/bucket-object-lock.go:1-348 + pkg/bucket/object/lock): WORM semantics —
a version under COMPLIANCE retention or legal hold cannot be deleted; a
GOVERNANCE-retained version needs an explicit bypass by a permitted
principal. Retention state lives in per-object metadata
(x-amz-object-lock-*), defaults come from the bucket configuration."""
from __future__ import annotations

import time
import xml.etree.ElementTree as ET
from dataclasses import dataclass

from ..objectlayer import datatypes as dt

META_MODE = "x-amz-object-lock-mode"
META_RETAIN_UNTIL = "x-amz-object-lock-retain-until-date"
META_LEGAL_HOLD = "x-amz-object-lock-legal-hold"

GOVERNANCE = "GOVERNANCE"
COMPLIANCE = "COMPLIANCE"

_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def findtext(el, tag) -> str:
    """Namespace-tolerant findtext (S3 clients differ on xmlns usage)."""
    v = el.findtext(tag)
    if v is None:
        v = el.findtext(_NS + tag)
    return v or ""


_findtext = findtext


def _find(el, tag):
    f = el.find(tag)
    return f if f is not None else el.find(_NS + tag)


@dataclass
class DefaultRetention:
    mode: str = ""     # "" = no default
    days: int = 0
    years: int = 0

    def retain_until(self, now: float | None = None) -> str:
        now = now or time.time()
        seconds = self.days * 86400 + self.years * 365 * 86400
        return iso8601(now + seconds)


def iso8601(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


def parse_iso8601(s: str) -> float:
    s = s.strip()
    for fmt in ("%Y-%m-%dT%H:%M:%SZ", "%Y-%m-%dT%H:%M:%S.%fZ",
                "%Y-%m-%dT%H:%M:%S%z"):
        try:
            import calendar
            import datetime
            d = datetime.datetime.strptime(s, fmt)
            if d.tzinfo is not None:
                return d.timestamp()
            return calendar.timegm(d.timetuple())
        except ValueError:
            continue
    raise ValueError(f"bad ISO8601 date {s!r}")


def parse_lock_config(xml_bytes: bytes) -> DefaultRetention:
    """<ObjectLockConfiguration><ObjectLockEnabled>Enabled</...>
    [<Rule><DefaultRetention><Mode/><Days|Years/>...]"""
    root = ET.fromstring(xml_bytes)
    enabled = _findtext(root, "ObjectLockEnabled")
    if enabled and enabled != "Enabled":
        raise ValueError("ObjectLockEnabled must be 'Enabled'")
    rule = _find(root, "Rule")
    if rule is None:
        return DefaultRetention()
    dr = _find(rule, "DefaultRetention")
    if dr is None:
        return DefaultRetention()
    mode = _findtext(dr, "Mode").upper()
    if mode not in (GOVERNANCE, COMPLIANCE):
        raise ValueError(f"bad retention mode {mode!r}")
    days = int(_findtext(dr, "Days") or 0)
    years = int(_findtext(dr, "Years") or 0)
    if (days and years) or (not days and not years):
        raise ValueError("exactly one of Days or Years required")
    return DefaultRetention(mode=mode, days=days, years=years)


def lock_config_xml(enabled: bool, dr: DefaultRetention) -> bytes:
    out = ["<ObjectLockConfiguration>"]
    if enabled:
        out.append("<ObjectLockEnabled>Enabled</ObjectLockEnabled>")
    if dr.mode:
        out.append("<Rule><DefaultRetention>")
        out.append(f"<Mode>{dr.mode}</Mode>")
        if dr.days:
            out.append(f"<Days>{dr.days}</Days>")
        if dr.years:
            out.append(f"<Years>{dr.years}</Years>")
        out.append("</DefaultRetention></Rule>")
    out.append("</ObjectLockConfiguration>")
    return "".join(out).encode()


@dataclass
class Retention:
    mode: str = ""
    retain_until: str = ""

    @property
    def active(self) -> bool:
        if not self.mode or not self.retain_until:
            return False
        try:
            return parse_iso8601(self.retain_until) > time.time()
        except ValueError:
            return False


def retention_of(meta: dict) -> Retention:
    return Retention(mode=meta.get(META_MODE, "").upper(),
                     retain_until=meta.get(META_RETAIN_UNTIL, ""))


def legal_hold_of(meta: dict) -> str:
    return meta.get(META_LEGAL_HOLD, "").upper() or "OFF"


def check_put_headers(hdr, bucket: str, key: str, lock_enabled: bool,
                      default: DefaultRetention) -> dict:
    """Validate PUT object-lock headers and compute the metadata to store
    (applying the bucket default when the request sets none)."""
    mode = hdr.get(META_MODE, "").upper()
    until = hdr.get(META_RETAIN_UNTIL, "")
    hold = hdr.get(META_LEGAL_HOLD, "").upper()
    out: dict = {}
    if mode or until or hold:
        if not lock_enabled:
            raise dt.InvalidRequest(
                bucket, key,
                "object lock headers on a bucket without object lock")
    if mode or until:
        if mode not in (GOVERNANCE, COMPLIANCE) or not until:
            raise dt.InvalidRequest(bucket, key,
                                    "invalid object lock retention")
        try:
            until_t = parse_iso8601(until)
        except ValueError:
            raise dt.InvalidRequest(
                bucket, key, "invalid retain-until date") from None
        if until_t <= time.time():
            raise dt.InvalidRequest(bucket, key,
                                    "retain-until date must be in the future")
        out[META_MODE] = mode
        out[META_RETAIN_UNTIL] = until
    elif lock_enabled and default.mode:
        out[META_MODE] = default.mode
        out[META_RETAIN_UNTIL] = default.retain_until()
    if hold:
        if hold not in ("ON", "OFF"):
            raise dt.InvalidRequest(bucket, key, "invalid legal hold")
        out[META_LEGAL_HOLD] = hold
    return out


def check_delete_allowed(meta: dict, bucket: str, key: str,
                         bypass_governance: bool) -> None:
    """Raise when WORM state forbids deleting this version
    (cmd/bucket-object-lock.go enforceRetentionForDeletion)."""
    if legal_hold_of(meta) == "ON":
        raise dt.ObjectLocked(bucket, key, "legal hold is on")
    ret = retention_of(meta)
    if not ret.active:
        return
    if ret.mode == COMPLIANCE:
        raise dt.ObjectLocked(bucket, key, "COMPLIANCE retention active")
    if ret.mode == GOVERNANCE and not bypass_governance:
        raise dt.ObjectLocked(bucket, key, "GOVERNANCE retention active")
