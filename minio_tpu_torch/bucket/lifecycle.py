"""Bucket lifecycle (ILM), the port of minio_tpu/bucket/lifecycle.py
(reference pkg/bucket/lifecycle + cmd/bucket-lifecycle.go): the rule engine
over the bucket's lifecycle XML — expiration by age or date, prefix and tag
filters, noncurrent-version expiration, delete-marker cleanup, and the
Transition action through a ``TransitionSys`` (``bucket/transition.py``)
when one is attached. The data scanner applies it to every object it
walks."""
from __future__ import annotations

import datetime
import time
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from ..obs import metrics


@dataclass
class Rule:
    rule_id: str = ""
    status: str = "Enabled"
    prefix: str = ""
    tags: dict[str, str] = field(default_factory=dict)
    expiration_days: int = 0
    expiration_date: float = 0.0
    expire_delete_marker: bool = False
    noncurrent_days: int = 0
    transition_days: int = 0
    transition_tier: str = ""   # <StorageClass> = admin-configured tier

    @property
    def enabled(self) -> bool:
        return self.status == "Enabled"


def _strip(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse_lifecycle(xml_blob: bytes) -> list[Rule]:
    if not xml_blob:
        return []
    root = ET.fromstring(xml_blob)
    for el in root.iter():
        el.tag = _strip(el.tag)
    rules = []
    for r in root.findall(".//Rule"):
        rule = Rule(rule_id=r.findtext("ID", ""),
                    status=r.findtext("Status", "Enabled"))
        f = r.find("Filter")
        if f is not None:
            rule.prefix = f.findtext("Prefix", "") or \
                f.findtext("And/Prefix", "")
            for t in f.findall(".//Tag"):
                rule.tags[t.findtext("Key", "")] = t.findtext("Value", "")
        else:
            rule.prefix = r.findtext("Prefix", "")
        exp = r.find("Expiration")
        if exp is not None:
            rule.expiration_days = int(exp.findtext("Days", "0") or "0")
            date_s = exp.findtext("Date", "")
            if date_s:
                rule.expiration_date = datetime.datetime.fromisoformat(
                    date_s.replace("Z", "+00:00")).timestamp()
            rule.expire_delete_marker = exp.findtext(
                "ExpiredObjectDeleteMarker", "false") == "true"
        nexp = r.find("NoncurrentVersionExpiration")
        if nexp is not None:
            rule.noncurrent_days = int(
                nexp.findtext("NoncurrentDays", "0") or "0")
        tr = r.find("Transition")
        if tr is not None:
            rule.transition_days = int(tr.findtext("Days", "0") or "0")
            rule.transition_tier = tr.findtext("StorageClass", "")
        rules.append(rule)
    return rules


class LifecycleSys:
    """Evaluates rules during scanner cycles (reference applies them in the
    scanner's scanFolder — cmd/data-scanner.go)."""

    def __init__(self, objlayer, bucket_meta, transition_sys=None):
        self.obj = objlayer
        self.bucket_meta = bucket_meta
        #: optional TransitionSys (bucket.transition) enabling the
        #: Transition action; None = transition rules are inert
        self.transition_sys = transition_sys
        self.expired = 0
        #: bucket -> (xml blob, parsed rules) — re-parse only on change
        self._cache: dict[str, tuple[bytes, list[Rule]]] = {}

    def rules_for(self, bucket: str) -> list[Rule]:
        blob = self.bucket_meta.get(bucket).lifecycle_xml
        cached = self._cache.get(bucket)
        if cached is not None and cached[0] == blob:
            return cached[1]
        rules = parse_lifecycle(blob)
        self._cache[bucket] = (blob, rules)
        return rules

    def apply(self, bucket: str, oi) -> bool:
        """Returns True if the object was expired/removed."""
        rules = self.rules_for(bucket)
        if not rules:
            return False
        now = time.time()
        tags: dict[str, str] | None = None  # fetched at most once
        for r in rules:
            if not r.enabled:
                continue
            if r.prefix and not oi.name.startswith(r.prefix):
                continue
            if r.tags:
                if tags is None:
                    try:
                        enc = self.obj.get_object_tags(bucket, oi.name)
                        tags = dict(urllib.parse.parse_qsl(enc))
                    except Exception:  # noqa: BLE001
                        tags = {}
                if any(tags.get(k) != v for k, v in r.tags.items()):
                    continue
            from ..objectlayer.datatypes import ObjectOptions
            # stale delete marker: a latest delete marker whose data
            # versions are all gone (num_versions == 1)
            if r.expire_delete_marker and oi.delete_marker \
                    and oi.is_latest and oi.num_versions <= 1:
                self.obj.delete_object(bucket, oi.name, ObjectOptions(
                    version_id=oi.version_id or "null", versioned=True))
                self.expired += 1
                metrics.inc("minio_tpu_ilm_expired_total")
                return True
            # noncurrent version expiry
            if r.noncurrent_days and not oi.is_latest and \
                    now - oi.mod_time >= r.noncurrent_days * 86400:
                self.obj.delete_object(bucket, oi.name, ObjectOptions(
                    version_id=oi.version_id or "null", versioned=True))
                self.expired += 1
                metrics.inc("minio_tpu_ilm_expired_total")
                return True
            expired = False
            if r.expiration_days and \
                    now - oi.mod_time >= r.expiration_days * 86400:
                expired = True
            if r.expiration_date and now >= r.expiration_date:
                # S3 semantics: once the date passes, every matching
                # object expires, regardless of creation time
                expired = True
            if expired and not oi.delete_marker:
                if self.transition_sys is not None:
                    from .transition import is_transitioned
                    if is_transitioned(oi):
                        # the tier key lives only in this stub: reclaim
                        # the tier copy before the stub disappears
                        self.transition_sys.delete_remote(oi)
                versioned = self.bucket_meta.versioning_enabled(bucket)
                self.obj.delete_object(bucket, oi.name,
                                       ObjectOptions(versioned=versioned))
                self.expired += 1
                metrics.inc("minio_tpu_ilm_expired_total")
                return True
            # transition to tier (cmd/bucket-lifecycle.go:365)
            if self.transition_sys is not None:
                from .transition import is_transitioned
                if self.transition_sys.maybe_restub(bucket, oi):
                    return False  # restored window lapsed: stubbed again
                if r.transition_days and r.transition_tier and \
                        not is_transitioned(oi) and \
                        now - oi.mod_time >= r.transition_days * 86400:
                    try:
                        moved = self.transition_sys.transition(
                            bucket, oi, r.transition_tier)
                    except Exception:  # noqa: BLE001 — tier down: retry
                        moved = False  # next cycle
                    if moved:
                        # the in-memory oi is now stale (object became a
                        # stub); stop evaluating further rules against it
                        # or a second Transition clause would archive the
                        # empty stub over the real pointer
                        return False
        return False
