"""Notification configuration, the port of minio_tpu/event/rules.py: XML
parsing + (event, key) -> ARN routing (reference pkg/event/config.go +
rules.go)."""
from __future__ import annotations

import fnmatch
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def _findall(el, tag):
    return el.findall(tag) + el.findall(_NS + tag)


def _findtext(el, tag) -> str:
    v = el.findtext(tag)
    if v is None:
        v = el.findtext(_NS + tag)
    return v or ""


@dataclass
class Rule:
    arn: str
    events: list[str] = field(default_factory=list)
    prefix: str = ""
    suffix: str = ""

    def matches(self, event_name: str, key: str) -> bool:
        if not any(fnmatch.fnmatchcase(event_name, pat)
                   for pat in self.events):
            return False
        return key.startswith(self.prefix) and key.endswith(self.suffix)


@dataclass
class NotificationRules:
    rules: list[Rule] = field(default_factory=list)

    def route(self, event_name: str, key: str) -> list[str]:
        """ARNs to deliver this event to (deduplicated, order kept)."""
        out: list[str] = []
        for r in self.rules:
            if r.arn not in out and r.matches(event_name, key):
                out.append(r.arn)
        return out

    def arns(self) -> set[str]:
        return {r.arn for r in self.rules}


def parse_notification_xml(xml_bytes: bytes) -> NotificationRules:
    """Parse <NotificationConfiguration> with QueueConfiguration entries
    (the reference addresses all 11 target kinds through the queue ARN
    namespace arn:minio:sqs::<id>:<kind>)."""
    rules: list[Rule] = []
    if not xml_bytes.strip():
        return NotificationRules()
    root = ET.fromstring(xml_bytes)
    for qc in _findall(root, "QueueConfiguration") + \
            _findall(root, "CloudFunctionConfiguration") + \
            _findall(root, "TopicConfiguration"):
        arn = _findtext(qc, "Queue") or _findtext(qc, "CloudFunction") \
            or _findtext(qc, "Topic")
        events = [(e.text or "").strip() for e in _findall(qc, "Event")]
        prefix = suffix = ""
        for flt in _findall(qc, "Filter"):
            for s3k in _findall(flt, "S3Key"):
                for fr in _findall(s3k, "FilterRule"):
                    name = _findtext(fr, "Name").lower()
                    value = _findtext(fr, "Value")
                    if name == "prefix":
                        prefix = value
                    elif name == "suffix":
                        suffix = value
        if arn and events:
            rules.append(Rule(arn=arn, events=events, prefix=prefix,
                              suffix=suffix))
    return NotificationRules(rules)
