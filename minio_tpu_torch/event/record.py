"""S3 event record construction, the port of minio_tpu/event/record.py
(reference pkg/event/event.go: the
eventVersion 2.0 JSON shape every AWS-compatible consumer parses)."""
from __future__ import annotations

import time
import urllib.parse


def new_event_record(event_name: str, bucket: str, oi,
                     region: str = "us-east-1",
                     request_params: dict | None = None,
                     sequencer: str = "") -> dict:
    """One S3 notification record; ``oi`` is an ObjectInfo (or anything
    with name/size/etag/version_id attributes)."""
    now = time.time()
    key = urllib.parse.quote(getattr(oi, "name", ""))
    if not sequencer:
        sequencer = f"{int(now * 1e9):016X}"
    return {
        "eventVersion": "2.0",
        "eventSource": "aws:s3",
        "awsRegion": region,
        "eventTime": time.strftime("%Y-%m-%dT%H:%M:%S.", time.gmtime(now))
        + f"{int(now * 1000) % 1000:03d}Z",
        "eventName": event_name.removeprefix("s3:"),
        "userIdentity": {"principalId": "minio-tpu"},
        "requestParameters": request_params or {},
        "responseElements": {},
        "s3": {
            "s3SchemaVersion": "1.0",
            "configurationId": "Config",
            "bucket": {
                "name": bucket,
                "ownerIdentity": {"principalId": "minio-tpu"},
                "arn": f"arn:aws:s3:::{bucket}",
            },
            "object": {
                "key": key,
                "size": getattr(oi, "size", 0),
                "eTag": getattr(oi, "etag", ""),
                "versionId": getattr(oi, "version_id", "") or "",
                "sequencer": sequencer,
            },
        },
    }
