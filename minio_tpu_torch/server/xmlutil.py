"""S3 XML response rendering and request parsing, the port of
minio_tpu/server/xmlutil.py (reference
cmd/api-response.go, cmd/api-errors.go XML shapes)."""
from __future__ import annotations

import datetime
import xml.etree.ElementTree as ET
from xml.sax.saxutils import escape

S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


def iso8601(ts: float) -> str:
    return datetime.datetime.fromtimestamp(
        ts, tz=datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] \
        + "Z"


def http_date(ts: float) -> str:
    return datetime.datetime.fromtimestamp(
        ts, tz=datetime.timezone.utc).strftime("%a, %d %b %Y %H:%M:%S GMT")


class X:
    """Tiny XML writer."""

    def __init__(self, tag: str, ns: str = ""):
        self.parts = [f'<?xml version="1.0" encoding="UTF-8"?>']
        attrs = f' xmlns="{ns}"' if ns else ""
        self.parts.append(f"<{tag}{attrs}>")
        self._stack = [tag]

    def el(self, tag: str, text=None) -> "X":
        if text is None:
            self.parts.append(f"<{tag}/>")
        else:
            self.parts.append(f"<{tag}>{escape(str(text))}</{tag}>")
        return self

    def open(self, tag: str) -> "X":
        self.parts.append(f"<{tag}>")
        self._stack.append(tag)
        return self

    def close(self) -> "X":
        self.parts.append(f"</{self._stack.pop()}>")
        return self

    def done(self) -> bytes:
        while self._stack:
            self.close()
        return "".join(self.parts).encode()


def error_xml(code: str, message: str, resource: str = "",
              request_id: str = "", host_id: str = "minio-tpu") -> bytes:
    x = X("Error")
    x.el("Code", code).el("Message", message)
    x.el("Resource", resource).el("RequestId", request_id)
    x.el("HostId", host_id)
    return x.done()


def list_buckets_xml(buckets, owner: str = "minio-tpu") -> bytes:
    x = X("ListAllMyBucketsResult", S3_NS)
    x.open("Owner").el("ID", owner).el("DisplayName", owner).close()
    x.open("Buckets")
    for b in buckets:
        x.open("Bucket").el("Name", b.name) \
            .el("CreationDate", iso8601(b.created)).close()
    return x.done()


def _obj_entry(x, o, versions=False):
    x.el("Key", o.name)
    if versions:
        x.el("VersionId", o.version_id or "null")
        x.el("IsLatest", "true" if o.is_latest else "false")
    x.el("LastModified", iso8601(o.mod_time))
    if not o.delete_marker:
        x.el("ETag", f'"{o.etag}"')
        x.el("Size", o.size)
        x.el("StorageClass", o.storage_class or "STANDARD")
    x.open("Owner").el("ID", "minio-tpu").el(
        "DisplayName", "minio-tpu").close()


def list_objects_v2_xml(bucket, prefix, delimiter, max_keys, result,
                        continuation_token="", start_after="") -> bytes:
    x = X("ListBucketResult", S3_NS)
    x.el("Name", bucket).el("Prefix", prefix)
    if delimiter:
        x.el("Delimiter", delimiter)
    x.el("MaxKeys", max_keys)
    x.el("KeyCount", len(result.objects) + len(result.prefixes))
    x.el("IsTruncated", "true" if result.is_truncated else "false")
    if continuation_token:
        x.el("ContinuationToken", continuation_token)
    if result.is_truncated and result.next_marker:
        x.el("NextContinuationToken", result.next_marker)
    for o in result.objects:
        x.open("Contents")
        _obj_entry(x, o)
        x.close()
    for p in result.prefixes:
        x.open("CommonPrefixes").el("Prefix", p).close()
    return x.done()


def list_objects_v1_xml(bucket, prefix, delimiter, marker, max_keys,
                        result) -> bytes:
    x = X("ListBucketResult", S3_NS)
    x.el("Name", bucket).el("Prefix", prefix).el("Marker", marker)
    if delimiter:
        x.el("Delimiter", delimiter)
    x.el("MaxKeys", max_keys)
    x.el("IsTruncated", "true" if result.is_truncated else "false")
    if result.is_truncated and result.next_marker:
        x.el("NextMarker", result.next_marker)
    for o in result.objects:
        x.open("Contents")
        _obj_entry(x, o)
        x.close()
    for p in result.prefixes:
        x.open("CommonPrefixes").el("Prefix", p).close()
    return x.done()


def list_versions_xml(bucket, prefix, delimiter, max_keys, result) -> bytes:
    x = X("ListVersionsResult", S3_NS)
    x.el("Name", bucket).el("Prefix", prefix)
    if delimiter:
        x.el("Delimiter", delimiter)
    x.el("MaxKeys", max_keys)
    x.el("IsTruncated", "true" if result.is_truncated else "false")
    if result.is_truncated:
        x.el("NextKeyMarker", result.next_key_marker)
        x.el("NextVersionIdMarker", result.next_version_id_marker)
    for o in result.objects:
        x.open("DeleteMarker" if o.delete_marker else "Version")
        _obj_entry(x, o, versions=True)
        x.close()
    for p in result.prefixes:
        x.open("CommonPrefixes").el("Prefix", p).close()
    return x.done()


def initiate_multipart_xml(bucket, key, upload_id) -> bytes:
    return (X("InitiateMultipartUploadResult", S3_NS)
            .el("Bucket", bucket).el("Key", key)
            .el("UploadId", upload_id).done())


def complete_multipart_xml(location, bucket, key, etag) -> bytes:
    return (X("CompleteMultipartUploadResult", S3_NS)
            .el("Location", location).el("Bucket", bucket)
            .el("Key", key).el("ETag", f'"{etag}"').done())


def list_parts_xml(info) -> bytes:
    x = X("ListPartsResult", S3_NS)
    x.el("Bucket", info.bucket).el("Key", info.object)
    x.el("UploadId", info.upload_id)
    x.el("PartNumberMarker", info.part_number_marker)
    x.el("NextPartNumberMarker", info.next_part_number_marker)
    x.el("MaxParts", info.max_parts)
    x.el("IsTruncated", "true" if info.is_truncated else "false")
    for p in info.parts:
        x.open("Part")
        x.el("PartNumber", p.part_number)
        x.el("LastModified", iso8601(p.last_modified))
        x.el("ETag", f'"{p.etag}"')
        x.el("Size", p.size)
        x.close()
    return x.done()


def list_uploads_xml(bucket, prefix, max_uploads, info) -> bytes:
    x = X("ListMultipartUploadsResult", S3_NS)
    x.el("Bucket", bucket).el("Prefix", prefix)
    x.el("MaxUploads", max_uploads)
    x.el("IsTruncated", "true" if info.is_truncated else "false")
    for u in info.uploads:
        x.open("Upload")
        x.el("Key", u.object)
        x.el("UploadId", u.upload_id)
        x.el("Initiated", iso8601(u.initiated))
        x.open("Owner").el("ID", "minio-tpu").close()
        x.close()
    return x.done()


def copy_object_xml(etag: str, mod_time: float) -> bytes:
    return (X("CopyObjectResult", S3_NS)
            .el("ETag", f'"{etag}"')
            .el("LastModified", iso8601(mod_time)).done())


def delete_result_xml(deleted, errs) -> bytes:
    x = X("DeleteResult", S3_NS)
    for d, e in zip(deleted, errs):
        if e is not None or d is None:
            x.open("Error")
            x.el("Key", getattr(d, "object_name", ""))
            vid = getattr(d, "version_id", "")
            if vid:
                x.el("VersionId", vid)
            x.el("Code", getattr(e, "code", "InternalError"))
            x.el("Message", str(e))
            x.close()
        else:
            x.open("Deleted")
            x.el("Key", d.object_name)
            if d.version_id:
                x.el("VersionId", d.version_id)
            if d.delete_marker:
                x.el("DeleteMarker", "true")
                x.el("DeleteMarkerVersionId", d.delete_marker_version_id)
            x.close()
    return x.done()


def versioning_xml(enabled: bool, suspended: bool = False) -> bytes:
    x = X("VersioningConfiguration", S3_NS)
    if enabled:
        x.el("Status", "Enabled")
    elif suspended:
        x.el("Status", "Suspended")
    return x.done()


def location_xml(region: str) -> bytes:
    # LocationConstraint has text content, empty for us-east-1
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f'<LocationConstraint xmlns="{S3_NS}">'
            f'{escape(region) if region != "us-east-1" else ""}'
            f"</LocationConstraint>").encode()


def tagging_xml(tags: dict[str, str]) -> bytes:
    x = X("Tagging", S3_NS)
    x.open("TagSet")
    for k, v in tags.items():
        x.open("Tag").el("Key", k).el("Value", v).close()
    return x.done()


# --- request XML parsing ------------------------------------------------------


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse_xml(body: bytes) -> ET.Element:
    root = ET.fromstring(body)
    for el in root.iter():
        el.tag = _strip_ns(el.tag)
    return root


def parse_complete_multipart(body: bytes):
    from ..objectlayer.datatypes import CompletePart
    root = parse_xml(body)
    parts = []
    for p in root.findall(".//Part"):
        parts.append(CompletePart(
            part_number=int(p.findtext("PartNumber")),
            etag=p.findtext("ETag", "").strip().strip('"')))
    return parts


def parse_delete_objects(body: bytes):
    root = parse_xml(body)
    objs = []
    quiet = (root.findtext("Quiet", "false").lower() == "true")
    for o in root.findall(".//Object"):
        objs.append({"object": o.findtext("Key", ""),
                     "version_id": o.findtext("VersionId", "") or ""})
    return objs, quiet


def parse_tagging(body: bytes) -> dict[str, str]:
    root = parse_xml(body)
    return {t.findtext("Key", ""): t.findtext("Value", "")
            for t in root.findall(".//Tag")}


def parse_versioning(body: bytes) -> bool:
    root = parse_xml(body)
    return root.findtext("Status", "") == "Enabled"


def sts_credentials_xml(action: str, access_key: str, secret_key: str,
                        expiration: str) -> bytes:
    """An STS action's answer (reference cmd/sts-datatypes.go): the
    temporary credentials under ``<{action}Result>``, byte for byte the
    JAX server's."""
    result = f"{action}Result"
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        f'<{action}Response xmlns='
        '"https://sts.amazonaws.com/doc/2011-06-15/">'
        f"<{result}><Credentials>"
        f"<AccessKeyId>{access_key}</AccessKeyId>"
        f"<SecretAccessKey>{secret_key}</SecretAccessKey>"
        f"<SessionToken>minio-tpu-session</SessionToken>"
        f"<Expiration>{expiration}</Expiration>"
        f"</Credentials></{result}></{action}Response>"
    ).encode()
