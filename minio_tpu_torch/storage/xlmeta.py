"""xl.meta — the per-object-version metadata journal, the port of
storage/xlmeta.py (reference cmd/xl-storage-format-v2.go; layout doc
SURVEY.md Appendix A.1/A.2). Packed with the port's own MessagePack subset
(utils/msgpack.py): the bytes are the JAX package's, so either package
reads the other's journals.

File layout: 8-byte magic header ``XLT2 1  `` (our format identifier — same
role as the reference's ``XL2 `` + version ``1   `` at
cmd/xl-storage-format-v2.go:33-38) followed by one msgpack map:

    {"Versions": [ {"Type": 1|2, "ModTime": f64, "V": {...}} ... ],
     "Data": {dataDir?: inlined bytes}}          # small-object inlining (A.4)

New blobs write format version 2 (``XLT2 2  ``) and end with a
``XLC1`` + CRC32 torn-write detector (see XL_TRAILER_MAGIC below);
version-1 blobs load trailer-free for backward compatibility.

Versions are kept sorted newest-first. Type 1 = object (full FileInfo incl.
erasure geometry), Type 2 = delete marker. The legacy v1 type is not carried
over — this framework has no pre-v2 history to migrate.
"""
from __future__ import annotations

import struct
import zlib

from ..utils import errors
from ..utils import msgpack
from .datatypes import ErasureInfo, FileInfo, ObjectPartInfo

#: legacy format version: msgpack only, no trailer
XL_HEADER = b"XLT2 1  "
#: current format version: msgpack + REQUIRED trailing checksum
XL_HEADER_V2 = b"XLT2 2  "
XL_META_FILE = "xl.meta"
#: quarantine name the recovery plane renames unparseable journals to
#: (forensics survive; the object slot becomes healable)
XL_META_CORRUPT_FILE = "xl.meta.corrupt"

#: trailing torn-write detector: every dump() writes the version-2
#: header and appends this magic + a CRC32 of everything before it. A
#: power cut mid-writeback leaves a v2 blob
#: whose trailer is missing or whose checksum mismatches — load()
#: rejects it as FileCorrupt instead of serving a silently truncated
#: version journal. The header version (not tail-sniffing) decides
#: whether a trailer is expected, so a legacy v1 blob whose inlined
#: data happens to end with the magic bytes can never be misread as
#: torn; v1 blobs load trailer-free (older stores stay readable).
XL_TRAILER_MAGIC = b"XLC1"
XL_TRAILER_LEN = len(XL_TRAILER_MAGIC) + 4

TYPE_OBJECT = 1
TYPE_DELETE_MARKER = 2

#: Objects <= this inline their single part into xl.meta (smallFileThreshold,
#: cmd/xl-storage.go:67).
SMALL_FILE_THRESHOLD = 128 << 10

#: Null-version sentinel used in version maps.
NULL_VERSION = ""


def _version_to_dict(fi: FileInfo) -> dict:
    if fi.deleted:
        return {"Type": TYPE_DELETE_MARKER, "ModTime": fi.mod_time,
                "V": {"id": fi.version_id}}
    return {
        "Type": TYPE_OBJECT, "ModTime": fi.mod_time,
        "V": {
            "id": fi.version_id,
            "ddir": fi.data_dir,
            "size": fi.size,
            "meta": dict(fi.metadata),
            "parts": [p.to_dict() for p in fi.parts],
            "ec": fi.erasure.to_dict(),
        },
    }


def _version_to_fileinfo(d: dict, volume: str, name: str) -> FileInfo:
    v = d.get("V", {})
    if d["Type"] == TYPE_DELETE_MARKER:
        return FileInfo(volume=volume, name=name, version_id=v.get("id", ""),
                        deleted=True, mod_time=d.get("ModTime", 0.0))
    return FileInfo(
        volume=volume, name=name, version_id=v.get("id", ""),
        data_dir=v.get("ddir", ""), mod_time=d.get("ModTime", 0.0),
        size=v.get("size", 0), metadata=dict(v.get("meta", {})),
        parts=[ObjectPartInfo.from_dict(p) for p in v.get("parts", [])],
        erasure=ErasureInfo.from_dict(v.get("ec", {})),
    )


class XLMeta:
    """Parsed xl.meta: a newest-first version journal + inline data blobs."""

    def __init__(self):
        self.versions: list[dict] = []
        self.data: dict[str, bytes] = {}

    # -- serialization -------------------------------------------------------

    @classmethod
    def load(cls, blob: bytes) -> "XLMeta":
        if len(blob) < len(XL_HEADER) or blob[:4] != XL_HEADER[:4]:
            raise errors.FileCorrupt("bad xl.meta header")
        if blob[:len(XL_HEADER_V2)] == XL_HEADER_V2:
            # v2: the trailer is REQUIRED — a tear that removes exactly
            # the trailer bytes is detected too, not mistaken for legacy
            if len(blob) < len(XL_HEADER_V2) + XL_TRAILER_LEN or \
                    blob[-XL_TRAILER_LEN:-4] != XL_TRAILER_MAGIC:
                raise errors.FileCorrupt(
                    "xl.meta v2 trailer missing (torn write)")
            (want,) = struct.unpack("<I", blob[-4:])
            if zlib.crc32(blob[:-XL_TRAILER_LEN]) & 0xFFFFFFFF != want:
                raise errors.FileCorrupt(
                    "xl.meta trailer checksum mismatch (torn write)")
            payload = blob[len(XL_HEADER_V2):-XL_TRAILER_LEN]
        else:
            payload = blob[len(XL_HEADER):]  # v1 legacy: no trailer
        m = cls()
        try:
            doc = msgpack.unpackb(payload)
        except Exception as e:  # noqa: BLE001
            raise errors.FileCorrupt(f"xl.meta unpack: {e}") from e
        m.versions = list(doc.get("Versions", []))
        m.data = {k: v for k, v in doc.get("Data", {}).items()}
        return m

    def dump(self) -> bytes:
        doc = {"Versions": self.versions, "Data": self.data}
        body = XL_HEADER_V2 + msgpack.packb(doc)
        return body + XL_TRAILER_MAGIC + \
            struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)

    # -- journal ops ---------------------------------------------------------

    def _sort(self):
        self.versions.sort(key=lambda d: d.get("ModTime", 0.0), reverse=True)

    def add_version(self, fi: FileInfo) -> list[str]:
        """Insert/replace a version (AddVersion,
        cmd/xl-storage-format-v2.go). Replacement key: version_id. Returns
        the dataDir uuids of any replaced versions so the caller can delete
        their part files (otherwise unversioned overwrites leak data dirs)."""
        vid = fi.version_id
        old_ddirs: list[str] = []
        kept = []
        for d in self.versions:
            if d.get("V", {}).get("id", "") == vid:
                ddir = d.get("V", {}).get("ddir", "")
                if ddir and ddir != fi.data_dir:
                    old_ddirs.append(ddir)
                    self.data.pop(ddir, None)
            else:
                kept.append(d)
        self.versions = kept
        self.versions.append(_version_to_dict(fi))
        if fi.data is not None and fi.data_dir:
            self.data[fi.data_dir] = fi.data
        self._sort()
        return old_ddirs

    def delete_version(self, fi: FileInfo) -> str:
        """Remove a version; returns its dataDir uuid (for part cleanup) or
        "". If fi.deleted, a delete marker is *added* instead."""
        if fi.deleted:
            self.add_version(fi)
            return ""
        vid = fi.version_id
        ddir = ""
        kept = []
        found = False
        for d in self.versions:
            if d.get("V", {}).get("id", "") == vid:
                found = True
                ddir = d.get("V", {}).get("ddir", "")
            else:
                kept.append(d)
        if not found:
            raise errors.FileVersionNotFound(vid)
        self.versions = kept
        if ddir and ddir in self.data:
            del self.data[ddir]
        return ddir

    def find_version(self, version_id: str) -> dict:
        """"" = latest; "null" = the null (unversioned) version, whose
        journal id is ""; anything else = exact uuid match."""
        if version_id == NULL_VERSION and self.versions:
            return self.versions[0]  # latest
        want = "" if version_id == "null" else version_id
        for d in self.versions:
            if d.get("V", {}).get("id", "") == want:
                return d
        raise errors.FileVersionNotFound(version_id)

    def to_fileinfo(self, volume: str, name: str, version_id: str = "",
                    ) -> FileInfo:
        if not self.versions:
            raise errors.FileNotFound(name)
        d = self.find_version(version_id)
        fi = _version_to_fileinfo(d, volume, name)
        fi.is_latest = d is self.versions[0]
        fi.num_versions = len(self.versions)
        if fi.data_dir and fi.data_dir in self.data:
            fi.data = self.data[fi.data_dir]
        return fi

    def latest_mod_time(self) -> float:
        return self.versions[0].get("ModTime", 0.0) if self.versions else 0.0

    def list_versions(self, volume: str, name: str) -> list[FileInfo]:
        out = []
        for i, d in enumerate(self.versions):
            fi = _version_to_fileinfo(d, volume, name)
            fi.is_latest = i == 0
            fi.num_versions = len(self.versions)
            out.append(fi)
        return out
