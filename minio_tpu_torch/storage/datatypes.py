"""Storage data types — the port of storage/datatypes.py, the Python form
of the reference's cmd/storage-datatypes.go (FileInfo, DiskInfo, VolInfo)
and the erasure geometry record carried inside xl.meta (ErasureInfo,
cmd/xl-storage-format-v1.go:86 / xlMetaV2Object EcM/EcN/... fields,
cmd/xl-storage-format-v2.go:148-166). The dict forms' keys and their order
are the JAX package's: both packages write the same xl.meta bytes.
"""
from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field


@dataclass
class ObjectPartInfo:
    """One object part (cmd/xl-storage-format-v1.go ObjectPartInfo)."""
    number: int
    etag: str = ""
    size: int = 0            # on-wire (possibly compressed/encrypted) size
    actual_size: int = 0     # original client size

    def to_dict(self):
        return {"n": self.number, "e": self.etag, "s": self.size,
                "as": self.actual_size}

    @classmethod
    def from_dict(cls, d):
        return cls(number=d["n"], etag=d.get("e", ""), size=d.get("s", 0),
                   actual_size=d.get("as", 0))


@dataclass
class ChecksumInfo:
    """Per-part bitrot checksum (whole-file algorithms only; streaming algos
    verify inline and store an empty hash — cmd/erasure-metadata.go)."""
    part_number: int
    algorithm: str
    hash: bytes = b""

    def to_dict(self):
        return {"n": self.part_number, "a": self.algorithm, "h": self.hash}

    @classmethod
    def from_dict(cls, d):
        return cls(part_number=d["n"], algorithm=d["a"], hash=d.get("h", b""))


@dataclass
class ErasureInfo:
    """Erasure geometry persisted per version (EcAlgo/EcM/EcN/EcBSize/
    EcIndex/EcDist + checksums)."""
    algorithm: str = "reedsolomon"
    data_blocks: int = 0
    parity_blocks: int = 0
    block_size: int = 0
    index: int = 0                      # 1-based shard index on this disk
    distribution: list[int] = field(default_factory=list)
    checksums: list[ChecksumInfo] = field(default_factory=list)

    def shard_file_size(self, total_length: int) -> int:
        from ..erasure.codec import shard_file_size
        return shard_file_size(total_length, self.block_size,
                               self.data_blocks)

    def shard_size(self) -> int:
        from ..erasure.codec import ceil_div
        return ceil_div(self.block_size, self.data_blocks)

    def to_dict(self):
        return {"algo": self.algorithm, "m": self.data_blocks,
                "n": self.parity_blocks, "bs": self.block_size,
                "i": self.index, "dist": list(self.distribution),
                "cs": [c.to_dict() for c in self.checksums]}

    @classmethod
    def from_dict(cls, d):
        return cls(algorithm=d.get("algo", "reedsolomon"),
                   data_blocks=d.get("m", 0), parity_blocks=d.get("n", 0),
                   block_size=d.get("bs", 0), index=d.get("i", 0),
                   distribution=list(d.get("dist", [])),
                   checksums=[ChecksumInfo.from_dict(c)
                              for c in d.get("cs", [])])


@dataclass
class FileInfo:
    """In-memory form of one object version on one disk (reference FileInfo,
    cmd/storage-datatypes.go:103)."""
    volume: str = ""
    name: str = ""
    version_id: str = ""           # "" = null version
    is_latest: bool = True
    deleted: bool = False          # delete marker
    data_dir: str = ""             # uuid of the part-data directory
    mod_time: float = 0.0          # unix seconds (float: ns precision)
    size: int = 0
    metadata: dict[str, str] = field(default_factory=dict)
    parts: list[ObjectPartInfo] = field(default_factory=list)
    erasure: ErasureInfo = field(default_factory=ErasureInfo)
    data: bytes | None = None      # inlined small-object data (A.4)
    num_versions: int = 0
    fresh: bool = False            # first write of this object

    @property
    def is_remote(self) -> bool:
        return False

    def write_quorum(self, default_parity: int) -> int:
        """data(+1 if data==parity) — cmd/erasure-object.go:631-634."""
        d = self.erasure.data_blocks or default_parity
        p = self.erasure.parity_blocks or default_parity
        return d + 1 if d == p else d

    def read_quorum(self) -> int:
        return self.erasure.data_blocks

    @staticmethod
    def new_version_id() -> str:
        return str(uuid.uuid4())

    @staticmethod
    def now() -> float:
        return time.time()

    def to_rpc(self) -> dict:
        """The storage REST wire form (the JAX package's keys)."""
        return {
            "v": self.volume, "n": self.name, "vid": self.version_id,
            "lat": self.is_latest, "del": self.deleted, "dd": self.data_dir,
            "mt": self.mod_time, "sz": self.size, "meta": self.metadata,
            "parts": [p.to_dict() for p in self.parts],
            "ec": self.erasure.to_dict(), "data": self.data,
            "nv": self.num_versions, "fresh": self.fresh,
        }

    @classmethod
    def from_rpc(cls, d: dict) -> "FileInfo":
        return cls(
            volume=d.get("v", ""), name=d.get("n", ""),
            version_id=d.get("vid", ""), is_latest=d.get("lat", True),
            deleted=d.get("del", False), data_dir=d.get("dd", ""),
            mod_time=d.get("mt", 0.0), size=d.get("sz", 0),
            metadata=dict(d.get("meta", {})),
            parts=[ObjectPartInfo.from_dict(p) for p in d.get("parts", [])],
            erasure=ErasureInfo.from_dict(d.get("ec", {})),
            data=d.get("data"), num_versions=d.get("nv", 0),
            fresh=d.get("fresh", False))


@dataclass
class VolInfo:
    name: str
    created: float = 0.0


@dataclass
class DiskInfo:
    """Disk health/capacity snapshot (reference DiskInfo,
    cmd/storage-datatypes.go:38)."""
    total: int = 0
    free: int = 0
    used: int = 0
    used_inodes: int = 0
    fs_type: str = ""
    root_disk: bool = False
    healing: bool = False
    endpoint: str = ""
    mount_path: str = ""
    id: str = ""
    error: str = ""
