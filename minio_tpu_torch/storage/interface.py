"""StorageAPI — the port of storage/interface.py: the disk abstraction
every erasure component codes against (reference
cmd/storage-interface.go:25: one interface served by the local posix
backend and by the remote REST client, so the encode/decode path works over
local and remote disks transparently — SURVEY.md §1 L3→L2).

Streams: create_file_writer returns an object with write()/close()/abort();
read_file_at returns an object with read_at(offset, length). These are what
the bitrot writer/reader wrap.
"""
from __future__ import annotations

import abc
from typing import Iterator

from .datatypes import DiskInfo, FileInfo, VolInfo


class StorageAPI(abc.ABC):
    # --- identity / health --------------------------------------------------

    @abc.abstractmethod
    def disk_info(self) -> DiskInfo: ...

    @abc.abstractmethod
    def endpoint(self) -> str: ...

    def is_local(self) -> bool:
        return True

    def is_online(self) -> bool:
        return True

    def close(self) -> None:
        pass

    def get_disk_id(self) -> str:
        return ""

    def set_disk_id(self, disk_id: str) -> None:
        pass

    # --- volumes ------------------------------------------------------------

    @abc.abstractmethod
    def make_vol(self, volume: str) -> None: ...

    def make_vols(self, volumes: list[str]) -> None:
        from ..utils import errors
        for v in volumes:
            try:
                self.make_vol(v)
            except errors.VolumeExists:
                pass

    @abc.abstractmethod
    def list_vols(self) -> list[VolInfo]: ...

    @abc.abstractmethod
    def stat_vol(self, volume: str) -> VolInfo: ...

    @abc.abstractmethod
    def delete_vol(self, volume: str, force: bool = False) -> None: ...

    # --- raw files ----------------------------------------------------------

    @abc.abstractmethod
    def list_dir(self, volume: str, dir_path: str, count: int = -1
                 ) -> list[str]: ...

    @abc.abstractmethod
    def read_all(self, volume: str, path: str) -> bytes: ...

    @abc.abstractmethod
    def write_all(self, volume: str, path: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def append_file(self, volume: str, path: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def create_file_writer(self, volume: str, path: str): ...

    @abc.abstractmethod
    def read_file_at(self, volume: str, path: str): ...

    @abc.abstractmethod
    def rename_file(self, src_volume: str, src_path: str, dst_volume: str,
                    dst_path: str) -> None: ...

    @abc.abstractmethod
    def delete_path(self, volume: str, path: str, recursive: bool = False
                    ) -> None: ...

    @abc.abstractmethod
    def stat_file_size(self, volume: str, path: str) -> int: ...

    # --- object versions (xl.meta) ------------------------------------------

    @abc.abstractmethod
    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str) -> None: ...

    @abc.abstractmethod
    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def update_metadata(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def read_version(self, volume: str, path: str, version_id: str = "",
                     read_data: bool = False) -> FileInfo: ...

    @abc.abstractmethod
    def list_versions(self, volume: str, path: str) -> list[FileInfo]: ...

    @abc.abstractmethod
    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None: ...

    def delete_versions(self, volume: str, paths: list[str],
                        fis: list[FileInfo]) -> list[BaseException | None]:
        """Vectorized delete (reference DeleteVersions RPC — one round trip
        for bulk deletes, cmd/erasure-object.go:877)."""
        out: list[BaseException | None] = []
        for p, fi in zip(paths, fis):
            try:
                self.delete_version(volume, p, fi)
                out.append(None)
            except Exception as e:  # noqa: BLE001
                out.append(e)
        return out

    @abc.abstractmethod
    def check_parts(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None: ...

    # --- namespace walk (scanner / listing) ---------------------------------

    @abc.abstractmethod
    def walk_dir(self, volume: str, dir_path: str = "",
                 recursive: bool = True) -> Iterator[str]:
        """Yield sorted object paths (entries owning an xl.meta) under
        dir_path (reference WalkDir, cmd/metacache-walk.go)."""
        ...

    def walk_versions(self, volume: str, prefix: str = "", marker: str = "",
                      limit: int = -1) -> Iterator[tuple[str, bytes]]:
        """Stream (object_name, raw xl.meta bytes) in sorted key order,
        names strictly after ``marker``, matching ``prefix`` — the
        metadata-carrying walk the metacache listing merges
        (cmd/metacache-walk.go sends metadata inline the same way).

        Default: derive from walk_dir + read_all (correct but O(namespace)
        per call); real backends override with marker push-down. walk_dir's
        filesystem descent order differs from S3 key order around the "/"
        separator ("a!b" < "a/c" as keys, but dir "a" walks before "a!b"),
        so the names are collected and sorted here — the merge machinery
        depends on strict key order."""
        emitted = 0
        for name in sorted(self.walk_dir(volume, "")):
            if not name.startswith(prefix) or name <= marker:
                continue
            if limit >= 0 and emitted >= limit:
                return
            try:
                blob = self.read_all(volume, f"{name}/xl.meta")
            except Exception:  # noqa: BLE001 — raced with delete
                continue
            emitted += 1
            yield name, blob
