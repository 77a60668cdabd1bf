"""Storage layer, the port of minio_tpu.storage (reference L2 — SURVEY.md
§1): the StorageAPI disk abstraction, the xl.meta on-disk version journal,
the fsync policy, the local posix backend, and the per-disk health and
disk-id wrappers (``health``, ``idcheck``)."""
from .datatypes import (DiskInfo, ErasureInfo, FileInfo, ObjectPartInfo,
                        VolInfo)
from .interface import StorageAPI
from .xlstorage import XLStorage

__all__ = ["StorageAPI", "XLStorage", "FileInfo", "ErasureInfo",
           "ObjectPartInfo", "DiskInfo", "VolInfo"]
