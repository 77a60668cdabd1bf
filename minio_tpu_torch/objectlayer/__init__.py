"""Object layer, the port of minio_tpu.objectlayer (reference L4 —
SURVEY.md §1): the ObjectLayer backend abstraction and its erasure
implementations (single set → sets → pools) over the device data path."""
from .datatypes import (BucketInfo, ListObjectsInfo, ObjectInfo,
                        ObjectOptions, api_errors)
from .interface import ObjectLayer
from .erasure_objects import ErasureObjects
from .sets import ErasureSets
from .pools import ServerPools

__all__ = ["ObjectLayer", "ErasureObjects", "ErasureSets", "ServerPools",
           "ObjectInfo", "ObjectOptions", "BucketInfo", "ListObjectsInfo",
           "api_errors"]
