"""Config KVS subsystem, the port of minio_tpu/config (reference
cmd/config/config.go:103-303)."""
from .kvs import ConfigSys, SUB_SYSTEMS, get_config_sys

__all__ = ["ConfigSys", "SUB_SYSTEMS", "get_config_sys"]
