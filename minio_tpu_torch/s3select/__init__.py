"""S3 Select (reference pkg/s3select): SQL parser and evaluator, CSV/JSON/
Parquet readers, the AWS event-stream response, and the CSV scan lane whose
WHERE clause runs on the card (K6, ops/scan_cuda.py) — the port of
minio_tpu/s3select, with ``select_object_content`` as its entry point over
an erasure-coded object."""
from .message import encode_end, encode_records, encode_stats
from .object import select_object_content
from .select import S3SelectRequest, run_select
from .sql import parse_select

__all__ = ["S3SelectRequest", "run_select", "parse_select",
           "encode_records", "encode_stats", "encode_end",
           "select_object_content"]
