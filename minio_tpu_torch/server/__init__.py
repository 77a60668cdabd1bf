"""S3-compatible HTTP server, the port of minio_tpu.server (reference L5/L6
— SURVEY.md §1): request routing, SigV4 auth and the S3 API handlers over
an ObjectLayer on the card. Start it with ``python -m
minio_tpu_torch.server``."""
from .s3api import S3Server

__all__ = ["S3Server"]
