"""SelectObjectContent over an erasure-coded object — the S3 handler's
``select_object_content`` of minio_tpu/server/s3api.py without HTTP.

The request XML and the SQL are parsed BEFORE any shard is read (a bad
expression is refused without paying the read). The object is then decoded
from its bitrot shard readers (``erasure_decode``), through a
``DecryptWriter`` when it is SSE-C or through the decompressor of its
marker when it is stored compressed (``utils/compress.py``), and
``run_select`` writes the event-stream frames over the plaintext.
BytesScanned is the stored (encrypted or compressed) size, BytesProcessed
the plaintext, as in the reference.
"""
from __future__ import annotations

from ..crypto import sse
from ..erasure.streaming import BufferSink, erasure_decode
from ..utils import compress as cz
from .select import S3SelectRequest, run_select
from .sql import parse_select


def select_object_content(body: bytes, erasure, readers: list, size: int,
                          internal: dict, hdr, bucket: str, key: str, writer,
                          device=None) -> dict:
    """Run the SelectObjectContent request ``body`` over the object whose
    ``size`` stored bytes the bitrot shard ``readers`` of ``erasure`` hold
    (None = an offline shard), writing the response frames to ``writer``;
    ``internal`` is the object's internal metadata and ``hdr`` the request
    headers (the SSE-C key). Returns the Stats numbers (scanned, processed,
    returned). Raises SQLError or xml.etree.ElementTree.ParseError for a
    bad request before reading anything."""
    req = S3SelectRequest.parse(body)
    parsed = parse_select(req.expression)
    ctx = sse.sse_read_ctx(internal, hdr, bucket, key, size, device=device)
    sink = BufferSink()
    scanned = size
    if ctx:
        oek, base_iv, plain_size, _, cipher = ctx
        scanned = sse.enc_size(plain_size)
        dw = sse.DecryptWriter(sink, oek, base_iv, 0, 0, plain_size, bucket,
                               key, cipher, device=device)
        erasure_decode(erasure, dw, readers, 0, size, size)
        dw.finish()
    elif internal.get(cz.META_COMPRESSION):
        dz = cz.decompress_writer(internal[cz.META_COMPRESSION], sink)
        erasure_decode(erasure, dz, readers, 0, size, size)
        dz.finish()
    else:
        erasure_decode(erasure, sink, readers, 0, size, size)
    return run_select(req, sink.getvalue(), writer, parsed=parsed,
                      scanned_bytes=scanned, device=device)
