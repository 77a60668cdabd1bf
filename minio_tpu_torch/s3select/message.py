"""AWS event-stream framing for SelectObjectContent responses (reference
pkg/s3select/message.go; wire format per the AWS vnd.amazon.event-stream
spec): each message = prelude(total_len u32, headers_len u32) +
crc32(prelude) + headers + payload + crc32(everything before).

Headers are (name_len u8, name, type u8 [7 = string], value_len u16,
value).

The port's copy of minio_tpu/s3select/message.py: the port imports
nothing of the JAX package, not even this pure-Python module.
"""
from __future__ import annotations

import struct
import zlib


def _header(name: str, value: str) -> bytes:
    nb = name.encode()
    vb = value.encode()
    return struct.pack(">B", len(nb)) + nb + b"\x07" + \
        struct.pack(">H", len(vb)) + vb


def encode_message(headers: list[tuple[str, str]], payload: bytes) -> bytes:
    hb = b"".join(_header(n, v) for n, v in headers)
    total = 12 + len(hb) + len(payload) + 4
    prelude = struct.pack(">II", total, len(hb))
    pre_crc = struct.pack(">I", zlib.crc32(prelude))
    body = prelude + pre_crc + hb + payload
    return body + struct.pack(">I", zlib.crc32(body))


def encode_records(payload: bytes) -> bytes:
    return encode_message([
        (":message-type", "event"),
        (":event-type", "Records"),
        (":content-type", "application/octet-stream"),
    ], payload)


def encode_progress(scanned: int, processed: int, returned: int) -> bytes:
    """Progress event. The three byte counts are DISTINCT quantities
    (reference pkg/s3select progress.go): ``scanned`` = input consumed
    from storage (compressed/encrypted), ``processed`` = decoded bytes
    the engine evaluated, ``returned`` = payload emitted in Records
    frames. run_select wires them; tests/test_workloads.py locks the
    framing."""
    xml = (f"<Progress><BytesScanned>{scanned}</BytesScanned>"
           f"<BytesProcessed>{processed}</BytesProcessed>"
           f"<BytesReturned>{returned}</BytesReturned></Progress>").encode()
    return encode_message([
        (":message-type", "event"),
        (":event-type", "Progress"),
        (":content-type", "text/xml"),
    ], xml)


def encode_stats(scanned: int, processed: int, returned: int) -> bytes:
    """Stats event — same distinct scanned/processed/returned contract
    as encode_progress."""
    xml = (f"<Stats><BytesScanned>{scanned}</BytesScanned>"
           f"<BytesProcessed>{processed}</BytesProcessed>"
           f"<BytesReturned>{returned}</BytesReturned></Stats>").encode()
    return encode_message([
        (":message-type", "event"),
        (":event-type", "Stats"),
        (":content-type", "text/xml"),
    ], xml)


def encode_end() -> bytes:
    return encode_message([
        (":message-type", "event"),
        (":event-type", "End"),
    ], b"")


def encode_error(code: str, message: str) -> bytes:
    return encode_message([
        (":message-type", "error"),
        (":error-code", code),
        (":error-message", message),
    ], b"")


def decode_messages(blob: bytes) -> list[tuple[dict, bytes]]:
    """Test-side decoder: [(headers dict, payload)] with CRC checks."""
    out = []
    pos = 0
    while pos < len(blob):
        total, hlen = struct.unpack_from(">II", blob, pos)
        pre_crc = struct.unpack_from(">I", blob, pos + 8)[0]
        if zlib.crc32(blob[pos:pos + 8]) != pre_crc:
            raise ValueError("prelude CRC mismatch")
        body = blob[pos:pos + total - 4]
        msg_crc = struct.unpack_from(">I", blob, pos + total - 4)[0]
        if zlib.crc32(body) != msg_crc:
            raise ValueError("message CRC mismatch")
        hdrs = {}
        hpos = pos + 12
        hend = hpos + hlen
        while hpos < hend:
            nlen = blob[hpos]
            name = blob[hpos + 1:hpos + 1 + nlen].decode()
            hpos += 1 + nlen
            assert blob[hpos] == 7
            vlen = struct.unpack_from(">H", blob, hpos + 1)[0]
            hdrs[name] = blob[hpos + 3:hpos + 3 + vlen].decode()
            hpos += 3 + vlen
        payload = blob[hend:pos + total - 4]
        out.append((hdrs, payload))
        pos += total
    return out
