"""Minimal mimedb, the port of minio_tpu/utils/mimedb.py: extension ->
content-type (reference pkg/mimedb, a
4,632-line generated table). A curated table of the extensions object
stores actually serve covers the hot 99%; anything unknown falls back to
the stdlib ``mimetypes`` registry (which reads the platform's mime.types
when present) and finally to the caller's default. The curated table
makes detection DETERMINISTIC across containers — minimal images often
ship no /etc/mime.types, and the reference bakes its table in for the
same reason.

Applied when a PUT (S3 or console upload) carries no Content-Type, so a
GET of ``x.html`` answers ``text/html`` instead of
``application/octet-stream``.
"""
from __future__ import annotations

#: extensions that are ENCODINGS of an inner type: for ``x.tar.gz`` the
#: inner type would mislead clients (a .tar.gz is not a plain tar), so
#: these resolve as their own opaque types
_ENCODINGS = {
    "gz": "application/gzip",
    "bz2": "application/x-bzip2",
    "xz": "application/x-xz",
    "zst": "application/zstd",
    "br": "application/octet-stream",
}

TYPES: dict[str, str] = {
    # text / web
    "html": "text/html", "htm": "text/html",
    "css": "text/css",
    "csv": "text/csv",
    "txt": "text/plain", "text": "text/plain", "log": "text/plain",
    "md": "text/markdown",
    "xml": "application/xml",
    "js": "application/javascript", "mjs": "application/javascript",
    "json": "application/json",
    "ndjson": "application/x-ndjson", "jsonl": "application/x-ndjson",
    "yaml": "application/yaml", "yml": "application/yaml",
    "wasm": "application/wasm",
    "ics": "text/calendar",
    "rtf": "application/rtf",
    # images
    "png": "image/png",
    "jpg": "image/jpeg", "jpeg": "image/jpeg",
    "gif": "image/gif",
    "webp": "image/webp",
    "avif": "image/avif",
    "svg": "image/svg+xml",
    "ico": "image/x-icon",
    "bmp": "image/bmp",
    "tif": "image/tiff", "tiff": "image/tiff",
    "heic": "image/heic",
    # audio / video
    "mp3": "audio/mpeg",
    "wav": "audio/wav",
    "ogg": "audio/ogg",
    "oga": "audio/ogg",
    "flac": "audio/flac",
    "aac": "audio/aac",
    "m4a": "audio/mp4",
    "mp4": "video/mp4", "m4v": "video/mp4",
    "webm": "video/webm",
    "mov": "video/quicktime",
    "mkv": "video/x-matroska",
    "avi": "video/x-msvideo",
    "mpg": "video/mpeg", "mpeg": "video/mpeg",
    "ts": "video/mp2t",
    "m3u8": "application/vnd.apple.mpegurl",
    # fonts
    "woff": "font/woff", "woff2": "font/woff2",
    "ttf": "font/ttf", "otf": "font/otf",
    # documents
    "pdf": "application/pdf",
    "doc": "application/msword",
    "docx": "application/vnd.openxmlformats-officedocument"
            ".wordprocessingml.document",
    "xls": "application/vnd.ms-excel",
    "xlsx": "application/vnd.openxmlformats-officedocument"
            ".spreadsheetml.sheet",
    "ppt": "application/vnd.ms-powerpoint",
    "pptx": "application/vnd.openxmlformats-officedocument"
            ".presentationml.presentation",
    "epub": "application/epub+zip",
    # archives / packages
    "zip": "application/zip",
    "tar": "application/x-tar",
    "7z": "application/x-7z-compressed",
    "rar": "application/vnd.rar",
    "jar": "application/java-archive",
    "apk": "application/vnd.android.package-archive",
    "deb": "application/vnd.debian.binary-package",
    "rpm": "application/x-rpm",
    "dmg": "application/x-apple-diskimage",
    "iso": "application/x-iso9660-image",
    # data / ML formats common in object stores
    "parquet": "application/vnd.apache.parquet",
    "avro": "application/avro",
    "orc": "application/octet-stream",
    "proto": "text/plain",
    "npy": "application/octet-stream",
    "npz": "application/octet-stream",
    "h5": "application/x-hdf5", "hdf5": "application/x-hdf5",
    "safetensors": "application/octet-stream",
    "sqlite": "application/vnd.sqlite3", "db": "application/vnd.sqlite3",
    "bin": "application/octet-stream",
}

TYPES.update(_ENCODINGS)


def content_type(key: str, default: str = "") -> str:
    """Content type for an object key by extension; ``default`` when the
    extension is unknown (or the key has none)."""
    name = key.rsplit("/", 1)[-1]
    if "." not in name:
        return default
    ext = name.rsplit(".", 1)[-1].lower()
    if ext in _ENCODINGS:
        # x.tar.gz and friends: the ENCODING extension wins — reporting
        # the inner type would mislead clients
        return _ENCODINGS[ext]
    hit = TYPES.get(ext)
    if hit:
        return hit
    import mimetypes
    guess, encoding = mimetypes.guess_type(name, strict=False)
    if guess and encoding is None:
        return guess
    return default
