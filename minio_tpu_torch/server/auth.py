"""AWS Signature V4 and V2 verification, the port of
minio_tpu/server/auth.py (reference cmd/signature-v4.go,
cmd/streaming-signature-v4.go, cmd/auth-handler.go): header-signed,
presigned-URL, UNSIGNED-PAYLOAD, and streaming aws-chunked payloads."""
from __future__ import annotations

import datetime
import hashlib
import hmac
import time
import urllib.parse
from dataclasses import dataclass

UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
SIGN_V4_ALGO = "AWS4-HMAC-SHA256"
PRESIGN_EXPIRY_MAX = 7 * 24 * 3600


class AuthError(Exception):
    def __init__(self, code: str, message: str, status: int = 403):
        self.code = code
        self.message = message
        self.status = status
        super().__init__(f"{code}: {message}")


@dataclass
class Credentials:
    access_key: str
    secret_key: str

    def is_valid(self) -> bool:
        return len(self.access_key) >= 3 and len(self.secret_key) >= 8


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str,
                service: str = "s3") -> bytes:
    k = _hmac(f"AWS4{secret}".encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-_.~" if encode_slash else "-_.~/"
    return urllib.parse.quote(s, safe=safe)


def canonical_query(query: dict[str, list[str]],
                    drop: tuple[str, ...] = ()) -> str:
    pairs = []
    for k in sorted(query):
        if k in drop:
            continue
        for v in sorted(query[k]):
            pairs.append(f"{uri_encode(k)}={uri_encode(v)}")
    return "&".join(pairs)


def canonical_request(method: str, path: str, query: dict[str, list[str]],
                      headers: dict[str, str], signed_headers: list[str],
                      payload_hash: str,
                      drop_query: tuple[str, ...] = ()) -> str:
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n"
        for h in signed_headers)
    return "\n".join([
        method,
        uri_encode(path, encode_slash=False) or "/",
        canonical_query(query, drop_query),
        canon_headers,
        ";".join(signed_headers),
        payload_hash,
    ])


def string_to_sign(timestamp: str, scope: str, creq: str) -> str:
    return "\n".join([SIGN_V4_ALGO, timestamp, scope,
                      hashlib.sha256(creq.encode()).hexdigest()])


@dataclass
class ParsedSig:
    access_key: str
    scope_date: str
    region: str
    service: str
    signed_headers: list[str]
    signature: str


def parse_auth_header(value: str) -> ParsedSig:
    if not value.startswith(SIGN_V4_ALGO):
        raise AuthError("SignatureDoesNotMatch",
                        "unsupported signature algorithm")
    fields: dict[str, str] = {}
    for part in value[len(SIGN_V4_ALGO):].split(","):
        part = part.strip()
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        fields[k.strip()] = v.strip()
    try:
        cred = fields["Credential"].split("/")
        return ParsedSig(
            access_key="/".join(cred[:-4]),
            scope_date=cred[-4], region=cred[-3], service=cred[-2],
            signed_headers=fields["SignedHeaders"].split(";"),
            signature=fields["Signature"])
    except (KeyError, IndexError) as e:
        raise AuthError("AuthorizationHeaderMalformed",
                        f"malformed authorization header: {e}") from e


class SigV4Verifier:
    """Stateless request verifier bound to a credential lookup function
    (access_key -> secret or None) and a region."""

    def __init__(self, lookup, region: str = "us-east-1"):
        self.lookup = lookup
        self.region = region

    # -- header-signed -------------------------------------------------------

    def verify(self, method: str, path: str, query: dict[str, list[str]],
               headers: dict[str, str]) -> str:
        """Verify; returns the authenticated access key. Raises AuthError."""
        auth = headers.get("authorization", "")
        if auth.startswith("AWS "):
            return self._verify_v2(method, path, query, headers, auth)
        if auth:
            return self._verify_header(method, path, query, headers, auth)
        ci = dict_ci(query)
        if "X-Amz-Signature" in ci:
            return self._verify_presigned(method, path, query, headers)
        if "Signature" in ci and "AWSAccessKeyId" in ci:
            return self._verify_presigned_v2(method, path, query)
        raise AuthError("AccessDenied", "no authentication provided")

    # --- AWS Signature Version 2 (reference cmd/signature-v2.go) ------------

    _V2_SUBRESOURCES = (
        "acl", "delete", "lifecycle", "location", "logging", "notification",
        "partNumber", "policy", "requestPayment", "response-cache-control",
        "response-content-disposition", "response-content-encoding",
        "response-content-language", "response-content-type",
        "response-expires", "restore", "tagging", "torrent", "uploadId",
        "uploads", "versionId", "versioning", "versions", "website",
        "select", "select-type", "object-lock", "retention", "legal-hold",
    )

    def _v2_string_to_sign(self, method: str, path: str,
                           query: dict[str, list[str]],
                           headers: dict[str, str], expires: str = "") -> str:
        amz = sorted((k.lower().strip(), ",".join(v if isinstance(v, list)
                                                  else [v]))
                     for k, v in headers.items()
                     if k.lower().startswith("x-amz-"))
        canon_amz = "".join(f"{k}:{vs.strip()}\n" for k, vs in amz)
        sub = sorted(k for k in query if k in self._V2_SUBRESOURCES)
        resource = path
        if sub:
            parts = []
            for k in sub:
                v = query[k][0] if query[k] and query[k][0] else ""
                parts.append(f"{k}={v}" if v else k)
            resource += "?" + "&".join(parts)
        # spec: when x-amz-date is sent it rides CanonicalizedAmzHeaders
        # and the Date line is EMPTY (double-counting it rejects every
        # conforming client that can't set Date)
        if expires:
            date = expires
        elif headers.get("x-amz-date"):
            date = ""
        else:
            date = headers.get("date", "")
        return "\n".join([
            method,
            headers.get("content-md5", ""),
            headers.get("content-type", ""),
            date,
            canon_amz + resource,
        ])

    def _v2_signature(self, secret: str, sts: str) -> str:
        import base64
        return base64.b64encode(
            hmac.new(secret.encode(), sts.encode(),
                     hashlib.sha1).digest()).decode()

    def _verify_v2(self, method, path, query, headers, auth) -> str:
        try:
            ak, want = auth[len("AWS "):].split(":", 1)
        except ValueError:
            raise AuthError("InvalidArgument",
                            "malformed v2 authorization") from None
        secret = self.lookup(ak)
        if secret is None:
            raise AuthError("InvalidAccessKeyId", "access key not found")
        sts = self._v2_string_to_sign(method, path, query, headers)
        if not hmac.compare_digest(self._v2_signature(secret, sts), want):
            raise AuthError("SignatureDoesNotMatch", "v2 signature mismatch")
        return ak

    def _verify_presigned_v2(self, method, path, query) -> str:
        ci = dict_ci(query)
        ak = first(ci, "AWSAccessKeyId")
        want = first(ci, "Signature")
        expires = first(ci, "Expires")
        secret = self.lookup(ak)
        if secret is None:
            raise AuthError("InvalidAccessKeyId", "access key not found")
        try:
            if float(expires) < time.time():
                raise AuthError("AccessDenied", "presigned URL expired")
        except ValueError:
            raise AuthError("InvalidArgument", "bad Expires") from None
        q = {k: v for k, v in query.items()
             if k not in ("Signature", "AWSAccessKeyId", "Expires")}
        sts = self._v2_string_to_sign(method, path, q, {}, expires=expires)
        if not hmac.compare_digest(self._v2_signature(secret, sts), want):
            raise AuthError("SignatureDoesNotMatch", "v2 signature mismatch")
        return ak

    def _verify_header(self, method, path, query, headers, auth) -> str:
        sig = parse_auth_header(auth)
        secret = self.lookup(sig.access_key)
        if secret is None:
            raise AuthError("InvalidAccessKeyId", "access key not found")
        timestamp = headers.get("x-amz-date") or headers.get("date", "")
        if not timestamp:
            raise AuthError("AccessDenied", "missing date header")
        self._check_skew(timestamp)
        payload_hash = headers.get("x-amz-content-sha256",
                                   UNSIGNED_PAYLOAD)
        scope = f"{sig.scope_date}/{sig.region}/{sig.service}/aws4_request"
        creq = canonical_request(method, path, query, headers,
                                 sig.signed_headers, payload_hash)
        sts = string_to_sign(timestamp, scope, creq)
        key = signing_key(secret, sig.scope_date, sig.region, sig.service)
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig.signature):
            raise AuthError("SignatureDoesNotMatch",
                            "request signature mismatch")
        return sig.access_key

    # -- presigned URL -------------------------------------------------------

    def _verify_presigned(self, method, path, query, headers) -> str:
        q = dict_ci(query)
        algo = first(q, "X-Amz-Algorithm")
        if algo != SIGN_V4_ALGO:
            raise AuthError("SignatureDoesNotMatch", "bad algorithm")
        cred = first(q, "X-Amz-Credential").split("/")
        access_key = "/".join(cred[:-4])
        scope_date, region, service = cred[-4], cred[-3], cred[-2]
        secret = self.lookup(access_key)
        if secret is None:
            raise AuthError("InvalidAccessKeyId", "access key not found")
        timestamp = first(q, "X-Amz-Date")
        expires = int(first(q, "X-Amz-Expires") or "0")
        if not 0 < expires <= PRESIGN_EXPIRY_MAX:
            raise AuthError("AuthorizationQueryParametersError",
                            "invalid expiry")
        t = _parse_amz_date(timestamp)
        now = datetime.datetime.now(datetime.timezone.utc)
        if now > t + datetime.timedelta(seconds=expires):
            raise AuthError("AccessDenied", "request has expired")
        # A far-future X-Amz-Date would keep the URL valid for years,
        # defeating PRESIGN_EXPIRY_MAX (reference errRequestNotReadyYet).
        if t > now + datetime.timedelta(seconds=15 * 60):
            raise AuthError("AccessDenied", "request is not valid yet")
        signed_headers = first(q, "X-Amz-SignedHeaders").split(";")
        signature = first(q, "X-Amz-Signature")
        scope = f"{scope_date}/{region}/{service}/aws4_request"
        creq = canonical_request(method, path, query, headers,
                                 signed_headers, UNSIGNED_PAYLOAD,
                                 drop_query=("X-Amz-Signature",))
        sts = string_to_sign(timestamp, scope, creq)
        key = signing_key(secret, scope_date, region, service)
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, signature):
            raise AuthError("SignatureDoesNotMatch",
                            "presigned signature mismatch")
        return access_key

    @staticmethod
    def _check_skew(timestamp: str, max_skew: int = 15 * 60):
        t = _parse_amz_date(timestamp)
        now = datetime.datetime.now(datetime.timezone.utc)
        if abs((now - t).total_seconds()) > max_skew:
            raise AuthError("RequestTimeTooSkewed",
                            "request time too skewed", 403)

    # -- signing (client side, for tests and the admin CLI) ------------------

    def sign_request(self, access_key: str, secret: str, method: str,
                     path: str, query: dict[str, list[str]],
                     headers: dict[str, str],
                     payload_hash: str = UNSIGNED_PAYLOAD) -> str:
        now = datetime.datetime.now(datetime.timezone.utc)
        timestamp = now.strftime("%Y%m%dT%H%M%SZ")
        headers["x-amz-date"] = timestamp
        headers["x-amz-content-sha256"] = payload_hash
        signed = sorted(h for h in headers
                        if h == "host" or h.startswith("x-amz-"))
        scope_date = timestamp[:8]
        scope = f"{scope_date}/{self.region}/s3/aws4_request"
        creq = canonical_request(method, path, query, headers, signed,
                                 payload_hash)
        sts = string_to_sign(timestamp, scope, creq)
        key = signing_key(secret, scope_date, self.region)
        sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        return (f"{SIGN_V4_ALGO} Credential={access_key}/{scope}, "
                f"SignedHeaders={';'.join(signed)}, Signature={sig}")


def _parse_amz_date(timestamp: str) -> datetime.datetime:
    try:
        return datetime.datetime.strptime(
            timestamp, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=datetime.timezone.utc)
    except ValueError:
        try:
            return datetime.datetime.strptime(
                timestamp, "%a, %d %b %Y %H:%M:%S %Z").replace(
                tzinfo=datetime.timezone.utc)
        except ValueError as e:
            raise AuthError("AccessDenied", f"bad date: {timestamp}") from e


def dict_ci(query: dict[str, list[str]]) -> dict[str, list[str]]:
    return dict(query)


def first(q: dict[str, list[str]], key: str) -> str:
    v = q.get(key) or [""]
    return v[0]


class ChunkedSigV4Reader:
    """Reader for STREAMING-AWS4-HMAC-SHA256-PAYLOAD bodies (reference
    cmd/streaming-signature-v4.go): frames of
    ``<hex-size>;chunk-signature=<sig>\\r\\n<data>\\r\\n`` with a rolling
    per-chunk signature chain; the final 0-size chunk closes the stream."""

    def __init__(self, raw, seed_signature: str, signing_key_: bytes,
                 timestamp: str, scope: str):
        self.raw = raw
        self.prev_sig = seed_signature
        self.key = signing_key_
        self.timestamp = timestamp
        self.scope = scope
        self._buf = bytearray()
        self._eof = False

    def _read_line(self) -> bytes:
        line = bytearray()
        while True:
            c = self.raw.read(1)
            if not c:
                raise AuthError("IncompleteBody", "truncated chunk header",
                                400)
            line += c
            if line.endswith(b"\r\n"):
                return bytes(line[:-2])

    def _next_chunk(self):
        header = self._read_line()
        try:
            size_hex, _, rest = header.partition(b";")
            size = int(size_hex, 16)
            sig = rest.split(b"=", 1)[1].decode()
        except (ValueError, IndexError) as e:
            raise AuthError("SignatureDoesNotMatch",
                            f"malformed chunk header: {header!r}", 400) from e
        data = self.raw.read(size) if size else b""
        while len(data) < size:
            more = self.raw.read(size - len(data))
            if not more:
                raise AuthError("IncompleteBody", "truncated chunk", 400)
            data += more
        crlf = self.raw.read(2)
        if crlf != b"\r\n":
            raise AuthError("IncompleteBody", "missing chunk CRLF", 400)
        sts = "\n".join([
            "AWS4-HMAC-SHA256-PAYLOAD", self.timestamp, self.scope,
            self.prev_sig, EMPTY_SHA256,
            hashlib.sha256(data).hexdigest()])
        want = hmac.new(self.key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            raise AuthError("SignatureDoesNotMatch",
                            "chunk signature mismatch", 403)
        self.prev_sig = sig
        if size == 0:
            self._eof = True
        else:
            self._buf += data

    def read(self, n: int = -1) -> bytes:
        while not self._eof and (n < 0 or len(self._buf) < n):
            self._next_chunk()
        if n < 0 or n >= len(self._buf):
            out = bytes(self._buf)
            self._buf.clear()
        else:
            out = bytes(self._buf[:n])
            del self._buf[:n]
        return out


def presign_v4(method: str, scheme: str, host: str, path: str,
               access_key: str, secret: str, region: str,
               expires_s: int) -> str:
    """Generate a presigned URL (client side of _verify_presigned —
    reference pkg/s3signer PresignV4). ``path`` is the RAW (unquoted)
    object path — parsing a joined URL string would misread keys
    containing '?' or '#'."""
    import urllib.parse
    path = path or "/"
    now = datetime.datetime.now(datetime.timezone.utc)
    timestamp = now.strftime("%Y%m%dT%H%M%SZ")
    scope = f"{timestamp[:8]}/{region}/s3/aws4_request"
    query = {
        "X-Amz-Algorithm": [SIGN_V4_ALGO],
        "X-Amz-Credential": [f"{access_key}/{scope}"],
        "X-Amz-Date": [timestamp],
        "X-Amz-Expires": [str(expires_s)],
        "X-Amz-SignedHeaders": ["host"],
    }
    headers = {"host": host}
    creq = canonical_request(method, path, query, headers, ["host"],
                             UNSIGNED_PAYLOAD)
    sts = string_to_sign(timestamp, scope, creq)
    key = signing_key(secret, timestamp[:8], region)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    qs = urllib.parse.urlencode(
        [(k, v[0]) for k, v in query.items()] +
        [("X-Amz-Signature", sig)])
    return f"{scheme}://{host}{urllib.parse.quote(path)}?{qs}"
