"""The port's request authentication (minio_tpu_torch.server.auth) held to
the JAX package's (minio_tpu.server.auth): the same requests get the same
verdict — the access key, or the same S3 error code and status — for
header-signed SigV4, presigned V4, header and presigned V2, the clock-skew
and expiry windows, and STREAMING-AWS4-HMAC-SHA256-PAYLOAD bodies (a
tampered, truncated or malformed chunk stream fails the same way). What one
package signs, the other accepts."""
import base64
import datetime
import hashlib
import hmac
import io
import time
import urllib.parse

import pytest

from minio_tpu.server import auth as jauth
from minio_tpu_torch.server import auth as pauth

AK, SK = "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY"
REGION = "us-east-1"
HOST = "127.0.0.1:9000"
PATH = "/bucket/dir/obj name+é.txt"


def lookup(ak):
    return SK if ak == AK else None


def verdict(mod, method, path, query, headers):
    """The access key, or the AuthError's (code, status)."""
    v = mod.SigV4Verifier(lookup, REGION)
    try:
        return v.verify(method, path, query, dict(headers))
    except mod.AuthError as e:
        return (e.code, e.status)


def amz_now(shift_s: float = 0.0) -> str:
    t = datetime.datetime.now(datetime.timezone.utc) + \
        datetime.timedelta(seconds=shift_s)
    return t.strftime("%Y%m%dT%H%M%SZ")


def v4_header(method, path, query, headers, ts, secret=SK, ak=AK,
              payload=jauth.UNSIGNED_PAYLOAD, signed=None):
    """Header-signed SigV4 at an explicit timestamp (the reference
    construction, JAX package's helpers)."""
    headers = dict(headers, **{"x-amz-date": ts,
                               "x-amz-content-sha256": payload})
    signed = signed or sorted(h for h in headers
                              if h == "host" or h.startswith("x-amz-"))
    scope = f"{ts[:8]}/{REGION}/s3/aws4_request"
    creq = jauth.canonical_request(method, path, query, headers, signed,
                                   payload)
    sts = jauth.string_to_sign(ts, scope, creq)
    key = jauth.signing_key(secret, ts[:8], REGION)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    headers["authorization"] = (
        f"{jauth.SIGN_V4_ALGO} Credential={ak}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return headers


def presigned_v4(method, path, ts, expires="600", secret=SK, extra=None):
    scope = f"{ts[:8]}/{REGION}/s3/aws4_request"
    q = {"X-Amz-Algorithm": [jauth.SIGN_V4_ALGO],
         "X-Amz-Credential": [f"{AK}/{scope}"],
         "X-Amz-Date": [ts], "X-Amz-Expires": [expires],
         "X-Amz-SignedHeaders": ["host"], **(extra or {})}
    creq = jauth.canonical_request(method, path, q, {"host": HOST}, ["host"],
                                   jauth.UNSIGNED_PAYLOAD,
                                   drop_query=("X-Amz-Signature",))
    sts = jauth.string_to_sign(ts, scope, creq)
    key = jauth.signing_key(secret, ts[:8], REGION)
    q["X-Amz-Signature"] = [hmac.new(key, sts.encode(),
                                     hashlib.sha256).hexdigest()]
    return q


def v2_sig(secret, sts):
    return base64.b64encode(hmac.new(secret.encode(), sts.encode(),
                                     hashlib.sha1).digest()).decode()


def v2_header(method, path, query, headers, secret=SK):
    sts = jauth.SigV4Verifier(lookup)._v2_string_to_sign(
        method, path, query, headers)
    return dict(headers, authorization=f"AWS {AK}:{v2_sig(secret, sts)}")


def presigned_v2(method, path, expires, secret=SK, query=None):
    q = dict(query or {})
    sts = jauth.SigV4Verifier(lookup)._v2_string_to_sign(
        method, path, q, {}, expires=str(expires))
    return {**q, "AWSAccessKeyId": [AK], "Expires": [str(expires)],
            "Signature": [v2_sig(secret, sts)]}


def _cases():
    h = {"host": HOST}
    q = {"list-type": ["2"], "prefix": ["a b/é"], "max-keys": ["3"]}
    body_sha = hashlib.sha256(b"payload").hexdigest()
    date = time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime())
    past = time.strftime("%a, %d %b %Y %H:%M:%S GMT",
                         time.gmtime(time.time() - 3600))
    now = amz_now()
    yield "v4 header", ("GET", PATH, q, v4_header("GET", PATH, q, h, now))
    yield "v4 signed payload", ("PUT", PATH, {}, v4_header(
        "PUT", PATH, {}, h, now, payload=body_sha))
    yield "v4 wrong secret", ("GET", PATH, q, v4_header(
        "GET", PATH, q, h, now, secret="nope-secret"))
    yield "v4 unknown key", ("GET", PATH, q, v4_header(
        "GET", PATH, q, h, now, ak="NOBODY"))
    yield "v4 tampered path", ("GET", PATH + "x", q, v4_header(
        "GET", PATH, q, h, now))
    yield "v4 tampered query", ("GET", PATH, {**q, "max-keys": ["4"]},
                                v4_header("GET", PATH, q, h, now))
    yield "v4 skew -16 min", ("GET", PATH, {}, v4_header(
        "GET", PATH, {}, h, amz_now(-16 * 60)))
    yield "v4 skew +16 min", ("GET", PATH, {}, v4_header(
        "GET", PATH, {}, h, amz_now(16 * 60)))
    yield "v4 skew -14 min", ("GET", PATH, {}, v4_header(
        "GET", PATH, {}, h, amz_now(-14 * 60)))
    no_date = v4_header("GET", PATH, {}, h, now)
    del no_date["x-amz-date"]
    yield "v4 missing date", ("GET", PATH, {}, no_date)
    bad_date = v4_header("GET", PATH, {}, h, now)
    bad_date["x-amz-date"] = "yesterday"
    yield "v4 bad date", ("GET", PATH, {}, bad_date)
    yield "v4 malformed header", ("GET", PATH, {}, dict(
        h, authorization=f"{jauth.SIGN_V4_ALGO} Credential=x",
        **{"x-amz-date": now}))
    yield "v4 other algorithm", ("GET", PATH, {}, dict(
        h, authorization="AWS4-HMAC-SHA512 Credential=a/b/c/d/e",
        **{"x-amz-date": now}))
    yield "anonymous", ("GET", PATH, {}, h)
    yield "presigned v4", ("GET", PATH, presigned_v4("GET", PATH, now), h)
    yield "presigned v4 expired", ("GET", PATH, presigned_v4(
        "GET", PATH, amz_now(-700), expires="600"), h)
    yield "presigned v4 not valid yet", ("GET", PATH, presigned_v4(
        "GET", PATH, amz_now(3600), expires="604800"), h)
    yield "presigned v4 zero expiry", ("GET", PATH, presigned_v4(
        "GET", PATH, now, expires="0"), h)
    yield "presigned v4 expiry past 7 days", ("GET", PATH, presigned_v4(
        "GET", PATH, now, expires="604801"), h)
    yield "presigned v4 wrong secret", ("GET", PATH, presigned_v4(
        "GET", PATH, now, secret="nope-secret"), h)
    yield "presigned v4 wrong method", ("PUT", PATH, presigned_v4(
        "GET", PATH, now), h)
    yield "v2 header", ("GET", PATH, {}, v2_header(
        "GET", PATH, {}, dict(h, date=date)))
    yield "v2 header x-amz-date", ("PUT", PATH, {"uploads": [""]},
                                   v2_header("PUT", PATH, {"uploads": [""]},
                                             dict(h, **{
                                                 "x-amz-date": date,
                                                 "x-amz-meta-k": "v",
                                                 "content-type": "a/b"})))
    yield "v2 header subresources", ("GET", PATH, {
        "acl": [""], "versionId": ["v1"], "prefix": ["p"]}, v2_header(
        "GET", PATH, {"acl": [""], "versionId": ["v1"], "prefix": ["p"]},
        dict(h, date=date)))
    yield "v2 header wrong secret", ("GET", PATH, {}, v2_header(
        "GET", PATH, {}, dict(h, date=date), secret="nope-secret"))
    yield "v2 header malformed", ("GET", PATH, {}, dict(
        h, authorization="AWS no-colon"))
    yield "v2 header unknown key", ("GET", PATH, {}, dict(
        h, date=past, authorization="AWS NOBODY:c2ln"))
    yield "presigned v2", ("GET", PATH, presigned_v2(
        "GET", PATH, int(time.time()) + 600), h)
    yield "presigned v2 subresource", ("GET", PATH, presigned_v2(
        "GET", PATH, int(time.time()) + 600,
        query={"tagging": [""]}), h)
    yield "presigned v2 expired", ("GET", PATH, presigned_v2(
        "GET", PATH, int(time.time()) - 1), h)
    yield "presigned v2 bad expires", ("GET", PATH, {
        "AWSAccessKeyId": [AK], "Expires": ["soon"],
        "Signature": ["c2ln"]}, h)
    yield "presigned v2 wrong secret", ("GET", PATH, presigned_v2(
        "GET", PATH, int(time.time()) + 600, secret="nope-secret"), h)


CASES = dict(_cases())


@pytest.mark.parametrize("case", list(CASES))
def test_verifier_verdicts_match(case):
    method, path, query, headers = CASES[case]
    want = verdict(jauth, method, path, query, headers)
    assert verdict(pauth, method, path, query, headers) == want
    ok = ("v4 header", "v4 signed payload", "v4 skew -14 min",
          "presigned v4", "v2 header", "v2 header x-amz-date",
          "v2 header subresources", "presigned v2",
          "presigned v2 subresource")
    assert (want == AK) == (case in ok), want


def test_canonical_forms_match():
    q = {"b": ["2", "1"], "a b": ["x/y z", ""], "é": ["~_-."]}
    h = {"host": HOST, "x-amz-date": "20261017T000000Z",
         "x-amz-meta-x": "  two   spaces  ", "content-type": "t/x"}
    signed = ["host", "x-amz-date", "x-amz-meta-x"]
    for path in (PATH, "/", "", "/b/a//c"):
        assert pauth.canonical_request("GET", path, q, h, signed,
                                       "UNSIGNED-PAYLOAD") == \
            jauth.canonical_request("GET", path, q, h, signed,
                                    "UNSIGNED-PAYLOAD")
    assert pauth.canonical_query(q, drop=("b",)) == \
        jauth.canonical_query(q, drop=("b",))
    assert pauth.signing_key(SK, "20261017", REGION) == \
        jauth.signing_key(SK, "20261017", REGION)
    value = v4_header("GET", PATH, {}, {"host": HOST},
                      amz_now())["authorization"]
    assert vars(pauth.parse_auth_header(value)) == \
        vars(jauth.parse_auth_header(value))


@pytest.mark.parametrize("signer,checker", [(pauth, jauth), (jauth, pauth)])
def test_each_package_accepts_what_the_other_signs(signer, checker):
    v = signer.SigV4Verifier(lambda a: None, REGION)
    q = {"list-type": ["2"], "prefix": ["é/ x"]}
    headers = {"host": HOST}
    headers["authorization"] = v.sign_request(AK, SK, "GET", PATH, q,
                                              headers)
    assert checker.SigV4Verifier(lookup, REGION).verify(
        "GET", PATH, q, headers) == AK
    url = signer.presign_v4("GET", "http", HOST, PATH, AK, SK, REGION, 600)
    split = urllib.parse.urlsplit(url)
    assert urllib.parse.unquote(split.path) == PATH
    query = urllib.parse.parse_qs(split.query, keep_blank_values=True)
    assert checker.SigV4Verifier(lookup, REGION).verify(
        "GET", PATH, query, {"host": HOST}) == AK


def chunked_body(chunks, ts, seed_sig, key, scope):
    body = bytearray()
    prev = seed_sig
    for chunk in list(chunks) + [b""]:
        sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", ts, scope, prev,
                         jauth.EMPTY_SHA256,
                         hashlib.sha256(chunk).hexdigest()])
        sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        body += f"{len(chunk):x};chunk-signature={sig}\r\n".encode()
        body += chunk + b"\r\n"
        prev = sig
    return bytes(body)


def _streams():
    ts = amz_now()
    scope = f"{ts[:8]}/{REGION}/s3/aws4_request"
    key = jauth.signing_key(SK, ts[:8], REGION)
    seed = "ab" * 32
    data = bytes(range(256)) * 600
    chunks = [data[:65536], data[65536:131072], data[131072:]]
    good = chunked_body(chunks, ts, seed, key, scope)
    first = good.find(b"\r\n") + 2
    tampered = bytearray(good)
    tampered[first + 100] ^= 0xFF
    bad_crlf = bytearray(good)
    bad_crlf[first + 65536] = ord("x")
    streams = {
        "good": good,
        "tampered chunk data": bytes(tampered),
        "truncated chunk": good[:first + 1000],
        "truncated header": good[:first + 65538 + 10],
        "missing chunk CRLF": bytes(bad_crlf),
        "malformed chunk header": b"zz;chunk-signature=00\r\n",
        "wrong seed signature": chunked_body(chunks, ts, "cd" * 32, key,
                                             scope),
    }
    return {name: (body, ts, scope, key, seed, data)
            for name, body in streams.items()}


STREAMS = _streams()


def read_stream(mod, body, ts, scope, key, seed, sizes):
    """Every read of the stream, or the AuthError's (code, status) at the
    first failing read."""
    r = mod.ChunkedSigV4Reader(io.BytesIO(body), seed, key, ts, scope)
    out = []
    try:
        for n in sizes:
            out.append(r.read(n))
    except mod.AuthError as e:
        return out, (e.code, e.status)
    return out, None


@pytest.mark.parametrize("name", list(STREAMS))
def test_chunked_streams_match(name):
    body, ts, scope, key, seed, data = STREAMS[name]
    # reads of a block size (1 MiB) larger than the 64 KiB chunks, odd
    # sizes that split chunks, then the rest
    sizes = [1 << 20, 7, 70_000, -1]
    want = read_stream(jauth, body, ts, scope, key, seed, sizes)
    got = read_stream(pauth, body, ts, scope, key, seed, sizes)
    assert got == want
    if name == "good":
        assert b"".join(got[0]) == data and got[1] is None
    else:
        assert got[1] is not None
