"""The port's identity providers (minio_tpu_torch.iam.{openid,ldap}) and
the STS actions that use them, held to the JAX package's on the CPU
(tests/test_identity.py's fixtures): an RS256 token verified through a
loopback JWKS stub, directly and by OpenID discovery, an HS256 token
under ``MINIO_TPU_OPENID_HMAC_SECRET``, the audience check, an expired
token, a tampered one, and LDAP simple binds against an in-process BER
stub. The providers give the same claims or the same error for every
token, and both servers the same statuses and credential kinds for every
STS call. The RSA key is made with the ``cryptography`` wheel (the port
verifies with Python integers and imports no crypto wheel)."""
import hashlib
import hmac
import http.server
import json
import os
import re
import sys
import threading
import time

import pytest
import requests

sys.path.insert(0, os.path.dirname(__file__))
from minio_tpu.iam import ldap as jldap  # noqa: E402
from minio_tpu.iam import openid as jopenid  # noqa: E402
from minio_tpu.obs import bucketstats as jbs  # noqa: E402
from minio_tpu.obs import logger as jlog  # noqa: E402
from minio_tpu_torch.iam import ldap as pldap  # noqa: E402
from minio_tpu_torch.iam import openid as popenid  # noqa: E402
from minio_tpu_torch.obs import bucketstats as pbs  # noqa: E402
from minio_tpu_torch.obs import logger as plog  # noqa: E402
from s3client import S3Client  # noqa: E402
from test_identity import MockLDAP, _b64url, sign_jwt_rs256  # noqa: E402
from test_torch_s3server import Server  # noqa: E402

OPENID = {"jax": jopenid, "port": popenid}
LDAP = {"jax": jldap, "port": pldap}
HMAC_SECRET = "hs256-shared-secret"


@pytest.fixture(autouse=True)
def fresh_planes(monkeypatch):
    """Both packages' bucket analytics and log plane start and end empty,
    and no identity setting comes from the environment but the test's."""
    for var in [v for v in os.environ
                if v.startswith(("MINIO_TPU_IDENTITY_",
                                 "MINIO_TPU_OPENID_"))]:
        monkeypatch.delenv(var)
    for mod in (jbs, pbs):
        mod.reset()
    jlog._sys = None
    plog.reset()
    yield
    for mod in (jbs, pbs):
        mod.reset()
    jlog._sys = None
    plog.reset()


@pytest.fixture(scope="module")
def rsa_key():
    from cryptography.hazmat.primitives.asymmetric import rsa
    priv = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    nums = priv.private_numbers()
    return nums.public_numbers.n, nums.public_numbers.e, nums.d


@pytest.fixture(scope="module")
def stub_idp(rsa_key):
    """Serves /jwks (an EC key the providers skip, and the RSA key) and an
    OIDC discovery document."""
    n, e, _d = rsa_key

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/jwks":
                body = json.dumps({"keys": [
                    {"kty": "EC", "kid": "ec1"},
                    {"kty": "RSA", "kid": "k1", "alg": "RS256",
                     "n": _b64url(n.to_bytes((n.bit_length() + 7) // 8,
                                             "big")),
                     "e": _b64url(e.to_bytes(3, "big"))}]}).encode()
            elif self.path == "/.well-known/openid-configuration":
                body = json.dumps({
                    "issuer": "http://stub",
                    "jwks_uri":
                        f"http://127.0.0.1:{self.server.server_port}/jwks",
                }).encode()
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield httpd
    httpd.shutdown()
    httpd.server_close()


def sign_hs256(claims: dict, secret: str = HMAC_SECRET) -> str:
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims).encode())
    sig = hmac.new(secret.encode(), f"{header}.{payload}".encode(),
                   hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url(sig)}"


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


def test_rsa_verify_matches_jax(rsa_key):
    n, e, d = rsa_key
    k = (n.bit_length() + 7) // 8
    msg = b"header.payload"
    digest = hashlib.sha256(msg).digest()
    em = b"\x00\x01" + b"\xff" * (k - 3 - 19 - 32) + b"\x00" + \
        jopenid._SHA256_PREFIX + digest
    sig = pow(int.from_bytes(em, "big"), d, n).to_bytes(k, "big")
    bad = bytes([sig[0] ^ 1]) + sig[1:]
    for s, m in ((sig, msg), (bad, msg), (sig, b"other"), (sig[1:], msg)):
        want = jopenid._rsa_pkcs1_sha256_verify(n, e, m, s)
        assert popenid._rsa_pkcs1_sha256_verify(n, e, m, s) == want
    assert popenid._rsa_pkcs1_sha256_verify(n, e, msg, sig)


def test_provider_verify_matches_jax_for_every_token(rsa_key, stub_idp):
    """RS256 through the JWKS stub and HS256 under a shared secret: the
    same claims, or the same error, for valid, tampered, expired,
    unsigned, audience-mismatched and malformed tokens."""
    n, _e, d = rsa_key
    now = int(time.time())
    jwks = f"http://127.0.0.1:{stub_idp.server_port}/jwks"
    good = {"sub": "alice", "exp": now + 600, "policy": "readwrite"}
    rs = sign_jwt_rs256(n, d, good)
    tokens = {
        "rs256": rs,
        "rs256 tampered": rs[:-8] + "AAAAAAAA",
        "rs256 expired": sign_jwt_rs256(n, d, {"sub": "a",
                                               "exp": now - 10}),
        "rs256 no exp": sign_jwt_rs256(n, d, {"sub": "a"}),
        "rs256 aud": sign_jwt_rs256(n, d, {**good, "aud": "myapp"}),
        "rs256 aud list": sign_jwt_rs256(n, d, {**good,
                                                "aud": ["x", "myapp"]}),
        "rs256 azp": sign_jwt_rs256(n, d, {**good, "azp": "myapp"}),
        "rs256 other aud": sign_jwt_rs256(n, d, {**good, "aud": "other"}),
        "rs256 unknown kid": sign_jwt_rs256(n, d, good, kid="k9"),
        "hs256": sign_hs256(good),
        "hs256 wrong secret": sign_hs256(good, "not-the-secret"),
        "alg none": _b64url(b'{"alg":"none"}') + "." +
        _b64url(json.dumps(good).encode()) + ".",
        "malformed": "not-a-jwt",
    }
    got = {}
    for pkg, mod in OPENID.items():
        rows = {}
        for client_id in ("", "myapp"):
            prov = mod.OpenIDProvider(jwks_url=jwks, client_id=client_id,
                                      hmac_secret=HMAC_SECRET)
            for label, tok in tokens.items():
                rows[(client_id, label)] = _outcome(
                    lambda tok=tok, prov=prov: prov.verify(tok))
        bare = mod.OpenIDProvider()
        rows["unconfigured"] = (bare.configured(),
                                _outcome(lambda: bare.verify(rs)))
        got[pkg] = rows
    assert got["port"] == got["jax"]
    rows = got["port"]
    assert rows[("", "rs256")] == ("ok", good)
    assert rows[("", "hs256")] == ("ok", good)
    assert rows[("myapp", "rs256 aud list")][0] == "ok"
    assert rows[("myapp", "rs256 azp")][0] == "ok"
    assert rows[("myapp", "rs256 other aud")] == \
        ("ValueError", "token audience mismatch")
    assert rows[("", "rs256 expired")] == ("ValueError", "JWT expired")
    assert rows[("", "rs256 tampered")] == \
        ("ValueError", "JWT signature mismatch")


def test_discovery_doc_and_jwks_by_discovery_match_jax(rsa_key, stub_idp):
    n, _e, d = rsa_key
    url = (f"http://127.0.0.1:{stub_idp.server_port}"
           "/.well-known/openid-configuration")
    tok = sign_jwt_rs256(n, d, {"sub": "svc", "exp": int(time.time()) + 60})
    got = {}
    for pkg, mod in OPENID.items():
        prov = mod.OpenIDProvider(config_url=url)
        got[pkg] = (prov.discovery_doc(), prov.verify(tok),
                    prov.jwks_url.endswith("/jwks"))
    assert got["port"] == got["jax"]
    assert got["port"][0]["issuer"] == "http://stub"


def test_ldap_bind_matches_jax():
    stub = MockLDAP("uid=bob,ou=people,dc=test", "hunter22")
    try:
        got = {}
        for pkg, mod in LDAP.items():
            rows = []
            for dn, pw in (("uid=bob,ou=people,dc=test", "hunter22"),
                           ("uid=bob,ou=people,dc=test", "wrong"),
                           ("uid=eve,ou=people,dc=test", "hunter22")):
                try:
                    mod.simple_bind(f"127.0.0.1:{stub.port}", dn, pw)
                    rows.append("ok")
                except mod.LDAPError as e:
                    rows.append(("LDAPError", e.code, str(e)))
            got[pkg] = rows
            for v in (0, 1, 127, 128, 255, 256, 1 << 20):
                got[pkg].append((mod._ber_int(v), mod._ber_len(v)))
    finally:
        stub.close()
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ["ok", ("LDAPError", 49,
                                      "ldap result 49: bind failed"),
                               ("LDAPError", 49,
                                "ldap result 49: bind failed")]
    assert stub.binds.count(("uid=bob,ou=people,dc=test", True)) == 2


# --- STS over both servers ---------------------------------------------------


def _sts(srv, form: dict):
    return requests.post(srv.endpoint() + "/", data=form, timeout=10)


def _creds(text: str) -> tuple[str, str]:
    ak = re.search(r"<AccessKeyId>([^<]+)</AccessKeyId>", text)
    sk = re.search(r"<SecretAccessKey>([^<]+)</SecretAccessKey>", text)
    return ak.group(1), sk.group(1)


def _kind(r) -> tuple:
    """(status, the action's response element, the credential's prefix)"""
    if r.status_code != 200:
        code = re.search(rb"<Code>([^<]+)</Code>", r.content)
        return r.status_code, code.group(1).decode() if code else ""
    ak, _ = _creds(r.text)
    # the credential's kind: the access key less its 16 random hex digits
    return 200, re.match(r"<\?xml[^>]*><(\w+)", r.text).group(1), ak[:-16]


def sts_flows(srv, rsa_key, stub_idp, monkeypatch) -> list:
    """The STS actions of tests/test_identity.py on one server, each with
    the S3 calls its credential is allowed or denied."""
    n, _e, d = rsa_key
    ep = srv.endpoint()
    port = stub_idp.server_port
    root = S3Client(ep, srv.access_key, srv.secret_key)
    out = [("bucket", root.put_bucket("idb").status_code),
           ("object", root.put_object("idb", "k", b"v").status_code)]
    now = int(time.time())
    monkeypatch.setenv("MINIO_TPU_IDENTITY_OPENID_JWKS_URL",
                       f"http://127.0.0.1:{port}/jwks")
    tok = sign_jwt_rs256(n, d, {"sub": "alice", "exp": now + 600,
                                "policy": "readwrite"})
    r = _sts(srv, {"Action": "AssumeRoleWithWebIdentity",
                   "WebIdentityToken": tok, "Version": "2011-06-15"})
    out.append(("web identity rs256", _kind(r)))
    c = S3Client(ep, *_creds(r.text))
    out += [("wi put", c.put_object("idb", "wi", b"w").status_code),
            ("wi get", c.get_object("idb", "wi").content)]
    out.append(("tampered", _kind(_sts(srv, {
        "Action": "AssumeRoleWithWebIdentity",
        "WebIdentityToken": tok[:-8] + "AAAAAAAA"}))))
    out.append(("expired", _kind(_sts(srv, {
        "Action": "AssumeRoleWithWebIdentity",
        "WebIdentityToken": sign_jwt_rs256(n, d, {"sub": "a",
                                                  "exp": now - 10})}))))
    monkeypatch.setenv("MINIO_TPU_IDENTITY_OPENID_CLIENT_ID", "myapp")
    for aud in ("myapp", "otherapp"):
        out.append((f"audience {aud}", _kind(_sts(srv, {
            "Action": "AssumeRoleWithWebIdentity",
            "WebIdentityToken": sign_jwt_rs256(
                n, d, {"sub": "a", "aud": aud, "exp": now + 600})}))))
    monkeypatch.delenv("MINIO_TPU_IDENTITY_OPENID_CLIENT_ID")
    monkeypatch.delenv("MINIO_TPU_IDENTITY_OPENID_JWKS_URL")
    monkeypatch.setenv("MINIO_TPU_IDENTITY_OPENID_CONFIG_URL",
                       f"http://127.0.0.1:{port}"
                       "/.well-known/openid-configuration")
    r = _sts(srv, {"Action": "AssumeRoleWithClientGrants",
                   "Token": sign_jwt_rs256(n, d, {
                       "sub": "svc-1", "exp": now + 600,
                       "policy": "readonly"})})
    out.append(("client grants", _kind(r)))
    c = S3Client(ep, *_creds(r.text))
    out += [("cg get", c.get_object("idb", "k").content),
            ("cg put denied", c.put_object("idb", "no", b"x").status_code)]
    monkeypatch.delenv("MINIO_TPU_IDENTITY_OPENID_CONFIG_URL")
    monkeypatch.setenv("MINIO_TPU_OPENID_HMAC_SECRET", HMAC_SECRET)
    session = json.dumps({"Statement": [{
        "Effect": "Allow", "Action": "s3:GetObject",
        "Resource": "arn:aws:s3:::idb/*"}]})
    r = _sts(srv, {"Action": "AssumeRoleWithWebIdentity",
                   "WebIdentityToken": sign_hs256({
                       "sub": "bob", "exp": now + 600,
                       "policy": "readwrite"}),
                   "Policy": session})
    out.append(("web identity hs256", _kind(r)))
    c = S3Client(ep, *_creds(r.text))
    out += [("hs get", c.get_object("idb", "k").content),
            ("hs put narrowed", c.put_object("idb", "h", b"x").status_code)]
    out.append(("hs256 wrong secret", _kind(_sts(srv, {
        "Action": "AssumeRoleWithWebIdentity",
        "WebIdentityToken": sign_hs256({"sub": "b", "exp": now + 60},
                                       "nope")}))))
    monkeypatch.delenv("MINIO_TPU_OPENID_HMAC_SECRET")
    out.append(("no provider", _kind(_sts(srv, {
        "Action": "AssumeRoleWithWebIdentity", "WebIdentityToken": tok}))))
    ldap = MockLDAP("uid=bob,ou=people,dc=test", "hunter22")
    try:
        monkeypatch.setenv("MINIO_TPU_IDENTITY_LDAP_SERVER_ADDR",
                           f"127.0.0.1:{ldap.port}")
        monkeypatch.setenv("MINIO_TPU_IDENTITY_LDAP_USER_DN_FORMAT",
                           "uid=%s,ou=people,dc=test")
        monkeypatch.setenv("MINIO_TPU_IDENTITY_LDAP_STS_POLICY",
                           "readwrite")
        r = _sts(srv, {"Action": "AssumeRoleWithLDAPIdentity",
                       "LDAPUsername": "bob", "LDAPPassword": "hunter22"})
        out.append(("ldap", _kind(r)))
        c = S3Client(ep, *_creds(r.text))
        out += [("ldap put", c.put_object("idb", "l", b"l").status_code)]
        for user, pw in (("bob", "wrong"), ("b=ob", "hunter22"),
                         ("bob", "")):
            out.append((f"ldap {user}/{pw}", _kind(_sts(srv, {
                "Action": "AssumeRoleWithLDAPIdentity",
                "LDAPUsername": user, "LDAPPassword": pw}))))
        out.append(("ldap binds", list(ldap.binds)))
    finally:
        ldap.close()
    return out


def test_sts_flows_match_jax(rsa_key, stub_idp, monkeypatch, tmp_path):
    got = {}
    for pkg in ("jax", "port"):
        s = Server(pkg, tmp_path / pkg)
        try:
            s.srv.enable_iam()
            got[pkg] = sts_flows(s.srv, rsa_key, stub_idp, monkeypatch)
        finally:
            s.close()
    assert got["port"] == got["jax"]
    rows = dict(got["port"])
    assert rows["web identity rs256"] == \
        (200, "AssumeRoleWithWebIdentityResponse", "STSWI")
    assert rows["client grants"] == \
        (200, "AssumeRoleWithClientGrantsResponse", "STSCG")
    assert rows["ldap"] == (200, "AssumeRoleWithLDAPIdentityResponse",
                            "STSLDAP")
    assert rows["tampered"] == rows["expired"] == \
        (400, "InvalidParameterValue")
    assert rows["audience otherapp"][0] == 400
    assert rows["hs put narrowed"] == 403 and rows["cg put denied"] == 403
    assert rows["wi get"] == b"w" and rows["hs get"] == b"v"
