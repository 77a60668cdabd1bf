"""The port's KMS (minio_tpu_torch.crypto.kms) and its OEK envelope held to
the JAX package's (minio_tpu.crypto.kms, crypto/sse.py): with
``secrets.token_bytes`` pinned in both, the sealed OEK and the LocalKMS
blobs are the same bytes and each package unseals the other's; a named key
id derives the same sub-key; a wrong context or key id fails in both.
``get_kms`` resolves the same backend from the same ``MINIO_TPU_KMS_*``
environment. The KES and Vault clients of both packages, run against one
recording loopback stub, send the same method, path and JSON body, fail
over alike, and map an outage to ``KMSUnreachable``. The S3 set-up maps
an outage to 503 and a wrong master key to 403."""
import base64
import hashlib
import io
import itertools
import json
import secrets
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
from cryptography.exceptions import InvalidTag as WheelInvalidTag

from minio_tpu.crypto import kms as jkms
from minio_tpu.crypto import sse as jsse
from minio_tpu_torch.crypto import aesgcm
from minio_tpu_torch.crypto import kms as pkms
from minio_tpu_torch.crypto import sse
from minio_tpu_torch.erasure.streaming import BufferSink
from minio_tpu_torch.utils import errors

MASTER = bytes(range(7, 39))
OEK = bytes(range(32, 64))
DK = hashlib.sha256(b"data key").digest()


class Keys:
    """``secrets.token_bytes`` on a counter (the same stream per reset)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._n = itertools.count(1)

    def __call__(self, n: int = 32) -> bytes:
        return hashlib.sha256(b"%d" % next(self._n)).digest()[:n]


@pytest.fixture
def keys(monkeypatch):
    k = Keys()
    monkeypatch.setattr(secrets, "token_bytes", k)
    return k


def both(keys, fn):
    """fn(package module set) for the JAX package and the port, each from
    the same pinned random stream."""
    out = []
    for mods in ((jkms, jsse), (pkms, sse)):
        keys.reset()
        out.append(fn(*mods))
    return out


@pytest.mark.parametrize("cipher", [sse.CIPHER_AESGCM, sse.CIPHER_CHACHA20])
def test_sealed_oek_is_the_same_bytes(keys, cipher):
    def seal(_, s):
        kw = {"device": "cpu"} if s is sse else {}
        return s.seal_object_key(OEK, DK, "b", "o/k", cipher=cipher, **kw)

    jax_sealed, port_sealed = both(keys, seal)
    assert port_sealed == jax_sealed and len(port_sealed) == 12 + 32 + 16
    assert sse.unseal_object_key(jax_sealed, DK, "b", "o/k", cipher=cipher,
                                 device="cpu") == OEK
    assert jsse.unseal_object_key(port_sealed, DK, "b", "o/k",
                                  cipher=cipher) == OEK
    # the envelope is bound to the object path and the scheme key
    for bad in ((DK, "b", "o/other"), (bytes(32), "b", "o/k")):
        with pytest.raises(errors.SSEKeyMismatch):
            sse.unseal_object_key(port_sealed, *bad, cipher=cipher,
                                  device="cpu")


@pytest.mark.parametrize("key_id", ["", "minio-tpu-default", "tenant-7"])
def test_local_kms_blobs_are_the_same_bytes(keys, key_id):
    ctx = "bkt/obj|{\"a\":1}"
    jax_out, port_out = both(keys, lambda k, _: k.LocalKMS(MASTER)
                             .generate_key(ctx, key_id=key_id))
    assert port_out == jax_out
    dk, blob = port_out
    assert jkms.LocalKMS(MASTER).unseal(blob, ctx, key_id=key_id) == dk
    assert pkms.LocalKMS(MASTER).unseal(blob, ctx, key_id=key_id) == dk
    if key_id not in ("", "minio-tpu-default"):
        # the named key's HMAC sub-key, not the master itself
        sub = jkms.LocalKMS(MASTER)._aead(key_id)
        assert sub.decrypt(blob[:12], blob[12:], ctx.encode()) == dk
        with pytest.raises(aesgcm.InvalidTag):
            pkms.LocalKMS(MASTER).unseal(blob, ctx)


@pytest.mark.parametrize("wrong", ["context", "key id", "master"])
def test_a_wrong_context_key_id_or_master_fails_in_both(keys, wrong):
    ctx = "bkt/obj|"
    dk, blob = pkms.LocalKMS(MASTER).generate_key(ctx, key_id="k1")
    args = {"context": ("bkt/other|", "k1", MASTER),
            "key id": (ctx, "k2", MASTER),
            "master": (ctx, "k1", bytes(32))}[wrong]
    with pytest.raises(WheelInvalidTag):
        jkms.LocalKMS(args[2]).unseal(blob, args[0], key_id=args[1])
    with pytest.raises(aesgcm.InvalidTag):
        pkms.LocalKMS(args[2]).unseal(blob, args[0], key_id=args[1])


def test_local_kms_surface_matches():
    for mod in (jkms, pkms):
        with pytest.raises(ValueError, match="32 bytes"):
            mod.LocalKMS(b"short")
    assert pkms.LocalKMS(MASTER).info() == jkms.LocalKMS(MASTER).info()
    pkms.LocalKMS(MASTER).create_key("anything")  # derived on demand


ENVS = [
    {},
    {"MINIO_TPU_KMS_MASTER_KEY": MASTER.hex()},
    {"MINIO_TPU_KMS_KES_ENDPOINT": "http://127.0.0.1:1,http://127.0.0.1:2",
     "MINIO_TPU_KMS_KES_KEY_NAME": "kes-key",
     "MINIO_TPU_KMS_MASTER_KEY": MASTER.hex()},
    {"MINIO_TPU_KMS_VAULT_ENDPOINT": "http://127.0.0.1:3/",
     "MINIO_TPU_KMS_VAULT_KEY_NAME": "vk",
     "MINIO_TPU_KMS_VAULT_APPROLE_ID": "role",
     "MINIO_TPU_KMS_VAULT_APPROLE_SECRET": "secret",
     "MINIO_TPU_KMS_VAULT_NAMESPACE": "ns"},
    {"MINIO_TPU_KMS_KES_ENDPOINT": "http://127.0.0.1:4",
     "MINIO_TPU_KMS_VAULT_ENDPOINT": "http://127.0.0.1:5"},
]


def _described(k) -> tuple:
    return (type(k).__name__, k.key_id, k.info(),
            getattr(k, "_master", None), getattr(k, "role_id", None),
            getattr(k, "namespace", None))


@pytest.mark.parametrize("env", range(len(ENVS)))
def test_get_kms_resolves_alike(monkeypatch, env):
    for var in ("MINIO_TPU_KMS_MASTER_KEY", "MINIO_TPU_SECRET_KEY") + tuple(
            k for e in ENVS for k in e):
        monkeypatch.delenv(var, raising=False)
    for var, value in ENVS[env].items():
        monkeypatch.setenv(var, value)
    got = []
    for mod in (jkms, pkms):
        monkeypatch.setattr(mod, "_kms", None)
        monkeypatch.setattr(mod, "_seed_secret", "")
        mod.configure("root-secret-1")
        first = mod.get_kms()
        assert mod.get_kms() is first  # resolved once per process
        got.append(_described(first))
    assert got[1] == got[0]
    explicit = pkms.LocalKMS(MASTER)
    pkms.set_kms(explicit)
    assert pkms.get_kms() is explicit


# --- KES and Vault against one recording stub -------------------------------

PLAIN = base64.b64encode(DK).decode()


class _Stub(BaseHTTPRequestHandler):
    """Records every request; answers the KES and Vault transit wire
    shapes with fixed keys. ``fail`` pops statuses to answer instead; a
    Vault call with a token other than ``token`` gets 403."""

    log: list = []
    fail: list = []
    token = "tok-1"
    logins = 0

    def log_message(self, *a):
        pass

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length", 0) or 0)
        body = json.loads(self.rfile.read(n) or b"{}")
        cls = type(self)
        cls.log.append(("POST", self.path, body,
                        self.headers.get("X-Vault-Token"),
                        self.headers.get("X-Vault-Namespace")))
        if cls.fail:
            return self._reply(cls.fail.pop(0), {"message": "injected"})
        p = self.path
        if p == "/v1/auth/approle/login":
            cls.logins += 1
            return self._reply(200, {"auth": {"client_token": cls.token}})
        if p.startswith("/v1/transit/") and \
                self.headers.get("X-Vault-Token") != cls.token:
            return self._reply(403, {"errors": ["permission denied"]})
        if p.startswith(("/v1/key/create/", "/v1/transit/keys/")):
            return self._reply(200, {})
        if p.startswith("/v1/key/generate/"):
            return self._reply(200, {"plaintext": PLAIN, "ciphertext":
                                     base64.b64encode(b"kes-blob").decode()})
        if p.startswith("/v1/key/decrypt/"):
            return self._reply(200, {"plaintext": PLAIN})
        if p.startswith("/v1/transit/datakey/plaintext/"):
            return self._reply(200, {"data": {"plaintext": PLAIN,
                                              "ciphertext": "vault:v1:xyz"}})
        if p.startswith("/v1/transit/decrypt/"):
            return self._reply(200, {"data": {"plaintext": PLAIN}})
        if p.startswith("/v1/transit/rewrap/"):
            return self._reply(200, {"data": {"ciphertext": "vault:v2:xyz"}})
        self._reply(404, {"message": "unknown"})

    def _reply(self, status, obj):
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture
def stub():
    _Stub.log, _Stub.fail, _Stub.token, _Stub.logins = [], [], "tok-1", 0
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _dead() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"


def _kes_session(mod, ep):
    c = mod.KESClient([ep], "my key/1")
    c.create_key("tenant a")
    out = [c.generate_key("bkt/obj|ctx"),
           c.generate_key("x", key_id="other"),
           c.unseal(b"kes-blob", "bkt/obj|ctx"), c.info()["name"]]
    _Stub.fail.append(400)
    with pytest.raises(mod.KMSError, match="400"):
        c.unseal(b"kes-blob", "c")
    return out


def _vault_session(mod, ep):
    c = mod.VaultClient(ep, "vk", role_id="role", secret_id="s",
                        namespace="ns")
    out = [c.generate_key("bkt/obj"), c.unseal(b"vault:v1:xyz", "bkt/obj")]
    _Stub.token = "tok-2"  # the token expires: one re-login, then retry
    out += [c.rewrap(b"vault:v1:xyz", "bkt/obj", key_id="k2"),
            c.create_key("k3"), c.info()["name"]]
    _Stub.fail.append(403)
    _Stub.fail.append(403)
    with pytest.raises(mod.KMSError, match="403"):
        c.unseal(b"vault:v1:xyz", "bkt/obj")
    return out


@pytest.mark.parametrize("session", [_kes_session, _vault_session],
                         ids=["kes", "vault"])
def test_clients_send_the_same_requests(stub, session):
    got = {}
    for name, mod in (("jax", jkms), ("port", pkms)):
        _Stub.log, _Stub.fail, _Stub.token = [], [], "tok-1"
        got[name] = (session(mod, stub), list(_Stub.log))
    assert got["port"] == got["jax"]
    assert got["port"][1]  # the stub saw the session


def test_kes_fails_over_and_reports_an_outage(stub):
    for mod in (jkms, pkms):
        _Stub.log, _Stub.fail = [], []
        c = mod.KESClient([_dead(), stub], "k")
        assert c.generate_key("ctx")[0] == DK  # the dead endpoint skipped
        _Stub.fail.append(503)  # a 5xx fails over to the next endpoint
        c2 = mod.KESClient([stub, stub], "k")
        assert c2.unseal(b"kes-blob", "ctx") == DK
        assert len(_Stub.log) == 3
        with pytest.raises(mod.KMSUnreachable):
            mod.KESClient([_dead(), _dead()], "k").generate_key("ctx")
        with pytest.raises(mod.KMSUnreachable):
            mod.VaultClient(_dead(), "k", token="t").generate_key("ctx")
        with pytest.raises(mod.KMSError, match="missing endpoint"):
            mod.KESClient([], "k")


# --- the S3 set-up's KMS branches -------------------------------------------


def _put(info, plain=b"p" * 1000):
    meta = {}
    reader, size, resp = sse.encrypt_setup(info, io.BytesIO(plain),
                                           len(plain), meta, "b", "o",
                                           device="cpu")
    return meta, reader.read(), size, resp


def _get(meta, size):
    oek, iv, psize, resp, cipher = sse.sse_read_ctx(meta, {}, "b", "o", size,
                                                    device="cpu")
    out = BufferSink()
    dw = sse.DecryptWriter(out, oek, iv, 0, 0, psize, "b", "o", cipher,
                           device="cpu")
    return out, dw, resp


@pytest.mark.parametrize("cipher", ["aes-gcm", "chacha20"])
@pytest.mark.parametrize("scheme", ["S3", "KMS"])
def test_s3_and_kms_setup_round_trip_and_failures(monkeypatch, scheme,
                                                  cipher):
    monkeypatch.setenv("MINIO_TPU_SSE_CIPHER", cipher)
    monkeypatch.setattr(pkms, "_kms", pkms.LocalKMS(MASTER))
    hdr = {"x-amz-server-side-encryption":
           "AES256" if scheme == "S3" else "aws:kms"}
    if scheme == "KMS":
        hdr["x-amz-server-side-encryption-aws-kms-key-id"] = "k1"
        hdr["x-amz-server-side-encryption-context"] = base64.b64encode(
            b'{"z":1}').decode()
    meta, ct, size, resp = _put(sse.parse_sse_headers(hdr, "b", "o"))
    assert meta[sse.META_CIPHER] == sse.default_cipher()
    assert meta[sse.META_SCHEME] == scheme
    out, dw, resp2 = _get(meta, size)
    dw.write(ct)
    dw.close()
    assert out.getvalue() == b"p" * 1000 and resp2 == resp
    # a rotated master key: the 403 of a key mismatch
    monkeypatch.setattr(pkms, "_kms", pkms.LocalKMS(bytes(32)))
    with pytest.raises(errors.SSEKeyMismatch) as e:
        _get(meta, size)
    assert e.value.http_status == 403
    # the KMS unreachable on GET and on PUT: 503 ServiceUnavailable
    monkeypatch.setattr(pkms, "_kms", pkms.KESClient([_dead()], "k"))
    for call in (lambda: _get(meta, size),
                 lambda: _put(sse.parse_sse_headers(hdr, "b", "o"))):
        with pytest.raises(errors.KMSNotAvailable) as e:
            call()
        assert (e.value.code, e.value.http_status) == \
            ("ServiceUnavailable", 503)
