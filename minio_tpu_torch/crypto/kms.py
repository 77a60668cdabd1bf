"""KMS backends for SSE-S3 / SSE-KMS, the port of minio_tpu/crypto/kms.py
(reference cmd/crypto/kms.go, kes.go, vault.go).

The reference abstracts master-key services behind a ``KMS`` interface
(cmd/crypto/kms.go:31 ``GenerateKey/UnsealKey/Info``) with three
implementations: a dev master-key KMS, a KES client (cmd/crypto/kes.go)
and a Vault client (cmd/crypto/vault.go). Here, as in the JAX package:

* ``LocalKMS`` — process-local AES-GCM master key (the port's native
  engine, crypto/aesgcm.py), with per-key-id subkeys derived by HMAC so
  SSE-KMS requests that name a key id work without an external service.
  Its blobs are byte-identical to the JAX package's.
* ``KESClient`` — the reference's KES wire protocol
  (``POST /v1/key/create|generate|decrypt/{name}``, base64 JSON bodies,
  mTLS client certs), over urllib so no extra dependency is needed.
* ``VaultClient`` — HashiCorp Vault transit engine (AppRole or token
  auth, ``/v1/transit/datakey|decrypt|rewrap``), matching
  cmd/crypto/vault.go's request/blob shapes.

``generate_key`` returns (plaintext data key, sealed blob); the sealed
blob is stored in object metadata and unsealed on read. Context binds
the blob to its object so blobs can't be replayed across objects.

``get_kms`` resolves the process KMS from the environment in the JAX
package's order: ``set_kms`` > KES (``MINIO_TPU_KMS_KES_*``) > Vault
(``MINIO_TPU_KMS_VAULT_*``) > ``MINIO_TPU_KMS_MASTER_KEY`` (hex) > a key
derived from the server's root secret (``configure``)."""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import secrets
import ssl
import urllib.error
import urllib.parse
import urllib.request

from .aesgcm import AESGCM


class KMSError(Exception):
    pass


class KMSUnreachable(KMSError):
    """No KMS endpoint answered — a transient availability failure, not a
    wrong-key condition; callers should surface 503, not AccessDenied."""


class KMS:
    """What the SSE paths need from any master-key service
    (cmd/crypto/kms.go:31)."""

    key_id: str = ""

    def generate_key(self, context: str, key_id: str = ""
                     ) -> tuple[bytes, bytes]:
        raise NotImplementedError

    def unseal(self, blob: bytes, context: str, key_id: str = "") -> bytes:
        raise NotImplementedError

    def create_key(self, key_id: str) -> None:
        raise NotImplementedError

    def info(self) -> dict:
        raise NotImplementedError


class LocalKMS(KMS):
    def __init__(self, master_key: bytes, key_id: str = "minio-tpu-default"):
        if len(master_key) != 32:
            raise ValueError("KMS master key must be 32 bytes")
        self.key_id = key_id
        self._master = master_key
        self._aead_cache: dict[str, AESGCM] = {}

    def _aead(self, key_id: str) -> AESGCM:
        a = self._aead_cache.get(key_id)
        if a is None:
            if key_id == self.key_id:
                # the default key seals directly under the master key —
                # blobs written before named-key support stay readable
                sub = self._master
            else:
                sub = hmac.new(self._master, b"minio-tpu-kms-sub:" +
                               key_id.encode(), hashlib.sha256).digest()
            a = self._aead_cache[key_id] = AESGCM(sub)
        return a

    def generate_key(self, context: str, key_id: str = ""
                     ) -> tuple[bytes, bytes]:
        """(plaintext 32-byte data key, sealed blob)."""
        kid = key_id or self.key_id
        key = secrets.token_bytes(32)
        nonce = secrets.token_bytes(12)
        blob = nonce + self._aead(kid).encrypt(nonce, key, context.encode())
        return key, blob

    def unseal(self, blob: bytes, context: str, key_id: str = "") -> bytes:
        nonce, ct = blob[:12], blob[12:]
        return self._aead(key_id or self.key_id).decrypt(
            nonce, ct, context.encode())

    def create_key(self, key_id: str) -> None:
        self._aead(key_id)  # derived on demand; nothing to persist

    def info(self) -> dict:
        return {"name": "local", "endpoints": [], "default_key_id":
                self.key_id, "status": "online"}


class KESClient(KMS):
    """Client for a KES key-management server speaking the reference wire
    protocol (cmd/crypto/kes.go:222-320):

    * ``POST /v1/key/create/{name}``
    * ``POST /v1/key/generate/{name}`` body ``{"context": b64}`` →
      ``{"plaintext": b64, "ciphertext": b64}``
    * ``POST /v1/key/decrypt/{name}`` body ``{"ciphertext": b64,
      "context": b64}`` → ``{"plaintext": b64}``

    mTLS client authentication mirrors KesConfig (cert_file/key_file/
    ca_path); plain http endpoints are accepted for tests."""

    def __init__(self, endpoints: list[str], default_key_id: str,
                 cert_file: str = "", key_file: str = "", ca_path: str = "",
                 timeout: float = 5.0, insecure: bool = False):
        if not endpoints:
            raise KMSError("kes: missing endpoint")
        self.endpoints = [e.rstrip("/") for e in endpoints]
        self.key_id = default_key_id
        self.timeout = timeout
        self._ctx = None
        if any(e.startswith("https") for e in self.endpoints):
            # no ca_path -> system trust store; verification is only ever
            # dropped on explicit request (self-signed dev KES), because a
            # MITM'd KES connection leaks every object data key
            self._ctx = ssl.create_default_context(
                cafile=ca_path or None)
            if insecure:
                self._ctx.check_hostname = False
                self._ctx.verify_mode = ssl.CERT_NONE
            if cert_file and key_file:
                self._ctx.load_cert_chain(cert_file, key_file)
        self._rr = 0

    def _post(self, path: str, body: dict) -> dict:
        data = json.dumps(body).encode()
        last: Exception | None = None
        for i in range(len(self.endpoints)):
            ep = self.endpoints[(self._rr + i) % len(self.endpoints)]
            req = urllib.request.Request(
                ep + path, data=data, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout, context=self._ctx) as r:
                    self._rr = (self._rr + i) % len(self.endpoints)
                    payload = r.read()
                    return json.loads(payload) if payload else {}
            except urllib.error.HTTPError as e:
                detail = e.read().decode(errors="replace")[:200]
                if e.code >= 500:
                    # server-side trouble on this endpoint; another may
                    # be healthy
                    last = KMSError(f"kes: {e.code} {detail}")
                    continue
                # 4xx is a definitive server answer, not a connectivity
                # failure — don't fail over, surface it.
                raise KMSError(f"kes: {e.code} {detail}") from None
            except Exception as e:  # noqa: BLE001 — connectivity: try next
                last = e
        raise KMSUnreachable(f"kes: all endpoints unreachable: {last}")

    def create_key(self, key_id: str) -> None:
        self._post(f"/v1/key/create/{urllib.parse.quote(key_id, safe='')}",
                   {})

    def generate_key(self, context: str, key_id: str = ""
                     ) -> tuple[bytes, bytes]:
        kid = key_id or self.key_id
        resp = self._post(
            f"/v1/key/generate/{urllib.parse.quote(kid, safe='')}",
            {"context": base64.b64encode(context.encode()).decode()})
        try:
            key = base64.b64decode(resp["plaintext"])
            blob = base64.b64decode(resp["ciphertext"])
        except (KeyError, TypeError, ValueError) as e:
            raise KMSError(f"kes: malformed generate response: {e!r}") \
                from None
        if len(key) != 32:
            raise KMSError("kes: invalid plaintext key size from KMS")
        return key, blob

    def unseal(self, blob: bytes, context: str, key_id: str = "") -> bytes:
        kid = key_id or self.key_id
        resp = self._post(
            f"/v1/key/decrypt/{urllib.parse.quote(kid, safe='')}",
            {"ciphertext": base64.b64encode(blob).decode(),
             "context": base64.b64encode(context.encode()).decode()})
        try:
            key = base64.b64decode(resp["plaintext"])
        except (KeyError, TypeError, ValueError) as e:
            raise KMSError(f"kes: malformed decrypt response: {e!r}") \
                from None
        if len(key) != 32:
            raise KMSError("kes: invalid plaintext key size from KMS")
        return key

    def info(self) -> dict:
        return {"name": "KES", "endpoints": self.endpoints,
                "default_key_id": self.key_id, "status": "online"}


class VaultClient(KMS):
    """HashiCorp Vault transit-engine KMS (reference cmd/crypto/vault.go):

    * AppRole login ``POST /v1/auth/approle/login`` → client token, sent
      as ``X-Vault-Token`` on every call (vault.go:159-194); a 403 mid-
      stream re-authenticates once (the reference renews on a timer).
    * data keys: ``POST /v1/transit/datakey/plaintext/{key}`` with the
      b64 context → ``data.plaintext`` (b64 32-byte key) +
      ``data.ciphertext`` (vault.go:225-251).
    * unseal: ``POST /v1/transit/decrypt/{key}`` (vault.go:260-285);
      rewrap after key rotation: ``POST /v1/transit/rewrap/{key}``
      (vault.go:293-310).

    Sealed blobs are Vault's ASCII ``vault:v1:...`` ciphertext, stored
    as bytes — exactly what the reference persists in object metadata.
    """

    def __init__(self, endpoint: str, default_key_id: str,
                 role_id: str = "", secret_id: str = "", token: str = "",
                 namespace: str = "", timeout: float = 5.0,
                 ca_path: str = "", insecure: bool = False):
        if not endpoint:
            raise KMSError("vault: missing endpoint")
        self.endpoint = endpoint.rstrip("/")
        self.key_id = default_key_id
        self.role_id = role_id
        self.secret_id = secret_id
        self.namespace = namespace
        self.timeout = timeout
        self._token = token
        self._ctx = None
        if self.endpoint.startswith("https"):
            self._ctx = ssl.create_default_context(cafile=ca_path or None)
            if insecure:
                self._ctx.check_hostname = False
                self._ctx.verify_mode = ssl.CERT_NONE

    def _login(self) -> None:
        if not self.role_id:
            raise KMSError("vault: no token and no AppRole credentials")
        resp = self._raw_post("/v1/auth/approle/login",
                              {"role_id": self.role_id,
                               "secret_id": self.secret_id}, auth=False)
        try:
            self._token = resp["auth"]["client_token"]
        except (KeyError, TypeError) as e:
            raise KMSError(f"vault: malformed login response: {e!r}") \
                from None

    def _raw_post(self, path: str, body: dict, auth: bool = True) -> dict:
        headers = {"Content-Type": "application/json"}
        if auth:
            headers["X-Vault-Token"] = self._token
        if self.namespace:
            headers["X-Vault-Namespace"] = self.namespace
        req = urllib.request.Request(
            self.endpoint + path, data=json.dumps(body).encode(),
            method="POST", headers=headers)
        try:
            with urllib.request.urlopen(
                    req, timeout=self.timeout, context=self._ctx) as r:
                payload = r.read()
                return json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:200]
            raise _VaultHTTPError(e.code,
                                  f"vault: {e.code} {detail}") from None
        except Exception as e:  # noqa: BLE001 — connectivity
            raise KMSUnreachable(f"vault: {self.endpoint}: {e}") from None

    def _post(self, path: str, body: dict) -> dict:
        if not self._token:
            self._login()
        try:
            return self._raw_post(path, body)
        except _VaultHTTPError as e:
            if e.code == 403 and self.role_id:
                # token expired: one re-login, then surface failures
                self._login()
                return self._raw_post(path, body)
            raise

    def create_key(self, key_id: str) -> None:
        self._post(
            f"/v1/transit/keys/{urllib.parse.quote(key_id, safe='')}", {})

    def generate_key(self, context: str, key_id: str = ""
                     ) -> tuple[bytes, bytes]:
        kid = key_id or self.key_id
        resp = self._post(
            "/v1/transit/datakey/plaintext/"
            f"{urllib.parse.quote(kid, safe='')}",
            {"context": base64.b64encode(context.encode()).decode()})
        data = resp.get("data") or {}
        try:
            key = base64.b64decode(data["plaintext"])
            blob = data["ciphertext"].encode()
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise KMSError(
                f"vault: malformed datakey response: {e!r}") from None
        if len(key) != 32:
            raise KMSError("vault: invalid plaintext key size from KMS")
        return key, blob

    def unseal(self, blob: bytes, context: str, key_id: str = "") -> bytes:
        kid = key_id or self.key_id
        resp = self._post(
            f"/v1/transit/decrypt/{urllib.parse.quote(kid, safe='')}",
            {"ciphertext": blob.decode("ascii", "replace"),
             "context": base64.b64encode(context.encode()).decode()})
        data = resp.get("data") or {}
        try:
            key = base64.b64decode(data["plaintext"])
        except (KeyError, TypeError, ValueError) as e:
            raise KMSError(
                f"vault: malformed decrypt response: {e!r}") from None
        if len(key) != 32:
            raise KMSError("vault: invalid plaintext key size from KMS")
        return key

    def rewrap(self, blob: bytes, context: str, key_id: str = "") -> bytes:
        """Re-seal a blob under the current master key version after a
        Vault-side rotation (reference UpdateKey, vault.go:293)."""
        kid = key_id or self.key_id
        resp = self._post(
            f"/v1/transit/rewrap/{urllib.parse.quote(kid, safe='')}",
            {"ciphertext": blob.decode("ascii", "replace"),
             "context": base64.b64encode(context.encode()).decode()})
        data = resp.get("data") or {}
        ct = data.get("ciphertext")
        if not isinstance(ct, str):
            raise KMSError("vault: rewrap response missing ciphertext")
        return ct.encode()

    def info(self) -> dict:
        return {"name": "Vault", "endpoints": [self.endpoint],
                "default_key_id": self.key_id, "status": "online"}


class _VaultHTTPError(KMSError):
    def __init__(self, code: int, msg: str):
        self.code = code
        super().__init__(msg)


_kms: KMS | None = None
_seed_secret = ""


def configure(seed_secret: str):
    """Give the KMS a deployment-specific seed (the server's root secret)
    for the derived-key fallback. Called by S3Server at construction."""
    global _seed_secret
    _seed_secret = seed_secret


def set_kms(kms: KMS | None):
    """Install a specific KMS (tests, or explicit server config)."""
    global _kms
    _kms = kms


def get_kms() -> KMS:
    """Process KMS resolution order (reference cmd/crypto/config.go
    LookupConfig): explicit set_kms > KES from env > local master key from
    MINIO_TPU_KMS_MASTER_KEY (hex) > key derived from the root secret
    (with a warning — production must set a real master key; the
    reference refuses SSE without a KMS for the same reason)."""
    global _kms
    if _kms is None:
        kes_ep = os.environ.get("MINIO_TPU_KMS_KES_ENDPOINT", "")
        if kes_ep:
            _kms = KESClient(
                kes_ep.split(","),
                os.environ.get("MINIO_TPU_KMS_KES_KEY_NAME",
                               "minio-tpu-default"),
                cert_file=os.environ.get("MINIO_TPU_KMS_KES_CERT_FILE", ""),
                key_file=os.environ.get("MINIO_TPU_KMS_KES_KEY_FILE", ""),
                ca_path=os.environ.get("MINIO_TPU_KMS_KES_CAPATH", ""),
                insecure=os.environ.get(
                    "MINIO_TPU_KMS_KES_INSECURE", "") == "1")
            return _kms
        vault_ep = os.environ.get("MINIO_TPU_KMS_VAULT_ENDPOINT", "")
        if vault_ep:
            _kms = VaultClient(
                vault_ep,
                os.environ.get("MINIO_TPU_KMS_VAULT_KEY_NAME",
                               "minio-tpu-default"),
                role_id=os.environ.get(
                    "MINIO_TPU_KMS_VAULT_APPROLE_ID", ""),
                secret_id=os.environ.get(
                    "MINIO_TPU_KMS_VAULT_APPROLE_SECRET", ""),
                token=os.environ.get("MINIO_TPU_KMS_VAULT_TOKEN", ""),
                namespace=os.environ.get(
                    "MINIO_TPU_KMS_VAULT_NAMESPACE", ""),
                ca_path=os.environ.get("MINIO_TPU_KMS_VAULT_CAPATH", ""),
                insecure=os.environ.get(
                    "MINIO_TPU_KMS_VAULT_INSECURE", "") == "1")
            return _kms
        hexkey = os.environ.get("MINIO_TPU_KMS_MASTER_KEY", "")
        if hexkey:
            master = bytes.fromhex(hexkey)
        else:
            import logging
            logging.getLogger("minio_tpu_torch.crypto").warning(
                "no MINIO_TPU_KMS_MASTER_KEY configured: SSE-S3 keys are "
                "sealed under a key derived from the root secret — set a "
                "dedicated master key for production")
            seed = _seed_secret or os.environ.get(
                "MINIO_TPU_SECRET_KEY", "minio-tpu-dev")
            master = hashlib.sha256(
                b"minio-tpu-kms-dev:" + seed.encode()).digest()
        _kms = LocalKMS(master)
    return _kms
