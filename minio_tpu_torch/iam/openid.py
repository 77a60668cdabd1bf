"""OpenID Connect provider for STS, the port of minio_tpu/iam/openid.py
(reference cmd/config/identity/openid/jwt.go): discover and fetch the
IdP's JWKS, verify RS256 (and HS256 shared-secret) ID tokens, and surface
the claims that drive temporary-credential minting.

RSA signature verification is done with Python integers (RSASSA-PKCS1-v1_5
with SHA-256 over the JWK's n and e): the verify side needs only modular
exponentiation, and the port imports no crypto wheel."""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
import time
import urllib.request

#: ASN.1 DigestInfo prefix for SHA-256 (RFC 8017 §9.2 notes).
_SHA256_PREFIX = bytes.fromhex(
    "3031300d060960864801650304020105000420")

#: JWKS cache TTL — keys rotate rarely; a bad-kid lookup forces a refresh.
JWKS_TTL_S = 300.0
#: Minimum spacing between unknown-kid forced refreshes (amplification
#: bound: the STS endpoint is unauthenticated).
FORCED_REFRESH_COOLDOWN_S = 10.0


def _b64url_decode(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def _rsa_pkcs1_sha256_verify(n: int, e: int, message: bytes,
                             sig: bytes) -> bool:
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    m = pow(int.from_bytes(sig, "big"), e, n)
    em = m.to_bytes(k, "big")
    digest = hashlib.sha256(message).digest()
    want = b"\x00\x01" + b"\xff" * (k - 3 - len(_SHA256_PREFIX)
                                    - len(digest)) + b"\x00" \
        + _SHA256_PREFIX + digest
    return hmac.compare_digest(em, want)


class OpenIDProvider:
    """One configured IdP: JWKS-backed RS256 (jwks_url or discovery via
    config_url) and/or an HS256 shared secret (dev/test IdPs)."""

    def __init__(self, jwks_url: str = "", config_url: str = "",
                 client_id: str = "", claim_name: str = "policy",
                 hmac_secret: str = "", timeout_s: float = 5.0):
        self.jwks_url = jwks_url
        self.config_url = config_url
        self.client_id = client_id
        self.claim_name = claim_name
        self.hmac_secret = hmac_secret
        self.timeout = timeout_s
        self._keys: dict[str, tuple[int, int]] = {}  # kid -> (n, e)
        # monotonic TTL clocks (never persisted): an NTP step must not
        # re-fetch the JWKS early nor pin a stale one. Seeded one full
        # window in the past so the first check is always "stale" even
        # on a freshly-booted machine where monotonic() is small.
        self._fetched_at = -JWKS_TTL_S
        self._disc_doc: dict | None = None
        self._disc_at = -JWKS_TTL_S
        self._forced_at = -FORCED_REFRESH_COOLDOWN_S
        self._lock = threading.Lock()
        #: guards JWKS refresh single-flight; shares self._lock so every
        #: state read below stays under the one lock
        self._cv = threading.Condition(self._lock)
        self._fetching = False

    def configured(self) -> bool:
        return bool(self.jwks_url or self.config_url or self.hmac_secret)

    def discovery_doc(self) -> dict:
        """The IdP's OpenID configuration document (console SSO needs the
        authorization endpoint before any credential exists); {} when
        only a JWKS URL / shared secret is configured. Cached for the
        JWKS TTL — this feeds an UNAUTHENTICATED console endpoint, which
        must not become an IdP-hammering amplifier."""
        if not self.config_url:
            return {}
        with self._lock:
            if time.monotonic() - self._disc_at < JWKS_TTL_S:
                # fresh success OR recent attempt (negative cache): a
                # down IdP must not be re-fetched per anonymous request
                return self._disc_doc or {}
            self._disc_at = time.monotonic()  # claim the fetch slot
        try:
            with urllib.request.urlopen(self.config_url,
                                        timeout=self.timeout) as r:
                doc = json.loads(r.read())
        except Exception:  # noqa: BLE001 — IdP down: serve stale/empty
            with self._lock:
                return self._disc_doc or {}
        with self._lock:
            self._disc_doc = doc
        return doc

    # --- JWKS -------------------------------------------------------------

    def _discover_jwks_url(self) -> str:
        if self.jwks_url:
            return self.jwks_url
        with urllib.request.urlopen(self.config_url,
                                    timeout=self.timeout) as r:
            doc = json.loads(r.read())
        self.jwks_url = doc["jwks_uri"]
        return self.jwks_url

    def _keys_fresh(self) -> bool:
        return bool(self._keys) and \
            time.monotonic() - self._fetched_at < JWKS_TTL_S

    def _refresh_keys(self, force: bool = False) -> None:
        """Fetch/refresh the JWKS. The IdP round-trip happens OUTSIDE
        the provider lock (graftlint GL002 finding: the fetch used to
        run under ``self._lock``, so one slow IdP round-trip queued
        every concurrent token validation behind the network); a
        single-flight flag keeps it to one fetch per TTL window while
        waiters block on the condition, not on a held lock."""
        if not force and self._keys_fresh():
            return
        with self._cv:
            # budget covers the fetcher's worst case: discovery
            # round-trip + JWKS round-trip, each bounded by self.timeout
            deadline = time.monotonic() + 2.0 * self.timeout + 1.0
            while self._fetching:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(timeout=remaining):
                    break  # fetcher wedged past its own timeout
            if not force and self._keys_fresh():
                return
            if self._fetching:
                # timed out waiting on a wedged fetcher: serve cached
                # keys if any rather than piling on the IdP
                if self._keys:
                    return
                raise ValueError("openid: JWKS fetch already in flight")
            self._fetching = True
        ok = False
        err: Exception | None = None
        keys: dict[str, tuple[int, int]] = {}
        try:
            url = self._discover_jwks_url()
            with urllib.request.urlopen(url, timeout=self.timeout) as r:
                doc = json.loads(r.read())
            for jwk in doc.get("keys", []):
                if jwk.get("kty") != "RSA":
                    continue
                kid = jwk.get("kid", "")
                n = int.from_bytes(_b64url_decode(jwk["n"]), "big")
                e = int.from_bytes(_b64url_decode(jwk["e"]), "big")
                keys[kid] = (n, e)
            ok = True
        except Exception as e:  # noqa: BLE001 — handled below
            err = e
        finally:
            # ALWAYS unwedge the single-flight flag — a malformed JWKS
            # document (or even a BaseException) must fail only this
            # call, never leave every future waiter stuck behind
            # _fetching=True. Failure also stamps _fetched_at: back off
            # further fetches for one TTL window instead of hammering a
            # down IdP.
            with self._cv:
                self._fetching = False
                self._fetched_at = time.monotonic()
                if ok:
                    self._keys = keys
                self._cv.notify_all()
        if not ok:
            # IdP briefly unreachable: keep serving with the cached
            # keys rather than failing every STS request.
            if self._keys:
                return
            raise ValueError(f"openid: JWKS fetch failed: {err}") \
                from None

    def _key_for(self, kid: str) -> tuple[int, int] | None:
        self._refresh_keys()
        key = self._keys.get(kid)
        if key is None and kid and \
                time.monotonic() - self._forced_at > \
                FORCED_REFRESH_COOLDOWN_S:
            # unknown kid: the IdP may have rotated — one forced refresh,
            # rate-limited (unauthenticated STS callers must not be able
            # to drive a fetch to the IdP per request)
            self._forced_at = time.monotonic()
            self._refresh_keys(force=True)
            key = self._keys.get(kid)
        if key is None and len(self._keys) == 1 and not kid:
            key = next(iter(self._keys.values()))
        return key

    # --- verification -----------------------------------------------------

    def verify(self, token: str) -> dict:
        """Validate signature + exp (+aud when client_id configured);
        returns the claims. Raises ValueError on any failure."""
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
            header = json.loads(_b64url_decode(header_b64))
            payload = json.loads(_b64url_decode(payload_b64))
            sig = _b64url_decode(sig_b64)
        except (ValueError, KeyError, json.JSONDecodeError):
            raise ValueError("malformed JWT") from None
        alg = header.get("alg")
        signed = f"{header_b64}.{payload_b64}".encode()
        if alg == "RS256":
            if not (self.jwks_url or self.config_url):
                raise ValueError("no JWKS configured for RS256 token")
            key = self._key_for(header.get("kid", ""))
            if key is None:
                raise ValueError(f"unknown signing key "
                                 f"{header.get('kid')!r}")
            if not _rsa_pkcs1_sha256_verify(key[0], key[1], signed, sig):
                raise ValueError("JWT signature mismatch")
        elif alg == "HS256":
            if not self.hmac_secret:
                raise ValueError("no HS256 secret configured")
            want = hmac.new(self.hmac_secret.encode(), signed,
                            hashlib.sha256).digest()
            if not hmac.compare_digest(want, sig):
                raise ValueError("JWT signature mismatch")
        else:
            raise ValueError(f"unsupported JWT alg {alg!r}")
        exp = payload.get("exp")
        if not isinstance(exp, (int, float)):
            # a token without a numeric expiry could be replayed forever
            # against the unauthenticated STS endpoint
            raise ValueError("JWT has no numeric exp claim")
        if exp < time.time():
            raise ValueError("JWT expired")
        if self.client_id:
            aud = payload.get("aud", "")
            auds = aud if isinstance(aud, list) else [aud]
            azp = payload.get("azp", "")
            if self.client_id not in auds and azp != self.client_id:
                raise ValueError("token audience mismatch")
        return payload


def provider_from_config(cfg) -> OpenIDProvider:
    """Build the provider from the identity_openid config subsystem
    (env > stored > default, like every subsystem)."""
    import os
    return OpenIDProvider(
        jwks_url=cfg.get("identity_openid", "jwks_url"),
        config_url=cfg.get("identity_openid", "config_url"),
        client_id=cfg.get("identity_openid", "client_id"),
        claim_name=cfg.get("identity_openid", "claim_name") or "policy",
        hmac_secret=os.environ.get("MINIO_TPU_OPENID_HMAC_SECRET", ""))
