"""IAMSys, the port of minio_tpu/iam/sys.py (reference cmd/iam.go:2187 +
cmd/iam-object-store.go): users, groups, service accounts, policy
documents and user-to-policy mappings, kept in one document,
``.minio.sys/config/iam/state.json``, written through the object layer's
``put_config`` on every mutation and cached in-process. STS temporary
credentials live in the same table with an expiry. The document is the
JAX package's byte for byte for the same mutations, so each package loads
the other's.

In a distributed deployment the node sets two hooks: ``on_change`` tells
the peers to reload after every persisted mutation, and ``dist_lock``
makes each read-modify-write of the shared document hold a cluster lock
(and reload under it), so concurrent admin calls on two nodes cannot
clobber each other. Alone, a mutation is a read-modify-write under the
instance lock."""
from __future__ import annotations

import base64
import json
import secrets
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from ..utils import errors
from . import policy as pol

IAM_PREFIX = "iam"


@dataclass
class UserIdentity:
    access_key: str
    secret_key: str
    status: str = "enabled"           # enabled | disabled
    policies: list[str] = field(default_factory=list)
    groups: list[str] = field(default_factory=list)
    parent: str = ""                  # service accounts / STS: owning user
    expiration: float = 0.0           # STS creds: unix expiry (0 = never)
    session_policy: bytes = b""       # STS/service-account inline policy

    @property
    def enabled(self) -> bool:
        return self.status == "enabled" and (
            self.expiration == 0.0 or self.expiration > time.time())

    def to_dict(self):
        return {"ak": self.access_key, "sk": self.secret_key,
                "status": self.status, "policies": self.policies,
                "groups": self.groups, "parent": self.parent,
                "exp": self.expiration,
                "spolicy": base64.b64encode(self.session_policy).decode()}

    @classmethod
    def from_dict(cls, d):
        return cls(access_key=d["ak"], secret_key=d["sk"],
                   status=d.get("status", "enabled"),
                   policies=list(d.get("policies", [])),
                   groups=list(d.get("groups", [])),
                   parent=d.get("parent", ""),
                   expiration=d.get("exp", 0.0),
                   session_policy=base64.b64decode(d.get("spolicy", "")))


class IAMSys:
    def __init__(self, objlayer, root_access_key: str, root_secret_key: str):
        self.obj = objlayer
        self.root_ak = root_access_key
        self.root_sk = root_secret_key
        self._lock = threading.Lock()
        self.users: dict[str, UserIdentity] = {}
        self.groups: dict[str, dict] = {}   # name -> {members, policies}
        self.policies: dict[str, pol.Policy] = dict(pol.CANNED)
        #: cross-node sync hook (reference peer-rest-common.go:33-44
        #: LoadUser/LoadPolicy/...): called after every persisted mutation
        #: so peers reload — set by dist.node.Node
        self.on_change = None
        #: cluster mutation lock factory (() -> DRWMutex-like with
        #: get_lock/unlock) — set by dist.node.Node
        self.dist_lock = None
        self.load()

    # --- persistence --------------------------------------------------------

    def _save(self):
        doc = {
            "users": {k: u.to_dict() for k, u in self.users.items()},
            "groups": self.groups,
            "policies": {name: p.dump().decode()
                         for name, p in self.policies.items()
                         if name not in pol.CANNED},
        }
        self.obj.put_config(f"{IAM_PREFIX}/state.json",
                            json.dumps(doc).encode())
        if self.on_change is not None:
            # async: a slow/dead peer must not stall the admin API call
            threading.Thread(target=self.on_change, daemon=True,
                             name="iam-sync").start()

    def load(self):
        with self._lock:
            self._load_locked()

    def _load_locked(self):
        try:
            doc = json.loads(self.obj.get_config(f"{IAM_PREFIX}/state.json"))
        except (errors.StorageError, ValueError, NotImplementedError):
            return
        self.users = {k: UserIdentity.from_dict(u)
                      for k, u in doc.get("users", {}).items()}
        self.groups = doc.get("groups", {})
        self.policies = dict(pol.CANNED)
        for name, blob in doc.get("policies", {}).items():
            try:
                self.policies[name] = pol.Policy.parse(blob, name)
            except ValueError:
                continue

    @contextmanager
    def _mutating(self):
        """Serialize a read-modify-write of the IAM document: the cluster
        lock (when distributed) and a reload from the store, then the
        change and its persistence under the instance lock."""
        mtx = self.dist_lock() if self.dist_lock is not None else None
        if mtx is not None and not mtx.get_lock(timeout=10.0):
            raise errors.LockTimeout("iam state lock")
        try:
            with self._lock:
                if mtx is not None:
                    self._load_locked()  # refresh under the cluster lock
                yield
                self._save()
        finally:
            if mtx is not None:
                mtx.unlock()

    # --- credential lookup (the auth layer's hook) --------------------------

    def lookup_secret(self, access_key: str) -> str | None:
        if access_key == self.root_ak:
            return self.root_sk
        u = self.users.get(access_key)
        if u is not None and u.enabled:
            return u.secret_key
        return None

    # --- users --------------------------------------------------------------

    def add_user(self, access_key: str, secret_key: str,
                 policies: list[str] | None = None):
        if access_key == self.root_ak:
            raise ValueError("cannot override root credentials")
        if len(access_key) < 3:
            raise ValueError("access key must be at least 3 characters")
        if len(secret_key) < 8:
            raise ValueError("secret key must be at least 8 characters")
        with self._mutating():
            self.users[access_key] = UserIdentity(
                access_key=access_key, secret_key=secret_key,
                policies=policies or [])

    def remove_user(self, access_key: str):
        with self._mutating():
            self.users.pop(access_key, None)
            # cascade: drop service accounts / STS creds owned by the user
            for k in [k for k, u in self.users.items()
                      if u.parent == access_key]:
                del self.users[k]

    def set_user_status(self, access_key: str, status: str):
        with self._mutating():
            u = self.users[access_key]
            u.status = status

    def set_user_policy(self, access_key: str, policy_names: list[str]):
        with self._mutating():
            self.users[access_key].policies = policy_names

    # --- groups -------------------------------------------------------------

    def add_group(self, name: str, members: list[str]):
        with self._mutating():
            g = self.groups.setdefault(name,
                                       {"members": [], "policies": []})
            g["members"] = sorted(set(g["members"]) | set(members))
            for m in members:
                if m in self.users and name not in self.users[m].groups:
                    self.users[m].groups.append(name)

    def set_group_policy(self, name: str, policy_names: list[str]):
        with self._mutating():
            self.groups.setdefault(name, {"members": []})[
                "policies"] = policy_names

    def remove_group(self, name: str):
        with self._mutating():
            self.groups.pop(name, None)
            for u in self.users.values():
                if name in u.groups:
                    u.groups.remove(name)

    # --- policies -----------------------------------------------------------

    def set_policy(self, name: str, doc: bytes):
        p = pol.Policy.parse(doc, name)
        with self._mutating():
            self.policies[name] = p

    def delete_policy(self, name: str):
        if name in pol.CANNED:
            raise ValueError(f"cannot delete canned policy {name}")
        with self._mutating():
            self.policies.pop(name, None)

    # --- service accounts / STS ---------------------------------------------

    def new_service_account(self, parent: str,
                            session_policy: bytes = b"") -> UserIdentity:
        ak = "SA" + secrets.token_hex(8).upper()
        sk = secrets.token_urlsafe(30)
        u = UserIdentity(access_key=ak, secret_key=sk, parent=parent,
                         session_policy=session_policy)
        with self._mutating():
            self.users[ak] = u
        return u

    def assume_role(self, access_key: str, duration_s: int = 3600,
                    session_policy: bytes = b"") -> UserIdentity:
        """STS AssumeRole (reference cmd/sts-handlers.go:43): temporary
        credentials inheriting the caller's policies, optionally narrowed
        by an inline session policy."""
        duration_s = max(900, min(duration_s, 7 * 24 * 3600))
        ak = "STS" + secrets.token_hex(8).upper()
        sk = secrets.token_urlsafe(30)
        u = UserIdentity(access_key=ak, secret_key=sk, parent=access_key,
                         expiration=time.time() + duration_s,
                         session_policy=session_policy)
        with self._mutating():
            self._purge_expired_locked()
            self.users[ak] = u
        return u

    def _openid_provider(self):
        """The configured OpenID provider (JWKS/RS256 + HS256 secret),
        cached per config tuple so the JWKS cache survives across STS
        calls but a config change rebuilds it."""
        import os

        from ..config import get_config_sys
        from .openid import provider_from_config
        cfg = get_config_sys(None)
        key = (cfg.get("identity_openid", "jwks_url"),
               cfg.get("identity_openid", "config_url"),
               cfg.get("identity_openid", "client_id"),
               cfg.get("identity_openid", "claim_name"),
               os.environ.get("MINIO_TPU_OPENID_HMAC_SECRET", ""))
        cached = getattr(self, "_openid_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        prov = provider_from_config(cfg)
        self._openid_cache = (key, prov)
        return prov

    def _mint_openid_identity(self, token: str, duration_s: int,
                              session_policy: bytes, prefix: str,
                              parent_kind: str) -> UserIdentity:
        """Shared WebIdentity/ClientGrants flow (reference
        cmd/sts-handlers.go:43-93: both validate an IdP token and mint
        temporary credentials; they differ only in the request shape)."""
        prov = self._openid_provider()
        if not prov.configured():
            raise ValueError("no OpenID provider configured")
        claims = prov.verify(token)
        sub = claims.get("sub", "")
        if not sub:
            raise ValueError("token has no sub claim")
        duration_s = max(900, min(duration_s, 7 * 24 * 3600))
        expiry = time.time() + duration_s
        if isinstance(claims.get("exp"), (int, float)):
            expiry = min(expiry, float(claims["exp"]))
        policies = [p for p in
                    str(claims.get(prov.claim_name, "")).split(",") if p]
        ak = prefix + secrets.token_hex(8).upper()
        sk = secrets.token_urlsafe(30)
        u = UserIdentity(access_key=ak, secret_key=sk,
                         parent=f"{parent_kind}:{sub}",
                         policies=policies,
                         expiration=expiry,
                         session_policy=session_policy)
        with self._mutating():
            self._purge_expired_locked()
            self.users[ak] = u
        return u

    def assume_role_with_web_identity(self, token: str,
                                      duration_s: int = 3600,
                                      session_policy: bytes = b""
                                      ) -> UserIdentity:
        """STS AssumeRoleWithWebIdentity: validate the IdP's JWT (RS256
        against the configured JWKS, or HS256 with the shared secret) and
        mint temporary credentials for its subject. The provider's
        claim_name (default ``policy``) carries comma-separated policy
        names; ``exp`` bounds the credential lifetime."""
        return self._mint_openid_identity(token, duration_s,
                                          session_policy, "STSWI",
                                          "web-identity")

    def assume_role_with_client_grants(self, token: str,
                                       duration_s: int = 3600,
                                       session_policy: bytes = b""
                                       ) -> UserIdentity:
        """STS AssumeRoleWithClientGrants: the OAuth2 client-credentials
        sibling of WebIdentity — same token validation, same minting
        (reference cmd/sts-handlers.go ClientGrants)."""
        return self._mint_openid_identity(token, duration_s,
                                          session_policy, "STSCG",
                                          "client-grants")

    def assume_role_with_ldap_identity(self, username: str, password: str,
                                       duration_s: int = 3600,
                                       session_policy: bytes = b""
                                       ) -> UserIdentity:
        """STS AssumeRoleWithLDAPIdentity (reference
        cmd/sts-handlers.go + cmd/config/identity/ldap): validate the
        password with a simple bind against the configured server, then
        mint temporary credentials. Policies come from the
        identity_ldap.sts_policy config (the reference's group->policy
        mapping is richer; this maps all LDAP identities to one policy
        set, documented divergence)."""
        from ..config import get_config_sys
        from .ldap import LDAPError, simple_bind
        cfg = get_config_sys(None)
        server = cfg.get("identity_ldap", "server_addr")
        dn_format = cfg.get("identity_ldap", "user_dn_format")
        if not server or not dn_format:
            raise ValueError("no LDAP provider configured")
        if not username or "," in username or "=" in username:
            raise ValueError("invalid LDAP username")
        if not password:
            raise ValueError("empty LDAP password")
        try:
            simple_bind(server, dn_format.replace("%s", username),
                        password)
        except LDAPError as e:
            raise ValueError(f"LDAP bind failed: {e}") from e
        except OSError as e:
            raise ValueError(f"LDAP server unreachable: {e}") from e
        duration_s = max(900, min(duration_s, 7 * 24 * 3600))
        policies = [p for p in
                    cfg.get("identity_ldap", "sts_policy").split(",")
                    if p]
        ak = "STSLDAP" + secrets.token_hex(8).upper()
        sk = secrets.token_urlsafe(30)
        u = UserIdentity(access_key=ak, secret_key=sk,
                         parent=f"ldap:{username}",
                         policies=policies,
                         expiration=time.time() + duration_s,
                         session_policy=session_policy)
        with self._mutating():
            self._purge_expired_locked()
            self.users[ak] = u
        return u

    def _purge_expired_locked(self):
        """Drop dead temporary credentials so the table and persisted
        state stay bounded under continuous AssumeRole traffic."""
        now = time.time()
        for k in [k for k, u in self.users.items()
                  if u.expiration and u.expiration < now]:
            del self.users[k]

    # --- authorization ------------------------------------------------------

    def effective_policies(self, access_key: str) -> list[pol.Policy]:
        u = self.users.get(access_key)
        if u is None:
            return []
        names = list(u.policies)
        src = u
        if u.parent:  # service account / STS inherits the parent's policies
            parent = self.users.get(u.parent)
            if parent is not None:
                names += parent.policies
                src = parent
            elif u.parent == self.root_ak:
                names.append("consoleAdmin")
        for g in src.groups:
            names += self.groups.get(g, {}).get("policies", [])
        out = [self.policies[n] for n in dict.fromkeys(names)
               if n in self.policies]
        if u.session_policy:
            try:
                out.append(pol.Policy.parse(u.session_policy, "session"))
            except ValueError:
                pass
        return out

    def is_allowed(self, access_key: str, action: str, bucket: str,
                   object: str = "", ctx: dict | None = None) -> bool:
        if access_key == self.root_ak:
            return True
        u = self.users.get(access_key)
        if u is None or not u.enabled:
            return False
        resource = f"{bucket}/{object}" if object else bucket
        policies = self.effective_policies(access_key)
        if u.session_policy:
            # session policy must ALSO allow (intersection semantics)
            try:
                sp = pol.Policy.parse(u.session_policy)
            except ValueError:
                return False
            if not pol.policy_allows([sp], action, resource, ctx):
                return False
            policies = [p for p in policies if p.name != "session"]
        return pol.policy_allows(policies, action, resource, ctx)
