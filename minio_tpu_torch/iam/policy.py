"""AWS-style IAM policy documents and their evaluation, the port of
minio_tpu/iam/policy.py (reference pkg/iam/policy: Statement, ActionSet,
ResourceSet, condition evaluation; pkg/policy for anonymous bucket
policies): Allow and Deny effects, action and resource wildcards,
principal matching for bucket policies, and the common condition
operators (string, IP range, bool, numeric). Standard library only; the
decisions are the JAX package's for every input."""
from __future__ import annotations

import fnmatch
import ipaddress
import json
from dataclasses import dataclass, field


def _as_list(v) -> list[str]:
    if v is None:
        return []
    return [v] if isinstance(v, str) else list(v)


def match_wild(pattern: str, value: str) -> bool:
    """AWS wildcard match: * and ? (no [] classes — escape them)."""
    # fnmatch treats [] as classes; AWS does not. Neutralize them.
    pattern = pattern.replace("[", "[[]")
    return fnmatch.fnmatchcase(value, pattern)


@dataclass
class Statement:
    effect: str = "Allow"
    actions: list[str] = field(default_factory=list)
    not_actions: list[str] = field(default_factory=list)
    resources: list[str] = field(default_factory=list)
    principals: list[str] = field(default_factory=list)  # bucket policies
    conditions: dict = field(default_factory=dict)
    sid: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "Statement":
        principal = d.get("Principal", {})
        if principal == "*":
            principals = ["*"]
        elif isinstance(principal, dict):
            principals = _as_list(principal.get("AWS", []))
        else:
            principals = _as_list(principal)
        return cls(
            effect=d.get("Effect", "Allow"),
            actions=_as_list(d.get("Action")),
            not_actions=_as_list(d.get("NotAction")),
            resources=_as_list(d.get("Resource")),
            principals=principals,
            conditions=d.get("Condition", {}) or {},
            sid=d.get("Sid", ""))

    def matches_action(self, action: str) -> bool:
        if self.not_actions:
            return not any(match_wild(a, action) for a in self.not_actions)
        return any(match_wild(a, action) for a in self.actions)

    def matches_resource(self, resource: str) -> bool:
        if not self.resources:
            return True
        arn = f"arn:aws:s3:::{resource}"
        return any(match_wild(r, arn) or match_wild(r, resource)
                   for r in self.resources)

    def matches_principal(self, principal: str) -> bool:
        if not self.principals:
            return True
        return any(p == "*" or match_wild(p, principal)
                   or p.endswith(f":{principal}")
                   for p in self.principals)

    def matches_conditions(self, ctx: dict) -> bool:
        for op, kv in self.conditions.items():
            for key, want in kv.items():
                have = ctx.get(key.lower())
                wants = _as_list(want)
                if not _eval_condition(op, have, wants):
                    return False
        return True


def _eval_condition(op: str, have, wants: list[str]) -> bool:
    if op == "StringEquals":
        return have is not None and str(have) in wants
    if op == "StringNotEquals":
        return have is None or str(have) not in wants
    if op == "StringLike":
        return have is not None and any(
            match_wild(w, str(have)) for w in wants)
    if op == "StringNotLike":
        return have is None or not any(
            match_wild(w, str(have)) for w in wants)
    if op == "IpAddress":
        return have is not None and _ip_in(str(have), wants)
    if op == "NotIpAddress":
        return have is None or not _ip_in(str(have), wants)
    if op == "Bool":
        return have is not None and \
            str(have).lower() == wants[0].lower()
    if op == "NumericLessThan":
        try:
            return have is not None and float(have) < float(wants[0])
        except ValueError:
            return False
    if op == "NumericGreaterThan":
        try:
            return have is not None and float(have) > float(wants[0])
        except ValueError:
            return False
    return False  # unknown operators fail closed


def _ip_in(addr: str, nets: list[str]) -> bool:
    try:
        a = ipaddress.ip_address(addr)
        return any(a in ipaddress.ip_network(n, strict=False) for n in nets)
    except ValueError:
        return False


@dataclass
class Policy:
    version: str = "2012-10-17"
    statements: list[Statement] = field(default_factory=list)
    name: str = ""

    @classmethod
    def parse(cls, blob: bytes | str, name: str = "") -> "Policy":
        d = json.loads(blob)
        stmts = d.get("Statement", [])
        if isinstance(stmts, dict):
            stmts = [stmts]
        return cls(version=d.get("Version", "2012-10-17"),
                   statements=[Statement.from_dict(s) for s in stmts],
                   name=name)

    def dump(self) -> bytes:
        return json.dumps({
            "Version": self.version,
            "Statement": [{
                "Sid": s.sid, "Effect": s.effect,
                **({"NotAction": s.not_actions} if s.not_actions
                   else {"Action": s.actions}),
                "Resource": s.resources,
                **({"Principal": {"AWS": s.principals}}
                   if s.principals else {}),
                **({"Condition": s.conditions} if s.conditions else {}),
            } for s in self.statements],
        }).encode()

    def is_allowed(self, action: str, resource: str, ctx: dict | None = None,
                   principal: str = "") -> bool:
        return policy_allows([self], action, resource, ctx, principal)


def policy_allows(policies: list[Policy], action: str, resource: str,
                  ctx: dict | None = None, principal: str = "") -> bool:
    """AWS evaluation order: explicit Deny wins, then any Allow, default
    deny."""
    ctx = ctx or {}
    allowed = False
    for pol in policies:
        for s in pol.statements:
            if not s.matches_action(action):
                continue
            if not s.matches_resource(resource):
                continue
            if principal and not s.matches_principal(principal):
                continue
            if not s.matches_conditions(ctx):
                continue
            if s.effect == "Deny":
                return False
            allowed = True
    return allowed


# --- canned policies (reference pkg/iam/policy: ReadOnly/WriteOnly/
# ReadWrite/ConsoleAdmin + diagnostics) ---------------------------------------

READONLY = Policy(name="readonly", statements=[Statement(
    effect="Allow",
    actions=["s3:GetBucketLocation", "s3:GetObject", "s3:ListBucket",
             "s3:ListAllMyBuckets", "s3:GetObjectTagging",
             "s3:GetBucketVersioning", "s3:ListBucketVersions"],
    resources=["arn:aws:s3:::*"])])

WRITEONLY = Policy(name="writeonly", statements=[Statement(
    effect="Allow",
    actions=["s3:PutObject", "s3:ListAllMyBuckets",
             "s3:AbortMultipartUpload", "s3:ListMultipartUploadParts",
             "s3:ListBucketMultipartUploads"],
    resources=["arn:aws:s3:::*"])])

READWRITE = Policy(name="readwrite", statements=[Statement(
    effect="Allow", actions=["s3:*"], resources=["arn:aws:s3:::*"])])

CONSOLE_ADMIN = Policy(name="consoleAdmin", statements=[Statement(
    effect="Allow", actions=["s3:*", "admin:*"],
    resources=["arn:aws:s3:::*"])])

CANNED = {p.name: p for p in [READONLY, WRITEONLY, READWRITE, CONSOLE_ADMIN]}
