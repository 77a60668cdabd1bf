"""The port's IAM plane (minio_tpu_torch.iam, the IAM half of
server/s3api.py and the admin IAM ops) held to the JAX package's on the
CPU, with exact decisions and exact bytes:

* ``policy_allows`` over a grid of policies, actions, resources,
  condition contexts and principals drawn with numpy from a seed, starting
  from the cases of tests/test_iam.py, and the canned policies' documents;
* ``IAMSys`` mutations (users, groups, custom policies, service accounts,
  STS with session policies, expiry and its purge) giving the same
  ``state.json`` bytes after every step and the same ``is_allowed``
  decisions, each package loading and re-saving the other's document;
* one signed script on a JAX and a port server (users, groups, service
  accounts, STS AssumeRole with a narrowing session policy and its
  expiry, the anonymous bucket policy, the admin IAM ops), answering
  alike and leaving byte-identical trees, ``state.json`` included.

The credentials' random parts (``secrets``) and the clock (``time``) are
pinned per module; both packages' process-global bucket analytics and log
plane are reset around each test."""
import base64
import hashlib
import itertools
import json
import os
import sys
import types
import urllib.parse

import numpy as np
import pytest
import requests

sys.path.insert(0, os.path.dirname(__file__))
from minio_tpu.iam import policy as jpol  # noqa: E402
from minio_tpu.iam import sys as jiam  # noqa: E402
from minio_tpu.obs import bucketstats as jbs  # noqa: E402
from minio_tpu.obs import logger as jlog  # noqa: E402
from minio_tpu.utils import errors as jerrors  # noqa: E402
from minio_tpu_torch.iam import policy as ppol  # noqa: E402
from minio_tpu_torch.iam import sys as piam  # noqa: E402
from minio_tpu_torch.obs import bucketstats as pbs  # noqa: E402
from minio_tpu_torch.obs import logger as plog  # noqa: E402
from minio_tpu_torch.utils import errors as perrors  # noqa: E402
from s3client import S3Client  # noqa: E402
from test_torch_s3server import (AK, SK, assert_same, body,  # noqa: E402
                                 pinned, run_both)

SEED = 20261018
T0 = 1.75e9

POLS = {"jax": jpol, "port": ppol}
IAMS = {"jax": jiam, "port": piam}
ERRS = {"jax": jerrors, "port": perrors}

# --- pinned randomness and clock ---------------------------------------------


class FakeSecrets:
    """``secrets`` as the IAM modules see it: token_hex and token_urlsafe
    on a counter, the same sequence after each reset."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._n = itertools.count(1)

    def token_hex(self, n: int = 32) -> str:
        return hashlib.sha256(b"hex%d" % next(self._n)).digest()[:n].hex()

    def token_urlsafe(self, n: int = 32) -> str:
        raw = hashlib.sha512(b"url%d" % next(self._n)).digest()[:n]
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()


class FakeClock:
    """``time`` as the IAM modules see it: a clock that moves only when a
    test advances it."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.now = T0

    def time(self) -> float:
        return self.now


SECRETS = FakeSecrets()
CLOCK = FakeClock()


@pytest.fixture(autouse=True)
def fresh_planes():
    """Both packages' process-global bucket analytics and log plane start
    and end empty."""
    for mod in (jbs, pbs):
        mod.reset()
    jlog._sys = None
    plog.reset()
    yield
    for mod in (jbs, pbs):
        mod.reset()
    jlog._sys = None
    plog.reset()


@pytest.fixture
def iam_pinned(monkeypatch):
    """Pin ``secrets`` and ``time`` in both IAM modules."""
    for mod in IAMS.values():
        monkeypatch.setattr(mod, "secrets", SECRETS)
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(time=CLOCK.time))
    SECRETS.reset()
    CLOCK.reset()

    def reset():
        SECRETS.reset()
        CLOCK.reset()

    return reset


# --- policy evaluation -------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_policy_cases_of_the_jax_suite(pkg):
    """tests/test_iam.py's evaluation cases, on either package."""
    pol = POLS[pkg]
    p = pol.Policy.parse(json.dumps({
        "Version": "2012-10-17",
        "Statement": [
            {"Effect": "Allow", "Action": ["s3:GetObject", "s3:List*"],
             "Resource": ["arn:aws:s3:::docs/*", "arn:aws:s3:::docs"]},
            {"Effect": "Deny", "Action": "s3:GetObject",
             "Resource": "arn:aws:s3:::docs/secret/*"},
        ]}))
    assert p.is_allowed("s3:GetObject", "docs/readme.txt")
    assert p.is_allowed("s3:ListBucket", "docs")
    assert not p.is_allowed("s3:PutObject", "docs/readme.txt")
    assert not p.is_allowed("s3:GetObject", "docs/secret/key.pem")
    assert not p.is_allowed("s3:GetObject", "other/file")
    assert pol.match_wild("s3:Get*", "s3:GetObject")
    assert pol.match_wild("arn:aws:s3:::b/*", "arn:aws:s3:::b/x/y")
    assert not pol.match_wild("s3:Get?bject", "s3:GetXObject")
    c = pol.Policy.parse(json.dumps({"Statement": [{
        "Effect": "Allow", "Action": "s3:GetObject",
        "Resource": "arn:aws:s3:::b/*",
        "Condition": {"IpAddress": {"aws:SourceIp": "10.0.0.0/8"}}}]}))
    assert c.is_allowed("s3:GetObject", "b/o", {"aws:sourceip": "10.1.2.3"})
    assert not c.is_allowed("s3:GetObject", "b/o",
                            {"aws:sourceip": "192.168.1.1"})


ACTIONS = ("s3:GetObject", "s3:PutObject", "s3:ListBucket",
           "s3:DeleteObject", "s3:GetBucketPolicy", "s3:ListAllMyBuckets",
           "admin:ServerInfo")
ACTION_PATTERNS = ACTIONS + ("s3:*", "s3:Get*", "s3:List*", "s3:Put?bject",
                             "*", "admin:*", "s3:[G]et*")
RESOURCES = ("docs", "docs/readme.txt", "docs/secret/key.pem", "other/file",
             "b", "b/x/y", "team/shared/doc", "a[1]/x")
RESOURCE_PATTERNS = ("arn:aws:s3:::*", "arn:aws:s3:::docs/*",
                     "arn:aws:s3:::docs", "arn:aws:s3:::docs/secret/*",
                     "docs/*", "arn:aws:s3:::b/*", "arn:aws:s3:::team/*/doc",
                     "arn:aws:s3:::a[1]/*", "*", "arn:aws:s3:::?ocs")
CONDITIONS = (
    {"IpAddress": {"aws:SourceIp": "10.0.0.0/8"}},
    {"NotIpAddress": {"aws:SourceIp": ["192.168.0.0/16", "fd00::/8"]}},
    {"StringEquals": {"s3:prefix": ["a", "b"]}},
    {"StringNotEquals": {"s3:prefix": "c"}},
    {"StringLike": {"aws:UserAgent": "curl/*"}},
    {"StringNotLike": {"aws:UserAgent": ["*bot*", "wget?"]}},
    {"Bool": {"aws:SecureTransport": "true"}},
    {"NumericLessThan": {"s3:max-keys": "100"}},
    {"NumericGreaterThan": {"s3:max-keys": "abc"}},
    {"Frobnicate": {"x": "y"}},
    {"IpAddress": {"aws:SourceIp": "10.0.0.0/8"},
     "StringEquals": {"s3:prefix": "a"}},
)
CONTEXTS = (
    {}, {"aws:sourceip": "10.1.2.3"}, {"aws:sourceip": "192.168.1.1"},
    {"aws:sourceip": "not-an-ip"}, {"aws:sourceip": "fd00::1"},
    {"s3:prefix": "a", "aws:useragent": "curl/8.1",
     "aws:securetransport": "True", "s3:max-keys": "50"},
    {"s3:prefix": "c", "aws:useragent": "a-bot-ua",
     "aws:securetransport": "false", "s3:max-keys": "500"},
    {"aws:useragent": "wget1", "s3:max-keys": "x"},
)
PRINCIPALS = (None, "*", ["arn:aws:iam::*:alice"], ["alice", "bob*"],
              {"AWS": "carol"})
CALLERS = ("", "alice", "bob2", "carol")


def _pick(gen, seq, k=None):
    if k is None:
        return seq[int(gen.integers(0, len(seq)))]
    idx = gen.choice(len(seq), size=k, replace=False)
    return [seq[int(i)] for i in idx]


def _statement(gen) -> dict:
    st: dict = {"Effect": _pick(gen, ("Allow", "Allow", "Deny"))}
    acts = _pick(gen, ACTION_PATTERNS, int(gen.integers(1, 4)))
    key = "NotAction" if gen.integers(0, 6) == 0 else "Action"
    st[key] = acts[0] if len(acts) == 1 and gen.integers(0, 2) else acts
    if gen.integers(0, 8):
        res = _pick(gen, RESOURCE_PATTERNS, int(gen.integers(1, 3)))
        st["Resource"] = res[0] if len(res) == 1 else res
    if gen.integers(0, 3) == 0:
        st["Condition"] = _pick(gen, CONDITIONS)
    principal = _pick(gen, PRINCIPALS)
    if principal is not None:
        st["Principal"] = principal
    if gen.integers(0, 2):
        st["Sid"] = f"s{int(gen.integers(0, 100))}"
    return st


def test_policy_decisions_match_jax_on_a_seeded_grid():
    """300 policies of 1-3 statements drawn from a seed, 80 queries each
    (action, resource, condition context, principal): every decision is
    the JAX package's, and so is every policy's ``dump()``."""
    gen = np.random.default_rng(SEED)
    n_allow = n_deny = 0
    for _ in range(300):
        stmts = [_statement(gen) for _ in range(int(gen.integers(1, 4)))]
        doc = json.dumps({"Version": "2012-10-17",
                          "Statement": stmts if len(stmts) > 1 or
                          gen.integers(0, 2) else stmts[0]})
        jp, pp = jpol.Policy.parse(doc), ppol.Policy.parse(doc)
        assert pp.dump() == jp.dump()
        jp2 = jpol.Policy.parse(jp.dump())
        pp2 = ppol.Policy.parse(pp.dump())
        for _ in range(80):
            q = (_pick(gen, ACTIONS), _pick(gen, RESOURCES),
                 _pick(gen, CONTEXTS), _pick(gen, CALLERS))
            want = jpol.policy_allows([jp], q[0], q[1], q[2], q[3])
            assert ppol.policy_allows([pp], q[0], q[1], q[2], q[3]) == \
                want, (doc, q)
            assert ppol.policy_allows([pp2], *q) == \
                jpol.policy_allows([jp2], *q), (doc, q)
            n_allow += want
            n_deny += not want
    # the grid reaches both outcomes
    assert n_allow > 1000 and n_deny > 1000


def test_canned_policies_match_jax():
    assert list(ppol.CANNED) == list(jpol.CANNED)
    for name, p in jpol.CANNED.items():
        assert ppol.CANNED[name].dump() == p.dump()


# --- IAMSys state ------------------------------------------------------------


class Store:
    """The config plane of an object layer, in memory: a missing path
    raises the package's FileNotFound, as the object layer does."""

    def __init__(self, pkg: str, docs: dict | None = None):
        self.errors = ERRS[pkg]
        self.docs = dict(docs or {})

    def put_config(self, path: str, data: bytes) -> None:
        self.docs[path] = bytes(data)

    def get_config(self, path: str) -> bytes:
        try:
            return self.docs[path]
        except KeyError:
            raise self.errors.FileNotFound(path) from None


STATE = "iam/state.json"
TEAM_READ = json.dumps({"Statement": [{
    "Effect": "Allow", "Action": ["s3:GetObject", "s3:GetBucketLocation"],
    "Resource": "arn:aws:s3:::teambucket/shared/*"}]}).encode()
DENY_SECRET = json.dumps({"Statement": [
    {"Effect": "Allow", "Action": "s3:*", "Resource": "arn:aws:s3:::*"},
    {"Effect": "Deny", "Action": "s3:GetObject",
     "Resource": "arn:aws:s3:::*/secret/*",
     "Condition": {"NotIpAddress": {"aws:SourceIp": "10.0.0.0/8"}}}]}
).encode()
SESSION = json.dumps({"Statement": [{
    "Effect": "Allow", "Action": ["s3:GetObject", "s3:PutObject"],
    "Resource": "arn:aws:s3:::teambucket/sts/*"}]}).encode()


def _mutations(iam):
    """The same mutations on one IAMSys: (label, callable) pairs."""
    out = {}

    def sa():
        out["sa"] = iam.new_service_account("alice", SESSION).access_key

    def sa_root():
        out["sa_root"] = iam.new_service_account(AK).access_key

    def sts():
        out["sts"] = iam.assume_role("carol", 900, SESSION).access_key

    def sts_long():
        out["sts_long"] = iam.assume_role("bob", 10**9).access_key

    def advance():
        CLOCK.now += 1000  # past the 900 s credential, within the long one

    return out, [
        ("add alice", lambda: iam.add_user("alice", "alice-secret",
                                           ["readonly"])),
        ("add bob", lambda: iam.add_user("bob", "bob-secret-1", [])),
        ("add carol", lambda: iam.add_user("carol", "carol-secret",
                                           ["writeonly", "readwrite"])),
        ("policy team-read", lambda: iam.set_policy("team-read", TEAM_READ)),
        ("policy deny-secret",
         lambda: iam.set_policy("deny-secret", DENY_SECRET)),
        ("group team", lambda: iam.add_group("team",
                                             ["bob", "alice", "ghost"])),
        ("group team again", lambda: iam.add_group("team", ["carol"])),
        ("group policy", lambda: iam.set_group_policy("team",
                                                      ["team-read"])),
        ("new group by policy",
         lambda: iam.set_group_policy("ops", ["readonly"])),
        ("bob policy", lambda: iam.set_user_policy(
            "bob", ["deny-secret", "team-read"])),
        ("service account", sa),
        ("root service account", sa_root),
        ("sts", sts),
        ("sts clamped", sts_long),
        ("disable carol", lambda: iam.set_user_status("carol", "disabled")),
        ("root override", lambda: iam.add_user(AK, "whatever-secret")),
        ("short key", lambda: iam.add_user("ab", "long-enough-secret")),
        ("short secret", lambda: iam.add_user("dave", "short")),
        ("clock", advance),
        ("sts purges expired", lambda: iam.assume_role("alice")),
        ("enable carol", lambda: iam.set_user_status("carol", "enabled")),
        ("remove group", lambda: iam.remove_group("team")),
        ("delete custom", lambda: iam.delete_policy("deny-secret")),
        ("delete canned", lambda: iam.delete_policy("readonly")),
        ("remove alice", lambda: iam.remove_user("alice")),
        ("status of a ghost", lambda: iam.set_user_status("ghost", "on")),
    ]


def _decisions(iam, keys) -> list:
    """is_allowed over every key x action x (bucket, object) of a grid,
    with a context or without."""
    out = []
    for ak in keys:
        for action in ACTIONS:
            for bucket, obj in (("teambucket", "shared/doc"),
                                ("teambucket", "sts/x"), ("teambucket", ""),
                                ("other", "secret/k"), ("", "")):
                for ctx in (None, {"aws:sourceip": "10.1.1.1"}):
                    out.append(iam.is_allowed(ak, action, bucket, obj, ctx))
    return out


def test_iamsys_state_bytes_and_decisions_match_jax(iam_pinned):
    """Every mutation leaves the same state.json bytes (or raises the same
    error type), the decisions agree midway and at the end, and a fresh
    IAMSys over the stored document holds the same secrets."""
    got = {}
    for pkg in ("jax", "port"):
        iam_pinned()
        store = Store(pkg)
        iam = IAMS[pkg].IAMSys(store, AK, SK)
        ids, steps = _mutations(iam)
        trail, mid = [], None
        for label, step in steps:
            try:
                step()
                outcome = "ok"
            except (ValueError, KeyError) as e:
                outcome = type(e).__name__
            trail.append((label, outcome, store.docs.get(STATE)))
            if label == "sts clamped":
                keys = [AK, "alice", "bob", "carol", "ghost", *ids.values()]
                mid = _decisions(iam, keys)
        keys = [AK, "alice", "bob", "carol", "ghost", *ids.values()]
        again = IAMS[pkg].IAMSys(Store(pkg, store.docs), AK, SK)
        got[pkg] = {"trail": trail, "mid": mid, "ids": ids,
                    "end": _decisions(iam, keys),
                    "reloaded": _decisions(again, keys),
                    "secrets": [again.lookup_secret(k) for k in keys],
                    "effective": {k: [p.name for p in
                                      again.effective_policies(k)]
                                  for k in keys}}
    assert got["port"]["trail"] == got["jax"]["trail"]
    for key in ("mid", "ids", "end", "reloaded", "secrets", "effective"):
        assert got["port"][key] == got["jax"][key], key
    outcomes = {label: o for label, o, _ in got["port"]["trail"]}
    assert outcomes["root override"] == "ValueError"
    assert outcomes["delete canned"] == "ValueError"
    assert outcomes["status of a ghost"] == "KeyError"
    # the 900 s credential was purged, the clamped one kept
    doc = json.loads(got["port"]["trail"][-1][2])
    assert got["port"]["ids"]["sts"] not in doc["users"]
    assert doc["users"][got["port"]["ids"]["sts_long"]]["exp"] == \
        T0 + 7 * 24 * 3600
    assert any(got["port"]["mid"]) and not all(got["port"]["mid"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_and_resaves_the_others_state(iam_pinned,
                                                         writer):
    """One package's state.json, loaded by the other and saved again,
    comes back byte for byte, and both decide alike over it."""
    reader = "port" if writer == "jax" else "jax"
    store = Store(writer)
    iam = IAMS[writer].IAMSys(store, AK, SK)
    ids, steps = _mutations(iam)
    for _label, step in steps[:15]:
        step()
    blob = store.docs[STATE]
    other = Store(reader, {STATE: blob})
    loaded = IAMS[reader].IAMSys(other, AK, SK)
    loaded._save()
    assert other.docs[STATE] == blob
    keys = [AK, "alice", "bob", "carol", "ghost", *ids.values()]
    assert _decisions(loaded, keys) == _decisions(iam, keys)


# --- the same signed script on both servers ----------------------------------


def _admin(c, method, op, query=None, doc=None, raw=b""):
    data = json.dumps(doc).encode() if doc is not None else raw
    return c.request(method, f"/minio/admin/v3/{op}", query=query, body=data)


def _sts(c, duration=900, policy=b""):
    form = {"Action": "AssumeRole", "Version": "2011-06-15",
            "DurationSeconds": str(duration)}
    if policy:
        form["Policy"] = policy.decode()
    return c.request("POST", "/", body=urllib.parse.urlencode(form).encode(),
                     headers={"content-type":
                              "application/x-www-form-urlencoded"})


def _creds(r) -> tuple[str, str]:
    import re
    return (re.search(rb"<AccessKeyId>([^<]+)<", r.content).group(1).decode(),
            re.search(rb"<SecretAccessKey>([^<]+)<",
                      r.content).group(1).decode())


def iam_script(s):
    """Users, groups, service accounts, STS, the anonymous bucket policy
    and the admin IAM ops over signed HTTP (tests/test_iam.py's flows)."""
    s.srv.enable_iam()
    ep, c = s.srv.endpoint(), s.cl
    yield "put bucket", c.put_bucket("iamb")
    yield "put o", c.put_object("iamb", "o", body(300))
    yield "put shared", c.put_object("iamb", "shared/doc", body(301))
    yield "add reader", _admin(c, "PUT", "add-user", {"accessKey": "reader1"},
                               {"secretKey": "readersecret",
                                "policies": ["readonly"]})
    yield "add writer", _admin(c, "PUT", "add-user", {"accessKey": "writer1"},
                               {"secretKey": "writersecret",
                                "policies": ["writeonly"]})
    rd = S3Client(ep, "reader1", "readersecret")
    wr = S3Client(ep, "writer1", "writersecret")
    yield "reader get", rd.get_object("iamb", "o")
    yield "reader list", rd.request("GET", "/iamb", query={"list-type": "2"})
    yield "reader put denied", rd.put_object("iamb", "new", b"x")
    yield "writer put", wr.put_object("iamb", "w", body(302))
    yield "writer get denied", wr.get_object("iamb", "o")
    yield "writer copy denied", wr.request(
        "PUT", "/iamb/copy", headers={"x-amz-copy-source": "/iamb/o"})
    yield "disable reader", _admin(c, "PUT", "set-user-status",
                                   {"accessKey": "reader1",
                                    "status": "disabled"})
    yield "disabled get", rd.get_object("iamb", "o")
    yield "enable reader", _admin(c, "PUT", "set-user-status",
                                  {"accessKey": "reader1",
                                   "status": "enabled"})
    yield "unknown key", S3Client(ep, "ghost", "nosecret123").get_object(
        "iamb", "o")
    yield "custom policy", _admin(c, "PUT", "add-canned-policy",
                                  {"name": "team-read"},
                                  raw=TEAM_READ.replace(b"teambucket",
                                                        b"iamb"))
    yield "add member", _admin(c, "PUT", "add-user",
                               {"accessKey": "member1"},
                               {"secretKey": "membersecret"})
    yield "group", _admin(c, "PUT", "add-user-to-group", None,
                          {"group": "team", "members": ["member1"]})
    yield "group policy", _admin(c, "PUT", "set-user-or-group-policy",
                                 {"userOrGroup": "team",
                                  "policyName": "team-read",
                                  "isGroup": "true"})
    m = S3Client(ep, "member1", "membersecret")
    yield "member get shared", m.get_object("iamb", "shared/doc")
    yield "member get private", m.get_object("iamb", "o")
    yield "member put denied", m.put_object("iamb", "shared/x", b"no")
    yield "user policy", _admin(c, "PUT", "set-user-or-group-policy",
                                {"userOrGroup": "member1",
                                 "policyName": "readwrite,nope",
                                 "isGroup": "false"})
    yield "member put", m.put_object("iamb", "shared/y", body(303))
    r = _admin(c, "PUT", "add-service-account", None, {"parent": "reader1"})
    yield "service account", r
    sa = S3Client(ep, r.json()["accessKey"], r.json()["secretKey"])
    yield "sa get", sa.get_object("iamb", "o")
    yield "sa put denied", sa.put_object("iamb", "n", b"y")
    r = _sts(wr)
    yield "assume role", r
    tmp = S3Client(ep, *_creds(r))
    yield "sts put", tmp.put_object("iamb", "sts/a", body(304))
    yield "sts get denied", tmp.get_object("iamb", "sts/a")
    narrow = json.dumps({"Statement": [{
        "Effect": "Allow", "Action": "s3:PutObject",
        "Resource": "arn:aws:s3:::iamb/sts/*"}]}).encode()
    yield "add full", _admin(c, "PUT", "add-user", {"accessKey": "full1"},
                             {"secretKey": "fullsecret1",
                              "policies": ["readwrite"]})
    r = _sts(S3Client(ep, "full1", "fullsecret1"), 3600, narrow)
    yield "assume role narrowed", r
    nar = S3Client(ep, *_creds(r))
    yield "narrowed put inside", nar.put_object("iamb", "sts/b", body(305))
    yield "narrowed put outside", nar.put_object("iamb", "elsewhere", b"z")
    yield "narrowed get denied", nar.get_object("iamb", "sts/b")
    yield "bad duration", wr.request(
        "POST", "/", body=b"Action=AssumeRole&DurationSeconds=soon",
        headers={"content-type": "application/x-www-form-urlencoded"})
    yield "bad action", wr.request(
        "POST", "/", body=b"Action=AssumeRoleWithMagic",
        headers={"content-type": "application/x-www-form-urlencoded"})
    CLOCK.now += 1000  # the 900 s credential is gone, the narrowed one not
    yield "expired sts", tmp.get_object("iamb", "o")
    yield "unexpired sts", nar.put_object("iamb", "sts/c", body(306))
    anon = requests.Session()
    yield "anon no policy", anon.get(f"{ep}/iamb/o")
    yield "no policy", c.request("GET", "/iamb", query={"policy": ""})
    public = json.dumps({"Statement": [{
        "Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
        "Resource": "arn:aws:s3:::iamb/*"}]}).encode()
    yield "put policy", c.request("PUT", "/iamb", query={"policy": ""},
                                  body=public)
    yield "get policy", c.request("GET", "/iamb", query={"policy": ""})
    yield "anon get", anon.get(f"{ep}/iamb/o")
    yield "anon put", anon.put(f"{ep}/iamb/evil", data=b"x")
    yield "anon list", anon.get(f"{ep}/iamb")
    yield "writer get by policy", wr.get_object("iamb", "o")
    yield "delete policy", c.request("DELETE", "/iamb",
                                     query={"policy": ""})
    yield "anon after delete", anon.get(f"{ep}/iamb/o")
    yield "admin by a user", _admin(rd, "GET", "list-users")
    yield "list users", _admin(c, "GET", "list-users")
    yield "list groups", _admin(c, "GET", "list-groups")
    yield "list policies", _admin(c, "GET", "list-canned-policies")
    yield "remove group", _admin(c, "DELETE", "remove-group",
                                 {"group": "team"})
    yield "remove reader", _admin(c, "DELETE", "remove-user",
                                  {"accessKey": "reader1"})
    yield "sa of a removed parent", sa.get_object("iamb", "o")
    yield "remove policy", _admin(c, "DELETE", "remove-canned-policy",
                                  {"name": "team-read"})
    yield "remove canned", _admin(c, "DELETE", "remove-canned-policy",
                                  {"name": "readonly"})
    yield "short secret", _admin(c, "PUT", "add-user", {"accessKey": "eve"},
                                 {"secretKey": "short"})
    yield "list users at the end", _admin(c, "GET", "list-users")


def test_iam_script_matches_jax(pinned, iam_pinned, tmp_path):
    def reset():
        orig()
        iam_pinned()

    orig, pinned.reset = pinned.reset, reset
    out = run_both(pinned, tmp_path, iam_script)
    assert_same(out, tmp_path)
    statuses = dict((label, r[0]) for label, r in out["port"])
    assert statuses["reader put denied"] == 403
    assert statuses["narrowed put outside"] == 403
    assert statuses["expired sts"] == 403
    assert statuses["anon get"] == 200 and statuses["anon put"] == 403
    assert statuses["sa of a removed parent"] == 403
    state = [p for p in (tmp_path / "port").rglob("state.json")
             if "iam" in p.parts]
    assert state and all(p.read_bytes() == (tmp_path / "jax" /
                                            p.relative_to(tmp_path / "port")
                                            ).read_bytes() for p in state)


def test_without_iam_the_server_stays_root_only(pinned, tmp_path):
    """No enable_iam(): STS answers 501 and the policy gate admits only
    the root credentials, as before the IAM plane was ported."""
    from test_torch_s3server import Server
    s = Server("port", tmp_path / "port")
    try:
        assert s.srv.iam is None
        r = s.cl.request("POST", "/", body=b"Action=AssumeRole")
        assert r.status_code == 501
        assert s.cl.put_bucket("noiam").status_code == 200
        assert requests.get(f"{s.srv.endpoint()}/noiam").status_code \
            == 403
        r = _admin(s.cl, "GET", "list-users")
        assert r.status_code == 501
    finally:
        s.close()
