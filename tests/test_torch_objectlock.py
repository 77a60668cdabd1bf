"""The port's object lock (minio_tpu_torch.bucket.objectlock and its S3
handlers) held to the JAX package's: the same signed script against a JAX
S3Server and a port one (tests/test_torch_s3server.py's harness) gives the
same statuses, error XML and headers, and byte-identical trees — the
lock-enabled bucket's record with its ObjectLockConfiguration, every
version's retention and legal-hold metadata in xl.meta. Each server then
reads the other's tree: the lock configuration, the retention, the legal
hold, and the same 403 for a locked version's delete.

The objectlock modules' clock is pinned (``LOCK_NOW``) in both packages,
so the default retention's retain-until date is the same string on both
sides; the scripts' explicit dates lie far in the future or the past."""
import types

import pytest

from minio_tpu.bucket import objectlock as jol
from minio_tpu_torch.bucket import objectlock as pol
from test_torch_s3server import (Server, assert_same, norm,  # noqa: F401
                                pinned, run_both)

#: the objectlock modules' now (2023-11-14T22:13:20Z)
LOCK_NOW = 1.7e9
FAR = "2099-01-01T00:00:00Z"
FARTHER = "2099-06-01T00:00:00Z"
PAST = "2000-01-01T00:00:00Z"
LOCK = {"x-amz-bucket-object-lock-enabled": "true"}
BYPASS = {"x-amz-bypass-governance-retention": "true"}


def governance(until=FAR):
    return {"x-amz-object-lock-mode": "GOVERNANCE",
            "x-amz-object-lock-retain-until-date": until}


def retention_xml(mode, until) -> bytes:
    return (f"<Retention><Mode>{mode}</Mode><RetainUntilDate>{until}"
            f"</RetainUntilDate></Retention>").encode()


def hold_xml(status) -> bytes:
    return f"<LegalHold><Status>{status}</Status></LegalHold>".encode()


def lock_config(mode="COMPLIANCE", days=1) -> bytes:
    return (b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
            b"</ObjectLockEnabled><Rule><DefaultRetention><Mode>%s</Mode>"
            b"<Days>%d</Days></DefaultRetention></Rule>"
            b"</ObjectLockConfiguration>" % (mode.encode(), days))


@pytest.fixture
def lock_clock(monkeypatch):
    import time
    fake = types.SimpleNamespace(time=lambda: LOCK_NOW,
                                 strftime=time.strftime, gmtime=time.gmtime)
    for mod in (jol, pol):
        monkeypatch.setattr(mod, "time", fake)


def lock_script(s: Server):
    c = s.cl
    yield "create lock bucket", c.request("PUT", "/lk", headers=LOCK)
    yield "create plain bucket", c.put_bucket("plain")
    yield "lock config default", c.request("GET", "/lk",
                                           query={"object-lock": ""})
    yield "lock config plain", c.request("GET", "/plain",
                                         query={"object-lock": ""})
    yield "put lock config plain", c.request(
        "PUT", "/plain", query={"object-lock": ""}, body=lock_config())
    yield "put lock config bad", c.request(
        "PUT", "/lk", query={"object-lock": ""},
        body=lock_config().replace(b"<Days>1</Days>", b""))
    yield "put lock config malformed", c.request(
        "PUT", "/lk", query={"object-lock": ""}, body=b"<nope")
    yield "put lock config", c.request("PUT", "/lk",
                                       query={"object-lock": ""},
                                       body=lock_config())
    yield "lock config", c.request("GET", "/lk", query={"object-lock": ""})
    yield "versioning", c.request("GET", "/lk", query={"versioning": ""})
    yield "suspend versioning", c.request(
        "PUT", "/lk", query={"versioning": ""},
        body=b"<VersioningConfiguration><Status>Suspended</Status>"
             b"</VersioningConfiguration>")
    # the bucket's COMPLIANCE default: nothing deletes the version
    r = c.put_object("lk", "c1", b"compliance one")
    yield "put c1", r
    c1 = r.headers["x-amz-version-id"]
    yield "retention c1", c.request("GET", "/lk/c1",
                                    query={"retention": ""})
    yield "legal hold c1", c.request("GET", "/lk/c1",
                                     query={"legal-hold": ""})
    yield "head c1", c.head_object("lk", "c1")
    yield "delete c1 version", c.delete_object("lk", "c1",
                                               query={"versionId": c1})
    yield "delete c1 version bypass", c.request(
        "DELETE", "/lk/c1", query={"versionId": c1}, headers=BYPASS)
    yield "weaken c1 to governance", c.request(
        "PUT", "/lk/c1", query={"retention": ""},
        body=retention_xml("GOVERNANCE", FARTHER))
    yield "extend c1", c.request("PUT", "/lk/c1", query={"retention": ""},
                                 body=retention_xml("COMPLIANCE", FAR))
    yield "shorten c1", c.request("PUT", "/lk/c1", query={"retention": ""},
                                  body=retention_xml("COMPLIANCE",
                                                     "2098-01-01T00:00:00Z"))
    yield "retention c1 after", c.request("GET", "/lk/c1",
                                          query={"retention": ""})
    yield "delete c1 (marker)", c.delete_object("lk", "c1")
    yield "get c1 version", c.get_object("lk", "c1",
                                         query={"versionId": c1})
    # GOVERNANCE: the bypass header (root may bypass) deletes
    r = c.put_object("lk", "g1", b"governance", headers=governance())
    yield "put g1", r
    g1 = r.headers["x-amz-version-id"]
    yield "delete g1 version", c.delete_object("lk", "g1",
                                               query={"versionId": g1})
    yield "delete g1 version bypass", c.request(
        "DELETE", "/lk/g1", query={"versionId": g1}, headers=BYPASS)
    r = c.put_object("lk", "g2", b"governance two", headers=governance())
    g2 = r.headers["x-amz-version-id"]
    yield "shorten g2", c.request("PUT", "/lk/g2", query={"retention": ""},
                                  body=retention_xml("GOVERNANCE",
                                                     "2098-01-01T00:00:00Z"))
    yield "shorten g2 bypass", c.request(
        "PUT", "/lk/g2", query={"retention": ""}, headers=BYPASS,
        body=retention_xml("GOVERNANCE", "2098-01-01T00:00:00Z"))
    yield "retention bad mode", c.request(
        "PUT", "/lk/g2", query={"retention": ""},
        body=retention_xml("FOREVER", FAR))
    yield "retention bad date", c.request(
        "PUT", "/lk/g2", query={"retention": ""},
        body=retention_xml("GOVERNANCE", "soon"))
    yield "retention malformed", c.request(
        "PUT", "/lk/g2", query={"retention": ""}, body=b"<Retention")
    # a legal hold blocks even the bypass until it is released
    yield "hold g2 on", c.request("PUT", "/lk/g2", query={"legal-hold": ""},
                                  body=hold_xml("ON"))
    yield "legal hold g2", c.request("GET", "/lk/g2",
                                     query={"legal-hold": ""})
    yield "delete g2 held", c.request(
        "DELETE", "/lk/g2", query={"versionId": g2}, headers=BYPASS)
    yield "hold bad", c.request("PUT", "/lk/g2", query={"legal-hold": ""},
                                body=hold_xml("MAYBE"))
    yield "hold g2 off", c.request("PUT", "/lk/g2",
                                   query={"legal-hold": ""},
                                   body=hold_xml("OFF"))
    yield "delete g2 released", c.request(
        "DELETE", "/lk/g2", query={"versionId": g2}, headers=BYPASS)
    # the request's headers: validated, and refused where no lock is
    yield "put past retention", c.put_object(
        "lk", "p", b"x", headers=governance(PAST))
    yield "put bad mode", c.put_object(
        "lk", "p", b"x", headers={**governance(), "x-amz-object-lock-mode":
                                  "SOMETIMES"})
    yield "put hold header", c.put_object(
        "lk", "h1", b"held", headers={"x-amz-object-lock-legal-hold": "ON"})
    yield "put h2 held", c.put_object(
        "lk", "h2", b"held two",
        headers={"x-amz-object-lock-legal-hold": "ON"})
    yield "put lock on plain", c.put_object("plain", "o", b"x",
                                            headers=governance())
    yield "put plain", c.put_object("plain", "o", b"plain object")
    yield "retention plain", c.request("GET", "/plain/o",
                                       query={"retention": ""})
    yield "put retention plain", c.request(
        "PUT", "/plain/o", query={"retention": ""},
        body=retention_xml("GOVERNANCE", FAR))
    yield "put hold plain", c.request("PUT", "/plain/o",
                                      query={"legal-hold": ""},
                                      body=hold_xml("ON"))
    yield "legal hold plain", c.request("GET", "/plain/o",
                                        query={"legal-hold": ""})
    # a copy into the lock bucket takes the default retention
    yield "copy", c.request("PUT", "/lk/copy",
                            headers={"x-amz-copy-source": "/plain/o"})
    yield "retention copy", c.request("GET", "/lk/copy",
                                      query={"retention": ""})
    # DeleteObjects: the locked version refused per key
    r = c.put_object("lk", "m", b"multi", headers=governance())
    m = r.headers["x-amz-version-id"]
    objs = (f"<Object><Key>m</Key><VersionId>{m}</VersionId></Object>"
            f"<Object><Key>h1</Key></Object>"
            f"<Object><Key>g1</Key></Object>")
    yield "delete objects", c.request(
        "POST", "/lk", query={"delete": ""},
        body=f"<Delete>{objs}</Delete>".encode())
    yield "list versions", c.request("GET", "/lk", query={"versions": ""})
    yield "force delete lock bucket", c.request(
        "DELETE", "/lk", headers={"x-minio-force-delete": "true"})


def reads(c):
    yield "lock config", c.request("GET", "/lk", query={"object-lock": ""})
    yield "retention c1", c.request("GET", "/lk/c1",
                                    query={"retention": ""})
    yield "retention g2", c.request("GET", "/lk/g2",
                                    query={"retention": ""})
    yield "legal hold h2", c.request("GET", "/lk/h2",
                                     query={"legal-hold": ""})
    yield "head h2", c.head_object("lk", "h2")
    yield "put default", c.put_object("lk", "new", b"new object")
    yield "retention default", c.request("GET", "/lk/new",
                                         query={"retention": ""})
    r = c.request("GET", "/lk", query={"versions": ""})
    yield "versions", r
    import re
    vid = re.search(rb"<Version><Key>c1</Key><VersionId>([^<]+)<",
                    r.content)
    yield "delete c1 version", c.delete_object(
        "lk", "c1", query={"versionId": vid.group(1).decode()})


def test_same_lock_script_same_responses_and_trees(tmp_path, pinned,
                                                   lock_clock):
    out = run_both(pinned, tmp_path, lock_script)
    assert_same(out, tmp_path)
    st = {label: resp[0] for label, resp in out["port"]}
    assert st["create lock bucket"] == 200
    assert st["delete c1 version"] == st["delete c1 version bypass"] == 403
    assert st["weaken c1 to governance"] == st["shorten c1"] == 403
    assert st["extend c1"] == 200
    assert st["delete g1 version"] == 403
    assert st["delete g1 version bypass"] == 204
    assert st["shorten g2"] == 403 and st["shorten g2 bypass"] == 200
    assert st["delete g2 held"] == 403 and st["delete g2 released"] == 204
    assert st["put lock on plain"] == st["put past retention"] == 400
    assert st["force delete lock bucket"] == 400
    replies = dict(out["port"])
    assert b"<Mode>COMPLIANCE</Mode>" in replies["retention c1"][2]
    assert b"<Days>1</Days>" in replies["lock config"][2]
    # ObjectLocked answers S3's AccessDenied code
    assert b"<Code>AccessDenied</Code>" in replies["delete c1 version"][2]


def test_each_server_reads_the_others_locks(tmp_path, pinned, lock_clock):
    """The port over the JAX tree and the JAX server over the port's:
    the same configuration, retention, legal hold, default on a new
    PUT and refusal of a locked version's delete."""
    out = run_both(pinned, tmp_path, lock_script)
    assert_same(out, tmp_path)
    got = {}
    for reader, writer in (("port", "jax"), ("jax", "port")):
        pinned.reset()
        s = Server(reader, tmp_path / writer)
        try:
            got[reader] = [(label, norm(r)) for label, r in reads(s.cl)]
        finally:
            s.close()
    assert [lbl for lbl, _ in got["port"]] == [lbl for lbl, _ in got["jax"]]
    for (label, want), (_, have) in zip(got["jax"], got["port"]):
        assert have == want, label
    st = dict(got["port"])
    assert st["delete c1 version"][0] == 403
    assert st["legal hold h2"][2] == b"<LegalHold><Status>ON</Status>" \
                                     b"</LegalHold>"


@pytest.mark.parametrize("case", [
    ({"x-amz-object-lock-mode": "governance",
      "x-amz-object-lock-retain-until-date": FAR}, True, ""),
    ({"x-amz-object-lock-mode": "GOVERNANCE"}, True, ""),
    ({"x-amz-object-lock-legal-hold": "on"}, True, ""),
    ({}, True, "GOVERNANCE"),
    ({}, False, "COMPLIANCE"),
    ({"x-amz-object-lock-retain-until-date": "2099-01-01T00:00:00.5Z",
      "x-amz-object-lock-mode": "COMPLIANCE"}, True, ""),
    ({"x-amz-object-lock-retain-until-date": "2099-01-01T00:00:00+02:00",
      "x-amz-object-lock-mode": "COMPLIANCE"}, True, ""),
], ids=["lowercase-mode", "mode-without-date", "hold", "default",
        "not-enabled", "fraction", "offset"])
def test_check_put_headers_match_jax(lock_clock, case):
    hdr, enabled, default_mode = case
    outs = []
    for mod, dt_mod in ((jol, "minio_tpu"), (pol, "minio_tpu_torch")):
        dr = mod.DefaultRetention(mode=default_mode, years=1) \
            if default_mode else mod.DefaultRetention()
        try:
            outs.append(("ok", mod.check_put_headers(hdr, "b", "k", enabled,
                                                     dr)))
        except Exception as e:  # noqa: BLE001 — compared across packages
            outs.append((type(e).__name__, str(e)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("blob", [
    b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
    b"</ObjectLockEnabled></ObjectLockConfiguration>",
    b'<ObjectLockConfiguration xmlns="http://s3.amazonaws.com/doc/'
    b'2006-03-01/"><ObjectLockEnabled>Enabled</ObjectLockEnabled><Rule>'
    b"<DefaultRetention><Mode>GOVERNANCE</Mode><Years>2</Years>"
    b"</DefaultRetention></Rule></ObjectLockConfiguration>",
    b"<ObjectLockConfiguration><ObjectLockEnabled>Disabled"
    b"</ObjectLockEnabled></ObjectLockConfiguration>",
    b"<ObjectLockConfiguration><Rule><DefaultRetention><Mode>X</Mode>"
    b"<Days>1</Days></DefaultRetention></Rule></ObjectLockConfiguration>",
    b"<ObjectLockConfiguration><Rule><DefaultRetention><Mode>COMPLIANCE"
    b"</Mode><Days>1</Days><Years>1</Years></DefaultRetention></Rule>"
    b"</ObjectLockConfiguration>",
], ids=["enabled", "namespaced-years", "disabled", "bad-mode", "both"])
def test_lock_config_parse_and_render_match_jax(blob):
    outs = []
    for mod in (jol, pol):
        try:
            dr = mod.parse_lock_config(blob)
            outs.append((dr.mode, dr.days, dr.years,
                         mod.lock_config_xml(True, dr)))
        except ValueError as e:
            outs.append(("ValueError", str(e)))
    assert outs[0] == outs[1]
