"""The port's bucket lifecycle (minio_tpu_torch.bucket.lifecycle, the
``?lifecycle`` sub-resource and the data scanner's hook) held to the JAX
package's: the rule grammar parses alike; the same signed script against
a JAX S3Server and a port one gives the same answers and trees; the rule
engine applied to every object of identical trees (expiry by age and by
date, prefix and tag filters, noncurrent versions, stale delete markers)
removes the same versions and leaves byte-identical trees; each package
reads the other's stored lifecycle document; and the port's scanner
applies the rules on its cycle, walking a ruled bucket even with no new
writes.

Object times are pinned to 2023 (``Pin``), so a one-day rule finds every
object old; the expiry dates lie in the past."""
import pytest

from minio_tpu.bucket import lifecycle as jlc
from minio_tpu_torch.bucket import lifecycle as plc
from test_torch_s3server import (Server, assert_same, norm,  # noqa: F401
                                 pinned, run_both)
from test_torch_objectlayer import tree

VERSIONED = (b"<VersioningConfiguration><Status>Enabled</Status>"
             b"</VersioningConfiguration>")
RULES = (
    b'<LifecycleConfiguration xmlns="http://s3.amazonaws.com/doc/'
    b'2006-03-01/">'
    b"<Rule><ID>logs</ID><Status>Enabled</Status><Filter><Prefix>logs/"
    b"</Prefix></Filter><Expiration><Days>1</Days></Expiration></Rule>"
    b"<Rule><ID>dated</ID><Status>Enabled</Status><Filter><Prefix>tmp/"
    b"</Prefix></Filter><Expiration><Date>2020-01-01T00:00:00Z</Date>"
    b"</Expiration></Rule>"
    b"<Rule><ID>tagged</ID><Status>Enabled</Status><Filter><And><Prefix>"
    b"</Prefix><Tag><Key>ttl</Key><Value>short</Value></Tag></And>"
    b"</Filter><Expiration><Days>1</Days></Expiration></Rule>"
    b"<Rule><ID>off</ID><Status>Disabled</Status><Filter><Prefix>keep/"
    b"</Prefix></Filter><Expiration><Days>1</Days></Expiration></Rule>"
    b"</LifecycleConfiguration>")
VERSION_RULES = (
    b"<LifecycleConfiguration><Rule><ID>nc</ID><Status>Enabled</Status>"
    b"<Filter><Prefix></Prefix></Filter><NoncurrentVersionExpiration>"
    b"<NoncurrentDays>1</NoncurrentDays></NoncurrentVersionExpiration>"
    b"<Expiration><ExpiredObjectDeleteMarker>true"
    b"</ExpiredObjectDeleteMarker></Expiration></Rule>"
    b"</LifecycleConfiguration>")
TAGS = (b"<Tagging><TagSet><Tag><Key>ttl</Key><Value>short</Value></Tag>"
        b"</TagSet></Tagging>")


@pytest.mark.parametrize("blob", [
    RULES, VERSION_RULES, b"",
    b"<LifecycleConfiguration><Rule><Prefix>old/</Prefix><Status>Enabled"
    b"</Status><Transition><Days>30</Days><StorageClass>COLD</StorageClass>"
    b"</Transition></Rule></LifecycleConfiguration>",
], ids=["expiry", "versions", "empty", "legacy-prefix-transition"])
def test_rule_grammar_matches_jax(blob):
    def fields(rules):
        return [tuple(sorted(vars(r).items())) for r in rules]
    assert fields(plc.parse_lifecycle(blob)) == \
        fields(jlc.parse_lifecycle(blob))


def lifecycle_script(s: Server):
    c = s.cl
    c.put_bucket("lc")
    yield "get none", c.request("GET", "/lc", query={"lifecycle": ""})
    yield "put", c.request("PUT", "/lc", query={"lifecycle": ""}, body=RULES)
    yield "get", c.request("GET", "/lc", query={"lifecycle": ""})
    yield "put missing bucket", c.request("PUT", "/nope",
                                          query={"lifecycle": ""},
                                          body=RULES)
    yield "delete", c.request("DELETE", "/lc", query={"lifecycle": ""})
    yield "get after delete", c.request("GET", "/lc",
                                        query={"lifecycle": ""})
    yield "put again", c.request("PUT", "/lc", query={"lifecycle": ""},
                                 body=RULES)
    for name in ("logs/a", "logs/b", "tmp/x", "keep/k", "data/d", "t1"):
        yield f"put {name}", c.put_object("lc", name, name.encode() * 10)
    yield "tag t1", c.request("PUT", "/lc/t1", query={"tagging": ""},
                              body=TAGS)
    c.put_bucket("vlc")
    c.request("PUT", "/vlc", query={"versioning": ""}, body=VERSIONED)
    yield "put version rules", c.request(
        "PUT", "/vlc", query={"lifecycle": ""}, body=VERSION_RULES)
    yield "put v1", c.put_object("vlc", "v", b"first")
    yield "put v2", c.put_object("vlc", "v", b"second")
    yield "put gone", c.put_object("vlc", "gone", b"to be removed")
    r = c.request("GET", "/vlc", query={"versions": ""})
    import re
    vid = re.search(rb"<Key>gone</Key><VersionId>([^<]+)<", r.content)
    yield "delete gone (marker)", c.delete_object("vlc", "gone")
    yield "delete gone version", c.delete_object(
        "vlc", "gone", query={"versionId": vid.group(1).decode()})


def _apply_all(s: Server) -> list:
    """The rule engine over every version of both buckets, as a scanner
    cycle applies it; returns (bucket, key, version, removed)."""
    mod = plc if s.pkg == "port" else jlc
    lc = mod.LifecycleSys(s.srv.obj, s.srv.bucket_meta)
    out = []
    for bucket in ("lc", "vlc"):
        r = s.srv.obj.list_object_versions(bucket, "", "", "", "", 1000)
        for oi in list(r.objects):
            out.append((bucket, oi.name, oi.version_id,
                        lc.apply(bucket, oi)))
    return out


def test_same_lifecycle_script_same_expiries_and_trees(tmp_path, pinned):
    applied = {}

    def script(s: Server):
        yield from lifecycle_script(s)
        applied[s.pkg] = _apply_all(s)
        c = s.cl
        yield "list after", c.request("GET", "/lc", query={"list-type": "2"})
        yield "versions after", c.request("GET", "/vlc",
                                          query={"versions": ""})

    out = run_both(pinned, tmp_path, script)
    assert_same(out, tmp_path)
    assert applied["port"] == applied["jax"]
    removed = {(b, k) for b, k, _v, gone in applied["port"] if gone}
    assert {("lc", "logs/a"), ("lc", "logs/b"), ("lc", "tmp/x"),
            ("lc", "t1"), ("vlc", "v")} <= removed
    assert ("lc", "keep/k") not in removed
    assert ("lc", "data/d") not in removed
    st = {label: resp[0] for label, resp in out["port"]}
    assert st["get none"] == 404 and st["get"] == 200
    assert st["get after delete"] == 404 and st["delete"] == 204


def test_each_server_reads_the_others_lifecycle(tmp_path, pinned):
    out = run_both(pinned, tmp_path, lifecycle_script)
    assert_same(out, tmp_path)
    got = {}
    for reader, writer in (("port", "jax"), ("jax", "port")):
        pinned.reset()
        s = Server(reader, tmp_path / writer)
        try:
            got[reader] = (
                norm(s.cl.request("GET", "/lc", query={"lifecycle": ""})),
                [r.rule_id for r in (plc if reader == "port" else jlc)
                 .LifecycleSys(s.srv.obj, s.srv.bucket_meta)
                 .rules_for("vlc")])
        finally:
            s.close()
    assert got["port"] == got["jax"]
    assert got["port"][0][2] == RULES and got["port"][1] == ["nc"]


def test_port_scanner_applies_rules_each_cycle(tmp_path, pinned):
    """A scanner cycle expires what the rules say; a bucket with rules is
    walked again on the next cycle although nothing was written (its
    rules trigger on age), where a bucket without rules is skipped."""
    from minio_tpu_torch.scanner.scanner import DataScanner
    s = Server("port", tmp_path)
    try:
        c = s.cl
        c.put_bucket("lc")
        c.put_bucket("plain")
        c.put_object("plain", "p", b"plain")
        c.put_object("lc", "logs/a", b"a")
        sc = DataScanner(s.srv.obj, sleep_per_object=0,
                         lifecycle=plc.LifecycleSys(s.srv.obj,
                                                    s.srv.bucket_meta))
        sc.scan_cycle()
        assert c.get_object("lc", "logs/a").status_code == 200
        c.request("PUT", "/lc", query={"lifecycle": ""}, body=RULES)
        seen = []
        orig = sc._check_object
        sc._check_object = lambda b, oi, deep: (seen.append(b),
                                                orig(b, oi, deep))
        sc.scan_cycle()
        assert seen == ["lc"]
        assert c.get_object("lc", "logs/a").status_code == 404
        assert sc.lifecycle.expired == 1
        assert c.get_object("plain", "p").status_code == 200
    finally:
        s.close()
