"""The port's event notifications (minio_tpu_torch.event: records, rules,
the queue store, the notifier, the webhook target, and the server's
notify hook, ``?notification`` and ``?events``) held to the JAX
package's: on a pinned clock the records are the same dicts; the rules
route alike; the same signed script against a JAX S3Server and a port
one, each with a webhook target on a loopback sink, answers alike and
delivers the same envelopes in the same order (PUT, GET, copy,
multipart completion, DELETE, DeleteObjects), the stored notification
documents are byte-identical, and a live listen streams the same lines;
each package's queue store delivers the other's queued events; the
notify chain attaches under the lock and keeps every link."""
import json
import os
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from minio_tpu.event import notifier as jnotifier
from minio_tpu.event import queuestore as jqs
from minio_tpu.event import record as jrec
from minio_tpu.event import rules as jrules
from minio_tpu.event import targets as jtargets
from minio_tpu_torch.event import notifier as pnotifier
from minio_tpu_torch.event import queuestore as pqs
from minio_tpu_torch.event import record as prec
from minio_tpu_torch.event import rules as prules
from minio_tpu_torch.event import targets as ptargets
from test_torch_s3server import (Server, body, norm,  # noqa: F401
                                 pinned)
from test_torch_objectlayer import tree

EVENT_NOW = 1.76e9 + 0.123
ARN = "arn:minio:sqs:us-east-1:t1:webhook"
NOTIF = f"""<NotificationConfiguration>
  <QueueConfiguration><Id>1</Id><Queue>{ARN}</Queue>
    <Event>s3:ObjectCreated:*</Event><Event>s3:ObjectAccessed:Get</Event>
    <Filter><S3Key><FilterRule><Name>prefix</Name><Value>docs/</Value>
    </FilterRule></S3Key></Filter></QueueConfiguration>
  <QueueConfiguration><Id>2</Id><Queue>{ARN}</Queue>
    <Event>s3:ObjectRemoved:*</Event></QueueConfiguration>
</NotificationConfiguration>""".encode()


@pytest.fixture
def event_clock(monkeypatch):
    fake = types.SimpleNamespace(time=lambda: EVENT_NOW,
                                 strftime=time.strftime, gmtime=time.gmtime)
    for mod in (jrec, prec):
        monkeypatch.setattr(mod, "time", fake)


class _Sink(BaseHTTPRequestHandler):
    got: list = []

    def do_POST(self):  # noqa: N802
        data = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        type(self).got.append((self.headers.get("Authorization", ""),
                               self.headers.get("Content-Type", ""),
                               json.loads(data)))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


def _wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline
        time.sleep(0.02)


def test_records_match_jax(event_clock):
    oi = types.SimpleNamespace(name="dir/a b+c.txt", size=12, etag="abc",
                               version_id="v1")
    for args in (("s3:ObjectCreated:Put", "b", oi),
                 ("s3:ObjectRemoved:Delete", "b", types.SimpleNamespace(
                     name="k"), "eu-west-1", {"sourceIPAddress": "1.2"}),
                 ("s3:ObjectAccessed:Get", "b", oi, "us-east-1", None,
                  "SEQ")):
        assert prec.new_event_record(*args) == jrec.new_event_record(*args)


def test_rules_route_like_jax():
    pr = prules.parse_notification_xml(NOTIF)
    jr = jrules.parse_notification_xml(NOTIF)
    for ev, key in (("s3:ObjectCreated:Put", "docs/a"),
                    ("s3:ObjectCreated:Copy", "other"),
                    ("s3:ObjectAccessed:Get", "docs/x"),
                    ("s3:ObjectAccessed:Head", "docs/x"),
                    ("s3:ObjectRemoved:Delete", "any")):
        assert pr.route(ev, key) == jr.route(ev, key)
    assert pr.arns() == jr.arns() == {ARN}
    assert prules.parse_notification_xml(b"  ").rules == []


def events_script(s: Server, sink):
    c = s.cl
    c.put_bucket("evb")
    yield "get default", c.request("GET", "/evb", query={"notification": ""})
    yield "put unknown arn", c.request(
        "PUT", "/evb", query={"notification": ""},
        body=NOTIF.replace(b"t1:webhook", b"zz:webhook"))
    yield "put malformed", c.request("PUT", "/evb",
                                     query={"notification": ""}, body=b"<x")
    yield "put", c.request("PUT", "/evb", query={"notification": ""},
                           body=NOTIF)
    yield "get", c.request("GET", "/evb", query={"notification": ""})
    yield "put docs/a", c.put_object("evb", "docs/a.txt", body(700, 1))
    yield "put skip", c.put_object("evb", "other/skip", b"x")
    yield "get docs/a", c.get_object("evb", "docs/a.txt")
    yield "copy", c.request("PUT", "/evb/docs/copy",
                            headers={"x-amz-copy-source": "/evb/docs/a.txt"})
    import re
    r = c.request("POST", "/evb/docs/mp", query={"uploads": ""})
    uid = re.search(rb"<UploadId>([^<]*)<", r.content).group(1).decode()
    e1 = c.request("PUT", "/evb/docs/mp", query={"partNumber": "1",
                                                 "uploadId": uid},
                   body=b"part")
    xml = (f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
           f"<ETag>{e1.headers['ETag']}</ETag></Part>"
           f"</CompleteMultipartUpload>").encode()
    yield "complete", c.request("POST", "/evb/docs/mp",
                                query={"uploadId": uid}, body=xml)
    yield "delete docs/a", c.delete_object("evb", "docs/a.txt")
    yield "delete objects", c.request(
        "POST", "/evb", query={"delete": ""},
        body=b"<Delete><Object><Key>other/skip</Key></Object>"
             b"<Object><Key>missing</Key></Object></Delete>")
    _wait(lambda: len(sink.got) >= 7)
    time.sleep(0.2)


def test_same_events_delivered_alike(tmp_path, pinned, event_clock):
    out, delivered = {}, {}
    for pkg in ("jax", "port"):
        pinned.reset()

        class Sink(_Sink):
            got = []

        httpd = ThreadingHTTPServer(("127.0.0.1", 0), Sink)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        s = Server(pkg, tmp_path / pkg)
        mod = ptargets if pkg == "port" else jtargets
        s.srv.enable_events([mod.WebhookTarget(
            "t1", f"http://127.0.0.1:{httpd.server_address[1]}/hook",
            auth_token="sekrit")], queue_root=str(tmp_path / f"q-{pkg}"))
        try:
            out[pkg] = [(label, norm(r))
                        for label, r in events_script(s, Sink)]
            delivered[pkg] = list(Sink.got)
        finally:
            s.close()
            s.srv._notifier.stop()
            httpd.shutdown()
            httpd.server_close()
    assert out["port"] == out["jax"]
    assert delivered["port"] == delivered["jax"]
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    names = [(d[2]["EventName"], d[2]["Key"]) for d in delivered["port"]]
    assert names == [("s3:ObjectCreated:Put", "evb/docs/a.txt"),
                     ("s3:ObjectAccessed:Get", "evb/docs/a.txt"),
                     ("s3:ObjectCreated:Copy", "evb/docs/copy"),
                     ("s3:ObjectCreated:CompleteMultipartUpload",
                      "evb/docs/mp"),
                     ("s3:ObjectRemoved:Delete", "evb/docs/a.txt"),
                     ("s3:ObjectRemoved:Delete", "evb/other/skip"),
                     ("s3:ObjectRemoved:Delete", "evb/missing")]
    assert delivered["port"][0][:2] == ("Bearer sekrit", "application/json")
    assert delivered["port"][0][2]["Records"][0]["s3"]["object"]["size"] \
        == 700
    st = {label: resp[0] for label, resp in out["port"]}
    assert st["put unknown arn"] == st["put malformed"] == 400
    assert os.listdir(tmp_path / "q-port" / "webhook" / "t1") == []


def test_listen_streams_the_same_lines(tmp_path, pinned, event_clock):
    """GET /bucket?events= on both servers (no stored configuration):
    the prefix and event filters apply, the lines are the same JSON."""
    lines = {}
    for pkg in ("jax", "port"):
        pinned.reset()
        s = Server(pkg, tmp_path / pkg)
        got: list = []
        try:
            c = s.cl
            c.put_bucket("lb")

            from s3client import S3Client
            lc = S3Client(s.srv.endpoint(), s.cl.ak, s.cl.sk)

            def listen():
                r = lc.request("GET", "/lb", query={
                    "events": "s3:ObjectCreated:*", "prefix": "logs/",
                    "timeout": "20"}, stream=True)
                for ln in r.iter_lines(chunk_size=1):
                    if ln and ln.strip():
                        got.append(json.loads(ln))
                        if len(got) >= 2:
                            break
                r.close()

            t = threading.Thread(target=listen, daemon=True)
            t.start()
            _wait(lambda: s.srv._notifier is not None and
                  s.srv._notifier._listeners)
            c.put_object("lb", "other/skip.txt", b"x")
            c.put_object("lb", "logs/a.txt", b"1")
            c.delete_object("lb", "logs/a.txt")
            c.put_object("lb", "logs/b.txt", b"22")
            t.join(timeout=30)
            bad = c.request("GET", "/lb", query={"events": "", "timeout":
                                                 "0"})
            lines[pkg] = (got, norm(bad))
        finally:
            s.close()
    assert lines["port"] == lines["jax"]
    keys = [g["Records"][0]["s3"]["object"]["key"]
            for g in lines["port"][0]]
    assert keys == ["logs/a.txt", "logs/b.txt"]
    assert lines["port"][1][0] == 400


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_queue_store_delivers_the_others_events(tmp_path, event_clock,
                                                writer, reader):
    """Events queued by one package's store while its target is down
    (files of the same bytes) are delivered, oldest first, by the other
    package's store over the same directory."""
    mods = {"jax": jqs, "port": pqs}
    recs = [jrec.new_event_record("s3:ObjectCreated:Put", "b",
                                  types.SimpleNamespace(name=f"k{i}",
                                                        size=i))
            for i in range(5)]
    qdir = str(tmp_path / "q")

    def down(record):
        raise RuntimeError("target down")

    store = mods[writer].QueueStore(qdir, down, retry_base_s=0.05)
    for r in recs:
        assert store.put(r)
    files = sorted(os.listdir(qdir))
    assert len(files) == 5
    contents = [open(os.path.join(qdir, f), "rb").read() for f in files]
    assert contents == [json.dumps(r, separators=(",", ":")).encode()
                        for r in recs]
    got: list = []
    other = mods[reader].QueueStore(qdir, got.append,
                                    retry_base_s=0.05).start()
    try:
        _wait(lambda: len(got) == 5)
    finally:
        other.stop()
    assert got == recs and os.listdir(qdir) == []
    assert other.delivered == 5


def test_queue_store_limit_and_failed_write_match_jax(tmp_path,
                                                      monkeypatch):
    outs = []
    for name, mod in (("jax", jqs), ("port", pqs)):
        st = mod.QueueStore(str(tmp_path / name), lambda r: None, limit=3)
        puts = [st.put({"i": i}) for i in range(4)]
        outs.append((puts, st.failed_puts, st._count))
    assert outs[0] == outs[1] == ([True, True, True, False], 1, 3)


def test_targets_from_env_and_config_match_jax(monkeypatch, tmp_path):
    from minio_tpu.config import kvs as jkvs
    from minio_tpu_torch.config import kvs as pkvs
    monkeypatch.setenv("MINIO_TPU_NOTIFY_WEBHOOK_ENDPOINT_PRIMARY",
                       "http://127.0.0.1:9/a")
    monkeypatch.setenv("MINIO_TPU_NOTIFY_WEBHOOK_AUTH_TOKEN_PRIMARY", "tok")
    monkeypatch.setenv("MINIO_TPU_NOTIFY_REDIS_ENABLE", "on")
    monkeypatch.setenv("MINIO_TPU_NOTIFY_REDIS_ADDRESS", "127.0.0.1:9")
    monkeypatch.setenv("MINIO_TPU_NOTIFY_NATS_ENABLE", "on")
    got = []
    for notifier, kvs in ((jnotifier, jkvs), (pnotifier, pkvs)):
        env = [(t.KIND, t.id, t.arn, t.endpoint, t.auth_token)
               for t in notifier.targets_from_env()]
        cfg = [(t.KIND, t.id, t.arn)
               for t in notifier.targets_from_config(kvs.ConfigSys())]
        got.append((env, cfg))
    assert got[0] == got[1]
    assert got[1][1] == [("redis", "1", "arn:minio:sqs:us-east-1:1:redis")]


def test_notify_chain_attaches_under_the_lock(tmp_path):
    """enable_replication waits for the notifier lock, and afterwards
    the pool, the cross-node plane and a lazily made listener notifier
    all see one notify."""
    from minio_tpu_torch.objectlayer import ErasureObjects
    from minio_tpu_torch.obs import slo
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.storage import XLStorage
    obj = ErasureObjects([XLStorage(str(tmp_path / f"d{i}"))
                          for i in range(4)], default_parity=1,
                         device="cpu")
    srv = S3Server(obj, "127.0.0.1", 0, access_key="ak",
                   secret_key="sk-secret", device="cpu")
    seen = []

    class Pool:
        def on_event(self, event, bucket, oi):
            seen.append(("pool", event))

    class Rs:
        def charge(self, event, bucket, oi):
            seen.append(("rs", event))

        def lag_report(self):
            return {"ok": True}

    attached = threading.Event()
    t = threading.Thread(
        target=lambda: (srv.enable_replication(Pool()), attached.set()))
    with srv._notifier_lock:
        t.start()
        time.sleep(0.2)
        assert not attached.is_set()
    t.join(10)
    assert attached.is_set()
    srv.enable_cross_replication(Rs())
    try:
        sub = srv.ensure_notifier().listen("b")
        srv.notify("s3:ObjectCreated:Put", "b",
                   types.SimpleNamespace(name="o", size=1, etag="e",
                                         version_id=""))
        assert ("pool", "s3:ObjectCreated:Put") in seen
        assert ("rs", "s3:ObjectCreated:Put") in seen
        assert sub.q.get(timeout=5)["s3"]["object"]["key"] == "o"
        assert srv.ensure_notifier() is srv._notifier
        assert slo.report()["async"]["replication"] == {"ok": True}
    finally:
        slo.unregister_async_probe("replication")


def test_each_server_reads_the_others_notification_rules(tmp_path, pinned):
    """A ``?notification`` document PUT through one package's server is
    served and routed alike by the other's notifier over the same tree."""
    def write(s: Server):
        s.cl.put_bucket("evb")
        yield "put", s.cl.request("PUT", "/evb", query={"notification": ""},
                                  body=NOTIF)

    from test_torch_s3server import assert_same, run_both
    assert_same(run_both(pinned, tmp_path, write), tmp_path)
    got = {}
    for reader, writer in (("port", "jax"), ("jax", "port")):
        s = Server(reader, tmp_path / writer)
        try:
            rules = s.srv.ensure_notifier().rules_for("evb")
            got[reader] = (
                norm(s.cl.request("GET", "/evb", query={"notification": ""})),
                [rules.route(e, k) for e, k in (
                    ("s3:ObjectCreated:Put", "docs/a"),
                    ("s3:ObjectCreated:Put", "x"),
                    ("s3:ObjectRemoved:Delete", "x"))])
        finally:
            s.close()
    assert got["port"] == got["jax"]
    assert got["port"][0][2] == NOTIF
    assert got["port"][1] == [[ARN], [], [ARN]]
