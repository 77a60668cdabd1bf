"""The port's log and audit plane (minio_tpu_torch.obs.logger) held to the
JAX package's on the CPU: the webhook target against a loopback receiver
(entries sent and counted, the one jittered retry after a failed POST,
drops counted when the endpoint is dead or the queue is full), the
console ring's dedup, the pubsub's drop counter, and the audit entries of
one signed script on both servers: one entry per request, the same keys
and the same API, method, path and status, each entry's ``request_id``
the response's ``x-amz-request-id``, delivered to an audit webhook."""
import http.server
import json
import os
import sys
import threading
import time

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from minio_tpu.obs import bucketstats as jbs  # noqa: E402
from minio_tpu.obs import logger as jlog  # noqa: E402
from minio_tpu.obs import metrics as jmx  # noqa: E402
from minio_tpu_torch.obs import bucketstats as pbs  # noqa: E402
from minio_tpu_torch.obs import logger as plog  # noqa: E402
from minio_tpu_torch.obs import metrics as pmx  # noqa: E402
from test_torch_s3server import Server, body  # noqa: E402

LOG = {"jax": jlog, "port": plog}
MX = {"jax": jmx, "port": pmx}


def _reset_logs():
    for mod in LOG.values():
        if mod._sys is not None:
            mod._sys.stop()
        mod._sys = None


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for var in ("MINIO_TPU_AUDIT_WEBHOOK_ENDPOINT",
                "MINIO_TPU_AUDIT_WEBHOOK_AUTH_TOKEN",
                "MINIO_TPU_LOGGER_WEBHOOK_ENDPOINT",
                "MINIO_TPU_LOGGER_WEBHOOK_AUTH_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    for mod in LOG.values():
        monkeypatch.setattr(mod, "RETRY_BACKOFF_S", 0.02)
    _reset_logs()
    for mod in (jbs, pbs):
        mod.reset()
    yield monkeypatch
    _reset_logs()
    for mod in (jbs, pbs):
        mod.reset()


class Receiver:
    """A loopback webhook: keeps every POSTed JSON document and its
    Authorization header; the first ``fail_first`` POSTs answer 500."""

    def __init__(self, fail_first: int = 0):
        self.docs: list = []
        self.auth: list = []
        self.fail_left = fail_first
        self.lock = threading.Lock()
        rx = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                data = self.rfile.read(int(self.headers["Content-Length"]))
                with rx.lock:
                    failing = rx.fail_left > 0
                    rx.fail_left -= failing
                    if not failing:
                        rx.docs.append(json.loads(data))
                        rx.auth.append(self.headers.get("Authorization"))
                self.send_response(500 if failing else 200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_port}/audit"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _counters(pkg: str, kind: str) -> dict:
    out = {}
    for key, v in MX[pkg].counters_snapshot().items():
        if key.startswith(("minio_tpu_log_target_", "minio_tpu_log_pubsub")) \
                and (f'target="{kind}"' in key or "pubsub" in key):
            out[key] = v
    return out


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def _drain(target, want: int, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while target.sent + target.dropped < want:
        assert time.monotonic() < deadline, (target.sent, target.dropped)
        time.sleep(0.01)


def target_flow(pkg: str) -> dict:
    """One package's HTTPLogTarget: 5 entries to a receiver whose first
    POST fails (one retry lands it), then 3 to a dead endpoint (each
    dropped after its retry), then a full queue."""
    mod = LOG[pkg]
    out = {}
    rx = Receiver(fail_first=1)
    before = _counters(pkg, "audit")
    t = mod.HTTPLogTarget(rx.url, auth_token="tok", kind="audit")
    try:
        for i in range(5):
            t.enqueue({"n": i, "pkg": "same"})
        _drain(t, 5)
        out["live"] = (t.sent, t.dropped, t.retries,
                       sorted(d["n"] for d in rx.docs), set(rx.auth))
    finally:
        t.stop()
        rx.close()
    dead = mod.HTTPLogTarget(rx.url, kind="audit")
    try:
        for i in range(3):
            dead.enqueue({"n": i})
        _drain(dead, 3)
        out["dead"] = (dead.sent, dead.dropped, dead.retries)
    finally:
        dead.stop()
    full = mod.HTTPLogTarget(rx.url, maxsize=2, kind="audit")
    full.stop()  # the sender is gone: the queue only fills
    for i in range(5):
        full.enqueue({"n": i})
    out["full"] = (full.dropped, full.q.qsize())
    out["counters"] = _delta(before, _counters(pkg, "audit"))
    return out


def test_webhook_target_sends_retries_and_counts_drops_as_jax():
    got = {pkg: target_flow(pkg) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["live"] == (5, 0, 1, [0, 1, 2, 3, 4], {"Bearer tok"})
    assert port["dead"] == (0, 3, 3)
    assert port["full"] == (3, 2)
    assert port["counters"] == {
        'minio_tpu_log_target_sent_total{target="audit"}': 5,
        'minio_tpu_log_target_dropped_total{reason="send_failed",'
        'target="audit"}': 3,
        'minio_tpu_log_target_dropped_total{reason="queue_full",'
        'target="audit"}': 3}


def test_console_ring_dedup_and_pubsub_drops_match_jax():
    got = {}
    for pkg, mod in LOG.items():
        before = _counters(pkg, "")
        ls = mod.LogSys()
        sub = ls.pubsub.subscribe()
        for _ in range(3):
            ls.log_once("k1", "warning", "scanner", "scan cycle failed")
        ls.event("error", "fault", "bad KVS rule 'x'", rule="x")
        ls.audit({"request_id": "r1", "api": "s3.getobject"})
        audit = [sorted(e) for e in ls.audit_ring]
        # a slow subscriber: its queue holds 1024 of the 1,033 entries
        # (the two log events and the audit ones), the 9 others drop
        for i in range(1030):
            ls.audit({"request_id": f"r{i}"})
        ring = [{k: v for k, v in e.items() if k != "time"}
                for e in ls.ring]
        got[pkg] = (ring, audit, len(ls.audit_ring), sub.qsize(),
                    _delta(before, _counters(pkg, "")))
        ls.pubsub.unsubscribe(sub)
        ls.stop()
    assert got["port"] == got["jax"]
    ring, audit, n_audit, queued, counters = got["port"]
    assert [e["message"] for e in ring] == ["scan cycle failed",
                                            "bad KVS rule 'x'"]
    assert audit[0] == ["api", "deploymentid", "request_id", "time", "type",
                        "version"]
    assert n_audit == 512 and queued == 1024
    assert counters == {
        'minio_tpu_log_pubsub_dropped_total{stream="audit"}': 9}


def audit_script(s):
    """Signed requests on one server; returns the request ids answered."""
    c = s.cl
    rids = []
    for r in (c.put_bucket("auditb"),
              c.put_object("auditb", "o", body(2000)),
              c.get_object("auditb", "o"),
              c.get_object("auditb", "nope"),
              c.request("GET", "/auditb", query={"list-type": "2"}),
              c.head_object("auditb", "o"),
              c.delete_object("auditb", "o"),
              c.request("GET", "/minio/admin/v3/info")):
        rids.append(r.headers["x-amz-request-id"])
    return rids


def test_audit_entries_of_one_script_match_jax(fresh, tmp_path):
    """Both servers leave one audit entry per request with the same keys
    and outcome, each joined to its request by ``request_id``, and POST
    each to the audit webhook with none dropped."""
    got = {}
    for pkg in ("jax", "port"):
        rx = Receiver()
        fresh.setenv("MINIO_TPU_AUDIT_WEBHOOK_ENDPOINT", rx.url)
        _reset_logs()
        s = Server(pkg, tmp_path / pkg)
        try:
            rids = audit_script(s)
            ls = LOG[pkg].log_sys()
            deadline = time.monotonic() + 10
            while len(rx.docs) < len(rids) or len(ls.audit_ring) < \
                    len(rids):
                assert time.monotonic() < deadline, len(rx.docs)
                time.sleep(0.01)
            ring = list(ls.audit_ring)
            sent = ls.audit_target.sent
            dropped = ls.audit_target.dropped
        finally:
            s.close()
            rx.close()
        assert [e["request_id"] for e in ring] == rids
        assert sorted(d["request_id"] for d in rx.docs) == sorted(rids)
        assert all(e["trace_id"] == e["request_id"] for e in ring)
        got[pkg] = {"keys": [sorted(e) for e in ring],
                    "what": [(e["api"], e["func"], e["method"], e["path"],
                              e["query"], e["status"], e["type"])
                             for e in ring],
                    "sent": sent, "dropped": dropped}
    assert got["port"] == got["jax"]
    assert got["port"]["sent"] == 8 and got["port"]["dropped"] == 0
    assert [w[0] for w in got["port"]["what"]] == [
        "s3.putbucket", "s3.putobject", "s3.getobject", "s3.getobject",
        "s3.listobjectsv2", "s3.headobject", "s3.deleteobject", "admin"]
