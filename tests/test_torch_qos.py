"""The port's QoS plane (minio_tpu_torch.qos: work classes, budgets,
admission control) held to the JAX package's (minio_tpu.qos): request
classification and the exempt planes over a table of method/path/query,
the token bucket's retry-after sequence at explicit times, the admission
gate's grants and counters, the class budgets' environment knobs, and
both S3 servers' ``503 SlowDown`` answer when their one admission slot is
held. Exact equality unless a test says otherwise."""
import os
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from s3client import S3Client  # noqa: E402

from minio_tpu import qos as jqos  # noqa: E402
from minio_tpu.qos import admission as jadm  # noqa: E402
from minio_tpu.qos import budget as jbudget  # noqa: E402
from minio_tpu_torch import qos as pqos  # noqa: E402
from minio_tpu_torch.qos import admission as padm  # noqa: E402
from minio_tpu_torch.qos import budget as pbudget  # noqa: E402

SEED = 20261017
AK, SK = "qosak", "qos-secret-key"

REQUESTS = [
    ("GET", "/b/o"), ("PUT", "/b/o"), ("HEAD", "/b/o"), ("POST", "/b/o"),
    ("DELETE", "/b/o"), ("PATCH", "/b/o"), ("GET", "/b/o?tagging"),
    ("PUT", "/b/dir/o?partNumber=1&uploadId=x"), ("GET", "/b"),
    ("GET", "/b/"), ("PUT", "/b"), ("GET", "/"), ("POST", "/"),
    ("GET", "/b?list-type=2&prefix=a"), ("POST", "/b?delete"),
    ("GET", "/minio/health/live"), ("GET", "/minio/health/ready"),
    ("GET", "/minio/metrics"), ("GET", "/minio/v2/metrics/node"),
    ("GET", "/minio/v2/metrics/cluster?attribution=1"),
    ("GET", "/minio/admin/v3/info"), ("GET", "/minio/admin/v3/trace"),
    ("POST", "/minio/webrpc"), ("GET", "/minio/upload/b/o"),
    ("GET", "/minio/storage/v1/read"), ("GET", "/minio/lock/v1/lock"),
    ("GET", "/minio"), ("GET", "/minio/"),
]


@pytest.mark.parametrize("method,path", REQUESTS)
@pytest.mark.parametrize("internal", [(), ("storage", "lock")])
def test_classify_request_and_plane_exempt_match(method, path, internal):
    assert padm.classify_request(method, path, internal) == \
        jadm.classify_request(method, path, internal)
    p = path.split("?", 1)[0]
    assert padm.plane_exempt(p, internal) == jadm.plane_exempt(p, internal)


@pytest.mark.parametrize("rate,burst", [(1.0, 8.0), (5.0, 10.0),
                                        (0.5, 8.0)])
def test_token_bucket_retry_after_sequence_matches(rate, burst):
    """The same takes at the same explicit times give the same waits
    (0.0 admitted, else the seconds to the next token), a clock behind
    the bucket's included; refunds alike."""
    rng = np.random.default_rng(SEED)
    t0 = 1000.0
    times = t0 + np.concatenate([[-1.0], np.cumsum(
        rng.exponential(1.0 / (2 * rate), 80))])
    jb, pb = jadm.TokenBucket(rate, burst), padm.TokenBucket(rate, burst)
    jb.t = pb.t = t0
    for i, now in enumerate(times):
        assert pb.take(now=float(now)) == jb.take(now=float(now))
        if i % 13 == 0:
            jb.refund()
            pb.refund()
        assert pb.tokens == jb.tokens


def test_admission_grants_and_counters_match():
    """Capacity 2 with no wait: the same grants, reasons and retry hints
    for the same admits and releases, and the same counters; a waiter-free
    reject keeps the class's rate token."""
    out = []
    for adm in (jadm.AdmissionController(max_requests=2, max_wait_s=0.0,
                                         rates={"control": 0.5}),
                padm.AdmissionController(max_requests=2, max_wait_s=0.0,
                                         rates={"control": 0.5})):
        held, trace = [], []
        for i, cls in enumerate(["interactive", "interactive",
                                 "interactive", "control", "interactive",
                                 "control"] * 2 + ["control"] * 10):
            g = adm.admit(cls)
            trace.append((g.ok, g.cls, g.reason, g.retry_after_s > 0,
                          adm.retry_after_header(g) if not g.ok else ""))
            if g.ok:
                held.append(g)
            if i % 3 == 2 and held:
                adm.release(held.pop(0))
        st = adm.stats()
        out.append((trace, {k: st[k] for k in (
            "max_requests", "inflight_total", "inflight", "admitted",
            "rejected")}))
    assert out[1] == out[0]


def test_class_budgets_follow_the_environment(monkeypatch):
    for env in ("MINIO_TPU_QOS_INTERACTIVE_BUDGET_MS",
                "MINIO_TPU_QOS_BACKGROUND_BUDGET_MS"):
        monkeypatch.delenv(env, raising=False)
    for cls in ("interactive", "background", "control"):
        assert pbudget.budget_s(cls) == jbudget.CostModel.budget_s(cls)
    monkeypatch.setenv("MINIO_TPU_QOS_INTERACTIVE_BUDGET_MS", "250")
    monkeypatch.setenv("MINIO_TPU_QOS_BACKGROUND_BUDGET_MS", "bad")
    for cls in ("interactive", "background", "control"):
        assert pbudget.budget_s(cls) == jbudget.CostModel.budget_s(cls)
    assert (pbudget.budget_s("interactive"),
            pbudget.budget_s("background")) == (0.25, 5.0)


def test_work_class_and_stream_contexts():
    """The class and the stream ride context variables, nested blocks
    restore the outer values, and the names are the JAX package's."""
    assert (pqos.CLASS_INTERACTIVE, pqos.CLASS_BACKGROUND,
            pqos.STREAM_BULK, pqos.STREAM_INTERACTIVE) == \
        (jqos.CLASS_INTERACTIVE, jqos.CLASS_BACKGROUND, jqos.STREAM_BULK,
         jqos.STREAM_INTERACTIVE)
    assert pqos.current_class() == "interactive"
    with pqos.background():
        assert pqos.current_class() == "background"
        with pqos.work_class("interactive"):
            assert pqos.current_class() == "interactive"
        assert pqos.current_class() == "background"
    assert pqos.current_stream() is None
    with pqos.device_stream(pqos.STREAM_INTERACTIVE):
        assert pqos.current_stream() == "interactive"
    assert pqos.current_stream() is None


def _server(pkg: str, root):
    if pkg == "port":
        from minio_tpu_torch.objectlayer import ErasureObjects
        from minio_tpu_torch.server import S3Server
        from minio_tpu_torch.storage import XLStorage
        obj = ErasureObjects([XLStorage(str(root / f"d{i}"))
                              for i in range(4)], default_parity=1,
                             block_size=1 << 16, device="cpu")
        srv = S3Server(obj, "127.0.0.1", 0, access_key=AK, secret_key=SK,
                       device="cpu", max_requests=1)
    else:
        from minio_tpu.objectlayer import ErasureObjects
        from minio_tpu.server import S3Server
        from minio_tpu.storage import XLStorage
        obj = ErasureObjects([XLStorage(str(root / f"d{i}"))
                              for i in range(4)], default_parity=1,
                             block_size=1 << 16)
        srv = S3Server(obj, "127.0.0.1", 0, access_key=AK, secret_key=SK,
                       max_requests=1)
    srv.start_background()
    return srv


def test_both_servers_answer_the_same_slowdown(tmp_path, monkeypatch):
    """One admission slot, held by a grant the test keeps: an object GET
    on either server waits its bounded wait and gets the same 503
    SlowDown error XML (request ids masked) and a Retry-After;
    the metrics plane stays exempt and counts the reject; after the slot
    frees the GET is served."""
    import requests
    monkeypatch.setenv("MINIO_TPU_QOS_MAX_WAIT_MS", "5")
    answers = {}
    for pkg in ("jax", "port"):
        srv = _server(pkg, tmp_path / pkg)
        try:
            c = S3Client(srv.endpoint(), AK, SK)
            assert c.request("PUT", "/qb").status_code == 200
            assert c.request("PUT", "/qb/o", body=b"q" * 1000).status_code \
                == 200
            hold = srv.qos_admission.admit("interactive")
            assert hold.ok
            try:
                r = c.request("GET", "/qb/o")
                m = requests.get(srv.endpoint() + "/minio/v2/metrics/node",
                                 timeout=30)
            finally:
                srv.qos_admission.release(hold)
            assert m.status_code == 200
            assert b"minio_tpu_qos_admission_rejects_total" in m.content
            body = re.sub(rb"<RequestId>[0-9a-f]+</RequestId>",
                          b"<RequestId/>", r.content)
            answers[pkg] = (r.status_code, r.headers["Retry-After"],
                            r.headers["Content-Type"], body,
                            srv.qos_admission.stats()["rejected"])
            ok = c.request("GET", "/qb/o")
            assert ok.status_code == 200 and ok.content == b"q" * 1000
        finally:
            srv.shutdown()
    assert answers["port"] == answers["jax"]
    status, retry, _, body, rejected = answers["port"]
    assert status == 503 and int(retry) >= 1
    assert b"<Code>SlowDown</Code>" in body
    assert rejected == {"interactive": 1}


def _expect_put(srv, path: str, body: bytes):
    """A PUT with ``Expect: 100-continue`` over a raw socket: the headers,
    then the server's first answer before any body byte is sent; the body
    only after a 100. Returns (first status line, the refusal's bytes or
    the final status line)."""
    import socket
    c = S3Client(srv.endpoint(), AK, SK)
    host = srv.endpoint().split("//", 1)[1]
    h = {"host": host}
    h["authorization"] = c.signer.sign_request(AK, SK, "PUT", path, {}, h)
    h.update({"content-length": str(len(body)), "expect": "100-continue"})
    with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
        s.sendall((f"PUT {path} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in h.items()) + "\r\n").encode())
        f = s.makefile("rb")
        first = f.readline()
        if b" 100 " not in first:
            return first, first + f.read()
        while f.readline() not in (b"\r\n", b""):
            pass
        s.sendall(body)
        return first, f.readline()


def test_expect_continue_waits_for_admission(tmp_path, monkeypatch):
    """A refused PUT that asks ``Expect: 100-continue`` gets its 503
    SlowDown, Retry-After and ``Connection: close`` before its client
    sends the body; an admitted one gets the 100 and is stored."""
    monkeypatch.setenv("MINIO_TPU_QOS_MAX_WAIT_MS", "5")
    srv = _server("port", tmp_path)
    try:
        c = S3Client(srv.endpoint(), AK, SK)
        assert c.request("PUT", "/eb").status_code == 200
        body = b"e" * (3 << 20)
        hold = srv.qos_admission.admit("interactive")
        try:
            first, resp = _expect_put(srv, "/eb/o", body)
        finally:
            srv.qos_admission.release(hold)
        assert first.startswith(b"HTTP/1.1 503")
        assert b"<Code>SlowDown</Code>" in resp
        assert b"Retry-After: 1" in resp and b"Connection: close" in resp
        first, resp = _expect_put(srv, "/eb/o", body)
        assert first.startswith(b"HTTP/1.1 100") and \
            resp.startswith(b"HTTP/1.1 200")
        assert c.request("GET", "/eb/o").content == body
    finally:
        srv.shutdown()
