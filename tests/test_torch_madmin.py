"""The port's admin client (minio_tpu_torch.madmin.AdminClient, signed by
the port's server/auth.py over urllib) against both servers, and the JAX
package's client against the port's server, on the CPU: one script of
admin calls (the IAM ops, quota, config, bucket analytics, the audit log,
and the errors of a non-root caller and an op the port has not) gives
the same results on every pairing. The IAM modules' ``secrets`` and
``time`` are pinned, so service-account keys agree."""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from minio_tpu import madmin as jmadmin  # noqa: E402
from minio_tpu.config import kvs as jkvs  # noqa: E402
from minio_tpu.obs import bucketstats as jbs  # noqa: E402
from minio_tpu.obs import logger as jlog  # noqa: E402
from minio_tpu.qos import budget as jbudget  # noqa: E402
from minio_tpu_torch import madmin as pmadmin  # noqa: E402
from minio_tpu_torch.config import kvs as pkvs  # noqa: E402
from minio_tpu_torch.obs import bucketstats as pbs  # noqa: E402
from minio_tpu_torch.obs import logger as plog  # noqa: E402
from minio_tpu_torch.qos import budget as pbudget  # noqa: E402
from test_torch_iam import iam_pinned  # noqa: E402,F401
from test_torch_s3server import AK, SK, Server, body  # noqa: E402

CLIENTS = {"jax": jmadmin, "port": pmadmin}
POLICY = json.dumps({"Statement": [{
    "Effect": "Allow", "Action": ["s3:GetObject"],
    "Resource": "arn:aws:s3:::madb/*"}]}).encode()


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Empty bucket registries and log planes; each server gets its own
    config registry (the first server of a process attaches it)."""
    for mod in (jkvs, pkvs):
        monkeypatch.setattr(mod, "_global", None)
    for mod in (jbudget, pbudget):
        monkeypatch.setattr(mod, "_cfg_cache", {})
    for mod in (jbs, pbs):
        mod.reset()
    jlog._sys = None
    plog.reset()
    yield
    for mod in (jbs, pbs):
        mod.reset()
    jlog._sys = None
    plog.reset()


def _err(fn) -> tuple:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the client's error class
        return type(e).__name__, getattr(e, "status", None)
    return ("no error",)


def admin_script(mod, s) -> list:
    """The same admin calls through one package's client on one server."""
    ep = s.srv.endpoint()
    adm = mod.AdminClient(ep, AK, SK)
    assert s.cl.put_bucket("madb").status_code == 200
    assert s.cl.put_object("madb", "o", body(400)).status_code == 200
    out = []
    adm.add_user("alice", "alice-secret-1", ["readonly"])
    adm.add_user("bob", "bob-secret-12")
    out.append(("list users", adm.list_users()))
    adm.set_user_status("bob", "disabled")
    adm.add_canned_policy("madb-read", POLICY)
    adm.set_policy("bob", ["madb-read"])
    adm.set_policy("team", ["madb-read", "readonly"], group=True)
    out.append(("list users after", adm.list_users()))
    out.append(("policies", sorted(adm.list_canned_policies())))
    out.append(("service account", adm.add_service_account("alice")))
    out.append(("root service account", adm.add_service_account()))
    user = mod.AdminClient(ep, "alice", "alice-secret-1")
    out.append(("user by a user", _err(user.list_users)))
    out.append(("short secret", _err(
        lambda: adm.add_user("carol", "short"))))
    adm.remove_user("alice")
    out.append(("list users at the end", adm.list_users()))
    adm.set_bucket_quota("madb", 1 << 30)
    out.append(("quota", adm.get_bucket_quota("madb")))
    adm.set_config_kv("bucketstats", "top_n", "16")
    out.append(("config", adm.get_config()["bucketstats"]["top_n"]))
    adm.del_config_kv("bucketstats", "top_n")
    stats = adm.bucket_stats()
    out.append(("bucketstats", {
        b: (r["requests_total"], r["requests"], r["bytes_in"])
        for b, r in stats["buckets"].items()}))
    out.append(("bucketstats keys", sorted(stats)))
    # the S3 requests' entries (an admin call's entry lands after its
    # answer, so the newest ones may still be on their way)
    out.append(("audit", [(e["api"], e["status"]) for e in
                          adm.recent_logs(100, kind="audit")
                          if e["api"].startswith("s3.")]))
    out.append(("no trace", _err(lambda: adm.trace_tree("f" * 32))))
    return out


@pytest.mark.parametrize("pairing", ["port client, jax server",
                                     "jax client, port server"])
def test_admin_client_pairings_match(iam_pinned, tmp_path, pairing):
    client, server = [p.split()[0] for p in pairing.split(", ")]
    got = {}
    for label, (cl, srv) in (("port-port", ("port", "port")),
                             (pairing, (client, server))):
        iam_pinned()
        for mod in (jbs, pbs):
            mod.reset()
        jlog._sys = None
        plog.reset()
        jkvs._global = pkvs._global = None
        s = Server(srv, tmp_path / label.replace(", ", "-").replace(" ", "_"))
        try:
            s.srv.enable_iam()
            got[label] = admin_script(CLIENTS[cl], s)
        finally:
            s.close()
    assert got[pairing] == got["port-port"]
    rows = dict(got["port-port"])
    assert rows["user by a user"] == ("AdminError", 403)
    assert rows["no trace"] == ("AdminError", 404)
    assert rows["audit"] == [("s3.putbucket", 200), ("s3.putobject", 200)]
    assert rows["short secret"] == ("AdminError", 500)
    assert set(rows["list users at the end"]) == {"bob", rows[
        "root service account"]["accessKey"]}
    assert rows["bucketstats"]["madb"][0] == 2
    assert rows["quota"] == {"quota": 1 << 30, "quotatype": "hard"}
