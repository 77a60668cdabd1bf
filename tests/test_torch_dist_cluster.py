"""Clusters of the port's distributed plane on the CPU, held to the JAX
package's: a port 2-node cluster and a JAX one take the same requests
(ids and times pinned per module) and leave byte-identical trees; a mixed
cluster (node 0 JAX, node 1 port) writes through one node and reads and
heals through the other, in both directions; IAM and bucket metadata
propagate between port nodes; the admin ``?peers=1`` fan-outs answer with
the JAX server's keys; dsync locks are cluster-wide (node chaos:
tests/test_torch_dist_chaos.py). Small sizes: 2 nodes
x 3 disks, objects of a few hundred KiB (the CPU queue's plain
HighwayHash costs ~0.2 s a flush)."""
import io
import os
import shutil
import socket
import threading
import time

import numpy as np
import pytest

from minio_tpu import fault as jfault
from minio_tpu.dist.harness import LocalCluster as JCluster
from minio_tpu.dist.node import Node as JNode
from minio_tpu.madmin import AdminClient as JAdmin
from minio_tpu_torch import fault as pfault
from minio_tpu_torch.dist.harness import LocalCluster as PCluster
from minio_tpu_torch.dist.node import Node as PNode
from minio_tpu_torch.madmin import AdminClient as PAdmin
from s3client import S3Client
from test_torch_objectlayer import Pin, tree

AK = SK = "minioadmin"
SEED = 20261019
SIZES = (0, 1000, 100 << 10, 300 << 10)


def body(size: int, tag: int = 0) -> bytes:
    return np.random.default_rng(SEED + size + tag).bytes(size)


def detach_config(layers) -> None:
    """Both packages' config registries are process-global and attach to
    the first object layer a server hands them: a shut-down cluster's
    layer must not stay behind for the tests that run after these."""
    from minio_tpu.config import kvs as jkvs
    from minio_tpu_torch.config import kvs as pkvs
    for kvs in (jkvs, pkvs):
        cfg = kvs._global
        if cfg is not None and any(cfg.obj is o for o in layers):
            cfg.obj = None


def wait_until(fn, timeout: float = 20.0, msg: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """A JAX and a port 2 x 3 cluster (one 6-drive set at 3+3), each
    in this process on its own localhost ports."""
    root = tmp_path_factory.mktemp("clusters")
    jfault.clear()
    pfault.clear()
    out = {"jax": JCluster(str(root / "jax"), nodes=2, disks_per_node=3,
                           parity=None),
           "port": PCluster(str(root / "port"), nodes=2, disks_per_node=3,
                            parity=None, device="cpu")}
    yield out
    for c in out.values():
        c.shutdown()
    detach_config([n.obj for c in out.values() for n in c.nodes])


def _bucket_tree(cluster, bucket: str) -> dict:
    out = {}
    for ni in range(cluster.n):
        for di in range(3):
            base = os.path.join(cluster.root, f"n{ni}", f"d{di}")
            for k, v in tree(os.path.join(base, bucket)).items():
                out[f"n{ni}/d{di}/{k}"] = v
    return out


def test_two_node_trees_match_the_jax_cluster(clusters, monkeypatch):
    """The same PUTs through node 0 and deletes through node 1 leave the
    same bytes on every drive of both clusters; node 1 reads what node 0
    wrote."""
    pin = Pin(monkeypatch)
    results = {}
    for pkg, lc in clusters.items():
        pin.reset()
        ol0, ol1 = lc.nodes[0].obj, lc.nodes[1].obj
        ol0.make_bucket("same")
        etags = []
        for i, size in enumerate(SIZES):
            data = body(size, i)
            oi = ol0.put_object("same", f"dir/o{i}", io.BytesIO(data),
                                len(data))
            etags.append(oi.etag)
            assert ol1.get_object_bytes("same", f"dir/o{i}") == data
        ol1.delete_object("same", "dir/o1")
        names = [o.name for o in ol1.list_objects("same").objects]
        results[pkg] = (etags, names, _bucket_tree(lc, "same"))
    assert results["jax"][:2] == results["port"][:2]
    assert results["jax"][2] == results["port"][2]
    assert len(results["port"][2]) >= 6 * 2


def test_iam_and_bucket_metadata_propagate(clusters):
    """A user added on node 0 signs requests on node 1 at once, and is
    refused there once removed; a bucket metadata update on node 0
    invalidates node 1's cached record."""
    n0, n1 = clusters["port"].nodes
    c_root = S3Client(n0.server.endpoint(), AK, SK)
    assert c_root.request("PUT", "/iamsync").status_code == 200
    n0.server.iam.add_user("synceduser", "syncedsecret99",
                           policies=["readwrite"])
    c_new = S3Client(n1.server.endpoint(), "synceduser", "syncedsecret99")
    wait_until(lambda: c_new.request("GET", "/iamsync").status_code == 200,
               msg="user on node 1")
    n0.server.iam.remove_user("synceduser")
    wait_until(lambda: c_new.request("GET", "/iamsync").status_code == 403,
               msg="user gone on node 1")
    assert not n1.bucket_meta.get("iamsync").versioning_enabled
    n0.bucket_meta.update("iamsync", versioning_enabled=True)
    wait_until(lambda: n1.bucket_meta.get("iamsync").versioning_enabled,
               msg="metadata on node 1")


def test_cluster_locks_are_shared(clusters):
    n0, n1 = clusters["port"].nodes
    m0 = n0.ns_lock.new_lock("b", "o")
    assert m0.get_lock(timeout=2)
    m1 = n1.ns_lock.new_lock("b", "o")
    assert not m1.get_lock(timeout=0.5)
    m0.unlock()
    assert m1.get_lock(timeout=2)
    m1.unlock()
    admin = PAdmin(n0.server.endpoint(), AK, SK)
    m1 = n1.ns_lock.new_lock("b", "held")
    assert m1.get_lock(timeout=2)
    try:
        locks = admin._json("GET", "top/locks", {"peers": "1"})
        held = [e for e in locks["locks"] if e["resource"] == "b/held"]
        assert len(held) == 2 and {e["owner"] for e in held} == {n1.local_url}
    finally:
        m1.unlock()


@pytest.mark.parametrize("op,query,path", [
    ("health", {}, ("cluster",)),
    ("bucketstats", {"peers": "1"}, ("nodes",)),
    ("device", {"peers": "1"}, ("nodes",)),
    ("profile", {"peers": "1"}, ("nodes",)),
    ("replication", {"peers": "1"}, ("peers",)),
    ("bandwidth", {"peers": "1"}, ()),
    ("top/locks", {"peers": "1"}, ("locks",)),
    ("bg-heal-status", {}, ("peers",)),
], ids=["health", "bucketstats", "device", "profile", "replication",
        "bandwidth", "toplocks", "bgheal"])
def test_admin_peer_fanouts_answer_with_the_jax_keys(clusters, op, query,
                                                     path):
    """Each ``?peers=1`` fan-out reaches the other node: the same
    top-level keys as the JAX cluster's answer, one row per node where
    the JAX server gives one, and the same keys under the fanned-out
    part (the health rollup, a peer's health row)."""
    answers = {}
    for pkg, lc in clusters.items():
        admin = (JAdmin if pkg == "jax" else PAdmin)(
            lc.nodes[0].server.endpoint(), AK, SK)
        answers[pkg] = admin._json("GET", op, query)
    j, p = answers["jax"], answers["port"]
    assert sorted(j) == sorted(p) or op in ("device", "profile")
    for key in path:
        j, p = j[key], p[key]
    if isinstance(j, list):
        assert len(j) == len(p)
        if op in ("bucketstats", "device", "profile"):
            assert [("error" in x, bool(x.get("endpoint"))) for x in j] == \
                [("error" in x, bool(x.get("endpoint"))) for x in p]
        elif op != "top/locks":
            assert sorted(j[0]) == sorted(p[0])
    elif isinstance(j, dict):
        assert sorted(j) == sorted(p)
    if op == "health":
        rows = {pkg: answers[pkg]["nodes"][0]["peers"]["rows"]
                for pkg in answers}
        assert len(rows["jax"]) == len(rows["port"]) == 1
        assert sorted(rows["jax"][0]) == sorted(rows["port"][0])
        assert len(answers["port"]["nodes"]) == 2


def test_trace_tree_merges_peer_fragments(clusters, monkeypatch):
    """A kept trace of a PUT through node 0 includes the storage RPC
    fragments node 1 recorded under the caller's trace id."""
    from minio_tpu_torch.obs import spans
    monkeypatch.setenv("MINIO_TPU_QOS_INTERACTIVE_BUDGET_MS", "0.0001")
    from minio_tpu_torch.qos import budget
    budget._cfg_cache.clear()
    lc = clusters["port"]
    c0 = S3Client(lc.nodes[0].server.endpoint(), AK, SK)
    c0.request("PUT", "/traced")
    r = c0.request("PUT", "/traced/obj", body=body(50 << 10))
    assert r.status_code == 200
    rid = r.headers["x-amz-request-id"]
    admin = PAdmin(lc.nodes[0].server.endpoint(), AK, SK)
    wait_until(lambda: spans.store().get(rid) is not None, msg="kept")
    t = admin._json("GET", "trace", {"trace_id": rid, "peers": "1"})
    names = {s["name"] for s in t["spans"]}
    assert any(n.startswith("rpc.storage.") for n in names), names
    frag_nodes = {s["attrs"].get("node") for s in t["spans"]
                  if s["name"].startswith("rpc.storage.")
                  and s["attrs"].get("node")}
    assert f"127.0.0.1:{lc.ports[1]}" in frag_nodes
    budget._cfg_cache.clear()


# --- a mixed cluster ---------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Node 0 of the JAX package and node 1 of the port, one 6-drive set
    over both."""
    root = tmp_path_factory.mktemp("mixed")
    ports = [_free_port(), _free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    args = []
    for ni in range(2):
        for di in range(3):
            d = root / f"n{ni}" / f"d{di}"
            d.mkdir(parents=True)
            args.append(f"{urls[ni]}{d}")
    common = dict(address="127.0.0.1", access_key=AK, secret_key=SK,
                  default_parity=None)
    nodes = [JNode(args, local_url=urls[0], port=ports[0], **common),
             PNode(args, local_url=urls[1], port=ports[1], device="cpu",
                   **common)]
    errs = []

    def boot(n):
        try:
            n.start(wait_format_timeout=60)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    ths = [threading.Thread(target=boot, args=(n,)) for n in nodes]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=120)
    assert not errs and all(n.obj is not None for n in nodes), errs
    yield {"jax": nodes[0], "port": nodes[1], "root": root}
    for n in nodes:
        n.shutdown()
    detach_config([n.obj for n in nodes])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mixed_cluster_put_get_heal(mixed, writer):
    """PUT through one package's node, GET through the other's; one of the
    writer's drives loses the bucket, and the other node heals it back
    over the storage RPC, byte for byte."""
    reader = "port" if writer == "jax" else "jax"
    w, r = mixed[writer], mixed[reader]
    bucket = f"mx-{writer}"
    w.obj.make_bucket(bucket)
    data = {f"o{i}": body(size, 7 + i)
            for i, size in enumerate((200 << 10, 300 << 10, 10))}
    for name, b in data.items():
        w.obj.put_object(bucket, name, io.BytesIO(b), len(b))
    for name, b in data.items():
        assert r.obj.get_object_bytes(bucket, name) == b
    disk = list(w.local_disks.values())[0]
    base = getattr(disk, "root", None) or disk.base
    before = tree(os.path.join(base, bucket))
    assert before
    shutil.rmtree(os.path.join(base, bucket))
    r.obj.heal_bucket(bucket)
    for name in data:
        res = r.obj.heal_object(bucket, name)
        assert "missing" in res.before_state, res.before_state
        assert res.after_state.count("ok") == 6, res.after_state
    assert tree(os.path.join(base, bucket)) == before
    for name, b in data.items():
        assert w.obj.get_object_bytes(bucket, name) == b


def test_mixed_cluster_iam_crosses_packages(mixed):
    """A user added through the JAX node authenticates on the port node
    (the peer RPC reload and the shared state document)."""
    mixed["jax"].server.iam.add_user("mixuser", "mixsecret123",
                                     policies=["readwrite"])
    c = S3Client(mixed["port"].server.endpoint(), "mixuser",
                 "mixsecret123")
    wait_until(lambda: c.request("GET", "/").status_code == 200,
               msg="user on the port node")


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_peer_rpc_across_packages(clusters, client_pkg):
    """Each package's peer client interrogates the other package's node:
    the control plane's answers have the same keys as the answers of the
    node's own package's client, and the live trace stream (chunked
    NDJSON with keep-alive newlines) delivers an event as it happens."""
    from minio_tpu.dist.peer import PeerRESTClient as JPeer
    from minio_tpu_torch.dist.peer import PeerRESTClient as PPeer
    target = clusters["jax" if client_pkg == "port" else "port"]
    url = target.urls[1]
    cls = PPeer if client_pkg == "port" else JPeer
    same = JPeer if client_pkg == "port" else PPeer
    mine, theirs = cls(url, SK), same(url, SK)
    for call in (lambda p: p.server_info(),
                 lambda p: p.background_heal_status(),
                 lambda p: p.get_bandwidth(),
                 lambda p: p.replication_stats()):
        assert sorted(call(mine)) == sorted(call(theirs))
    assert mine.get_local_disk_ids() == theirs.get_local_disk_ids()
    assert mine.get_locks() == [] and isinstance(mine.console_log(5), list)
    assert mine.verify_config(target.nodes[1].layout_fingerprint())
    assert not mine.verify_config({"endpoints": [], "sets": 1})
    assert isinstance(mine.metrics(), dict)
    assert mine.trace_tree("no-such-trace") == {}
    got = []
    reader = threading.Thread(target=lambda: got.extend(
        mine.trace_stream(timeout_s=10, count=1)))
    reader.start()
    c = S3Client(target.endpoint(1), AK, SK)
    deadline = time.monotonic() + 10
    while not got and time.monotonic() < deadline:
        c.request("GET", "/")
        time.sleep(0.05)
    reader.join(timeout=20)
    assert not reader.is_alive() and got and got[0]["func"]
