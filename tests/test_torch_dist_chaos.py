"""Node chaos on the port's LocalCluster (3 nodes x 2 drives, 4+2):
an asymmetric partition blackholes one direction only and its gated
probe keeps the peer offline until the rule goes; a slow peer degrades
the health score with no disk error; a killed node is marked offline by
its peers, writes keep quorum, a dead owner's lock is reclaimed within
the lease, and the restarted node rejoins and serves what was written
while it was down. Waits are on events, with timeouts, never fixed
sleeps."""
import io
import time

import numpy as np
import pytest

from minio_tpu_torch import fault as pfault
from minio_tpu_torch.dist.harness import LocalCluster as PCluster
from minio_tpu_torch.utils import errors as perrors
from test_torch_dist_cluster import detach_config

SEED = 20261019


def body(size: int, tag: int = 0) -> bytes:
    return np.random.default_rng(SEED + size + tag).bytes(size)


def wait_until(fn, timeout: float = 20.0, msg: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    from minio_tpu_torch.dist import lock_rest, rpc
    mp = pytest.MonkeyPatch()
    # chaos-speed knobs: fast reconnect probing, fast lock leases
    mp.setattr(rpc, "HEALTH_MAX_INTERVAL_S", 1.0)
    mp.setattr(lock_rest, "LOCK_MAINTENANCE_INTERVAL_S", 0.25)
    mp.setenv("MINIO_TPU_HEALTH_COOLDOWN_S", "1")
    pfault.clear()
    lc = PCluster(str(tmp_path_factory.mktemp("chaos")), nodes=3,
                  disks_per_node=2, parity=2, device="cpu")
    first = [n.obj for n in lc.nodes]
    yield lc
    lc.shutdown()
    detach_config(first + [n.obj for n in lc.nodes])
    pfault.clear()
    mp.undo()


def _peer(node, url):
    return [p for p in node.peers if p.url == url][0]


def _peer_row(node, url):
    from minio_tpu_torch.obs.health import node_snapshot
    rows = node_snapshot(node.server)["peers"]["rows"]
    return [r for r in rows if r["url"] == url][0]


def test_partition_is_asymmetric_and_heals(chaos):
    from minio_tpu_torch.fault import node as fnode
    rid = fnode.partition(chaos.urls[1], chaos.urls[0])
    try:
        p01 = _peer(chaos.nodes[0], chaos.urls[1])
        with pytest.raises(perrors.StorageError):
            p01.server_info()
        p10 = _peer(chaos.nodes[1], chaos.urls[0])
        assert p10.server_info()["endpoint"] == chaos.urls[0]
        row = _peer_row(chaos.nodes[0], chaos.urls[1])
        assert row["degraded"] and not row["online"]
        # the gated probe keeps the peer offline while the rule stands
        assert not p01.is_online()
    finally:
        pfault.disarm(rid)
    wait_until(p01.is_online, msg="reconnect after disarm")


def test_slow_peer_degrades_health(chaos):
    from minio_tpu_torch.fault import node as fnode
    rid = fnode.slow_peer(chaos.urls[2], 700)
    p02 = _peer(chaos.nodes[0], chaos.urls[2])
    try:
        for _ in range(5):
            p02.server_info()
        row = _peer_row(chaos.nodes[0], chaos.urls[2])
        assert row["online"] and row["ewma_ms"] > 500 and row["degraded"]
    finally:
        pfault.disarm(rid)
    for _ in range(12):
        p02.server_info()
    assert not _peer_row(chaos.nodes[0], chaos.urls[2])["degraded"]


def test_kill_and_restart_a_node(chaos):
    """A killed node's peers mark it offline on their next call, writes
    keep quorum (4+2 over 3 nodes x 2 drives), a dead owner's lock is
    reclaimed, and the restarted node rejoins: its peers reconnect and
    it serves what was written while it was down."""
    n0 = chaos.nodes[0]
    n0.obj.make_bucket("chaos")
    m = chaos.nodes[2].ns_lock.new_lock("lk", "obj")
    assert m.get_lock(timeout=5)
    chaos.kill(2)
    data = body(120 << 10, 99)
    n0.obj.put_object("chaos", "during", io.BytesIO(data), len(data))
    p02 = _peer(n0, chaos.urls[2])
    with pytest.raises(perrors.StorageError):
        p02.server_info()
    assert not p02.is_online()
    wait_until(lambda: n0.local_locker.expired("lk/obj", m.uid),
               msg="dead-owner lock reclaim")
    node = chaos.restart(2)
    wait_until(p02.is_online, msg="peer reconnect")
    assert node.obj.get_object_bytes("chaos", "during") == data
    assert chaos.nodes[2] is node
