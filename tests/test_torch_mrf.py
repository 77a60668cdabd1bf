"""The port's MRF heal queue (minio_tpu_torch.scanner.mrf over
park.DebtQueue, wired by ``S3Server.start_background_services``) held to
the JAX package's (minio_tpu.scanner.mrf, wired as its server wires it):
the same queue operations leave the same journal, ``mrf.json`` written by
either package is recovered by the other, and a degraded or bitrot-hit GET
over HTTP queues the same item on both servers, whose background heal
leaves the same files — the undamaged ones."""
import json
import os
import shutil
import time

import pytest

from minio_tpu.scanner import mrf as jmrf
from minio_tpu.scanner import park as jpark
from minio_tpu_torch.objectlayer.metadata import hash_order
from minio_tpu_torch.scanner import mrf as pmrf
from minio_tpu_torch.scanner import park as ppark
from test_torch_objectlayer import tree
from test_torch_s3server import N, Server, body, pinned  # noqa: F401


def _queue_ops(mod, path):
    """One script of DebtQueue calls; returns what it observed and the
    journal it left."""
    dq = mod.DebtQueue(max_queue=4)
    seen = [dq.attach_persistence(path)]
    for i, mode in enumerate(("normal", "deep", "normal", "normal")):
        dq.add("b", f"o{i % 3}", "", mode=mode)
    dq.add("b", "o1", "v1", mode="normal")    # a fifth: drop-oldest
    dq.add("b", "o3", "", mode="deep")
    seen.append(dq.stats())
    first = dq.pop(timeout=0.1)
    seen.append(first)
    dq.park(first[:4], 1, 0.0, 0.0)
    dq.kick()
    seen.append(dq.queued(tuple(first[:3])))
    dq.flush(force=True)
    with open(path, "rb") as f:
        journal = f.read()
    while (e := dq.pop(timeout=0.05)) is not None:
        seen.append(e)
        dq.settle(tuple(e[:3]))
    dq.flush(force=True)
    seen.append(dq.stats())
    with open(path, "rb") as f:
        return seen, journal, f.read()


def test_debt_queue_matches(tmp_path):
    want = _queue_ops(jpark, str(tmp_path / "jax" / "mrf.json"))
    got = _queue_ops(ppark, str(tmp_path / "port" / "mrf.json"))
    assert got == want
    assert want[0][1]["dropped"] == 2
    assert json.loads(want[1])["entries"]


@pytest.mark.parametrize("writer,reader", [(jmrf, pmrf), (pmrf, jmrf)])
def test_mrf_json_round_trips(tmp_path, writer, reader):
    path = str(tmp_path / ".minio.sys" / "mrf.json")
    items = [("b", "x", "", "normal"), ("b", "y/z", "v-1", "deep"),
             ("c", "é", "", "normal"), ("b", "x", "", "deep")]
    w = writer.MRFHealer(None)
    w.attach_persistence(path)
    for b, o, v, mode in items:
        w.add_partial(b, o, v, scan_mode=mode)
    w.flush_journal()
    r = reader.MRFHealer(None)
    assert r.attach_persistence(path) == 3  # the journal keys dedupe
    got = sorted(r.q.queue)
    assert got == sorted([("b", "x", "", "deep"), ("b", "y/z", "v-1", "deep"),
                          ("c", "é", "", "normal")])
    r.flush_journal()
    with open(path, "rb") as f:
        doc = json.load(f)
    assert sorted(map(json.dumps, doc["entries"])) == sorted(
        json.dumps({"bucket": b, "object": o, "version_id": v,
                    "scan_mode": m}) for b, o, v, m in got)


def wait_for(cond, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def _wire(s: Server):
    """The MRF behind a server's erasure set, as each package's server
    wires it (the JAX one's start_background_services also starts the
    scanner and auto-heal, which write files of their own): returns the
    healer and the list of on_partial calls it received."""
    calls = []
    if s.pkg == "port":
        s.srv.start_background_services()
        mrf = s.srv.mrf
        layer = s.srv.obj
        assert layer.on_partial == mrf.add_partial
    else:
        mrf = jmrf.MRFHealer(s.srv.obj)
        mrf.attach_persistence(os.path.join(s.root, "d00", ".minio.sys",
                                            "mrf.json"))
        mrf.start()
        layer = s.srv.obj
    add = mrf.add_partial

    def record(bucket, object, version_id="", scan_mode="normal"):
        calls.append((bucket, object, version_id, scan_mode))
        add(bucket, object, version_id, scan_mode=scan_mode)

    layer.on_partial = record
    return mrf, calls


def _damage(root: str, scenario: str) -> None:
    """Drop, or flip one byte of, the shard data shard 1 of b/o lives
    in: every GET reads it."""
    disk = os.path.join(root, f"d{hash_order('b/o', N).index(1):02d}")
    obj = os.path.join(disk, "b", "o")
    if scenario == "missing_shard":
        shutil.rmtree(obj)
        return
    ddir = next(e for e in os.listdir(obj) if e != "xl.meta")
    p = os.path.join(obj, ddir, "part.1")
    with open(p, "r+b") as f:
        f.seek(32 + 500)
        c = f.read(1)
        f.seek(32 + 500)
        f.write(bytes([c[0] ^ 0x5A]))


@pytest.mark.parametrize("scenario", ["missing_shard", "bitrot"])
def test_degraded_get_feeds_the_same_heal(tmp_path, pinned, scenario):
    data = body(100_000, 7)
    result = {}
    for pkg in ("jax", "port"):
        pinned.reset()
        root = tmp_path / pkg
        s = Server(pkg, root)
        try:
            s.cl.put_bucket("b")
            assert s.cl.put_object("b", "o", data).status_code == 200
            s.cl.put_object("b", "keep", b"k" * 3000)
            original = tree(root)
            mrf, calls = _wire(s)
            _damage(str(root), scenario)
            r = s.cl.get_object("b", "o")
            assert r.status_code == 200 and r.content == data
            # the read signals after its last byte is out, and the worker
            # heals after it dequeues: wait for both
            wait_for(lambda: calls and mrf.healed + mrf.failed >= 1)
            mrf.stop()  # joins the worker, then writes the journal
            stats = {k: mrf.stats()[k] for k in ("healed", "failed",
                                                 "queued", "dropped")}
            with open(os.path.join(root, "d00", ".minio.sys", "mrf.json"),
                      "rb") as f:
                journal = f.read()
        finally:
            s.close()
        healed = tree(root)
        healed.pop(os.path.join("d00", ".minio.sys", "mrf.json"))
        assert healed == original, pkg
        result[pkg] = calls, stats, journal, healed
    mode = "deep" if scenario == "bitrot" else "normal"
    assert result["jax"][0] == [("b", "o", "", mode)]
    assert result["jax"][1] == {"healed": 1, "failed": 0, "queued": 0,
                                "dropped": 0}
    assert result["port"] == result["jax"]
