"""The port's replication bandwidth plane (minio_tpu_torch.bucket.bandwidth)
held to the JAX package's: on one scripted clock the throttle grants the
same bytes per call, the monitor reports the same limits and rates, the
monitored reader reads and tracks alike; on the real clock a replication
through a throttled target stays inside the throttle's windows; the
admin ``bandwidth`` op answers the JAX server's report."""
import io
import json
import time
import types

import pytest

from minio_tpu.bucket import bandwidth as jbw
from minio_tpu_torch.bucket import bandwidth as pbw


class Clock:
    """A monotonic clock that moves ``step`` seconds per reading."""

    def __init__(self, step: float):
        self.t = 1000.0
        self.step = step

    def monotonic(self):
        self.t += self.step
        return self.t


@pytest.fixture
def clocks(monkeypatch):
    made = {}

    def pin(step: float):
        for name, mod in (("jax", jbw), ("port", pbw)):
            made[name] = Clock(step)
            monkeypatch.setattr(mod, "time", types.SimpleNamespace(
                monotonic=made[name].monotonic))
        return made

    return pin


@pytest.fixture(autouse=True)
def fresh_monitors(monkeypatch):
    """The process-wide monitors start and end empty (a bucket left in
    one would add bandwidth rows to later tests' scrapes)."""
    for mod in (jbw, pbw):
        monkeypatch.setattr(mod, "_monitor", None)


def _throttle_script(mod):
    t = mod.Throttle(1 << 20)  # 256 KiB per window
    out = [t.take(64 << 10) for _ in range(5)]
    t.release(100_000)
    out += [t.take(200_000), t.take(0), t.take(-5)]
    t.set_bandwidth(4 << 20)
    out += [t.take(3 << 20) for _ in range(3)]
    out.append(mod.Throttle(0).take(1 << 30))
    return out


def test_throttle_grants_match_jax(clocks):
    clocks(0.13)
    assert _throttle_script(pbw) == _throttle_script(jbw)


def _monitor_script(mod):
    mon = mod.Monitor()
    mon.throttle("a", 1 << 20)
    mon.throttle("a", 2 << 20)  # a changed limit updates it
    reports = [mon.report()]
    for n in (10_000, 50_000, 70_000, 1_000, 400_000, 5):
        mon.track("a", n)
        mon.track("b", n // 2)
        reports.append(mon.report())
    reports.append(mon.report(["b"]))
    mon.delete_bucket("a")
    reports.append(mon.report())
    return reports


def test_monitor_reports_match_jax(clocks):
    clocks(0.3)
    assert _monitor_script(pbw) == _monitor_script(jbw)


def _reader_script(mod):
    mon = mod.Monitor()
    src = io.BytesIO(bytes(range(256)) * 2000)
    r = mod.MonitoredReader(mon, "bkt", src, bytes_per_second=256_000,
                            total_size=512_000)
    chunks = []
    while True:
        b = r.read(100_000)
        if not b:
            break
        chunks.append(len(b))
    unsized = mod.MonitoredReader(mon, "other", io.BytesIO(b"x"))
    try:
        len(unsized)
        sized = "no error"
    except TypeError as e:
        sized = str(e)
    return chunks, len(r), sized, mon.report()


def test_monitored_reader_matches_jax(clocks):
    clocks(0.13)
    assert _reader_script(pbw) == _reader_script(jbw)


def test_global_monitor_is_one_per_process():
    assert pbw.global_monitor() is pbw.global_monitor()
    assert pbw.global_monitor() is not jbw.global_monitor()


def test_replication_stays_inside_the_throttle_windows(tmp_path):
    """A 1 MiB object replicated by the port's pool through a target
    throttled at 1 MiB/s: the bytes moved by any instant never pass one
    window's grant per window begun (``Throttle``'s own allowance), the
    replica is exact, and the monitor reports the limit."""
    import numpy as np
    from minio_tpu_torch.bucket.replication import ReplicationPool, S3Target
    from minio_tpu_torch.objectlayer import ErasureObjects
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.storage import XLStorage

    def layer(name):
        return ErasureObjects([XLStorage(str(tmp_path / f"{name}{i}"))
                               for i in range(4)], default_parity=1,
                              block_size=1 << 16, device="cpu")

    dst_obj = layer("dst")
    dst = S3Server(dst_obj, "127.0.0.1", 0, access_key="ak",
                   secret_key="sk-secret", device="cpu")
    dst.start_background()
    src_obj = layer("src")
    src_obj.make_bucket("rb")
    data = np.random.default_rng(5).bytes(1 << 20)
    src_obj.put_object("rb", "o", io.BytesIO(data), len(data))
    pool = ReplicationPool(src_obj, workers=1).start()
    reads: list = []
    orig = pbw.MonitoredReader.read

    def timed(self, n=-1):
        b = orig(self, n)
        reads.append((time.monotonic(), len(b)))
        return b

    try:
        pbw.MonitoredReader.read = timed
        tgt = S3Target(dst.endpoint(), "ak", "sk-secret", "rb",
                       bandwidth_limit=1 << 20)
        pool.set_target("rb", tgt)
        pool.schedule("rb", "o", "put")
        deadline = time.monotonic() + 60
        while pool.replicated + pool.failed < 1:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        pool.drain(timeout=30)
    finally:
        pbw.MonitoredReader.read = orig
        pool.stop()
        dst.shutdown()
    assert pool.replicated == 1 and pool.failed == 0
    assert dst_obj.get_object_bytes("rb", "o") == data
    per_window = int((1 << 20) * pbw.WINDOW_S)
    t0 = reads[0][0]
    moved = 0
    for t, n in reads:
        moved += n
        windows = int((t - t0) / pbw.WINDOW_S) + 1
        assert moved <= per_window * (windows + 1), (t - t0, moved)
    assert reads[-1][0] - t0 >= 2 * pbw.WINDOW_S
    rep = pbw.global_monitor().report()
    assert rep["bucketStats"]["rb"]["limitInBits"] == 1 << 20


def test_admin_bandwidth_report_matches_jax(tmp_path):
    """The admin op over both servers after the same throttle and
    traffic on each package's global monitor (rates pinned to 0 by an
    empty window): the same JSON, filtered alike by ``?buckets=``."""
    from test_torch_s3server import Server
    got = {}
    for pkg, mod in (("jax", jbw), ("port", pbw)):
        mon = mod.global_monitor()
        mon.throttle("b1", 8 << 20)
        mon.throttle("b2", 1 << 20)
        s = Server(pkg, tmp_path / pkg)
        try:
            c = s.cl
            got[pkg] = [
                (r.status_code, json.loads(r.content))
                for r in (c.request("GET", "/minio/admin/v3/bandwidth"),
                          c.request("GET", "/minio/admin/v3/bandwidth",
                                    query={"buckets": "b2,zz"}))]
        finally:
            s.close()
    assert got["port"] == got["jax"]
    assert got["port"][1][1] == {"bucketStats": {"b2": {
        "limitInBits": 1 << 20, "currentBandwidth": 0.0}}}
