"""The port's heal plane (minio_tpu_torch.scanner.autoheal: the healing
tracker, the global healer, the auto-heal monitor; scanner.healseq and the
admin ops over them; the server's background services) held to the JAX
package's on numpy-made inputs: copies of one tree with one drive wiped
and its tracker set are healed by each package's monitor into
byte-identical trees, whichever package wrote the tracker; a resume from a
persisted marker skips what it should; both servers answer the admin
``heal``, ``datausageinfo`` and ``bg-heal-status`` ops alike apart from
timestamps and tokens, and their scrapes carry the heal plane's families
under the same names. Geometry: 4+2 with 64 KiB blocks, objects of tens of
KiB."""
import json
import os
import shutil
import threading

import pytest

from minio_tpu.scanner import autoheal as jah
from minio_tpu.scanner.scanner import DataScanner as JScanner
from minio_tpu.storage import XLStorage as JXLStorage
from minio_tpu_torch.scanner import autoheal as pah
from minio_tpu_torch.scanner.scanner import DataScanner
from minio_tpu_torch.storage import XLStorage
from test_torch_metrics import lint
from test_torch_scanner import PKGS, body, files, layer, no_time, put

MODS = {"jax": jah, "port": pah}
DISK = {"jax": JXLStorage, "port": XLStorage}
OBJECTS = {"gh": {f"p{i % 3}/o{i:02d}": 20_000 + 997 * i for i in range(10)},
           "gz": {"a": 70_000, "b/c": 3_000}}


def _write(root):
    ol = layer("port", root)
    for b, objs in OBJECTS.items():
        ol.make_bucket(b)
        for name, n in objs.items():
            put(ol, b, name, body(n))


@pytest.mark.parametrize("tracker_writer", PKGS)
def test_monitors_heal_a_wiped_drive_into_identical_trees(tmp_path,
                                                          tracker_writer):
    src = tmp_path / "src"
    _write(src)
    original = files(src)
    results = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        shutil.copytree(src, root)
        shutil.rmtree(root / "d03")
        ol = layer(pkg, root)
        victim = DISK[tracker_writer](str(root / "d03"))
        MODS[tracker_writer].set_healing_tracker(victim,
                                                 {"reason": "fresh-disk"})
        assert MODS[pkg].get_healing_tracker(ol.disks[3])["reason"] == \
            "fresh-disk"
        mon = MODS[pkg].AutoHealMonitor(ol, ol.disks, interval_s=9999)
        assert mon.check_and_heal() is True
        assert MODS[pkg].get_healing_tracker(ol.disks[3]) is None
        results[pkg] = (mon.healer.objects_healed, mon.healer.objects_failed,
                        mon.heal_passes)
        assert mon.check_and_heal() is False  # no tracker: nothing to do
    assert results["port"] == results["jax"] == (12, 0, 1)
    assert files(tmp_path / "port") == files(tmp_path / "jax") == original


@pytest.mark.parametrize("tracker_writer", PKGS)
def test_resume_from_a_persisted_marker(tmp_path, monkeypatch,
                                        tracker_writer):
    """A marker persisted by either package makes the port's next pass
    skip every object up to it; the clean remainder clears the tracker."""
    ol = layer("port", tmp_path)
    ol.make_bucket("hb")
    for i in range(12):
        put(ol, "hb", f"o{i:03d}", body(1000 + i))
    MODS[tracker_writer].set_healing_tracker(
        DISK[tracker_writer](str(tmp_path / "d00")),
        {"bucket": "hb", "object": "o007"})
    seen = []
    real = pah.GlobalHealer._heal_one

    def spy(self, bucket, name, scan_mode):
        seen.append(name)
        return real(self, bucket, name, scan_mode)

    monkeypatch.setattr(pah.GlobalHealer, "_heal_one", spy)
    mon = pah.AutoHealMonitor(ol, ol.disks, interval_s=9999)
    assert mon.check_and_heal() is True
    assert sorted(seen) == [f"o{i:03d}" for i in range(8, 12)]
    assert pah.get_healing_tracker(ol.disks[0]) is None


def test_interrupted_pass_persists_its_marker(tmp_path):
    """The progress callback writes the walk position into the tracker of
    every pending disk; the JAX package reads it."""
    ol = layer("port", tmp_path)
    ol.make_bucket("hb")
    for i in range(9):
        put(ol, "hb", f"o{i:03d}", body(800 + i))
    pah.set_healing_tracker(ol.disks[2])
    mon = pah.AutoHealMonitor(ol, ol.disks, interval_s=9999)
    marks = []
    real = mon.healer.heal_all

    def heal_all(resume_from=None, progress_cb=None):
        def cb(bucket, obj, res):
            progress_cb(bucket, obj, res)
            marks.append(jah.get_healing_tracker(
                JXLStorage(str(tmp_path / "d02"))))
        return real(resume_from=resume_from, progress_cb=cb,
                    progress_every=4)

    mon.healer.heal_all = heal_all
    assert mon.check_and_heal() is True
    assert [(m["bucket"], m["object"], m["objects_healed"]) for m in marks] \
        == [("hb", "o003", 4), ("hb", "o007", 8)]
    assert pah.get_healing_tracker(ol.disks[2]) is None


def test_global_healer_batches_its_rebuilds(tmp_path):
    """Concurrent heals of two wiped drives ride the dispatch queue, more
    than one rebuild per flush."""
    from minio_tpu_torch.runtime.dispatch import global_queue
    ol = layer("port", tmp_path)
    ol.make_bucket("batch")
    for i in range(16):
        put(ol, "batch", f"o{i}", body(40_000 + i))
    for i in (1, 4):
        shutil.rmtree(tmp_path / f"d{i:02d}" / "batch")
    q = global_queue("cpu")
    q.reset_stats()
    res = pah.GlobalHealer(ol, concurrency=16).heal_all()
    assert res == {"buckets": 1, "objects_healed": 16, "objects_failed": 0}
    st = q.stats()
    assert st["items"] > st["batches"] >= 1
    for i in range(16):
        ol.disks[1].read_version("batch", f"o{i}")


# --- the server --------------------------------------------------------------


def _server(pkg, root):
    from test_torch_s3server import Server
    return Server(pkg, root)


def _gate(srv):
    """Hold every heal_object of the server's layer until released."""
    release = threading.Event()
    real = srv.obj.heal_object

    def held(*a, **kw):
        release.wait(30)
        return real(*a, **kw)

    srv.obj.heal_object = held
    return release


def _no_clock(doc: dict) -> dict:
    return {k: v for k, v in doc.items()
            if k not in ("clientToken", "started", "finished")}


def test_admin_heal_usage_and_bg_status_match(tmp_path):
    # the JAX package's bucket analytics registry is process-wide: the
    # buckets of earlier tests in the worker fill its tracked slots, and
    # its usage rows then fold this test's bucket into "_overflow_" (the
    # port's registry likewise)
    from minio_tpu.obs import bucketstats
    from minio_tpu_torch.obs import bucketstats as pbucketstats
    bucketstats.reset()
    pbucketstats.reset()
    out = {}
    for pkg in PKGS:
        s = _server(pkg, tmp_path / pkg)
        try:
            c, got = s.cl, {}
            assert c.request("PUT", "/hb").status_code == 200
            for i in range(3):
                assert c.request("PUT", f"/hb/k/{i}",
                                 body=body(5000 + i)).status_code == 200
            shutil.rmtree(tmp_path / pkg / "d01" / "hb")
            # a heal of one bucket, finished within the call's wait
            r = c.request("GET", "/minio/admin/v3/heal/hb")
            assert r.status_code == 200
            first = r.json()
            token = first["clientToken"]
            poll = c.request("GET", "/minio/admin/v3/heal/hb",
                             query={"clientToken": token}).json()
            got["heal"] = (_no_clock(first), _no_clock(poll))
            got["bad_token"] = c.request(
                "GET", "/minio/admin/v3/heal/hb",
                query={"clientToken": "nope"}).status_code
            # a running sequence, stopped by its token
            release = _gate(s.srv)
            running = c.request("GET", "/minio/admin/v3/heal").json()
            stop = c.request("GET", "/minio/admin/v3/heal",
                             query={"clientToken": running["clientToken"],
                                    "forceStop": "1"}).json()
            release.set()
            seq = s.srv._heal_seqs.get(running["clientToken"])
            seq._thread.join(30)
            assert not seq._thread.is_alive()
            got["stopped"] = (running["status"], stop["status"],
                              seq.summary()["status"])
            # the usage document after one scanner cycle
            cls = DataScanner if pkg == "port" else JScanner
            cls(s.srv.obj, sleep_per_object=0).scan_cycle()
            got["usage"] = no_time(c.request(
                "GET", "/minio/admin/v3/datausageinfo",
                query={"depth": "1"}).json())
            got["bg_before"] = c.request(
                "GET", "/minio/admin/v3/bg-heal-status").json()
            s.srv.start_background_services()
            got["bg"] = c.request(
                "GET", "/minio/admin/v3/bg-heal-status").json()
            scrape = c.request("GET", "/minio/v2/metrics/cluster"
                               ).content.decode()
            got["families"] = lint(scrape)
            got["usage_rows"] = sorted(
                ln for ln in scrape.splitlines()
                if ln.startswith(("minio_tpu_cluster_usage_",
                                  "minio_tpu_bucket_usage_total_bytes",
                                  "minio_tpu_bucket_usage_object_total",
                                  "minio_tpu_heal_disks_healing")))
            out[pkg] = got
        finally:
            s.close()
    j, p = out["jax"], out["port"]
    assert p["heal"] == j["heal"]
    first, poll = p["heal"]
    assert first["status"] == poll["status"] == "done"
    assert (first["scanned"], first["healed"], first["failed"]) == (3, 3, 0)
    assert p["bad_token"] == j["bad_token"] == 400
    assert p["stopped"] == j["stopped"] == ("running", "running", "stopped")
    assert p["usage"] == j["usage"]
    assert p["usage"]["buckets"]["hb"]["prefixes"] == {
        "k/": {"objects": 3, "size": 15003, "versions": 3}}
    assert p["bg_before"] == j["bg_before"] == {}
    assert p["bg"] == j["bg"]
    assert set(p["bg"]) == {"autoheal", "mrf"}
    assert p["usage_rows"] == j["usage_rows"]
    for fam in ("minio_tpu_cluster_usage_object_total",
                "minio_tpu_bucket_usage_total_bytes",
                "minio_tpu_heal_disks_healing", "minio_tpu_disk_state",
                "minio_tpu_scanner_cycles_total",
                "minio_tpu_scanner_objects_scanned_total",
                "minio_tpu_durability_recovery_runs_total"):
        assert p["families"][fam] == j["families"][fam], fam


def test_start_background_services_wires_the_plane(tmp_path, monkeypatch):
    """The port's server starts the MRF, the scanner (interval from
    MINIO_TPU_SCANNER_INTERVAL_S) and the monitor over every disk; a disk
    that re-onlines gets a healing tracker and kicks the monitor; shutdown
    stops all three."""
    monkeypatch.setenv("MINIO_TPU_SCANNER_INTERVAL_S", "1234")
    s = _server("port", tmp_path)
    try:
        srv = s.srv
        srv.start_background_services()
        assert srv.scanner.interval == 1234.0
        assert srv.autoheal.local_disks == srv.obj.disks
        assert srv.obj.on_partial == srv.mrf.add_partial
        kicked = []
        monkeypatch.setattr(srv.autoheal, "kick", lambda: kicked.append(1))
        srv.obj._on_disk_state(srv.obj.disks[4], "faulty")
        assert not kicked and pah.get_healing_tracker(srv.obj.disks[4]) \
            is None
        srv.obj.disks[4].state_listeners[0](srv.obj.disks[4], "ok")
        assert kicked == [1]
        assert json.loads((tmp_path / "d04" / ".minio.sys" / "healing.bin"
                           ).read_bytes())["started"] > 0
    finally:
        s.close()
    for svc in (srv.scanner, srv.autoheal, srv.mrf):
        assert not svc._thread.is_alive()
