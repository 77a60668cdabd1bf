"""The port's disk health trackers (minio_tpu_torch.storage.health), the
disk-id wrapper (storage.idcheck) and the format.json helpers
(dist.format) held to the JAX package's: a stub disk that raises trips both
packages' wrappers after the same count, benign errors never trip, the
cooldown probe re-onlines a recovered disk and both packages' listeners see
the same sequence (also through an erasure set's ``on_disk_state``);
DiskIDCheck raises as the JAX one does on a foreign or missing
format.json; and the wrapper keeps the disk's own attributes and reader
reachable on the data path."""
import os
import shutil
import time

import pytest

from minio_tpu.dist import format as jfmt
from minio_tpu.storage import health as jh
from minio_tpu.storage import idcheck as jid
from minio_tpu.storage import XLStorage as JXLStorage
from minio_tpu.utils import errors as jerr
from minio_tpu_torch.dist import format as pfmt
from minio_tpu_torch.storage import health as ph
from minio_tpu_torch.storage import idcheck as pid
from minio_tpu_torch.storage import XLStorage
from minio_tpu_torch.utils import errors as perr
from test_torch_scanner import PKGS, body, layer, put

HEALTH = {"jax": jh, "port": ph}
ERRS = {"jax": jerr, "port": perr}
DISK = {"jax": JXLStorage, "port": XLStorage}


class StubDisk:
    """A disk whose calls raise what ``script`` says: an error class name
    of the package's ``errors`` (or ``"slow"``) per call, then success."""

    def __init__(self, errs, script=()):
        self.errs = errs
        self.script = list(script)
        self.sick = False
        self.files = {}

    def endpoint(self):
        return "stub"

    def _next(self):
        step = self.script.pop(0) if self.script else None
        if step == "slow":
            time.sleep(0.03)
        elif step is not None:
            raise getattr(self.errs, step)("scripted")

    def read_all(self, volume, path):
        self._next()
        return b"x"

    def disk_info(self):
        if self.sick:
            raise self.errs.FaultyDisk("still sick")
        return {}

    def write_all(self, volume, path, data):
        self.files[path] = data

    def delete_path(self, volume, path, recursive=False):
        self.files.pop(path, None)


SCRIPTS = {
    "faulty": (["FaultyDisk"] * 5, 3),
    "benign": (["FileNotFound", "VolumeNotFound", "FileCorrupt",
                "VolumeExists", "FileVersionNotFound"] * 2, None),
    "reset_by_success": (["FaultyDisk", "FaultyDisk", None, "FaultyDisk",
                          "FaultyDisk"], None),
    "timeouts": (["slow"] * 3, 3),
}


def _trace(pkg, script):
    h = HEALTH[pkg].DiskHealthCheck(StubDisk(ERRS[pkg], script),
                                    trip_threshold=3, deadline_s=0.02,
                                    cooldown_s=60)
    seen, states = [], []
    h.state_listeners.append(lambda d, st: states.append(st))
    for _ in script:
        try:
            h.read_all("v", "p")
            seen.append("ok")
        except Exception as e:  # noqa: BLE001 — recorded and compared
            seen.append(type(e).__name__)
    st = h.health_stats()
    h.close = lambda: None
    h._closed.set()  # stop the probe thread a trip started
    return seen, states, {k: st[k] for k in (
        "state", "consecutive_failures", "total_errors", "trips")}


@pytest.mark.parametrize("case", list(SCRIPTS))
def test_wrappers_trip_alike(case):
    script, trips_at = SCRIPTS[case]
    runs = {pkg: _trace(pkg, script) for pkg in PKGS}
    assert runs["port"] == runs["jax"]
    seen, states, st = runs["port"]
    if trips_at is None:
        assert st["state"] == "ok" and not states
    else:
        assert states == ["faulty"] and st["trips"] == 1
        # the calls after the trip fail fast without reaching the disk
        assert seen[trips_at:] == ["DiskNotFound"] * (len(script) - trips_at)


def test_probe_reonlines_and_listeners_fire_alike():
    out = {}
    for pkg in PKGS:
        inner = StubDisk(ERRS[pkg], ["FaultyDisk"] * 2)
        inner.sick = True
        h = HEALTH[pkg].DiskHealthCheck(inner, trip_threshold=2,
                                        deadline_s=5, cooldown_s=0.02)
        states = []
        h.state_listeners.append(lambda d, st, s=states: s.append(st))
        for _ in range(2):
            with pytest.raises(ERRS[pkg].FaultyDisk):
                h.read_all("v", "p")
        time.sleep(0.1)  # probes run and fail while the disk is sick
        assert h.health_state() == "faulty"
        inner.sick = False
        deadline = time.monotonic() + 10
        while h.health_state() != "ok":
            assert time.monotonic() < deadline
            time.sleep(0.01)
        h._probe_thread.join(5)
        out[pkg] = (states, inner.files, h.read_all("v", "p"))
    assert out["port"] == out["jax"] == (["faulty", "ok"], {}, b"x")


def _trip_by_rename(pkg, root, monkeypatch):
    """An erasure set whose disk 2's root is renamed away until its tracker
    trips; a PUT meanwhile keeps write quorum; renamed back, the probe
    re-onlines it. Returns the on_disk_state sequence."""
    monkeypatch.setenv("MINIO_TPU_HEALTH_COOLDOWN_S", "0.05")
    ol = layer(pkg, root)
    ol.make_bucket("hl")
    states = []
    ol.on_disk_state = lambda d, st: states.append((d.endpoint(), st))
    d2 = ol.disks[2]
    away = str(root / "d02.away")
    os.rename(root / "d02", away)
    while d2.health_state() == "ok":
        with pytest.raises(Exception):  # noqa: B017 — any raw error
            d2.disk_info()
    data = body(30_000)
    put(ol, "hl", "o", data)
    os.rename(away, root / "d02")
    deadline = time.monotonic() + 10
    while d2.health_state() != "ok":
        assert time.monotonic() < deadline
        time.sleep(0.01)
    return [(os.path.basename(ep), st) for ep, st in states], d2.trips


def test_set_forwards_trip_and_reonline_alike(tmp_path, monkeypatch):
    runs = {pkg: _trip_by_rename(pkg, tmp_path / pkg, monkeypatch)
            for pkg in PKGS}
    assert runs["port"] == runs["jax"] == ([("d02", "faulty"),
                                            ("d02", "ok")], 1)
    # the port's probe leaves .minio.sys/tmp in place (the JAX package's
    # prunes it), so the re-onlined disk can take its healing tracker
    assert (tmp_path / "port" / "d02" / ".minio.sys" / "tmp").is_dir()


def test_wrapper_keeps_the_disk_reachable(tmp_path, monkeypatch):
    """The wrapped disk's own attributes and calls pass through; a shard
    reader keeps its read_at and close; MINIO_TPU_HEALTH=0 leaves the disks
    bare and wrapping is idempotent."""
    ol = layer("port", tmp_path)
    d = ol.disks[0]
    assert isinstance(d, ph.DiskHealthCheck)
    assert d.root == str(tmp_path / "d00") and d.sweep_tmp(0.0) == 0
    assert ph.wrap_disks([d, None]) == [d, None]
    ol.make_bucket("b")
    data = body(200_000)
    put(ol, "b", "o", data)
    assert ol.get_object_bytes("b", "o") == data
    fi = d.read_version("b", "o")
    r = d.read_file_at("b", f"o/{fi.data_dir}/part.1")
    assert isinstance(r, ph._ScoredReadAt)
    assert len(r.read_at(0, 100)) == 100
    r.close()
    assert d.health_stats()["total_errors"] == 0
    monkeypatch.setenv("MINIO_TPU_HEALTH", "0")
    bare = XLStorage(str(tmp_path / "bare"))
    assert ph.wrap_disks([bare]) == [bare]


# --- disk identity -----------------------------------------------------------


def _id_run(pkg, root, monkeypatch):
    fmt, idc = (jfmt, jid) if pkg == "jax" else (pfmt, pid)
    monkeypatch.setattr(idc, "ID_CHECK_INTERVAL_S", 0.0)
    disks = [DISK[pkg](os.path.join(str(root), f"d{i}")) for i in range(4)]
    ref = fmt.init_format_erasure(disks, 1, 4)
    ids = [d.get_disk_id() for d in disks]
    out = [ref["xl"]["sets"] == [ids]]
    w = idc.DiskIDCheck(disks[1])
    w.make_vol("b")
    out.append(sorted(v.name for v in w.list_vols()))
    # a foreign format.json: another deployment's identity on this slot
    foreign = fmt.new_format(1, 4, "0" * 8)
    foreign["xl"]["this"] = foreign["xl"]["sets"][0][1]
    fmt.save_format(disks[1], foreign)
    for _ in range(2):
        try:
            w.list_vols()
            out.append("served")
        except ERRS[pkg].DiskNotFound:
            out.append("DiskNotFound")
    out.append(w.healthy())
    os.remove(os.path.join(str(root), "d1", ".minio.sys", "format.json"))
    try:
        w.stat_vol("b")
        out.append("served")
    except ERRS[pkg].DiskNotFound:
        out.append("DiskNotFound")
    out.append(fmt.find_disk_slot(ref, ids[3]))
    return out, ref


def test_disk_id_check_and_format_alike(tmp_path, monkeypatch):
    runs = {pkg: _id_run(pkg, tmp_path / pkg, monkeypatch) for pkg in PKGS}
    assert runs["port"][0] == runs["jax"][0] == [
        True, ["b"], "DiskNotFound", "DiskNotFound", False, "DiskNotFound",
        (0, 3)]
    # each package reads the other's format.json and keeps its identity
    for writer, reader in (("jax", "port"), ("port", "jax")):
        fmt = pfmt if reader == "port" else jfmt
        disk = DISK[reader](str(tmp_path / writer / "d2"))
        got = fmt.load_format(disk)
        assert got["id"] == runs[writer][1]["id"]
        assert got["xl"]["this"] == runs[writer][1]["xl"]["sets"][0][2]
    shutil.rmtree(tmp_path / "port" / "d3" / ".minio.sys")
    with pytest.raises(perr.UnformattedDisk):
        pfmt.load_format(XLStorage(str(tmp_path / "port" / "d3")))


def test_benign_errors_are_the_jax_packages():
    assert [e.__name__ for e in ph.BENIGN_ERRS] == \
        [e.__name__ for e in jh.BENIGN_ERRS]
