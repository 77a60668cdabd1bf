"""The port's xl.meta journal (minio_tpu_torch.storage.xlmeta) and its disk
(minio_tpu_torch.storage.xlstorage) held to the JAX package's: the same
FileInfo versions dump to identical bytes, either package loads the
other's journals, a version-1 blob (no trailer) loads, a torn or bad-CRC
version-2 blob raises FileCorrupt in both, and the disks' journal calls
(rename_data, write_metadata, update_metadata, delete_version, the walks,
quarantine and reconcile) leave the same files behind."""
import os
import struct
import zlib

import msgpack
import numpy as np
import pytest

from minio_tpu.storage import xlmeta as jxl
from minio_tpu.storage.datatypes import ErasureInfo as JErasureInfo
from minio_tpu.storage.datatypes import FileInfo as JFileInfo
from minio_tpu.storage.datatypes import ObjectPartInfo as JPart
from minio_tpu.storage.xlstorage import XLStorage as JXLStorage
from minio_tpu.utils import errors as jerrors
from minio_tpu_torch.storage import xlmeta as pxl
from minio_tpu_torch.storage.datatypes import ErasureInfo, FileInfo
from minio_tpu_torch.storage.datatypes import ObjectPartInfo
from minio_tpu_torch.storage.xlstorage import XLStorage
from minio_tpu_torch.utils import errors

SIDES = {"jax": (JFileInfo, JErasureInfo, JPart, jxl, jerrors, JXLStorage),
         "port": (FileInfo, ErasureInfo, ObjectPartInfo, pxl, errors,
                  XLStorage)}


def versions(side: str, gen) -> list:
    """Object versions, an inlined one and a delete marker, from ``gen``."""
    fi_cls, ei_cls, part_cls, _, _, _ = SIDES[side]
    out = []
    for v in range(4):
        out.append(fi_cls(
            volume="b", name="o", version_id=f"vid-{v}" if v else "",
            data_dir=f"ddir-{v}", mod_time=1.7e9 + v + float(gen.random()),
            size=int(gen.integers(0, 1 << 30)),
            metadata={"etag": gen.bytes(16).hex(),
                      "content-type": "application/octet-stream",
                      "x-minio-internal-bitrot": "highwayhash256S",
                      "x-minio-internal-bitrot-chunk": "16384",
                      "x-amz-meta-é": "ü" * int(gen.integers(0, 80))},
            parts=[part_cls(number=p + 1, etag=gen.bytes(16).hex(),
                            size=int(gen.integers(0, 1 << 40)),
                            actual_size=int(gen.integers(0, 1 << 40)))
                   for p in range(int(gen.integers(1, 4)))],
            erasure=ei_cls(data_blocks=16, parity_blocks=4,
                           block_size=1 << 20, index=int(gen.integers(1, 21)),
                           distribution=[int(x) for x in
                                         gen.permutation(20) + 1]),
            data=gen.bytes(int(gen.integers(0, 2000))) if v == 2 else None))
    out.append(fi_cls(volume="b", name="o", version_id="dm", deleted=True,
                      mod_time=1.7e9 + 9.5))
    return out


def journal(side: str, seed: int):
    _, _, _, mod, _, _ = SIDES[side]
    m = mod.XLMeta()
    for fi in versions(side, np.random.default_rng(seed)):
        m.add_version(fi)
    return m


@pytest.mark.parametrize("seed", range(4))
def test_dump_identical(seed):
    j, p = journal("jax", seed), journal("port", seed)
    assert p.dump() == j.dump()
    # each loads the other's bytes to the same journal
    assert pxl.XLMeta.load(j.dump()).dump() == j.dump()
    assert jxl.XLMeta.load(p.dump()).dump() == p.dump()
    got = pxl.XLMeta.load(j.dump()).list_versions("b", "o")
    want = jxl.XLMeta.load(j.dump()).list_versions("b", "o")
    assert [(f.version_id, f.deleted, f.data_dir, f.mod_time, f.size)
            for f in got] == [(f.version_id, f.deleted, f.data_dir,
                               f.mod_time, f.size) for f in want]


def test_journal_ops_match():
    j, p = journal("jax", 7), journal("port", 7)
    for m, fi_cls in ((j, JFileInfo), (p, FileInfo)):
        assert m.delete_version(fi_cls(version_id="vid-1")) == "ddir-1"
        m.add_version(fi_cls(volume="b", name="o", version_id="vid-3",
                             data_dir="new", mod_time=1.8e9))
    assert p.dump() == j.dump()
    with pytest.raises(errors.FileVersionNotFound):
        p.delete_version(FileInfo(version_id="nope"))
    for vid in ("", "null", "vid-2", "dm"):
        a = p.to_fileinfo("b", "o", vid)
        b = j.to_fileinfo("b", "o", vid)
        assert (a.version_id, a.data, a.is_latest, a.num_versions) == \
            (b.version_id, b.data, b.is_latest, b.num_versions)


def test_v1_blob_loads_in_both():
    doc = {"Versions": [{"Type": 1, "ModTime": 1.5e9, "V": {
        "id": "", "ddir": "d", "size": 5, "meta": {"etag": "e"},
        "parts": [{"n": 1, "e": "e", "s": 5, "as": 5}],
        "ec": {"algo": "reedsolomon", "m": 2, "n": 2, "bs": 1 << 20,
               "i": 1, "dist": [1, 2, 3, 4], "cs": []}}}], "Data": {}}
    blob = b"XLT2 1  " + msgpack.packb(doc, use_bin_type=True)
    for mod in (jxl, pxl):
        fi = mod.XLMeta.load(blob).to_fileinfo("b", "o")
        assert (fi.size, fi.data_dir, fi.erasure.distribution) == \
            (5, "d", [1, 2, 3, 4])


@pytest.mark.parametrize("damage", ["torn", "no_trailer", "bad_crc",
                                    "bad_header", "bad_payload"])
def test_damaged_v2_raises_in_both(damage):
    good = journal("port", 1).dump()
    if damage == "torn":
        bad = good[:len(good) // 2]
    elif damage == "no_trailer":
        bad = good[:-8]
    elif damage == "bad_crc":
        bad = good[:-4] + struct.pack("<I", (zlib.crc32(good[:-8]) + 1)
                                      & 0xFFFFFFFF)
    elif damage == "bad_header":
        bad = b"XXXX" + good[4:]
    else:  # a payload that is not msgpack, with a valid trailer
        body = b"XLT2 2  " + b"\xc1\xc1\xc1"
        bad = body + b"XLC1" + struct.pack("<I", zlib.crc32(body))
    with pytest.raises(jerrors.FileCorrupt):
        jxl.XLMeta.load(bad)
    with pytest.raises(errors.FileCorrupt):
        pxl.XLMeta.load(bad)


def _tree(root: str) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        if rel.startswith(".minio.sys/tmp"):
            continue
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out


def _drive(side: str, root: str) -> list:
    """The same journal calls on one package's disk; returns what the
    calls returned."""
    fi_cls, ei_cls, part_cls, _, errs, disk_cls = SIDES[side]
    d = disk_cls(root)
    d.make_vol("b")
    seen = []
    for v, name in enumerate(["a/x", "a/y", "a!b", "c", "a/x/z"]):
        fi = fi_cls(volume="b", name=name, version_id="", data_dir=f"dd{v}",
                    mod_time=1.7e9 + v, size=3,
                    metadata={"etag": "e", "content-type": "t"},
                    parts=[part_cls(number=1, etag="e", size=3,
                                    actual_size=3)],
                    erasure=ei_cls(data_blocks=2, parity_blocks=2,
                                   block_size=1 << 16, index=1,
                                   distribution=[1, 2, 3, 4]))
        w = d.create_file_writer(".minio.sys/tmp", f"t{v}/dd{v}/part.1")
        w.write(b"abc")
        w.close()
        d.rename_data(".minio.sys/tmp", f"t{v}", fi, "b", name)
    d.write_metadata("b", "c", fi_cls(volume="b", name="c", version_id="v2",
                                      data_dir="", mod_time=1.8e9,
                                      deleted=True))
    fi = d.read_version("b", "a/y")
    fi.metadata["x"] = "y"
    d.update_metadata("b", "a/y", fi)
    d.delete_version("b", "a!b", fi_cls(version_id=""))
    seen.append(sorted(d.walk_dir("b")))
    seen.append([n for n, _ in d.walk_versions("b")])
    seen.append([n for n, _ in d.walk_versions("b", prefix="a/",
                                               marker="a/x")])
    seen.append(d.list_dir("b", "a"))
    seen.append([(f.version_id, f.deleted) for f in d.list_versions("b",
                                                                    "c")])
    # a torn journal: quarantined, then heal-able as missing
    p = os.path.join(root, "b", "a", "y", "xl.meta")
    with open(p, "r+b") as f:
        f.truncate(20)
    with pytest.raises(errs.FileCorrupt):
        d.read_version("b", "a/y")
    seen.append(sorted(os.listdir(os.path.join(root, "b", "a", "y"))))
    with pytest.raises(errs.FileNotFound):
        d.read_version("b", "a/y")
    # an orphan data dir beside a journal
    os.makedirs(os.path.join(root, "b", "c", "orphan"))
    seen.append(d.reconcile_object("b", "c"))
    seen.append(list(d.walk_unjournaled("b")))
    # staging left by a dead process (a pid no process has) is swept,
    # this process's own too; a live peer's would be kept
    tmp = os.path.join(root, ".minio.sys", "tmp")
    for name in ("4194303-x", f"{os.getpid()}-y", "legacy"):
        os.makedirs(os.path.join(tmp, name, "dd"))
    seen.append(d.sweep_tmp())
    seen.append(sorted(os.listdir(tmp)))
    return seen


def test_disk_journal_calls_match(tmp_path):
    want = _drive("jax", str(tmp_path / "jax"))
    got = _drive("port", str(tmp_path / "port"))
    assert got == want
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))


def test_port_disk_serves_jax_journals(tmp_path):
    _drive("jax", str(tmp_path))
    j, p = JXLStorage(str(tmp_path)), XLStorage(str(tmp_path))
    for name in ("a/x", "a/x/z", "c"):
        for vid in ("", "null"):
            try:
                want = j.read_version("b", name, vid)
            except jerrors.StorageError as e:
                with pytest.raises(getattr(errors, type(e).__name__)):
                    p.read_version("b", name, vid)
                continue
            got = p.read_version("b", name, vid)
            assert (got.data_dir, got.mod_time, got.deleted,
                    got.erasure.distribution, got.metadata) == \
                (want.data_dir, want.mod_time, want.deleted,
                 want.erasure.distribution, want.metadata)


@pytest.mark.parametrize("mode", ["always", "batched"])
def test_fsync_modes_commit_the_same_files(tmp_path, monkeypatch, mode):
    """Under each fsync policy the port's disk leaves the files of the
    default (``off``); ``batched`` drains its flusher."""
    from minio_tpu_torch.storage import durability
    _drive("port", str(tmp_path / "off"))
    monkeypatch.setenv("MINIO_TPU_FSYNC", mode)
    assert durability.fsync_mode() == mode
    _drive("port", str(tmp_path / mode))
    assert durability.flusher().flush(timeout=30)
    assert _tree(str(tmp_path / mode)) == _tree(str(tmp_path / "off"))
