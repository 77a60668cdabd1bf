"""Every bitrot algorithm of the reference table across the two packages:
an object written by the JAX package (minio_tpu) under SHA256, BLAKE2B512,
HIGHWAYHASH256, HIGHWAYHASH256S, BLAKE2B256S or MUR3X256S is read whole,
read with two shards gone and healed by the port (minio_tpu_torch), and
the reverse; shard files must agree in size and bytes, whole-file digests
byte for byte. The object is the 4+2 / 64 KiB-block / 141,073-byte one of
tests/test_torch_erasure.py (two full blocks and an unaligned tail)."""
import io
import os

import numpy as np
import pytest

from minio_tpu.erasure import Erasure as JErasure
from minio_tpu.erasure import BitrotAlgorithm as JAlgo
from minio_tpu.erasure import new_bitrot_reader as j_reader
from minio_tpu.erasure import new_bitrot_writer as j_writer
from minio_tpu.erasure.streaming import BufferSink as JSink
from minio_tpu.erasure.streaming import erasure_decode as j_decode
from minio_tpu.erasure.streaming import erasure_encode as j_encode
from minio_tpu.erasure.streaming import erasure_heal as j_heal
from minio_tpu.storage.xlstorage import _FileReadAt, _FileWriter
from minio_tpu_torch.erasure import BitrotAlgorithm, Erasure
from minio_tpu_torch.erasure import new_bitrot_reader, new_bitrot_writer
from minio_tpu_torch.erasure.bitrot import pick_bitrot_chunk
from minio_tpu_torch.erasure.streaming import (BufferSink, erasure_decode,
                                               erasure_encode, erasure_heal)

K, M, BLOCK, SIZE = 4, 2, 64 << 10, (2 << 16) + 10001
ALGOS = [a.value for a in BitrotAlgorithm]
#: the shard file sizes the reference writes for this object: streaming
#: 32-byte digests before each 16 KiB chunk, whole-file the raw shard
FILE_SIZE = {True: 35365, False: 35269}
LOST = (0, K)  # one data and one parity shard


@pytest.fixture(autouse=True)
def _jax_routes(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_PUT_PATH", "dispatch")
    monkeypatch.setenv("MINIO_TPU_MUR3_PALLAS", "0")
    monkeypatch.setenv("MINIO_TPU_DISPATCH_MODE", "cpu")


class Side:
    """One package's erasure surface, writing into its own directory."""

    def __init__(self, pkg: str, algo: str, root: str):
        self.pkg = pkg
        self.port = pkg == "port"
        self.algo = (BitrotAlgorithm if self.port else JAlgo)(algo)
        self.er = Erasure(K, M, BLOCK, device="cpu") if self.port \
            else JErasure(K, M, BLOCK)
        self.chunk = pick_bitrot_chunk(BLOCK // K)
        self.till = self.er.shard_file_size(SIZE)
        self.root = root

    def path(self, i, tag="") -> str:
        return os.path.join(self.root, f"d{i}{tag}", "part.1")

    def writers(self, paths):
        new = new_bitrot_writer if self.port else j_writer
        return [None if p is None else new(_FileWriter(p), self.algo,
                                           self.chunk) for p in paths]

    def put(self, data: bytes) -> list[bytes]:
        ws = self.writers([self.path(i) for i in range(K + M)])
        enc = erasure_encode if self.port else j_encode
        assert enc(self.er, io.BytesIO(data), ws, K) == SIZE
        for w in ws:
            w.close()
        return [w.digest() if hasattr(w, "digest") else b"" for w in ws]

    def readers(self, paths, digests, drop=()):
        new = new_bitrot_reader if self.port else j_reader
        return [None if i in drop else new(
            _FileReadAt(p), self.algo, self.till, self.chunk, digests[i],
            self.till) for i, p in enumerate(paths)]

    def get(self, paths, digests, drop=()) -> bytes:
        out = BufferSink() if self.port else JSink()
        dec = erasure_decode if self.port else j_decode
        dec(self.er, out, self.readers(paths, digests, drop), 0, SIZE, SIZE)
        return out.getvalue()

    def heal(self, paths, digests) -> list:
        """Rebuild the LOST shards from the others into new files; returns
        the healed writers."""
        ws = self.writers([self.path(i, "healed") if i in LOST else None
                           for i in range(K + M)])
        heal = erasure_heal if self.port else j_heal
        heal(self.er, ws, self.readers(paths, digests, LOST), SIZE)
        return ws


def read(p) -> bytes:
    with open(p, "rb") as f:
        return f.read()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("algo", ALGOS)
def test_each_algorithm_crosses_the_packages(tmp_path, algo, writer):
    data = np.random.default_rng(SIZE).integers(0, 256, SIZE,
                                                dtype=np.uint8).tobytes()
    w = Side(writer, algo, str(tmp_path / "w"))
    r = Side("port" if writer == "jax" else "jax", algo, str(tmp_path / "r"))
    digests = w.put(data)
    paths = [w.path(i) for i in range(K + M)]
    streaming = w.algo.streaming
    for p in paths:
        assert len(read(p)) == FILE_SIZE[streaming]
    # the other package writes the same object: identical shard files
    assert r.put(data) == digests
    for i in range(K + M):
        assert read(r.path(i)) == read(paths[i]), f"shard {i}"
    # it reads the first package's files whole and with two shards gone
    assert r.get(paths, digests) == data
    assert r.get(paths, digests, drop=(1, 2)) == data
    # and heals them byte for byte
    healed = r.heal(paths, digests)
    for i in LOST:
        assert read(r.path(i, "healed")) == read(paths[i]), f"shard {i}"
        if not streaming:
            assert healed[i].digest() == digests[i]


@pytest.mark.parametrize("algo", ALGOS)
def test_port_detects_a_flipped_byte(tmp_path, algo):
    """A flipped payload byte in a JAX-written shard: the port's reader of
    each algorithm reports the shard corrupt and the GET stays exact."""
    from minio_tpu_torch.utils import errors
    data = np.random.default_rng(SIZE).integers(0, 256, SIZE,
                                                dtype=np.uint8).tobytes()
    w = Side("jax", algo, str(tmp_path / "w"))
    digests = w.put(data)
    paths = [w.path(i) for i in range(K + M)]
    blob = bytearray(read(paths[1]))
    blob[100] ^= 0x21
    with open(paths[1], "wb") as f:
        f.write(blob)
    r = Side("port", algo, str(tmp_path / "r"))
    out = BufferSink()
    st = erasure_decode(r.er, out, r.readers(paths, digests), 0, SIZE, SIZE)
    assert out.getvalue() == data
    assert isinstance(st.errs[1], errors.FileCorrupt)
