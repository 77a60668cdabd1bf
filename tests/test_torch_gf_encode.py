"""K2's build on the host: the preprocessor values that compile an encode
matrix into csrc/gf_encode.cu (``rs_cuda.encode_defines``), the library key
they give (``cuda_build.target``), the codec preparing its library when it
is made for the card, K2's launch counts by batch size, and the operation
count of the set-bit schedule that ``chip_smoke.py`` bounds K2 with. The
CPU route of ``gf_encode_batched`` is held to the JAX package's static
batched kernel in interpret mode at one toy shape. No card needed."""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from minio_tpu.ops import rs_jax, rs_pallas
from minio_tpu_torch.ops import cuda_build, gf256, rs_cuda, rs_torch

GEOMS = [(16, 4), (12, 4), (8, 4), (4, 2)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parity(k, m):
    return rs_torch.ReedSolomon(k, m, device="cpu").parity_rows


def decode_defines(defines) -> np.ndarray:
    """The matrix a set of K2 defines compiles in, read as the kernel's
    constexpr coef() reads GFK_MAT."""
    d = dict(defines)
    o, i, mat = int(d["GFK_O"]), int(d["GFK_I"]), d["GFK_MAT"]
    assert mat.startswith("0x") and len(mat) == 2 + 2 * o * i
    assert re.fullmatch(r"0x[0-9a-f]*", mat)  # no comma for nvcc to split
    return np.array([int(mat[2 + 2 * n: 4 + 2 * n], 16)
                     for n in range(o * i)], np.uint8).reshape(o, i)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_k2", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k,m", GEOMS)
def test_defines_decode_to_parity_rows(k, m):
    par = parity(k, m)
    defines = rs_cuda.encode_defines(par)
    assert [name for name, _ in defines] == ["GFK_O", "GFK_I", "GFK_MAT"]
    assert all(isinstance(v, str) for _, v in defines)
    assert np.array_equal(decode_defines(defines), par)


def test_library_key_follows_the_matrix():
    """One library per matrix: the name carries o x i and a hash of the
    defines; the same matrix (any copy of it) gives the same library, and
    the key has no room for W or B, which vary from launch to launch."""
    paths = {}
    for k, m in GEOMS:
        par = parity(k, m)
        src, lib = cuda_build.target("gf_encode", rs_cuda.encode_defines(par))
        assert src.endswith(os.path.join("csrc", "gf_encode.cu"))
        assert re.fullmatch(rf"gf_encode-{m}x{k}-[0-9a-f]{{16}}\.so",
                            os.path.basename(lib))
        again = cuda_build.target("gf_encode",
                                  rs_cuda.encode_defines(par.copy()))
        assert again[1] == lib
        paths[(k, m)] = lib
    assert len(set(paths.values())) == len(GEOMS)
    # another matrix of the same shape is another library
    other = parity(16, 4).copy()
    other[0, 0] ^= 1
    lib2 = cuda_build.target("gf_encode", rs_cuda.encode_defines(other))[1]
    assert lib2 != paths[(16, 4)]
    assert cuda_build.label(("gf_encode", rs_cuda.encode_defines(other))) \
        == "gf_encode-4x16"


def test_target_keeps_plain_and_variant_libraries_apart():
    with pytest.raises(ValueError):
        cuda_build.target("gf_encode")
    with pytest.raises(ValueError):
        cuda_build.target("scan", (("GFK_O", "4"),))
    assert os.path.basename(cuda_build.target("scan")[1]).startswith("scan-")
    # the default build list holds no variant: it needs its defines
    assert "gf_encode" in cuda_build.SIGNATURES
    assert "gf_encode" in cuda_build.VARIANTS


def test_prepare_encode_builds_by_the_matrix(monkeypatch):
    seen = []
    monkeypatch.setattr(cuda_build, "library",
                        lambda name, defines=(): seen.append((name, defines)))
    par = parity(8, 4)
    rs_cuda.prepare_encode(par)
    assert seen == [("gf_encode", rs_cuda.encode_defines(par))]
    with pytest.raises(ValueError):  # more inputs than the kernel holds
        rs_cuda.prepare_encode(np.ones((2, rs_cuda.ENCODE_MAX_INPUTS + 1),
                                       np.uint8))


def test_codec_prepares_its_encoder_only_for_the_card(monkeypatch):
    """ReedSolomon made for CUDA builds K2 for its parity rows at once (no
    dispatcher flush waits on nvcc); a CPU codec builds nothing."""
    seen = []
    monkeypatch.setattr(rs_cuda, "prepare_encode",
                        lambda mat: seen.append(np.array(mat)))
    rs_torch.ReedSolomon(12, 4, device="cpu")
    assert seen == []
    monkeypatch.setattr(rs_torch, "resolve_device",
                        lambda device: torch.device("cuda"))
    codec = rs_torch.ReedSolomon(12, 4)
    assert len(seen) == 1 and np.array_equal(seen[0], codec.parity_rows)


@pytest.mark.parametrize("bsz,bucket", [(1, 1), (5, 8), (16, 16), (85, 128),
                                        (128, 128)])
def test_encode_launches_count_by_batch_size(bsz, bucket):
    counts = {"gf_encode_batched": 0}
    sizes = {"gf_encode_batched": {}}
    rs_cuda.count_launch(counts, sizes, "gf_encode_batched", bsz)
    rs_cuda.count_launch(counts, sizes, "gf_encode_batched", bsz)
    assert counts == {"gf_encode_batched": 2}
    assert sizes == {"gf_encode_batched": {bucket: 2}}
    rs_cuda.launch_sizes["gf_encode_batched"][bucket] = 1
    rs_cuda.launch_sizes["gf_matmul_batched"][bucket] = 1
    rs_cuda.launch_rows["gf_matmul_batched"][2] = 1
    rs_cuda.reset_launches()
    # K1's launches are counted by batch size and by output rows too
    assert rs_cuda.launch_sizes == {"gf_matmul_batched": {},
                                    "gf_encode_batched": {}}
    assert rs_cuda.launch_rows == {"gf_matmul_batched": {}}
    assert rs_cuda.launches["gf_encode_batched"] == 0


@pytest.mark.parametrize("k,m", GEOMS)
def test_fixed_matrix_ops_count_the_set_bits(smoke, k, m):
    """chip_smoke's bound for K2 counts only the set coefficient bits of
    gf256.coeff_masks (a 3-input LOP3 folds two of a plane's words into the
    accumulator) plus the 7 doublings of a row (5 ops, 3 of them logic)."""
    par = parity(k, m)
    masks = gf256.coeff_masks(par)             # [8, o, i], all ones if set
    per_plane = (masks != 0).sum(axis=2)       # [8, o]
    folds = int(((per_plane + 1) // 2).sum())
    assert smoke.fixed_matrix_ops(par) == (folds + 35 * m, folds + 21 * m)
    if (k, m) == (16, 4):  # the 16+4 counts of the kernel's source note
        assert (per_plane.sum(axis=0) == 65).all()  # 65 of 128 bits a row
        assert smoke.fixed_matrix_ops(par) == (272, 216)


def test_build_list_holds_the_paths_encoder(smoke):
    keys = smoke.build_keys()
    assert "gf_encode" not in keys and "scan" in keys
    par = parity(16, 4)
    assert ("gf_encode", rs_cuda.encode_defines(par)) in keys


def test_cpu_route_matches_static_batch_kernel_toy_shape():
    """gf_encode_batched on CPU tensors against rs_pallas's batched static
    kernel (interpret mode), B = 2, 4+2, W = 96."""
    rs = rs_jax.ReedSolomon(4, 2, backend="xla")
    x = np.random.default_rng(5).integers(0, 2**32, (2, 4, 96),
                                          dtype=np.uint64).astype(np.uint32)
    want = np.asarray(rs_pallas.gf_matmul_static_batch(rs.parity_rows,
                                                       jnp.asarray(x)))
    got = rs_cuda.gf_encode_batched(rs.parity_rows,
                                    torch.from_numpy(x.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), want)
