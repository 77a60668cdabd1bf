"""Guards of the port's boundaries: minio_tpu_torch and chip_smoke.py import
neither JAX nor anything of the JAX package (minio_tpu), nor the
``msgpack``, ``cryptography`` and ``requests`` wheels the card's machine
lacks, and the port's entry points run on the CUDA card unless the caller
asks for the CPU."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "minio_tpu_torch"
SOURCES = sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py")) + \
    ["chip_smoke.py"]

#: top-level packages the port must not import: JAX, the JAX package, and
#: the wheels the card's machine does not have
FORBIDDEN = ("jax", "jaxlib", "minio_tpu", "msgpack", "cryptography",
             "requests")
#: the port's module count (walk_packages), raised as slices land
MODULES = 143

# imports every port module and chip_smoke.py with jax unimportable and a
# finder that refuses minio_tpu, msgpack, cryptography and requests and
# their submodules (but not minio_tpu_torch)
_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
REFUSED = ("minio_tpu", "msgpack", "cryptography", "requests")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import minio_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    minio_tpu_torch.__path__, "minio_tpu_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" and sys.modules[m] is not None
             or m.split(".")[0] in REFUSED)
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax_or_minio_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) >= MODULES  # every module imported


def _imported(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


@pytest.mark.parametrize("src", SOURCES)
def test_no_forbidden_import_statement(src):
    """Also catches imports inside functions, which importing the module
    does not run."""
    for name in _imported(REPO / src):
        assert name.split(".")[0] not in FORBIDDEN, (src, name)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    from minio_tpu_torch.erasure import Erasure
    from minio_tpu_torch.ops.rs_torch import ReedSolomon
    from minio_tpu_torch.runtime.dispatch import DispatchQueue
    from minio_tpu_torch.server import S3Server
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    for make in (lambda: Erasure(4, 2, 1 << 16),
                 lambda: ReedSolomon(4, 2),
                 lambda: DispatchQueue(),
                 lambda: S3Server(None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    er = Erasure(4, 2, 1 << 16, device="cpu")
    assert er.device.type == "cpu" and er.codec.device.type == "cpu"


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """No result without CUDA, nor from a directory holding chip_smoke.py
    and nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True)
             for cwd in (REPO, tmp_path)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode != 0
        assert '"ok"' not in out
