"""The port's distributed CLI: ``python -m minio_tpu_torch.server --device
cpu http://...`` boots one node process per node of a 2 x 2 cluster on
localhost ports; a PUT through one process reads back through the other;
SIGUSR1 writes the node's counters (``--stats-file``), SIGTERM stops it
cleanly after a last write; and without ``--device cpu`` on a host with no
card the node exits with the device error (no fall back to the CPU)."""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import requests

sys.path.insert(0, os.path.dirname(__file__))
from s3client import S3Client  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AK, SK = "cliak", "cli-secret-key"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _spawn(port: int, endpoints: list, stats: str, device=("--device",
                                                           "cpu")):
    env = dict(os.environ, MINIO_TPU_ROOT_USER=AK,
               MINIO_TPU_ROOT_PASSWORD=SK, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", *device,
         "--address", f"127.0.0.1:{port}", "--stats-file", stats,
         *endpoints], env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)


def _wait_ready(url: str, proc, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.communicate(timeout=10)[1][-3000:]
        try:
            if requests.get(f"{url}/minio/health/ready",
                            timeout=2).status_code == 200:
                return
        except requests.RequestException:
            pass
        time.sleep(0.2)
    raise AssertionError(f"{url} not ready")


def _wait_file(path: str, after: float, timeout: float = 20.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path) and os.path.getmtime(path) >= after:
            with open(path) as f:
                return json.load(f)
        time.sleep(0.05)
    raise AssertionError(f"{path} not written")


def test_cli_boots_a_distributed_cluster(tmp_path):
    ports = [_free_port(), _free_port()]
    endpoints = [f"http://127.0.0.1:{ports[n]}{tmp_path}/n{n}/d{d}"
                 for n in range(2) for d in range(2)]
    stats = [str(tmp_path / f"stats{n}.json") for n in range(2)]
    procs = [_spawn(ports[n], endpoints, stats[n]) for n in range(2)]
    try:
        urls = [f"http://127.0.0.1:{p}" for p in ports]
        for u, p in zip(urls, procs):
            _wait_ready(u, p)
        c0, c1 = S3Client(urls[0], AK, SK), S3Client(urls[1], AK, SK)
        assert c0.put_bucket("clib").status_code == 200
        data = np.random.default_rng(7).bytes(200 << 10)
        assert c0.put_object("clib", "o", data).status_code == 200
        assert c1.get_object("clib", "o").content == data
        t0 = time.time() - 1
        procs[1].send_signal(signal.SIGUSR1)
        rep = _wait_file(stats[1], t0)
        assert rep["endpoint"] == urls[1] and rep["device"] == "cpu"
        assert rep["rpc"]["storage"]["readfileat"]["calls"] >= 1
        assert rep["kernels"]["launches"] == {
            "gf_matmul_batched": 0, "gf_encode_batched": 0,
            "mur3x256_chunks": 0, "chacha20_xor": 0,
            "highwayhash256_chunks": 0, "scan_codes": 0}
        assert rep["dispatch"]["failed_batches"] == 0
        assert urls[0] in rep["peers"]
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(timeout=60) == 0, p.communicate()[1][-3000:]
        with open(stats[0]) as f:
            rep0 = json.load(f)
        assert rep0["locks"]["acquired"] >= 1
        assert rep0["rpc"]["storage"]["renamedata"]["calls"] >= 2
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def test_cli_without_a_card_exits_with_the_device_error(tmp_path):
    port = _free_port()
    endpoints = [f"http://127.0.0.1:{port}{tmp_path}/d{d}"
                 for d in range(4)]
    p = _spawn(port, endpoints, str(tmp_path / "s.json"), device=())
    try:
        rc = p.wait(timeout=120)
        err = p.communicate(timeout=10)[1]
    finally:
        if p.poll() is None:
            p.kill()
    assert rc != 0 and "CUDA is not available" in err
