"""Remote tier targets for ILM transition, the port of
minio_tpu/bucket/tiers.py (reference cmd/tier.go +
cmd/tier-handlers.go: the admin-configured S3/Azure/GCS tiers cold data
transitions to). Two tier kinds here:

- **fs**: a directory (cold-storage mount) — simplest real target.
- **s3**: any minio-tpu / S3-compatible endpoint driven by a minimal
  SigV4 client (framework-side twin of the test client).

Config persists as one JSON document through the object layer
(reference TierConfigMgr saves tier-config.bin the same way)."""
from __future__ import annotations

import hashlib
import json
import os
import threading
import urllib.parse
import urllib.request

from ..utils import errors

TIERS_PATH = "tiers.json"


def _tier_timeout_s() -> float:
    """Per-call deadline for tier IO (config ``replication.tier_timeout_s``
    / env): a cold-storage mount that hangs must park the transition for
    retry, not wedge the scanner cycle."""
    from ..qos.budget import _config_float
    return _config_float("replication", "tier_timeout_s",
                         "MINIO_TPU_TIER_TIMEOUT_S", 30.0)


def _bounded(fn, timeout_s: float, what: str):
    """Run one tier IO under a hard deadline. A filesystem tier has no
    socket timeout to lean on — a dead NFS/fuse mount blocks in
    uninterruptible IO — so the call runs on a reaper thread and the
    caller gives up at the deadline (the orphaned thread finishes or
    dies with the process; durable_write's tmp+rename means an
    abandoned write can never tear the visible file)."""
    out: dict = {}
    done = threading.Event()

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True, name=f"tier-io-{what}")
    t.start()
    if not done.wait(timeout_s):
        raise errors.FaultyDisk(f"tier {what} timed out after {timeout_s}s")
    if "error" in out:
        raise out["error"]
    return out.get("value")


class TierFS:
    kind = "fs"

    def __init__(self, name: str, directory: str):
        self.name = name
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def put(self, key: str, data: bytes) -> None:
        from .. import fault
        fault.inject("disk", self.name, "tier_put")
        from ..storage.durability import durable_write
        path = os.path.join(self.dir, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _bounded(lambda: durable_write(path, data), _tier_timeout_s(),
                 "put")

    def get(self, key: str) -> bytes:
        from .. import fault
        fault.inject("disk", self.name, "tier_get")

        def read():
            with open(os.path.join(self.dir, key), "rb") as f:
                return f.read()
        try:
            return _bounded(read, _tier_timeout_s(), "get")
        except OSError as e:
            raise errors.FileNotFound(key) from e

    def remove(self, key: str) -> None:
        from .. import fault
        fault.inject("disk", self.name, "tier_delete")
        try:
            _bounded(lambda: os.unlink(os.path.join(self.dir, key)),
                     _tier_timeout_s(), "delete")
        except OSError:
            pass

    def to_dict(self) -> dict:
        return {"kind": self.kind, "name": self.name, "dir": self.dir}


class TierS3:
    """Minimal SigV4 client against an S3-compatible tier endpoint."""

    kind = "s3"

    def __init__(self, name: str, endpoint: str, bucket: str,
                 access_key: str, secret_key: str, prefix: str = "",
                 region: str = "us-east-1"):
        self.name = name
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.ak = access_key
        self.sk = secret_key
        self.region = region

    def _request(self, method: str, key: str, body: bytes = b""):
        from .. import fault
        fault.inject("disk", self.name, f"tier_{method.lower()}")
        from ..server.auth import SigV4Verifier
        path = f"/{self.bucket}/" + (f"{self.prefix}/{key}" if self.prefix
                                     else key)
        host = self.endpoint.split("//", 1)[1]
        headers = {"host": host}
        payload_hash = hashlib.sha256(body).hexdigest()
        signer = SigV4Verifier(lambda a: None, self.region)
        auth = signer.sign_request(self.ak, self.sk, method, path, {},
                                   headers, payload_hash)
        headers["authorization"] = auth
        req = urllib.request.Request(
            self.endpoint + urllib.parse.quote(path), data=body or None,
            method=method, headers=headers)
        return urllib.request.urlopen(req, timeout=_tier_timeout_s())

    def put(self, key: str, data: bytes) -> None:
        with self._request("PUT", key, data) as resp:
            if resp.status not in (200, 204):
                raise errors.FaultyDisk(f"tier put status {resp.status}")

    def get(self, key: str) -> bytes:
        try:
            with self._request("GET", key) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise errors.FileNotFound(key) from None
            raise errors.FaultyDisk(f"tier get status {e.code}") from e

    def remove(self, key: str) -> None:
        try:
            with self._request("DELETE", key):
                pass
        except Exception:  # noqa: BLE001 — best-effort cleanup
            pass

    def to_dict(self) -> dict:
        return {"kind": self.kind, "name": self.name,
                "endpoint": self.endpoint, "bucket": self.bucket,
                "prefix": self.prefix, "access_key": self.ak,
                "secret_key": self.sk, "region": self.region}


def _from_dict(d: dict):
    if d.get("kind") == "fs":
        return TierFS(d["name"], d["dir"])
    if d.get("kind") == "s3":
        return TierS3(d["name"], d["endpoint"], d["bucket"],
                      d["access_key"], d["secret_key"],
                      d.get("prefix", ""), d.get("region", "us-east-1"))
    raise ValueError(f"unknown tier kind {d.get('kind')!r}")


class TierRegistry:
    def __init__(self, objlayer):
        self.obj = objlayer
        self._lock = threading.Lock()
        self.tiers: dict[str, object] = {}
        self.load()

    def load(self):
        try:
            doc = json.loads(self.obj.get_config(TIERS_PATH))
        except (errors.StorageError, ValueError, NotImplementedError):
            return
        with self._lock:
            self.tiers = {}
            for d in doc.get("tiers", []):
                try:
                    t = _from_dict(d)
                    self.tiers[t.name] = t
                except (ValueError, KeyError):
                    continue

    def _persist(self):
        self.obj.put_config(TIERS_PATH, json.dumps(
            {"tiers": [t.to_dict() for t in self.tiers.values()]}).encode())

    def add(self, tier) -> None:
        with self._lock:
            if tier.name in self.tiers:
                raise ValueError(f"tier {tier.name} already exists")
            self.tiers[tier.name] = tier
            self._persist()

    def remove(self, name: str) -> None:
        with self._lock:
            self.tiers.pop(name, None)
            self._persist()

    def get(self, name: str):
        with self._lock:
            return self.tiers.get(name)

    def list(self) -> list[dict]:
        with self._lock:
            out = []
            for t in self.tiers.values():
                d = t.to_dict()
                d.pop("secret_key", None)  # never expose secrets
                out.append(d)
            return out
