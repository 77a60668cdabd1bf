"""Minimal etcd v3 client over the JSON/gRPC-gateway, the port of
minio_tpu/dist/etcd.py (reference
cmd/etcd.go wraps go.etcd.io/clientv3; the JSON gateway speaks the same
KV API over plain HTTP: POST /v3/kv/{range,put,deleterange} with
base64-encoded keys/values), so federation needs no etcd driver
dependency."""
from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request


class EtcdError(Exception):
    pass


class EtcdClient:
    def __init__(self, endpoints: list[str], timeout: float = 5.0):
        if not endpoints:
            raise EtcdError("etcd: no endpoints")
        self.endpoints = [e.rstrip("/") for e in endpoints]
        self.timeout = timeout
        self._rr = 0

    def _post(self, path: str, body: dict) -> dict:
        data = json.dumps(body).encode()
        last: Exception | None = None
        for i in range(len(self.endpoints)):
            ep = self.endpoints[(self._rr + i) % len(self.endpoints)]
            req = urllib.request.Request(
                ep + path, data=data, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as r:
                    self._rr = (self._rr + i) % len(self.endpoints)
                    return json.loads(r.read() or b"{}")
            except urllib.error.HTTPError as e:
                detail = e.read().decode(errors="replace")[:200]
                raise EtcdError(f"etcd: {e.code} {detail}") from None
            except Exception as e:  # noqa: BLE001 — connectivity
                last = e
        raise EtcdError(f"etcd: all endpoints unreachable: {last}")

    @staticmethod
    def _b64(s: str | bytes) -> str:
        raw = s.encode() if isinstance(s, str) else s
        return base64.b64encode(raw).decode()

    def put(self, key: str, value: str) -> None:
        self._post("/v3/kv/put", {"key": self._b64(key),
                                  "value": self._b64(value)})

    def get(self, key: str) -> bytes | None:
        out = self._post("/v3/kv/range", {"key": self._b64(key)})
        kvs = out.get("kvs") or []
        if not kvs:
            return None
        return base64.b64decode(kvs[0].get("value", ""))

    def get_prefix(self, prefix: str) -> dict[str, bytes]:
        """All keys under a prefix (range_end = prefix+1 per the etcd
        range convention)."""
        raw = prefix.encode()
        end = raw[:-1] + bytes([raw[-1] + 1]) if raw else b"\x00"
        out = self._post("/v3/kv/range", {
            "key": self._b64(raw), "range_end": self._b64(end)})
        result = {}
        for kv in out.get("kvs") or []:
            k = base64.b64decode(kv.get("key", "")).decode()
            result[k] = base64.b64decode(kv.get("value", ""))
        return result

    def put_if_absent(self, key: str, value: str) -> bool:
        """Atomic create: txn comparing create_revision == 0 (the etcd
        idiom for claim-if-unowned). Returns False when the key already
        exists."""
        out = self._post("/v3/kv/txn", {
            "compare": [{"key": self._b64(key), "target": "CREATE",
                         "create_revision": "0"}],
            "success": [{"request_put": {"key": self._b64(key),
                                         "value": self._b64(value)}}]})
        return bool(out.get("succeeded"))

    def delete(self, key: str) -> None:
        self._post("/v3/kv/deleterange", {"key": self._b64(key)})

    def delete_if_value(self, key: str, value: str) -> bool:
        """Atomic guarded delete: remove the key only when it still
        holds ``value`` (txn compare VALUE). Returns False when someone
        else owns the key."""
        out = self._post("/v3/kv/txn", {
            "compare": [{"key": self._b64(key), "target": "VALUE",
                         "value": self._b64(value)}],
            "success": [{"request_delete_range":
                         {"key": self._b64(key)}}]})
        return bool(out.get("succeeded"))
