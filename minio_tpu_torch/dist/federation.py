"""Bucket-DNS federation, the port of minio_tpu/dist/federation.py
(reference cmd/etcd.go +
cmd/config/dns/etcd_dns.go + the forwarding middleware
cmd/routers.go:73 setBucketForwardingHandler): several independent
clusters share one namespace by registering every bucket in etcd under
the CoreDNS/SkyDNS key scheme; a request for a bucket another cluster
owns is proxied there.

Key layout (etcd_dns.go Put): ``/skydns/<domain reversed>/<bucket>/``
entries, one per cluster endpoint, value ``{"host": ..., "port": ...,
"ttl": ...}``."""
from __future__ import annotations

import json

from .etcd import EtcdClient, EtcdError

DEFAULT_DOMAIN = "cluster.local"


class FederationConflict(Exception):
    """Another cluster holds the bucket name."""


class BucketDNS:
    def __init__(self, etcd: EtcdClient, host: str, port: int,
                 domain: str = DEFAULT_DOMAIN):
        self.etcd = etcd
        self.host = host
        self.port = port
        self.domain = domain
        rev = "/".join(reversed(domain.split(".")))
        self._prefix = f"/skydns/{rev}/"

    def _key(self, bucket: str) -> str:
        return f"{self._prefix}{bucket}/{self.host}:{self.port}"

    def _claim_key(self, bucket: str) -> str:
        # the atomic ownership claim lives on one canonical key; the
        # per-endpoint records under it are plain SkyDNS entries
        return f"{self._prefix}{bucket}/@owner"

    def put(self, bucket: str) -> None:
        """Register this cluster as the bucket's owner. The claim is an
        etcd create-txn, so two clusters racing the same name cannot
        both win (the check-then-put in the caller is only a fast
        path). Endpoint records are only ever written under a held
        claim — a freed claim between attempts retries rather than
        registering unclaimed."""
        me = f"{self.host}:{self.port}"
        for _ in range(8):
            if self.etcd.put_if_absent(self._claim_key(bucket), me):
                break
            current = self.etcd.get(self._claim_key(bucket))
            if current is None:
                continue  # freed between txn and get: retry the claim
            if current.decode() != me:
                raise FederationConflict(
                    f"bucket {bucket!r} is owned by {current.decode()}")
            break  # already mine (idempotent re-put)
        else:
            raise EtcdError("etcd: claim churn, giving up")
        self.etcd.put(self._key(bucket), json.dumps(
            {"host": self.host, "port": self.port, "ttl": 30}))

    def delete(self, bucket: str) -> None:
        self.etcd.delete(self._key(bucket))
        # guarded: only the claim's holder may release it — an
        # unconditional delete would let a cluster with a same-named
        # LOCAL bucket destroy another cluster's federation claim
        if not self.etcd.delete_if_value(self._claim_key(bucket),
                                         f"{self.host}:{self.port}"):
            # identity drift (advertise address changed since the claim
            # was written): claims take no lease, so an orphaned claim
            # with NO endpoint records left would poison the name
            # forever — reap it; when records remain, another cluster
            # genuinely owns the name and the claim must stand
            # observe the claim value BEFORE the records check: a racing
            # put() that wins the claim after this read changes the
            # value, so the guarded delete below misses and the winner's
            # claim survives (reading after the check would let the reap
            # destroy a freshly-won claim whose record isn't written yet)
            current = self.etcd.get(self._claim_key(bucket))
            records = {
                k: v for k, v in self.etcd.get_prefix(
                    f"{self._prefix}{bucket}/").items()
                if not k.endswith("/@owner")}
            if not records and current is not None:
                self.etcd.delete_if_value(self._claim_key(bucket),
                                          current.decode())

    def lookup(self, bucket: str) -> list[tuple[str, int]]:
        """Endpoints owning ``bucket`` (empty when unregistered)."""
        out = []
        try:
            entries = self.etcd.get_prefix(f"{self._prefix}{bucket}/")
        except EtcdError:
            return []
        for _, raw in sorted(entries.items()):
            try:
                doc = json.loads(raw)
                out.append((doc["host"], int(doc["port"])))
            except (ValueError, KeyError):
                continue
        return out

    def list_buckets(self) -> dict[str, list[tuple[str, int]]]:
        """bucket -> owning endpoints for the whole federation."""
        out: dict[str, list[tuple[str, int]]] = {}
        try:
            entries = self.etcd.get_prefix(self._prefix)
        except EtcdError:
            return {}
        for key, raw in sorted(entries.items()):
            rest = key[len(self._prefix):]
            bucket = rest.split("/", 1)[0]
            try:
                doc = json.loads(raw)
                out.setdefault(bucket, []).append(
                    (doc["host"], int(doc["port"])))
            except (ValueError, KeyError):
                continue
        return out

    def is_mine(self, endpoints: list[tuple[str, int]]) -> bool:
        return (self.host, self.port) in endpoints


def federation_from_env(host: str, port: int):
    """BucketDNS from MINIO_TPU_ETCD_ENDPOINTS (comma-separated) +
    MINIO_TPU_DOMAIN, or None when federation is not configured
    (reference config/dns lookup from MINIO_ETCD_ENDPOINTS /
    MINIO_DOMAIN)."""
    import os
    eps = os.environ.get("MINIO_TPU_ETCD_ENDPOINTS", "")
    if not eps:
        return None
    return BucketDNS(
        EtcdClient(eps.split(",")), host, port,
        os.environ.get("MINIO_TPU_DOMAIN", DEFAULT_DOMAIN))
