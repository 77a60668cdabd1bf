"""Node, the port of minio_tpu/dist/node.py — one server process in a
(possibly distributed) deployment (reference serverMain,
cmd/server-main.go:404): parses endpoints, builds local XLStorage and
remote StorageRESTClient disks, waits for / initializes format.json across
the cluster, assembles the ObjectLayer, mounts the storage, lock and peer
RPC services on the S3 listener, and runs the bootstrap config
cross-check.

``device`` reaches every erasure set the node builds and its S3 server,
``block_size`` every set (the JAX class builds its sets at the object
layer's default block, 4 MiB):
the CUDA card unless the caller passes ``device="cpu"`` (the JAX class has
no such argument; its sets pick their route themselves). On the card each
set builds K2 for both storage classes' matrices at construction, so
several node processes on one card need the encoders built beforehand
(``ops.cuda_build``) or they each run nvcc at start.
"""
from __future__ import annotations

import os
import time

from ..objectlayer import ErasureObjects, ErasureSets
from ..objectlayer.erasure_objects import DEFAULT_BLOCK_SIZE
from ..server import S3Server
from ..storage import XLStorage
from ..utils import errors
from ..utils.device import resolve_device
from .dsync import LocalLocker, NSLockMap
from .endpoints import Endpoint, nodes_of, parse_endpoints
from .format import init_format_erasure
from .lock_rest import LockRESTClient, LockRESTService
from .peer import PeerRESTClient, PeerRESTService
from .storage_rest import StorageRESTClient, StorageRESTService
from .topology import pick_set_layout


class Node:
    def __init__(self, endpoint_args: list[str], local_url: str = "",
                 address: str = "0.0.0.0", port: int = 9000,
                 access_key: str = "", secret_key: str = "",
                 default_parity: int | None = None,
                 region: str = "us-east-1", device=None,
                 block_size: int = DEFAULT_BLOCK_SIZE):
        self.endpoints: list[Endpoint] = parse_endpoints(endpoint_args)
        self.local_url = local_url.rstrip("/")
        self._start = time.monotonic()  # uptime() measures a duration
        self.device = resolve_device(device)
        self.block_size = block_size

        #: disk path -> XLStorage (this node's disks, served over RPC)
        self.local_disks: dict[str, XLStorage] = {}
        secret = secret_key or "minioadmin"
        self.secret = secret
        self.disks: list = []
        for ep in self.endpoints:
            if ep.is_local_path or ep.url == self.local_url:
                d = XLStorage(ep.path, endpoint=str(ep))
                self.local_disks[ep.path] = d
                self.disks.append(d)
            else:
                rc = StorageRESTClient(ep.url, ep.path, secret,
                                       src=self.local_url)
                rc.rpc.on_reconnect = self._on_peer_reconnect
                self.disks.append(rc)

        self.peer_urls = [u for u in nodes_of(self.endpoints)
                          if u != self.local_url]
        self.peers = [PeerRESTClient(u, secret, src=self.local_url)
                      for u in self.peer_urls]

        # lockers: this node's local locker + one lock client per peer
        self.local_locker = LocalLocker()
        self._lock_clients = [LockRESTClient(u, secret,
                                             src=self.local_url)
                              for u in self.peer_urls]
        self.ns_lock = NSLockMap(
            lambda: [self.local_locker, *self._lock_clients],
            owner=self.local_url or "standalone")

        # per-host drive counts drive the set-symmetry filter
        host_counts: dict[str, int] = {}
        for ep in self.endpoints:
            host_counts[ep.url or "local"] = \
                host_counts.get(ep.url or "local", 0) + 1
        self.set_count, self.drives_per_set = pick_set_layout(
            len(self.disks), list(host_counts.values()))
        self.obj = None
        self.bucket_meta = None
        self.server: S3Server | None = None
        self._access_key = access_key
        self._secret_key = secret_key
        self._address, self._port, self._region = address, port, region
        self.format = None
        self.default_parity = default_parity

    def uptime(self) -> float:
        return time.monotonic() - self._start

    def layout_fingerprint(self) -> dict:
        return {"endpoints": [str(e) for e in self.endpoints],
                "sets": self.set_count, "drives": self.drives_per_set}

    def rpc_clients(self) -> list:
        """Every RPC client of this node: its remote disks', peers' and
        lockers'."""
        return [*(d.rpc for d in self.disks
                  if isinstance(d, StorageRESTClient)),
                *(p.rpc for p in self.peers),
                *(c.rpc for c in self._lock_clients)]

    def report(self) -> dict:
        """This process's counters as the node reports them (the CLI's
        ``--stats-file``): every kernel's launches by shape, the RPC
        clients' calls and successful-call seconds by service and method,
        the namespace locks' acquisitions, the dispatch queue's failed and
        salvaged flushes, the card's stream occupancy and memory, every
        successful shard heal's seconds, and for each peer URL the wall
        times its clients last went offline and came back."""
        import torch

        from ..objectlayer import erasure_objects
        from ..obs import device as obs_device
        from ..ops import chacha_cuda, hh_cuda, mur3_cuda, rs_cuda, scan_cuda
        from ..runtime import dispatch
        kernels = {"launches": {}, "launch_sizes": {},
                   "launch_rows": dict(rs_cuda.launch_rows),
                   "launch_pkgs": dict(chacha_cuda.launch_pkgs)}
        for mod in (rs_cuda, mur3_cuda, chacha_cuda, hh_cuda, scan_cuda):
            kernels["launches"].update(mod.launches)
            kernels["launch_sizes"].update(mod.launch_sizes)
        rpc: dict = {}
        for client in self.rpc_clients():
            by_method = rpc.setdefault(client.service, {})
            for m, st in client.method_stats().items():
                row = by_method.setdefault(
                    m, {"calls": 0, "errors": 0, "seconds": []})
                row["calls"] += st["calls"]
                row["errors"] += st["errors"]
                row["seconds"] += st["seconds"]
        marks: dict = {}
        for client in self.rpc_clients():
            m = marks.setdefault(client.base, {"offline_at": [],
                                               "online_at": []})
            m["offline_at"].append(client.offline_at)
            m["online_at"].append(client.online_at)
        q = dispatch._queues.get(str(self.device))
        st = q.stats() if q is not None else {}
        out = {"endpoint": self.local_url, "pid": os.getpid(),
               "device": str(self.device), "kernels": kernels, "rpc": rpc,
               "locks": self.ns_lock.stats.snapshot(),
               "peers": {p.url: p.rpc.health_stats() for p in self.peers},
               "peer_marks": marks,
               "heal_shard_seconds": list(
                   erasure_objects.heal_shard_seconds),
               "dispatch": {k: st.get(k, 0) for k in (
                   "batches", "items", "failed_batches", "failed_items",
                   "salvaged_batches", "salvaged_items", "obs_errors")},
               "occupancy": obs_device.occupancy_totals()}
        if self.device.type == "cuda":
            out["memory"] = {
                "max_allocated": torch.cuda.max_memory_allocated(),
                "reserved": torch.cuda.memory_reserved()}
        return out

    # --- startup ------------------------------------------------------------

    def start(self, wait_format_timeout: float = 60.0) -> S3Server:
        """Mount RPC services + S3 API, then bring storage online."""
        server = S3Server(self.obj, self._address, self._port,
                          self._region, self._access_key, self._secret_key,
                          device=self.device)
        self.server = server
        # owner-driven lock maintenance (reference lockMaintenance):
        # entries on THIS node acquired by a peer are lease-checked
        # against that peer's locker — dead owners free up within
        # interval x (1 + strikes) instead of the stale-sweep age
        lock_svc = LockRESTService(
            self.local_locker,
            owner_lockers_fn=lambda: dict(zip(self.peer_urls,
                                              self._lock_clients)),
            local_owner=self.local_url or "standalone")
        lock_svc.start_maintenance()
        self.lock_service = lock_svc
        server.internal = {
            "storage": StorageRESTService(self.local_disks),
            "lock": lock_svc,
            "peer": PeerRESTService(self),
        }
        server.start_background()
        self.wait_format(wait_format_timeout)
        self._build_object_layer()
        self._attach(server)
        self.bootstrap_verify()
        # background plane (scanner, MRF, auto-heal — reference
        # cmd/server-main.go:508-514) once the object layer is live
        server.start_background_services()
        # cross-node replication plane (bucket/replicate.py): charges
        # ride the notify chain, debt journals beside the MRF journal
        # on the first local disk, and a rejoining peer kicks the
        # backoff park (below)
        from ..bucket.replicate import ReplicationSys
        from ..storage.xlstorage import META_BUCKET
        rs = ReplicationSys(self.obj, server.bucket_meta, node=self)
        disk = next(iter(self.local_disks.values()), None)
        if disk is not None:
            rs.attach_persistence(
                os.path.join(disk.root, META_BUCKET, "replication.json"))
        server.enable_cross_replication(rs)
        rs.start()
        return server

    def _attach(self, server: S3Server) -> None:
        """Hand the built object layer to the server that started without
        one: stored config, bucket metadata (with cross-node
        invalidation), heal sequences and the admin plane's peer hooks
        before ``server.obj`` (the server answers ready, and serves the
        admin plane, once that is set), then IAM with cross-node
        propagation, which loads through it."""
        from ..bucket.metadata import BucketMetadataSys
        from ..config import get_config_sys
        from ..scanner.healseq import HealSequenceManager
        get_config_sys(self.obj)  # attach stored-config persistence
        server.bucket_meta = BucketMetadataSys(self.obj)
        self.bucket_meta = server.bucket_meta
        server.bucket_meta.on_update = self._broadcast_bucket_update
        server._heal_seqs = HealSequenceManager(self.obj)
        # observability hooks for the admin plane (fan-outs, top locks)
        server.peers = lambda: self.peers
        server.local_locker = self.local_locker
        server.obj = self.obj
        # IAM with cross-node propagation: a user created on this node can
        # authenticate on every peer immediately (reference
        # peer-rest-common.go:33-44 LoadUser et al.); mutations serialize
        # under a cluster lock so concurrent admin calls on different
        # nodes can't clobber the shared state document
        server.enable_iam()
        server.iam.on_change = self._broadcast_iam_update
        server.iam.dist_lock = lambda: self.ns_lock.new_lock(
            ".minio.sys", "config/iam/state.json")

    def _on_peer_reconnect(self, client) -> None:
        """A storage RPC client flipped back online (the peer node
        rejoined): kick the auto-heal monitor and nudge the MRF so the
        heal debt journalled while it was gone drains NOW instead of
        waiting out the retry backoff."""
        srv = self.server
        if srv is None:
            return
        for svc in (srv.autoheal, srv.mrf, srv.replication_sys):
            if svc is None:
                continue
            try:
                svc.kick()
            except Exception as e:  # noqa: BLE001 — mid-shutdown
                from ..obs.logger import log_sys
                log_sys().log_once(
                    f"peer-reconnect:{type(e).__name__}", "warning",
                    "dist", f"reconnect kick failed: {e!r}")

    def _broadcast_iam_update(self):
        for p in self.peers:
            try:
                p.load_iam()
            except Exception:  # noqa: BLE001 — peer down: it reloads on boot
                pass

    def wait_format(self, timeout: float):
        """waitForFormatErasure (cmd/prepare-storage.go:331): retry until
        every disk is reachable and consistently formatted. Only the node
        owning the FIRST endpoint may stamp a brand-new deployment; the
        rest wait for its format to land (first-disk rule, else two fresh
        nodes race to different deployment ids)."""
        first = self.endpoints[0] if self.endpoints else None
        may_init = first is None or not first.url \
            or first.url == self.local_url
        deadline = time.monotonic() + timeout
        while True:
            try:
                self.format = init_format_erasure(
                    self.disks, self.set_count, self.drives_per_set,
                    may_init=may_init)
                return
            except errors.StorageError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.5)

    def _build_object_layer(self):
        if self.set_count == 1:
            obj = ErasureObjects(self.disks,
                                 default_parity=self.default_parity,
                                 block_size=self.block_size,
                                 device=self.device)
        else:
            obj = ErasureSets(self.disks, self.set_count,
                              self.drives_per_set,
                              deployment_id=self.format["id"],
                              default_parity=self.default_parity,
                              block_size=self.block_size,
                              device=self.device)
        # wire namespace locks into every set
        for s in ([obj] if self.set_count == 1 else obj.sets):
            s.ns_lock = self.ns_lock
        self.obj = obj

    def _broadcast_bucket_update(self, bucket: str):
        for p in self.peers:
            try:
                p.load_bucket_metadata(bucket)
            except Exception:  # noqa: BLE001
                pass

    def bootstrap_verify(self, quorum: bool = False):
        """verifyServerSystemConfig (cmd/bootstrap-peer-server.go:162):
        cross-check the endpoint layout with peers (best effort during
        rolling start; hard failure only on mismatch)."""
        mine = self.layout_fingerprint()
        for p in self.peers:
            try:
                if not p.verify_config(mine):
                    raise RuntimeError(
                        f"bootstrap: {p.url} disagrees on cluster layout")
            except errors.StorageError:
                continue  # peer not up yet — it will verify against us

    def shutdown(self):
        svc = getattr(self, "lock_service", None)
        if svc is not None:
            svc.stop()
        if self.server is not None:
            self.server.shutdown()

