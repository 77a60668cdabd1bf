"""S3-compatible HTTP API server, the port of minio_tpu/server/s3api.py
(reference cmd/api-router.go:82 + cmd/object-handlers.go /
cmd/bucket-handlers.go): path-style routing over an ObjectLayer, SigV4
auth, XML responses.

Threaded stdlib HTTP server: request concurrency maps to the dispatch
queue's batching, so the blocks of many in-flight PUTs and GETs coalesce
into single kernel launches on the card (K2 encode and K5 hashes on PUT,
K5 verify and K1 rebuild on GET and heal, K4 for the ChaCha20 SSE
package cipher, K6 for SelectObjectContent; the AES-256-GCM package
cipher runs on the host's native engine).

What came over: the bucket handlers (list buckets, put/head/delete
bucket, location, ListObjects V1/V2, list versions, versioning, bucket
tagging, DeleteObjects, the hard quota check), the object handlers (PUT,
GET, ranged GET, HEAD, conditional requests, delete, copy, object
tagging, the six multipart handlers, SSE-C, SSE-S3 and SSE-KMS over the
process KMS (``crypto/kms.py``, configured with the root secret at
construction), SelectObjectContent), the
health endpoints, and the background plane: the MRF heal queue that
degraded reads feed, the data scanner and its usage snapshot (which the
quota check reads), and fresh-disk auto-heal
(``start_background_services``).

The observability and admission planes (``obs/``, ``qos/``): every
request passes admission control (``qos.admission``: a bounded-wait
concurrency gate of ``max_requests`` slots and per-class token buckets;
an overloaded server answers ``503 SlowDown`` with ``Retry-After``),
opens a root span whose id is its ``x-amz-request-id``, and is counted,
timed and published on the trace stream. ``/minio/v2/metrics/{cluster,
node}`` and ``/minio/metrics`` serve the Prometheus exposition
(``?attribution=1`` adds the stage families), ``/minio/admin/`` the
admin observability, heal and usage ops (``server/admin.py``).

IAM (``S3Server.enable_iam()``, as the JAX package's server offers it;
off by default, when only the root credentials authenticate): users,
groups, service accounts and STS credentials authenticate through
``iam/``; every handler asks the gate for its S3 action, and a denied
principal, or an anonymous one, may still be granted by the bucket's
policy (``?policy`` PUT, GET and DELETE); STS answers ``POST /``
(``AssumeRole``, ``AssumeRoleWithWebIdentity``,
``AssumeRoleWithClientGrants``, ``AssumeRoleWithLDAPIdentity``).

Every finished request is charged to its bucket's analytics
(``obs/bucketstats``: request counts, bytes in and out through a counting
response writer, TTFB and wall) and leaves one audit entry
(``obs/logger``, its ``request_id`` the trace id), and its SLO outcome
feeds the bucket's burn-attribution ring.

The bucket feature planes (``bucket/``): object lock (lock-enabled
buckets, default retention, ``?retention`` and ``?legal-hold``, GOVERNANCE
with its bypass header, COMPLIANCE, version deletes refused while a
retention or hold is active), lifecycle (``?lifecycle``, applied by the
data scanner) with its tiers and transition (a transitioned object is a
stub whose GET reads through from its tier, ``POST ?restore`` brings it
back), replication to an S3 target (``enable_replication``: object events
feed a ``ReplicationPool``, a GET that misses locally proxies to the
bucket's target) and the cross-node replication plane
(``enable_cross_replication``: ``?replication`` rules, per-object status
in xl.meta, a journalled debt queue, the SLO plane's lag objective); and
event notifications (``enable_events``: ``?notification`` rules route
object events to webhook and broker targets through persistent queue
stores; ``GET ?events`` streams them live). Every object handler that
creates, removes or reads an object fires the ``notify`` hook.

The distributed plane (``dist/``): a node mounts its storage, lock and
peer RPC services in ``internal`` (``/minio/<service>/v1/<method>``,
bearer-token auth, typed errors in a header, the caller's span context
joined as a peer-side fragment), sets ``peers`` for the admin fan-outs,
and ``hard_close_connections`` severs every accepted connection as a
killed process would. Bucket-DNS federation (``enable_federation``):
bucket create and delete register in etcd, a request for a bucket another
cluster owns is proxied there, and ListBuckets shows the federated
namespace.

Every API whose plane is not ported answers S3's ``501 NotImplemented``
in the reference's error XML: STS without IAM, the other admin ops, the
console and web-RPC planes, POST policy uploads and the bucket's
``?encryption`` sub-resource.

Transparent compression (``utils/compress.py``): with
``MINIO_TPU_COMPRESSION=on`` a PUT of compressible content (by extension
or MIME type) is stored as an S2 frame stream (or ``zlib/1``), its ETag the
plaintext's MD5 (the shared MD5 lanes for large bodies); GET, ranged GET,
HEAD, listings, copy and Select serve the plaintext of the three markers,
whichever package wrote them.

The fault plane (``fault/``) takes its ``fault`` config subsystem's rules
at construction and on every change of it; the server can listen on
extra addresses (``extra_addresses``, the CLI's ``--address a:p,b:q``).

The config registry (``config/``) attaches to the object layer at
construction: stored settings (``api.requests_max`` among them) hold here
under the environment. The always-on profiler starts with the first
server; every request's worker thread is tagged with its class and op for
it, and every admitted request's outcome feeds the SLO plane."""
from __future__ import annotations

import base64
import binascii
import hashlib
import json
import logging
import os
import socket
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..bucket import metadata as bucket_metadata
from ..obs import bucketstats as _bs
from ..obs import latency as _lat
from ..obs import metrics as _mx
from ..obs import profiler as _prof
from ..obs import slo as _slo
from ..obs import spans as _sp
from ..obs import trace as _trc
from ..obs.logger import log_sys
from ..objectlayer import ObjectOptions
from ..objectlayer import datatypes as dt
from ..scanner import usage as usage_mod
from ..scanner.healseq import HealSequenceManager
from ..utils import compress as cz
from ..utils import errors
from ..utils.device import resolve_device
from ..utils.hashreader import (BadDigestError, HashReader,
                                SHA256MismatchError)
from ..qos.admission import AdmissionController, classify_request, \
    plane_exempt
from . import xmlutil as xu
from .auth import (STREAMING_PAYLOAD, UNSIGNED_PAYLOAD, AuthError,
                   ChunkedSigV4Reader, SigV4Verifier, parse_auth_header,
                   signing_key)

MAX_PUT_SIZE = 5 << 30          # single PUT cap 5 GiB

#: internal metadata of a compressed object
META_COMPRESSION = cz.META_COMPRESSION
META_ACTUAL_SIZE = cz.META_ACTUAL_SIZE
_HOST_ID = ""

log = logging.getLogger("minio_tpu_torch.server")


def host_id() -> str:
    """Stable per-host opaque id stamped as ``x-amz-id-2`` / error-XML
    ``HostId`` (the JAX package's derivation)."""
    global _HOST_ID
    if not _HOST_ID:
        _HOST_ID = base64.b64encode(hashlib.sha256(
            socket.gethostname().encode()).digest()).decode()[:44]
    return _HOST_ID


class S3Server:
    """Owns the ObjectLayer, auth and bucket metadata; builds the HTTP
    server. ``device`` is where the handlers' own device work runs (the
    SSE-C keystreams, the Select scan): the CUDA card unless the caller
    passes ``device="cpu"``; give the object layer the same device.
    The process KMS (SSE-S3, SSE-KMS) derives its fallback master key from
    ``secret_key`` unless the environment configures one (crypto/kms.py).
    ``max_requests`` is the admission gate's concurrency;
    ``extra_addresses`` are (host, port) bindings served beside the main
    one (the reference's multi-address listener), their bound ports in
    ``extra_ports`` after ``build()``."""

    def __init__(self, objlayer, address: str = "0.0.0.0", port: int = 9000,
                 region: str = "us-east-1", access_key: str = "",
                 secret_key: str = "", device=None, max_requests: int = 256,
                 extra_addresses: list | None = None):
        self.extra_addresses = list(extra_addresses or [])
        self._extra_httpds: list = []
        self.extra_ports: list = []
        self.obj = objlayer
        self.region = region
        self.device = resolve_device(device)
        self.access_key = access_key or os.environ.get(
            "MINIO_ROOT_USER", "minioadmin")
        self.secret_key = secret_key or os.environ.get(
            "MINIO_ROOT_PASSWORD", "minioadmin")
        from ..crypto import kms as _kms_mod
        _kms_mod.configure(self.secret_key)
        self.bucket_meta = bucket_metadata.BucketMetadataSys(objlayer)
        #: the IAM subsystem (``enable_iam``); None: root credentials only
        self.iam = None
        #: the event hook, fn(event_name, bucket, object_info): the
        #: notifier, the replication planes, or a chain of them
        #: (``ensure_notifier``, ``enable_events``, ``enable_replication``,
        #: ``enable_cross_replication``); None: no plane listens
        self.notify = None
        self._notifier = None
        #: serializes every read-chain-store of ``notify``
        self._notifier_lock = threading.Lock()
        #: the S3-target replication pool and the cross-node replication
        #: plane, once enabled
        self.replication = None
        self.replication_sys = None
        self._tiers = None
        self._transition = None
        #: the admin ``service`` op's hook (action "restart" or "stop");
        #: the CLI installs one, None acknowledges and does nothing
        self.on_service_signal = None
        self.verifier = SigV4Verifier(self.lookup_secret, region)
        self.address = address
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None
        #: internal RPC services mounted under /minio/<name>/v1/<method>
        #: (storage, lock, peer — populated by dist.node.Node)
        self.internal: dict[str, object] = {}
        #: () -> the peer RPC clients the admin fan-outs reach (the node's)
        self.peers = lambda: []
        #: the node's dsync locker (admin ``top/locks``); None standalone
        self.local_locker = None
        #: federation bucket DNS (dist.federation.BucketDNS); None when
        #: the deployment is not federated
        self.federation = None
        #: live accepted connections: node-kill chaos severs these the way
        #: a dead process would (keep-alive peers must not keep talking to
        #: a "killed" node through zombie sockets)
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        #: the background plane (start_background_services)
        self.mrf = None
        self.scanner = None
        self.autoheal = None
        #: the admin heal sequences, by client token
        self._heal_seqs = HealSequenceManager(objlayer)
        #: the config registry gets its persistence (``.minio.sys/config``
        #: through the object layer), so stored settings survive restarts
        #: and a JAX server's stored config holds here (env > stored >
        #: default)
        from ..config import get_config_sys
        cfg = get_config_sys(objlayer) if objlayer is not None else None
        if cfg is not None and \
                cfg.source("api", "requests_max") != "default":
            # an operator-set env/stored value wins over the constructor's
            # default; an explicit constructor argument wins otherwise
            max_requests = cfg.get_int("api", "requests_max", max_requests)
        #: admission control: a request that cannot get a slot within the
        #: bounded wait (or whose class token bucket is empty) is answered
        #: 503 SlowDown + Retry-After instead of parking a handler thread
        self.qos_admission = AdmissionController(max_requests=max_requests)
        if cfg is not None:
            import weakref
            ref = weakref.ref(self)

            def _apply_api(c, _ref=ref):
                s = _ref()
                if s is not None and \
                        c.source("api", "requests_max") != "default":
                    s.qos_admission.reconfigure(
                        c.get_int("api", "requests_max",
                                  s.qos_admission.max_requests))

            cfg.on_apply("api", _apply_api)
            # the fault subsystem's rules: applied at start and on every
            # change of the subsystem
            from .. import fault as _fault
            cfg.on_apply("fault", _fault.apply_config)
            _fault.apply_config(cfg)
        # the always-on continuous profiler: one process-global daemon
        # whatever the server count (repeated server cycles add no thread)
        _prof.ensure_started()

    def lookup_secret(self, access_key: str) -> str | None:
        """The secret of an access key: IAM's once it is enabled (root,
        users, service accounts, unexpired STS credentials), else the
        root credentials only."""
        if self.iam is not None:
            return self.iam.lookup_secret(access_key)
        return self.secret_key if access_key == self.access_key else None

    def enable_iam(self):
        """Attach the IAM subsystem: per-user credentials, policy
        enforcement, STS, anonymous bucket-policy access. Its state loads
        from (and every mutation rewrites) ``.minio.sys/config/iam/
        state.json`` through the object layer."""
        from ..iam import IAMSys
        self.iam = IAMSys(self.obj, self.access_key, self.secret_key)
        return self.iam

    def authorize(self, access_key: str, action: str, bucket: str,
                  object: str) -> bool:
        """The policy gate of one request: without IAM any authenticated
        principal (root) may do anything and an anonymous one nothing;
        with IAM the principal's effective policies decide, and failing
        them the bucket's policy may grant the (possibly anonymous)
        principal."""
        if self.iam is None:
            return access_key != ""
        if self.iam.is_allowed(access_key, action, bucket, object):
            return True
        if bucket:
            from ..iam.policy import Policy, policy_allows
            meta = self.bucket_meta.get(bucket)
            if meta.policy_json:
                try:
                    bp = Policy.parse(meta.policy_json)
                except ValueError:
                    return False
                resource = f"{bucket}/{object}" if object else bucket
                return policy_allows([bp], action, resource,
                                     principal=access_key or "*")
        return False

    def _track_conn(self, sock) -> None:
        with self._conns_lock:
            self._conns.add(sock)

    def _untrack_conn(self, sock) -> None:
        with self._conns_lock:
            self._conns.discard(sock)

    def hard_close_connections(self) -> None:
        """Sever every accepted connection (fault.node.node_kill): a
        SIGKILL'd process takes its established sockets with it, so the
        in-process kill must too — otherwise peers keep completing RPCs
        against the 'dead' node over keep-alive connections."""
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def create_bucket(self, bucket: str, object_lock: bool = False):
        """Bucket creation: the federation's namespace check, the object
        layer's bucket plus its metadata record (an object-lock bucket is
        versioned from its creation) and the DNS registration, undone
        whole when the registration fails."""
        dns = self.federation
        if dns is not None:
            owners = dns.lookup(bucket)
            if owners and not dns.is_mine(owners):
                raise dt.BucketExists(bucket)
        self.obj.make_bucket(bucket)
        meta = bucket_metadata.BucketMetadata(name=bucket)
        if object_lock:
            meta.object_lock_enabled = True
            meta.versioning_enabled = True
        self.bucket_meta.set(bucket, meta)
        if dns is not None:
            from ..dist.federation import FederationConflict
            try:
                dns.put(bucket)
            except Exception as e:  # noqa: BLE001 — an unregistered
                # bucket would be invisible to the federation: undo it all
                self.obj.delete_bucket(bucket, force=True)
                self.bucket_meta.remove(bucket)
                if self._notifier is not None:
                    self._notifier.invalidate(bucket)
                if isinstance(e, FederationConflict):
                    # lost the atomic claim race to another cluster
                    raise dt.BucketExists(bucket) from None
                raise dt.InvalidRequest(
                    bucket, "", f"federation DNS: {e}") from None

    def remove_bucket(self, bucket: str, force: bool = False):
        if force and self.bucket_meta.get(bucket).object_lock_enabled:
            # force delete would bypass WORM retention (the reference
            # refuses force-delete on lock buckets the same way)
            raise dt.InvalidRequest(
                bucket, "",
                "force delete not allowed on object-lock buckets")
        # the bucket must exist here before DNS is touched: deleting a
        # bucket we don't hold must not strip (or, through the restore
        # below, resurrect) another cluster's registration
        self.obj.get_bucket_info(bucket)
        if self.federation is not None:
            # unregister FIRST and fail the request when etcd is down:
            # entries take no lease, so a silently skipped delete would
            # poison the name federation-wide forever
            try:
                self.federation.delete(bucket)
            except Exception as e:  # noqa: BLE001
                raise dt.InvalidRequest(
                    bucket, "", f"federation DNS: {e}") from None
        try:
            self.obj.delete_bucket(bucket, force=force)
        except dt.BucketNotFound:
            raise  # lost a delete race: nothing to restore
        except BaseException:
            if self.federation is not None:
                try:  # the local delete failed: restore the DNS record
                    self.federation.put(bucket)
                except Exception:  # noqa: BLE001 — best effort
                    log.warning("federation record of %s not restored",
                                bucket, exc_info=True)
            raise
        self.bucket_meta.remove(bucket)
        if self._notifier is not None:
            # a recreated bucket must not inherit the old routing rules
            self._notifier.invalidate(bucket)

    def enable_federation(self, dns):
        """Attach a federation BucketDNS (``dist/federation.py``): bucket
        create and delete register in etcd, requests for a bucket another
        cluster owns proxy there, ListBuckets shows the federated
        namespace."""
        self.federation = dns
        return dns

    def _chain(self, fn) -> None:
        """Put ``fn`` in front of the notify hook, keeping what was there
        (under the caller's ``_notifier_lock``: an unguarded read-chain-
        store racing another attach would drop one of the links)."""
        prev = self.notify
        if prev is None:
            self.notify = fn
            return

        def chained(event, bucket, oi, *a):
            fn(event, bucket, oi, *a)
            prev(event, bucket, oi, *a)

        self.notify = chained

    def ensure_notifier(self):
        """The event notifier, created lazily when a live listener needs
        it before any target configuration. Chains with (never replaces)
        an existing notify hook, and the lock closes the concurrent-first-
        listener race that would orphan one notifier."""
        with self._notifier_lock:
            if self._notifier is None:
                from ..event import EventNotifier
                n = EventNotifier(self.bucket_meta, [], "", self.region)
                self._chain(n)
                self._notifier = n
            return self._notifier

    def enable_replication(self, pool):
        """Attach a ReplicationPool (``bucket/replication.py``): object
        events feed it (chained with any existing hook) and GETs of
        locally missing objects proxy to the bucket's target (reference
        proxy-to-target on GET miss)."""
        self.replication = pool
        with self._notifier_lock:
            self._chain(lambda event, bucket, oi, *a:
                        pool.on_event(event, bucket, oi))
        return pool

    def enable_cross_replication(self, rs):
        """Attach the cross-node ReplicationSys (``bucket/replicate.py``):
        completed writes and deletes charge replication debt through the
        notify chain, the scanner re-charges PENDING and FAILED leftovers
        each cycle, and the replication lag rides the SLO plane as an
        async objective."""
        self.replication_sys = rs
        with self._notifier_lock:
            self._chain(lambda event, bucket, oi, *a:
                        rs.charge(event, bucket, oi))
        if self.scanner is not None:
            self.scanner.replication = rs
        _slo.register_async_probe("replication", rs.lag_report)
        return rs

    def enable_events(self, targets: list | None = None,
                      queue_root: str = ""):
        """Attach the event-notification subsystem: persistent per-target
        delivery queues and ARN routing from the buckets' notification
        configurations. The targets default to the environment's webhooks
        (``MINIO_TPU_NOTIFY_WEBHOOK_ENDPOINT_<ID>``) and the config
        registry's broker targets; the queue root to
        ``MINIO_TPU_NOTIFY_QUEUE_DIR`` or ``.minio-tpu-events`` under the
        working directory."""
        from ..event import EventNotifier, targets_from_env
        from ..event.notifier import targets_from_config
        if targets is None:
            targets = targets_from_env(self.region)
            from ..config import get_config_sys
            targets += targets_from_config(get_config_sys(self.obj),
                                           self.region)
        if not queue_root:
            queue_root = os.environ.get(
                "MINIO_TPU_NOTIFY_QUEUE_DIR",
                os.path.join(os.getcwd(), ".minio-tpu-events"))
        with self._notifier_lock:
            if self._notifier is not None:
                # a listener-only notifier exists and live streams hold
                # subscriptions on it: attach the targets to it
                self._notifier.add_targets(targets, queue_root)
                return self._notifier
            self._notifier = EventNotifier(self.bucket_meta, targets,
                                           queue_root, self.region)
            self._chain(self._notifier)
            return self._notifier

    @property
    def tiers(self):
        """The tier registry (reference globalTierConfigMgr), loaded
        from ``tiers.json`` through the object layer at first use."""
        if self._tiers is None:
            from ..bucket.tiers import TierRegistry
            self._tiers = TierRegistry(self.obj)
        return self._tiers

    @property
    def transition(self):
        """The ILM transition plane over ``tiers``, made at first use."""
        if self._transition is None:
            from ..bucket.transition import TransitionSys
            self._transition = TransitionSys(self.obj, self.tiers,
                                             self.bucket_meta)
        return self._transition

    # --- server lifecycle ---------------------------------------------------

    def build(self) -> ThreadingHTTPServer:
        server = self

        class Handler(_S3Handler):
            s3 = server

        class TunedServer(ThreadingHTTPServer):
            """Listener tuning (reference cmd/http/server.go +
            listener.go): deep accept backlog for bursty S3 clients,
            TCP_NODELAY + keepalive on every accepted connection, and an
            idle read timeout so quiet keep-alive connections release
            their handler thread."""
            request_queue_size = 1024
            daemon_threads = True
            idle_timeout_s = float(os.environ.get(
                "MINIO_TPU_HTTP_IDLE_TIMEOUT_S", "120"))

            def process_request(self, request, client_address):
                try:
                    request.setsockopt(socket.IPPROTO_TCP,
                                       socket.TCP_NODELAY, 1)
                    request.setsockopt(socket.SOL_SOCKET,
                                       socket.SO_KEEPALIVE, 1)
                    if self.idle_timeout_s > 0:
                        request.settimeout(self.idle_timeout_s)
                except OSError:
                    pass
                server._track_conn(request)
                super().process_request(request, client_address)

            def shutdown_request(self, request):
                server._untrack_conn(request)
                super().shutdown_request(request)

            def handle_error(self, request, client_address):
                # a client severing the socket mid-response is normal
                # churn, not a server error
                import sys as _sys
                et = _sys.exc_info()[0]
                if et is not None and issubclass(
                        et, (BrokenPipeError, ConnectionResetError,
                             TimeoutError, socket.timeout)):
                    return
                super().handle_error(request, client_address)

        httpd = TunedServer((self.address, self.port), Handler)
        self._httpd = httpd
        self.port = httpd.server_address[1]
        # the extra addresses: an accept loop each, feeding the same
        # handler and server state (reference xhttp.Listener)
        try:
            for host, port in self.extra_addresses:
                self._extra_httpds.append(TunedServer((host, port), Handler))
        except OSError:
            # a failed extra bind leaks none of the sockets bound so far
            for extra in self._extra_httpds:
                extra.server_close()
            self._extra_httpds = []
            httpd.server_close()
            self._httpd = None
            raise
        self.extra_ports = [x.server_address[1] for x in self._extra_httpds]
        return httpd

    def _start_extra(self) -> None:
        for extra in self._extra_httpds:
            threading.Thread(target=extra.serve_forever,
                             name="minio-tpu-http-extra",
                             daemon=True).start()

    def serve_forever(self):
        httpd = self.build()
        self._start_extra()
        httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        httpd = self.build()
        t = threading.Thread(target=httpd.serve_forever,
                             name="minio-tpu-http", daemon=True)
        t.start()
        self._start_extra()
        return t

    def start_background_services(self):
        """The background plane (reference cmd/server-main.go:508-514
        initAutoHeal / initDataScanner + MRF): the MRF heal queue,
        persisted to ``.minio.sys/mrf.json`` on the first disk and fed by
        every erasure set's ``on_partial`` (a degraded or bitrot-hit read
        queues a heal); the data scanner (a cycle every
        ``MINIO_TPU_SCANNER_INTERVAL_S`` seconds, default 300 as in the JAX
        package: usage accounting, the deep scan's findings to the MRF, the
        durability janitor); the auto-heal monitor over every
        disk (a disk carrying a healing tracker gets a global heal). Every
        set's ``on_disk_state`` is wired so that a health-tracked disk that
        re-onlines gets a healing tracker and kicks the monitor, and the
        objects written while it was down are rebuilt. The scanner applies
        the buckets' lifecycle rules (expiry, and transition through
        ``transition``) and, once ``enable_cross_replication`` has run,
        re-charges replication left PENDING or FAILED. Idempotent."""
        if self.mrf is not None:
            return
        from ..bucket.lifecycle import LifecycleSys
        from ..obs.metrics import _all_disks
        from ..scanner.autoheal import AutoHealMonitor, set_healing_tracker
        from ..scanner.mrf import MRFHealer
        from ..scanner.scanner import DataScanner
        from ..storage.xlstorage import META_BUCKET
        self.mrf = MRFHealer(self.obj)
        disks = _all_disks(self.obj)
        disk = next((d for d in disks if getattr(d, "root", "")), None)
        if disk is not None:
            self.mrf.attach_persistence(
                os.path.join(disk.root, META_BUCKET, "mrf.json"))
        self.mrf.start()
        lc = LifecycleSys(self.obj, self.bucket_meta, self.transition)
        self.scanner = DataScanner(
            self.obj, interval_s=float(os.environ.get(
                "MINIO_TPU_SCANNER_INTERVAL_S", "300")),
            mrf=self.mrf, lifecycle=lc,
            replication=self.replication_sys).start()
        self.autoheal = AutoHealMonitor(self.obj, disks).start()

        def disk_state(disk, state, srv=self):
            if state == "ok" and srv.autoheal is not None:
                try:
                    set_healing_tracker(disk)
                except Exception:  # noqa: BLE001 — disk may still be sick
                    log.warning("healing tracker not set on %s",
                                disk.endpoint(), exc_info=True)
                srv.autoheal.kick()

        for layer in self._erasure_layers():
            layer.on_partial = self.mrf.add_partial
            layer.on_disk_state = disk_state

    def _erasure_layers(self) -> list:
        """Every ErasureObjects under any ObjectLayer shape (one set, a
        sets layer, or server pools)."""
        obj = self.obj
        if hasattr(obj, "pools"):
            out = []
            for p in obj.pools:
                out.extend(p.sets if hasattr(p, "sets") else [p])
            return out
        if hasattr(obj, "sets"):
            return list(obj.sets)
        return [obj] if hasattr(obj, "on_partial") else []

    def shutdown(self):
        for svc in (self.scanner, self.autoheal, self.mrf,
                    self.replication_sys, self.replication, self._notifier):
            if svc is not None:
                svc.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for extra in self._extra_httpds:
            extra.shutdown()
            extra.server_close()

    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"


class _ChunkedWriter:
    """HTTP/1.1 chunked transfer encoding over a raw socket file — lets
    event-stream responses (S3 Select) stream frames without knowing the
    total length up front."""

    def __init__(self, wfile):
        self.wfile = wfile

    def write(self, b: bytes) -> int:
        if b:
            self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")
        return len(b)

    def close(self):
        self.wfile.write(b"0\r\n\r\n")


class _CountingWriter:
    """The response stream, counting the bytes written: the per-bucket
    traffic counters read each request's ``sent`` delta, so streamed GET
    bodies are charged with no hook inside the streaming loops."""

    __slots__ = ("_w", "sent")

    def __init__(self, w):
        self._w = w
        self.sent = 0

    def write(self, b) -> int:
        n = self._w.write(b)
        self.sent += len(b)
        return n

    def __getattr__(self, name):
        return getattr(self._w, name)


class _S3Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    s3: S3Server = None  # set by subclass factory
    #: the request carries ``Expect: 100-continue`` (handle_expect_100)
    _expect_100 = False
    #: when the response's status line went out (TTFB); None before
    _t_first = None

    def setup(self):
        super().setup()
        self.wfile = _CountingWriter(self.wfile)

    def log_message(self, fmt, *args):  # noqa: A003
        pass

    # --- plumbing -----------------------------------------------------------

    def _parse(self):
        split = urllib.parse.urlsplit(self.path)
        self.raw_query = split.query
        self.url_path = urllib.parse.unquote(split.path)
        self.query = urllib.parse.parse_qs(split.query,
                                           keep_blank_values=True)
        parts = self.url_path.lstrip("/").split("/", 1)
        self.bucket = parts[0]
        self.key = parts[1] if len(parts) > 1 else ""
        self.hdr = {k.lower(): v for k, v in self.headers.items()}
        self._consumed = 0  # request-body bytes read (keep-alive hygiene)

    def q(self, key: str, default: str = "") -> str:
        v = self.query.get(key)
        return v[0] if v else default

    def has_q(self, key: str) -> bool:
        return key in self.query

    def _api_name(self) -> str:
        """S3 API name of the request (the reference's api="getobject"
        labels, cmd/metrics-v2.go:147-154); it names the API in a 501."""
        m, b, k = self.command, self.bucket, self.key
        if not b:
            return "listbuckets" if m == "GET" else "sts"
        if k:
            if m == "GET":
                if self.has_q("uploadId"):
                    return "listobjectparts"
                for sub in ("tagging", "retention", "legal-hold", "acl"):
                    if self.has_q(sub):
                        return f"getobject{sub.replace('-', '')}"
                return "getobject"
            if m == "HEAD":
                return "headobject"
            if m == "PUT":
                if self.has_q("partNumber"):
                    return "putobjectpart"
                if "x-amz-copy-source" in self.hdr:
                    return "copyobject"
                for sub in ("tagging", "retention", "legal-hold", "acl"):
                    if self.has_q(sub):
                        return f"putobject{sub.replace('-', '')}"
                return "putobject"
            if m == "POST":
                if self.has_q("uploads"):
                    return "newmultipartupload"
                if self.has_q("uploadId"):
                    return "completemultipartupload"
                if self.has_q("select") or self.q("select-type"):
                    return "selectobjectcontent"
                if self.has_q("restore"):
                    return "restoreobject"
                return "postobject"
            if m == "DELETE":
                if self.has_q("uploadId"):
                    return "abortmultipartupload"
                if self.has_q("tagging"):
                    return "deleteobjecttagging"
                return "deleteobject"
            return m.lower()
        subs = ("policy", "lifecycle", "versioning", "notification",
                "tagging", "object-lock", "replication", "encryption",
                "quota", "versions", "uploads", "location")
        sub = next((s for s in subs if self.has_q(s)), "")
        if m == "GET":
            if sub == "versions":
                return "listobjectversions"
            if sub == "uploads":
                return "listmultipartuploads"
            if sub:
                return f"getbucket{sub.replace('-', '')}"
            return "listobjectsv2" if self.q("list-type") == "2" \
                else "listobjectsv1"
        if m == "HEAD":
            return "headbucket"
        if m == "PUT":
            return f"putbucket{sub.replace('-', '')}" if sub \
                else "putbucket"
        if m == "DELETE":
            return f"deletebucket{sub.replace('-', '')}" if sub \
                else "deletebucket"
        if m == "POST":
            if self.has_q("delete"):
                return "deletemultipleobjects"
            return "postpolicybucket"
        return m.lower()

    def _send(self, status: int, body: bytes = b"",
              content_type: str = "application/xml",
              headers: dict | None = None):
        if self._last_status:
            # a response already started: an error surfacing MID-BODY must
            # not append an error document to the keep-alive framing; cut
            # the connection so the client sees EOF
            self.close_connection = True
            return
        self.send_response(status)
        for k, v in (headers or {}).items():
            if v is not None and v != "":
                self.send_header(k, v)
        if body or status not in (204, 304):
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
        else:
            self.send_header("Content-Length", "0")
        self.end_headers()
        if body and self.command != "HEAD":
            self.wfile.write(body)

    def _error(self, code: str, message: str, status: int):
        if status in (204, 304):  # bodiless statuses per RFC 9110
            return self._send(status)
        self._send(status, xu.error_xml(
            code, message, getattr(self, "url_path", self.path),
            request_id=self._request_id, host_id=host_id()))

    def _api_error(self, e: dt.ObjectAPIError):
        self._error(e.code, str(e), e.http_status)

    def _not_implemented(self, why: str = ""):
        """S3's 501 for an API whose plane the port does not have."""
        self._error("NotImplemented",
                    why or f"{self._api_name()} is not implemented", 501)

    def _read_body(self) -> bytes:
        n = int(self.hdr.get("content-length", "0") or "0")
        data = self.rfile.read(n) if n else b""
        self._consumed += len(data)
        return data

    def _drain_body(self):
        """Discard any unread request body so the next request on this
        keep-alive connection parses cleanly; large remainders close the
        connection instead of burning bandwidth."""
        try:
            n = int(self.hdr.get("content-length", "0") or "0")
        except (AttributeError, ValueError):
            return
        remaining = n - getattr(self, "_consumed", 0)
        if remaining <= 0:
            return
        if remaining > (1 << 20):
            self.close_connection = True
            return
        while remaining > 0:
            chunk = self.rfile.read(min(65536, remaining))
            if not chunk:
                break
            remaining -= len(chunk)

    # --- auth ---------------------------------------------------------------

    def _authenticate(self) -> str:
        headers = dict(self.hdr)
        headers.setdefault("host", self.headers.get("Host", ""))
        return self.s3.verifier.verify(
            self.command, self.url_path, self.query, headers)

    def _authorize(self, access_key: str, action: str,
                   bucket: str | None = None, key: str | None = None):
        """The server's policy gate for ``action`` on this request's bucket
        and key (or the given ones); a denial is 403 AccessDenied."""
        bucket = self.bucket if bucket is None else bucket
        key = self.key if key is None else key
        if not self.s3.authorize(access_key, action, bucket, key):
            raise AuthError("AccessDenied",
                            f"not allowed to {action}" if self.s3.iam
                            is not None else "anonymous access denied")

    def _sts(self, body: bytes):
        """STS (reference cmd/sts-handlers.go:43-93): AssumeRole for a
        signed caller, AssumeRoleWithWebIdentity and
        AssumeRoleWithClientGrants for an OpenID token against the
        configured provider, AssumeRoleWithLDAPIdentity by a simple
        bind. The answer carries the temporary credentials."""
        form = dict(urllib.parse.parse_qsl(body.decode("utf-8", "replace")))
        action = form.get("Action", "AssumeRole")
        try:
            duration = int(form.get("DurationSeconds", "3600") or "3600")
        except ValueError:
            return self._error("InvalidParameterValue",
                               "DurationSeconds must be an integer", 400)
        session_policy = form.get("Policy", "").encode()
        iam = self.s3.iam
        try:
            if action == "AssumeRoleWithWebIdentity":
                cred = iam.assume_role_with_web_identity(
                    form.get("WebIdentityToken", ""), duration,
                    session_policy)
            elif action == "AssumeRoleWithClientGrants":
                cred = iam.assume_role_with_client_grants(
                    form.get("Token", ""), duration, session_policy)
            elif action == "AssumeRoleWithLDAPIdentity":
                cred = iam.assume_role_with_ldap_identity(
                    form.get("LDAPUsername", ""),
                    form.get("LDAPPassword", ""), duration,
                    session_policy)
            elif action == "AssumeRole":
                try:
                    ak = self._authenticate()
                except AuthError as e:
                    return self._error(e.code, e.message, e.status)
                cred = iam.assume_role(ak, duration, session_policy)
            else:
                return self._error("InvalidAction",
                                   f"unsupported STS action {action}", 400)
        except ValueError as e:
            return self._error("InvalidParameterValue", str(e), 400)
        import datetime
        exp = datetime.datetime.fromtimestamp(
            cred.expiration, tz=datetime.timezone.utc
        ).strftime("%Y-%m-%dT%H:%M:%SZ")
        self._send(200, xu.sts_credentials_xml(
            action, cred.access_key, cred.secret_key, exp))

    def _body_stream(self, size: int):
        """Request-body reader honoring aws-chunked streaming signatures:
        either way the object layer reads exactly the signed payload."""
        sha = self.hdr.get("x-amz-content-sha256", "")
        if sha == STREAMING_PAYLOAD:
            auth = parse_auth_header(self.hdr.get("authorization", ""))
            secret = self.s3.lookup_secret(auth.access_key)
            key = signing_key(secret, auth.scope_date, auth.region,
                              auth.service)
            scope = (f"{auth.scope_date}/{auth.region}/{auth.service}/"
                     "aws4_request")
            # chunked framing makes residual length unknowable: if the
            # handler errors mid-stream, close rather than drain
            self._consumed = 1 << 62
            self.close_connection = True
            return ChunkedSigV4Reader(
                self.rfile, auth.signature, key,
                self.hdr.get("x-amz-date", ""), scope)
        return _CappedReader(self.rfile, size, self)

    # --- routing ------------------------------------------------------------

    def _route(self):
        self._parse()
        # unauthenticated health endpoints (cmd/healthcheck-handler.go):
        # liveness = this process serves HTTP; readiness = storage online
        if self.url_path.startswith("/minio/health/"):
            if self.url_path.rstrip("/").endswith("/live"):
                return self._send(200, b"", "text/plain; charset=utf-8")
            ok = self.s3.obj is not None and self.s3.obj.is_ready()
            return self._send(200 if ok else 503, b"",
                              "text/plain; charset=utf-8")
        # internal RPC services (storage, lock, peer — reference
        # registerDistErasureRouters, cmd/routers.go:26-39); served before
        # the object layer exists, as format negotiation needs them
        if self.url_path.startswith("/minio/") and self.s3.internal:
            parts = self.url_path.split("/", 4)
            if len(parts) >= 5 and parts[2] in self.s3.internal:
                return self._internal_rpc(parts[2], parts[4])
        if self.s3.obj is None:
            return self._error("ServerNotInitialized",
                               "server still starting", 503)
        if self.url_path.startswith("/minio/metrics") or \
                self.url_path.startswith("/minio/v2/metrics"):
            from ..obs.metrics import render_prometheus
            scope = "node" if self.url_path.rstrip("/").endswith("/node") \
                else "cluster"
            # exemplars are OpenMetrics-only syntax: on an explicit
            # ?openmetrics=1 only (a classic parser reads a trailing
            # exemplar as an invalid timestamp)
            om = self.q("openmetrics") == "1"
            ctype = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8") if om else \
                "text/plain; version=0.0.4"
            return self._send(200, render_prometheus(
                self.s3, scope, attribution=self.q("attribution") == "1",
                openmetrics=om), ctype)
        if self.url_path.startswith("/minio/admin/"):
            from .admin import handle_admin
            return handle_admin(self)
        if self.url_path.rstrip("/") == "/minio" or \
                self.url_path.startswith("/minio/"):
            # the console and web-RPC planes
            return self._not_implemented(
                f"{self.url_path} is not implemented")
        if self.command == "POST" and self.url_path == "/":
            if self.s3.iam is None:
                return self._not_implemented("STS is not implemented")
            # the STS actions carry their credential in the form (a web
            # identity token has no Authorization header): the Action
            # decides
            body = self._read_body()
            if b"Action=Assume" in body or b"Action=assume" in body:
                return self._sts(body)
        if self.command == "POST" and self.key == "" and \
                self.bucket and self.hdr.get("content-type", "").startswith(
                    "multipart/form-data"):
            return self._not_implemented("POST policy uploads are not "
                                         "implemented")
        try:
            access_key = self._authenticate()
        except AuthError as e:
            # with IAM an unsigned request goes on as the anonymous
            # principal, which only a bucket policy can grant
            if self.s3.iam is not None and e.code == "AccessDenied" and \
                    "no authentication" in e.message:
                access_key = ""
            else:
                return self._error(e.code, e.message, e.status)
        try:
            if self._maybe_forward_federated(access_key):
                return
            self._dispatch(access_key)
        except dt.ObjectAPIError as e:
            self._api_error(e)
        except AuthError as e:
            self._error(e.code, e.message, e.status)
        except (BadDigestError, SHA256MismatchError) as e:
            self._error("BadDigest", str(e), 400)
        except NotImplementedError as e:
            # a plane the port does not have
            self._not_implemented(str(e))
        except BrokenPipeError:
            # client went away mid-response; the half-written reply makes
            # this connection unusable for keep-alive
            self.close_connection = True
        except Exception as e:  # noqa: BLE001
            import traceback
            traceback.print_exc()
            self._error("InternalError", str(e), 500)

    #: federation forwarding: S3 action to enforce locally before the
    #: request is re-signed with cluster credentials — without this gate
    #: a scoped IAM user could escalate to root on the remote cluster
    _FWD_ACTIONS = {"GET": ("s3:GetObject", "s3:ListBucket"),
                    "HEAD": ("s3:GetObject", "s3:ListBucket"),
                    "PUT": ("s3:PutObject", "s3:CreateBucket"),
                    "POST": ("s3:PutObject", "s3:PutObject"),
                    "DELETE": ("s3:DeleteObject", "s3:DeleteBucket")}
    #: request headers a forwarded request carries over
    _FWD_HEADERS = ("content-type", "range", "if-match", "if-none-match",
                    "if-modified-since", "if-unmodified-since",
                    "content-md5")

    def _maybe_forward_federated(self, access_key: str) -> bool:
        """Federation forwarding (reference setBucketForwardingHandler,
        cmd/routers.go:73): when the requested bucket is not here but the
        federation DNS says another cluster owns it, proxy the request
        there re-signed with this cluster's credentials (federated
        clusters share root credentials), after the caller's own policy
        gate. Returns True when the remote's response was served."""
        dns = self.s3.federation
        if dns is None or not self.bucket:
            return False
        if self.command == "PUT" and not self.key and not self.query:
            return False  # bucket create: put_bucket handles it
        try:
            self.s3.obj.get_bucket_info(self.bucket)
            return False  # a bucket of ours: serve it here
        except (dt.BucketNotFound, errors.StorageError):
            pass
        if self.hdr.get("x-minio-tpu-forwarded"):
            # loop guard: a forwarded request that still isn't local here
            # (stale DNS pointing back at us) fails, never re-forwards
            return False
        owners = dns.lookup(self.bucket)
        if not owners or dns.is_mine(owners):
            return False  # unknown everywhere: the local NoSuchBucket
        obj_action, bkt_action = self._FWD_ACTIONS.get(
            self.command, ("s3:PutObject", "s3:PutObject"))
        if self.command == "POST" and "delete" in self.query:
            # multi-object delete rides POST: the delete action decides
            obj_action = bkt_action = "s3:DeleteObject"
        self._authorize(access_key, obj_action if self.key else bkt_action)
        host, port = owners[0]
        # an aws-chunked body's wire length includes its framing; the
        # proxied body is the decoded payload
        if self.hdr.get("x-amz-content-sha256", "") == STREAMING_PAYLOAD:
            size = int(self.hdr.get("x-amz-decoded-content-length",
                                    "0") or "0")
        else:
            size = int(self.hdr.get("content-length", "0") or "0")
        headers = {"host": f"{host}:{port}"}
        for k, v in self.hdr.items():
            if k in self._FWD_HEADERS or k.startswith("x-amz-meta-"):
                headers[k] = v
        headers["x-minio-tpu-forwarded"] = "1"
        headers["authorization"] = self.s3.verifier.sign_request(
            self.s3.access_key, self.s3.secret_key, self.command,
            self.url_path, self.query, headers, UNSIGNED_PAYLOAD)
        headers["content-length"] = str(size)
        qs = urllib.parse.urlencode(
            [(k, v) for k, vs in self.query.items() for v in vs])
        target = urllib.parse.quote(self.url_path) + (f"?{qs}" if qs else "")
        import http.client
        conn = http.client.HTTPConnection(host, port, timeout=30)
        try:
            try:
                conn.putrequest(self.command, target, skip_host=True,
                                skip_accept_encoding=True)
                for k, v in headers.items():
                    conn.putheader(k, v)
                conn.endheaders()
                if size:
                    # stream the body at constant memory
                    src = self._body_stream(size)
                    left = size
                    while left > 0:
                        chunk = src.read(min(left, 1 << 20))
                        if not chunk:
                            break
                        conn.send(chunk)
                        left -= len(chunk)
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException) as e:
                self._error("ServiceUnavailable",
                            f"federated cluster unreachable: {e}", 503)
                return True
            self.send_response(resp.status)
            hop = {"connection", "transfer-encoding", "keep-alive",
                   "x-amz-request-id", "x-amz-id-2"}
            length = resp.getheader("Content-Length")
            for k, v in resp.getheaders():
                if k.lower() not in hop:
                    self.send_header(k, v)
            if length is None:
                body = resp.read()
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.end_headers()
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    self.wfile.write(chunk)
        finally:
            conn.close()
        return True

    def _internal_rpc(self, service: str, method: str):
        """Dispatch an internal RPC call (bearer-token auth, typed errors
        over headers — SURVEY.md A.7 wire shape)."""
        from ..dist.rpc import check_token, rpc_error_response
        auth = self.hdr.get("authorization", "")
        token = auth[len("Bearer "):] if auth.startswith("Bearer ") else ""
        if not check_token(self.s3.secret_key, token):
            return self._send(401, b"invalid rpc token", "text/plain")
        params = {k: v[0] for k, v in self.query.items()}
        body = self._read_body()
        # span propagation: an RPC that carried the caller's traceparent
        # joins that trace — storage, lock and peer spans recorded under
        # this fragment share the caller's trace_id and are stored here
        # for the caller's ?trace_id=...&peers=1 merge
        ctx_in = _sp.parse_traceparent(self.hdr.get(_sp.RPC_HEADER, ""))
        try:
            with _sp.fragment(ctx_in, f"rpc.{service}.{method}",
                              node=f"{self.s3.address}:{self.s3.port}"):
                out = self.s3.internal[service].handle(method, params,
                                                       body)
        except Exception as e:  # noqa: BLE001 — the wire's typed error
            return rpc_error_response(self, e)
        if out is not None and not isinstance(out, (bytes, bytearray)):
            # a streaming method (live trace and console): chunked NDJSON
            # with keep-alive newlines (A.7 framing)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            w = _ChunkedWriter(self.wfile)
            try:
                for chunk in out:
                    if chunk:
                        w.write(chunk)
            except OSError:  # the client went away mid-stream
                self.close_connection = True
                return
            w.close()
            return
        self._send(200, out, "application/octet-stream")

    def _dispatch(self, access_key: str):
        m = self.command
        if not self.bucket:
            if m == "GET":
                return self.list_buckets(access_key)
            return self._error("MethodNotAllowed", "bad service op", 405)
        if not self.key:
            return self._bucket_op(m, access_key)
        return self._object_op(m, access_key)

    #: bucket sub-resources whose planes are not ported (the JAX server
    #: names ``encryption`` in its API table and has no handler for it)
    _BUCKET_501 = ("encryption",)

    def _bucket_op(self, m: str, ak: str):
        s = self
        if any(s.has_q(sub) for sub in self._BUCKET_501):
            return s._not_implemented()
        if m == "PUT":
            if s.has_q("versioning"):
                return s.put_versioning(ak)
            if s.has_q("tagging"):
                return s.put_bucket_tagging(ak)
            if s.has_q("policy"):
                return s.put_bucket_policy(ak)
            if s.has_q("notification"):
                return s.put_bucket_notification(ak)
            if s.has_q("lifecycle"):
                return s.put_bucket_lifecycle(ak)
            if s.has_q("replication"):
                return s.put_bucket_replication(ak)
            if s.has_q("object-lock"):
                return s.put_object_lock_config(ak)
            return s.put_bucket(ak)
        if m in ("GET", "HEAD"):
            if s.has_q("location"):
                return s._send(200, xu.location_xml(s.s3.region))
            if s.has_q("versioning"):
                return s.get_versioning(ak)
            if s.has_q("tagging"):
                return s.get_bucket_tagging(ak)
            if s.has_q("policy"):
                return s.get_bucket_policy(ak)
            if s.has_q("notification"):
                return s.get_bucket_notification(ak)
            if s.has_q("lifecycle"):
                return s.get_bucket_lifecycle(ak)
            if s.has_q("replication"):
                return s.get_bucket_replication(ak)
            if s.has_q("object-lock"):
                return s.get_object_lock_config(ak)
            if s.has_q("uploads"):
                return s.list_uploads(ak)
            if s.has_q("versions"):
                return s.list_versions(ak)
            if s.has_q("events") and m == "GET":
                return s.listen_bucket_notification(ak)
            if m == "HEAD":
                return s.head_bucket(ak)
            return s.list_objects(ak)
        if m == "DELETE":
            if s.has_q("tagging"):
                return s.delete_bucket_tagging(ak)
            if s.has_q("policy"):
                return s.delete_bucket_policy(ak)
            if s.has_q("lifecycle"):
                return s.delete_bucket_lifecycle(ak)
            if s.has_q("replication"):
                return s.delete_bucket_replication(ak)
            return s.delete_bucket(ak)
        if m == "POST":
            if s.has_q("delete"):
                return s.delete_multiple(ak)
        return s._error("MethodNotAllowed", f"bad bucket op {m}", 405)

    def _object_op(self, m: str, ak: str):
        s = self
        if m == "PUT":
            if s.has_q("partNumber") and s.has_q("uploadId"):
                return s.put_part(ak)
            if s.has_q("tagging"):
                return s.put_object_tagging(ak)
            if s.has_q("retention"):
                return s.put_object_retention(ak)
            if s.has_q("legal-hold"):
                return s.put_object_legal_hold(ak)
            if "x-amz-copy-source" in s.hdr:
                return s.copy_object(ak)
            return s.put_object(ak)
        if m == "GET":
            if s.has_q("uploadId"):
                return s.list_parts(ak)
            if s.has_q("tagging"):
                return s.get_object_tagging(ak)
            if s.has_q("retention"):
                return s.get_object_retention(ak)
            if s.has_q("legal-hold"):
                return s.get_object_legal_hold(ak)
            return s.get_object(ak)
        if m == "HEAD":
            return s.head_object(ak)
        if m == "DELETE":
            if s.has_q("uploadId"):
                return s.abort_upload(ak)
            if s.has_q("tagging"):
                return s.delete_object_tagging(ak)
            return s.delete_object(ak)
        if m == "POST":
            if s.has_q("uploads"):
                return s.initiate_upload(ak)
            if s.has_q("uploadId"):
                return s.complete_upload(ak)
            if s.has_q("select") or s.q("select-type"):
                return s.select_object_content(ak)
            if s.has_q("restore"):
                return s.restore_object(ak)
        return s._error("MethodNotAllowed", f"bad object op {m}", 405)

    def select_object_content(self, ak):
        """SelectObjectContent (reference cmd/object-handlers.go:96 ->
        pkg/s3select): run the SQL over the object and stream event-stream
        frames; a CSV WHERE scans on the server's device (K6 on the card).
        Encrypted objects are decrypted first."""
        self._authorize(ak, "s3:GetObject")
        from ..erasure.streaming import BufferSink
        from ..s3select import S3SelectRequest, parse_select, run_select
        from ..s3select.sql import SQLError
        body = self._read_body()
        try:
            req = S3SelectRequest.parse(body)
            # validate the SQL BEFORE reading the object (a bad expression
            # must 400 without paying the read; frames stream chunked
            # after the 200, so late errors can only abort mid-stream)
            parsed = parse_select(req.expression)
        except (ET.ParseError, SQLError) as e:
            return self._error("InvalidRequest", str(e), 400)
        opts = self._opts()
        oi = self.s3.obj.get_object_info(self.bucket, self.key, opts)
        sse = self._sse_read_ctx(oi)
        sink = BufferSink()
        # BytesScanned = input consumed from storage (the ciphertext, the
        # compressed stream); the engine reports the decoded size as
        # BytesProcessed
        scanned = oi.size
        if sse:
            from ..crypto import DecryptWriter, enc_size
            oek, base_iv, plain_size, _, cipher = sse
            scanned = enc_size(plain_size)
            dw = DecryptWriter(sink, oek, base_iv, 0, 0, plain_size,
                               self.bucket, self.key, cipher=cipher,
                               device=self.s3.device)
            self.s3.obj.get_object(self.bucket, self.key, dw, 0, -1, opts)
            dw.finish()
        elif oi.internal.get(META_COMPRESSION):
            # the SQL engine needs the plaintext
            dz = cz.decompress_writer(oi.internal[META_COMPRESSION], sink)
            self.s3.obj.get_object(self.bucket, self.key, dz, 0, -1, opts)
            dz.finish()
        else:
            self.s3.obj.get_object(self.bucket, self.key, sink, 0, -1, opts)
        raw = sink.getvalue()
        self.send_response(200)
        self.send_header("Content-Type",
                         "application/vnd.amazon.eventstream")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        out = _ChunkedWriter(self.wfile)
        try:
            run_select(req, raw, out, parsed=parsed, scanned_bytes=scanned,
                       device=self.s3.device)
        except Exception:  # noqa: BLE001 — mid-stream failure: cut the
            self.close_connection = True  # connection, the client sees EOF
            return
        out.close()

    # --- HTTP verbs ---------------------------------------------------------

    def send_response(self, code, message=None):  # noqa: N802
        self._last_status = code
        if self._t_first is None:
            self._t_first = time.perf_counter()  # TTFB anchor
        super().send_response(code, message)
        # every response carries the request id and host id (reference
        # setAmzRequestID middleware: x-amz-request-id + x-amz-id-2)
        self.send_header("x-amz-request-id", self._request_id)
        self.send_header("x-amz-id-2", host_id())

    def _admit(self):
        """Admission control ahead of routing: object and control-plane
        requests pass their class's token bucket and the bounded-wait
        concurrency gate or are answered ``503 SlowDown`` + ``Retry-After``.
        Health, metrics and admin planes are exempt: an overloaded server
        stays observable. Returns (proceed, release callback)."""
        adm = self.s3.qos_admission
        # kept for the finish-side tail sampling: a trace is judged under
        # the class it was admitted under
        cls = self._qos_class = classify_request(
            self.command, self.path, internal=self.s3.internal)
        if cls is None:
            return True, None
        grant = adm.admit(cls)
        if grant.ok:
            return True, lambda: adm.release(grant)
        _mx.inc("minio_tpu_qos_admission_rejects_total",
                reason=grant.reason, **{"class": cls})
        # parsed so the request's counters and trace name it; the body
        # stays unread, so the connection closes (and says so)
        self._parse()
        self.close_connection = True
        self._send(
            503,
            xu.error_xml(
                "SlowDown",
                "request rate/concurrency limit exceeded; reduce "
                "your request rate", self.url_path,
                request_id=self._request_id, host_id=host_id()),
            headers={"Retry-After": adm.retry_after_header(grant),
                     "Connection": "close"})
        return False, None

    def _span_exempt(self, path: str, query: str = "") -> bool:
        """Requests that open no request-scoped trace: health and metrics
        probes (the planes admission exempts) and the long polls whose
        duration the client chooses, admin trace follows and bucket event
        listens (a GET of a bucket with an ``events`` parameter)."""
        if plane_exempt(path, internal=self.s3.internal) or (
                path.startswith("/minio/admin/")
                and path.rstrip("/").endswith("/trace")):
            return True
        if self.command == "GET" and "events=" in query and \
                not path.startswith("/minio/"):
            parts = path.lstrip("/").split("/", 1)
            bucket_level = len(parts) < 2 or parts[1] == ""
            return bucket_level and "events" in urllib.parse.parse_qs(
                query, keep_blank_values=True)
        return False

    def handle_expect_100(self):
        """``Expect: 100-continue``: the interim 100 waits for admission
        (``_handle``), so a request the gate refuses gets its 503 before
        its client sends the body — as the reference's server, which
        answers 100 only when a handler first reads the body."""
        self._expect_100 = True
        return True

    def _handle(self):
        """Route one request inside the observability plane: admission,
        a root span (its trace id is the request id), the request
        counters and latencies, the per-API window and the http trace.
        Admission 503s run inside it, so they are counted and traced like
        every other response."""
        self._last_status = 0
        self._t_first = None
        rid = _sp.new_trace_id()
        self._request_id = rid
        raw_path, _, raw_query = self.path.partition("?")
        root = tok = None
        self._exempt = self._span_exempt(raw_path, raw_query)
        if _sp.enabled() and not self._exempt:
            root, tok = _sp.begin_request(rid)
        t0 = time.perf_counter()
        sent_mark = self.wfile.sent
        release = None
        try:
            proceed, release = self._admit()
            # the sampling profiler joins this worker's samples to its
            # admitted class and op through the per-thread tag registry
            # (context variables are not visible across threads)
            _prof.set_task_tag(self._qos_class or "control",
                               f"s3.{self.command.lower()}")
            if proceed:
                if self._expect_100:
                    self.send_response_only(100)
                    self.end_headers()
                self._route()
        finally:
            _prof.clear_task_tag()
            self._expect_100 = False
            if release is not None:
                release()
            try:
                self._drain_body()
            except Exception:  # noqa: BLE001
                self.close_connection = True
            self._observe(rid, root, tok, time.perf_counter() - t0, t0,
                          self.wfile.sent - sent_mark)

    def _observe(self, rid: str, root, tok, dur: float, t0: float,
                 sent: int) -> None:
        """The finished request's counters, latency window, bucket
        analytics, trace event, audit entry and root span (with the
        tail-sampling decision). ``sent`` is the bytes of its response."""
        status = self._last_status
        path = getattr(self, "url_path", self.path)
        api = f"s3.{self.command}"
        if path.startswith("/minio/admin/"):
            api = "admin"
        elif path.startswith("/minio/"):
            api = "internal"
        api_detail = api
        traced = root is not None and root.sampled
        _mx.inc("minio_tpu_requests_total", api=api, code=str(status))
        _mx.observe("minio_tpu_request_duration_seconds", dur, api=api)
        ttfb = (self._t_first or time.perf_counter()) - t0
        if api.startswith("s3."):
            name = self._api_name()
            api_detail = f"s3.{name}"
            _mx.inc("minio_tpu_s3_requests_total", api=name)
            if status >= 400:
                _mx.inc("minio_tpu_s3_requests_errors_total", api=name)
            _mx.observe("minio_tpu_s3_ttfb_seconds", ttfb, api=name)
            if root is not None:
                _lat.observe("api", dur, 0, trace_id=rid if traced else "",
                             api=name)
            # the bucket's analytics (bounded registry); long-polls stay
            # out, their duration being the client's choice
            bkt = getattr(self, "bucket", "")
            if bkt and not self._exempt:
                _bs.record_request(bkt, name, status, dur, ttfb_s=ttfb,
                                   bytes_in=getattr(self, "_consumed", 0),
                                   bytes_out=sent)
        elif api == "admin" and root is not None:
            _lat.observe("api", dur, 0, trace_id=rid if traced else "",
                         api="admin")
        node = f"{self.s3.address}:{self.s3.port}"
        info = _trc.TraceInfo(
            node=node, func=api, method=self.command, path=path,
            query=getattr(self, "raw_query", ""), status=status,
            duration_s=dur, ttfb_s=ttfb,
            input_bytes=int(getattr(self, "hdr", {}).get(
                "content-length", "0") or 0),
            remote=self.client_address[0], trace_id=rid,
            span_id=root.span_id if root is not None else "")
        _trc.publish(info)
        if api != "internal":
            # the audit entry: the trace record, joined to the trace by
            # its request id, with the API's name
            entry = info.to_dict()
            entry["request_id"] = rid
            entry["api"] = api_detail
            log_sys().audit(entry)
        # the SLO plane: an admitted request (an admission 503 included)
        # burns its class's error budget; the exempt planes carry no
        # objective, and a trace follow's duration is the client's choice
        qcls = getattr(self, "_qos_class", None)
        if qcls is not None and not self._exempt:
            _slo.record(qcls, dur, status=status,
                        trace_id=rid if traced else "",
                        bucket=getattr(self, "bucket", "")
                        if api.startswith("s3.") else "")
        if root is not None:
            _sp.finish_request(
                root, tok, name=api_detail, method=self.command, path=path,
                status=status, duration_s=dur,
                cls=qcls or "control",
                node=node, remote=self.client_address[0])
            kept = _sp.store().get(rid) if root.sampled else None
            if kept is not None and any(
                    s.get("name", "").startswith("rpc.")
                    for s in kept.get("spans", ())):
                # the trace was KEPT and fanned out over RPC: snapshot
                # the peers' fragments now, before their small stores
                # churn them out (one bounded background worker)
                peers = self.s3.peers()
                if peers:
                    _sp.schedule_collect(rid, peers)

    def do_GET(self):  # noqa: N802
        self._handle()

    def do_PUT(self):  # noqa: N802
        self._handle()

    def do_POST(self):  # noqa: N802
        self._handle()

    def do_DELETE(self):  # noqa: N802
        self._handle()

    def do_HEAD(self):  # noqa: N802
        self._handle()

    # --- service ------------------------------------------------------------

    def list_buckets(self, ak):
        self._authorize(ak, "s3:ListAllMyBuckets")
        buckets = self.s3.obj.list_buckets()
        if self.s3.federation is not None:
            # the federated namespace is the union of every cluster's
            # buckets (cmd/bucket-handlers.go ListBuckets with etcd)
            have = {b.name for b in buckets}
            for name in sorted(self.s3.federation.list_buckets()):
                if name not in have:
                    buckets.append(dt.BucketInfo(name=name))
        self._send(200, xu.list_buckets_xml(buckets))

    # --- bucket -------------------------------------------------------------

    def put_bucket(self, ak):
        self._authorize(ak, "s3:CreateBucket")
        self.s3.create_bucket(
            self.bucket,
            object_lock=self.hdr.get(
                "x-amz-bucket-object-lock-enabled", "") == "true")
        self._send(200, headers={"Location": f"/{self.bucket}"})

    def head_bucket(self, ak):
        self._authorize(ak, "s3:ListBucket")
        self.s3.obj.get_bucket_info(self.bucket)
        self._send(200)

    def delete_bucket(self, ak):
        self._authorize(ak, "s3:DeleteBucket")
        force = self.hdr.get("x-minio-force-delete", "") == "true"
        self.s3.remove_bucket(self.bucket, force=force)
        self._send(204)

    @staticmethod
    def _display_sizes(r):
        """Listings report the size GET/HEAD do: the plaintext size of an
        encrypted or compressed object, not the stored stream length, and
        a transitioned stub's archived size."""
        from ..bucket import transition as tx
        from ..crypto import META_SCHEME, plain_size_of
        for oi in r.objects:
            if oi.internal.get(META_SCHEME):
                oi.size = plain_size_of(oi.internal, oi.size)
            elif oi.internal.get(META_COMPRESSION):
                oi.size = oi.actual_size
            elif tx.is_transitioned(oi) and oi.size == 0:
                oi.size = tx.transitioned_size(oi)
        return r

    def list_objects(self, ak):
        self._authorize(ak, "s3:ListBucket")
        prefix = self.q("prefix")
        delimiter = self.q("delimiter")
        max_keys = min(int(self.q("max-keys", "1000") or "1000"), 10_000)
        if self.q("list-type") == "2":
            marker = self.q("continuation-token") or self.q("start-after")
            r = self._display_sizes(self.s3.obj.list_objects(
                self.bucket, prefix, marker, delimiter, max_keys))
            return self._send(200, xu.list_objects_v2_xml(
                self.bucket, prefix, delimiter, max_keys, r,
                continuation_token=self.q("continuation-token")))
        marker = self.q("marker")
        r = self._display_sizes(self.s3.obj.list_objects(
            self.bucket, prefix, marker, delimiter, max_keys))
        self._send(200, xu.list_objects_v1_xml(
            self.bucket, prefix, delimiter, marker, max_keys, r))

    def list_versions(self, ak):
        self._authorize(ak, "s3:ListBucketVersions")
        prefix = self.q("prefix")
        delimiter = self.q("delimiter")
        max_keys = min(int(self.q("max-keys", "1000") or "1000"), 10_000)
        r = self._display_sizes(self.s3.obj.list_object_versions(
            self.bucket, prefix, self.q("key-marker"),
            self.q("version-id-marker"), delimiter, max_keys))
        self._send(200, xu.list_versions_xml(
            self.bucket, prefix, delimiter, max_keys, r))

    def put_versioning(self, ak):
        self._authorize(ak, "s3:PutBucketVersioning")
        self.s3.obj.get_bucket_info(self.bucket)
        enabled = xu.parse_versioning(self._read_body())
        was = self.s3.bucket_meta.get(self.bucket)
        if was.object_lock_enabled and not enabled:
            # suspending versioning would let WORM-retained versions be
            # hard-deleted via versionless deletes
            raise dt.InvalidRequest(
                self.bucket, "",
                "cannot suspend versioning on an object-lock bucket")
        self.s3.bucket_meta.update(
            self.bucket, versioning_enabled=enabled,
            versioning_suspended=not enabled and
            (was.versioning_enabled or was.versioning_suspended))
        self._send(200)

    def get_versioning(self, ak):
        self._authorize(ak, "s3:GetBucketVersioning")
        self.s3.obj.get_bucket_info(self.bucket)
        meta = self.s3.bucket_meta.get(self.bucket)
        self._send(200, xu.versioning_xml(meta.versioning_enabled,
                                          meta.versioning_suspended))

    def put_bucket_tagging(self, ak):
        self._authorize(ak, "s3:PutBucketTagging")
        self.s3.obj.get_bucket_info(self.bucket)
        tags = xu.parse_tagging(self._read_body())
        self.s3.bucket_meta.update(self.bucket, tagging=tags)
        self._send(200)

    def get_bucket_tagging(self, ak):
        self._authorize(ak, "s3:GetBucketTagging")
        meta = self.s3.bucket_meta.get(self.bucket)
        if not meta.tagging:
            return self._error("NoSuchTagSet", "no tags", 404)
        self._send(200, xu.tagging_xml(meta.tagging))

    def delete_bucket_tagging(self, ak):
        self._authorize(ak, "s3:PutBucketTagging")
        self.s3.bucket_meta.update(self.bucket, tagging={})
        self._send(204)

    def put_bucket_policy(self, ak):
        self._authorize(ak, "s3:PutBucketPolicy")
        self.s3.obj.get_bucket_info(self.bucket)
        self.s3.bucket_meta.update(self.bucket,
                                   policy_json=self._read_body())
        self._send(204)

    def get_bucket_policy(self, ak):
        self._authorize(ak, "s3:GetBucketPolicy")
        meta = self.s3.bucket_meta.get(self.bucket)
        if not meta.policy_json:
            return self._error("NoSuchBucketPolicy", "no policy", 404)
        self._send(200, meta.policy_json, "application/json")

    def delete_bucket_policy(self, ak):
        self._authorize(ak, "s3:DeleteBucketPolicy")
        self.s3.bucket_meta.update(self.bucket, policy_json=b"")
        self._send(204)

    # --- bucket notification, lifecycle, replication ------------------------

    def listen_bucket_notification(self, ak):
        """The live event stream (the reference's ListenBucketNotification
        extension): GET /bucket?events=<pattern>&prefix=&suffix= streams
        the matching events as JSON lines over chunked encoding, a blank
        keep-alive line every 5 s of silence. It needs no stored
        notification configuration; ``?timeout`` bounds the stream."""
        import queue as qmod
        self._authorize(ak, "s3:ListenBucketNotification")
        self.s3.obj.get_bucket_info(self.bucket)
        # listening needs the event plane: attach it lazily with no
        # targets (queues exist per target, listeners are free)
        notifier = self.s3.ensure_notifier()
        events = tuple(v for vs in self.query.get("events", [])
                       for v in (vs.split(",") if vs else [])) or ("s3:*",)
        try:
            timeout = float(self.q("timeout", "86400") or "86400")
        except ValueError:
            timeout = -1.0
        if not timeout > 0:  # rejects 0, negatives and NaN
            raise dt.InvalidRequest(self.bucket, "",
                                    "invalid listen timeout")
        sub = notifier.listen(self.bucket, self.q("prefix"),
                              self.q("suffix"), events)
        try:  # every exit unlistens, or the dead subscription keeps
            # collecting events
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            out = _ChunkedWriter(self.wfile)
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                try:
                    rec = sub.q.get(timeout=min(
                        5.0, max(0.0, deadline - time.monotonic())))
                except qmod.Empty:
                    out.write(b" \n")  # keep-alive
                    self.wfile.flush()
                    continue
                out.write((json.dumps({"Records": [rec]},
                                      separators=(",", ":")) + "\n")
                          .encode())
                self.wfile.flush()
            out.close()
        except OSError:
            pass  # the client went away: the normal end of a listen
        finally:
            notifier.unlisten(sub)
            self.close_connection = True

    def put_bucket_notification(self, ak):
        self._authorize(ak, "s3:PutBucketNotification")
        self.s3.obj.get_bucket_info(self.bucket)
        body = self._read_body()
        from ..event import parse_notification_xml
        try:
            parsed = parse_notification_xml(body)
        except Exception:  # noqa: BLE001 — malformed XML
            return self._error("MalformedXML",
                               "invalid notification configuration", 400)
        notifier = self.s3._notifier
        if notifier is not None and notifier.targets:
            # a listener-only notifier (no targets) accepts every ARN, as
            # a server without a notifier does
            unknown = notifier.unknown_arns(parsed)
            if unknown:
                return self._error(
                    "InvalidArgument",
                    f"unknown notification target ARN(s): "
                    f"{', '.join(unknown)}", 400)
        self.s3.bucket_meta.update(self.bucket, notification_xml=body)
        if notifier is not None:
            notifier.invalidate(self.bucket)
        self._send(200)

    def get_bucket_notification(self, ak):
        self._authorize(ak, "s3:GetBucketNotification")
        meta = self.s3.bucket_meta.get(self.bucket)
        self._send(200, meta.notification_xml or
                   b'<?xml version="1.0" encoding="UTF-8"?>'
                   b'<NotificationConfiguration '
                   b'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"/>')

    def put_bucket_lifecycle(self, ak):
        self._authorize(ak, "s3:PutLifecycleConfiguration")
        self.s3.obj.get_bucket_info(self.bucket)
        self.s3.bucket_meta.update(self.bucket,
                                   lifecycle_xml=self._read_body())
        self._send(200)

    def get_bucket_lifecycle(self, ak):
        self._authorize(ak, "s3:GetLifecycleConfiguration")
        meta = self.s3.bucket_meta.get(self.bucket)
        if not meta.lifecycle_xml:
            return self._error("NoSuchLifecycleConfiguration",
                               "no lifecycle", 404)
        self._send(200, meta.lifecycle_xml)

    def delete_bucket_lifecycle(self, ak):
        self._authorize(ak, "s3:PutLifecycleConfiguration")
        self.s3.bucket_meta.update(self.bucket, lifecycle_xml=b"")
        self._send(204)

    def put_bucket_replication(self, ak):
        """PUT ?replication: the rules validate before they persist (a
        rule without a destination would charge obligations nothing can
        pay)."""
        self._authorize(ak, "s3:PutReplicationConfiguration")
        self.s3.obj.get_bucket_info(self.bucket)
        body = self._read_body()
        from ..bucket import replicate as repl
        try:
            repl.validate_replication(body)
        except (ET.ParseError, ValueError) as e:
            return self._error("MalformedXML", str(e), 400)
        self.s3.bucket_meta.update(self.bucket, replication_xml=body)
        self._send(200)

    def get_bucket_replication(self, ak):
        self._authorize(ak, "s3:GetReplicationConfiguration")
        meta = self.s3.bucket_meta.get(self.bucket)
        if not meta.replication_xml:
            return self._error("ReplicationConfigurationNotFoundError",
                               "no replication config", 404)
        self._send(200, meta.replication_xml)

    def delete_bucket_replication(self, ak):
        self._authorize(ak, "s3:PutReplicationConfiguration")
        self.s3.bucket_meta.update(self.bucket, replication_xml=b"")
        self._send(204)

    def delete_multiple(self, ak):
        self._authorize(ak, "s3:DeleteObject")
        objs, quiet = xu.parse_delete_objects(self._read_body())
        versioned = self.s3.bucket_meta.versioning_enabled(self.bucket)
        # WORM: a version delete under retention or legal hold is refused
        # per key, not for the whole request
        locked_errs: list = []
        if self.s3.bucket_meta.get(self.bucket).object_lock_enabled:
            allowed = []
            for idx, obj in enumerate(objs):
                vid = "" if isinstance(obj, str) else obj.get(
                    "version_id", "")
                name = obj if isinstance(obj, str) else obj["object"]
                if vid:
                    try:
                        self._check_delete_lock(ak, ObjectOptions(
                            version_id=vid, versioned=versioned), key=name)
                    except dt.ObjectAPIError as e:
                        # key and version kept, so the <Error> entry names
                        # what was refused
                        locked_errs.append((idx, name, vid, e))
                        continue
                allowed.append(obj)
            objs = allowed
        deleted, errs = self.s3.obj.delete_objects(
            self.bucket, objs, ObjectOptions(versioned=versioned))
        for idx, name, vid, e in locked_errs:
            deleted.insert(idx, dt.DeletedObject(object_name=name,
                                                 version_id=vid))
            errs.insert(idx, e)
        ok_deleted = [d for d, e in zip(deleted, errs) if e is None]
        if quiet:
            # quiet mode reports only failures
            pairs = [(d, e) for d, e in zip(deleted, errs) if e is not None]
            deleted = [d for d, _ in pairs]
            errs = [e for _, e in pairs]
        self._send(200, xu.delete_result_xml(deleted, errs))
        if self.s3.notify is not None:
            for d in ok_deleted:
                if d is not None:
                    self.s3.notify("s3:ObjectRemoved:Delete", self.bucket,
                                   dt.ObjectInfo(bucket=self.bucket,
                                                 name=d.object_name))

    # --- object -------------------------------------------------------------

    def _opts(self, versioned=None) -> ObjectOptions:
        if versioned is None:
            versioned = self.s3.bucket_meta.versioning_enabled(self.bucket)
        return ObjectOptions(version_id=self.q("versionId"),
                             versioned=versioned)

    def _notify(self, event: str, oi):
        if self.s3.notify is not None:
            self.s3.notify(event, self.bucket, oi)

    def _lock_ctx(self):
        """(object lock enabled, the bucket's default retention)."""
        from ..bucket import objectlock as ol
        meta = self.s3.bucket_meta.get(self.bucket)
        default = ol.DefaultRetention()
        if meta.object_lock_enabled and meta.object_lock_xml:
            try:
                default = ol.parse_lock_config(meta.object_lock_xml)
            except ValueError:
                pass
        return meta.object_lock_enabled, default

    def _charge_replication(self) -> bool:
        """True when the cross-node replication plane owes this key a
        copy (its status is charged PENDING with the write)."""
        rs = self.s3.replication_sys
        return rs is not None and \
            rs.heads_up(self.bucket, self.key) is not None

    def put_object(self, ak):
        self._authorize(ak, "s3:PutObject")
        size = int(self.hdr.get("content-length", "-1") or "-1")
        if self.hdr.get("x-amz-content-sha256", "") == STREAMING_PAYLOAD:
            size = int(self.hdr.get("x-amz-decoded-content-length",
                                    str(size)))
        if size < 0:
            # unbounded socket reads hang keep-alive connections
            return self._error("MissingContentLength",
                               "Content-Length required", 411)
        if size > MAX_PUT_SIZE:
            raise dt.EntityTooLarge(self.bucket, self.key)
        user_defined = self._user_meta()
        # object lock: the request's headers validated, else the bucket's
        # default retention
        from ..bucket import objectlock as olock
        lock_enabled, lock_default = self._lock_ctx()
        user_defined.update(olock.check_put_headers(
            self.hdr, self.bucket, self.key, lock_enabled, lock_default))
        self._check_quota(size)
        hr = self._hash_reader(size)
        from ..crypto import encrypt_setup, parse_sse_headers
        sse = parse_sse_headers(self.hdr, self.bucket, self.key)
        stream, put_size = hr, size
        sse_resp = {}
        opts = self._opts()
        if sse is not None:
            stream, put_size, sse_resp = encrypt_setup(
                sse, hr, size, user_defined, self.bucket, self.key,
                device=self.s3.device)
        elif cz.should_compress(self.key,
                                user_defined.get("content-type", "")):
            # the compressed length is unknown up front: the object layer
            # streams to EOF (size -1) and records the stored length; the
            # ETag stays the plaintext's MD5 (etag_source)
            user_defined[META_COMPRESSION] = cz.algo()
            user_defined[META_ACTUAL_SIZE] = str(size)
            stream, put_size = cz.compress_reader(hr), -1
            opts.etag_source = hr
        if self._charge_replication():
            # the status lands in xl.meta with the write itself; the
            # notify chain queues the debt
            from ..bucket import replicate as repl
            user_defined[repl.META_REP_STATUS] = repl.PENDING
        opts.user_defined = user_defined
        oi = self.s3.obj.put_object(self.bucket, self.key, stream, put_size,
                                    opts)
        if stream is not hr:
            # the response and the event records speak plaintext sizes
            oi.size = size
        self._send(200, headers={
            "ETag": f'"{oi.etag}"',
            "x-amz-version-id": oi.version_id or None,
            **sse_resp})
        self._notify("s3:ObjectCreated:Put", oi)

    def _sse_read_ctx(self, oi):
        """(oek, base_iv, plain_size, response headers, package cipher)
        of an encrypted object, unsealed with this request's SSE-C key (a
        wrong key MD5 403s before any package is read) or through the KMS
        (an outage 503s, a wrong master key 403s); None for a plain
        object."""
        from ..crypto import sse_read_ctx
        return sse_read_ctx(oi.internal, self.hdr, self.bucket, self.key,
                            oi.size, device=self.s3.device)

    def _hash_reader(self, size: int) -> HashReader:
        """Body reader verifying Content-MD5 / x-amz-content-sha256 on the
        fly — shared by PutObject and UploadPart so the two paths can't
        diverge."""
        sha = self.hdr.get("x-amz-content-sha256", "")
        sha_hex = sha if sha and sha not in (
            UNSIGNED_PAYLOAD, STREAMING_PAYLOAD) else ""
        md5_b64 = self.hdr.get("content-md5", "")
        md5_hex = ""
        if md5_b64:
            try:
                decoded = base64.b64decode(md5_b64, validate=True)
            except (binascii.Error, ValueError) as e:
                raise dt.InvalidDigest(self.bucket, self.key) from e
            if len(decoded) != 16:
                raise dt.InvalidDigest(self.bucket, self.key)
            md5_hex = decoded.hex()
        return HashReader(self._body_stream(size), size, md5_hex, sha_hex)

    def _user_meta(self) -> dict[str, str]:
        out = {}
        ct = self.hdr.get("content-type")
        if not ct and self.key:
            # extension-based detection via the curated mimedb table
            from ..utils.mimedb import content_type
            ct = content_type(self.key)
        if ct:
            out["content-type"] = ct
        for k, v in self.hdr.items():
            if k.startswith("x-amz-meta-"):
                out[k] = v
        for k in ("cache-control", "content-disposition",
                  "content-encoding", "content-language", "expires"):
            if k in self.hdr:
                out[k] = self.hdr[k]
        return out

    def _obj_headers(self, oi) -> dict:
        h = {
            "ETag": f'"{oi.etag}"',
            "Last-Modified": xu.http_date(oi.mod_time),
            "Content-Type": oi.content_type or "application/octet-stream",
            "Accept-Ranges": "bytes",
            "x-amz-version-id": oi.version_id or None,
        }
        for k, v in oi.user_defined.items():
            if k.startswith("x-amz-meta-") or \
                    k.startswith("x-amz-object-lock-") or k in (
                    "cache-control", "content-disposition",
                    "content-encoding", "content-language", "expires"):
                h[k] = v
        return h

    def _parse_range(self, total: int):
        rng = self.hdr.get("range", "")
        if not rng.startswith("bytes="):
            return None
        spec = rng[len("bytes="):].split(",")[0].strip()
        start_s, _, end_s = spec.partition("-")
        try:
            if start_s == "":
                n = int(end_s)
                if n == 0:
                    raise dt.InvalidRange(self.bucket, self.key)
                start, end = max(0, total - n), total - 1
            else:
                start = int(start_s)
                end = int(end_s) if end_s else total - 1
        except ValueError:
            return None
        if start >= total or end < start:
            raise dt.InvalidRange(self.bucket, self.key)
        return start, min(end, total - 1)

    def _proxy_get(self) -> bool:
        """A GET of an object not held here, served from the bucket's
        replication target when there is one (reference proxy-to-target
        on a GET miss); False when nothing served it."""
        pool = self.s3.replication
        res = pool.proxy_get(self.bucket, self.key,
                             self.hdr.get("range", "")) \
            if pool is not None else None
        if res is None:
            return False
        status, chunks, hdrs, clen = res
        self.send_response(status)
        for k, v in hdrs.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(clen))
        self.send_header("x-minio-proxied-from-target", "true")
        self.end_headers()
        for chunk in chunks:  # streamed, never wholly resident
            if chunk:
                self.wfile.write(chunk)
        return True

    def get_object(self, ak):
        self._authorize(ak, "s3:GetObject")
        opts = self._opts()
        try:
            oi = self.s3.obj.get_object_info(self.bucket, self.key, opts)
        except dt.ObjectNotFound:
            if self._proxy_get():
                return
            raise
        self._check_preconditions(oi)
        from ..bucket import transition as tx
        if tx.is_transitioned(oi) and oi.size == 0:
            # a stub: read through from the tier
            return self._get_transitioned(oi)
        sse = self._sse_read_ctx(oi)
        compressed = oi.internal.get(META_COMPRESSION, "")
        logical_size = sse[2] if sse else (
            oi.actual_size if compressed else oi.size)
        rng = self._parse_range(logical_size) if logical_size > 0 else None
        headers = self._obj_headers(oi)
        if sse:
            headers.update(sse[3])
        if rng is None:
            offset, length = 0, logical_size
            status = 200
        else:
            offset, length = rng[0], rng[1] - rng[0] + 1
            status = 206
            headers["Content-Range"] = \
                f"bytes {rng[0]}-{rng[1]}/{logical_size}"
        self.send_response(status)
        for k, v in headers.items():
            if v:
                self.send_header(k, v)
        self.send_header("Content-Length", str(length))
        self.end_headers()
        if length <= 0:
            return
        if sse:
            from ..crypto import DecryptWriter, decrypt_range_bounds
            oek, base_iv, plain_size, _, cipher = sse
            enc_off, enc_len, seq0, skip = decrypt_range_bounds(
                offset, length, plain_size)
            dw = DecryptWriter(self.wfile, oek, base_iv, seq0, skip, length,
                               self.bucket, self.key, cipher=cipher,
                               device=self.s3.device)
            if enc_len > 0:
                self.s3.obj.get_object(self.bucket, self.key, dw, enc_off,
                                       enc_len, opts)
            dw.finish()
        elif compressed:
            # inflate the whole stored stream and trim to the plaintext
            # range (the reference's compressed-range behaviour)
            dz = cz.decompress_writer(compressed, self.wfile, skip=offset,
                                      limit=length)
            self.s3.obj.get_object(self.bucket, self.key, dz, 0, -1, opts)
            dz.finish()
        else:
            self.s3.obj.get_object(self.bucket, self.key, self.wfile,
                                   offset, length, opts)
        self._notify("s3:ObjectAccessed:Get", oi)

    def _get_transitioned(self, oi):
        """GET of a transitioned stub: the bytes read through from its
        tier (reference getTransitionedObjectReader)."""
        from ..bucket import transition as tx
        try:
            data = self.s3.transition.read(oi)
        except Exception:  # noqa: BLE001 — the tier is unreachable
            return self._error("InvalidObjectState",
                               "transitioned object's tier unavailable",
                               403)
        rng = self._parse_range(len(data)) if data else None
        headers = self._obj_headers(oi)
        headers["x-amz-storage-class"] = oi.internal.get(tx.META_TIER, "")
        if rng is None:
            body, status = data, 200
        else:
            body, status = data[rng[0]:rng[1] + 1], 206
            headers["Content-Range"] = \
                f"bytes {rng[0]}-{rng[1]}/{len(data)}"
        self.send_response(status)
        for k, v in headers.items():
            if v:
                self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self._notify("s3:ObjectAccessed:Get", oi)

    def restore_object(self, ak):
        """POST ?restore (reference PostRestoreObjectHandler): a
        transitioned object's bytes come back locally for ``Days`` days;
        an already restored copy only has its expiry moved."""
        self._authorize(ak, "s3:RestoreObject")
        from ..bucket import objectlock as ol
        from ..bucket import transition as tx
        days = 1
        body = self._read_body()
        if body.strip():
            try:
                days = int(ol.findtext(ET.fromstring(body), "Days") or "1")
            except ET.ParseError as e:
                return self._error("MalformedXML", str(e), 400)
        oi = self.s3.obj.get_object_info(self.bucket, self.key,
                                         self._opts())
        if not tx.is_transitioned(oi):
            return self._error("InvalidObjectState",
                               "object is not archived", 403)
        if oi.size > 0 and tx.is_restored(oi):
            self.s3.transition.extend_restore(self.bucket, oi, days)
        else:
            self.s3.transition.restore(self.bucket, oi, days)
        self._send(202)

    def head_object(self, ak):
        self._authorize(ak, "s3:GetObject")
        oi = self.s3.obj.get_object_info(self.bucket, self.key, self._opts())
        self._check_preconditions(oi)
        from ..bucket import transition as tx
        if tx.is_transitioned(oi):
            h = self._obj_headers(oi)
            h["Content-Length"] = str(tx.transitioned_size(oi))
            h["x-amz-storage-class"] = oi.internal.get(tx.META_TIER, "")
            if oi.size > 0 and tx.is_restored(oi):
                h["x-amz-restore"] = 'ongoing-request="false"'
            self.send_response(200)
            for k, v in h.items():
                if v:
                    self.send_header(k, v)
            self.end_headers()
            return
        sse = self._sse_read_ctx(oi)
        h = self._obj_headers(oi)
        if sse:
            h.update(sse[3])
            h["Content-Length"] = str(sse[2])
        else:
            h["Content-Length"] = str(
                oi.actual_size if oi.internal.get(META_COMPRESSION)
                else oi.size)
        self.send_response(200)
        for k, v in h.items():
            if v:
                self.send_header(k, v)
        self.end_headers()

    def _check_preconditions(self, oi):
        inm = self.hdr.get("if-none-match", "")
        if inm and inm.strip('"') == oi.etag:
            raise dt.NotModified(self.bucket, self.key)
        im = self.hdr.get("if-match", "")
        if im and im.strip('"') != oi.etag:
            raise dt.PreconditionFailed(self.bucket, self.key)

    # --- object lock, retention, legal hold -------------------------------

    def put_object_lock_config(self, ak):
        self._authorize(ak, "s3:PutBucketObjectLockConfiguration")
        from ..bucket import objectlock as ol
        if not self.s3.bucket_meta.get(self.bucket).object_lock_enabled:
            raise dt.InvalidRequest(
                self.bucket, "",
                "object lock is not enabled on this bucket")
        body = self._read_body()
        try:
            ol.parse_lock_config(body)
        except (ET.ParseError, ValueError) as e:
            return self._error("MalformedXML", str(e), 400)
        self.s3.bucket_meta.update(self.bucket, object_lock_xml=body)
        self._send(200)

    def get_object_lock_config(self, ak):
        self._authorize(ak, "s3:GetBucketObjectLockConfiguration")
        from ..bucket import objectlock as ol
        meta = self.s3.bucket_meta.get(self.bucket)
        if not meta.object_lock_enabled:
            return self._error("ObjectLockConfigurationNotFoundError",
                               "object lock is not enabled", 404)
        dr = ol.DefaultRetention()
        if meta.object_lock_xml:
            dr = ol.parse_lock_config(meta.object_lock_xml)
        self._send(200, ol.lock_config_xml(True, dr))

    def put_object_retention(self, ak):
        """PUT ?retention: COMPLIANCE may only be extended; an active
        GOVERNANCE retention may be shortened only with the bypass header
        and its permission."""
        self._authorize(ak, "s3:PutObjectRetention")
        from ..bucket import objectlock as ol
        enabled, _ = self._lock_ctx()
        if not enabled:
            raise dt.InvalidRequest(self.bucket, self.key,
                                    "bucket has no object lock")
        try:
            root = ET.fromstring(self._read_body())
        except ET.ParseError as e:
            return self._error("MalformedXML", str(e), 400)
        mode = ol.findtext(root, "Mode").upper()
        until = ol.findtext(root, "RetainUntilDate")
        if mode not in (ol.GOVERNANCE, ol.COMPLIANCE) or not until:
            raise dt.InvalidRequest(self.bucket, self.key,
                                    "invalid retention")
        try:
            until_t = ol.parse_iso8601(until)
        except ValueError:
            raise dt.InvalidRequest(self.bucket, self.key,
                                    "invalid retain-until date") from None
        opts = self._opts()
        oi = self.s3.obj.get_object_info(self.bucket, self.key, opts)
        cur = ol.retention_of(oi.user_defined)
        bypass = self.hdr.get(
            "x-amz-bypass-governance-retention", "") == "true"
        if bypass:
            # weakening GOVERNANCE retention needs its own permission, as
            # the delete path does
            self._authorize(ak, "s3:BypassGovernanceRetention")
        cur_t = 0.0
        if cur.active:
            try:
                cur_t = ol.parse_iso8601(cur.retain_until)
            except ValueError:
                cur_t = 0.0
        if cur.active and cur.mode == ol.COMPLIANCE:
            if mode != ol.COMPLIANCE or until_t < cur_t:
                raise dt.ObjectLocked(self.bucket, self.key,
                                      "COMPLIANCE retention active")
        elif cur.active and cur.mode == ol.GOVERNANCE and not bypass:
            if until_t < cur_t:
                raise dt.ObjectLocked(self.bucket, self.key,
                                      "GOVERNANCE retention active")
        self.s3.obj.update_object_meta(
            self.bucket, self.key,
            {ol.META_MODE: mode, ol.META_RETAIN_UNTIL: until}, opts)
        self._send(200)

    def get_object_retention(self, ak):
        self._authorize(ak, "s3:GetObjectRetention")
        from ..bucket import objectlock as ol
        oi = self.s3.obj.get_object_info(self.bucket, self.key, self._opts())
        ret = ol.retention_of(oi.user_defined)
        if not ret.mode:
            return self._error("NoSuchObjectLockConfiguration",
                               "no retention on this object", 404)
        self._send(200, (f"<Retention><Mode>{ret.mode}</Mode>"
                         f"<RetainUntilDate>{ret.retain_until}"
                         f"</RetainUntilDate></Retention>").encode())

    def put_object_legal_hold(self, ak):
        self._authorize(ak, "s3:PutObjectLegalHold")
        from ..bucket import objectlock as ol
        enabled, _ = self._lock_ctx()
        if not enabled:
            raise dt.InvalidRequest(self.bucket, self.key,
                                    "bucket has no object lock")
        try:
            root = ET.fromstring(self._read_body())
        except ET.ParseError as e:
            return self._error("MalformedXML", str(e), 400)
        status = ol.findtext(root, "Status").upper()
        if status not in ("ON", "OFF"):
            raise dt.InvalidRequest(self.bucket, self.key,
                                    "invalid legal hold status")
        self.s3.obj.update_object_meta(self.bucket, self.key,
                                       {ol.META_LEGAL_HOLD: status},
                                       self._opts())
        self._send(200)

    def get_object_legal_hold(self, ak):
        self._authorize(ak, "s3:GetObjectLegalHold")
        from ..bucket import objectlock as ol
        oi = self.s3.obj.get_object_info(self.bucket, self.key, self._opts())
        status = ol.legal_hold_of(oi.user_defined)
        self._send(200, f"<LegalHold><Status>{status}</Status></LegalHold>"
                   .encode())

    def _check_delete_lock(self, ak: str, opts, key: str | None = None):
        """WORM enforcement of a version delete (a versionless delete only
        writes a delete marker, which object lock permits)."""
        if not opts.version_id:
            return
        from ..bucket import objectlock as ol
        if not self.s3.bucket_meta.get(self.bucket).object_lock_enabled:
            return
        key = self.key if key is None else key
        try:
            oi = self.s3.obj.get_object_info(self.bucket, key, opts)
        except dt.ObjectAPIError:
            return  # nothing to protect
        bypass = self.hdr.get(
            "x-amz-bypass-governance-retention", "") == "true"
        if bypass:
            self._authorize(ak, "s3:BypassGovernanceRetention", self.bucket,
                            key)
        ol.check_delete_allowed(oi.user_defined, self.bucket, key, bypass)

    def _check_quota(self, incoming: int):
        """Hard bucket quota from the data-usage snapshot
        (cmd/bucket-quota.go enforceBucketQuotaHard): best-effort like the
        reference — usage trails the scanner's last sweep. The snapshot is
        cached on the server for 10 s so the write path does not re-read
        and parse it per request."""
        import time as _t
        meta = self.s3.bucket_meta.get(self.bucket)
        if meta.quota <= 0:
            return
        cached = getattr(self.s3, "_usage_cache", None)
        if cached is None or _t.monotonic() - cached[0] > 10.0:
            cached = (_t.monotonic(), usage_mod.load_usage(self.s3.obj))
            self.s3._usage_cache = cached
        used = cached[1].get("buckets", {}).get(self.bucket, {}).get(
            "size", 0)
        if used + max(incoming, 0) > meta.quota:
            raise dt.QuotaExceeded(
                self.bucket, self.key,
                f"quota {meta.quota} would be exceeded")

    def delete_object(self, ak):
        self._authorize(ak, "s3:DeleteObject")
        opts = self._opts()
        self._check_delete_lock(ak, opts)
        oi = self.s3.obj.delete_object(self.bucket, self.key, opts)
        self._send(204, headers={
            "x-amz-version-id": oi.version_id or None,
            "x-amz-delete-marker": "true" if oi.delete_marker else None})
        self._notify("s3:ObjectRemoved:Delete", oi)

    def copy_object(self, ak):
        self._authorize(ak, "s3:PutObject")
        src = urllib.parse.unquote(self.hdr["x-amz-copy-source"])
        src_vid = ""
        if "?versionId=" in src:
            src, _, src_vid = src.partition("?versionId=")
        src = src.lstrip("/")
        src_bucket, _, src_key = src.partition("/")
        # the caller must be allowed to read the source too, or a copy
        # would exfiltrate an object it cannot GET
        self._authorize(ak, "s3:GetObject", src_bucket, src_key)
        src_opts = ObjectOptions(version_id=src_vid)
        # SSE copy (decrypt source / re-encrypt destination) is not wired
        # in either package; refuse instead of copying ciphertext
        from ..crypto import META_SCHEME
        si_probe = self.s3.obj.get_object_info(src_bucket, src_key, src_opts)
        if si_probe.internal.get(META_SCHEME) or \
                self.hdr.get("x-amz-server-side-encryption") or \
                self.hdr.get(
                    "x-amz-server-side-encryption-customer-algorithm"):
            raise dt.NotImplemented(self.bucket, self.key)
        self._check_quota(si_probe.size)  # destination bucket quota
        dst_opts = self._opts()
        # object lock applies to the new version as to a PUT
        from ..bucket import objectlock as olock
        lock_enabled, lock_default = self._lock_ctx()
        lock_meta = olock.check_put_headers(
            self.hdr, self.bucket, self.key, lock_enabled, lock_default)
        directive = self.hdr.get("x-amz-metadata-directive", "COPY")
        if directive == "REPLACE":
            dst_opts.user_defined = self._user_meta()
            dst_opts.metadata_replace = True
        else:
            dst_opts.user_defined = dict(si_probe.user_defined)
            if si_probe.content_type:
                dst_opts.user_defined["content-type"] = si_probe.content_type
        # the copy moves the STORED bytes, so the compression markers must
        # travel with them or the destination would serve raw deflate
        for k in (META_COMPRESSION, META_ACTUAL_SIZE):
            if k in si_probe.internal:
                dst_opts.user_defined[k] = si_probe.internal[k]
        dst_opts.user_defined.update(lock_meta)
        oi = self.s3.obj.copy_object(src_bucket, src_key, self.bucket,
                                     self.key, None, src_opts, dst_opts)
        self._send(200, xu.copy_object_xml(oi.etag, oi.mod_time),
                   headers={"x-amz-version-id": oi.version_id or None})
        self._notify("s3:ObjectCreated:Copy", oi)

    # --- object tagging -----------------------------------------------------

    def put_object_tagging(self, ak):
        self._authorize(ak, "s3:PutObjectTagging")
        tags = xu.parse_tagging(self._read_body())
        self.s3.obj.put_object_tags(self.bucket, self.key,
                                    urllib.parse.urlencode(tags),
                                    self._opts())
        self._send(200)

    def get_object_tagging(self, ak):
        self._authorize(ak, "s3:GetObjectTagging")
        enc = self.s3.obj.get_object_tags(self.bucket, self.key,
                                          self._opts())
        self._send(200, xu.tagging_xml(dict(urllib.parse.parse_qsl(enc))))

    def delete_object_tagging(self, ak):
        self._authorize(ak, "s3:PutObjectTagging")
        self.s3.obj.delete_object_tags(self.bucket, self.key, self._opts())
        self._send(204)

    # --- multipart ----------------------------------------------------------

    def initiate_upload(self, ak):
        self._authorize(ak, "s3:PutObject")
        if self.hdr.get("x-amz-server-side-encryption") or self.hdr.get(
                "x-amz-server-side-encryption-customer-algorithm"):
            # multipart SSE (per-part cipher streams) is not wired in
            # either package; refuse instead of storing parts unencrypted
            raise dt.NotImplemented(self.bucket, self.key)
        opts = self._opts()
        opts.user_defined = self._user_meta()
        uid = self.s3.obj.new_multipart_upload(self.bucket, self.key, opts)
        self._send(200, xu.initiate_multipart_xml(self.bucket, self.key, uid))

    def put_part(self, ak):
        self._authorize(ak, "s3:PutObject")
        part_id = int(self.q("partNumber"))
        uid = self.q("uploadId")
        size = int(self.hdr.get("content-length", "-1") or "-1")
        if self.hdr.get("x-amz-content-sha256", "") == STREAMING_PAYLOAD:
            size = int(self.hdr.get("x-amz-decoded-content-length",
                                    str(size)))
        if size < 0:
            return self._error("MissingContentLength",
                               "Content-Length required", 411)
        self._check_quota(size)  # quota applies to multipart traffic too
        # Content-MD5 / x-amz-content-sha256 are verified on part bodies
        # exactly like PutObject
        hr = self._hash_reader(size)
        pi = self.s3.obj.put_object_part(self.bucket, self.key, uid,
                                         part_id, hr, size)
        self._send(200, headers={"ETag": f'"{pi.etag}"'})

    def list_parts(self, ak):
        self._authorize(ak, "s3:ListMultipartUploadParts")
        info = self.s3.obj.list_object_parts(
            self.bucket, self.key, self.q("uploadId"),
            int(self.q("part-number-marker", "0") or "0"),
            min(int(self.q("max-parts", "1000") or "1000"), 10_000))
        self._send(200, xu.list_parts_xml(info))

    def list_uploads(self, ak):
        self._authorize(ak, "s3:ListBucketMultipartUploads")
        self.s3.obj.get_bucket_info(self.bucket)
        prefix = self.q("prefix")
        max_uploads = min(int(self.q("max-uploads", "1000") or "1000"),
                          10_000)
        info = self.s3.obj.list_multipart_uploads(self.bucket, prefix,
                                                  max_uploads)
        self._send(200, xu.list_uploads_xml(self.bucket, prefix, max_uploads,
                                            info))

    def abort_upload(self, ak):
        self._authorize(ak, "s3:AbortMultipartUpload")
        self.s3.obj.abort_multipart_upload(self.bucket, self.key,
                                           self.q("uploadId"))
        self._send(204)

    def complete_upload(self, ak):
        self._authorize(ak, "s3:PutObject")
        parts = xu.parse_complete_multipart(self._read_body())
        oi = self.s3.obj.complete_multipart_upload(
            self.bucket, self.key, self.q("uploadId"), parts, self._opts())
        if self._charge_replication():
            # the parts were written before the obligation existed: the
            # status rides a metadata update
            from ..bucket import replicate as repl
            try:
                self.s3.obj.update_object_meta(
                    self.bucket, self.key,
                    {repl.META_REP_STATUS: repl.PENDING})
            except Exception:  # noqa: BLE001 — the charge still queues
                log.warning("replication status of %s/%s not set",
                            self.bucket, self.key, exc_info=True)
        self._send(200, xu.complete_multipart_xml(
            f"{self.s3.endpoint()}/{self.bucket}/{self.key}",
            self.bucket, self.key, oi.etag),
            headers={"x-amz-version-id": oi.version_id or None})
        self._notify("s3:ObjectCreated:CompleteMultipartUpload", oi)


class _CappedReader:
    """Bound a socket read to the declared Content-Length (socket streams
    never EOF on keep-alive connections); reports consumption back to the
    handler for end-of-request draining. ``readinto`` is the PUT ingest's
    leg into the erasure pipeline's pooled block buffers."""

    def __init__(self, raw, size: int, handler=None):
        self.raw = raw
        self.remaining = max(0, size) if size >= 0 else -1
        self.handler = handler

    def read(self, n: int = -1) -> bytes:
        if self.remaining == 0:
            return b""
        if self.remaining > 0:
            n = self.remaining if n < 0 else min(n, self.remaining)
        b = self.raw.read(n)
        if self.remaining > 0:
            self.remaining -= len(b)
        if self.handler is not None:
            self.handler._consumed += len(b)
        return b

    def readinto(self, view) -> int:
        """Fill ``view`` from the socket's buffered reader, within the
        declared length (no ``bytes`` object per block)."""
        if self.remaining == 0:
            return 0
        view = memoryview(view).cast("B")
        if 0 < self.remaining < len(view):
            view = view[: self.remaining]
        got = self.raw.readinto(view) or 0
        if self.remaining > 0:
            self.remaining -= got
        if self.handler is not None:
            self.handler._consumed += got
        return got
