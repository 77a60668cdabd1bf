"""Cross-node async bucket replication, the port of
minio_tpu/bucket/replicate.py (reference
cmd/bucket-replication.go + cmd/bucket-replication-stats.go): every
acked write into a bucket with a replication rule owes an off-node copy,
and the obligation must survive kills, partitions, and restarts of
either end.

The plane is three pieces:

* **Rule config** — per-bucket ReplicationConfiguration XML persisted in
  bucket metadata (``BucketMetadata.replication_xml``), one or more
  ``<Rule>`` entries naming a target ``<Endpoint>`` (a peer node URL)
  and ``<Destination><Bucket>``. Admin surface: ``?replication`` bucket
  API + ``mc admin replication`` equivalents in madmin.
* **Status in xl.meta** — each charged object carries
  ``x-minio-internal-replication-status`` (PENDING at PUT, flipped to
  COMPLETED/FAILED by the worker through ``update_object_meta``), and
  replica writes on the target carry
  ``x-minio-internal-replica-status: REPLICA`` so replication can never
  loop back (reference ReplicationStatusType / ReplicaStatus).
* **Debt queue** — the SAME ``scanner.park.DebtQueue`` the MRF heal
  plane runs: bounded drop-oldest queue,
  exponential-backoff retry park, journal persisted via
  ``durable_write`` so replication debt survives a source restart, and
  ``kick()`` wired into ``Node._on_peer_reconnect`` so a rejoining
  target drains its backlog NOW instead of waiting out the backoff.

The worker reads through ``get_object_buffer`` (the zero-copy read
path — one pass, no final full-object copy; on the card the GET's K5
verify, and K1 when shards are away) and ships through a peer transport
resolved per rule endpoint (``_peer_for``): a node's peer RPC client
(``dist.peer.PeerRESTClient``) for a target among its peers or an ad-hoc
one with the cluster secret, or, without a node, a rule endpoint's entry
in ``_extra_peers`` (any object with ``replicate_object`` and
``replicate_delete``). Replication traffic is background-class QoS: a
drain burst must not starve interactive GETs.

Replication lag (charge→replica-landed seconds) is measured through
``obs.latency.Window`` — the same percentile machinery behind every
other latency metric — and surfaces as an SLO objective
(``obs.slo``, registered by ``S3Server.enable_cross_replication``).
"""
from __future__ import annotations

import threading
import time
import xml.etree.ElementTree as ET
from dataclasses import dataclass

from ..obs import metrics
from ..obs.latency import Window
from ..scanner.park import DebtQueue

#: per-object replication state recorded in xl.meta (internal key —
#: rides ObjectInfo.internal, never echoed as x-amz-meta)
META_REP_STATUS = "x-minio-internal-replication-status"
#: stamped on the TARGET's copy: marks it a replica so an event fired
#: by the replica write can never re-charge replication (loop guard)
META_REPLICA = "x-minio-internal-replica-status"

PENDING = "PENDING"
COMPLETED = "COMPLETED"
FAILED = "FAILED"
REPLICA = "REPLICA"

#: same retry shape as the MRF heal plane: the usual failure is the
#: whole target node being down, and the debt must survive until rejoin
RETRY_MAX = 8
RETRY_CAP_S = 30.0

#: charge-timestamp map bound — lag sampling is best-effort telemetry,
#: not an obligation record (the journal is); an unbounded map would
#: leak on a dead target holding 10k queued entries
_LAG_MAP_MAX = 8192


def _cfg(key: str, env: str, default: float) -> float:
    """replication.* knob: env > stored config > default (the shared
    qos.budget resolver so the cache/TTL semantics stay uniform)."""
    from ..qos.budget import _config_float
    return _config_float("replication", key, env, default)


@dataclass
class ReplRule:
    """One parsed <Rule> (reference pkg/bucket/replication/rule.go)."""
    rule_id: str = ""
    status: str = "Enabled"
    priority: int = 0
    prefix: str = ""
    #: replicate delete operations too (<DeleteMarkerReplication>)
    delete_replication: bool = False
    target_bucket: str = ""
    #: peer node URL (http://host:port) — the dist-RPC endpoint
    endpoint: str = ""

    @property
    def enabled(self) -> bool:
        return self.status == "Enabled"


def _strip(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse_replication(xml_blob: bytes) -> list[ReplRule]:
    """ReplicationConfiguration XML -> rules. Grammar (subset of the
    S3 schema, documented in docs/replication.md)::

        <ReplicationConfiguration>
          <Rule>
            <ID>r1</ID><Status>Enabled</Status><Priority>1</Priority>
            <Filter><Prefix>logs/</Prefix></Filter>
            <DeleteMarkerReplication><Status>Enabled</Status>
            </DeleteMarkerReplication>
            <Destination>
              <Bucket>dst-bucket</Bucket>
              <Endpoint>http://node2:9000</Endpoint>
            </Destination>
          </Rule>
        </ReplicationConfiguration>
    """
    if not xml_blob:
        return []
    root = ET.fromstring(xml_blob)
    for el in root.iter():
        el.tag = _strip(el.tag)
    rules = []
    for r in root.findall(".//Rule"):
        rule = ReplRule(rule_id=r.findtext("ID", ""),
                        status=r.findtext("Status", "Enabled"),
                        priority=int(r.findtext("Priority", "0") or "0"))
        f = r.find("Filter")
        if f is not None:
            rule.prefix = f.findtext("Prefix", "") or \
                f.findtext("And/Prefix", "")
        else:
            rule.prefix = r.findtext("Prefix", "")
        dmr = r.find("DeleteMarkerReplication")
        if dmr is not None:
            rule.delete_replication = \
                dmr.findtext("Status", "Disabled") == "Enabled"
        dst = r.find("Destination")
        if dst is not None:
            # accept both arn:...:bucket and a bare bucket name
            b = dst.findtext("Bucket", "")
            rule.target_bucket = b.rsplit(":", 1)[-1]
            rule.endpoint = dst.findtext("Endpoint", "").rstrip("/")
        rules.append(rule)
    return rules


def validate_replication(xml_blob: bytes) -> list[ReplRule]:
    """Parse + sanity-check a config before persisting it (the PUT
    ?replication handler): every enabled rule needs a destination."""
    rules = parse_replication(xml_blob)
    for r in rules:
        if r.enabled and (not r.target_bucket or not r.endpoint):
            raise ValueError(
                f"rule {r.rule_id or '?'}: Destination needs both "
                "<Bucket> and <Endpoint>")
    return rules


def _debt_moot(e: BaseException) -> bool:
    """The source object/bucket is gone — nothing left to replicate
    (deletes have their own op; a vanished put is churn)."""
    return type(e).__name__ in ("ObjectNotFound", "VersionNotFound",
                                "BucketNotFound")


class ReplicationSys:
    """The source-side replication engine: charge at PUT/DELETE/
    multipart-complete (chained into the server's notify hook), drain
    on a background worker, resync rebuilt targets, and expose
    lag/backlog to the SLO + metrics planes."""

    def __init__(self, objlayer, bucket_meta, node=None,
                 max_queue: int = 10_000):
        self.obj = objlayer
        self.bucket_meta = bucket_meta
        #: dist.node.Node — peer resolution + secret; None in
        #: single-node unit tests that stub the transport
        self.node = node
        self.dq = DebtQueue(
            max_queue=max_queue, mode_field="op",
            # a delete obligation supersedes the put it follows: on a
            # journal dedupe collision the delete wins, or a crash
            # replay could resurrect the object on the target
            sticky_modes=("delete",),
            dropped_metric="minio_tpu_replication_dropped_total")
        self.completed = 0
        self.failed = 0
        self.resynced = 0
        #: charge→landed seconds, the replication-lag objective
        self.lag = Window()
        self._charged: dict[tuple, float] = {}
        self._charged_lock = threading.Lock()
        #: bucket -> (xml blob, parsed rules); re-parse only on change
        self._cache: dict[str, tuple[bytes, list[ReplRule]]] = {}
        #: endpoint URL -> PeerRESTClient for targets outside the
        #: node's static peer set
        self._extra_peers: dict = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- rules ---------------------------------------------------------------

    def rules_for(self, bucket: str) -> list[ReplRule]:
        if self.bucket_meta is None:
            return []
        blob = self.bucket_meta.get(bucket).replication_xml
        cached = self._cache.get(bucket)
        if cached is not None and cached[0] == blob:
            return cached[1]
        rules = parse_replication(blob)
        self._cache[bucket] = (blob, rules)
        return rules

    def heads_up(self, bucket: str, key: str):
        """Best matching enabled rule for an object, or None. Highest
        Priority wins ties (reference FilterActionableRules)."""
        best = None
        for r in self.rules_for(bucket):
            if not r.enabled or not r.target_bucket or not r.endpoint:
                continue
            if r.prefix and not key.startswith(r.prefix):
                continue
            if best is None or r.priority > best.priority:
                best = r
        return best

    # -- charging ------------------------------------------------------------

    def charge(self, event: str, bucket: str, oi, *_a) -> None:
        """Notify-hook shape (event, bucket, ObjectInfo): record the
        replication obligation for a completed write/delete. Cheap on
        the request path — one rule lookup + queue put; all journal IO
        happens on the worker thread."""
        key = getattr(oi, "name", "")
        if not key:
            return
        # a replica landing on THIS node must not re-replicate
        if getattr(oi, "internal", None) and \
                oi.internal.get(META_REPLICA):
            return
        rule = self.heads_up(bucket, key)
        if rule is None:
            return
        if event.startswith("s3:ObjectCreated"):
            op = "put"
        elif event.startswith("s3:ObjectRemoved"):
            if not rule.delete_replication:
                return
            op = "delete"
        else:
            return
        version_id = getattr(oi, "version_id", "") or ""
        self.dq.add(bucket, key, version_id, mode=op)
        metrics.inc("minio_tpu_replication_charged_total")
        with self._charged_lock:
            if len(self._charged) < _LAG_MAP_MAX:
                self._charged[(bucket, key)] = time.monotonic()

    # -- transport -----------------------------------------------------------

    def _peer_for(self, endpoint: str):
        """Resolve a rule's endpoint to its transport. A target in the
        node's static peer set reuses that client (shares its
        online/offline state + reconnect ping loop); anything else is a
        registered ``_extra_peers`` transport or, on a node, a cached
        ad-hoc PeerRESTClient with the same cluster secret."""
        endpoint = endpoint.rstrip("/")
        if self.node is not None:
            for p in self.node.peers:
                if p.url.rstrip("/") == endpoint:
                    return p
        client = self._extra_peers.get(endpoint)
        if client is None:
            if self.node is None:
                return None
            from ..dist.peer import PeerRESTClient
            client = PeerRESTClient(endpoint, self.node.secret,
                                    src=self.node.local_url)
            self._extra_peers[endpoint] = client
        return client

    def _read_source(self, bucket: str, key: str, oi) -> bytes:
        """One-pass zero-copy read of the source object
        (``get_object_buffer`` — PreallocSink handed out as a
        memoryview); compressed objects inflate because the replica
        must hold plaintext (the target doesn't share our markers)."""
        read = getattr(self.obj, "get_object_buffer", None)
        buf = read(bucket, key) if read is not None \
            else self.obj.get_object_bytes(bucket, key)
        from ..utils.compress import META_COMPRESSION, logical_bytes
        if oi.internal.get(META_COMPRESSION, ""):
            return logical_bytes(oi, bytes(buf))
        return bytes(buf)

    # -- worker --------------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="replication-worker")
        self._thread.start()
        return self

    def _retry_base_s(self) -> float:
        return _cfg("retry_base_s", "MINIO_TPU_REPLICATION_RETRY_BASE_S",
                    1.0)

    def timeout_s(self) -> float:
        return _cfg("timeout_s", "MINIO_TPU_REPLICATION_TIMEOUT_S", 10.0)

    def _loop(self):
        while not self._stop.is_set():
            entry = self.dq.pop(timeout=0.5,
                                repark_s=self._retry_base_s())
            if entry is None:
                continue
            bucket, key, version_id, op = entry[:4]
            attempt = entry[4] if len(entry) > 4 else 0
            try:
                from .. import qos
                # replication is background-class: a backlog drain
                # must queue behind interactive traffic, not starve it
                with qos.background():
                    self._replicate_one(bucket, key, version_id, op)
                # counted here, EXPOSED by obs.metrics._g_replication
                # (explicit gauge/counter rows off stats() — inc()'ing
                # the same family would double-render the exposition)
                self.completed += 1
            except Exception as e:  # noqa: BLE001
                self.failed += 1
                if attempt + 1 <= RETRY_MAX and not _debt_moot(e):
                    # park with backoff, KEEP the journal entry: the
                    # usual cause is the target node being down, and
                    # the obligation must survive until it rejoins
                    # (and survive OUR restart, via the journal)
                    self.dq.park((bucket, key, version_id, op),
                                 attempt + 1, self._retry_base_s(),
                                 RETRY_CAP_S)
                    self.dq.flush()
                    continue
                # retries exhausted: record FAILED in xl.meta so the
                # scanner sweep re-charges it next cycle
                self._set_status(bucket, key, FAILED)
            self.dq.settle((bucket, key, version_id))

    def _replicate_one(self, bucket: str, key: str, version_id: str,
                       op: str) -> None:
        rule = self.heads_up(bucket, key)
        if rule is None:
            return  # config removed since charge: obligation moot
        peer = self._peer_for(rule.endpoint)
        if peer is None:
            raise RuntimeError(f"no transport for {rule.endpoint}")
        timeout = self.timeout_s()
        if op == "delete":
            peer.replicate_delete(rule.target_bucket, key,
                                  version_id=version_id,
                                  timeout=timeout)
            with self._charged_lock:
                self._charged.pop((bucket, key), None)
            return
        try:
            oi = self.obj.get_object_info(bucket, key)
        except Exception as e:  # noqa: BLE001
            if _debt_moot(e):
                return  # deleted since charge; the delete op follows
            raise
        if oi.internal.get(META_REPLICA):
            return  # replica landed here out-of-band: never loop
        data = self._read_source(bucket, key, oi)
        meta = {"user_defined": {k: v for k, v in
                                 oi.user_defined.items()},
                "etag": oi.etag, "mod_time": oi.mod_time}
        peer.replicate_object(rule.target_bucket, key, data, meta=meta,
                              version_id=version_id, timeout=timeout)
        self._set_status(bucket, key, COMPLETED)
        with self._charged_lock:
            t0 = self._charged.pop((bucket, key), None)
        if t0 is not None:
            self.lag.observe(time.monotonic() - t0, nbytes=oi.size)

    def _set_status(self, bucket: str, key: str, status: str) -> None:
        """Flip the per-object replication status in xl.meta;
        best-effort (the object may have been deleted mid-flight)."""
        try:
            self.obj.update_object_meta(bucket, key,
                                        {META_REP_STATUS: status})
        except Exception:  # noqa: BLE001
            pass

    # -- resync + sweep ------------------------------------------------------

    def resync(self, bucket: str, force: bool = False) -> int:
        """Replay a bucket's replication backlog against a rebuilt or
        rejoined target (reference resyncBucket): every object whose
        status isn't COMPLETED — or EVERY object with ``force`` (the
        target was rebuilt from scratch) — re-enqueues. Returns the
        number scheduled."""
        if not self.rules_for(bucket):
            return 0
        count = 0
        for oi in self.obj.iter_objects(bucket):
            if oi.internal.get(META_REPLICA):
                continue
            if self.heads_up(bucket, oi.name) is None:
                continue
            status = oi.internal.get(META_REP_STATUS, "")
            if force or status != COMPLETED:
                self.dq.add(bucket, oi.name, "", mode="put")
                with self._charged_lock:
                    if len(self._charged) < _LAG_MAP_MAX:
                        self._charged[(bucket, oi.name)] = \
                            time.monotonic()
                count += 1
        self.resynced += count
        return count

    def sweep(self, bucket: str, oi) -> bool:
        """Scanner-cycle hook: re-charge an object whose status is
        still PENDING or FAILED (missed charge, exhausted retries, or
        journal shed under overflow). Returns True when re-charged."""
        status = oi.internal.get(META_REP_STATUS, "")
        if status not in (PENDING, FAILED):
            return False
        if oi.internal.get(META_REPLICA) or \
                self.heads_up(bucket, oi.name) is None:
            return False
        if self.dq.queued((bucket, oi.name, "")):
            return False  # already owed
        self.dq.add(bucket, oi.name, "", mode="put")
        return True

    # -- plumbing ------------------------------------------------------------

    def attach_persistence(self, path: str, load: bool = True) -> int:
        """Point the replication journal at its on-disk file; existing
        entries (debt recorded before a crash/restart) re-enqueue."""
        return self.dq.attach_persistence(path, load=load)

    def kick(self) -> None:
        """Peer rejoined: promote every backoff-parked obligation to
        runnable NOW (wired into ``Node._on_peer_reconnect``)."""
        self.dq.kick()

    def lag_report(self) -> dict:
        """The SLO-plane view: lag percentiles (Window-derived),
        configured threshold, backlog, verdict."""
        st = self.lag.stats(qs=(0.5, 0.99))
        p = st["percentiles"]
        threshold = _cfg("lag_slo_s", "MINIO_TPU_REPLICATION_LAG_SLO_S",
                         30.0)
        backlog = self.dq.stats()["queued"]
        return {"lag_p50_s": p[0.5], "lag_p99_s": p[0.99],
                "samples": st["count"], "threshold_s": threshold,
                "backlog": backlog,
                "ok": p[0.99] <= threshold}

    def stats(self) -> dict:
        rep = self.lag_report()
        return {"completed": self.completed, "failed": self.failed,
                "resynced": self.resynced,
                "lag_p50_s": rep["lag_p50_s"],
                "lag_p99_s": rep["lag_p99_s"],
                "lag_samples": rep["samples"],
                **self.dq.stats()}

    def drain(self, timeout: float = 30.0) -> bool:
        return self.dq.drain(timeout)

    def flush_journal(self) -> None:
        self.dq.flush(force=True)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.dq.flush(force=True)
