"""EventNotifier, the port of minio_tpu/event/notifier.py — ties the
pieces together (reference cmd/notification.go
+ cmd/event-notification.go): per-bucket rules cached from bucket
metadata, ARN routing, and one persistent queue+sender per target. The
object handlers call it through the existing ``s3.notify`` hook."""
from __future__ import annotations

import logging
import os
import queue
import threading

from .queuestore import QueueStore
from .record import new_event_record
from .rules import NotificationRules, parse_notification_xml
from .targets import WebhookTarget

log = logging.getLogger("minio_tpu_torch.event")


def targets_from_env(region: str = "us-east-1") -> list[WebhookTarget]:
    """Webhook targets from MINIO_TPU_NOTIFY_WEBHOOK_ENDPOINT_<ID> (+
    optional _AUTH_TOKEN_<ID>) — the reference's
    MINIO_NOTIFY_WEBHOOK_ENABLE_* env scheme."""
    out = []
    prefix = "MINIO_TPU_NOTIFY_WEBHOOK_ENDPOINT_"
    for k, v in os.environ.items():
        if not k.startswith(prefix) or not v:
            continue
        tid = k[len(prefix):].lower()
        token = os.environ.get(
            f"MINIO_TPU_NOTIFY_WEBHOOK_AUTH_TOKEN_{tid.upper()}", "")
        out.append(WebhookTarget(tid, v, token, region=region))
    return out


def targets_from_config(cfg, region: str = "us-east-1") -> list:
    """Build every enabled broker-backed target from the config KVS
    (subsystems notify_kafka/_amqp/_mqtt/_redis/_elasticsearch/_nats/
    _nsq, env > stored > default per key). Bad configs are skipped with a
    log line rather than failing server start (the reference validates at
    set-time; we also tolerate stored configs going stale)."""
    from . import targets as T
    out: list = []

    def on(subsys):
        return cfg.get(subsys, "enable").lower() in ("on", "1", "true")

    # (subsystem, required-endpoint key): enable=on with an empty
    # endpoint must be SKIPPED, not built — the wire clients connect
    # lazily, so an empty host would silently resolve to localhost and
    # retry against whatever listens there
    required = {
        "notify_kafka": "brokers", "notify_amqp": "url",
        "notify_mqtt": "broker", "notify_redis": "address",
        "notify_elasticsearch": "url", "notify_nats": "address",
        "notify_nsq": "nsqd_address", "notify_postgres": "address",
        "notify_mysql": "address",
    }
    builders = [
        ("notify_kafka", lambda: T.KafkaTarget(
            "1", cfg.get("notify_kafka", "brokers"),
            cfg.get("notify_kafka", "topic"), region)),
        ("notify_amqp", lambda: T.AMQPTarget(
            "1", cfg.get("notify_amqp", "url"),
            cfg.get("notify_amqp", "exchange"),
            cfg.get("notify_amqp", "routing_key"), region)),
        ("notify_mqtt", lambda: T.MQTTTarget(
            "1", cfg.get("notify_mqtt", "broker"),
            cfg.get("notify_mqtt", "topic"),
            cfg.get("notify_mqtt", "username"),
            cfg.get("notify_mqtt", "password"),
            int(cfg.get("notify_mqtt", "qos") or 1), region)),
        ("notify_redis", lambda: T.RedisTarget(
            "1", cfg.get("notify_redis", "address"),
            cfg.get("notify_redis", "key"),
            cfg.get("notify_redis", "password"),
            cfg.get("notify_redis", "format"), region)),
        ("notify_elasticsearch", lambda: T.ElasticsearchTarget(
            "1", cfg.get("notify_elasticsearch", "url"),
            cfg.get("notify_elasticsearch", "index"),
            cfg.get("notify_elasticsearch", "format"),
            cfg.get("notify_elasticsearch", "username"),
            cfg.get("notify_elasticsearch", "password"), region)),
        ("notify_nats", lambda: T.NATSTarget(
            "1", cfg.get("notify_nats", "address"),
            cfg.get("notify_nats", "subject"),
            cfg.get("notify_nats", "username"),
            cfg.get("notify_nats", "password"),
            cfg.get("notify_nats", "token"), region)),
        ("notify_nsq", lambda: T.NSQTarget(
            "1", cfg.get("notify_nsq", "nsqd_address"),
            cfg.get("notify_nsq", "topic"), region)),
        ("notify_mysql", lambda: T.MySQLTarget(
            "1", cfg.get("notify_mysql", "address"),
            cfg.get("notify_mysql", "database"),
            cfg.get("notify_mysql", "table"),
            cfg.get("notify_mysql", "user"),
            cfg.get("notify_mysql", "password"),
            cfg.get("notify_mysql", "format"), region)),
        ("notify_postgres", lambda: T.PostgresTarget(
            "1", cfg.get("notify_postgres", "address"),
            cfg.get("notify_postgres", "database"),
            cfg.get("notify_postgres", "table"),
            cfg.get("notify_postgres", "user"),
            cfg.get("notify_postgres", "password"),
            cfg.get("notify_postgres", "format"), region)),
    ]
    for subsys, build in builders:
        try:
            if not on(subsys):
                continue
            if not cfg.get(subsys, required[subsys]).strip():
                log.warning("%s enabled but %s is empty; skipping",
                            subsys, required[subsys])
                continue
            out.append(build())
        except Exception:  # noqa: BLE001 — bad target config: skip it
            log.warning("skipping misconfigured %s target", subsys,
                        exc_info=True)
    return out


class _ListenSub:
    """One live listener: bucket + key filters + a bounded queue."""

    __slots__ = ("bucket", "prefix", "suffix", "events", "q")

    def __init__(self, bucket, prefix, suffix, events, q):
        self.bucket = bucket
        self.prefix = prefix
        self.suffix = suffix
        self.events = events
        self.q = q

    def matches(self, event_name: str, bucket: str, key: str) -> bool:
        import fnmatch
        if bucket != self.bucket:
            return False
        # event names arrive s3:-prefixed ("s3:ObjectCreated:Put")
        if not any(fnmatch.fnmatchcase(event_name, pat)
                   for pat in self.events):
            return False
        return key.startswith(self.prefix) and key.endswith(self.suffix)


class EventNotifier:
    def __init__(self, bucket_meta, targets: list, queue_root: str,
                 region: str = "us-east-1", queue_limit: int = 10000):
        self.bucket_meta = bucket_meta
        self.region = region
        self._rules: dict[str, NotificationRules] = {}
        self._rules_lock = threading.Lock()
        self._listeners: list[_ListenSub] = []
        self._listen_lock = threading.Lock()
        self.stores: dict[str, QueueStore] = {}
        self.targets: dict[str, object] = {}
        self.queue_limit = queue_limit
        #: targets whose queue-full drop has been logged once — a full
        #: queue under load would otherwise emit one warning PER EVENT
        #: on the request path (the drop counters carry the volume)
        self._drop_logged: set[str] = set()
        for t in targets:
            self.targets[t.arn] = t
            self.stores[t.arn] = QueueStore(
                os.path.join(queue_root, t.KIND, t.id), t.send,
                limit=queue_limit).start()

    def add_targets(self, targets: list, queue_root: str) -> None:
        """Attach targets (with their persistent queues) to a running
        notifier — used when the event plane was created lazily for
        listeners before any target configuration arrived."""
        for t in targets:
            if t.arn in self.targets:
                continue
            self.targets[t.arn] = t
            self.stores[t.arn] = QueueStore(
                os.path.join(queue_root, t.KIND, t.id), t.send,
                limit=self.queue_limit).start()

    # -- config ---------------------------------------------------------------

    def rules_for(self, bucket: str) -> NotificationRules:
        with self._rules_lock:
            cached = self._rules.get(bucket)
        if cached is not None:
            return cached
        xml = b""
        if self.bucket_meta is not None:
            meta = self.bucket_meta.get(bucket)
            xml = getattr(meta, "notification_xml", b"") or b""
        try:
            rules = parse_notification_xml(xml)
        except Exception:  # noqa: BLE001 — bad stored config: no routing
            log.warning("bad notification config for %s", bucket,
                        exc_info=True)
            rules = NotificationRules()
        with self._rules_lock:
            self._rules[bucket] = rules
        return rules

    def invalidate(self, bucket: str):
        with self._rules_lock:
            self._rules.pop(bucket, None)

    def unknown_arns(self, rules: NotificationRules) -> list[str]:
        """ARNs in a candidate config with no registered target (the
        reference rejects SetBucketNotification for these)."""
        return sorted(a for a in rules.arns() if a not in self.targets)

    # -- the s3.notify hook ---------------------------------------------------

    def __call__(self, event_name: str, bucket: str, oi,
                 request_params: dict | None = None):
        rules = self.rules_for(bucket)
        key = getattr(oi, "name", "")
        arns = rules.route(event_name, key)
        record = None
        if arns:
            record = new_event_record(event_name, bucket, oi,
                                      self.region, request_params)
            for arn in arns:
                store = self.stores.get(arn)
                if store is not None and not store.put(record):
                    if arn not in self._drop_logged:
                        self._drop_logged.add(arn)
                        log.warning(
                            "event queue full for %s; dropping (further "
                            "drops counted, not logged)", arn)
                    # every drop path exports a counter — the store's
                    # failed_puts rides the notification group too, but
                    # this one survives store replacement/restart
                    try:
                        from ..obs import metrics as mx
                        mx.inc("minio_tpu_notify_events_dropped_total",
                               target=arn)
                    except Exception:  # noqa: BLE001 — obs shielded
                        pass
        # live listeners (ListenBucketNotification): independent of any
        # stored config — the filters came with the listening request
        with self._listen_lock:
            subs = list(self._listeners)
        for sub in subs:
            if not sub.matches(event_name, bucket, key):
                continue
            if record is None:
                record = new_event_record(event_name, bucket, oi,
                                          self.region, request_params)
            try:
                sub.q.put_nowait(record)
            except queue.Full:  # slow consumer: drop, never block PUTs
                try:
                    from ..obs import metrics as mx
                    mx.inc("minio_tpu_notify_listener_dropped_total")
                except Exception:  # noqa: BLE001 — obs shielded
                    pass

    # -- live listen channels (reference ListenBucketNotificationHandler,
    # cmd/bucket-notification-handlers.go: an HTTP stream fed straight
    # from the event path) ---------------------------------------------------

    def listen(self, bucket: str, prefix: str = "", suffix: str = "",
               events: tuple = ("s3:*",), depth: int = 256
               ) -> "_ListenSub":
        sub = _ListenSub(bucket, prefix, suffix, tuple(events),
                         queue.Queue(maxsize=depth))
        with self._listen_lock:
            self._listeners.append(sub)
        return sub

    def unlisten(self, sub: "_ListenSub") -> None:
        with self._listen_lock:
            try:
                self._listeners.remove(sub)
            except ValueError:
                pass

    def stop(self):
        for s in self.stores.values():
            s.stop()
