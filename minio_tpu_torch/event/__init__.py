"""Bucket event notification, the port of minio_tpu/event (reference
pkg/event: 11 target types +
persistent queue store + ARN routing). Here: S3-shaped event records,
notification-rule matching, a crash-safe on-disk delivery queue with
retry, and ten target kinds — webhook, kafka, amqp, mqtt, redis,
elasticsearch, nats, nsq, postgresql, mysql — the broker-backed ones speaking
minimal native wire protocols (event/wire.py) instead of vendor SDKs."""
from .notifier import (EventNotifier, targets_from_config,
                       targets_from_env)
from .queuestore import QueueStore
from .record import new_event_record
from .rules import NotificationRules, parse_notification_xml
from .targets import (AMQPTarget, ElasticsearchTarget, KafkaTarget,
                      MQTTTarget, MySQLTarget, NATSTarget, NSQTarget,
                      PostgresTarget, RedisTarget, WebhookTarget)

__all__ = [
    "EventNotifier", "targets_from_env", "targets_from_config",
    "QueueStore", "new_event_record", "NotificationRules",
    "parse_notification_xml", "WebhookTarget", "KafkaTarget",
    "AMQPTarget", "MQTTTarget", "RedisTarget", "ElasticsearchTarget",
    "NATSTarget", "NSQTarget", "PostgresTarget", "MySQLTarget",
]
