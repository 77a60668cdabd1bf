"""Prometheus metrics, the port of minio_tpu/obs/metrics.py: a v2-style
grouped registry (reference cmd/metrics-v2.go: MetricsGroup generators
with cached reads, namespaced descriptors, cluster vs node exposition
paths; cmd/metrics-router.go mounts /minio/v2/metrics/{cluster,node}).

Two layers:

* A process-wide counter/histogram store (``inc``/``observe``) that hot
  paths write to with GIL-atomic dict ops — request counts, TTFB, the
  request waits on the queue, admission rejects, trace drops.
* ``MetricsGroup`` generators that sample subsystem state on demand, each
  cached for ``interval`` seconds the way the reference caches group
  reads, so a scrape storm cannot hammer /proc or statvfs.

Only the groups whose subsystem the port has: software, capacity,
device (the flight recorder's lanes), usage (the data scanner's snapshot,
its bucket rows through the bucket analytics' fold gate), bucket (the
per-bucket analytics of ``obs/bucketstats``), dispatch, disk_latency,
kernel, qos (admission and the class
windows), lane, pipeline, disk_health (the health trackers' states),
durability (the fsync policy and flusher), workloads (the SSE package
cipher), slo (objectives, windows, burn rates, breaches), profiler (the
sampler's health and overhead, role and subsystem shares, the lock-wait
histogram), device_obs, process and heal (the auto-heal trackers and the
MRF), plus the stage attribution families on ``?attribution=1``. The
scanner's counters
(``minio_tpu_scanner_{cycles,objects_scanned,bytes_scanned}_total``), the
janitor's and the quarantine's (``minio_tpu_durability_*``), the health
trackers' (``minio_tpu_disk_{trips,reonline}_total``), the SLO outcomes
(``minio_tpu_slo_requests_total``) and the profiler's breach captures
ride the counter store, as do the hedged reads
(``minio_tpu_hedged_reads_total{outcome}``, beside the
``minio_tpu_hedge_threshold_seconds`` gauge of the disk_health group) and
the fault plane's injections (``minio_tpu_fault_injected_total{layer,
action}``) and the log plane's sent and dropped entries
(``minio_tpu_log_target_{sent,dropped}_total``,
``minio_tpu_log_pubsub_dropped_total``). The replication group (the
S3-target pool's and the cross-node plane's queues, completions and lag,
and the per-bucket bandwidth limit and rate), the notification group (each
target's queue store) and the ILM group (the tiers configured) are there
once their planes are enabled; the ILM, replication and notification
counters (``minio_tpu_ilm_{expired,transitioned,restored}_total``,
``minio_tpu_replication_{charged,dropped}_total``,
``minio_tpu_notify_{events,listener}_dropped_total``) ride the counter
store. The groups of planes the port has not (cache, locks) are absent,
not faked, as is the scan lane's gauge. The names are the JAX package's,
so one dashboard reads both servers; the port adds
``minio_tpu_device_obs_stream_occupancy_ratio`` (the share of the last
minute the flushes' CUDA-event intervals cover on the card's streams,
which the JAX package does not measure; the streams' waits for the host
are in it, so it is not the card's busy share).
"""
from __future__ import annotations

import os
import re
import threading
import time

_start = time.monotonic()  # uptime is a duration: NTP-step-proof
_lock = threading.Lock()
_counters: dict[str, float] = {}
_histograms: dict[str, list[float]] = {}

BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)

#: group cache interval (reference metricsGroupCacheInterval 10s; kept
#: short enough that tests see fresh numbers)
CACHE_INTERVAL_S = float(os.environ.get("MINIO_TPU_METRICS_CACHE_S", "3"))


def inc(name: str, value: float = 1.0, **labels):
    key = _key(name, labels)
    with _lock:
        _counters[key] = _counters.get(key, 0.0) + value


def observe(name: str, seconds: float, **labels):
    key = _key(name, labels)
    with _lock:
        _histograms.setdefault(key, []).append(seconds)
        if len(_histograms[key]) > 10_000:
            _histograms[key] = _histograms[key][-5_000:]


def counters_snapshot() -> dict[str, float]:
    """Point-in-time copy of the counter store (peer RPC aggregation,
    tests)."""
    with _lock:
        return dict(_counters)


def histograms_snapshot() -> dict[str, list[float]]:
    """Point-in-time copy of the raw histogram samples (admin top-api)."""
    with _lock:
        return {k: list(v) for k, v in _histograms.items()}


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    lab = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{lab}}}"


class MetricsGroup:
    """One generator of related metrics, output cached for ``interval``
    seconds (reference MetricsGroup + timedValue)."""

    def __init__(self, name: str, scope: str, gen,
                 interval: float | None = None):
        self.name = name
        self.scope = scope              # "cluster" | "node"
        self.gen = gen                  # (server) -> list[str]
        self.interval = CACHE_INTERVAL_S if interval is None else interval
        #: cache keyed per live server instance (weak keys: an id()-based
        #: map could hand a recycled address another server's numbers) —
        #: several servers in one process must not serve each other's
        #: disk counts
        import weakref
        self._cached: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._lock = threading.Lock()

    def lines(self, server) -> list[str]:
        with self._lock:
            now = time.monotonic()
            hit = self._cached.get(server)
            if hit is None or now - hit[0] >= self.interval:
                try:
                    out = self.gen(server)
                except Exception:  # noqa: BLE001 — one group must never
                    out = []  # take down the whole exposition
                self._cached[server] = (now, out)
                return out
            return hit[1]


def _all_disks(obj) -> list:
    """Every disk under any ObjectLayer shape: one set (.disks), a sets
    layer (.sets -> .disks), or server pools (.pools -> recurse)."""
    if hasattr(obj, "disks"):
        return [d for d in obj.disks if d is not None]
    if hasattr(obj, "sets"):
        return [d for s in obj.sets for d in s.disks if d is not None]
    if hasattr(obj, "pools"):
        return [d for p in obj.pools for d in _all_disks(p)]
    return []


def _queues() -> list:
    """The process's dispatch queues (one per device)."""
    from ..runtime import dispatch
    with dispatch._queues_lock:
        return list(dispatch._queues.values())


def _queue_depth() -> int | None:
    """Items waiting in every lane of every queue, read under the lanes'
    locks; None without a queue."""
    qs = _queues()
    if not qs:
        return None
    depth = 0
    for q in qs:
        for lane in q._lanes():
            with lane.cv:
                depth += sum(len(b.items) for b in lane.buckets.values())
    return depth


# -- group generators ---------------------------------------------------------


def _g_software(server) -> list[str]:
    from .. import __version__
    return [
        "# TYPE minio_tpu_uptime_seconds gauge",
        f"minio_tpu_uptime_seconds {time.monotonic() - _start:.1f}",
        "# TYPE minio_tpu_info gauge",
        f'minio_tpu_info{{version="{__version__}"}} 1',
    ]


def _g_capacity(server) -> list[str]:
    """Cluster capacity + drive states (reference getClusterCapacityMD,
    getNodeDiskMetrics)."""
    info = server.obj.storage_info()
    lines = [
        "# TYPE minio_tpu_cluster_disk_online_total gauge",
        f"minio_tpu_cluster_disk_online_total {info.get('disks_online', 0)}",
        "# TYPE minio_tpu_cluster_disk_offline_total gauge",
        "minio_tpu_cluster_disk_offline_total "
        f"{info.get('disks_offline', 0)}",
    ]
    pools = info.get("pools")
    if pools:
        lines.append("# TYPE minio_tpu_cluster_pool_count gauge")
        lines.append(f"minio_tpu_cluster_pool_count {len(pools)}")
    # raw fs capacity of each local disk root (statvfs — the reference
    # reads the same from disk.GetInfo)
    total = free = 0
    for d in _all_disks(server.obj):
        base = getattr(d, "root", None)
        if not base:
            continue
        try:
            st = os.statvfs(base)
        except OSError:
            continue
        total += st.f_frsize * st.f_blocks
        free += st.f_frsize * st.f_bavail
    if total:
        lines += [
            "# TYPE minio_tpu_cluster_capacity_raw_total_bytes gauge",
            f"minio_tpu_cluster_capacity_raw_total_bytes {total}",
            "# TYPE minio_tpu_cluster_capacity_raw_free_bytes gauge",
            f"minio_tpu_cluster_capacity_raw_free_bytes {free}",
        ]
    return lines


def _g_usage(server) -> list[str]:
    """Scanner-derived usage (reference getBucketUsageMetrics). Bucket
    rows go through the bucket analytics' fold gate: a namespace of many
    buckets renders at most ``top_n`` tracked rows plus one
    ``_overflow_`` row summing the rest."""
    from ..scanner.usage import load_usage
    from . import bucketstats as _bs
    usage = load_usage(server.obj)
    lines = [
        "# TYPE minio_tpu_cluster_usage_object_total gauge",
        f"minio_tpu_cluster_usage_object_total "
        f"{usage.get('objects_total', 0)}",
        "# TYPE minio_tpu_cluster_usage_total_bytes gauge",
        f"minio_tpu_cluster_usage_total_bytes {usage.get('size_total', 0)}",
        "# TYPE minio_tpu_bucket_usage_total_bytes gauge",
        "# TYPE minio_tpu_bucket_usage_object_total gauge",
    ]
    folded: dict[str, list[int]] = {}
    for b, st in usage.get("buckets", {}).items():
        row = folded.setdefault(_bs.fold_label(b), [0, 0])
        row[0] += st.get("size", 0)
        row[1] += st.get("objects", 0)
    for lab, (size, objs) in sorted(folded.items()):
        lines.append(
            f'minio_tpu_bucket_usage_total_bytes{{bucket="{_esc(lab)}"}} '
            f'{size}')
        lines.append(
            f'minio_tpu_bucket_usage_object_total{{bucket="{_esc(lab)}"}} '
            f'{objs}')
    return lines


def _g_bucket(server) -> list[str]:
    """Per-bucket analytics (obs/bucketstats): requests, traffic and
    latency per tracked bucket, live usage, drift, SLO burn contribution
    and growth projection, bounded by the registry's top_n plus the
    ``_overflow_`` row."""
    from . import bucketstats as _bs
    return _bs.metric_lines()


def _g_replication(server) -> list[str]:
    """Replication queue and per-bucket bandwidth (reference
    getBucketReplicationMetrics and the bandwidth Report)."""
    lines = []
    pool = getattr(server, "replication", None)
    if pool is not None:
        lines += [
            "# TYPE minio_tpu_replication_completed_total counter",
            f"minio_tpu_replication_completed_total {pool.replicated}",
            "# TYPE minio_tpu_replication_failed_total counter",
            f"minio_tpu_replication_failed_total {pool.failed}",
            "# TYPE minio_tpu_replication_queued gauge",
            f"minio_tpu_replication_queued {pool.q.qsize()}",
        ]
    rs = getattr(server, "replication_sys", None)
    if rs is not None:
        st = rs.stats()
        if pool is None:
            lines += [
                "# TYPE minio_tpu_replication_completed_total counter",
                f"minio_tpu_replication_completed_total {st['completed']}",
                "# TYPE minio_tpu_replication_failed_total counter",
                f"minio_tpu_replication_failed_total {st['failed']}",
                "# TYPE minio_tpu_replication_queued gauge",
                f"minio_tpu_replication_queued {st['queued']}",
            ]
        lines += [
            "# TYPE minio_tpu_replication_backlog gauge",
            f"minio_tpu_replication_backlog {st['queued']}",
            "# TYPE minio_tpu_replication_retry_pending gauge",
            f"minio_tpu_replication_retry_pending {st['retry_pending']}",
            "# TYPE minio_tpu_replication_resynced_total counter",
            f"minio_tpu_replication_resynced_total {st['resynced']}",
            "# TYPE minio_tpu_replication_lag_seconds gauge",
            'minio_tpu_replication_lag_seconds{quantile="0.5"} '
            f"{st['lag_p50_s']}",
            'minio_tpu_replication_lag_seconds{quantile="0.99"} '
            f"{st['lag_p99_s']}",
        ]
    from ..bucket.bandwidth import global_monitor
    stats = global_monitor().report().get("bucketStats", {})
    if stats:
        lines.append("# TYPE minio_tpu_bucket_bandwidth_limit_bytes gauge")
        lines.append(
            "# TYPE minio_tpu_bucket_bandwidth_current_bytes gauge")
        # the rows are bounded by the operator's throttle configuration
        # (a bucket appears once a limit is set on it), not by traffic
        for b, st in sorted(stats.items()):
            lines.append(
                f'minio_tpu_bucket_bandwidth_limit_bytes{{bucket="{b}"}} '
                f'{st["limitInBits"]}')
            lines.append(
                f'minio_tpu_bucket_bandwidth_current_bytes{{bucket="{b}"}}'
                f' {st["currentBandwidth"]}')
    return lines


def _g_notification(server) -> list[str]:
    """Event-target queue depth, deliveries and failures per ARN
    (reference getNotificationMetrics: the queue stores' state)."""
    stores = getattr(getattr(server, "_notifier", None), "stores", None)
    if not stores:
        return []
    lines = [
        "# TYPE minio_tpu_notify_events_queued gauge",
        "# TYPE minio_tpu_notify_events_queue_limit gauge",
        "# TYPE minio_tpu_notify_events_sent_total counter",
        "# TYPE minio_tpu_notify_events_send_failures_total counter",
        "# TYPE minio_tpu_notify_events_skipped_total counter",
    ]
    for arn, st in sorted(stores.items()):
        lab = f'{{target="{arn}"}}'
        lines += [
            f"minio_tpu_notify_events_queued{lab} {st._count}",
            f"minio_tpu_notify_events_queue_limit{lab} {st.limit}",
            f"minio_tpu_notify_events_sent_total{lab} {st.delivered}",
            f"minio_tpu_notify_events_send_failures_total{lab} "
            f"{st.send_failures}",
            f"minio_tpu_notify_events_skipped_total{lab} "
            f"{st.failed_puts}",
        ]
    return lines


def _g_ilm(server) -> list[str]:
    """ILM state (reference getILMNodeMetrics): the tier registry; the
    transition, restore and expiry totals ride the counter store."""
    tiers = getattr(server, "_tiers", None)
    if tiers is None:
        return []
    return ["# TYPE minio_tpu_ilm_tiers_configured gauge",
            f"minio_tpu_ilm_tiers_configured {len(tiers.tiers)}"]


def _g_dispatch(server) -> list[str]:
    """The dispatch queues (every device's): flushes, items, average batch
    and flushes by route (device: the card's queue, cpu: a CPU queue).
    Queue depth renders at scrape time (``_c_live_gauges``)."""
    qs = _queues()
    if not qs:
        return []
    stats = [(q.route, q.stats()) for q in qs]
    batches = sum(st["batches"] for _, st in stats)
    items = sum(st["items"] for _, st in stats)
    lines = [
        "# TYPE minio_tpu_dispatch_batches_total counter",
        f"minio_tpu_dispatch_batches_total {batches}",
        "# TYPE minio_tpu_dispatch_items_total counter",
        f"minio_tpu_dispatch_items_total {items}",
        "# TYPE minio_tpu_dispatch_avg_batch gauge",
        f"minio_tpu_dispatch_avg_batch "
        f"{items / batches if batches else 0.0:.2f}",
    ]
    for route in ("cpu", "device"):
        n = sum(st["batches"] for r, st in stats if r == route)
        lines.append(f"# TYPE minio_tpu_dispatch_{route}_batches gauge")
        lines.append(f"minio_tpu_dispatch_{route}_batches {n}")
    return lines


def _g_device(server) -> list[str]:
    """Per-lane (bulk, interactive) utilization from the flight recorder
    (obs/timeline.py): the dispatcher's busy-ratio integration over the
    last minute, lifetime flush/item/busy totals, batch-occupancy (fill vs
    capacity), and the sampled dispatch queue-depth distribution.
    Companion recorder-health counters ride the same group."""
    from . import timeline as tl
    util = tl.utilization()
    lines = []
    if util["lanes"]:
        lines += ["# TYPE minio_tpu_device_busy_ratio gauge",
                  "# TYPE minio_tpu_device_flushes_total counter",
                  "# TYPE minio_tpu_device_items_total counter",
                  "# TYPE minio_tpu_device_busy_seconds_total counter",
                  "# TYPE minio_tpu_device_flush_bytes_total counter",
                  "# TYPE minio_tpu_device_batch_fill_avg gauge"]
        for lane, st in util["lanes"].items():
            lab = f'{{lane="{_esc(lane)}"}}'
            lines += [
                f"minio_tpu_device_busy_ratio{lab} {st['busy_ratio']}",
                f"minio_tpu_device_flushes_total{lab} {st['flushes']}",
                f"minio_tpu_device_items_total{lab} {st['items']}",
                f"minio_tpu_device_busy_seconds_total{lab} "
                f"{st['busy_seconds_total']}",
                f"minio_tpu_device_flush_bytes_total{lab} {st['bytes']}",
                f"minio_tpu_device_batch_fill_avg{lab} "
                f"{st['batch_fill_avg']}",
            ]
        lines.append("# TYPE minio_tpu_device_batch_fill_total counter")
        for lane, st in util["lanes"].items():
            for bucket, n in st["batch_fill_hist"].items():
                lines.append(
                    "minio_tpu_device_batch_fill_total"
                    f'{{lane="{_esc(lane)}",fill="{bucket}"}} {n}')
    qd = util["queue_depth"]
    if qd["samples"]:
        lines += [
            "# TYPE minio_tpu_device_queue_depth gauge",
            f'minio_tpu_device_queue_depth{{quantile="0.5"}} {qd["p50"]}',
            f'minio_tpu_device_queue_depth{{quantile="0.99"}} '
            f'{qd["p99"]}',
        ]
    st = tl.status()
    lines += [
        "# TYPE minio_tpu_timeline_enabled gauge",
        f"minio_tpu_timeline_enabled {1 if st['enabled'] else 0}",
        "# TYPE minio_tpu_timeline_events_total counter",
        f"minio_tpu_timeline_events_total {st['events_total']}",
        "# TYPE minio_tpu_timeline_dropped_total counter",
        f"minio_tpu_timeline_dropped_total {st['dropped_total']}",
    ]
    return lines


def _g_lane(server) -> list[str]:
    """The dispatch lanes (bulk and interactive): per-stream flush/item
    totals, the interactive lane's switch, batch cap and async (event
    poller) completions, and per-stream wall percentiles. The consumer-side
    wait counters (``minio_tpu_lane_await_total{op}``,
    ``minio_tpu_lane_await_seconds_total{op}``) ride the counter store,
    incremented by runtime/completion.await_result. The JAX lane's
    deadline cuts, queued bytes and backlog belong to its QoS scheduler,
    not ported."""
    from . import latency as lat
    lines: list[str] = []
    qs = _queues()
    if qs:
        lanes = [q.stats()["lanes"] for q in qs]
        ia = [ln["interactive"] for ln in lanes]
        bulk_flushes = sum(ln["bulk"]["flushes"] for ln in lanes)
        bulk_items = sum(ln["bulk"]["items"] for ln in lanes)
        lines += [
            "# TYPE minio_tpu_lane_enabled gauge",
            f"minio_tpu_lane_enabled "
            f"{1 if any(x['enabled'] for x in ia) else 0}",
            "# TYPE minio_tpu_lane_flushes_total counter",
            'minio_tpu_lane_flushes_total{stream="interactive"} '
            f"{sum(x['flushes'] for x in ia)}",
            f'minio_tpu_lane_flushes_total{{stream="bulk"}} '
            f"{bulk_flushes}",
            "# TYPE minio_tpu_lane_items_total counter",
            'minio_tpu_lane_items_total{stream="interactive"} '
            f"{sum(x['items'] for x in ia)}",
            f'minio_tpu_lane_items_total{{stream="bulk"}} {bulk_items}',
            "# TYPE minio_tpu_lane_async_completions_total counter",
            "minio_tpu_lane_async_completions_total "
            f"{sum(x['async_completions'] for x in ia)}",
            "# TYPE minio_tpu_lane_batch_max gauge",
            'minio_tpu_lane_batch_max{stream="interactive"} '
            f"{max(x['batch_cap'] for x in ia)}",
        ]
    rows = lat.snapshot("lane")
    if rows:
        lines.append("# TYPE minio_tpu_lane_wall_seconds gauge")
        for labels, w in rows:
            stream = _esc(labels.get("stream", ""))
            st = w.stats(tuple(q for q, _ in _QUANTILES))
            for q, qs_ in _QUANTILES:
                lines.append(
                    "minio_tpu_lane_wall_seconds"
                    f'{{stream="{stream}",quantile="{qs_}"}} '
                    f'{st["percentiles"][q]:.6f}')
    return lines


def _g_qos(server) -> list[str]:
    """QoS plane as far as it is ported: admission capacity, in-flight
    and admitted totals, the queue depth, and per-class last-minute
    latency percentiles of dispatch items. Admission REJECT totals ride
    the counter store (``minio_tpu_qos_admission_rejects_total{class,
    reason}``), incremented at rejection time. The JAX scheduler's spill,
    deadline and lane-divert families are absent: no scheduler here."""
    from . import latency as lat
    lines: list[str] = []
    depth = _queue_depth()
    if depth is not None:
        lines += ["# TYPE minio_tpu_qos_queue_depth gauge",
                  f"minio_tpu_qos_queue_depth {depth}"]
    adm = getattr(server, "qos_admission", None)
    if adm is not None:
        st = adm.stats()
        lines += [
            "# TYPE minio_tpu_qos_admission_max_requests gauge",
            f"minio_tpu_qos_admission_max_requests {st['max_requests']}",
            "# TYPE minio_tpu_qos_admission_inflight gauge",
            "minio_tpu_qos_admission_inflight "
            f"{st['inflight_total']}",
        ]
        if st["admitted"]:
            lines.append(
                "# TYPE minio_tpu_qos_admitted_total counter")
            for cls, n in sorted(st["admitted"].items()):
                lines.append(
                    f'minio_tpu_qos_admitted_total{{class="{_esc(cls)}"}} '
                    f"{n}")
    rows = lat.snapshot("qos")
    if rows:
        lines.append(
            "# TYPE minio_tpu_qos_class_latency_seconds gauge")
        for labels, w in rows:
            cls = _esc(labels.get("class", ""))
            st = w.stats(tuple(q for q, _ in _QUANTILES))
            for q, qs_ in _QUANTILES:
                lines.append(
                    "minio_tpu_qos_class_latency_seconds"
                    f'{{class="{cls}",quantile="{qs_}"}} '
                    f'{st["percentiles"][q]:.6f}')
    return lines


def _g_pipeline(server) -> list[str]:
    """The block buffer pool's hit/miss counters. The retained-bytes
    gauge renders at scrape time (``_c_live_gauges``)."""
    from ..runtime import bufpool
    if bufpool._global is None:
        return []
    st = bufpool._global.stats()
    return [
        "# TYPE minio_tpu_pipeline_bufpool_hits_total counter",
        f"minio_tpu_pipeline_bufpool_hits_total {st['hits']}",
        "# TYPE minio_tpu_pipeline_bufpool_misses_total counter",
        f"minio_tpu_pipeline_bufpool_misses_total {st['misses']}",
    ]


def _g_process(server) -> list[str]:
    """Node process resources (reference getMinioProcMetrics:
    /proc/self/io rchar/wchar, fds, rss)."""
    lines = []
    try:
        with open("/proc/self/io") as f:
            io_stats = dict(ln.strip().split(": ") for ln in f
                            if ": " in ln)
        lines += [
            "# TYPE minio_tpu_node_io_rchar_bytes counter",
            f"minio_tpu_node_io_rchar_bytes {io_stats.get('rchar', 0)}",
            "# TYPE minio_tpu_node_io_wchar_bytes counter",
            f"minio_tpu_node_io_wchar_bytes {io_stats.get('wchar', 0)}",
        ]
    except OSError:
        pass
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    rss_kb = int(ln.split()[1])
                    lines += [
                        "# TYPE minio_tpu_node_process_resident_memory_bytes"
                        " gauge",
                        "minio_tpu_node_process_resident_memory_bytes "
                        f"{rss_kb * 1024}",
                    ]
                    break
    except OSError:
        pass
    try:
        nfds = len(os.listdir("/proc/self/fd"))
        lines += ["# TYPE minio_tpu_node_file_descriptor_open_total gauge",
                  f"minio_tpu_node_file_descriptor_open_total {nfds}"]
    except OSError:
        pass
    return lines


def _g_heal(server) -> list[str]:
    """Heal detail (reference getHealingMetrics): the per-disk healing
    trackers and the MRF queue; heal-op counters ride the store."""
    from ..scanner.autoheal import get_healing_tracker
    healing = objects_healed = items_failed = 0
    for d in _all_disks(server.obj):
        t = get_healing_tracker(d)
        if t is not None:
            healing += 1
            objects_healed += t.get("objects_healed", 0)
            items_failed += t.get("objects_failed", 0)
    lines = ["# TYPE minio_tpu_heal_disks_healing gauge",
             f"minio_tpu_heal_disks_healing {healing}"]
    if healing:
        lines += [
            "# TYPE minio_tpu_heal_tracker_objects_healed gauge",
            f"minio_tpu_heal_tracker_objects_healed {objects_healed}",
            "# TYPE minio_tpu_heal_tracker_items_failed gauge",
            f"minio_tpu_heal_tracker_items_failed {items_failed}",
        ]
    mrf = getattr(server, "mrf", None)
    if mrf is not None:
        st = mrf.stats()
        lines += [
            "# TYPE minio_tpu_heal_mrf_queued gauge",
            f"minio_tpu_heal_mrf_queued {st['queued']}",
            "# TYPE minio_tpu_heal_mrf_healed_total counter",
            f"minio_tpu_heal_mrf_healed_total {st['healed']}",
            "# TYPE minio_tpu_heal_mrf_failed_total counter",
            f"minio_tpu_heal_mrf_failed_total {st['failed']}",
        ]
    return lines


def _g_disk_health(server) -> list[str]:
    """The disk health trackers' states and latency EWMAs
    (storage/health.py) and the live hedged-read threshold
    (erasure/streaming.py, while hedging is on); the trip, re-online,
    hedged-read and fault-injection counters ride the store."""
    rows = [(d.endpoint(), d.health_stats()) for d in _all_disks(server.obj)
            if hasattr(d, "health_stats")]
    lines = []
    if rows:
        lines += ["# TYPE minio_tpu_disk_state gauge",
                  "# TYPE minio_tpu_disk_health_ewma_seconds gauge"]
    for ep, st in rows:
        lines.append(f'minio_tpu_disk_state{{disk="{_esc(ep)}",'
                     f'state="{_esc(st["state"])}"}} 1')
        lines.append(f'minio_tpu_disk_health_ewma_seconds{{disk="{_esc(ep)}"}}'
                     f' {st["ewma_ms"] / 1e3:.6f}')
    from ..erasure.streaming import hedge_threshold_s, hedging_enabled
    if hedging_enabled():
        lines += ["# TYPE minio_tpu_hedge_threshold_seconds gauge",
                  f"minio_tpu_hedge_threshold_seconds "
                  f"{hedge_threshold_s():.6f}"]
    return lines


def _g_durability(server) -> list[str]:
    """Durability plane: the effective fsync policy and the batched
    flusher's state (the counters: recovered tmp, quarantines, orphan data
    dirs, expired uploads, recovery runs, ride the store)."""
    from ..storage import durability as dur
    st = dur.status()
    return [
        "# TYPE minio_tpu_durability_fsync_mode gauge",
        f'minio_tpu_durability_fsync_mode{{mode="{st["fsync"]}"}} 1',
        "# TYPE minio_tpu_durability_fsync_pending gauge",
        f"minio_tpu_durability_fsync_pending {st['pending']}",
        "# TYPE minio_tpu_durability_fsync_flushed_total counter",
        f"minio_tpu_durability_fsync_flushed_total {st['flushed_total']}",
    ]


_QUANTILES = ((0.5, "0.5"), (0.95, "0.95"), (0.99, "0.99"))


def _esc(v: str) -> str:
    """Prometheus label-value escaping: a disk endpoint is a
    user-supplied path, and one quote/backslash/newline in it must not
    break the whole exposition."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _g_disk_latency(server) -> list[str]:
    """Per-disk per-op online latency percentiles from the last-minute
    sliding windows the storage layer feeds (reference metrics-v2 drive
    latency rows over lastMinuteLatency)."""
    from . import latency as lat
    rows = lat.snapshot("disk")
    if not rows:
        return []
    lines = ["# TYPE minio_tpu_disk_latency_seconds gauge",
             "# TYPE minio_tpu_disk_op_last_minute_total gauge"]
    for labels, w in rows:
        disk = _esc(labels.get("disk", ""))
        op = _esc(labels.get("op", ""))
        st = w.stats(tuple(q for q, _ in _QUANTILES))
        for q, qs in _QUANTILES:
            lines.append(
                f'minio_tpu_disk_latency_seconds{{disk="{disk}",op="{op}",'
                f'quantile="{qs}"}} {st["percentiles"][q]:.6f}')
        lines.append(
            f'minio_tpu_disk_op_last_minute_total{{disk="{disk}",'
            f'op="{op}"}} {st["count"]}')
    return lines


def _hist_lines(fam: str, label: str, h: dict,
                exemplar_ok: bool) -> list[str]:
    """Render one Window.hist() as a real Prometheus histogram
    (`_bucket`/`_sum`/`_count`), with an OpenMetrics exemplar carrying
    the window's worst sample's trace_id on the first bucket that
    contains it — beside the p50/p99 summary gauges the dashboards
    keep. ``label`` is a pre-rendered
    ``key="value",`` prefix ('' for unlabeled families)."""
    from . import latency as lat
    out = []
    worst_s, worst_tid = h["worst_s"], h["worst_trace_id"]
    exemplar_at = None
    if exemplar_ok and worst_tid:
        for i, edge in enumerate(lat.HIST_EDGES):
            if worst_s <= edge:
                exemplar_at = i
                break
        else:
            exemplar_at = len(lat.HIST_EDGES)  # +Inf bucket
    for i, (edge, cum) in enumerate(zip(h["edges"], h["cum"])):
        ln = f'{fam}_bucket{{{label}le="{edge:.6g}"}} {cum}'
        if i == exemplar_at:
            ln += f' # {{trace_id="{_esc(worst_tid)}"}} {worst_s:.6f}'
        out.append(ln)
    inf = f'{fam}_bucket{{{label}le="+Inf"}} {h["count"]}'
    if exemplar_at == len(h["edges"]):
        inf += f' # {{trace_id="{_esc(worst_tid)}"}} {worst_s:.6f}'
    out.append(inf)
    base_label = f'{{{label[:-1]}}}' if label else ""
    out.append(f'{fam}_sum{base_label} {h["sum"]:.6f}')
    out.append(f'{fam}_count{base_label} {h["count"]}')
    return out


def _exemplar_fetchable(trace_id: str) -> bool:
    """Only trace ids the slow-trace store will actually serve are
    advertised as exemplars — same rule as the worst-sample gauge."""
    if not trace_id:
        return False
    from . import spans as _sp
    return _sp.store().contains(trace_id)


def _g_kernel(server) -> list[str]:
    """Per-op dispatch/heal kernel latency percentiles + GiB/s — the
    north star's metrics (erasure encode/reconstruct GiB/s, p99
    heal-shard latency) served online. The p50/p99 gauges keep their
    names for dashboard compatibility; the same windows ALSO render as
    real histograms (minio_tpu_kernel_op_duration_seconds /
    minio_tpu_heal_shard_duration_seconds) with OpenMetrics
    exemplars."""
    from . import latency as lat
    lines = ["# TYPE minio_tpu_kernel_op_latency_seconds gauge",
             "# TYPE minio_tpu_kernel_op_gibs gauge",
             "# TYPE minio_tpu_kernel_op_last_minute_total gauge"]
    hist_lines = ["# TYPE minio_tpu_kernel_op_duration_seconds histogram"]
    for labels, w in lat.snapshot("kernel"):
        op = _esc(labels.get("op", ""))
        st = w.stats(tuple(q for q, _ in _QUANTILES))
        for q, qs in _QUANTILES:
            lines.append(
                f'minio_tpu_kernel_op_latency_seconds{{op="{op}",'
                f'quantile="{qs}"}} {st["percentiles"][q]:.6f}')
        lines.append(f'minio_tpu_kernel_op_gibs{{op="{op}"}} '
                     f'{st["rate_gibs"]:.4f}')
        lines.append(f'minio_tpu_kernel_op_last_minute_total{{op="{op}"}} '
                     f'{st["count"]}')
        h = w.hist()
        hist_lines += _hist_lines(
            "minio_tpu_kernel_op_duration_seconds", f'op="{op}",', h,
            _exemplar_fetchable(h["worst_trace_id"]))
    lines += hist_lines
    # the north-star number gets its own stable gauge (creating the
    # window on first scrape so the family is always present); ONE
    # stats() merge serves both the p99 and its worst-sample exemplar
    # so they cannot disagree about the window
    heal = lat.get_window("kernel", op="heal_shard")
    hst = heal.stats((0.99,))
    lines += ["# TYPE minio_tpu_heal_shard_latency_p99_seconds gauge",
              "minio_tpu_heal_shard_latency_p99_seconds "
              f"{hst['percentiles'][0.99]:.6f}"]
    hh = heal.hist()
    lines += ["# TYPE minio_tpu_heal_shard_duration_seconds histogram"]
    lines += _hist_lines("minio_tpu_heal_shard_duration_seconds", "", hh,
                         _exemplar_fetchable(hh["worst_trace_id"]))
    # exemplar-style link from the north-star metric to the span tree
    # behind its worst sample (trace_id rides a label — Prometheus text
    # format has no native exemplars; fetch via admin trace?trace_id=).
    # Only ids that are actually FETCHABLE are advertised: the worst
    # sample's trace is tail-discarded when the whole request stayed
    # inside its budget, and an exemplar that 404s is worse than none.
    worst_s, worst_tid = hst["worst_s"], hst["worst_trace_id"]
    if worst_tid:
        from . import spans as _sp
        if _sp.store().contains(worst_tid):
            lines += [
                "# TYPE minio_tpu_heal_shard_latency_worst_seconds gauge",
                "minio_tpu_heal_shard_latency_worst_seconds"
                f'{{trace_id="{_esc(worst_tid)}"}} {worst_s:.6f}']
    return lines


def _g_workloads(server) -> list[str]:
    """Data-plane workloads: the package cipher of new SSE objects
    (``workloads.sse_cipher``). The scan lane's gauge
    (``minio_tpu_workloads_scan_lane``) is not ported: the port's Select
    scan always rides the dispatch queue, with no ``workloads.scan``
    switch to report."""
    from ..crypto.sse import CIPHER_CHACHA20, default_cipher
    cipher = "chacha20" if default_cipher() == CIPHER_CHACHA20 \
        else "aes-gcm"
    return ["# TYPE minio_tpu_workloads_sse_cipher gauge",
            f'minio_tpu_workloads_sse_cipher{{cipher="{cipher}"}} 1']


def _g_slo(server) -> list[str]:
    """SLO plane (obs/slo.py): per-class objectives, fast/slow-window
    compliance and error-budget burn rates, breach verdicts, worst-breach
    trace link.
    The cumulative outcome counter
    (minio_tpu_slo_requests_total{class,outcome}) rides the counter
    store, incremented at record time."""
    from . import slo
    rep = slo.report()
    if not rep["enabled"]:
        return ["# TYPE minio_tpu_slo_enabled gauge",
                "minio_tpu_slo_enabled 0"]
    lines = [
        "# TYPE minio_tpu_slo_enabled gauge",
        "minio_tpu_slo_enabled 1",
        "# TYPE minio_tpu_slo_availability_objective gauge",
        "# TYPE minio_tpu_slo_latency_threshold_seconds gauge",
        "# TYPE minio_tpu_slo_latency_objective gauge",
        "# TYPE minio_tpu_slo_window_requests gauge",
        "# TYPE minio_tpu_slo_window_errors gauge",
        "# TYPE minio_tpu_slo_window_breaches gauge",
        "# TYPE minio_tpu_slo_availability_ratio gauge",
        "# TYPE minio_tpu_slo_latency_ratio gauge",
        "# TYPE minio_tpu_slo_burn_rate gauge",
        "# TYPE minio_tpu_slo_breach gauge",
        "# TYPE minio_tpu_slo_worst_breach_seconds gauge",
    ]
    for cls, ent in sorted(rep["classes"].items()):
        lab = f'class="{_esc(cls)}"'
        obj = ent["objective"]
        lines += [
            f"minio_tpu_slo_availability_objective{{{lab}}} "
            f"{obj['availability']}",
            f"minio_tpu_slo_latency_threshold_seconds{{{lab}}} "
            f"{obj['latency_threshold_s']}",
            f"minio_tpu_slo_latency_objective{{{lab}}} "
            f"{obj['latency_target']}",
        ]
        for win, w in sorted(ent["windows"].items()):
            wlab = f'{lab},window="{win}"'
            lines += [
                f"minio_tpu_slo_window_requests{{{wlab}}} "
                f"{w['requests']}",
                f"minio_tpu_slo_window_errors{{{wlab}}} {w['errors']}",
                f"minio_tpu_slo_window_breaches{{{wlab}}} {w['slow']}",
                f"minio_tpu_slo_availability_ratio{{{wlab}}} "
                f"{w['availability']}",
                f"minio_tpu_slo_latency_ratio{{{wlab}}} "
                f"{w['latency_ok_ratio']}",
                f'minio_tpu_slo_burn_rate{{{lab},slo="availability",'
                f'window="{win}"}} {w["availability_burn"]}',
                f'minio_tpu_slo_burn_rate{{{lab},slo="latency",'
                f'window="{win}"}} {w["latency_burn"]}',
            ]
        for kind, hit in sorted(ent["breach"].items()):
            lines.append(
                f'minio_tpu_slo_breach{{{lab},slo="{kind}"}} '
                f"{1 if hit else 0}")
        worst = ent["worst_breach"]
        if worst["stored"]:
            # exemplar rule shared with the heal worst gauge: only
            # trace ids the slow-trace store will actually serve (the
            # TYPE line lives in the header — per-class emission would
            # duplicate it when several classes hold a stored breach)
            lines.append(
                f"minio_tpu_slo_worst_breach_seconds{{{lab},"
                f'trace_id="{_esc(worst["trace_id"])}"}} '
                f"{worst['seconds']}")
    return lines


def _g_profiler(server) -> list[str]:
    """Continuous profiling plane (obs/profiler.py): sampler health +
    self-measured overhead, per-role sample counts, subsystem CPU shares,
    and the lock-wait histogram the tracked-lock acquires feed. The
    breach-capture counters (minio_tpu_profiler_breach_captures_total{class},
    minio_tpu_profiler_breach_capture_errors_total) ride the counter
    store, incremented by the capture worker."""
    from . import profiler
    st = profiler.status()
    lines = [
        "# TYPE minio_tpu_profiler_enabled gauge",
        f"minio_tpu_profiler_enabled {1 if st['enabled'] else 0}",
        "# TYPE minio_tpu_profiler_running gauge",
        f"minio_tpu_profiler_running {1 if st['running'] else 0}",
        "# TYPE minio_tpu_profiler_hz gauge",
        f"minio_tpu_profiler_hz {st['hz']:g}",
        "# TYPE minio_tpu_profiler_samples_total counter",
        f"minio_tpu_profiler_samples_total {st['samples_total']}",
        "# TYPE minio_tpu_profiler_dropped_total counter",
        f"minio_tpu_profiler_dropped_total {st['dropped_total']}",
        "# TYPE minio_tpu_profiler_stacks gauge",
        f"minio_tpu_profiler_stacks {st['distinct_stacks']}",
        "# TYPE minio_tpu_profiler_overhead_ratio gauge",
        f"minio_tpu_profiler_overhead_ratio {st['overhead_ratio']}",
        "# TYPE minio_tpu_profiler_lockwait_samples_total counter",
        "minio_tpu_profiler_lockwait_samples_total "
        f"{st['lockwait_samples_total']}",
    ]
    if st["roles"]:
        lines.append(
            "# TYPE minio_tpu_profiler_role_samples_total counter")
        for role, n in sorted(st["roles"].items()):
            lines.append(
                "minio_tpu_profiler_role_samples_total"
                f'{{role="{_esc(role)}"}} {n}')
    if st["subsystem_shares"]:
        lines.append(
            "# TYPE minio_tpu_profiler_subsystem_share gauge")
        for sub, share in sorted(st["subsystem_shares"].items()):
            lines.append(
                "minio_tpu_profiler_subsystem_share"
                f'{{subsystem="{_esc(sub)}"}} {share}')
    waits = profiler.lock_wait_snapshot()
    if waits:
        fam = "minio_tpu_lock_wait_seconds"
        lines.append(f"# TYPE {fam} histogram")
        lines.append("# TYPE minio_tpu_lock_wait_sites gauge")
        lines.append(f"minio_tpu_lock_wait_sites {len(waits)}")
        for site, w in sorted(waits.items()):
            lab = f'site="{_esc(site)}",'
            cum = 0
            for edge, n in zip(profiler.LOCK_WAIT_BUCKETS,
                               w["buckets"]):
                cum += n
                lines.append(
                    f'{fam}_bucket{{{lab}le="{edge:g}"}} {cum}')
            lines.append(
                f'{fam}_bucket{{{lab}le="+Inf"}} {w["count"]}')
            lines.append(
                f'{fam}_sum{{site="{_esc(site)}"}} {w["sum"]:.6f}')
            lines.append(
                f'{fam}_count{{site="{_esc(site)}"}} {w["count"]}')
    return lines


def _g_device_obs(server) -> list[str]:
    """Device plane (obs/device.py): per-lane live-buffer ledger gauges,
    build counters, per-op seconds of the flushes' CUDA-event intervals,
    the achieved GiB/s and roofline ratio over them against the card's
    bound (absent where the bound is unknown), the streams' occupancy over
    the last minute, host buffer
    high-water, and the caching allocator's bytes once CUDA is live. The
    storm counter (``minio_tpu_device_obs_compile_storms_total``) rides
    the counter store."""
    from . import device
    st = device.status(touch_backend=False)
    lines = [
        "# TYPE minio_tpu_device_obs_enabled gauge",
        f"minio_tpu_device_obs_enabled {1 if st['enabled'] else 0}",
        "# TYPE minio_tpu_device_hbm_used gauge",
        "# TYPE minio_tpu_device_hbm_peak gauge",
        "# TYPE minio_tpu_device_hbm_live_buffers gauge",
        "# TYPE minio_tpu_device_obs_ledger_acquired_total counter",
        "# TYPE minio_tpu_device_obs_ledger_released_total counter",
    ]
    for lane, led in sorted(st["ledger"].items()):
        lab = f'lane="{_esc(lane)}"'
        lines += [
            f"minio_tpu_device_hbm_used{{{lab}}} {led['live_bytes']}",
            f"minio_tpu_device_hbm_peak{{{lab}}} {led['peak_bytes']}",
            f"minio_tpu_device_hbm_live_buffers{{{lab}}} "
            f"{led['live_buffers']}",
            f"minio_tpu_device_obs_ledger_acquired_total{{{lab}}} "
            f"{led['acquired_total']}",
            f"minio_tpu_device_obs_ledger_released_total{{{lab}}} "
            f"{led['released_total']}",
        ]
    comp = st["compile"]
    lines += [
        "# TYPE minio_tpu_device_obs_compiles_total counter",
        f"minio_tpu_device_obs_compiles_total {comp['compiles_total']}",
        "# TYPE minio_tpu_device_obs_compile_seconds_total counter",
        "minio_tpu_device_obs_compile_seconds_total "
        f"{comp['compile_seconds_total']}",
        "# TYPE minio_tpu_device_obs_first_launches_total counter",
        "minio_tpu_device_obs_first_launches_total "
        f"{comp['first_launches_total']}",
        "# TYPE minio_tpu_device_obs_host_buf_bytes gauge",
        "minio_tpu_device_obs_host_buf_bytes "
        f"{st['host_bufpool']['live_bytes']}",
        "# TYPE minio_tpu_device_obs_host_buf_peak_bytes gauge",
        "minio_tpu_device_obs_host_buf_peak_bytes "
        f"{st['host_bufpool']['peak_bytes']}",
    ]
    if st["roofline"]:
        lines += [
            "# HELP minio_tpu_kernel_roofline_ratio achieved GiB/s over "
            "the card's memory bound; bytes over the flushes' CUDA-event "
            "intervals, which hold the streams' waits for the host",
            "# HELP minio_tpu_kernel_achieved_gibs flush bytes over the "
            "flushes' CUDA-event intervals (a lower bound on the kernels' "
            "rate)",
            "# HELP minio_tpu_device_seconds_total seconds of the flushes' "
            "CUDA-event intervals: copies, kernels and the streams' waits "
            "for the host"]
        lines.append("# TYPE minio_tpu_kernel_roofline_ratio gauge")
        lines.append("# TYPE minio_tpu_kernel_achieved_gibs gauge")
        lines.append("# TYPE minio_tpu_device_seconds_total counter")
        for op, r in sorted(st["roofline"].items()):
            lab = f'op="{_esc(op)}"'
            if r["roofline_ratio"] is not None:
                lines.append(f"minio_tpu_kernel_roofline_ratio{{{lab}}} "
                             f"{r['roofline_ratio']}")
            lines.append(f"minio_tpu_kernel_achieved_gibs{{{lab}}} "
                         f"{r['achieved_gibs']}")
            lines.append(f"minio_tpu_device_seconds_total{{{lab}}} "
                         f"{r['device_seconds']}")
    occ = [(dev, o) for dev, o in st["stream_occupancy"].items()
           if o["union_share"] is not None]
    if occ:
        fam = "minio_tpu_device_obs_stream_occupancy_ratio"
        lines += [f"# HELP {fam} share of the last minute the flushes' "
                  "CUDA-event intervals cover (the streams' waits for the "
                  "host included; not the card's busy share)",
                  f"# TYPE {fam} gauge"]
        for dev, o in occ:
            lines.append(f'{fam}{{device="{_esc(dev)}",lane="all"}} '
                         f'{o["union_share"]}')
            for lane, ln in o["lanes"].items():
                lines.append(f'{fam}{{device="{_esc(dev)}",'
                             f'lane="{_esc(lane)}"}} {ln["share"]}')
    mem = st["device_memory"]
    if mem:
        lines.append("# TYPE minio_tpu_device_hbm_bytes_in_use gauge")
        lines.append("# TYPE minio_tpu_device_hbm_bytes_limit gauge")
        for d in mem:
            lab = f'device="{d["id"]}",platform="cuda"'
            lines.append(f"minio_tpu_device_hbm_bytes_in_use{{{lab}}} "
                         f"{d['bytes_in_use']}")
            lines.append(f"minio_tpu_device_hbm_bytes_limit{{{lab}}} "
                         f"{d['bytes_limit']}")
    return lines


_GROUPS = [
    MetricsGroup("software", "node", _g_software, interval=0),
    MetricsGroup("capacity", "cluster", _g_capacity),
    # device lanes read in-memory flight-recorder accounting —
    # interval 0 so a lane's busy ratio is live on every scrape
    MetricsGroup("device", "node", _g_device, interval=0),
    MetricsGroup("usage", "cluster", _g_usage),
    # the bounded registry in memory: interval 0 so request counters and
    # drift are live per scrape
    MetricsGroup("bucket", "node", _g_bucket, interval=0),
    MetricsGroup("replication", "cluster", _g_replication),
    MetricsGroup("dispatch", "node", _g_dispatch),
    # latency groups read in-memory windows — interval 0 keeps scrapes
    # (and tests driving heals) fresh at negligible cost
    MetricsGroup("disk_latency", "node", _g_disk_latency, interval=0),
    MetricsGroup("kernel", "node", _g_kernel, interval=0),
    MetricsGroup("qos", "node", _g_qos, interval=0),
    MetricsGroup("lane", "node", _g_lane, interval=0),
    MetricsGroup("pipeline", "node", _g_pipeline, interval=0),
    # disk health reads in-memory tracker state: interval 0 so a trip is
    # visible on the very next scrape
    MetricsGroup("disk_health", "node", _g_disk_health, interval=0),
    MetricsGroup("durability", "node", _g_durability, interval=0),
    MetricsGroup("workloads", "node", _g_workloads, interval=0),
    # slo reads in-memory windows: interval 0 so burn rates move on the
    # very next scrape after an incident starts
    MetricsGroup("slo", "node", _g_slo, interval=0),
    # profiler reads in-memory sampler state: interval 0 so subsystem
    # shares and lock-wait stats are live per scrape
    MetricsGroup("profiler", "node", _g_profiler, interval=0),
    # the device plane's ledger is the leak gate: live per scrape
    MetricsGroup("device_obs", "node", _g_device_obs, interval=0),
    MetricsGroup("process", "node", _g_process),
    MetricsGroup("notification", "cluster", _g_notification),
    MetricsGroup("ilm", "cluster", _g_ilm),
    MetricsGroup("heal", "cluster", _g_heal),
]


# -- scrape-time collectors ---------------------------------------------------
#
# Gauges that sample live state must be read AT SCRAPE TIME, not through
# a MetricsGroup cache: a queue that drained right after the last cache
# fill would keep reporting its pre-drain depth for a whole interval.
# Collectors run uncached on every render_prometheus call.

_COLLECTORS: list = []


def register_collector(fn) -> None:
    """Register a ``(server) -> list[str]`` callback rendered fresh on
    every scrape, bypassing all group caching."""
    _COLLECTORS.append(fn)


def _c_live_gauges(server) -> list[str]:
    """The live gauges: dispatch queue depth and bufpool retained
    bytes."""
    lines = []
    qdepth = _queue_depth()
    if qdepth is not None:
        lines += ["# TYPE minio_tpu_dispatch_queue_depth gauge",
                  f"minio_tpu_dispatch_queue_depth {qdepth}"]
    from ..runtime import bufpool
    if bufpool._global is not None:
        st = bufpool._global.stats()
        lines += ["# TYPE minio_tpu_pipeline_bufpool_retained_bytes gauge",
                  "minio_tpu_pipeline_bufpool_retained_bytes "
                  f"{st['retained']}"]
    return lines


register_collector(_c_live_gauges)


def _attribution_lines() -> list[str]:
    """Standing per-op stage attribution (obs/attribution.py) as
    Prometheus families — rendered only on ``?attribution=1`` scrapes
    (the report is also served as JSON by the admin timeline
    endpoint)."""
    from . import attribution as attr
    rep = attr.report()
    if not rep:
        return []
    lines = ["# TYPE minio_tpu_stage_latency_seconds gauge",
             "# TYPE minio_tpu_stage_seconds_total counter",
             "# TYPE minio_tpu_stage_share_of_wall gauge",
             "# TYPE minio_tpu_stage_op_wall_seconds_total counter",
             "# TYPE minio_tpu_stage_op_total counter"]
    for op, ent in sorted(rep.items()):
        lab_op = _esc(op)
        lines.append(
            f'minio_tpu_stage_op_wall_seconds_total{{op="{lab_op}"}} '
            f'{ent["wall_seconds_total"]}')
        lines.append(
            f'minio_tpu_stage_op_total{{op="{lab_op}"}} {ent["count"]}')
        # whole-op wall percentiles ride the same family as a "wall"
        # stage row (the share denominators' latency twin)
        lines += [
            f'minio_tpu_stage_latency_seconds{{op="{lab_op}",'
            f'stage="wall",quantile="0.5"}} {ent["wall_p50_s"]}',
            f'minio_tpu_stage_latency_seconds{{op="{lab_op}",'
            f'stage="wall",quantile="0.99"}} {ent["wall_p99_s"]}',
        ]
        for stage, st in sorted(ent["stages"].items()):
            lab = f'op="{lab_op}",stage="{_esc(stage)}"'
            lines += [
                f'minio_tpu_stage_latency_seconds{{{lab},'
                f'quantile="0.5"}} {st["p50_s"]}',
                f'minio_tpu_stage_latency_seconds{{{lab},'
                f'quantile="0.99"}} {st["p99_s"]}',
                f'minio_tpu_stage_seconds_total{{{lab}}} '
                f'{st["seconds_total"]}',
                f'minio_tpu_stage_share_of_wall{{{lab}}} '
                f'{st["share_of_wall"]}',
            ]
    return lines


def _store_lines() -> list[str]:
    """The counter/histogram store: request totals, TTFB, heal, RPC."""
    lines = []
    with _lock:
        for key, v in sorted(_counters.items()):
            lines.append(f"{key} {v:g}")
        for key, vals in sorted(_histograms.items()):
            base, _, labels = key.partition("{")
            labels = ("," + labels[:-1]) if labels else ""
            n = len(vals)
            total = sum(vals)
            for b in BUCKETS:
                c = sum(1 for x in vals if x <= b)
                lines.append(f'{base}_bucket{{le="{b}"{labels}}} {c}')
            lines.append(f'{base}_bucket{{le="+Inf"{labels}}} {n}')
            lines.append(f"{base}_count{{{labels[1:]}}} {n}"
                         if labels else f"{base}_count {n}")
            lines.append(f"{base}_sum{{{labels[1:]}}} {total:.6f}"
                         if labels else f"{base}_sum {total:.6f}")
    return lines


def _sample_name(line: str) -> str:
    """Metric name of one sample line (text up to '{' or the value)."""
    cut = len(line)
    for sep in ("{", " "):
        i = line.find(sep)
        if i != -1:
            cut = min(cut, i)
    return line[:cut]


def _family_of(name: str, hist_families: set[str]) -> str:
    for suf in ("_bucket", "_count", "_sum"):
        if name.endswith(suf) and name[:-len(suf)] in hist_families:
            return name[:-len(suf)]
    return name


def _annotate(lines: list[str]) -> list[str]:
    """Exposition-format hygiene pass: every family gets exactly one
    ``# HELP`` and one ``# TYPE`` line ahead of its first sample, with
    the type inferred (histogram when ``X_bucket`` samples exist,
    counter for ``*_total``, gauge otherwise) when a generator didn't
    declare one. Generators therefore CANNOT ship malformed families —
    the naming lint of the tests locks this in."""
    hist_families = {
        _sample_name(ln)[:-len("_bucket")] for ln in lines
        if not ln.startswith("#") and _sample_name(ln).endswith("_bucket")}
    out: list[str] = []
    declared: set[str] = set()
    pending_help: dict[str, str] = {}

    def declare(fam: str, typ: str | None = None):
        if fam in declared:
            return
        declared.add(fam)
        if typ is None:
            typ = "histogram" if fam in hist_families else \
                ("counter" if fam.endswith("_total") else "gauge")
        help_text = pending_help.pop(fam, "") or \
            fam.removeprefix("minio_tpu_").replace("_", " ")
        out.append(f"# HELP {fam} {help_text}")
        out.append(f"# TYPE {fam} {typ}")

    for ln in lines:
        if ln.startswith("# HELP "):
            parts = ln.split(maxsplit=3)
            if len(parts) >= 3 and parts[2] not in declared:
                # stash author help; declaration waits for the TYPE
                # line (or first sample) so an explicit type wins
                pending_help[parts[2]] = \
                    parts[3] if len(parts) > 3 else ""
            continue
        if ln.startswith("# TYPE "):
            parts = ln.split()
            if len(parts) >= 3:
                declare(parts[2], parts[3] if len(parts) > 3 else None)
                continue
            out.append(ln)
            continue
        if ln.startswith("#") or not ln.strip():
            out.append(ln)
            continue
        declare(_family_of(_sample_name(ln), hist_families))
        out.append(ln)
    return out


#: exemplar suffix as _hist_lines appends it: ' # {labels} value' at
#: end of a sample line — anchored so no legal label value can match
_EXEMPLAR_RE = re.compile(r" # \{[^}]*\} [0-9.eE+-]+$")


def render_prometheus(server, scope: str = "", attribution: bool = False,
                      openmetrics: bool = False) -> bytes:
    """Text exposition. scope "" or "cluster" renders every group;
    "node" renders only node-scoped groups (reference mounts
    /minio/v2/metrics/cluster and /minio/v2/metrics/node). Scrape-time
    collectors render after the groups, UNCACHED. ``attribution=True``
    (the ``?attribution=1`` query) appends the standing per-op stage
    breakdown families. ``openmetrics=True`` (Accept-negotiated by the
    handler) keeps the histogram exemplar suffixes and terminates with
    ``# EOF``; the classic text format has NO exemplar syntax — a
    trailing ``#`` would read as an invalid timestamp and fail the
    ENTIRE scrape — so they are stripped otherwise."""
    lines: list[str] = []
    for g in _GROUPS:
        if scope == "node" and g.scope != "node":
            continue
        lines.extend(g.lines(server))
    for fn in list(_COLLECTORS):
        try:
            lines.extend(fn(server))
        except Exception:  # noqa: BLE001 — one collector must never
            pass  # take down the whole exposition (same rule as groups)
    if attribution:
        lines.extend(_attribution_lines())
    lines.extend(_store_lines())
    out = _annotate(lines)
    if openmetrics:
        out.append("# EOF")
    else:
        out = [_EXEMPLAR_RE.sub("", ln) if " # {" in ln else ln
               for ln in out]
    return ("\n".join(out) + "\n").encode()
