"""Observability, the port of minio_tpu/obs/ as far as the data path
needs it (reference §2.7 — cmd/metrics-v2.go, cmd/http-tracer.go):

- ``pubsub``      bounded per-subscriber queues with drop counting
- ``latency``     the sliding last-minute log-bucket ``Window`` behind every
  percentile
- ``stages`` / ``attribution``  per-request stage collectors and the
  standing per-op (put/get/heal) stage report
- ``timeline``    the dispatch flight recorder (events, per-lane busy
  ratio, queue depth, Chrome export)
- ``device``      the device plane: live-buffer ledger, builds and first
  launches, CUDA-event device time, the card's busy share, roofline,
  memory, torch.profiler sessions
- ``trace`` / ``spans``  the flat trace stream and request span trees with
  tail sampling
- ``metrics``     the Prometheus exposition

Left for later slices: the profiler, lock ranks, SLO and health planes,
per-bucket statistics and the logger.
"""
