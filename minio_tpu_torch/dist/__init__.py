"""The distributed plane, ported from minio_tpu.dist: ellipses expansion of
disk arguments, the erasure set layout choice and the format.json helpers;
endpoints, the REST-RPC transport (``rpc``) and its storage, lock and peer
services; dsync's quorum locks; ``Node`` (one server process of a
deployment) and ``harness.LocalCluster`` (N nodes in one process); and
bucket-DNS federation over etcd (``etcd``, ``federation``)."""
