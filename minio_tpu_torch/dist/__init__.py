"""The pure helpers of the distributed plane, ported from minio_tpu.dist:
ellipses expansion of disk arguments, the erasure set layout choice and
the format.json helpers. Peer RPC, dsync and the storage REST service wait
for the multi-GPU and distributed slice."""
