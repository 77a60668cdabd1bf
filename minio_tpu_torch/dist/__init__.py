"""The pure helpers of the distributed plane, ported from minio_tpu.dist:
ellipses expansion of disk arguments and the erasure set layout choice.
Peer RPC, dsync and the storage REST service wait for the multi-GPU and
distributed slice."""
