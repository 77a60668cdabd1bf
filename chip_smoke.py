#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (minio_tpu_torch) on one card.

    python3 chip_smoke.py                  # the full run, needs a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny host-only dry run of the
                                           # same phases (never prints ok)

Phases, each printing one JSON line:

1. build — compiles minio_tpu_torch/csrc/*.cu with nvcc (one process per
   library, all at once) into build/minio_tpu_torch/, cached by content
   hash: one library per source, and K2 (csrc/gf_encode.cu) once per
   encode matrix, here the 16+4, 8+4, 18+2, 8+8 and 12+4 codecs'
   (``build_keys``).
2. card — the card's name and power limit from nvidia-smi.
3. native — builds the port's host library (libnative.so, g++ on this
   host) into build/minio_tpu_torch/, holds its HighwayHash-256 and
   MUR3X256 digests byte for byte to the numpy references at chunk lengths
   with and without a remainder, and measures the host hash rate over
   16 KiB chunks at 1, 8 and 32 threads.
4. kernels — each hand-written kernel (K1-K6) at the shapes the paths give
   it, batched and single-block, held bit-exact against its plain PyTorch
   version on the card, timed as one CUDA-event pair around a run of
   launches on cold inputs (``time_ms``), with the plain version's time,
   the computed bound, a device-to-device copy of the same bytes as the
   measured memory floor (``copy_ms``) and, for K1 and K4, an empty kernel
   of the same library at the launch's grid and block (``floor_ms``). K1
   runs at B = 128 (o = 2 and o = 20) and at the batches the paths launch,
   B = 1, 2, 4 and 8 by o = 1 and 2; K4 at I = 128 and at I = 1, 4, 16
   and 64 (16 packages of 64 KiB); each row with its launch plan
   (rs_cuda.matmul_plan, chacha_cuda.launch_plan), registers and CTAs per
   SM, a four-lane K4 row also with one thread per block timed beside it
   (``earlier_design_ms``), and the SASS mix of the kernels of K1's B =
   128 and B = 1 rows and K4's I = 128 and I = 1 rows; K1 also at the
   cluster path's 8+8, o = 8 over i = 8 at B = 1 and 8. K2 runs at B = 1,
   16, 64 and 128 at 16+4, at
   B = 128 at 8+4, on an unaligned view, and at the cluster path's 8+8
   and 12+4 over whole 1 MiB blocks at B = 1 and 16, with its launch plan,
   registers and (at 16+4) its static SASS mix. K3 and K5 run at the chunk
   counts the paths launch (1, 256, 1,024 and 10,240 chunks of 16 KiB),
   each row with its launch plan, registers and shared memory per CTA. K6
   (the S3 Select scan) runs at the select path's flush (128 lineitem
   blocks of 1 MiB), at Query A's flush of 16, at one block, on a small
   block of parse edge cases under a program with every op kind over 8
   columns, and on the edge blocks of ``edge_blocks`` (a row longer than a
   tile and its halo, no newline, wide rows), each with its tile plan,
   registers and shared memory per CTA; the flush's device memory beyond
   its inputs is reported and held to the codes plus 64 KiB.
5. main path (MUR3X256S) — a 16+4 erasure set over 20 disk directories,
   1 MiB blocks, MUR3X256S bitrot with 16 KiB chunks: 64 objects of 4 MiB
   PUT from 64 threads through erasure_encode, GET back, two data shards
   of every object removed and a degraded GET of all, one flipped byte
   detected with the GET still exact, and erasure_heal of all 64 objects
   with the healed files byte-identical to the originals. One object's
   first block is also checked against the host reference math.
6. SSE path (HighwayHash256S, the default bitrot algorithm) — 32 SSE-C
   ChaCha20-Poly1305 objects of 4 MiB (every second one 333 bytes short,
   so it ends in a short package), each under its own customer key made
   from --seed, at 16+4 / 1 MiB / 16 KiB chunks: PUT through
   EncryptReader into erasure_encode, whole GET and a ranged GET across a
   package boundary through DecryptWriter, degraded GET with two data
   shards gone, and heal; every plaintext byte is compared, the healed
   files are byte-identical, and the host Poly1305 seconds are reported.
   Every keystream (full packages, short packages, the key envelope) is
   K4's.
7. select path — TPC-H lineitem at scale factor 0.5 (3,000,608 rows in
   dbgen's '|' text, made in numpy from --seed) split on row boundaries
   into 64 objects, stored at 16+4 / 1 MiB / HighwayHash256S with 16 KiB
   chunks, every ninth one SSE-C, every fourth with two data shards
   removed; then Query A from 64 threads, one SelectObjectContent each
   (select_object_content: erasure decode, decrypt, run_select, the scan
   on K6), and the residual-heavy Query B on one object. Every response's
   records are held byte for byte to rows built in numpy from the
   generated columns, and its Stats to the object's sizes.
8. object layer path — the users' calls over the same data path:
   ServerPools over one pool of two 16+4 erasure sets (40 disk
   directories, ErasureSets placing each name by SipHash under a
   deployment id made from --seed), 1 MiB blocks, HighwayHash256S with
   16 KiB chunks. PUT of 64 objects of 4 MiB from 64 threads (each fused
   ETag equal to pipeline_etag_reference of the body, every xl.meta
   naming its set's geometry), 64 objects of 100 KiB (MD5 ETags) and one
   multipart object of 8 MiB + 8 MiB + 5 MiB and 333 bytes (the -3 ETag of
   etag_from_parts); list_objects of all 129 in order with sizes and
   ETags; GET of all, byte-exact, and ranged GETs across a block and a
   part boundary; two drives of each set replaced by empty ones (their
   files kept aside) and heal_bucket; degraded GET of the 64 big objects,
   counting those that needed a rebuild; heal_object of all 129 from 128
   threads, per-object p50/p99, every healed xl.meta and part.* equal to
   the kept files; one flipped byte in a data shard: the GET stays exact,
   on_partial reports a deep scan, and a deep heal restores the shard.
   K1, K2 and K5 must launch. Cut: one process over local directories
   (the cluster path, step 15, runs 32 drives over the storage RPC).
9. S3 server path — the port's S3Server (server/s3api.py) on 127.0.0.1
   over the object layer path's deployment (one pool of two 16+4 sets, 40
   disk directories, 1 MiB blocks, HighwayHash256S), driven through
   http.client by 32 client threads signing with the port's
   server/auth.py. PUT of 32 objects of 4 MiB (64 until the cluster path
   came; every eighth as a STREAMING-AWS4-HMAC-SHA256-PAYLOAD body in 64
   KiB chunks; each fused ETag equal to pipeline_etag_reference), the same
   32 bodies PUT and GET
   through ServerPools in-process (the HTTP cost: wall over HTTP against
   in-process), a 3-part multipart upload (the -3 ETag of
   etag_from_parts), a CopyObject, 32 SSE-C objects of 4 MiB each under
   its own key and 8 lineitem CSV objects (the select path's first cuts).
   GET of every object, byte-exact with its ETag; ranged GETs across a
   block, a part and an SSE package; HEAD of each; a presigned GET;
   ListObjectsV2 in pages of 25; SelectObjectContent (Query A) on the CSV
   objects, the records held to the rows built from the generated
   columns. Then two drives of each set replaced by empty ones and
   heal_bucket; a degraded GET of every object, each of which must reach
   the MRF through on_partial; the MRF drained, its per-object heal wall
   p50/p99 reported, every file on the new drives equal to the kept ones;
   one flipped byte in a data shard: the GET stays exact, on_partial is
   deep and the MRF restores the byte. Teardown by DeleteObjects. K1, K2,
   K4, K5 and K6 must launch. Each step reports the clients' request
   p50/p99.
9b. SSE-KMS path (after the S3 server path) — SSE-S3 and SSE-KMS over
   the same deployment and clients, the process KMS a LocalKMS under a
   master key made from --seed (MINIO_TPU_KMS_MASTER_KEY). First the host
   AES-256-GCM engine (native/aesgcm.cpp in libnative.so): its seal of a
   fixed key, nonce, AAD and 64 KiB + 5 bytes held to a SHA-256 computed
   with the ``cryptography`` wheel (AES_KAT_SHA256), and its seal and open
   GiB/s over 16-package calls of 64 KiB packages from 1 and 8 threads.
   Then three groups of 32 objects of 4 MiB (every second 333 bytes
   short): SSE-S3 and SSE-KMS (a named key, a JSON context) under the
   default ChaCha20 lane, and SSE-S3 with MINIO_TPU_SSE_CIPHER=aes-gcm:
   PUT and GET of each group (wall and plaintext GiB/s per cipher, the
   response's SSE headers, the cipher in each object's metadata), ranged
   GETs across a block and a package boundary, HEAD of each; two drives
   per set replaced and a degraded GET of half of each group; a GET of
   each group under a second master key (403 AccessDenied); a KES
   endpoint on a closed loopback port (503 ServiceUnavailable on GET and
   PUT); the admin kms/status, kms/key/create, kms/key/status,
   set-bucket-quota, get-bucket-quota and durability ops (200). K1, K2,
   K4 and K5 must launch.
10. obs path — the observability plane over the S3 server path's
   deployment (two 16+4 sets, 1 MiB blocks), 32 signing clients: PUT and
   GET of 32 objects of 4 MiB (64 until the cluster path came), two
   drives per set replaced, a degraded GET of all feeding the MRF,
   drained, with the stage attribution of PUT, GET and heal (per-stage p50/p99
   and share of wall); the node
   scrape with ?attribution=1 under the naming lint of
   tests/test_obs_naming.py, the kernel, lane, dispatch, device_obs and
   qos families present; one stored trace tree by its trace id, holding a
   kernel span linked to the request; the timeline's per-lane
   utilisation and queue-depth p99; the device plane (ledger balanced
   after the drain, builds and launches per (op, shape), GiB/s and
   roofline ratio per op, each at most 1.05, the allocator's peak); a 3 s
   torch.profiler session over a GET load through the admin API, the
   card's own busy time beside the flushes' CUDA-event intervals; an
   admission burst of 32 concurrent 4 MiB PUTs (Expect: 100-continue,
   honouring Retry-After) against a second S3Server on the same layer
   with max_requests=4 and MINIO_TPU_QOS_MAX_WAIT_MS=20, every object
   stored exact; and the object layer's PUT and GET of the 32 with every
   plane off and on (MINIO_TPU_TIMELINE, MINIO_TPU_DEVICE_OBS,
   MINIO_TPU_TRACE_SPANS, MINIO_TPU_PROFILER): a discarded warm-up turn,
   then one block of off, on, on, off, with its on/off ratio and each
   setting's spread. The config, profiler, lock and SLO planes: first
   the config registry over admin (set-config-kv of the interactive
   budget and profiler.hz, read back with source "stored", the history
   listed and its oldest snapshot restored, the defaults back); each
   load's window of the always-on
   profiler (``profile_window``: role, subsystem, class and op shares,
   observed over nominal pass rate, the sampler's cost, the dispatcher
   threads' top leaf frames); after the burst, the port's lockrank
   installed, a second server over the same drives and one PUT and GET
   load of the 32 through it, with the contended lock sites, the
   lock-wait share and any cycle or held-across-flush report; last, the
   admin slo, health, healthinfo and profile bodies. K1, K2 and K5 must
   launch.
11. background path — the background heal plane over the S3 server
   (S3Server over one pool of two 16+4 sets, 40 disk directories, 1 MiB
   blocks, HighwayHash256S, start_background_services(): the MRF, the data
   scanner, the auto-heal monitor): 64 objects of 4 MiB (128 until the
   cluster path came) under two levels of prefixes in 4 buckets and 64 of 100
   KiB, from --seed. A normal
   scanner cycle whose usage snapshot, per-prefix trees and size classes
   equal the script's own count, as GET /minio/admin/v3/datausageinfo
   serves them, and the scrape's heal-plane families; 8 PUTs to one
   bucket, after which the next cycle walks that bucket only (the change
   tracker); a flipped byte in 16 shard files, which the deep cycle queues
   to the MRF and the MRF heals (verify_file then passes); two drives of
   each set wiped, their healing trackers set and the monitor kicked: its
   global heal of all 136 objects from 128 workers, the per-object heal
   wall p50/p99, every shard on the replaced drives verified and the
   trackers cleared; one drive's root renamed away until its health
   tracker trips, 16 PUTs to its set, the root renamed back: the probe
   re-onlines it, on_disk_state sets its tracker and the monitor heals the
   16 onto it (the time from re-online to healed); an admin heal sequence
   of one bucket over signed HTTP, polled by its token, and
   bg-heal-status; a restart (a second server over the same directories
   after a crash's staging is left on every disk: startup recovery's
   counts, the first server's usage and tracker loaded); and the in-process
   PUT and GET of 64 x 4 MiB with MINIO_TPU_HEALTH off and on (each turn
   on a set built under its setting; a discarded warm-up turn, one ABBA
   block, its on/off ratio and each setting's spread). K1, K2 and
   K5 must launch.
12. host path — the host pieces of the object path over the S3 server
   (S3Server over one pool of two 16+4 sets, 40 disk directories, 1 MiB
   blocks, HighwayHash256S, 32 signing clients; the MRF running). (a)
   With MINIO_TPU_COMPRESSION=on, 32 objects of TPC-H lineitem text (the
   select path's table, each cut at the first row boundary at or past 4
   MiB) PUT as .csv: each stored as an S2 stream, its ETag the plaintext's
   MD5 from the shared MD5 lanes (rounds and streams per round printed);
   GET of each, 64 ranged GETs, HEAD and ListObjectsV2 giving the
   plaintext sizes, a CopyObject keeping the markers, and Query A over the
   compressed objects held to the rows built from the generated columns
   (BytesScanned the stored size); the stored-over-plain ratio, the PUT
   and GET walls and plaintext GiB/s. (b) A 300 ms delay rule on the
   shard reads of one drive of each set; GET of the 32 from 32 clients
   with hedging on (the default adaptive threshold, each turn from an
   empty shard-read window) and off, one ABBA block (on, off, off, on):
   GET p50/p99 per turn, the threshold at each turn's start and end,
   hedges fired, won and lost, K1 launches (a hedged block's data shard
   is rebuilt by the fused launch), and the MRF's on_partial calls, which
   must be 0. (c) The fault plane: a kernel error rule fails exactly one
   flush (its PUTs answer 5xx on the card; a CPU queue salvages it), the
   PUTs again and their GETs exact; a kernel delay rule on 8 flushes, the
   GETs exact; typed errors on one drive, PUT and GET within quorum; a
   bitrot rule on one shard read, caught by the verify, the GET exact, the
   object healed deep by the MRF; a crash rule at pre_meta_write during an
   in-process PUT, then a new layer over the same directories (startup
   recovery) and a janitor sweep: the object absent or whole. K1, K2, K5
   and K6 must launch.
13. iam path — a multi-tenant deployment on one S3Server with IAM
   (``enable_iam()``) over one 16+4 set, 20 disk directories, 1 MiB
   blocks, HighwayHash256S, entry points without a device argument (the
   card). Over the admin API through ``minio_tpu_torch.madmin``: 40 canned
   policies, 200 users in 20 groups with group policies and 16 service
   accounts, each mutation rewriting ``.minio.sys/config/iam/state.json``
   on every drive (the mutation walls' p50/p99 and the document's size).
   40 buckets, created by root in order, so the first 32 (the bucket
   analytics' ``top_n``) are tracked and the rest fold into
   ``_overflow_``. 16 tenants from 32 client threads: 8 users, 4 service
   accounts, 2 AssumeRole sessions under a session policy that narrows a
   readwrite parent to the tenant's bucket and 2 AssumeRoleWithWebIdentity
   sessions from an HS256 OpenID provider (MINIO_TPU_OPENID_HMAC_SECRET),
   each PUTting 2 objects of 4 MiB (4 until the cluster path came) into
   its bucket, GETting them back exact and again with two drives' copies taken
   away (K1), with walls,
   GiB/s and p50/p99 per principal kind. Each tenant's PUT and GET in
   another tenant's bucket answer 403 AccessDenied, the refused PUTs
   launching no K2; an expired STS credential is refused; a public-read
   bucket policy serves an anonymous GET. One ABBA block of 16 PUTs of 4
   MiB by root and by an IAM user, and the policy gate alone in process.
   The admin bucketstats report equals the clients' own count of requests,
   body bytes taken in and bytes sent back per tracked bucket and for the
   ``_overflow_`` row; a scanner cycle's reconcile finds exactly the
   overwritten ABBA bytes as drift (the live deltas count an overwrite as
   a new object) and a second cycle finds none. A loopback receiver as the
   audit webhook gets one entry per request issued (S3 and admin), each
   ``request_id`` a trace id, none dropped. K1, K2 and K5 must launch.
14. bucket feature path — two S3Servers, each over one 16+4 set of 20
   disk directories (1 MiB blocks, HighwayHash256S), the source with a
   ReplicationPool (8 workers, S3Target to the second server), an FS tier
   (a directory, added over the admin API) and a webhook event target on
   a loopback receiver, every bucket's notification configuration naming
   it for s3:ObjectCreated:*, s3:ObjectRemoved:* and s3:ObjectAccessed:*.
   (a) 64 x 4 MiB PUT from 32 clients and replicated: lag (the notify
   hook's charge to the replica's PUT answered) p50/p99, replicated GiB/s,
   every replica's bytes and ETag equal to the source's; 16 more PUT
   before the bucket has a target, two drives' copies of it taken away,
   then the target attached and the bucket resynced, so every worker read
   rebuilds (K1); a DELETE replicated to the target. (b) 16 x 4 MiB
   replicated through a target throttled at 64 MiB/s, and 4 x 4 MiB
   through one at 8 MiB/s (below the pipeline's own rate, so it binds):
   the bytes the throttle let through at every read within its windows'
   grants (``bucket.bandwidth.Throttle``: one window's bytes per 250 ms
   window begun), the measured rate against the limit. (c) A one-day Transition
   rule on 32 x 4 MiB and one scanner cycle whose lifecycle pass sees
   every object two days older: all 32 become stubs and the tier holds
   their bytes (the transition's wall per object); GETs of the 32 through
   the tier against GETs of 32 local objects in one ABBA block (p50/p99
   per turn), the webhook's listener down through the second turn; 8
   restored by POST ?restore (K2, K5) and read back; an Expiration rule
   (a date in the past) over half of them and a second cycle: 16 expired,
   their tier copies gone. (d) A lock-enabled bucket with a COMPLIANCE
   default: 16 x 4 MiB PUT, every version DELETE (with and without the
   bypass header) 403; a GOVERNANCE object refused without the bypass,
   refused with it under a legal hold, deleted with it once the hold is
   off. (e) The webhook got every event the clients' successful requests
   owe, none lost and none extra, the events queued during the outage
   delivered after it: sent, queued, redelivered, lost, delivery latency
   p50/p99 (event time to arrival). Each step reports its wall, the
   streams' occupancy, the lanes' busy ratio and its K1, K2 and K5
   launches by size. K1, K2 and K5 must launch.
15. cluster path — a distributed deployment on the one card: 4 processes
   of ``python -m minio_tpu_torch.server`` given the full endpoint list
   (``http://127.0.0.1:<port>/.../n<i>/d<j>``, host-major), each serving
   8 drive directories: 32 drives in two sets of 16 (set 0 on nodes 0-1,
   set 1 on nodes 2-3) at the sets' default parity, 8+8, 1 MiB blocks,
   HighwayHash256S with 16 KiB chunks, the storage, lock and peer RPC
   between the processes over loopback. (a) 128 objects of 4 MiB PUT
   from 32 client threads spread over the four listeners, signed by the
   port's server/auth.py, with the dsync lock acquisitions' p50/p99 under
   that load; (b) every object GET through a node other than its writer,
   bytes and ETags exact; (c) node 1 SIGKILLed: a degraded GET of all 128
   through nodes 0, 2 and 3 (K1 on set 0's), the time until each peer
   marks node 1 offline (the wall time its first RPC client toward node 1
   went offline, from its stats), and PUTs to both sets held to the
   write-quorum rule (data + 1 when parity equals data: set 0, 8 of 16
   drives left, refuses; set 1 stores); (d) node 1 restarted over the same
   drives and port: the time to ``/minio/health/cluster`` ready and to
   every peer's reconnect (each of its clients that went offline back
   online, from its stats), the outage's objects read through it; (e) one
   drive on node 0 and one on node 2 replaced, as
   tests/test_cluster_heal_oop.py does: both nodes SIGKILLed, the drives
   copied aside and wiped, the nodes restarted over them (a start formats
   an empty drive into its slot), and an admin heal of the bucket through
   node 0 (one object at a time, as the JAX package's heal sequence
   does); every healed file equals the kept one; the heal wall and GiB/s,
   the p50/p99 over every shard heal the nodes recorded in this step, and
   a last GET of all. Each
   process's counters come from its ``--stats-file`` (SIGUSR1): K1, K2
   and K5 launches by batch size and K1's by o summed over the processes
   (the killed node's up to its kill), the storage, lock and peer RPC
   calls and p50/p99 per method, and each process's stream occupancy and
   device memory. K1, K2 and K5 must launch. The rehearsal runs the same
   steps at 4 nodes x 2 drives on the CPU.

Each sub-phase of a path reports, beside its wall and GiB/s, the streams'
occupancy (``stream_occupancy``: the union of the flushes' CUDA-event
intervals over the wall, and each lane's share; the streams' waits for
the host are in it, so it is not the card's busy share, which only the
obs path's profiler window measures), the flight recorder's per-lane
busy ratio, busy share and batch fill (``timeline``: a lane is busy from
a flush's start to its readback landing), the dispatch queue's flushes
and items by op and by lane, the completers' seconds, the interactive
lane's async completions, the requests' waits on the queue by op, and the
seconds inside the host hashes by engine (``native``; ``numpy`` must read
0 calls). A failed flush (a launch or readback that raised: its waiters
get the error on the card; a CPU queue salvages it on the host) fails the
run, as do a call of the numpy hashes on a path, a library built inside a
timed sub-phase, an occupancy share outside [0, 1] and an instrument
(dispatch or storage) that raised.

Kernel launch counts are reset just before each path (each SSE sub-phase)
and read just after; every kernel a path should run must have launched.
Launches are also counted by size (``launch_sizes``, printed per path):
K3's and K5's by chunk count, K1's and K2's by batch size B and K4's by
item count I (powers of two), K1's also by output rows o
(``gf_matmul_batched_by_o``), K4's also by package count P
(``chacha20_xor_by_p``), K6's by batch size.
Then the {"kernels": [...]} summary line and, last, the ok line. Any
failure exits non-zero without the ok line; so does a host without CUDA.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM rates of the bounds. HBM3 bytes/s. Integer instructions the
#: SMs can issue: 128 lanes/clk/SM * 132 SMs * 1.98 GHz (the float32 peak
#: of 67 TFLOP/s, which counts a fused multiply-add as two). The integer
#: ALU pipe alone runs half of that: bitwise logic (XOR, AND, OR: LOP3) has
#: no other pipe, while adds, shifts, rotates and multiplies can also issue
#: on the FMA pipe (IMAD forms), so only logic is held to the ALU's rate.
HBM_BYTES_S = 3.35e12
ISSUE_OPS_S = 128 * 132 * 1.98e9
LOGIC_OPS_S = 64 * 132 * 1.98e9

K, M = 16, 4
#: K2's libraries built in the build phase: the paths' 16+4, the 8+4 row,
#: the object layer's REDUCED_REDUNDANCY codec of a 20-drive set (18+2),
#: which ErasureObjects prepares at start-up, and the cluster path's two
#: (a 16-drive set at its default parity, 8+8, and REDUCED_REDUNDANCY's
#: 12+4), so no node process runs nvcc at its start
ENCODE_GEOMETRIES = ((K, M), (8, 4), (K + M - 2, 2), (8, 8), (12, 4))
BLOCK = 1 << 20
CHUNK = 16384
N_OBJECTS = 128
#: the SSE path's objects: cut from 128 when the background path came, to
#: keep the script near 750 s, and from 64 when the iam path came
SSE_OBJECTS = 32
#: the MUR3X256S path's objects: cut from 128 so that the whole script,
#: the select path included, stays near four minutes
MUR3_OBJECTS = 64
OBJECT_BYTES = 4 << 20
#: every second SSE object is this many bytes short of whole packages
TAIL_SHORT = 333
#: CUDA-event timings per kernel: the mean of a run of this many launches
REPS = 50
#: K1's and K4's rows at the batches the paths launch (PERF.md §6: K1
#: never above B = 8, K4 at I = 1 for most of its launches): K1 at B x o
#: of SMALL_B x SMALL_O, K4 at I of SMALL_I (16 packages of 64 KiB)
SMALL_B = (1, 2, 4, 8)
SMALL_O = (1, 2)
SMALL_I = (1, 4, 16, 64)
#: the plain versions' timings: the mean of a run of this many calls
PLAIN_REPS = 3
#: a timed kernel's inputs are rotated over copies of at least this many
#: bytes (twice the H100's 50 MB L2), so each launch reads them cold
COLD_BYTES = 100 * 10**6
#: the spin kernel that holds the stream while the host enqueues a timed
#: run counts GPU clock cycles: about this many per second
SPIN_CYCLES_S = 2.0e9
#: the select path: the lineitem table's scale factor (cut from 1 to keep
#: the script near four minutes; Query A's wall grows with the table), its
#: objects, its two queries, and the objects that are SSE-C (every ninth)
#: or lose two data shards (every fourth)
SELECT_SCALE = 0.5
SELECT_OBJECTS = 64
QUERY_A = ("SELECT s._1, s._2, s._5 FROM s3object s "
           "WHERE s._2 < 2000 AND s._5 <= 24")
QUERY_B = "SELECT s._1 FROM s3object s WHERE s._6 < 1000.5"
SSE_EVERY = 9
DEGRADED_EVERY = 4
#: the object layer path: one pool of OL_SETS 16+4 sets; OL_BIG objects of
#: 4 MiB PUT and GET from 64 threads (N_OBJECTS, 128, until the iam path
#: came), OL_SMALL of 100 KiB, one multipart object of OL_PARTS; two drives
#: of each set (OL_LOST) replaced by empty ones; every object healed from
#: 128 threads
OL_SETS = 2
OL_BIG = 64
OL_SMALL = 64
OL_SMALL_BYTES = 100 << 10
OL_PARTS = (8 << 20, 8 << 20, (5 << 20) + 333)
OL_LOST = (0, 1)
OL_PUT_THREADS = 64
OL_HEAL_THREADS = 128
#: the S3 server path: signed requests from S3_THREADS client threads;
#: S3_BIG plain objects of OBJECT_BYTES (every S3_CHUNKED_EVERY-th as an
#: aws-chunked stream of S3_STREAM_CHUNK chunks), S3_SSE SSE-C objects
#: each under its own key, S3_CSV lineitem objects (the select path's first
#: cuts) and one multipart object of S3_PARTS; ListObjectsV2 pages of
#: S3_LIST_PAGE keys. S3_BIG (also the obs path's objects) was 64 until
#: the cluster path came, to keep the script well inside its time limit
S3_THREADS = 32
S3_BIG = 32
#: the depth cuts made to keep the whole script well inside its 1200 s
#: limit as paths were added, each listed in its path's ``cut`` field
CUT_S3_BIG = (f"{S3_BIG} plain objects, not 64: cut when the cluster path "
              "came")
S3_CHUNKED_EVERY = 8
S3_STREAM_CHUNK = 64 << 10
S3_SSE = 32
S3_CSV = 8
S3_PARTS = (5 << 20, 5 << 20, (1 << 20) + 333)
S3_LIST_PAGE = 25
S3_REGION = "us-east-1"
S3_ACCESS_KEY = "smoke-admin"
S3_SECRET_KEY = "smoke-admin-secret-key"
PIPE, COMMA = 124, 44
#: K6's flush scratch beyond its codes at most (the tiles' status words)
SCAN_SCRATCH_MAX = 64 << 10
#: K6's edge-case block: the parse corners of tests/test_scan_pallas.py
#: (cells that parse, and cells that must not) and a program with every op
#: kind over 8 columns (slots 0-7 = CSV columns 1-8)
EDGE_INTS = (b"34", b" 41 ", b"-7", b"+19", b"007", b"999999999", b"0",
             b"-0", b"-999999999", b"7", b"19", b"3", b"40", b"\t5 ")
EDGE_BAD = (b"2.5", b"", b"12_000", b"1234567890", b"1 2",
            b"                9", b"5-3", b"123\x00", b"\x0045", b"+-4",
            b"- 4", b"x")
EDGE_PROGRAM = (
    ("num", 0, "lt", 10), ("num", 1, "le", 3), ("or",),
    ("num", 2, "gt", -5), ("and",), ("num", 3, "ge", 0),
    ("num", 4, "eq", 7), ("or",), ("and",), ("num", 5, "ne", 3), ("and",),
    ("between", 6, 5, 20), ("in", 7, ()), ("not",), ("and",), ("or",),
    ("in", 0, (7, 19, 34)), ("const", True), ("and",), ("or",),
    ("const", False), ("not",), ("and",))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# --- timing ---------------------------------------------------------------


def cold_copies(args: tuple, total: int = COLD_BYTES) -> list:
    """Argument tuples for a run of calls that each read their inputs from
    device memory, as the paths do: k copies of the tensors of ``args``,
    ``total`` bytes in all, k = 1 when the inputs alone are that large."""
    import torch
    size = sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))
    k = max(1, -(-total // max(size, 1)))
    if k == 1:
        return [args]
    stacks = [a.unsqueeze(0).expand(k, *a.shape).clone()
              if isinstance(a, torch.Tensor) else None for a in args]
    return [tuple(a if st is None else st[i] for a, st in zip(args, stacks))
            for i in range(k)]


def time_ms(fn, args: tuple, reps: int, device, cold: bool = True,
            spin: bool | None = None) -> float:
    """Milliseconds per call of ``fn(*args)``: on the card, one CUDA-event
    pair around a run of ``reps`` calls after a warm-up call, divided by
    ``reps``; with ``cold``, the calls rotate over copies of the inputs
    (``cold_copies``, past the 50 MB L2, read out of it before the run);
    with ``spin`` (default: ``cold``), a spin kernel holds the stream while
    the host enqueues the run, so that the host's wrapper time does not
    enter the window. On the CPU (rehearsal only) the host clock."""
    import torch
    spin = cold if spin is None else spin
    sets = cold_copies(args) if cold and device.type == "cuda" else [args]
    fn(*sets[-1])
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if spin:
        t0 = time.perf_counter()
        for i in range(3):
            fn(*sets[-1 - i % len(sets)])
        host_s = (time.perf_counter() - t0) / 3
        torch.cuda.synchronize()
        if cold:
            flush = torch.empty(COLD_BYTES // 4, dtype=torch.int32,
                                device=device)
            flush.sum()
            del flush
        torch.cuda._sleep(int(min(2 * host_s * reps + 1e-3, 1.0) *
                              SPIN_CYCLES_S))
    a.record()
    for i in range(reps):
        fn(*sets[i % len(sets)])
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def copy_floor_ms(nbytes: int, reps: int, device) -> float:
    """A device-to-device copy that reads and writes ``nbytes`` in all,
    under the kernels' timer."""
    import torch
    n = max(1, nbytes // 8)
    src = torch.empty(n, dtype=torch.int32, device=device)
    return time_ms(lambda s, d: d.copy_(s), (src, torch.empty_like(src)),
                   reps, device)


def max_abs_err(a, b) -> int:
    from minio_tpu_torch.ops.rs_torch import to_u32_i64
    if a.shape != b.shape or a.dtype != b.dtype:
        raise PhaseError(f"{a.dtype} {tuple(a.shape)} != "
                         f"{b.dtype} {tuple(b.shape)}")
    return int((to_u32_i64(a) - to_u32_i64(b)).abs().max().item())


def fixed_matrix_ops(mat) -> tuple[int, int]:
    """(integer operations, of them bitwise logic) per word column for a
    product by a matrix known before launch (K2): only the set coefficient
    bits cost work. Per output row and bit plane, the set bits' words fold
    into the accumulator two at a time (one 3-input LOP3 per pair), and the
    7 Horner doublings take 5 ops each, 3 of them logic."""
    import numpy as np
    bits = np.unpackbits(np.asarray(mat, dtype=np.uint8)[..., None], axis=-1)
    per_plane = bits.sum(axis=1)  # [o, 8]: set bits per row and plane
    folds = int(((per_plane + 1) // 2).sum())
    return folds + 35 * len(mat), folds + 21 * len(mat)


def bound_ms(nbytes: int, ops: int, logic_ops: int) -> tuple[float, str]:
    """The least time of the work: its bytes over the memory rate, or its
    integer operations over the issue rate, or its bitwise logic over the
    ALU pipe's rate, whichever is largest."""
    tb = nbytes / HBM_BYTES_S * 1e3
    to = max(ops / ISSUE_OPS_S, logic_ops / LOGIC_OPS_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# --- TPC-H lineitem ---------------------------------------------------------

#: TPC-H v3.0.1, the LINEITEM table (1.4.1) with dbgen's value rules (4.2.3):
#: orders and rows at scale factor 1, parts and suppliers, dates, the fixed
#: SHIPINSTRUCT and SHIPMODE words. The comment words hold no quote, CR,
#: NUL, '|' or ',' (a quote, CR or NUL anywhere would send a select to the
#: classic interpreter and no row would reach the scan).
ORDERS_SF1 = 1_500_000
ROWS_SF1 = 6_001_215
PARTS_SF1 = 200_000
SUPPS_SF1 = 10_000
SHIPINSTRUCT = (b"DELIVER IN PERSON", b"COLLECT COD", b"NONE",
                b"TAKE BACK RETURN")
SHIPMODE = (b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL", b"FOB")
COMMENT_WORDS = (
    b"furiously carefully quickly slyly blithely fluffily final regular "
    b"express pending ironic bold special even unusual silent daring "
    b"deposits requests accounts packages instructions theodolites foxes "
    b"pinto beans ideas dependencies excuses platelets asymptotes courts "
    b"dolphins sleep wake are haggle nag use boost affix detect integrate "
    b"cajole above against along among around the about after").split()


def _digits(v, width: int):
    """Decimal digits of non-negative ints ``v`` left-aligned in uint8
    [N, width], with their lengths."""
    import numpy as np
    v = np.asarray(v, dtype=np.int64)
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    right = ((v[:, None] // p) % 10 + 48).astype(np.uint8)
    nd = np.ones(len(v), dtype=np.int64)
    for k in range(1, width):
        nd += v >= 10 ** k
    idx = np.minimum(np.arange(width) + (width - nd)[:, None], width - 1)
    return np.take_along_axis(right, idx, 1), nd


def _fixed(text: bytes, n: int):
    import numpy as np
    return np.broadcast_to(np.frombuffer(text, np.uint8), (n, len(text))), \
        None


def _pick(words, idx):
    """Words of a table by index: (uint8 [N, longest], lengths)."""
    import numpy as np
    w = max(len(t) for t in words)
    arr = np.array(words, dtype=f"S{w}").view(np.uint8).reshape(-1, w)
    return arr[idx], np.array([len(t) for t in words])[idx]


def _cents(v, width: int):
    """``v`` hundredths as 'int.dd': the pieces of one decimal field."""
    import numpy as np
    v = np.asarray(v, dtype=np.int64)
    frac = ((v % 100)[:, None] // np.array([10, 1]) % 10 + 48)
    return [_digits(v // 100, width), _fixed(b".", len(v)),
            (frac.astype(np.uint8), None)]


def _assemble(pieces) -> tuple[bytes, object]:
    """Rows made of pieces (uint8 [N, w], lengths [N] or None for all w)
    back to back -> (the text of every row in order, each row's length)."""
    import numpy as np
    n = len(pieces[0][0])
    width = sum(a.shape[1] for a, _ in pieces)
    cells = np.empty((n, width), np.uint8)
    mask = np.ones((n, width), bool)
    col = 0
    for a, ln in pieces:
        w = a.shape[1]
        cells[:, col:col + w] = a
        if ln is not None:
            mask[:, col:col + w] = np.arange(w) < ln[:, None]
        col += w
    return cells[mask].tobytes(), mask.sum(axis=1)


def lineitem(seed: int, scale: float = 1.0) -> dict:
    """TPC-H lineitem at scale factor ``scale`` in dbgen's '|'-delimited
    .tbl text (a trailing '|', no header), made in numpy from ``seed`` with
    dbgen's formats and ranges: 1,500,000 x scale orders of 1-7 lines each
    (nudged to 6,001,215 x scale rows in all, SF 1's count), sparse order
    keys, l_partkey uniform over 200,000 x scale parts and its supplier
    among 10,000 x scale, l_quantity 1-50, the extended price from the
    part's retail price, discounts 0.00-0.10, taxes 0.00-0.08, ISO dates,
    flags from the dates, the fixed SHIPINSTRUCT and SHIPMODE words,
    comments of 10-43 characters. Returns the text, each row's byte offset
    (N + 1 of them) and the columns the selects read. (dbgen's own random
    streams are not reproduced: the rows are other rows of the same
    distributions.)"""
    import numpy as np
    gen = np.random.default_rng(seed)
    n_orders = max(1, round(ORDERS_SF1 * scale))
    parts = max(1, round(PARTS_SF1 * scale))
    supps = max(1, round(SUPPS_SF1 * scale))
    counts = gen.integers(1, 8, n_orders)
    diff = round(ROWS_SF1 * scale) - int(counts.sum())
    room = np.flatnonzero(counts < 7 if diff > 0 else counts > 1)
    pick = gen.choice(room, min(abs(diff), len(room)), replace=False)
    counts[pick] += 1 if diff > 0 else -1
    n = int(counts.sum())
    order = np.repeat(np.arange(n_orders), counts)
    line = np.arange(n) - np.repeat(np.cumsum(counts) - counts, counts) + 1
    orderkey = (order // 8) * 32 + order % 8 + 1
    partkey = gen.integers(1, parts + 1, n)
    i = gen.integers(0, 4, n)
    suppkey = (partkey + i * (supps // 4 + (partkey - 1) // supps)) \
        % supps + 1
    quantity = gen.integers(1, 51, n)
    retail = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    price = quantity * retail
    discount = gen.integers(0, 11, n)
    tax = gen.integers(0, 9, n)
    start = np.datetime64("1992-01-01")
    current = np.datetime64("1995-06-17")
    order_days = int((np.datetime64("1998-12-31") - 151 - start)
                     // np.timedelta64(1, "D"))
    # dates as days since 1992-01-01, printed from a table of every day
    orderdate = gen.integers(0, order_days + 1, n_orders)[order]
    ship = orderdate + gen.integers(1, 122, n)
    commit = orderdate + gen.integers(30, 91, n)
    receipt = ship + gen.integers(1, 31, n)
    today = int((current - start) // np.timedelta64(1, "D"))
    flag = np.where(receipt <= today, gen.integers(0, 2, n), 2)
    status = (ship > today).astype(np.int64)
    days = np.datetime_as_string(start + np.arange(order_days + 152)) \
        .astype("S10").view(np.uint8).reshape(-1, 10)
    pool = []
    for _ in range(4096):
        words = b" ".join(COMMENT_WORDS[j] for j in gen.integers(
            0, len(COMMENT_WORDS), 12))
        pool.append(words[:int(gen.integers(10, 44))].strip())
    comment = gen.integers(0, len(pool), n)
    instruct = gen.integers(0, len(SHIPINSTRUCT), n)
    mode = gen.integers(0, len(SHIPMODE), n)

    def date(d):
        return days[d], None

    texts, lens = [], []
    for a in range(0, n, 1 << 16):     # cache-sized slices of rows
        sl = slice(a, min(n, a + (1 << 16)))
        m = sl.stop - sl.start
        bar = _fixed(b"|", m)
        pieces = [_digits(orderkey[sl], 7), bar, _digits(partkey[sl], 6), bar,
                  _digits(suppkey[sl], 5), bar, _digits(line[sl], 1), bar,
                  _digits(quantity[sl], 2), bar, *_cents(price[sl], 6), bar,
                  *_cents(discount[sl], 1), bar, *_cents(tax[sl], 1), bar,
                  _pick((b"R", b"A", b"N"), flag[sl]), bar,
                  _pick((b"F", b"O"), status[sl]), bar,
                  date(ship[sl]), bar, date(commit[sl]), bar,
                  date(receipt[sl]), bar, _pick(SHIPINSTRUCT, instruct[sl]),
                  bar, _pick(SHIPMODE, mode[sl]), bar,
                  _pick(pool, comment[sl]), bar, _fixed(b"\n", m)]
        t, ln = _assemble(pieces)
        texts.append(t)
        lens.append(ln)
    offsets = np.concatenate(([0], np.cumsum(np.concatenate(lens))))
    return {"text": b"".join(texts), "offsets": offsets, "rows": n,
            "orderkey": orderkey, "partkey": partkey, "quantity": quantity,
            "price_cents": price}


# --- phases ---------------------------------------------------------------


def encode_key(k: int, m: int) -> tuple:
    """K2's library key for the k+m codec's encode matrix."""
    from minio_tpu_torch.ops import gf256, rs_cuda
    return ("gf_encode",
            rs_cuda.encode_defines(gf256.build_matrix(k, m)[k:]))


def build_keys() -> list:
    """Every library the paths and the kernels phase load: one per source,
    and K2's for each encode matrix of ENCODE_GEOMETRIES."""
    from minio_tpu_torch.ops import cuda_build
    return [n for n in cuda_build.SIGNATURES if n not in cuda_build.VARIANTS] \
        + [encode_key(k, m) for k, m in ENCODE_GEOMETRIES]


def phase_build(rehearsal: bool) -> None:
    from minio_tpu_torch.ops import cuda_build
    if rehearsal:
        emit({"phase": "build", "skipped": "cpu rehearsal"})
        return
    t0 = time.monotonic()
    keys = build_keys()
    took = cuda_build.build(keys)
    ptxas = {}
    for key in keys:
        name, defines = (key, ()) if isinstance(key, str) else key
        lines = [ln.strip() for ln in cuda_build.build_log(
            name, defines).splitlines() if "registers" in ln or "spill" in ln]
        ptxas[cuda_build.label(key)] = lines[:8]
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "per_library_s": {k: round(v, 3) for k, v in took.items()},
          "ptxas": ptxas})


def phase_card(rehearsal: bool) -> str:
    if rehearsal:
        emit({"phase": "card", "skipped": "cpu rehearsal"})
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(out, flush=True)
    emit({"phase": "card", "nvidia_smi": out})
    return out


#: the native phase: chunk lengths whose digests are held to the numpy
#: references (remainders of every kind), and the thread counts of its
#: host hash rates over 16 KiB chunks
NATIVE_LENGTHS = (1, 31, 33, 1028, 16384, 16385)
NATIVE_THREADS = (1, 8, 32)


def phase_native(rehearsal: bool) -> dict:
    """Builds the port's libnative.so with this host's g++, holds its
    HighwayHash-256 and MUR3X256 digests byte for byte to the numpy
    references (native/hhpy.py, native/mur3py.py), and measures the host
    hash rate over 16 KiB chunks at 1, 8 and 32 threads (each thread hashes
    the same buffer of 64 MiB, 1 MiB per call; the numpy HighwayHash beside
    it at one thread, on 4 MiB)."""
    import numpy as np
    from minio_tpu_torch import native
    from minio_tpu_torch.erasure.bitrot import HIGHWAY_KEY
    from minio_tpu_torch.native import hhpy, mur3py

    t0 = time.monotonic()
    native.load_native()
    res = {"build_s": time.monotonic() - t0, "flags": native.build_flags,
           "library": os.path.relpath(native.library_path(), HERE),
           "cpus": os.cpu_count()}
    gen = np.random.default_rng(5)
    for length in NATIVE_LENGTHS:
        c = gen.integers(0, 256, (8, length), dtype=np.uint8)
        check(np.array_equal(native.hh256_batch(HIGHWAY_KEY, c),
                             hhpy.hash256_batch(HIGHWAY_KEY, c)),
              f"native HighwayHash-256 differs from hhpy at {length} bytes")
        check(np.array_equal(native.mur3x256_batch(HIGHWAY_KEY, c),
                             mur3py.hash256_batch(HIGHWAY_KEY, c)),
              f"native MUR3X256 differs from mur3py at {length} bytes")
    res["digests_checked"] = {"lengths": list(NATIVE_LENGTHS), "chunks": 8,
                              "equal": True}
    mib = 4 if rehearsal else 64
    buf = gen.integers(0, 256, (mib * (2**20 // CHUNK), CHUNK),
                       dtype=np.uint8)
    batches = buf.reshape(-1, 2**20 // CHUNK, CHUNK)  # 1 MiB per call
    rates = {}
    for name, fn in (("highwayhash256", native.hh256_batch),
                     ("mur3x256", native.mur3x256_batch)):
        rates[name] = {}
        for n in NATIVE_THREADS:
            def work(_):
                for b in batches:
                    fn(HIGHWAY_KEY, b)
            t0 = time.monotonic()
            with ThreadPoolExecutor(max_workers=n) as ex:
                list(ex.map(work, range(n)))
            rates[name][str(n)] = n * buf.nbytes / (time.monotonic() - t0) \
                / 2**30
    t0 = time.monotonic()
    for b in batches[:4]:
        hhpy.hash256_batch(HIGHWAY_KEY, b)
    rates["highwayhash256_numpy_1_thread"] = \
        4 * batches[0].nbytes / (time.monotonic() - t0) / 2**30
    res["host_hash_gib_s"] = rates
    emit({"phase": "native", **res})
    return res


class _HashClocks:
    """Seconds inside the host bitrot hashes while installed, by engine:
    ``native`` (the port's libnative.so entries the paths call) and
    ``numpy`` (native/hhpy.py and native/mur3py.py, which no path may
    call)."""

    def __init__(self):
        from minio_tpu_torch import native
        from minio_tpu_torch.native import hhpy, mur3py
        self.clocks = {"native": [_Clock(native, n) for n in (
            "hh256", "hh256_batch", "hh256_multi", "mur3x256_batch",
            "mur3x256_many")],
            "numpy": [_Clock(hhpy, "hash256_batch"),
                      _Clock(mur3py, "hash256_batch"),
                      _Clock(mur3py, "digest256_py")]}

    def __enter__(self):
        for cs in self.clocks.values():
            for c in cs:
                c.__enter__()
        return self

    def __exit__(self, *exc):
        for cs in self.clocks.values():
            for c in cs:
                c.__exit__()

    def summary(self) -> dict:
        return {engine: {"cpu_s": sum(c.cpu_s for c in cs),
                         "thread_wall_s": sum(c.wall_s for c in cs),
                         "calls": sum(c.calls for c in cs)}
                for engine, cs in self.clocks.items()}


def _words(gen, shape, device):
    import numpy as np
    import torch
    return torch.from_numpy(gen.integers(
        -2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).to(device)


def _err(got, want) -> int:
    """Largest word difference over a result or a tuple of results."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    return max(max_abs_err(a, b) for a, b in zip(got, want))


def kernel_row(name: str, source: str, replaces: str, shape: str, run,
               plain, args: tuple, nbytes: int, ops: tuple[int, int], device,
               floor=None, **extra) -> dict:
    """One kernel at one shape: ``run(*args)`` held word for word against
    its plain version ``plain(*args)``, then both timed (``time_ms``, the
    kernel on cold inputs), with the bound of the work, what bounds it, a
    device-to-device copy of the same bytes as the measured memory floor
    (``copy_ms``) and, given ``floor`` (a call that launches an empty
    kernel at the kernel's geometry), the launch floor (``floor_ms``)."""
    err = _err(run(*args), plain(*args))
    check(err == 0, f"{name} at {shape} disagrees with its plain version: "
          f"max_abs_err {err}")
    b_ms, b_by = bound_ms(nbytes, *ops)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "shape": shape, "max_abs_err": err,
           "ms": time_ms(run, args, REPS, device),
           "plain_ms": time_ms(plain, args, PLAIN_REPS, device, cold=False),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "copy_ms": copy_floor_ms(nbytes, REPS, device)}
    if floor is not None:
        row["floor_ms"] = time_ms(floor, (), REPS, device, cold=False,
                                  spin=True)
    row.update(extra)
    emit({"phase": "kernel", **row})
    return row


def chacha_ops(items: int, pkgs: int, words: int) -> tuple[int, int]:
    """(int32 operations, of them XORs) of the ChaCha20 XOR: per data block
    the 960 of the rounds (320 adds, 320 XORs, 320 rotates), 16
    feed-forward adds and 16 XORs with the payload; per package key block
    the rounds and the 8 feed-forward adds its Poly1305 key needs."""
    per = items * pkgs
    return (per * ((words // 16) * 992 + 968),
            per * ((words // 16) * 336 + 320))


def chacha_bytes(items: int, pkgs: int, words: int) -> int:
    """Payload in and out, keys and nonces in, Poly1305 keys out."""
    return 4 * items * pkgs * (2 * words + 3 + 8) + 32 * items


def hh_ops(n: int, nbytes: int) -> tuple[int, int]:
    """(int32 operations, of them XORs) of HighwayHash-256 per chunk
    (64-bit adds and XORs as 2, the 32x32->64 multiply as 2, a byte
    permute as 1): 96 per 32-byte packet, 112 for a remainder packet (its
    length add, half rotates and update), 1,018 for the key set-up, 10
    finalize rounds and the modular reduction; the XORs of the packet
    updates, 16 per packet, are the logic (the rest is left out, which
    only lowers the bound)."""
    packets = nbytes // 32 + (1 if nbytes % 32 else 0)
    return (n * (96 * (nbytes // 32) + (112 if nbytes % 32 else 0) + 1018),
            n * 16 * packets)


#: SASS opcodes by the pipe that issues them (Hopper); the uniform
#: datapath's U* opcodes and anything else fall under "other"
_PIPES = {
    "alu": ("IADD3", "LOP3", "SHF", "PRMT", "ISETP", "SEL", "LEA", "IABS",
            "IMNMX", "FLO", "MOV", "PLOP3", "SGXT", "BMSK"),
    "fma": ("IMAD", "IMUL", "FFMA", "FADD", "FMUL"),
    "memory": ("LDG", "STG", "LD", "ST", "LDS", "STS", "LDC"),
    "control": ("BRA", "EXIT", "BSSY", "BSYNC", "RET", "CALL", "BAR",
                "WARPSYNC"),
}


def sass_mix(lib: str, symbol: str, defines: tuple = ()) -> dict:
    """Static SASS instruction counts of one kernel of a built library, by
    issuing pipe (``cuobjdump -sass``, beside nvcc; NOP padding left out).
    The kernels are fully unrolled, so this is what one thread issues,
    both branches of a lane kind included."""
    import re
    from minio_tpu_torch.ops import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-sass",
                           cuda_build.target(lib, defines)[1]],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts = {k: 0 for k in (*_PIPES, "other")}
    ops: dict = {}
    inside = False
    for line in dump.splitlines():
        if "Function :" in line:
            inside = symbol in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if not inside or not m or m.group(1) == "NOP":
            continue
        base = m.group(1).split(".")[0]
        ops[base] = ops.get(base, 0) + 1
        pipe = next((p for p, names in _PIPES.items() if base in names),
                    "other")
        counts[pipe] += 1
    check(sum(counts.values()) > 0, f"no SASS found for {symbol} in {lib}")
    return {"per_pipe": counts, "total": sum(counts.values()),
            "by_opcode": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}


def ptxas_info(lib: str, defines: tuple = ()) -> dict:
    """Registers, spills and static shared memory of each kernel of a built
    library, read from its build log's ptxas lines: {mangled name:
    {"registers": r, "spill_bytes": s, "static_smem_bytes": b}}."""
    import re
    from minio_tpu_torch.ops import cuda_build
    out, cur = {}, None
    for line in cuda_build.build_log(lib, defines).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {"registers": None,
                                              "spill_bytes": 0,
                                              "static_smem_bytes": 0})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def hash_geometry(lib: str, symbol: str, n: int, nbytes: int,
                  device) -> dict:
    """The launch plan of a K3/K5 launch over ``n`` chunks of ``nbytes``
    (16-byte-aligned rows) and its kernel's registers and shared memory per
    CTA (the ring's dynamic bytes plus the static ones)."""
    import torch
    from minio_tpu_torch.ops import hh_cuda
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else hh_cuda.SMS
    plan = hh_cuda.launch_plan(n, nbytes, nbytes % 16 == 0, sms)
    res = next((v for k, v in ptxas_info(lib).items() if symbol in k),
               {"registers": None, "static_smem_bytes": 0})
    return {"plan": plan._asdict(), "registers": res["registers"],
            "smem_bytes_per_cta": plan.smem_bytes + res["static_smem_bytes"]}


def encode_geometry(mat, x) -> dict:
    """K2's launch over x [B, i, W] by ``mat``: its grid, threads and words
    per thread (4 through 16-byte loads when W % 4 == 0, the view is
    16-byte aligned and i <= 16), and the kernel's registers, spills and
    shared memory per CTA from the ptxas lines of its library's build."""
    from minio_tpu_torch.ops import rs_cuda
    b, i, w = x.shape
    v = 4 if w % 4 == 0 and x.data_ptr() % 16 == 0 and i <= 16 else 1
    res = next((r for k, r in ptxas_info(
        "gf_encode", rs_cuda.encode_defines(mat)).items()
        if f"gf_encode_kernelILi{v}E" in k), {})
    groups = -(-w // v)
    return {"plan": {"grid": [-(-groups // 128), b], "threads": 128,
                     "words_per_thread": v},
            "registers": res.get("registers"),
            "spill_bytes": res.get("spill_bytes"),
            "smem_bytes_per_cta": res.get("static_smem_bytes", 0)}


def scan_geometry(x) -> dict:
    """K6's tile plan over x [B, L] and its kernel's registers, spills and
    shared memory per CTA (the plan's dynamic bytes plus the static ones);
    bulk copies take the tiles when L % 16 == 0 and x is 16-byte aligned."""
    from minio_tpu_torch.ops import scan_cuda
    b, L = x.shape
    plan = scan_cuda.tile_plan(L, b)
    bulk = L % 16 == 0 and x.data_ptr() % 16 == 0
    res = next((r for k, r in ptxas_info("scan").items()
                if f"scan_tiles_kernelILb{int(bulk)}E" in k), {})
    return {"plan": {**plan._asdict(), "bulk_copies": bulk},
            "registers": res.get("registers"),
            "spill_bytes": res.get("spill_bytes"),
            "smem_bytes_per_cta": plan.smem_bytes
            + res.get("static_smem_bytes", 0)}


def edge_blocks(text: bytes, L: int) -> dict:
    """K6's edge blocks of L bytes from lineitem text (uint8 [L] each):
    ``long_row``: a block whose newlines in 20,000 bytes at its middle are
    spaces (one row longer than a tile and its halo); ``no_newline``: every
    newline a '|' (the block is one unterminated row); ``wide_rows``: each
    row's comment widened by 1,000 bytes, newline-padded as DeviceScan
    pads (~1,000 rows where the flush's max_rows is 16,384, so the last
    tile fills more ranks than a tile holds rows)."""
    import numpy as np
    base = np.frombuffer(text[:L], np.uint8).copy()
    long_row = base.copy()
    mid = long_row[L // 2: L // 2 + 20000]
    mid[mid == 10] = 32
    no_newline = base.copy()
    no_newline[no_newline == 10] = PIPE
    wide, size = [], 0
    for row in text[:L].split(b"\n"):
        row = row[:-1] + b"w" * 1000 + b"|\n"
        if size + len(row) > L:
            break
        wide.append(row)
        size += len(row)
    wide_rows = np.frombuffer(b"".join(wide).ljust(L, b"\n"), np.uint8)
    return {"long_row": long_row, "no_newline": no_newline,
            "wide_rows": wide_rows.copy()}


def select_program(sql: str) -> tuple[tuple, tuple]:
    """The compiled WHERE program and CSV columns of a header-less query."""
    from minio_tpu_torch.s3select.device import compile_where
    from minio_tpu_torch.s3select.sql import parse_select
    sel = parse_select(sql)
    return compile_where(sel.where, sel.alias or "", {})


def select_blocks(text: bytes, n: int, device):
    """The first ``n`` blocks the select path's DeviceScan cuts from
    ``text``, newline-padded as it pads them, on ``device`` -> (uint8
    [n, L], the request's max_rows)."""
    import numpy as np
    import torch
    from minio_tpu_torch.s3select.device import DeviceScan, _next_pow2
    prog, cols = select_program(QUERY_A)
    data = np.frombuffer(text[:(n + 8) * BLOCK], np.uint8)
    # a span of exactly 1 MiB pads to 2 MiB and takes a bucket of its own:
    # the flush shape is the other spans'
    spans = [sp for sp in DeviceScan(data, prog, cols, PIPE, device).spans
             if sp[1] - sp[0] < BLOCK][:n]
    check(len(spans) == n and not any(r for _, _, r in spans),
          f"{len(spans)} scan blocks, not {n}")
    L = max(_next_pow2(max(e - a + 1, 4096)) for a, e, _ in spans)
    out = np.full((n, L), 10, np.uint8)
    rows = 1
    for i, (a, e, _) in enumerate(spans):
        out[i, :e - a] = data[a:e]
        rows = max(rows, int(np.count_nonzero(data[a:e] == 10)))
    return torch.from_numpy(out).to(device), _next_pow2(rows)


def edge_block(gen, L: int = 4096):
    """Rows of 9 fields, the last 8 drawn from EDGE_INTS, every third row
    with one cell from EDGE_BAD, every seventh cut short (a blank row
    among them), newline-padded to ``L`` bytes."""
    import numpy as np
    rows = []
    while True:
        k = len(rows)
        nf = 9 if k % 7 else int(gen.integers(0, 9))
        cells = [b"r%d" % k] + [EDGE_INTS[j] for j in gen.integers(
            0, len(EDGE_INTS), 8)]
        if k % 3 == 0:
            cells[1 + int(gen.integers(0, 8))] = \
                EDGE_BAD[int(gen.integers(0, len(EDGE_BAD)))]
        row = b",".join(cells[:nf]) + b"\n"
        if sum(map(len, rows)) + len(row) > L - 32:
            break
        rows.append(row)
    txt = b"".join(rows)
    return np.frombuffer(txt + b"\n" * (L - len(txt)), np.uint8)[None] \
        .copy()


def scan_ops(x, program: tuple, cols: tuple, delim: int, max_rows: int
             ) -> tuple[int, int]:
    """(integer operations, of them ALU-only) that these blocks' scan needs:
    one compare per block byte (is it a newline), per byte of a referenced
    cell of at most 16 bytes 3 (a digit test on the ALU pipe, the
    multiply-add and the power of ten), and per row the program's ops
    (compares on the ALU pipe). Counted from this run's data (the plain
    version's cells)."""
    import torch
    from minio_tpu_torch.ops import scan_torch
    c = scan_torch.cells(x, cols, delim, max_rows)
    cell_bytes = int(((c != 0) & (c != scan_torch.POISON)).sum())
    del c
    real_rows = int(torch.clamp((x == 10).sum(dim=1), max=max_rows).sum())
    n = x.numel() + real_rows * len(program)
    return n + 3 * cell_bytes, n + cell_bytes


def occupancy(threads: int, registers, smem_bytes: int) -> int | None:
    """Resident CTAs per SM on Hopper for a kernel of ``threads`` threads,
    ``registers`` per thread and ``smem_bytes`` of shared memory per CTA:
    at most 32 CTAs and 64 warps, registers allocated 256 per warp from
    65,536, shared memory from 228 KB with 1 KB kept per CTA."""
    if registers is None:
        return None
    warps = -(-threads // 32)
    warp_regs = -(-registers * 32 // 256) * 256
    return min(32, 64 // warps, 65536 // warp_regs // warps,
               233_472 // (smem_bytes + 1024))


def matmul_geometry(plan) -> dict:
    """K1's plan with the registers, spills and static shared memory of the
    kernel it launches (its build log's ptxas lines) and the CTAs per SM
    they allow."""
    sym = (f"gf_matmul_batched_kernelILi{plan.jmax}"
           f"ELi{plan.words_per_thread}E")
    res = next((r for k, r in ptxas_info("gf_matmul").items() if sym in k),
               {})
    smem = plan.smem_bytes + res.get("static_smem_bytes", 0)
    return {"plan": plan._asdict(), "kernel": sym,
            "registers": res.get("registers"),
            "spill_bytes": res.get("spill_bytes"),
            "smem_bytes_per_cta": smem,
            "ctas_per_sm": occupancy(plan.threads, res.get("registers"),
                                     smem)}


def chacha_geometry(plan) -> dict:
    """K4's plan with its kernel's registers and spills and the CTAs per SM
    they allow."""
    sym = "chacha20_quad_kernel" if plan.lanes_per_block == 4 \
        else "chacha20_kernelILb1E"
    res = next((r for k, r in ptxas_info("chacha20").items() if sym in k),
               {})
    return {"plan": plan._asdict(), "kernel": sym,
            "registers": res.get("registers"),
            "spill_bytes": res.get("spill_bytes"),
            "ctas_per_sm": occupancy(plan.threads, res.get("registers"), 0)}


def rebuild_masks(gen, codec, b: int, o: int, k: int = K, m: int = M):
    """K1's masks [b, 8, o, k] of b rebuilds: for each element m of the
    k + m shards lost at random, the first o of them rebuilt from k
    survivors (o = k + m: every shard, as reconstruct_batch asks)."""
    import numpy as np
    from minio_tpu_torch.ops import gf256
    masks = np.empty((b, 8, o, k), dtype=np.uint32)
    for e in range(b):
        lost = sorted(gen.choice(k + m, size=m, replace=False))
        present = tuple(i for i in range(k + m) if i not in lost)[:k]
        targets = tuple(int(t) for t in lost[:o]) if o <= m \
            else tuple(range(k + m))
        masks[e] = gf256.coeff_masks(codec.rebuild_rows(present, targets))
    return masks.view(np.int32)


def matmul_rows(device, gen, x, codec, shapes) -> list:
    """K1 rows over x [B, k, W] (``codec`` is k+m) for each (b, o,
    replaces) of ``shapes``: the kernel at ``rs_cuda.matmul_plan``'s
    geometry and its launch floor."""
    import torch
    from minio_tpu_torch.ops import rs_cuda
    w, k = x.shape[-1], x.shape[1]
    m = codec.parity_rows.shape[0]
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else rs_cuda.SMS
    out = []
    for b, o, replaces in shapes:
        mk = torch.from_numpy(rebuild_masks(gen, codec, b, o, k, m)).to(
            device)
        xb = x[:b]
        extra, floor = {}, None
        if device.type == "cuda":
            plan = rs_cuda.matmul_plan(b, o, k, w, xb.data_ptr() % 16 == 0,
                                       sms)
            floor = (lambda plan=plan: rs_cuda.launch_empty(plan, device))
            extra = matmul_geometry(plan)
        out.append(kernel_row(
            "gf_matmul_batched", "minio_tpu_torch/csrc/gf_matmul.cu",
            replaces, f"B={b} o={o} i={k} W={w}",
            rs_cuda.gf_matmul_batched, rs_cuda.gf_matmul_batched_ref,
            (mk, xb), 4 * b * (k * w + o * w + 8 * o * k),
            (b * w * o * (8 * k + 35), b * w * o * (8 * k + 21)), device,
            floor=floor, **extra))
    return out


def chacha_rows(device, shapes) -> list:
    """K4 rows for each (keys, nonces, data, replaces) of ``shapes``: the
    kernel at ``chacha_cuda.launch_plan``'s geometry, its launch floor,
    and, where the plan is four threads per block, one thread per block
    (K4's only layout before the four-lane one) timed in the same run
    (``earlier_design_ms``)."""
    import torch
    from minio_tpu_torch.ops import chacha_cuda, chacha_torch
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else chacha_cuda.SMS
    out = []
    for keys, nonces, data, replaces in shapes:
        items, pkgs, pw = data.shape
        extra, floor = {}, None
        if device.type == "cuda":
            plan = chacha_cuda.launch_plan(items, pkgs, pw, sms)
            floor = (lambda plan=plan: chacha_cuda.launch_empty(plan,
                                                                device))
            extra = chacha_geometry(plan)
        row = kernel_row(
            "chacha20_xor", "minio_tpu_torch/csrc/chacha20.cu", replaces,
            f"I={items} P={pkgs} W={pw}",
            chacha_cuda.chacha20_xor, chacha_torch.multi_xor,
            (keys, nonces, data), chacha_bytes(items, pkgs, pw),
            chacha_ops(items, pkgs, pw), device, floor=floor, **extra)
        one = chacha_cuda.one_lane_plan(items, pkgs, pw)
        if device.type == "cuda" and plan != one:
            row["earlier_design_ms"] = time_ms(
                lambda k, n, d, p=one: chacha_cuda.launch(
                    k, n, d, torch.empty_like(d),
                    torch.empty((items, pkgs, 8), dtype=torch.int32,
                                device=device), p),
                (keys, nonces, data), REPS, device)
            row["earlier_design"] = chacha_geometry(one)
            emit({"phase": "kernel_earlier_design", "name": row["name"],
                  "shape": row["shape"], "ms": row["ms"],
                  "earlier_design_ms": row["earlier_design_ms"]})
        out.append(row)
    return out


def phase_kernels(device, small: bool, table: dict) -> dict:
    """Each kernel against its plain version at the shapes the paths give
    it: the batched shapes of a 128-object flush and the B = 1 / I = 1
    shapes of the single-block entry points; K6 on the blocks of ``table``
    (the select path's lineitem text)."""
    import numpy as np
    import torch
    from minio_tpu_torch.erasure.bitrot import HIGHWAY_KEY
    from minio_tpu_torch.native.mur3py import seeds_from_key
    from minio_tpu_torch.ops import (chacha_cuda, chacha_torch, gf256,
                                     hh_cuda, hh_torch, mur3_cuda, rs_cuda)
    from minio_tpu_torch.ops.rs_torch import get_codec

    B, W = (4, 1024 + 4) if small else (128, BLOCK // K // 4)
    gen = np.random.default_rng(7)
    x = _words(gen, (B, K, W), device)
    codec = get_codec(K, M, device=device)
    rows = {}

    # K2: the encode matrix compiled into its kernel, over the batch (B =
    # 128, and the paths' PUT flushes: MUR3 ~85 items, SSE ~18, Select
    # 5-12, so 64 and 16), over one block (ReedSolomon.encode), at 8+4
    # (its own library), and on a view one word into its storage (not
    # 16-byte aligned: one word per thread)
    enc = []
    for k, m, b, line, unaligned in (
            (K, M, B, 300, False), (K, M, 1, 224, False),
            (K, M, 16, 300, False), (K, M, 64, 300, False),
            (8, 4, B, 300, False), (K, M, B, 300, True)):
        par = get_codec(k, m, device=device).parity_rows
        masks = torch.from_numpy(
            gf256.coeff_masks(par).view(np.int32)).to(device)
        wk = W * K // k
        b = min(b, B)
        if unaligned:
            xb = _words(gen, (b * k * wk + 1,), device)[1:].view(b, k, wk)
            check(xb.data_ptr() % 16 != 0, "the view is 16-byte aligned")
        elif k == K:
            xb = x[:b]
        else:
            xb = _words(gen, (b, k, wk), device)
        enc.append(kernel_row(
            "gf_encode_batched", "minio_tpu_torch/csrc/gf_encode.cu",
            f"minio_tpu/ops/rs_pallas.py:{line}",
            f"B={b} {k}+{m} W={wk}" + (" unaligned" if unaligned else ""),
            lambda xb, par=par: rs_cuda.gf_encode_batched(par, xb),
            lambda xb, masks=masks: rs_cuda.gf_matmul_batched_ref(masks, xb),
            (xb,), 4 * b * wk * (k + m),
            tuple(b * wk * v for v in fixed_matrix_ops(par)), device,
            **encode_geometry(par, xb)))
    # K2 at the cluster path's geometries, over whole 1 MiB blocks: a
    # 16-drive set at its default parity (8+8) and REDUCED_REDUNDANCY
    # (12+4), one block and a 16-item flush each
    for k, m in ((8, 8), (12, 4)):
        par = get_codec(k, m, device=device).parity_rows
        masks = torch.from_numpy(
            gf256.coeff_masks(par).view(np.int32)).to(device)
        shard = -(-(BLOCK if not small else 16448) // k)  # bytes, ceil
        wk = -(-shard // 4)
        for b in (1, 16 if not small else 2):
            xb = _words(gen, (b, k, wk), device)
            enc.append(kernel_row(
                "gf_encode_batched", "minio_tpu_torch/csrc/gf_encode.cu",
                "minio_tpu/ops/rs_pallas.py:" + ("224" if b == 1 else "300"),
                f"B={b} {k}+{m} W={wk}",
                lambda xb, par=par: rs_cuda.gf_encode_batched(par, xb),
                lambda xb, masks=masks: rs_cuda.gf_matmul_batched_ref(
                    masks, xb),
                (xb,), 4 * b * wk * (k + m),
                tuple(b * wk * v for v in fixed_matrix_ops(par)), device,
                **encode_geometry(par, xb)))
    rows["gf_encode_batched"] = {**enc[0], "also": enc[1:]}
    if not small:
        enc[0]["sass"] = sass_mix("gf_encode", "gf_encode_kernelILi4E",
                                  encode_key(K, M)[1])
        emit({"phase": "sass", "kernel": f"gf_encode_kernel<4> {K}+{M}",
              **enc[0]["sass"]})

    # K1: per-element masks, known only at run time, so every coefficient
    # bit costs one LOP3 ((mask & x) ^ acc), plus 7 doublings of 5 ops (3
    # of them logic) per output word — o=2 (two lost data shards per
    # item: degraded GET and heal), o=20 (reconstruct_batch) at B = 128,
    # and the batches the paths launch (SMALL_B x SMALL_O: B = 1 is
    # ReedSolomon.reconstruct of one block)
    mm = matmul_rows(device, gen, x, codec, [
        (B, 2, "minio_tpu/ops/rs_pallas.py:147"),
        (B, K + M, "minio_tpu/ops/rs_pallas.py:147")] + [
        (min(b, B), o, "minio_tpu/ops/rs_pallas.py:" + (
            "89" if b == 1 else "147"))
        for b in SMALL_B if b <= B for o in SMALL_O])
    # K1 at the cluster path's 8+8: a node's loss takes 8 shards of a set,
    # so a degraded GET rebuilds up to o = 8 rows from i = 8 survivors,
    # over one block and over the batch of 8 the paths launch
    w8 = (BLOCK if not small else 16448) // 8 // 4
    x8 = _words(gen, (8, 8, w8), device)
    mm += matmul_rows(device, gen, x8, get_codec(8, 8, device=device), [
        (1, 8, "minio_tpu/ops/rs_pallas.py:89"),
        (8, 8, "minio_tpu/ops/rs_pallas.py:147")])
    rows["gf_matmul_batched"] = {**mm[0], "also": mm[1:]}
    if not small:
        # the SASS of the kernels of the B = 128 and the B = 1 rows
        for row in (mm[0], next(r for r in mm if r["shape"].startswith(
                "B=1 o=2"))):
            row["sass"] = sass_mix("gf_matmul", row["kernel"])
            emit({"phase": "sass", "kernel": row["kernel"], **row["sass"]})

    # K4: the sse_xor flush (128 objects of 16 packages of 64 KiB, each
    # object under its own key), the item counts the paths launch
    # (SMALL_I), and one object's packages under one key (I = 1, the shape
    # of xor_packages, whose wrapper is held to its plain version too; the
    # row times the kernel alone, without that wrapper's nonce read-back)
    items, pkgs, pw = (3, 2, 64) if small else (N_OBJECTS, 16, 16384)
    keys = _words(gen, (items, 8), device)
    nonces = _words(gen, (items, pkgs, 3), device)
    # package sequence numbers near 2**32 - 1, key words with the top bit
    nonces[:, :, 2] = -1 - torch.arange(pkgs, dtype=torch.int32,
                                        device=device)
    keys[:, 0] |= -2**31
    payload = _words(gen, (items, pkgs, pw), device)
    key0 = gen.bytes(32)
    one_nonce = nonces[0].clone()
    one_nonce[:, :2] = one_nonce[0, :2]
    err = _err(chacha_cuda.xor_packages(key0, one_nonce, payload[0]),
               chacha_torch.xor_packages(key0, one_nonce, payload[0]))
    check(err == 0, f"xor_packages disagrees with its plain version: "
          f"max_abs_err {err}")
    kw0 = chacha_torch.key_words(key0, device)
    ch = chacha_rows(device, [
        (keys, nonces, payload, "minio_tpu/ops/chacha_pallas.py:210"),
        (kw0, one_nonce[None], payload[:1],
         "minio_tpu/ops/chacha_pallas.py:92")] + [
        (keys[:i], nonces[:i], payload[:i],
         "minio_tpu/ops/chacha_pallas.py:210")
        for i in SMALL_I if 1 < i < items])
    rows["chacha20_xor"] = {**ch[0], "also": ch[1:]}
    if not small:
        # the SASS of the flush's one-lane kernel and the I = 1 row's
        for row in ch[:2]:
            row["sass"] = sass_mix("chacha20", row["kernel"])
            emit({"phase": "sass", "kernel": row["kernel"], **row["sass"]})

    # K3 and K5 at the chunk counts the paths launch (launch_sizes): every
    # 16 KiB chunk of a 128-item 16+4 flush (10,240), one chunk (the serial
    # chain), a verify flush (~256) and an SSE encode_hashed data launch
    # (~1,024); K5 also at the short tail chunks of the SSE objects' last
    # block (64 B: 1 KiB of ciphertext over 16 data shards) and at a
    # remainder past the last packet (1,028 B, the direct-load case)
    nc = (W * 4) // CHUNK if not small else 2
    cw = CHUNK // 4 if not small else 64
    seeds = seeds_from_key(HIGHWAY_KEY)
    kw = hh_torch.key_words(HIGHWAY_KEY)
    sizes = [(n, cw * 4) for n in (B * (K + M) * nc, 1, 256, 1024)]
    k3, k5 = [], []
    for n, nbytes in sizes + [(B * (K + M), 64), (B * (K + M), 1028)]:
        d = _words(gen, (n, nbytes // 4), device)
        shape = f"N={n} chunks x {nbytes} B"
        if (n, nbytes) in sizes:
            k3.append(kernel_row(
                "mur3x256_chunks", "minio_tpu_torch/csrc/mur3x256.cu",
                "minio_tpu/ops/mur3_pallas.py:164", shape,
                lambda d, nb=nbytes: mur3_cuda.mur3x256_chunks(seeds, nb, d),
                lambda d, nb=nbytes: mur3_cuda.mur3x256_ref(seeds, nb, d),
                (d,), n * nbytes + n * 32,
                (n * (nbytes // 16) * 44, n * (nbytes // 16) * 8), device,
                **hash_geometry("mur3x256", "mur3x256_kernel", n, nbytes,
                                device)))
        k5.append(kernel_row(
            "highwayhash256_chunks", "minio_tpu_torch/csrc/highwayhash.cu",
            "minio_tpu/ops/hh_jax.py:302", shape,
            lambda d, nb=nbytes: hh_cuda.highwayhash256_chunks(kw, nb, d),
            lambda d, nb=nbytes: hh_cuda.highwayhash256_ref(kw, nb, d),
            (d,), n * nbytes + n * 32, hh_ops(n, nbytes), device,
            **hash_geometry("highwayhash", "hh256_kernelILb%dE" % (
                nbytes % 16 == 0), n, nbytes, device)))
    rows["mur3x256_chunks"] = {**k3[0], "also": k3[1:]}
    rows["highwayhash256_chunks"] = {**k5[0], "also": k5[1:]}

    # K6: Query A's program over the select path's flush (128 lineitem
    # blocks of 1 MiB), over Query A's own flush of 16, over one of those
    # blocks, the edge-case block under EDGE_PROGRAM over 8 columns (whose
    # max_rows passes its newline count), and the edge blocks made from a
    # lineitem block (edge_blocks: a row longer than a tile and its halo,
    # no newline, rows so wide that the newline count is under max_rows by
    # more than a tile's rows)
    from minio_tpu_torch.ops import scan_cuda, scan_torch
    prog, cols = select_program(QUERY_A)
    blocks, max_rows = select_blocks(table["text"], 4 if small else N_OBJECTS,
                                     device)
    edge = torch.from_numpy(edge_block(gen)).to(device)
    check(int((edge == 10).sum()) < 1024, "edge block has too many rows")
    cases = [(blocks, prog, cols, PIPE, max_rows, ""),
             (blocks[:16], prog, cols, PIPE, max_rows, ""),
             (blocks[:1], prog, cols, PIPE, max_rows, ""),
             (edge, EDGE_PROGRAM, tuple(range(1, 9)), COMMA, 1024, "edge")]
    for what, blk in edge_blocks(table["text"],
                                 blocks.shape[1]).items():
        cases.append((torch.from_numpy(blk[None]).to(device), prog, cols,
                      PIPE, max_rows, what))
    scan = []
    for xb, p, c, d, mr, what in cases:
        scan.append(kernel_row(
            "scan_codes", "minio_tpu_torch/csrc/scan.cu",
            "minio_tpu/ops/scan_pallas.py:259",
            f"B={xb.shape[0]} L={xb.shape[1]} max_rows={mr} C={len(c)} "
            f"ops={len(p)}" + (f" {what}" if what else ""),
            lambda xb, p=p, c=c, d=d, mr=mr: scan_cuda.scan_codes(
                xb, p, c, d, mr),
            lambda xb, p=p, c=c, d=d, mr=mr: scan_torch.scan_blocks(
                xb, p, c, d, mr), (xb,),
            xb.numel() + 4 * xb.shape[0] * mr, scan_ops(xb, p, c, d, mr),
            device, **scan_geometry(xb),
            newlines=int((xb == 10).sum())))
    codes = scan_cuda.scan_codes(edge, EDGE_PROGRAM, tuple(range(1, 9)),
                                 COMMA, 1024)
    check(all(bool((codes == v).any()) for v in (0, 1, 2)),
          "the edge block's codes lack a match, a miss or a residual")
    if device.type == "cuda":
        # device memory of one flush beyond its input blocks: the codes and
        # the tiles' status words (at most SCAN_SCRATCH_MAX beyond the codes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        scan_cuda.scan_codes(blocks, prog, cols, PIPE, max_rows)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        codes = 4 * blocks.shape[0] * max_rows
        scan[0].update(flush_peak_bytes=peak, codes_bytes=codes,
                       input_bytes=blocks.numel())
        emit({"phase": "scan_flush_memory",
              "peak_bytes_beyond_inputs": peak, "codes_bytes": codes,
              "input_bytes": blocks.numel()})
        check(peak - codes <= SCAN_SCRATCH_MAX,
              f"K6's flush takes {peak - codes} bytes beyond its codes")
    rows["scan_codes"] = {**scan[0], "also": scan[1:]}
    if not small:
        scan[0]["sass"] = sass_mix("scan", "scan_tiles_kernelILb1E")
        emit({"phase": "sass", "kernel": "scan_tiles_kernel<true>",
              **scan[0]["sass"]})
    return rows


def _disk_root(name: str) -> str:
    """Disk directories live inside the checkout (build/ is git-ignored)."""
    root = os.path.join(HERE, "build", "minio_tpu_torch",
                        f"smoke_disks_{os.getpid()}", name)
    os.makedirs(root, exist_ok=True)
    return root


def _percentile(vals: list, q: float) -> float:
    s = sorted(vals)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def _kernel_modules():
    from minio_tpu_torch.ops import (chacha_cuda, hh_cuda, mur3_cuda, rs_cuda,
                                     scan_cuda)
    return rs_cuda, mur3_cuda, chacha_cuda, hh_cuda, scan_cuda


def reset_launches() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


def read_launches() -> dict:
    out = {}
    for mod in _kernel_modules():
        out.update(mod.launches)
    return out


def read_launch_sizes() -> dict:
    """Launches since the reset by size: K3's and K5's by chunk count, K1's
    and K2's by batch size B and K4's by item count I, {kernel: {"<=2^k":
    launches}}, a launch of n under the least power of two at or above n;
    K1's also by output rows, {"gf_matmul_batched_by_o": {"o=2":
    launches}}; K4's also by package count P, {"chacha20_xor_by_p":
    {"<=16": launches}}; K6's by batch size, {"scan_codes": {"B":
    launches}}."""
    from minio_tpu_torch.ops import (chacha_cuda, hh_cuda, mur3_cuda,
                                     rs_cuda, scan_cuda)
    out = {}
    for mod in (mur3_cuda, hh_cuda, rs_cuda, chacha_cuda):
        for name, hist in mod.launch_sizes.items():
            out[name] = {f"<={b}": hist[b] for b in sorted(hist)}
    for name, hist in rs_cuda.launch_rows.items():
        out[f"{name}_by_o"] = {f"o={o}": hist[o] for o in sorted(hist)}
    for name, hist in chacha_cuda.launch_pkgs.items():
        out[f"{name}_by_p"] = {f"<={p}": hist[p] for p in sorted(hist)}
    for name, hist in scan_cuda.launch_sizes.items():
        out[name] = {str(b): hist[b] for b in sorted(hist)}
    return out


def merge_sizes(into: dict, sizes: dict) -> None:
    """Adds one sub-phase's ``read_launch_sizes`` into a path's."""
    for name, hist in sizes.items():
        dst = into.setdefault(name, {})
        for b, v in hist.items():
            dst[b] = dst.get(b, 0) + v


#: the device plane's readings at the start of the current sub-phase
_MARK: dict = {}


def _reset(q) -> None:
    """Zero the queue's, the request waits' and the flight recorder's
    counters before a sub-phase, and read the streams' occupied seconds,
    the build count and the storage instruments' errors (``_phase_row``
    takes the differences)."""
    from minio_tpu_torch.obs import device, timeline
    from minio_tpu_torch.runtime import completion
    from minio_tpu_torch.storage import xlstorage
    q.reset_stats()
    completion.reset_stats()
    timeline.reset()
    _MARK.update(occupancy=device.occupancy_totals(),
                 builds=device.compiles_total(),
                 storage_obs_errors=xlstorage.obs_errors())


def _device_rows(wall: float) -> dict:
    """The sub-phase's stream occupancy (the union of the flushes'
    CUDA-event intervals on the card's clock over the wall, and each
    lane's own share: the card's work plus the streams' waits for the
    host) and the flight recorder's per-lane figures: its last-minute
    ``busy_ratio`` as a scrape reads it, and the lane's busy seconds
    (flush start to readback landed) over the wall. Fails on a share
    outside [0, 1], on a library built inside the sub-phase and on a
    storage instrument that raised."""
    from minio_tpu_torch.obs import device, timeline
    from minio_tpu_torch.storage import xlstorage
    builds = device.compiles_total() - _MARK["builds"]
    check(builds == 0, f"{builds} libraries built during a timed phase")
    errs = xlstorage.obs_errors() - _MARK["storage_obs_errors"]
    check(errs == 0, f"{errs} storage instruments raised")
    occ = device.occupancy_share(_MARK["occupancy"],
                                 device.occupancy_totals(), wall)
    check(len(occ) == 1, f"flush intervals on {sorted(occ)}")
    (dev_occ,) = occ.values()
    if dev_occ["union"] is not None:
        for what, v in [("union", dev_occ["union"]),
                        *dev_occ["lanes"].items()]:
            check(0.0 <= v <= 1.0, f"stream occupancy of {what} is {v}")
    util = timeline.utilization()
    return {"stream_occupancy": dev_occ,
            "timeline": {
                "lanes": {ln: {"busy_ratio": st["busy_ratio"],
                               "busy_share":
                                   st["busy_seconds_total"] / wall,
                               "flushes": st["flushes"],
                               "batch_fill_avg": st["batch_fill_avg"]}
                          for ln, st in util["lanes"].items()},
                "queue_depth_p99": util["queue_depth"]["p99"]}}


def _phase_row(q, total: int, wall: float, hashes: _HashClocks) -> dict:
    """Wall, GiB/s, the dispatch queue's flush statistics and the host
    hash seconds by engine of one sub-phase (``_reset`` ran just before
    it, ``hashes`` was installed around it). Fails on any failed or
    salvaged flush and on any call of the numpy hashes."""
    from minio_tpu_torch.runtime import completion
    st = q.stats()
    host_hash = hashes.summary()
    check(host_hash["numpy"]["calls"] == 0,
          f"a path called the numpy hashes: {host_hash['numpy']}")
    check(st["failed_batches"] == 0,
          f"{st['failed_batches']} flushes ({st['failed_items']} items) "
          f"failed")
    check(st["salvaged_batches"] == 0,
          f"{st['salvaged_batches']} flushes ({st['salvaged_items']} items) "
          f"were salvaged on the host")
    check(st["obs_errors"] == 0, f"{st['obs_errors']} instruments raised")
    return {"wall_s": wall, "gib_s": total / wall / 2**30,
            "lanes": st["lanes"], "completer_s": st["completer_seconds"],
            "interactive_async_completions":
                st["lanes"]["interactive"]["async_completions"],
            "failed": {"batches": st["failed_batches"],
                       "items": st["failed_items"]},
            "salvaged": {"batches": st["salvaged_batches"],
                         "items": st["salvaged_items"]},
            "staging": st["staging"],
            "await_by_op": completion.stats(),
            "host_hash_s": host_hash,
            "flushes": st["batches"], "items": st["items"],
            "items_per_flush": st["avg_batch"],
            "max_items_per_flush": st["max_items"],
            "items_per_flush_by_op": {
                op: v["items"] / v["batches"]
                for op, v in st["ops"].items() if v["batches"]},
            "ops": {op: v for op, v in st["ops"].items() if v["items"]},
            **_device_rows(wall)}


def phase_main(device, n_objects: int, obj_bytes: int, seed: int) -> dict:
    """The MUR3X256S path: objects PUT, GET, degraded GET, corrupted
    GET and healed (see the module docstring)."""
    import numpy as np
    from minio_tpu_torch.erasure import (BitrotAlgorithm, Erasure,
                                         new_bitrot_reader, new_bitrot_writer)
    from minio_tpu_torch.erasure.bitrot import (HIGHWAY_KEY,
                                                pick_bitrot_chunk)
    from minio_tpu_torch.erasure.streaming import (BufferSink,
                                                   erasure_decode,
                                                   erasure_encode,
                                                   erasure_heal)
    from minio_tpu_torch.native import mur3py
    from minio_tpu_torch.ops import gf256
    from minio_tpu_torch.runtime.dispatch import global_queue
    from minio_tpu_torch.storage.xlstorage import XLStorage
    from minio_tpu_torch.utils import errors

    algo = BitrotAlgorithm.MUR3X256S
    er = Erasure(K, M, BLOCK, device=device)
    chunk = pick_bitrot_chunk(er.shard_size(), CHUNK)
    check(chunk == CHUNK, f"bitrot chunk {chunk} != {CHUNK}")
    root = _disk_root("mur3")
    disks = [XLStorage(os.path.join(root, f"d{i:02d}"))
             for i in range(K + M)]
    backup = os.path.join(root, "removed")
    gen = np.random.default_rng(seed)
    objs = [gen.bytes(obj_bytes) for _ in range(n_objects)]
    total = n_objects * obj_bytes
    till = er.shard_file_size(obj_bytes)
    lost = (0, 1)  # two data shards of every object
    q = global_queue(device)
    result = {"objects": n_objects, "object_bytes": obj_bytes,
              "geometry": f"{K}+{M}", "block": BLOCK, "chunk": chunk,
              "algo": algo.value, "threads": n_objects, "disk_root": root}

    def path(j):
        return f"obj{j:04d}/part.1"

    def readers(j, drop=()):
        return [None if i in drop else new_bitrot_reader(
            disks[i].read_file_at("bucket", path(j)), algo, till, chunk)
            for i in range(K + M)]

    def put(j):
        ws = [new_bitrot_writer(d.create_file_writer("bucket", path(j)),
                                algo, chunk) for d in disks]
        n = erasure_encode(er, io.BytesIO(objs[j]), ws, K)
        for w in ws:
            w.close()
        return n

    def get(j, drop=()):
        out = BufferSink()
        st = erasure_decode(er, out, readers(j, drop), 0, obj_bytes,
                            obj_bytes)
        return out.getvalue(), st

    def heal(j):
        t0 = time.monotonic()
        ws = [new_bitrot_writer(disks[i].create_file_writer(
            "bucket", path(j)), algo, chunk) if i in lost else None
            for i in range(K + M)]
        erasure_heal(er, ws, readers(j, lost), obj_bytes)
        return time.monotonic() - t0

    def run(fn, label):
        _reset(q)
        with _HashClocks() as hashes:
            t0 = time.monotonic()
            with ThreadPoolExecutor(max_workers=n_objects) as ex:
                res = list(ex.map(fn, range(n_objects)))
            wall = time.monotonic() - t0
        result[label] = _phase_row(q, total, wall, hashes)
        return res

    reset_launches()

    counts = run(put, "put")
    check(counts == [obj_bytes] * n_objects, "PUT consumed a wrong size")

    got = run(lambda j: get(j)[0], "get")
    bad = [j for j in range(n_objects) if got[j] != objs[j]]
    check(not bad, f"GET mismatch on objects {bad[:5]}")
    del got

    # one object's first block against the host reference math: parity
    # via gf256.gf_matmul_ref, digests via the pure-Python MUR3X256
    blk = np.frombuffer(objs[0][:BLOCK], dtype=np.uint8).reshape(K, -1)
    ref_par = gf256.gf_matmul_ref(er.codec.parity_rows, blk)
    for i in range(K + M):
        raw = disks[i].read_file_at("bucket", path(0)).read_at(
            0, 32 + chunk)
        shard = blk[i] if i < K else ref_par[i - K]
        check(raw[32:] == shard[:chunk].tobytes(),
              f"shard {i} block 0 disagrees with the host reference")
        check(raw[:32] == mur3py.digest256_py(
            HIGHWAY_KEY, shard[:chunk].tobytes()),
              f"shard {i} digest disagrees with the host reference")

    os.makedirs(backup, exist_ok=True)
    for j in range(n_objects):
        for i in lost:
            src = os.path.join(disks[i].root, "bucket", path(j))
            dst = os.path.join(backup, f"d{i:02d}_{j:04d}")
            os.replace(src, dst)

    got = run(lambda j: get(j, lost)[0], "degraded_get")
    bad = [j for j in range(n_objects) if got[j] != objs[j]]
    check(not bad, f"degraded GET mismatch on objects {bad[:5]}")
    del got

    # flip one payload byte of a surviving data shard of object 0
    victim = 2
    vpath = os.path.join(disks[victim].root, "bucket", path(0))
    with open(vpath, "r+b") as f:
        f.seek(32 + 1000)
        byte = f.read(1)
        f.seek(32 + 1000)
        f.write(bytes([byte[0] ^ 0x5A]))
    data0, st = get(0, lost)
    check(data0 == objs[0], "GET of the corrupted object is not exact")
    check(isinstance(st.errs[victim], errors.FileCorrupt),
          f"corrupt source not reported: {st.errs[victim]!r}")
    result["corruption"] = {"object": 0, "shard": victim,
                            "reported": type(st.errs[victim]).__name__,
                            "get_exact": True}

    lat = run(heal, "heal")
    result["heal"]["p50_ms"] = _percentile(lat, 0.50) * 1e3
    result["heal"]["p99_ms"] = _percentile(lat, 0.99) * 1e3
    for j in range(n_objects):
        for i in lost:
            with open(os.path.join(backup, f"d{i:02d}_{j:04d}"), "rb") as f:
                want = f.read()
            with open(os.path.join(disks[i].root, "bucket", path(j)),
                      "rb") as f:
                check(f.read() == want,
                      f"healed shard {i} of object {j} differs")
    result["heal"]["byte_identical"] = True

    launches = read_launches()
    result["launches"] = launches
    result["launch_sizes"] = read_launch_sizes()
    flushes = [result[p]["max_items_per_flush"]
               for p in ("put", "get", "degraded_get", "heal")]
    result["max_items_per_flush"] = max(flushes)
    if device.type == "cuda":
        for name in ("gf_matmul_batched", "gf_encode_batched",
                     "mur3x256_chunks"):
            check(launches[name] > 0,
                  f"kernel {name} never launched on the MUR3X256S path")
    check(max(flushes) > 1, "no flush coalesced more than one item")
    shutil.rmtree(root, ignore_errors=True)
    return result


class _Clock:
    """Time spent inside one module function, summed over every thread that
    calls it while installed: wall seconds (waits for the interpreter lock
    included) and the calling threads' CPU seconds (the host Poly1305 of
    the SSE path)."""

    def __init__(self, module, name: str):
        import threading
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.wall_s = self.cpu_s = 0.0
        self.calls = 0
        self._lock = threading.Lock()

        def timed(*a, **kw):
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return self.fn(*a, **kw)
            finally:
                dt, dc = time.perf_counter() - t0, time.thread_time() - c0
                with self._lock:
                    self.wall_s += dt
                    self.cpu_s += dc
                    self.calls += 1
        self.timed = timed

    def __enter__(self):
        setattr(self.module, self.name, self.timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class _Sampler:
    """Where the host's threads are while installed: every ``every``
    seconds, the innermost Python frame of each thread (file:function:line;
    a thread blocked in C, or waiting for the interpreter lock after a C
    call, shows the line of that call), counted apart for the dispatcher
    thread and for the others. The sampling thread takes the lock once per
    sample."""

    def __init__(self, every: float = 0.01):
        import collections
        import threading
        self.every = every
        self.counts = {"dispatcher": collections.Counter(),
                       "others": collections.Counter()}
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        import threading
        me = threading.get_ident()
        while not self._stop.wait(self.every):
            names = {t.ident: t.name for t in threading.enumerate()}
            self.samples += 1
            for ident, fr in sys._current_frames().items():
                if ident == me:
                    continue
                who = "dispatcher" if names.get(ident, "").startswith(
                    "minio-tpu-torch-dispatch") else "others"
                code = fr.f_code
                self.counts[who][f"{os.path.basename(code.co_filename)}:"
                                 f"{code.co_name}:{fr.f_lineno}"] += 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def top(self, n: int = 12) -> dict:
        """Each group's most frequent frames, as shares of the samples."""
        return {who: [(k, v / max(1, self.samples)) for k, v in
                      c.most_common(n)] for who, c in self.counts.items()}


def phase_sse(device, n_objects: int, plain_bytes: int, seed: int) -> dict:
    """SSE-C ChaCha20-Poly1305 objects on HighwayHash256S erasure shards:
    each object, under its own customer key, is sealed by EncryptReader
    (sse_xor flushes, K4) into erasure_encode (encode_hashed: K2 + K5),
    read back whole and ranged through DecryptWriter (verify: K5), read
    with two data shards gone (fused: K1 + K5) and healed. Every plaintext
    byte is compared with the source; the launch counts are reset before
    and read after each sub-phase."""
    import base64
    import hashlib
    import numpy as np
    from minio_tpu_torch.crypto import chacha20poly1305 as ccp
    from minio_tpu_torch.crypto import sse
    from minio_tpu_torch.erasure import (BitrotAlgorithm, Erasure,
                                         new_bitrot_reader, new_bitrot_writer)
    from minio_tpu_torch.erasure.bitrot import (DEFAULT_BITROT_ALGO,
                                                pick_bitrot_chunk)
    from minio_tpu_torch.erasure.streaming import (BufferSink,
                                                   erasure_decode,
                                                   erasure_encode,
                                                   erasure_heal)
    from minio_tpu_torch.runtime.dispatch import global_queue
    from minio_tpu_torch.storage.xlstorage import XLStorage

    algo = BitrotAlgorithm.HIGHWAYHASH256S
    check(DEFAULT_BITROT_ALGO is algo, f"default bitrot algorithm is "
          f"{DEFAULT_BITROT_ALGO}, not {algo}")
    er = Erasure(K, M, BLOCK, device=device)
    chunk = pick_bitrot_chunk(er.shard_size(), CHUNK)
    check(chunk == CHUNK, f"bitrot chunk {chunk} != {CHUNK}")
    root = _disk_root("sse")
    disks = [XLStorage(os.path.join(root, f"d{i:02d}"))
             for i in range(K + M)]
    backup = os.path.join(root, "removed")
    gen = np.random.default_rng(seed + 1)
    # every second object ends in a short package (TAIL_SHORT bytes short
    # of whole packages), sealed and opened on the card as well
    sizes = [plain_bytes - (TAIL_SHORT if j % 2 else 0)
             for j in range(n_objects)]
    plains = [gen.bytes(n) for n in sizes]
    keys = [gen.bytes(32) for _ in range(n_objects)]
    enc_totals = [sse.enc_size(n) for n in sizes]
    lost = (0, 1)  # two data shards of every object
    bucket = "sse-bucket"
    meta: list = [None] * n_objects
    q = global_queue(device)
    total = sum(sizes)
    result = {"objects": n_objects, "plain_bytes": sorted(set(sizes)),
              "cipher_bytes": sorted(set(enc_totals)),
              "geometry": f"{K}+{M}",
              "block": BLOCK, "chunk": chunk, "algo": algo.value,
              "scheme": "SSE-C", "cipher": sse.CIPHER_CHACHA20,
              "threads": n_objects, "disk_root": root}

    def headers(j):
        return {
            "x-amz-server-side-encryption-customer-algorithm": "AES256",
            "x-amz-server-side-encryption-customer-key":
                base64.b64encode(keys[j]).decode(),
            "x-amz-server-side-encryption-customer-key-md5":
                base64.b64encode(hashlib.md5(keys[j]).digest()).decode()}

    def path(j):
        return f"obj{j:04d}/part.1"

    def readers(j, drop=(), till_offset=None):
        if till_offset is None:
            till_offset = er.shard_file_size(enc_totals[j])
        return [None if i in drop else new_bitrot_reader(
            disks[i].read_file_at(bucket, path(j)), algo, till_offset,
            chunk) for i in range(K + M)]

    def put(j):
        info = sse.parse_sse_headers(headers(j), bucket, path(j))
        meta[j] = {}
        reader, size, _ = sse.encrypt_setup(
            info, io.BytesIO(plains[j]), sizes[j], meta[j], bucket,
            path(j), device=device)
        ws = [new_bitrot_writer(d.create_file_writer(bucket, path(j)),
                                algo, chunk) for d in disks]
        n = erasure_encode(er, reader, ws, K)
        for w in ws:
            w.close()
        return n == size == enc_totals[j]

    def get(j, offset=0, length=-1, drop=()):
        enc_total = enc_totals[j]
        oek, iv, plain_size, _, cipher = sse.sse_read_ctx(
            meta[j], headers(j), bucket, path(j), enc_total, device=device)
        enc_off, enc_len, seq0, skip = sse.decrypt_range_bounds(
            offset, length, plain_size)
        out = BufferSink()
        dw = sse.DecryptWriter(out, oek, iv, seq0, skip,
                               length if length >= 0 else plain_size,
                               bucket, path(j), cipher, device=device)
        erasure_decode(er, dw, readers(
            j, drop, er.shard_file_offset(enc_off, enc_len, enc_total)),
            enc_off, enc_len, enc_total)
        dw.close()
        return out.getvalue()

    def ranged(j):
        # an odd offset 4,097 bytes before a package boundary, 300,001
        # bytes long: several packages, the boundary mid-range
        pkgs = sizes[j] // sse.PKG_SIZE
        off = sse.PKG_SIZE * (1 + j % max(1, pkgs - 5)) - 4097
        ln = min(300001, sizes[j] - off)
        return get(j, off, ln) == plains[j][off: off + ln]

    def heal(j):
        t0 = time.monotonic()
        ws = [new_bitrot_writer(disks[i].create_file_writer(
            bucket, path(j)), algo, chunk) if i in lost else None
            for i in range(K + M)]
        erasure_heal(er, ws, readers(j, lost), enc_totals[j])
        return time.monotonic() - t0

    launched, sized = {}, {}

    def run(fn, label, kernels):
        _reset(q)
        reset_launches()
        with _Clock(ccp, "poly1305_tags") as poly, _HashClocks() as hashes:
            t0, c0 = time.monotonic(), time.process_time()
            with ThreadPoolExecutor(max_workers=n_objects) as ex:
                res = list(ex.map(fn, range(n_objects)))
            wall = time.monotonic() - t0
            cpu = time.process_time() - c0
        row = _phase_row(q, total, wall, hashes)
        row["launches"] = read_launches()
        row["launch_sizes"] = read_launch_sizes()
        # host CPU seconds of the whole process, and those inside Poly1305
        # (its wall seconds add the calling threads' waits for the lock)
        row["host_cpu_s"] = cpu
        row["poly1305_cpu_s"] = poly.cpu_s
        row["poly1305_cpu_share_of_wall"] = poly.cpu_s / wall
        row["poly1305_thread_wall_s"] = poly.wall_s
        result[label] = row
        if device.type == "cuda":
            for name in kernels:
                check(row["launches"][name] > 0,
                      f"kernel {name} never launched in SSE {label}")
        for name, n in row["launches"].items():
            launched[name] = launched.get(name, 0) + n
        merge_sizes(sized, row["launch_sizes"])
        return res

    ok = run(put, "put", ("chacha20_xor", "highwayhash256_chunks",
                          "gf_encode_batched"))
    check(all(ok), "an SSE PUT consumed a wrong size")

    got = run(get, "get", ("chacha20_xor", "highwayhash256_chunks"))
    bad = [j for j in range(n_objects) if got[j] != plains[j]]
    check(not bad, f"SSE GET plaintext mismatch on objects {bad[:5]}")
    del got

    ok = run(ranged, "ranged_get", ("chacha20_xor", "highwayhash256_chunks"))
    bad = [j for j in range(n_objects) if not ok[j]]
    check(not bad, f"SSE ranged GET mismatch on objects {bad[:5]}")

    os.makedirs(backup, exist_ok=True)
    for j in range(n_objects):
        for i in lost:
            os.replace(os.path.join(disks[i].root, bucket, path(j)),
                       os.path.join(backup, f"d{i:02d}_{j:04d}"))

    got = run(lambda j: get(j, drop=lost), "degraded_get",
              ("chacha20_xor", "highwayhash256_chunks", "gf_matmul_batched"))
    bad = [j for j in range(n_objects) if got[j] != plains[j]]
    check(not bad, f"SSE degraded GET mismatch on objects {bad[:5]}")
    del got

    lat = run(heal, "heal", ("highwayhash256_chunks", "gf_matmul_batched"))
    result["heal"]["p50_ms"] = _percentile(lat, 0.50) * 1e3
    result["heal"]["p99_ms"] = _percentile(lat, 0.99) * 1e3
    for j in range(n_objects):
        for i in lost:
            with open(os.path.join(backup, f"d{i:02d}_{j:04d}"), "rb") as f:
                want = f.read()
            with open(os.path.join(disks[i].root, bucket, path(j)),
                      "rb") as f:
                check(f.read() == want,
                      f"healed shard {i} of SSE object {j} differs")
    result["heal"]["byte_identical"] = True
    # the healed files serve the plaintext again
    check(get(0) == plains[0], "GET after heal is not exact")
    result["launches"] = launched
    result["launch_sizes"] = sized
    shutil.rmtree(root, ignore_errors=True)
    return result


def _expected_rows(table: dict, r0: int, r1: int, which: str) -> bytes:
    """The records a query must return over rows [r0, r1), built from the
    generated columns (not from the text): Query A's 'orderkey,partkey,
    quantity' where partkey < 2000 and quantity <= 24, Query B's orderkey
    where the extended price is below 1000.50."""
    import numpy as np
    sl = slice(r0, r1)
    ok, pk, qty = (table[k][sl] for k in ("orderkey", "partkey",
                                            "quantity"))
    if which == "A":
        m = (pk < 2000) & (qty <= 24)
        if not m.any():
            return b""
        n = int(m.sum())
        comma = _fixed(b",", n)
        return _assemble([_digits(ok[m], 7), comma, _digits(pk[m], 6),
                          comma, _digits(qty[m], 2),
                          _fixed(b"\n", n)])[0]
    m = table["price_cents"][sl] < 100050
    if not m.any():
        return b""
    return _assemble([_digits(ok[m], 7), _fixed(b"\n", int(m.sum()))])[0]


def _request(sql: str) -> bytes:
    from xml.sax.saxutils import escape
    return (b"<SelectObjectContentRequest><Expression>%s</Expression>"
            b"<ExpressionType>SQL</ExpressionType><InputSerialization>"
            b"<CompressionType>NONE</CompressionType><CSV>"
            b"<FileHeaderInfo>NONE</FileHeaderInfo><FieldDelimiter>|"
            b"</FieldDelimiter></CSV></InputSerialization>"
            b"<OutputSerialization><CSV/></OutputSerialization>"
            b"</SelectObjectContentRequest>" % escape(sql).encode())


def phase_select(device, table: dict, n_objects: int, seed: int) -> dict:
    """TPC-H lineitem as erasure-coded objects and SelectObjectContent over
    them (see the module docstring): PUT, Query A from one thread per
    object, Query B on one object. Every response's records are compared
    byte for byte with _expected_rows, its Stats with the object's sizes;
    launch counts are reset before and read after each sub-phase."""
    import base64
    import hashlib
    import numpy as np
    import torch
    from minio_tpu_torch.crypto import sse
    from minio_tpu_torch.erasure import (BitrotAlgorithm, Erasure,
                                         new_bitrot_reader, new_bitrot_writer)
    from minio_tpu_torch.erasure.bitrot import pick_bitrot_chunk
    from minio_tpu_torch.erasure.streaming import erasure_encode
    from minio_tpu_torch.ops import scan_cuda
    from minio_tpu_torch.runtime import dispatch
    from minio_tpu_torch.runtime.dispatch import global_queue
    from minio_tpu_torch.s3select import object as s3object
    from minio_tpu_torch.s3select import select_object_content
    from minio_tpu_torch.s3select.message import decode_messages
    from minio_tpu_torch.storage.xlstorage import XLStorage

    algo = BitrotAlgorithm.HIGHWAYHASH256S
    er = Erasure(K, M, BLOCK, device=device)
    chunk = pick_bitrot_chunk(er.shard_size(), CHUNK)
    check(chunk == CHUNK, f"bitrot chunk {chunk} != {CHUNK}")
    root = _disk_root("select")
    disks = [XLStorage(os.path.join(root, f"d{i:02d}"))
             for i in range(K + M)]
    text, offs = table["text"], table["offsets"]
    # objects of about equal bytes, cut on row boundaries
    cuts = np.searchsorted(offs, np.arange(n_objects + 1) * (len(text) /
                                                             n_objects))
    cuts[0], cuts[-1] = 0, table["rows"]
    rows_of = [(int(cuts[j]), int(cuts[j + 1])) for j in range(n_objects)]
    plains = [text[offs[a]:offs[b]] for a, b in rows_of]
    gen = np.random.default_rng(seed + 2)
    ssec = [j % SSE_EVERY == 0 for j in range(n_objects)]
    keys = [gen.bytes(32) for _ in range(n_objects)]
    lost = (0, 1)
    degraded = [j % DEGRADED_EVERY == 0 for j in range(n_objects)]
    bucket = "tpch"
    meta: list = [{} for _ in range(n_objects)]
    sizes = [len(p) for p in plains]
    q = global_queue(device)
    total = sum(sizes)
    result = {"table": "TPC-H lineitem", "rows": table["rows"],
              "text_bytes": len(text), "objects": n_objects,
              "object_bytes": [min(sizes), max(sizes)],
              "sse_c_objects": sum(ssec), "degraded_objects": sum(degraded),
              "geometry": f"{K}+{M}", "block": BLOCK, "chunk": chunk,
              "algo": algo.value, "threads": n_objects, "disk_root": root}

    def headers(j):
        if not ssec[j]:
            return {}
        return {
            "x-amz-server-side-encryption-customer-algorithm": "AES256",
            "x-amz-server-side-encryption-customer-key":
                base64.b64encode(keys[j]).decode(),
            "x-amz-server-side-encryption-customer-key-md5":
                base64.b64encode(hashlib.md5(keys[j]).digest()).decode()}

    def path(j):
        return f"lineitem/part-{j:05d}.tbl"

    stored = [0] * n_objects

    def put(j):
        stream, size = io.BytesIO(plains[j]), sizes[j]
        if ssec[j]:
            info = sse.parse_sse_headers(headers(j), bucket, path(j))
            stream, size, _ = sse.encrypt_setup(
                info, stream, sizes[j], meta[j], bucket, path(j),
                device=device)
        ws = [new_bitrot_writer(d.create_file_writer(bucket, path(j)),
                                algo, chunk) for d in disks]
        n = erasure_encode(er, stream, ws, K)
        for w in ws:
            w.close()
        stored[j] = n
        return n == size

    def select(j, sql):
        till = er.shard_file_size(stored[j])
        readers = [None if degraded[j] and i in lost else new_bitrot_reader(
            disks[i].read_file_at(bucket, path(j)), algo, till, chunk)
            for i in range(K + M)]
        out = io.BytesIO()
        t0 = time.monotonic()
        st = select_object_content(_request(sql), er, readers, stored[j],
                                   meta[j], headers(j), bucket, path(j), out,
                                   device=device)
        lat = time.monotonic() - t0
        msgs = decode_messages(out.getvalue())
        recs = b"".join(p for h, p in msgs
                        if h.get(":event-type") == "Records")
        stats = [p for h, p in msgs if h.get(":event-type") == "Stats"]
        return recs, st, stats[0].decode() if stats else "", lat

    def run(fn, jobs, label, kernels, nbytes):
        _reset(q)
        reset_launches()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        # thread-summed wall seconds inside the request's stages and the
        # dispatcher's scan flush (stacking, then K6 with its read-back)
        clocks = [_Clock(mod, name) for mod, name in (
            (s3object, "erasure_decode"), (s3object, "run_select"),
            (dispatch, "_stage"), (scan_cuda, "scan_codes"))]
        for c in clocks:
            c.__enter__()
        try:
            with _Sampler() as sampler, _HashClocks() as hashes:
                t0, c0 = time.monotonic(), time.process_time()
                with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
                    res = list(ex.map(fn, jobs))
                wall, cpu = time.monotonic() - t0, time.process_time() - c0
        finally:
            for c in clocks:
                c.__exit__()
        row = _phase_row(q, nbytes, wall, hashes)
        row["host_cpu_s"] = cpu
        row["thread_wall_s"] = {c.name: c.wall_s for c in clocks}
        row["host_frames"] = sampler.top()
        row["launches"] = read_launches()
        row["launch_sizes"] = read_launch_sizes()
        if device.type == "cuda":
            row["peak_device_bytes"] = torch.cuda.max_memory_allocated()
            for name in kernels:
                check(row["launches"][name] > 0,
                      f"kernel {name} never launched in select {label}")
        result[label] = row
        return res

    ok = run(put, range(n_objects), "put",
             ("gf_encode_batched", "highwayhash256_chunks", "chacha20_xor"),
             total)
    check(all(ok), "a lineitem PUT stored a wrong size")
    for j in range(n_objects):
        if degraded[j]:
            for i in lost:
                os.remove(os.path.join(disks[i].root, bucket, path(j)))

    def check_reply(j, reply, which):
        recs, st, stats_xml, _ = reply
        a, b = rows_of[j]
        check(recs == _expected_rows(table, a, b, which),
              f"Query {which} records of object {j} differ from the "
              f"expected rows")
        want = {"scanned": stored[j], "processed": sizes[j],
                "returned": len(recs)}
        check(st == want, f"Query {which} stats of object {j}: {st} != "
              f"{want}")
        for tag, v in (("BytesScanned", want["scanned"]),
                       ("BytesProcessed", want["processed"]),
                       ("BytesReturned", want["returned"])):
            check(f"<{tag}>{v}</{tag}>" in stats_xml,
                  f"Stats event of object {j} lacks {tag} {v}")
        return len(recs)

    replies = run(lambda j: select(j, QUERY_A), range(n_objects), "query_a",
                  ("scan_codes", "highwayhash256_chunks", "gf_matmul_batched",
                   "chacha20_xor"), total)
    matched = 0
    for j, reply in enumerate(replies):
        check_reply(j, reply, "A")
        matched += reply[0].count(b"\n")
    lat = [r[3] for r in replies]
    qa = result["query_a"]
    qa.update(rows_matched=matched, p50_ms=_percentile(lat, 0.5) * 1e3,
              p99_ms=_percentile(lat, 0.99) * 1e3,
              gib_s_processed=total / qa["wall_s"] / 2**30)
    check(matched > 0, "Query A matched no row")
    plain_j = next(j for j in range(n_objects)
                   if not ssec[j] and not degraded[j])
    sse_j = next(j for j in range(n_objects) if ssec[j])
    result["stats_checked"] = {
        "plain": {"object": plain_j, **replies[plain_j][1]},
        "sse_c": {"object": sse_j, **replies[sse_j][1]}}
    check(replies[sse_j][1]["scanned"] == sse.enc_size(sizes[sse_j]) >
          sizes[sse_j], "SSE-C BytesScanned is not the sealed size")

    reply = run(lambda j: select(j, QUERY_B), [plain_j], "query_b",
                ("scan_codes", "highwayhash256_chunks"), sizes[plain_j])[0]
    check_reply(plain_j, reply, "B")
    qb = result["query_b"]
    qb.update(object=plain_j, rows_matched=reply[0].count(b"\n"),
              latency_ms=reply[3] * 1e3,
              gib_s_processed=sizes[plain_j] / qb["wall_s"] / 2**30)
    launched, sized = {}, {}
    for label in ("put", "query_a", "query_b"):
        for name, n in result[label]["launches"].items():
            launched[name] = launched.get(name, 0) + n
        merge_sizes(sized, result[label]["launch_sizes"])
    result["launches"] = launched
    result["launch_sizes"] = sized
    shutil.rmtree(root, ignore_errors=True)
    return result


def _files(root: str) -> dict:
    """Every file under root, relative path -> bytes."""
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def phase_objectlayer(device, n_big: int, big_bytes: int, n_small: int,
                      small_bytes: int, part_sizes: tuple,
                      seed: int) -> dict:
    """The object layer over the device data path: one pool of two 16+4
    erasure sets (40 disk directories, 1 MiB blocks, HighwayHash256S with
    16 KiB chunks, placement by SipHash of the name under a deployment id
    made from --seed), driven through ServerPools as a user's calls reach
    it (see the module docstring, step 8). Launch counts are reset once
    before the path and read after it; each step reports its own."""
    import hashlib
    import uuid
    import numpy as np
    from minio_tpu_torch.erasure.bitrot import DEFAULT_BITROT_ALGO
    from minio_tpu_torch.erasure.streaming import PreallocSink
    from minio_tpu_torch.objectlayer import (ErasureSets, ObjectOptions,
                                             ServerPools)
    from minio_tpu_torch.objectlayer.datatypes import CompletePart
    from minio_tpu_torch.objectlayer.metadata import hash_order
    from minio_tpu_torch.runtime.dispatch import global_queue
    from minio_tpu_torch.storage.xlmeta import XLMeta
    from minio_tpu_torch.storage.xlstorage import XLStorage
    from minio_tpu_torch.utils.hashreader import (etag_from_parts,
                                                  pipeline_etag_reference)

    n_disks = OL_SETS * (K + M)
    root = _disk_root("objectlayer")
    disk_dirs = [os.path.join(root, f"d{i:02d}") for i in range(n_disks)]
    gen = np.random.default_rng(seed + 2)
    dep = str(uuid.UUID(bytes=gen.bytes(16)))
    bucket = "bucket"
    q = global_queue(device)
    t0 = time.monotonic()
    sets = ErasureSets([XLStorage(d) for d in disk_dirs], OL_SETS, K + M,
                       dep, default_parity=M, block_size=BLOCK,
                       device=device)
    pool = ServerPools([sets])
    result = {"deployment": f"1 pool x {OL_SETS} sets x {K + M} drives",
              "disks": n_disks, "geometry": f"{K}+{M}", "block": BLOCK,
              "chunk": CHUNK, "algo": sets.sets[0].bitrot_algo.value,
              "placement": sets.distribution_algo, "deployment_id": dep,
              "setup_s": time.monotonic() - t0, "disk_root": root,
              "cut": "one process over local disk directories (the "
                     "cluster path runs 32 drives over the storage RPC)"}
    check(sets.sets[0].bitrot_algo is DEFAULT_BITROT_ALGO,
          f"bitrot algorithm {sets.sets[0].bitrot_algo}")
    pool.make_bucket(bucket)
    big = {f"big/{j:04d}": gen.bytes(big_bytes) for j in range(n_big)}
    small = {f"small/{j:04d}": gen.bytes(small_bytes)
             for j in range(n_small)}
    parts = [gen.bytes(n) for n in part_sizes]
    mp_name = "multipart/object"
    bodies = {**big, **small, mp_name: b"".join(parts)}
    etags: dict = {}

    def put(name):
        data = bodies[name]
        return name, pool.put_object(bucket, name, io.BytesIO(data),
                                     len(data)).etag

    def get(name, offset=0, length=-1):
        sink = PreallocSink()
        pool.get_object(bucket, name, sink, offset, length)
        return sink.getbuffer()

    def set_of(name):
        s = sets.get_hashed_set_index(name)
        return s, sets.sets[s]

    def run(label, fn, jobs, threads, nbytes, kernels=()):
        _reset(q)
        before = read_launches()
        with _HashClocks() as hashes:
            t0 = time.monotonic()
            with ThreadPoolExecutor(max_workers=threads) as ex:
                res = list(ex.map(fn, jobs))
            wall = time.monotonic() - t0
        row = _phase_row(q, nbytes, wall, hashes)
        after = read_launches()
        row["launches"] = {k: after[k] - before.get(k, 0) for k in after}
        row["threads"] = threads
        row["objects"] = len(jobs)
        result[label] = row
        if device.type == "cuda":
            for name in kernels:
                check(row["launches"][name] > 0,
                      f"kernel {name} never launched in {label}")
        return res

    reset_launches()
    # 1. PUT of the big objects: fused ETags, journals naming the geometry
    names = sorted(big)
    etags.update(run("put_big", put, names, OL_PUT_THREADS,
                     n_big * big_bytes,
                     ("gf_encode_batched", "highwayhash256_chunks")))
    with ThreadPoolExecutor(max_workers=8) as ex:
        want = dict(zip(names, ex.map(lambda n: pipeline_etag_reference(
            big[n], K, BLOCK, CHUNK, 0), names)))
    bad = [n for n in names if etags[n] != want[n]]
    check(not bad, f"fused ETag differs from the reference on {bad[:3]}")
    for name in names:
        s, es = set_of(name)
        dist = hash_order(f"{bucket}/{name}", K + M)
        for i, d in enumerate(es.disks):
            fi = XLMeta.load(d.read_all(bucket, f"{name}/xl.meta")) \
                .to_fileinfo(bucket, name)
            ec = fi.erasure
            check((ec.data_blocks, ec.parity_blocks, ec.block_size,
                   ec.index, ec.distribution) == (K, M, BLOCK, dist[i],
                                                 dist),
                  f"xl.meta of {name} on set {s} disk {i} names "
                  f"{ec.data_blocks}+{ec.parity_blocks}/{ec.block_size} "
                  f"index {ec.index}")
    result["put_big"]["etags_equal_reference"] = len(names)
    result["put_big"]["xl_meta_checked"] = len(names) * (K + M)

    # 2. small objects (MD5 ETags) and one multipart object
    snames = sorted(small)
    etags.update(run("put_small", put, snames, OL_PUT_THREADS,
                     n_small * small_bytes, ("gf_encode_batched",)))
    bad = [n for n in snames
           if etags[n] != hashlib.md5(small[n]).hexdigest()]
    check(not bad, f"small-object ETag is not the MD5 on {bad[:3]}")

    def multipart(_):
        uid = pool.new_multipart_upload(bucket, mp_name)
        pe = [pool.put_object_part(bucket, mp_name, uid, i + 1,
                                   io.BytesIO(p), len(p)).etag
              for i, p in enumerate(parts)]
        oi = pool.complete_multipart_upload(
            bucket, mp_name, uid,
            [CompletePart(i + 1, e) for i, e in enumerate(pe)])
        return pe, oi.etag

    (part_etags, mp_etag), = run("multipart", multipart, [0], 1,
                                 sum(part_sizes), ("gf_encode_batched",))
    for p, e in zip(parts, part_etags):
        want_e = pipeline_etag_reference(p, K, BLOCK, CHUNK, 0) \
            if len(p) >= 1 << 20 else hashlib.md5(p).hexdigest()
        check(e == want_e, "a multipart part's ETag is not the reference")
    check(mp_etag == etag_from_parts(part_etags)
          and mp_etag.endswith(f"-{len(parts)}"),
          f"multipart ETag {mp_etag}")
    etags[mp_name] = mp_etag
    result["multipart"].update(parts=list(part_sizes), etag=mp_etag)

    # 3. listing: every name in order, with its size and ETag
    t0 = time.monotonic()
    listed = pool.list_objects(bucket, max_keys=1000)
    want_list = [(n, len(bodies[n]), etags[n]) for n in sorted(bodies)]
    got_list = [(o.name, o.size, o.etag) for o in listed.objects]
    check(got_list == want_list and not listed.is_truncated,
          f"list_objects: {len(got_list)} entries, want {len(want_list)}")
    result["list"] = {"wall_s": time.monotonic() - t0,
                      "objects": len(got_list)}

    # 4. GET of everything, and ranged GETs across a block and a part
    every = sorted(bodies)
    total = sum(len(b) for b in bodies.values())
    got = run("get", get, every, OL_PUT_THREADS, total,
              ("highwayhash256_chunks",))
    bad = [n for n, g in zip(every, got) if g != bodies[n]]
    check(not bad, f"GET mismatch on {bad[:3]}")
    del got
    mp_off = part_sizes[0] - 777
    ranges = [(names[0], BLOCK - 500, 1000),
              (mp_name, mp_off, min(5000, len(bodies[mp_name]) - mp_off))]
    for name, off, ln in ranges:
        check(get(name, off, ln) == bodies[name][off:off + ln],
              f"ranged GET of {name} at {off} is not exact")
    result["get"]["ranged"] = [list(r) for r in ranges]

    # 5. drive loss: two drives of each set replaced by empty ones
    lost = [(s, i) for s in range(OL_SETS) for i in OL_LOST]
    backup = os.path.join(root, "backup")
    for s, i in lost:
        path = disk_dirs[s * (K + M) + i]
        shutil.copytree(os.path.join(path, bucket),
                        os.path.join(backup, f"s{s}d{i}"))
        shutil.rmtree(path)
        sets.sets[s]._disks[i] = XLStorage(path)
    t0 = time.monotonic()
    hb = pool.heal_bucket(bucket)
    check(hb.after_state.count("ok") == n_disks, f"heal_bucket: {hb}")
    result["heal_bucket"] = {"wall_s": time.monotonic() - t0,
                             "missing_before": hb.before_state.count(
                                 "missing")}

    # 6. degraded GET of the big objects
    rebuild = 0
    for name in names:
        dist = hash_order(f"{bucket}/{name}", K + M)
        rebuild += min(dist[i] for i in OL_LOST) <= K
    got = run("degraded_get", get, names, OL_PUT_THREADS,
              n_big * big_bytes, ("highwayhash256_chunks",
                                  "gf_matmul_batched"))
    bad = [n for n, g in zip(names, got) if g != bodies[n]]
    check(not bad, f"degraded GET mismatch on {bad[:3]}")
    del got
    result["degraded_get"].update(objects_rebuilt=rebuild,
                                  objects_verified_only=n_big - rebuild)

    # 7. heal of every object from 128 threads
    def heal(name):
        t0 = time.monotonic()
        r = pool.heal_object(bucket, name)
        return time.monotonic() - t0, r.before_state.count("missing")

    res = run("heal", heal, every, OL_HEAL_THREADS, total,
              ("highwayhash256_chunks", "gf_matmul_batched"))
    lat = [w for w, _ in res]
    check(all(m == len(OL_LOST) for _, m in res),
          "a heal did not find its two missing drives")
    result["heal"].update(p50_ms=_percentile(lat, 0.50) * 1e3,
                          p99_ms=_percentile(lat, 0.99) * 1e3,
                          objects_healed=len(res))
    for s, i in lost:
        healed = _files(os.path.join(disk_dirs[s * (K + M) + i], bucket))
        want_files = _files(os.path.join(backup, f"s{s}d{i}"))
        check(healed == want_files,
              f"healed drive {i} of set {s}: {len(healed)} files, "
              f"{sum(healed.get(p) != v for p, v in want_files.items())} "
              f"differ from the backup")
    result["heal"]["byte_identical_files"] = sum(
        len(_files(os.path.join(backup, f"s{s}d{i}"))) for s, i in lost)

    # 8. bitrot: one flipped byte in a data shard
    name = names[0]
    s, es = set_of(name)
    dist = hash_order(f"{bucket}/{name}", K + M)
    i1 = dist.index(1)
    obj_dir = os.path.join(disk_dirs[s * (K + M) + i1], bucket, name)
    ddir = next(e for e in os.listdir(obj_dir) if e != "xl.meta")
    shard = os.path.join(obj_dir, ddir, "part.1")
    with open(shard, "rb") as f:
        pristine = f.read()
    with open(shard, "r+b") as f:
        f.seek(32 + 1000)
        f.write(bytes([pristine[32 + 1000] ^ 0x5A]))
    partial = []
    for e in sets.sets:
        e.on_partial = lambda b, o, v, scan_mode="normal": \
            partial.append((o, scan_mode))
    check(get(name) == bodies[name], "GET of the corrupted object")
    check((name, "deep") in partial, f"on_partial saw {partial}")
    r = pool.heal_object(bucket, name, scan_mode="deep")
    with open(shard, "rb") as f:
        check(f.read() == pristine, "deep heal did not restore the shard")
    result["bitrot"] = {"object": name, "set": s, "disk": i1,
                        "on_partial": [list(p) for p in partial],
                        "before": r.before_state.count("corrupt"),
                        "restored": True}
    for e in sets.sets:
        e.on_partial = None

    launches = read_launches()
    result["launches"] = launches
    result["launch_sizes"] = read_launch_sizes()
    if device.type == "cuda":
        for kname in ("gf_matmul_batched", "gf_encode_batched",
                      "highwayhash256_chunks"):
            check(launches[kname] > 0,
                  f"kernel {kname} never launched on the object layer path")
    shutil.rmtree(root, ignore_errors=True)
    return result


class _S3Client:
    """A signing S3 client over http.client, as a user's SDK drives the
    server: SigV4 from the port's server/auth.py under the root credentials
    or the given ones, one keep-alive connection per thread, the latency of
    every request kept for the step's p50/p99."""

    def __init__(self, port: int, access_key: str = S3_ACCESS_KEY,
                 secret_key: str = S3_SECRET_KEY):
        from minio_tpu_torch.server.auth import SigV4Verifier
        self.port = port
        self.access_key, self.secret_key = access_key, secret_key
        self.host = f"127.0.0.1:{port}"
        self.signer = SigV4Verifier(lambda ak: None, S3_REGION)
        self._local = threading.local()
        self._conns: list = []
        self.latencies: list = []

    def _conn(self):
        import http.client
        c = getattr(self._local, "conn", None)
        if c is None:
            c = http.client.HTTPConnection("127.0.0.1", self.port,
                                           timeout=600)
            self._local.conn = c
            self._conns.append(c)
        return c

    def _drop(self):
        c = getattr(self._local, "conn", None)
        if c is not None:
            c.close()
            self._local.conn = None

    def send(self, method: str, url: str, body: bytes, headers: dict,
             close: bool = False, expect: bool = False) -> tuple:
        """One request on this thread's connection: (status, headers,
        body). ``close`` drops the connection after it (the server closes
        one after an aws-chunked body). ``expect`` sends the headers with
        ``Expect: 100-continue`` and the body only after the server's 100
        (or after 1 s without an answer), as the AWS SDKs send a PUT: a
        refusal then arrives before the body is sent. A GET or HEAD whose
        kept-alive connection the server closed while it idled (the
        server's idle timeout) is sent again once on a new connection, as
        the SDKs do."""
        import http.client
        c = self._conn()
        reused = c.sock is not None and method in ("GET", "HEAD")
        try:
            return self._exchange(c, method, url, body, headers, close,
                                  expect)
        except (http.client.RemoteDisconnected, ConnectionResetError,
                BrokenPipeError):
            if not reused:
                raise
            self._drop()
            return self._exchange(self._conn(), method, url, body, headers,
                                  close, expect)

    def _exchange(self, c, method: str, url: str, body: bytes,
                  headers: dict, close: bool, expect: bool) -> tuple:
        import select
        t0 = time.monotonic()
        if not expect:
            c.request(method, url, body=body, headers=headers)
        else:
            c.putrequest(method, url, skip_host=True,
                         skip_accept_encoding=True)
            for k, v in headers.items():
                c.putheader(k, v)
            c.putheader("Content-Length", str(len(body)))
            c.putheader("Expect", "100-continue")
            c.endheaders()
            if select.select([c.sock], [], [], 1.0)[0] and \
                    c.sock.recv(12, socket.MSG_PEEK)[9:12] == b"100":
                head = b""
                while not head.endswith(b"\r\n\r\n"):
                    head += c.sock.recv(1)
                c.send(body)
            elif not select.select([c.sock], [], [], 0)[0]:
                c.send(body)
        r = c.getresponse()
        data = r.read()
        self.latencies.append(time.monotonic() - t0)
        if close or r.will_close:
            self._drop()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, data

    def request(self, method: str, path: str, query: dict | None = None,
                body: bytes = b"", headers: dict | None = None,
                expect: bool = False) -> tuple:
        import urllib.parse
        from minio_tpu_torch.server.auth import UNSIGNED_PAYLOAD
        query = {k: [v] for k, v in (query or {}).items()}
        h = {"host": self.host, **(headers or {})}
        h["authorization"] = self.signer.sign_request(
            self.access_key, self.secret_key, method, path, query, h,
            UNSIGNED_PAYLOAD)
        qs = urllib.parse.urlencode([(k, v[0]) for k, v in query.items()])
        url = urllib.parse.quote(path) + (f"?{qs}" if qs else "")
        return self.send(method, url, body, h, expect=expect)

    def chunked_put(self, path: str, payload: bytes) -> tuple:
        """A STREAMING-AWS4-HMAC-SHA256-PAYLOAD upload in 64 KiB chunks,
        each signed on the chain of the previous one, as mc and the AWS
        SDKs send it."""
        import datetime
        import hashlib
        import hmac
        import urllib.parse
        from minio_tpu_torch.server import auth
        ts = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")
        scope = f"{ts[:8]}/{S3_REGION}/s3/aws4_request"
        h = {"host": self.host, "x-amz-date": ts,
             "x-amz-content-sha256": auth.STREAMING_PAYLOAD,
             "x-amz-decoded-content-length": str(len(payload))}
        signed = sorted(h)
        creq = auth.canonical_request("PUT", path, {}, h, signed,
                                      auth.STREAMING_PAYLOAD)
        key = auth.signing_key(S3_SECRET_KEY, ts[:8], S3_REGION)
        prev = hmac.new(key, auth.string_to_sign(ts, scope, creq).encode(),
                        hashlib.sha256).hexdigest()
        h["authorization"] = (
            f"{auth.SIGN_V4_ALGO} Credential={S3_ACCESS_KEY}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={prev}")
        out = []
        view = memoryview(payload)
        chunks = [view[i:i + S3_STREAM_CHUNK]
                  for i in range(0, len(payload), S3_STREAM_CHUNK)]
        for chunk in chunks + [b""]:
            sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", ts, scope, prev,
                             auth.EMPTY_SHA256,
                             hashlib.sha256(chunk).hexdigest()])
            prev = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
            out += [f"{len(chunk):x};chunk-signature={prev}\r\n".encode(),
                    chunk, b"\r\n"]
        return self.send("PUT", urllib.parse.quote(path), b"".join(out), h,
                         close=True)

    def close(self):
        for c in self._conns:
            c.close()


class _TimedHeals:
    """The object layer as the MRF worker sees it, timing each
    heal_object call (the per-object MRF heal wall)."""

    def __init__(self, layer):
        self._layer = layer
        self.walls: dict = {}
        self.done: dict = {}

    def heal_object(self, bucket, object, *a, **kw):
        t0 = time.monotonic()
        try:
            return self._layer.heal_object(bucket, object, *a, **kw)
        finally:
            t1 = time.monotonic()
            self.walls[object] = t1 - t0
            self.done[object] = t1

    def __getattr__(self, name):
        return getattr(self._layer, name)


def phase_s3server(device, table: dict, sizes: dict, seed: int) -> dict:
    """The S3 front end over the object layer path's deployment (one pool
    of two 16+4 sets, 40 disk directories, 1 MiB blocks, HighwayHash256S
    with 16 KiB chunks), driven over HTTP by signed requests from a pool of
    client threads (see the module docstring, step 9). Launch counts are
    reset once before the path and read after it; each step reports its
    own, the clients' request p50/p99 and the lanes' busy shares."""
    import base64
    import hashlib
    import re
    import urllib.parse
    import uuid
    import numpy as np
    from minio_tpu_torch.erasure.streaming import PreallocSink
    from minio_tpu_torch.objectlayer import ErasureSets, ServerPools
    from minio_tpu_torch.objectlayer.metadata import hash_order
    from minio_tpu_torch.runtime.dispatch import global_queue
    from minio_tpu_torch.s3select.message import decode_messages
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.server.auth import presign_v4
    from minio_tpu_torch.storage.xlstorage import XLStorage
    from minio_tpu_torch.utils.hashreader import (etag_from_parts,
                                                  pipeline_etag_reference)

    n_big, big_bytes = sizes["big"]
    n_sse, sse_bytes = sizes["sse"]
    n_csv = sizes["csv"]
    part_sizes = sizes["parts"]
    n_disks = OL_SETS * (K + M)
    root = _disk_root("s3server")
    disk_dirs = [os.path.join(root, f"d{i:02d}") for i in range(n_disks)]
    gen = np.random.default_rng(seed + 3)
    dep = str(uuid.UUID(bytes=gen.bytes(16)))
    bucket = "bucket"
    q = global_queue(device)
    t0 = time.monotonic()
    sets = ErasureSets([XLStorage(d) for d in disk_dirs], OL_SETS, K + M,
                       dep, default_parity=M, block_size=BLOCK,
                       device=device)
    pool = ServerPools([sets])
    srv = S3Server(pool, "127.0.0.1", 0, access_key=S3_ACCESS_KEY,
                   secret_key=S3_SECRET_KEY, region=S3_REGION, device=device)
    srv.start_background()
    srv.start_background_services()
    mrf = srv.mrf
    heals = _TimedHeals(pool)
    mrf.obj = heals
    partial: dict = {}
    queued_at: dict = {}
    for layer in srv._erasure_layers():
        add = layer.on_partial
        check(add == mrf.add_partial, "on_partial does not feed the MRF")

        def record(b, o, v="", scan_mode="normal", _add=add):
            partial.setdefault(o, []).append(scan_mode)
            queued_at.setdefault(o, time.monotonic())
            _add(b, o, v, scan_mode=scan_mode)

        layer.on_partial = record
    client = _S3Client(srv.port)
    result = {"deployment": f"1 pool x {OL_SETS} sets x {K + M} drives",
              "disks": n_disks, "geometry": f"{K}+{M}", "block": BLOCK,
              "chunk": CHUNK, "deployment_id": dep,
              "endpoint": srv.endpoint(), "client_threads": S3_THREADS,
              "setup_s": time.monotonic() - t0, "disk_root": root,
              "cut": "one process over local disk directories, clients "
                     "over the loopback interface; " + CUT_S3_BIG}

    def sse_headers(j):
        key = hashlib.sha256(b"s3server-key-%d-%d" % (seed, j)).digest()
        return {"x-amz-server-side-encryption-customer-algorithm": "AES256",
                "x-amz-server-side-encryption-customer-key":
                    base64.b64encode(key).decode(),
                "x-amz-server-side-encryption-customer-key-md5":
                    base64.b64encode(hashlib.md5(key).digest()).decode()}

    big = {f"big/{j:04d}": gen.bytes(big_bytes) for j in range(n_big)}
    chunked = set(sorted(big)[::S3_CHUNKED_EVERY])
    sse_objs = {f"sse/{j:04d}": gen.bytes(sse_bytes) for j in range(n_sse)}
    sse_hdr = {name: sse_headers(j)
               for j, name in enumerate(sorted(sse_objs))}
    text, offs = table["text"], table["offsets"]
    cuts = np.searchsorted(offs, np.arange(SELECT_OBJECTS + 1) *
                           (len(text) / SELECT_OBJECTS))
    cuts[0], cuts[-1] = 0, table["rows"]
    csv_rows = {f"csv/part-{j:05d}.tbl": (int(cuts[j]), int(cuts[j + 1]))
                for j in range(n_csv)}
    csv = {n: text[offs[a]:offs[b]] for n, (a, b) in csv_rows.items()}
    parts = [gen.bytes(n) for n in part_sizes]
    mp_name, copy_name = "multipart/object", "copy/object"
    bodies = {**big, **sse_objs, **csv, mp_name: b"".join(parts)}
    etags: dict = {}

    def run(label, fn, jobs, nbytes, kernels=(), threads=S3_THREADS):
        _reset(q)
        client.latencies.clear()
        before = read_launches()
        with _HashClocks() as hashes:
            t0 = time.monotonic()
            with ThreadPoolExecutor(max_workers=threads) as ex:
                res = list(ex.map(fn, jobs))
            wall = time.monotonic() - t0
        row = _phase_row(q, nbytes, wall, hashes)
        after = read_launches()
        row["launches"] = {k: after[k] - before.get(k, 0) for k in after}
        lat = list(client.latencies)
        row.update(requests=len(lat), objects=len(jobs), threads=threads)
        if lat:
            row.update(request_p50_ms=_percentile(lat, 0.50) * 1e3,
                       request_p99_ms=_percentile(lat, 0.99) * 1e3)
        result[label] = row
        if device.type == "cuda":
            for name in kernels:
                check(row["launches"][name] > 0,
                      f"kernel {name} never launched in s3server {label}")
        return res

    def ok(status, want, what):
        check(status == want, f"{what}: HTTP {status}, want {want}")

    reset_launches()
    ok(client.request("PUT", f"/{bucket}")[0], 200, "PUT bucket")

    # 1. PUT of the plain objects, some as aws-chunked streams
    def put_big(name):
        if name in chunked:
            st, h, data = client.chunked_put(f"/{bucket}/{name}", big[name])
        else:
            st, h, data = client.request("PUT", f"/{bucket}/{name}",
                                         body=big[name])
        ok(st, 200, f"PUT {name}: {data[:200]!r}")
        return name, h["etag"].strip('"')

    names = sorted(big)
    etags.update(run("put_plain", put_big, names, n_big * big_bytes,
                     ("gf_encode_batched", "highwayhash256_chunks")))
    with ThreadPoolExecutor(max_workers=8) as ex:
        want = dict(zip(names, ex.map(lambda n: pipeline_etag_reference(
            big[n], K, BLOCK, CHUNK, 0), names)))
    bad = [n for n in names if etags[n] != want[n]]
    check(not bad, f"fused ETag differs from the reference on {bad[:3]}")
    result["put_plain"].update(etags_equal_reference=len(names),
                               aws_chunked=len(chunked))

    # 2. the HTTP cost: the same bodies through ServerPools in-process
    ok(client.request("PUT", "/inprocess")[0], 200, "PUT bucket")

    def put_inproc(name):
        return pool.put_object("inprocess", name, io.BytesIO(big[name]),
                               len(big[name])).etag

    got = run("put_inprocess", put_inproc, names, n_big * big_bytes,
              ("gf_encode_batched",))
    check(got == [etags[n] for n in names],
          "in-process ETags differ from the HTTP PUT's")

    # 3. a 3-part multipart upload, a CopyObject, SSE-C and CSV objects
    def multipart(_):
        st, _h, data = client.request("POST", f"/{bucket}/{mp_name}",
                                      query={"uploads": ""})
        ok(st, 200, "CreateMultipartUpload")
        uid = re.search(rb"<UploadId>([^<]+)</UploadId>", data).group(1)
        uid = uid.decode()
        pe = []
        for i, p in enumerate(parts):
            st, h, _ = client.request(
                "PUT", f"/{bucket}/{mp_name}",
                query={"partNumber": str(i + 1), "uploadId": uid}, body=p)
            ok(st, 200, f"UploadPart {i + 1}")
            pe.append(h["etag"].strip('"'))
        xml = "".join(f"<Part><PartNumber>{i + 1}</PartNumber><ETag>"
                      f"\"{e}\"</ETag></Part>" for i, e in enumerate(pe))
        st, _h, data = client.request(
            "POST", f"/{bucket}/{mp_name}", query={"uploadId": uid},
            body=f"<CompleteMultipartUpload>{xml}"
                 f"</CompleteMultipartUpload>".encode())
        ok(st, 200, f"CompleteMultipartUpload {data[:200]!r}")
        return pe, re.search(rb'<ETag>"([^"<]+)"</ETag>', data).group(1)

    (part_etags, mp_etag), = run("multipart", multipart, [0],
                                 sum(part_sizes), ("gf_encode_batched",),
                                 threads=1)
    mp_etag = mp_etag.decode()
    check(mp_etag == etag_from_parts(part_etags)
          and mp_etag.endswith(f"-{len(parts)}"), f"multipart ETag {mp_etag}")
    etags[mp_name] = mp_etag
    result["multipart"].update(parts=list(part_sizes), etag=mp_etag)
    st, _h, data = client.request(
        "PUT", f"/{bucket}/{copy_name}",
        headers={"x-amz-copy-source": f"/{bucket}/{names[0]}"})
    ok(st, 200, f"CopyObject {data[:200]!r}")
    bodies[copy_name] = big[names[0]]
    etags[copy_name] = re.search(rb'<ETag>"([^"<]+)"</ETag>',
                                 data).group(1).decode()
    result["copy"] = {"source": names[0], "etag": etags[copy_name]}

    def put_sse(name):
        st, h, data = client.request("PUT", f"/{bucket}/{name}",
                                     body=sse_objs[name],
                                     headers=sse_hdr[name])
        ok(st, 200, f"SSE-C PUT {name}: {data[:200]!r}")
        check(h.get("x-amz-server-side-encryption-customer-key-md5") ==
              sse_hdr[name]["x-amz-server-side-encryption-customer-key-md5"],
              "SSE-C PUT does not echo the key MD5")
        return name, h["etag"].strip('"')

    etags.update(run("put_sse", put_sse, sorted(sse_objs),
                     n_sse * sse_bytes,
                     ("gf_encode_batched", "highwayhash256_chunks",
                      "chacha20_xor")))

    def put_csv(name):
        st, h, _ = client.request("PUT", f"/{bucket}/{name}",
                                  body=csv[name])
        ok(st, 200, f"PUT {name}")
        return name, h["etag"].strip('"')

    etags.update(run("put_csv", put_csv, sorted(csv),
                     sum(map(len, csv.values())), ("gf_encode_batched",)))

    # 4. GET of everything, HEAD, ranged GETs, a presigned GET, listing
    def get(name, extra=None):
        h = dict(sse_hdr.get(name, {}), **(extra or {}))
        return client.request("GET", f"/{bucket}/{name}", headers=h)

    def get_exact(name):
        st, h, data = get(name)
        ok(st, 200, f"GET {name}")
        check(data == bodies[name], f"GET {name} is not exact")
        check(h["etag"].strip('"') == etags[name], f"GET {name} ETag")
        return len(data)

    run("get_plain", get_exact, names, n_big * big_bytes,
        ("highwayhash256_chunks",))

    def get_inproc(name):
        sink = PreallocSink()
        pool.get_object("inprocess", name, sink)
        return sink.getbuffer() == big[name]

    check(all(run("get_inprocess", get_inproc, names, n_big * big_bytes,
                  ("highwayhash256_chunks",))),
          "in-process GET is not exact")
    rest = sorted(set(bodies) - set(names))
    run("get_rest", get_exact, rest, sum(len(bodies[n]) for n in rest),
        ("highwayhash256_chunks", "chacha20_xor"))
    http_cost = {}
    for what in ("put", "get"):
        h, p = result[f"{what}_plain"], result[f"{what}_inprocess"]
        http_cost[what] = {"http_wall_s": h["wall_s"],
                           "inprocess_wall_s": p["wall_s"],
                           "http_over_inprocess": h["wall_s"] / p["wall_s"],
                           "http_gib_s": h["gib_s"],
                           "inprocess_gib_s": p["gib_s"]}
    result["http_cost"] = http_cost
    objs = [{"Key": n} for n in names]
    st, _h, data = client.request(
        "POST", "/inprocess", query={"delete": ""},
        body=("<Delete><Quiet>true</Quiet>" + "".join(
            f"<Object><Key>{o['Key']}</Key></Object>" for o in objs) +
            "</Delete>").encode())
    ok(st, 200, "DeleteObjects of the in-process objects")
    check(b"<Error>" not in data, f"DeleteObjects: {data[:300]!r}")
    ok(client.request("DELETE", "/inprocess")[0], 204, "DELETE bucket")

    t0 = time.monotonic()
    ranges = [(names[0], BLOCK - 500, 1000),
              (mp_name, part_sizes[0] - 777, 5000),
              (sorted(sse_objs)[0], BLOCK - 40_000, 80_000)]
    ranges = [(n, off, min(ln, len(bodies[n]) - off))
              for n, off, ln in ranges]
    for name, off, ln in ranges:
        st, h, data = get(name, {"range": f"bytes={off}-{off + ln - 1}"})
        ok(st, 206, f"ranged GET {name}")
        check(data == bodies[name][off:off + ln]
              and h["content-range"] ==
              f"bytes {off}-{off + ln - 1}/{len(bodies[name])}",
              f"ranged GET of {name} at {off} is not exact")
    for name in sorted(bodies):
        st, h, _ = client.request("HEAD", f"/{bucket}/{name}",
                                  headers=sse_hdr.get(name, {}))
        ok(st, 200, f"HEAD {name}")
        check(int(h["content-length"]) == len(bodies[name]),
              f"HEAD {name} Content-Length")
    url = presign_v4("GET", "http", client.host, f"/{bucket}/{names[1]}",
                     S3_ACCESS_KEY, S3_SECRET_KEY, S3_REGION, 600)
    split = urllib.parse.urlsplit(url)
    st, _h, data = client.send("GET", f"{split.path}?{split.query}", b"",
                               {"host": client.host})
    ok(st, 200, "presigned GET")
    check(data == big[names[1]], "presigned GET is not exact")
    listed, token, pages = [], "", 0
    while True:
        query = {"list-type": "2", "max-keys": str(S3_LIST_PAGE)}
        if token:
            query["continuation-token"] = token
        st, _h, data = client.request("GET", f"/{bucket}", query=query)
        ok(st, 200, "ListObjectsV2")
        pages += 1
        listed += [(k.decode(), int(s)) for k, s in re.findall(
            rb"<Key>([^<]+)</Key>.*?<Size>(\d+)</Size>", data)]
        m = re.search(rb"<NextContinuationToken>([^<]+)<", data)
        if b"<IsTruncated>true" not in data:
            break
        token = m.group(1).decode()
    check(listed == [(n, len(bodies[n])) for n in sorted(bodies)],
          f"ListObjectsV2 listed {len(listed)} objects, want {len(bodies)}")
    result["read_checks"] = {"wall_s": time.monotonic() - t0,
                             "ranged": [list(r) for r in ranges],
                             "heads": len(bodies), "list_pages": pages,
                             "listed": len(listed), "presigned": True}

    # 5. SelectObjectContent (Query A) on the CSV objects
    def select(name):
        st, _h, data = client.request(
            "POST", f"/{bucket}/{name}",
            query={"select": "", "select-type": "2"}, body=_request(QUERY_A))
        ok(st, 200, f"SelectObjectContent {name}")
        msgs = decode_messages(data)
        recs = b"".join(p for h, p in msgs
                        if h.get(":event-type") == "Records")
        a, b = csv_rows[name]
        check(recs == _expected_rows(table, a, b, "A"),
              f"Query A records of {name} differ from the expected rows")
        return recs.count(b"\n")

    matched = run("select", select, sorted(csv),
                  sum(map(len, csv.values())),
                  ("scan_codes", "highwayhash256_chunks"))
    result["select"]["rows_matched"] = sum(matched)

    # 6. drive loss: two drives of each set replaced by empty ones; the
    # degraded GETs feed the MRF, which heals in the background
    lost = [(s, i) for s in range(OL_SETS) for i in OL_LOST]
    backup = os.path.join(root, "backup")
    for s, i in lost:
        path = disk_dirs[s * (K + M) + i]
        shutil.copytree(os.path.join(path, bucket),
                        os.path.join(backup, f"s{s}d{i}"))
        shutil.rmtree(path)
        sets.sets[s]._disks[i] = XLStorage(path)
    t0 = time.monotonic()
    hb = pool.heal_bucket(bucket)
    check(hb.after_state.count("ok") == n_disks, f"heal_bucket: {hb}")
    result["heal_bucket"] = {"wall_s": time.monotonic() - t0}
    every = sorted(bodies)
    run("degraded_get", get_exact, every,
        sum(len(bodies[n]) for n in every),
        ("highwayhash256_chunks", "gf_matmul_batched", "chacha20_xor"))
    deadline = time.monotonic() + 60
    while set(every) - set(partial) and time.monotonic() < deadline:
        time.sleep(0.01)
    missing = sorted(set(every) - set(partial))
    check(not missing, f"no on_partial for {len(missing)} degraded GETs: "
          f"{missing[:3]}")

    def drain(_):
        deadline = time.monotonic() + 600
        while not (mrf.dq.q.empty() and set(heals.done) >= set(partial)):
            check(time.monotonic() < deadline, "the MRF did not drain")
            time.sleep(0.01)
        return True

    run("mrf_drain", drain, [0], 0, threads=1)
    st = mrf.stats()
    check(st["failed"] == 0 and st["dropped"] == 0,
          f"MRF stats {st}")
    walls = [heals.walls[o] for o in partial]
    waits = [heals.done[o] - queued_at[o] for o in partial]
    result["mrf"] = {
        "on_partial": len(partial),
        "modes": sorted({m for ms in partial.values() for m in ms}),
        "healed": st["healed"], "failed": st["failed"],
        "heal_p50_ms": _percentile(walls, 0.50) * 1e3,
        "heal_p99_ms": _percentile(walls, 0.99) * 1e3,
        "queued_to_healed_p50_ms": _percentile(waits, 0.50) * 1e3,
        "queued_to_healed_p99_ms": _percentile(waits, 0.99) * 1e3}
    for s, i in lost:
        healed = _files(os.path.join(disk_dirs[s * (K + M) + i], bucket))
        want_files = _files(os.path.join(backup, f"s{s}d{i}"))
        check(healed == want_files,
              f"MRF-healed drive {i} of set {s}: {len(healed)} files, "
              f"{sum(healed.get(p) != v for p, v in want_files.items())} "
              f"differ from the backup")
    result["mrf"]["byte_identical_files"] = sum(
        len(_files(os.path.join(backup, f"s{s}d{i}"))) for s, i in lost)

    # 7. bitrot: one flipped byte in a data shard; the GET stays exact, the
    # MRF heals the byte (deep)
    name = names[2]
    s = sets.get_hashed_set_index(name)
    dist = hash_order(f"{bucket}/{name}", K + M)
    i1 = dist.index(1)
    obj_dir = os.path.join(disk_dirs[s * (K + M) + i1], bucket, name)
    ddir = next(e for e in os.listdir(obj_dir) if e != "xl.meta")
    shard = os.path.join(obj_dir, ddir, "part.1")
    with open(shard, "rb") as f:
        pristine = f.read()
    with open(shard, "r+b") as f:
        f.seek(32 + 1000)
        f.write(bytes([pristine[32 + 1000] ^ 0x5A]))
    partial.clear()
    heals.done.clear()
    get_exact(name)
    # the read signals once its last byte is out, after the response
    deadline = time.monotonic() + 60
    while not partial and time.monotonic() < deadline:
        time.sleep(0.01)
    check(partial.get(name) == ["deep"], f"on_partial saw {partial}")
    drain(0)
    with open(shard, "rb") as f:
        check(f.read() == pristine, "the MRF did not restore the shard")
    result["bitrot"] = {"object": name, "set": s, "disk": i1,
                        "on_partial": partial[name], "restored": True}

    # 8. teardown: DeleteObjects on everything, then the bucket
    t0 = time.monotonic()
    st, _h, data = client.request(
        "POST", f"/{bucket}", query={"delete": ""},
        body=("<Delete>" + "".join(f"<Object><Key>{n}</Key></Object>"
                                   for n in every) + "</Delete>").encode())
    ok(st, 200, "DeleteObjects")
    deleted = data.count(b"<Deleted>")
    check(deleted == len(every) and b"<Error>" not in data,
          f"DeleteObjects deleted {deleted} of {len(every)}")
    st, _h, data = client.request("GET", f"/{bucket}",
                                  query={"list-type": "2"})
    check(b"<Key>" not in data, "objects left after DeleteObjects")
    ok(client.request("DELETE", f"/{bucket}")[0], 204, "DELETE bucket")
    result["teardown"] = {"wall_s": time.monotonic() - t0,
                          "deleted": deleted}
    client.close()
    srv.shutdown()

    launches = read_launches()
    result["launches"] = launches
    result["launch_sizes"] = read_launch_sizes()
    if device.type == "cuda":
        for kname in ("gf_matmul_batched", "gf_encode_batched",
                      "chacha20_xor", "highwayhash256_chunks",
                      "scan_codes"):
            check(launches[kname] > 0,
                  f"kernel {kname} never launched on the S3 server path")
    shutil.rmtree(root, ignore_errors=True)
    return result


#: the SSE-KMS path: objects per group (SSE-S3 and SSE-KMS under the
#: default ChaCha20 lane, SSE-S3 under AES-256-GCM), the SSE-KMS objects'
#: master key id and context, the host engine's timing calls per thread
KMS_OBJECTS = 32
KMS_KEY_ID = "smoke-tenant-key"
KMS_CONTEXT = b'{"tenant": "smoke", "path": ["kms", 1]}'
AES_ENGINE_THREADS = (1, 8)
AES_ENGINE_CALLS = 96
#: the host engine's known answer: SHA-256 of AES-256-GCM ciphertext || tag
#: of AES_KAT_PLAIN under the key, nonce and AAD below, computed with the
#: ``cryptography`` wheel's AESGCM (which the card's machine does not have)
AES_KAT_KEY = b"chip-smoke-aes-kat-key"
AES_KAT_NONCE = b"chip-smoke-aes-kat-nonce"
AES_KAT_AAD = b"minio-tpu-sse-v1\x00\x00\x00\x05"
AES_KAT_LEN = (64 << 10) + 5
AES_KAT_SHA256 = \
    "72b475dcec5e8a10a870b82ee029abcfdf52b6f893427750e50ab7b72283c639"


def aes_engine(calls: int) -> dict:
    """The host AES-256-GCM engine (native/aesgcm.cpp in libnative.so):
    its known answer, then seal and open GiB/s over blocks of 16 packages
    of 64 KiB (one native call each, as the package lane makes them) from
    1 and 8 threads."""
    import hashlib
    from minio_tpu_torch import native
    from minio_tpu_torch.crypto.aesgcm import AESGCM
    key = hashlib.sha256(AES_KAT_KEY).digest()
    nonce = hashlib.sha256(AES_KAT_NONCE).digest()[:12]
    plain = bytes((i * 7 + 3) & 0xFF for i in range(AES_KAT_LEN))
    sealed = AESGCM(key).encrypt(nonce, plain, AES_KAT_AAD)
    got = hashlib.sha256(sealed).hexdigest()
    check(got == AES_KAT_SHA256, f"AES-256-GCM known answer {got}")
    check(AESGCM(key).decrypt(nonce, sealed, AES_KAT_AAD) == plain,
          "AES-256-GCM does not open its own seal")
    pkgs = [plain[:64 << 10]] * 16
    blocks = [bytes(v) for v in native.aesgcm_seal_pkgs(key, nonce, 0,
                                                         pkgs)]
    out = {"known_answer": got, "build_flags": list(native.build_flags or ()),
           "package_bytes": 64 << 10, "packages_per_call": 16,
           "calls_per_thread": calls}
    for op, fn, arg in (("seal", native.aesgcm_seal_pkgs, pkgs),
                        ("open", native.aesgcm_open_pkgs, blocks)):
        for threads in AES_ENGINE_THREADS:
            def work(_):
                for j in range(calls):
                    fn(key, nonce, j * 16, arg)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=threads) as ex:
                list(ex.map(work, range(threads)))
            wall = time.perf_counter() - t0
            out[f"{op}_gib_s_{threads}t"] = \
                threads * calls * (16 << 16) / wall / 2**30
    return out


def phase_ssekms(device, n_objects: int, obj_bytes: int, seed: int) -> dict:
    """SSE-S3 and SSE-KMS over the S3 server path's deployment (one pool of
    two 16+4 sets, 40 disk directories, 1 MiB blocks, HighwayHash256S with
    16 KiB chunks), 32 signing clients, the process KMS a LocalKMS under a
    master key made from --seed (MINIO_TPU_KMS_MASTER_KEY): the host
    engine's known answer and rates; PUT, GET, ranged GET and HEAD of
    three groups of objects (SSE-S3 and SSE-KMS under a named key with a
    context on the default ChaCha20 lane, SSE-S3 with
    MINIO_TPU_SSE_CIPHER=aes-gcm); two drives per set replaced and a
    degraded GET of half of each group; a GET under a second master key (403), a KES
    endpoint on a closed loopback port (503 on GET and PUT); the admin KMS,
    quota and durability ops. Launch counts are reset once before the path
    and read after it. K1, K2, K4 and K5 must launch."""
    import base64
    import hashlib
    import uuid
    import numpy as np
    from minio_tpu_torch import native
    from minio_tpu_torch.crypto import kms as kms_mod
    from minio_tpu_torch.crypto import sse
    from minio_tpu_torch.objectlayer import ErasureSets, ServerPools
    from minio_tpu_torch.runtime.dispatch import global_queue
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.storage.xlstorage import XLStorage

    n_disks = OL_SETS * (K + M)
    root = _disk_root("ssekms")
    disk_dirs = [os.path.join(root, f"d{i:02d}") for i in range(n_disks)]
    gen = np.random.default_rng(seed + 11)
    dep = str(uuid.UUID(bytes=gen.bytes(16)))
    bucket = "kms"
    q = global_queue(device)
    reset_launches()
    result = {"deployment": f"1 pool x {OL_SETS} sets x {K + M} drives",
              "disks": n_disks, "geometry": f"{K}+{M}", "block": BLOCK,
              "chunk": CHUNK,
              "cut": "one process over local disk directories, clients "
                     "over the loopback interface, a LocalKMS in the "
                     "process"}
    t0 = time.monotonic()
    result["aes_engine"] = aes_engine(AES_ENGINE_CALLS
                                      if device.type == "cuda" else 4)
    result["aes_engine"]["seconds"] = time.monotonic() - t0
    old = _env({"MINIO_TPU_KMS_MASTER_KEY": hashlib.sha256(
        b"smoke-kms-master-%d" % seed).hexdigest()})
    old["MINIO_TPU_SSE_CIPHER"] = os.environ.pop("MINIO_TPU_SSE_CIPHER",
                                                 None)
    for var in [v for v in os.environ if v.startswith("MINIO_TPU_KMS_")
                and v != "MINIO_TPU_KMS_MASTER_KEY"]:
        old.setdefault(var, os.environ.pop(var))
    kms_mod.set_kms(None)
    sets = ErasureSets([XLStorage(d) for d in disk_dirs], OL_SETS, K + M,
                       dep, default_parity=M, block_size=BLOCK,
                       device=device)
    pool = ServerPools([sets])
    srv = S3Server(pool, "127.0.0.1", 0, access_key=S3_ACCESS_KEY,
                   secret_key=S3_SECRET_KEY, region=S3_REGION, device=device)
    srv.start_background()
    client = _S3Client(srv.port)
    kms_ctx = base64.b64encode(KMS_CONTEXT).decode()
    groups = {
        "s3_chacha20": ({"x-amz-server-side-encryption": "AES256"},
                        "auto", sse.CIPHER_CHACHA20),
        "kms_chacha20": ({"x-amz-server-side-encryption": "aws:kms",
                          "x-amz-server-side-encryption-aws-kms-key-id":
                              KMS_KEY_ID,
                          "x-amz-server-side-encryption-context": kms_ctx},
                         "auto", sse.CIPHER_CHACHA20),
        "s3_aes_gcm": ({"x-amz-server-side-encryption": "AES256"},
                       "aes-gcm", sse.CIPHER_AESGCM)}
    bodies = {g: {f"{g}/{j:04d}": gen.bytes(obj_bytes - (j % 2) * 333)
                  for j in range(n_objects)} for g in groups}
    everything = {n: b for g in bodies.values() for n, b in g.items()}

    def ok(status, want, what):
        check(status == want, f"{what}: HTTP {status}, want {want}")

    def run(label, fn, jobs, nbytes, kernels=()):
        _reset(q)
        client.latencies.clear()
        before = read_launches()
        aes = [_Clock(native, n) for n in ("aesgcm_seal_pkgs",
                                           "aesgcm_open_pkgs",
                                           "aesgcm_seal", "aesgcm_open")]
        with _HashClocks() as hashes:
            for c in aes:
                c.__enter__()
            try:
                t0 = time.monotonic()
                with ThreadPoolExecutor(max_workers=S3_THREADS) as ex:
                    res = list(ex.map(fn, jobs))
                wall = time.monotonic() - t0
            finally:
                for c in aes:
                    c.__exit__()
        row = _phase_row(q, nbytes, wall, hashes)
        after = read_launches()
        row["launches"] = {k: after[k] - before.get(k, 0) for k in after}
        row["aes_engine_s"] = {c.name: {"cpu_s": c.cpu_s,
                                        "thread_wall_s": c.wall_s,
                                        "calls": c.calls} for c in aes}
        lat = list(client.latencies)
        row.update(requests=len(lat), objects=len(jobs))
        if lat:
            row.update(request_p50_ms=_percentile(lat, 0.50) * 1e3,
                       request_p99_ms=_percentile(lat, 0.99) * 1e3)
        result[label] = row
        if device.type == "cuda":
            for name in kernels:
                check(row["launches"][name] > 0,
                      f"kernel {name} never launched in sse_kms {label}")
        return res

    ok(client.request("PUT", f"/{bucket}")[0], 200, "PUT bucket")
    walls = {}
    for g, (hdr, cipher_env, cipher) in groups.items():
        os.environ["MINIO_TPU_SSE_CIPHER"] = cipher_env
        want_resp = {k: v for k, v in hdr.items()
                     if k != "x-amz-server-side-encryption-context"}

        def put(name, hdr=hdr, want_resp=want_resp, g=g):
            st, h, data = client.request("PUT", f"/{bucket}/{name}",
                                         body=bodies[g][name], headers=hdr)
            ok(st, 200, f"{g} PUT {name}: {data[:200]!r}")
            for k, v in want_resp.items():
                check(h.get(k) == v, f"{g} PUT {name}: {k} is {h.get(k)}")
            return name

        def get(name, g=g, want_resp=want_resp):
            st, h, data = client.request("GET", f"/{bucket}/{name}")
            ok(st, 200, f"{g} GET {name}")
            check(data == bodies[g][name], f"{g} GET {name} is not exact")
            for k, v in want_resp.items():
                check(h.get(k) == v, f"{g} GET {name}: {k} is {h.get(k)}")
            return len(data)

        nbytes = sum(map(len, bodies[g].values()))
        # K4 runs for the ChaCha20 packages and envelopes only
        k4 = ("chacha20_xor",) if cipher == sse.CIPHER_CHACHA20 else ()
        run(f"put_{g}", put, sorted(bodies[g]), nbytes,
            ("gf_encode_batched", "highwayhash256_chunks") + k4)
        run(f"get_{g}", get, sorted(bodies[g]), nbytes,
            ("highwayhash256_chunks",) + k4)
        for name in sorted(bodies[g])[:2]:
            info = pool.get_object_info(bucket, name)
            check(info.internal.get(sse.META_CIPHER) == cipher,
                  f"{name} sealed with {info.internal.get(sse.META_CIPHER)}")
        walls[g] = {"cipher": cipher,
                    "put_wall_s": result[f"put_{g}"]["wall_s"],
                    "put_gib_s": result[f"put_{g}"]["gib_s"],
                    "get_wall_s": result[f"get_{g}"]["wall_s"],
                    "get_gib_s": result[f"get_{g}"]["gib_s"]}
    os.environ.pop("MINIO_TPU_SSE_CIPHER", None)
    result["by_cipher"] = walls

    # ranged GETs across a block and a package boundary, and HEADs
    t0 = time.monotonic()
    for g in groups:
        name = sorted(bodies[g])[1]
        body = bodies[g][name]
        for off, ln in ((BLOCK - 40_000, 80_000), (3 * (64 << 10) - 7, 100),
                        (len(body) - 5, 5)):
            ln = min(ln, len(body) - off)
            st, h, data = client.request(
                "GET", f"/{bucket}/{name}",
                headers={"range": f"bytes={off}-{off + ln - 1}"})
            ok(st, 206, f"{g} ranged GET {name}")
            check(data == body[off:off + ln] and h["content-range"] ==
                  f"bytes {off}-{off + ln - 1}/{len(body)}",
                  f"{g} ranged GET {name} at {off} is not exact")
        for name in sorted(bodies[g]):
            st, h, _ = client.request("HEAD", f"/{bucket}/{name}")
            ok(st, 200, f"{g} HEAD {name}")
            check(int(h["content-length"]) == len(bodies[g][name]),
                  f"{g} HEAD {name} Content-Length")
            check(h.get("x-amz-server-side-encryption") ==
                  groups[g][0]["x-amz-server-side-encryption"],
                  f"{g} HEAD {name} scheme header")
    result["read_checks"] = {"wall_s": time.monotonic() - t0,
                             "ranged": 3 * len(groups),
                             "heads": len(everything)}

    # drive loss: two drives per set replaced by empty ones, a degraded
    # GET of the first half of each group (K1 rebuilds, K5 verifies, K4
    # for ChaCha20; half keeps the path near a minute)
    for s in range(OL_SETS):
        for i in OL_LOST:
            path = disk_dirs[s * (K + M) + i]
            shutil.rmtree(path)
            sets.sets[s]._disks[i] = XLStorage(path)

    def get_any(name):
        st, _h, data = client.request("GET", f"/{bucket}/{name}")
        ok(st, 200, f"degraded GET {name}")
        check(data == everything[name], f"degraded GET {name} is not exact")
        return len(data)

    degraded = [n for g in groups
                for n in sorted(bodies[g])[:max(1, n_objects // 2)]]
    run("degraded_get", get_any, degraded,
        sum(len(everything[n]) for n in degraded),
        ("highwayhash256_chunks", "gf_matmul_batched", "chacha20_xor"))

    # the failure cases: a second master key, an unreachable KES
    probe = sorted(bodies["s3_chacha20"])[0]
    failures = {}
    kms_mod.set_kms(kms_mod.LocalKMS(hashlib.sha256(
        b"another-master-%d" % seed).digest()))
    for g in groups:
        st, _h, data = client.request("GET",
                                      f"/{bucket}/{sorted(bodies[g])[0]}")
        ok(st, 403, f"{g} GET under another master key")
        check(b"<Code>AccessDenied</Code>" in data,
              f"{g} GET under another master key: {data[:200]!r}")
    failures["other_master_get"] = 403
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{sk.getsockname()[1]}"
    kms_mod.set_kms(kms_mod.KESClient([dead], KMS_KEY_ID, timeout=2.0))
    for method, path, body, hdr in (
            ("GET", probe, b"", {}),
            ("PUT", "outage", b"x" * 100, groups["kms_chacha20"][0])):
        st, _h, data = client.request(method, f"/{bucket}/{path}",
                                      body=body, headers=hdr)
        ok(st, 503, f"{method} with the KES endpoint down")
        check(b"<Code>ServiceUnavailable</Code>" in data,
              f"{method} with the KES endpoint down: {data[:200]!r}")
        failures[f"kes_down_{method.lower()}"] = st
    kms_mod.set_kms(None)
    st, _h, data = client.request("GET", f"/{bucket}/{probe}")
    ok(st, 200, "GET after the KMS came back")
    check(data == everything[probe], "GET after the KMS came back")
    result["failures"] = failures

    # the admin ops of the slice
    admin = "/minio/admin/v3/"
    replies = {}
    for label, method, op, query, body in (
            ("kms_status", "GET", "kms/status", None, b""),
            ("kms_key_create", "POST", "kms/key/create",
             {"key-id": "smoke-new-key"}, b""),
            ("kms_key_status", "GET", "kms/key/status",
             {"key-id": KMS_KEY_ID}, b""),
            ("set_quota", "PUT", "set-bucket-quota", {"bucket": bucket},
             b'{"quota": 1099511627776}'),
            ("get_quota", "GET", "get-bucket-quota", {"bucket": bucket},
             b""),
            ("durability", "GET", "durability", None, b"")):
        st, _h, data = client.request(method, admin + op, query=query,
                                      body=body)
        ok(st, 200, f"admin {op}: {data[:200]!r}")
        replies[label] = json.loads(data)
    check(replies["kms_status"]["name"] == "local",
          f"kms/status {replies['kms_status']}")
    check(replies["kms_key_status"]["encryption-err"] == "" and
          replies["kms_key_status"]["decryption-err"] == "",
          f"kms/key/status {replies['kms_key_status']}")
    check(replies["get_quota"]["quota"] == 1 << 40,
          f"get-bucket-quota {replies['get_quota']}")
    result["admin"] = {k: v for k, v in replies.items()
                       if k in ("kms_status", "kms_key_status", "get_quota")}
    result["admin"]["durability_fsync"] = replies["durability"]["fsync"]

    client.close()
    srv.shutdown()
    _restore(old)
    kms_mod.set_kms(None)
    launches = read_launches()
    result["launches"] = launches
    result["launch_sizes"] = read_launch_sizes()
    if device.type == "cuda":
        for kname in ("gf_matmul_batched", "gf_encode_batched",
                      "chacha20_xor", "highwayhash256_chunks"):
            check(launches[kname] > 0,
                  f"kernel {kname} never launched on the SSE-KMS path")
    result["kernel_launches"] = {
        k: launches[k] for k in ("chacha20_xor", "gf_encode_batched",
                                 "highwayhash256_chunks",
                                 "gf_matmul_batched")}
    shutil.rmtree(root, ignore_errors=True)
    return result


#: the obs path: admission's gate for the burst, its bounded wait, the
#: burst's PUTs, and the planes' off/on turns: one discarded warm-up turn
#: after the burst, then one ABBA block (cut from three when the
#: background path came, to keep the script near 750 s)
OBS_MAX_REQUESTS = 4
OBS_MAX_WAIT_MS = 20
OBS_WARMUP = "on"
OBS_TURNS = ("off", "on", "on", "off")
#: the admin plane's torch.profiler session over a GET load, seconds
OBS_TRACE_S = 3.0
#: each plane's own switch, set to 0 for an "off" turn (the sampling
#: profiler's among them)
OBS_SWITCHES = ("MINIO_TPU_TIMELINE", "MINIO_TPU_DEVICE_OBS",
                "MINIO_TPU_TRACE_SPANS", "MINIO_TPU_PROFILER")
#: the config round trip over admin: the keys set, and their values
OBS_CONFIG = {("qos", "interactive_budget_ms"): "150",
              ("profiler", "hz"): "23"}
#: families the obs path's scrape must hold: kernel, lane, dispatch,
#: device_obs and qos groups
OBS_FAMILIES = ("minio_tpu_kernel_op_latency_seconds",
                "minio_tpu_kernel_op_duration_seconds",
                "minio_tpu_lane_flushes_total",
                "minio_tpu_dispatch_batches_total",
                "minio_tpu_device_obs_enabled", "minio_tpu_device_hbm_used",
                "minio_tpu_qos_admission_inflight",
                "minio_tpu_qos_class_latency_seconds",
                "minio_tpu_stage_share_of_wall",
                "minio_tpu_profiler_samples_total",
                "minio_tpu_profiler_overhead_ratio",
                "minio_tpu_profiler_role_samples_total",
                "minio_tpu_slo_burn_rate", "minio_tpu_slo_requests_total",
                "minio_tpu_workloads_sse_cipher")
#: and, on the card, the device plane's CUDA-event families
OBS_CARD_FAMILIES = ("minio_tpu_device_obs_stream_occupancy_ratio",
                     "minio_tpu_device_seconds_total",
                     "minio_tpu_kernel_achieved_gibs",
                     "minio_tpu_device_hbm_bytes_in_use")


def lint_exposition(text: str) -> dict:
    """The naming lint of tests/test_obs_naming.py over one exposition:
    every family snake_case under ``minio_tpu_``, one HELP and one TYPE
    before its first sample. Returns {family: type}."""
    import re
    name_re = re.compile(r"^minio_tpu_[a-z0-9]+(_[a-z0-9]+)*$")
    lines = [ln for ln in text.splitlines() if ln.strip()]
    helps, types, samples = {}, {}, []
    for i, ln in enumerate(lines):
        if ln.startswith("# HELP "):
            helps.setdefault(ln.split()[2], i)
        elif ln.startswith("# TYPE "):
            fam = ln.split()[2]
            check(fam not in types, f"duplicate # TYPE for {fam}")
            check(ln.split()[3] in ("gauge", "counter", "histogram",
                                    "summary", "untyped"), ln)
            types[fam] = (i, ln.split()[3])
        else:
            check(not ln.startswith("#"), f"unknown comment line {ln}")
            cut = min([len(ln)] + [ln.find(c) for c in "{ " if c in ln])
            samples.append((i, ln[:cut]))
    hist = {n[:-len("_bucket")] for _, n in samples
            if n.endswith("_bucket")}
    for i, name in samples:
        fam = next((name[:-len(suf)] for suf in ("_bucket", "_count",
                                                  "_sum")
                    if name.endswith(suf) and name[:-len(suf)] in hist),
                   name)
        check(bool(name_re.match(fam)), f"metric name {name}")
        check(fam in types and fam in helps and types[fam][0] < i
              and helps[fam] < i, f"{name} lacks a HELP/TYPE before it")
    return {f: t for f, (_, t) in types.items()}


def _admin_json(client, op: str, method: str = "GET", **query):
    """One admin op over the signing client; its JSON body."""
    import json as _json
    st, _h, data = client.request(method, f"/minio/admin/v3/{op}",
                                  query=query or None)
    check(st == 200, f"admin {op}: HTTP {st}, {data[:300]!r}")
    return _json.loads(data) if data else None


def obs_config(client) -> dict:
    """The config registry over admin: OBS_CONFIG set and read back with
    source "stored", the history listed, its oldest snapshot restored, and
    the defaults back; the profiler's rate follows both changes at once."""
    from minio_tpu_torch.obs import profiler
    t0 = time.monotonic()
    before = _admin_json(client, "get-config")
    for (sub, key), value in OBS_CONFIG.items():
        check(before[sub][key]["source"] == "default",
              f"{sub}.{key} is not at its default: {before[sub][key]}")
        _admin_json(client, "set-config-kv", "PUT", subsys=sub, key=key,
                    value=value)
    hz_set = profiler.base_hz()
    after = _admin_json(client, "get-config")
    for (sub, key), value in OBS_CONFIG.items():
        check(after[sub][key] == {**before[sub][key], "value": value,
                                  "source": "stored"},
              f"{sub}.{key} read back {after[sub][key]}")
    hist = _admin_json(client, "list-config-history")
    check(len(hist) == len(OBS_CONFIG), f"history {hist}")
    _admin_json(client, "restore-config-history", "PUT",
                restoreId=hist[-1]["restore_id"])
    restored = _admin_json(client, "get-config")
    check(restored == before, "the restore did not bring the defaults back")
    check(hz_set == float(OBS_CONFIG[("profiler", "hz")]) and
          profiler.base_hz() == profiler.DEFAULT_HZ,
          f"profiler.hz followed as {hz_set}, {profiler.base_hz()}")
    return {"set": {f"{sub}.{key}": v for (sub, key), v in
                    OBS_CONFIG.items()},
            "read_back": {f"{sub}.{key}": after[sub][key]
                          for sub, key in OBS_CONFIG},
            "history": [h["cause"] for h in hist],
            "restored": hist[-1]["restore_id"],
            "profiler_hz_set_then_restored": [hz_set, profiler.base_hz()],
            "history_after_restore": len(
                _admin_json(client, "list-config-history")),
            "wall_s": time.monotonic() - t0}


def profile_window(before: dict, sample_s0: float) -> dict:
    """The always-on profiler over one load, from ``before`` (an
    ``agg_snapshot(full=True)``) and the sampler's own seconds then:
    delta_report's role, subsystem, class and op shares, the observed pass
    rate beside the nominal one, the sampler's cost over the window and
    since it started, the lock-wait share and sites, the top leaf frames,
    and the dispatcher threads' top leaf frames."""
    import collections
    from minio_tpu_torch.obs import profiler
    rep = profiler.delta_report(before, n=8)
    after = profiler.agg_snapshot(full=True)
    spent = profiler._sampler.sample_seconds - sample_s0
    leaves: collections.Counter = collections.Counter()
    for stack, n in (after["stacks"] - before["stacks"]).items():
        if stack.startswith("role:dispatcher;"):
            leaves[stack.removesuffix(";[lockwait]").rsplit(";", 1)[-1]] \
                += n
    n_disp = sum(leaves.values())
    nominal = profiler.base_hz()
    return {
        "samples": rep["samples"], "duration_s": rep["duration_s"],
        "observed_hz": rep["sample_hz"], "nominal_hz": nominal,
        "observed_over_nominal": rep["sample_hz"] / nominal,
        "window_overhead_ratio": spent / rep["duration_s"],
        "overhead_ratio": profiler.status()["overhead_ratio"],
        "drops": rep["drops"], "roles": rep["roles"],
        "subsystems": rep["subsystems"], "classes": rep["classes"],
        "ops": rep["ops"], "lockwait_share": rep["lockwait_share"],
        "lock_contention": rep["lock_contention"],
        "top_frames": {f["frame"]: f["share"] for f in rep["top_frames"]},
        "dispatcher_samples": n_disp,
        "dispatcher_top_leaves": {leaf: round(n / n_disp, 4) for leaf, n in
                                  leaves.most_common(8)} if n_disp else {}}


def obs_lockrank(device, disk_dirs: list, dep: str, bodies: dict) -> dict:
    """The port's lockrank installed, a second ServerPools and S3Server
    built over the same drives (so their locks are created tracked), and
    one PUT and GET load of every object through it from S3_THREADS
    clients; the contended sites, the lock-wait shares and any cycle or
    held-across-flush report are the result (a report is a finding, not a
    failure). Uninstalled after."""
    from minio_tpu_torch.objectlayer import ErasureSets, ServerPools
    from minio_tpu_torch.obs import lockrank, profiler
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.storage.xlstorage import XLStorage
    names = sorted(bodies)
    os.environ["MINIO_TPU_LOCKRANK"] = "1"
    lockrank.clear()
    check(lockrank.install(), "the port's lockrank did not install")
    out: dict = {}
    try:
        sets = ErasureSets([XLStorage(d) for d in disk_dirs], OL_SETS, K + M,
                           dep, default_parity=M, block_size=BLOCK,
                           device=device)
        srv = S3Server(ServerPools([sets]), "127.0.0.1", 0,
                       access_key=S3_ACCESS_KEY, secret_key=S3_SECRET_KEY,
                       region=S3_REGION, device=device)
        srv.start_background()
        # the factory wrapped the new server's locks (else the segment
        # would measure nothing)
        check(isinstance(srv.qos_admission._lock, lockrank.TrackedLock),
              "the second server's locks are not tracked")
        client = _S3Client(srv.port)
        check(client.request("PUT", "/locks")[0] == 200, "PUT bucket locks")

        def put(name):
            st, _h, data = client.request("PUT", f"/locks/{name}",
                                          body=bodies[name])
            check(st == 200, f"lockrank PUT {name}: {st} {data[:200]!r}")

        def get(name):
            st, _h, data = client.request("GET", f"/locks/{name}")
            check(st == 200 and data == bodies[name],
                  f"lockrank GET {name}: {st}")

        for label, fn in (("put", put), ("get", get)):
            before = profiler.agg_snapshot(full=True)
            s0 = profiler._sampler.sample_seconds
            t0 = time.monotonic()
            with ThreadPoolExecutor(max_workers=S3_THREADS) as ex:
                list(ex.map(fn, names))
            out[label] = {"wall_s": time.monotonic() - t0,
                          **profile_window(before, s0)}
        client.close()
        srv.shutdown()
    finally:
        lockrank.uninstall()
        del os.environ["MINIO_TPU_LOCKRANK"]
    reps = lockrank.reports()
    out["graph"] = lockrank.stats()
    out["contended_sites"] = dict(sorted(
        lockrank.contended_sites().items(), key=lambda kv: -kv[1])[:16])
    out["lock_wait_top"] = profiler.lock_report(12)
    out["reports"] = [{k: r[k] for k in ("kind", "locks", "cycle", "what",
                                         "lock_sites", "thread") if k in r}
                      for r in reps[:16]]
    out["report_stacks"] = [r.get("stack") or [e["stack"] for e in
                                               r.get("edges", ())]
                            for r in reps[:4]]
    out["report_counts"] = {kind: sum(r["kind"] == kind for r in reps)
                            for kind in ("lock-order-cycle",
                                         "lock-held-across-blocking")}
    return out


def obs_slo_health(client, n_disks: int, card: str, device) -> dict:
    """The SLO plane, the health snapshot and the OBD report over admin."""
    slo = _admin_json(client, "slo")
    health = _admin_json(client, "health")
    info = _admin_json(client, "healthinfo")
    top = _admin_json(client, "profile")
    check(set(slo["classes"]) == {"interactive", "control", "background"},
          f"slo classes {sorted(slo['classes'])}")
    check(health["cluster"]["disks_total"] == n_disks and
          health["cluster"]["disks_faulty"] == 0,
          f"health {health['cluster']}")
    check(len(info["drives"]) == n_disks and "dispatch" in info,
          f"healthinfo drives {len(info['drives'])}, {sorted(info)}")
    if device.type == "cuda":
        check(info["dispatch"]["card"] == card.split(",")[0],
              f"healthinfo card {info['dispatch'].get('card')!r}")
    keep = ("requests", "errors", "slow", "availability", "latency_ok_ratio",
            "availability_burn", "latency_burn", "p50_s", "p99_s")
    node = health["nodes"][0]
    return {
        "slo": {cls: {"objective": ent["objective"],
                      "windows": {w: {k: v[k] for k in keep}
                                  for w, v in ent["windows"].items()},
                      "breach": ent["breach"],
                      "breach_profile": ent["breach_profile"]}
                for cls, ent in slo["classes"].items()},
        "health": {"cluster": health["cluster"],
                   "admission": node["qos"]["admission"],
                   "heal": node["heal"], "lanes": node["lanes"]},
        "healthinfo": {"keys": sorted(info), "drives": len(info["drives"]),
                       "write_256k_ms_max": max(
                           d.get("write_256k_ms", 0) for d in info["drives"]),
                       "card": info["dispatch"].get("card"),
                       "process": info["process"]},
        "profile_top": {k: top[k] for k in ("samples", "duration_s",
                                            "sample_hz", "roles",
                                            "subsystems", "lockwait_share")}}


def phase_obs(device, n_objects: int, obj_bytes: int, card: str,
              seed: int) -> dict:
    """The observability plane over the S3 server (module docstring, step
    10): the object layer path's deployment behind the port's S3Server,
    32 signing clients; stage attribution of PUT, GET and heal, the
    metrics scrape under the naming lint, a trace tree with its kernel
    span, the timeline, the device plane, an admission burst against a
    second server with 4 slots, and the object layer's walls with every
    plane off and on, in turns."""
    import json as _json
    import uuid
    import numpy as np
    from minio_tpu_torch.erasure.streaming import PreallocSink
    from minio_tpu_torch.objectlayer import ErasureSets, ServerPools
    from minio_tpu_torch.obs import attribution, device as dev_obs
    from minio_tpu_torch.obs import profiler, timeline
    from minio_tpu_torch.runtime.dispatch import global_queue
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.storage.xlstorage import XLStorage

    n_disks = OL_SETS * (K + M)
    root = _disk_root("obs")
    disk_dirs = [os.path.join(root, f"d{i:02d}") for i in range(n_disks)]
    gen = np.random.default_rng(seed + 4)
    dep = str(uuid.UUID(bytes=gen.bytes(16)))
    bucket = "obs"
    q = global_queue(device)
    sets = ErasureSets([XLStorage(d) for d in disk_dirs], OL_SETS, K + M,
                       dep, default_parity=M, block_size=BLOCK,
                       device=device)
    pool = ServerPools([sets])
    # the config registry is process-global and keeps the object layer
    # the first server attached (the S3 server path's, whose drives are
    # gone): detached, it takes this path's server's layer, as in a fresh
    # process, and keeps its subscribers
    from minio_tpu_torch.config import get_config_sys
    get_config_sys().obj = None
    srv = S3Server(pool, "127.0.0.1", 0, access_key=S3_ACCESS_KEY,
                   secret_key=S3_SECRET_KEY, region=S3_REGION, device=device)
    srv.start_background()
    srv.start_background_services()
    mrf = srv.mrf
    # the sampler runs since the first server: a fresh base aggregate
    # (its distinct-stack cap unspent) for this path's windows
    profiler.reset()
    partial: dict = {}
    for layer in srv._erasure_layers():
        add = layer.on_partial

        def record(b, o, v="", scan_mode="normal", _add=add):
            partial.setdefault(o, []).append(scan_mode)
            _add(b, o, v, scan_mode=scan_mode)

        layer.on_partial = record
    client = _S3Client(srv.port)
    bodies = {f"o/{j:04d}": gen.bytes(obj_bytes) for j in range(n_objects)}
    names = sorted(bodies)
    result = {"deployment": f"1 pool x {OL_SETS} sets x {K + M} drives",
              "geometry": f"{K}+{M}", "block": BLOCK, "objects": n_objects,
              "object_bytes": obj_bytes, "client_threads": S3_THREADS,
              "card": card, "cut": "one process over local disk "
                                   "directories, clients over loopback; "
                                   + CUT_S3_BIG}

    def run(label, fn, jobs, nbytes, kernels=(), threads=S3_THREADS):
        _reset(q)
        client.latencies.clear()
        before = read_launches()
        prof0 = profiler.agg_snapshot(full=True)
        spent0 = profiler._sampler.sample_seconds
        with _HashClocks() as hashes:
            t0 = time.monotonic()
            with ThreadPoolExecutor(max_workers=threads) as ex:
                res = list(ex.map(fn, jobs))
            wall = time.monotonic() - t0
        row = _phase_row(q, nbytes, wall, hashes)
        row["profiler"] = profile_window(prof0, spent0)
        after = read_launches()
        row["launches"] = {k: after[k] - before.get(k, 0) for k in after}
        lat = list(client.latencies)
        if lat:
            row.update(requests=len(lat),
                       request_p50_ms=_percentile(lat, 0.50) * 1e3,
                       request_p99_ms=_percentile(lat, 0.99) * 1e3)
        result[label] = row
        if device.type == "cuda":
            for name in kernels:
                check(row["launches"][name] > 0,
                      f"kernel {name} never launched in obs {label}")
        return res

    def ok(status, want, what):
        check(status == want, f"{what}: HTTP {status}, want {want}")

    def stages(op):
        rep = attribution.report().get(op)
        check(rep is not None and rep["count"] > 0, f"no {op} attribution")
        return {"count": rep["count"], "wall_p50_s": rep["wall_p50_s"],
                "wall_p99_s": rep["wall_p99_s"],
                "stages": {st: {k: v[k] for k in ("p50_s", "p99_s",
                                                   "share_of_wall")}
                           for st, v in rep["stages"].items()}}

    def get_exact(name):
        st, _h, data = client.request("GET", f"/{bucket}/{name}")
        ok(st, 200, f"GET {name}")
        check(data == bodies[name], f"GET {name} is not exact")
        return st

    reset_launches()
    # 0. the config registry over admin (every load below on defaults)
    result["config"] = obs_config(client)
    ok(client.request("PUT", f"/{bucket}")[0], 200, "PUT bucket")
    timeline.configure()
    attribution.reset()

    # 1. PUT and GET, with their stage attribution
    def put(name):
        st, _h, data = client.request("PUT", f"/{bucket}/{name}",
                                      body=bodies[name])
        ok(st, 200, f"PUT {name}: {data[:200]!r}")

    total = n_objects * obj_bytes
    run("put", put, names, total, ("gf_encode_batched",
                                   "highwayhash256_chunks"))
    run("get", get_exact, names, total, ("highwayhash256_chunks",))
    result["attribution"] = {"put": stages("put"), "get": stages("get")}

    # 2. two drives of each set replaced; degraded GETs feed the MRF,
    # drained; the heal stages
    for s in range(OL_SETS):
        for i in OL_LOST:
            path = disk_dirs[s * (K + M) + i]
            shutil.rmtree(path)
            sets.sets[s]._disks[i] = XLStorage(path)
    hb = pool.heal_bucket(bucket)
    check(hb.after_state.count("ok") == n_disks, f"heal_bucket: {hb}")
    run("degraded_get", get_exact, names, total,
        ("highwayhash256_chunks", "gf_matmul_batched"))
    deadline = time.monotonic() + 60
    while set(names) - set(partial) and time.monotonic() < deadline:
        time.sleep(0.01)
    check(not set(names) - set(partial), "degraded GETs missed the MRF")

    def drain(_):
        deadline = time.monotonic() + 600
        while mrf.stats()["healed"] + mrf.stats()["failed"] < len(partial) \
                or not mrf.dq.q.empty():
            check(time.monotonic() < deadline, "the MRF did not drain")
            time.sleep(0.01)
        return True

    run("mrf_drain", drain, [0], 0, ("gf_matmul_batched",), threads=1)
    check(mrf.stats()["failed"] == 0, f"MRF {mrf.stats()}")
    result["attribution"]["heal"] = stages("heal")

    # 3. the scrape, under the naming lint, with the data path's families
    t0 = time.monotonic()
    st, h, data = client.request("GET", "/minio/v2/metrics/node",
                                 query={"attribution": "1"})
    ok(st, 200, "metrics scrape")
    fams = lint_exposition(data.decode())
    want = OBS_FAMILIES + (OBS_CARD_FAMILIES if device.type == "cuda"
                           else ())
    missing = [f for f in want if f not in fams]
    check(not missing, f"scrape lacks {missing}")
    result["scrape"] = {"families": len(fams), "bytes": len(data),
                        "lint": "passed", "required": list(want),
                        "wall_s": time.monotonic() - t0}

    # 4. one stored trace tree by its trace id: a kernel span linked to
    # the request's spans
    st, _h, data = client.request("GET", "/minio/admin/v3/trace",
                                  query={"slow": "1", "count": "200"})
    ok(st, 200, "trace ?slow=1")
    slow = [e for e in _json.loads(data)
            if e["name"] in ("s3.getobject", "s3.putobject")]
    check(bool(slow), "no slow S3 trace kept")
    tid = slow[0]["trace_id"]
    st, _h, data = client.request("GET", "/minio/admin/v3/trace",
                                  query={"trace_id": tid})
    ok(st, 200, f"trace {tid}")
    tree = _json.loads(data)
    ids = {sp["span_id"] for sp in tree["spans"]}
    kspans = [sp for sp in tree["spans"] if sp["name"].startswith("kernel.")
              and any(ln["trace_id"] == tid and ln["span_id"] in ids
                      for ln in sp.get("links", ()))]
    check(bool(kspans), f"trace {tid} holds no kernel span linked to it")
    result["trace"] = {"trace_id": tid, "name": tree["name"],
                       "duration_s": tree["duration_s"],
                       "spans": len(tree["spans"]),
                       "kernel_spans": len(kspans),
                       "kernel_ops": sorted({sp["name"] for sp in kspans}),
                       "span_names": sorted({sp["name"]
                                             for sp in tree["spans"]})}

    # 5. the timeline: per-lane utilisation and queue-depth p99
    st, _h, data = client.request("GET", "/minio/admin/v3/timeline",
                                  query={"count": "1"})
    ok(st, 200, "timeline")
    tl = _json.loads(data)
    result["timeline"] = {"lanes": tl["utilization"]["lanes"],
                          "queue_depth": tl["utilization"]["queue_depth"],
                          "events_total": tl["events_total"],
                          "dropped_total": tl["dropped_total"]}

    # 6. the device plane: ledger balanced after the drain, builds and
    # first launches, GiB/s and roofline ratio per op, memory peak
    st, _h, data = client.request("GET", "/minio/admin/v3/device")
    ok(st, 200, "device")
    d = _json.loads(data)
    check(d["ledger_balanced"], f"ledger unbalanced: {d['ledger']}")
    for op, r in d["roofline"].items():
        check(r["roofline_ratio"] is None or r["roofline_ratio"] <= 1.05,
              f"roofline ratio of {op} is {r['roofline_ratio']}")
    if device.type == "cuda":
        check(bool(d["roofline"]), "no device time on the card")
        check(all(o["union_share"] is not None
                  for o in d["stream_occupancy"].values()),
              "no stream occupancy on the card")
    result["device"] = {
        "card": d["card"], "nvidia_smi": card,
        "ledger_balanced": d["ledger_balanced"], "ledger": d["ledger"],
        "builds": {k: d["compile"][k] for k in (
            "compiles_total", "compile_seconds_total", "storms_total",
            "first_launches_total", "launches_total")},
        "build_table": d["compile"]["table"],
        "launches_by_shape": d["compile"]["launches"],
        "roofline": d["roofline"],
        "stream_occupancy": d["stream_occupancy"],
        "memory": d["device_memory"], "host_bufpool": d["host_bufpool"]}

    # 6b. the admin plane's torch.profiler session over a GET load: the
    # device's own busy time as CUPTI records it beside the flushes'
    # CUDA-event intervals in the same window
    stop = threading.Event()

    def load(j):
        while not stop.is_set():
            get_exact(names[j % len(names)])
            j += S3_THREADS

    with ThreadPoolExecutor(max_workers=S3_THREADS) as ex:
        futs = [ex.submit(load, j) for j in range(S3_THREADS)]
        try:
            st, _h, data = client.request("GET", "/minio/admin/v3/device",
                                          query={"trace": str(OBS_TRACE_S)})
        finally:
            stop.set()
        for f in futs:
            f.result()
    ok(st, 200, "device?trace")
    tr = _json.loads(data)["trace"]
    check("error" not in tr, f"device trace: {tr}")
    shutil.rmtree(tr["logdir"], ignore_errors=True)
    prof_busy, occupied = tr["device_busy_s"], tr["flush_stream_occupancy_s"]
    if device.type == "cuda":
        check(tr["device_events"] > 0 and
              0.0 < tr["device_busy_share"] <= 1.0,
              f"the card's busy share is {tr['device_busy_share']} "
              f"({tr['device_events']} activity records)")
    result["profiled_get"] = {
        "window_s": tr["window_s"], "session_s": tr["seconds"],
        "device_events": tr["device_events"],
        "device_busy_s": prof_busy,
        "device_busy_share": tr["device_busy_share"],
        "device_idle_share": tr["device_idle_share"],
        "flush_stream_occupancy_s": occupied,
        "flush_stream_occupancy_share": occupied / tr["window_s"],
        "occupancy_over_device_busy": occupied / prof_busy if prof_busy
        else None,
        "top_device_names": dict(list(
            tr["device_seconds_by_name"].items())[:8])}

    # 7. admission: a second server on the same layer with 4 slots and a
    # 20 ms wait; a burst of PUTs whose clients honour Retry-After
    ok(client.request("PUT", "/burst")[0], 200, "PUT bucket")
    # (a rehearsal's few objects meet one slot)
    slots = max(1, min(OBS_MAX_REQUESTS, n_objects // 8))
    gate = S3Server(pool, "127.0.0.1", 0, access_key=S3_ACCESS_KEY,
                    secret_key=S3_SECRET_KEY, region=S3_REGION,
                    device=device, max_requests=slots)
    gate.start_background()
    burst = _S3Client(gate.port)
    seen = {"503": 0, "reset": 0, "retries": 0}
    lock = threading.Lock()

    def put_burst(name):
        import http.client
        while True:
            try:
                st, h, data = burst.request("PUT", f"/burst/{name}",
                                            body=bodies[name], expect=True)
            except (OSError, http.client.HTTPException):
                # a refusal that came after the body started (the 1 s
                # wait for the 100 ran out): the answer is lost with the
                # connection; wait the gate's Retry-After (1 s for a
                # concurrency reject)
                burst._drop()
                with lock:
                    seen["reset"] += 1
                    seen["retries"] += 1
                time.sleep(1.0)
                continue
            if st == 503:
                check(b"<Code>SlowDown</Code>" in data, "503 without SlowDown")
                with lock:
                    seen["503"] += 1
                    seen["retries"] += 1
                time.sleep(int(h["retry-after"]))
                continue
            ok(st, 200, f"burst PUT {name}: {data[:200]!r}")
            return

    os.environ["MINIO_TPU_QOS_MAX_WAIT_MS"] = str(OBS_MAX_WAIT_MS)
    try:
        t0 = time.monotonic()
        with ThreadPoolExecutor(max_workers=len(names)) as ex:
            list(ex.map(put_burst, names))
        burst_wall = time.monotonic() - t0
    finally:
        del os.environ["MINIO_TPU_QOS_MAX_WAIT_MS"]
    adm = gate.qos_admission.stats()
    burst.close()
    gate.shutdown()
    for name in names:
        sink = PreallocSink()
        pool.get_object("burst", name, sink)
        check(sink.getbuffer() == bodies[name], f"burst {name} not exact")
    result["admission"] = {
        "max_requests": slots, "max_wait_ms": OBS_MAX_WAIT_MS,
        "puts": len(names), "wall_s": burst_wall,
        "slowdown_503": adm["rejected"].get("interactive", 0),
        "client_saw_503": seen["503"],
        "client_saw_reset": seen["reset"], "admitted": adm["admitted"],
        "stored_exact": len(names)}
    check(adm["rejected"].get("interactive", 0) > 0,
          "the burst met no SlowDown")

    # 7b. lock order and lock waits under the port's lockrank, through a
    # second server over the same drives
    result["lockrank"] = obs_lockrank(device, disk_dirs, dep, bodies)

    # 8. the object layer's PUT and GET with every plane off and on, in
    # turns, each plane by its own switch: a warm-up turn after the burst
    # (dropped: the first turn after it is the slowest), then ABBA blocks
    walls = []
    try:
        for mode in (OBS_WARMUP, *OBS_TURNS):
            for sw in OBS_SWITCHES:
                if mode == "off":
                    os.environ[sw] = "0"
                else:
                    os.environ.pop(sw, None)
            timeline.configure()
            row = {"planes": mode}
            for what in ("put", "get"):
                def one(name, what=what):
                    if what == "put":
                        pool.put_object(bucket, name,
                                        io.BytesIO(bodies[name]),
                                        len(bodies[name]))
                        return True
                    sink = PreallocSink()
                    pool.get_object(bucket, name, sink)
                    return sink.getbuffer() == bodies[name]

                t0 = time.monotonic()
                with ThreadPoolExecutor(max_workers=S3_THREADS) as ex:
                    good = list(ex.map(one, names))
                row[f"{what}_wall_s"] = time.monotonic() - t0
                check(all(good), f"{what} with the planes {mode} not exact")
            walls.append(row)
    finally:
        for sw in OBS_SWITCHES:
            os.environ.pop(sw, None)
        timeline.configure()
    warmup, walls = walls[0], walls[1:]
    keys = ("put_wall_s", "get_wall_s")

    def mean_of(rows, mode, w):
        vals = [r[w] for r in rows if r["planes"] == mode]
        return sum(vals) / len(vals)

    blocks = [walls[i:i + 4] for i in range(0, len(walls), 4)]
    ratios = {w: [mean_of(b, "on", w) / mean_of(b, "off", w)
                  for b in blocks] for w in keys}
    result["planes_on_off"] = {
        "warmup_dropped": warmup, "turns": walls,
        "mean": {m: {w: mean_of(walls, m, w) for w in keys}
                 for m in ("off", "on")},
        "spread": {m: {w: [min(r[w] for r in walls if r["planes"] == m),
                           max(r[w] for r in walls if r["planes"] == m)]
                       for w in keys} for m in ("off", "on")},
        "on_over_off_by_block": ratios,
        "on_over_off": {w: mean_of(walls, "on", w) / mean_of(walls, "off", w)
                        for w in keys},
        "on_over_off_median": {w: statistics.median(r)
                               for w, r in ratios.items()}}
    check(dev_obs.ledger_balanced(), "ledger unbalanced after the turns")

    # 9. the SLO verdicts (the burst's 503s are in the 5 m window), the
    # health snapshot, the OBD report and the profiler's admin report
    result.update(obs_slo_health(client, n_disks, card, device))

    client.close()
    srv.shutdown()
    get_config_sys().obj = None
    launches = read_launches()
    result["launches"] = launches
    result["launch_sizes"] = read_launch_sizes()
    if device.type == "cuda":
        for kname in ("gf_matmul_batched", "gf_encode_batched",
                      "highwayhash256_chunks"):
            check(launches[kname] > 0,
                  f"kernel {kname} never launched on the obs path")
    shutil.rmtree(root, ignore_errors=True)
    return result


#: the background path: BG_BUCKETS hold BG_BIG objects of OBJECT_BYTES
#: under two levels of prefixes and BG_SMALL of OL_SMALL_BYTES; BG_NEW more
#: land in the first bucket between two normal cycles, BG_CORRUPT shard
#: files get a flipped byte before the deep cycle, two drives of each set
#: (BG_LOST, never the first, which holds the tracker and the MRF journal)
#: are wiped for the global heal, one drive (BG_TRIP: set 1, slot 7) trips
#: while BG_TRIP_PUTS objects land on its set; the wrapper's cost is the
#: in-process PUT and GET of BG_WRAP objects with MINIO_TPU_HEALTH off and
#: on, a warm-up turn then one ABBA block (three until the SSE-KMS path
#: came, to keep the script well inside its time limit); BG_BIG was 256
#: until the iam path came and 128 until the cluster path came, for the
#: same reason
BG_BUCKETS = ("logs", "media", "backup", "data")
BG_BIG = 64
CUT_BG_BIG = (f"{BG_BIG} big objects, not 256: cut to 128 when the iam "
              "path came and to 64 when the cluster path came")
BG_SMALL = 64
BG_NEW = 8
BG_CORRUPT = 16
BG_LOST = (3, 12)
BG_TRIP = (1, 7)
BG_TRIP_PUTS = 16
BG_WRAP = 64
BG_WARMUP = "on"
BG_TURNS = ("off", "on", "on", "off")
#: the usage tree's size classes: label, exclusive upper bound
BG_SIZE_CLASSES = (("LESS_THAN_1024_B", 1 << 10),
                   ("BETWEEN_1024_B_AND_1_MB", 1 << 20),
                   ("BETWEEN_1_MB_AND_10_MB", 10 << 20),
                   ("BETWEEN_10_MB_AND_64_MB", 64 << 20),
                   ("BETWEEN_64_MB_AND_128_MB", 128 << 20),
                   ("BETWEEN_128_MB_AND_512_MB", 512 << 20),
                   ("GREATER_THAN_512_MB", None))
#: the scrape's heal-plane families
BG_FAMILIES = ("minio_tpu_cluster_usage_object_total",
               "minio_tpu_bucket_usage_total_bytes",
               "minio_tpu_heal_disks_healing", "minio_tpu_disk_state",
               "minio_tpu_disk_health_ewma_seconds",
               "minio_tpu_durability_fsync_mode",
               "minio_tpu_durability_recovery_runs_total",
               "minio_tpu_scanner_cycles_total",
               "minio_tpu_scanner_objects_scanned_total",
               "minio_tpu_scanner_bytes_scanned_total")


def expected_usage(sizes: dict, depth: int) -> dict:
    """The usage document the scanner must write for objects of these
    sizes ({(bucket, name): bytes}), computed from the script's own data:
    per bucket its objects, bytes and versions (one each), the folders
    down to ``depth`` levels, and the size classes."""
    out: dict = {}
    for (bucket, name), n in sorted(sizes.items()):
        e = out.setdefault(bucket, {
            "objects": 0, "size": 0, "versions": 0, "prefixes": {},
            "histogram": {label: 0 for label, _ in BG_SIZE_CLASSES}})
        e["objects"] += 1
        e["size"] += n
        e["versions"] += 1
        folders = name.split("/")[:-1]
        for d in range(1, min(depth, len(folders)) + 1):
            p = e["prefixes"].setdefault("/".join(folders[:d]) + "/", {
                "objects": 0, "size": 0, "versions": 0})
            p["objects"] += 1
            p["size"] += n
            p["versions"] += 1
        label = next(lb for lb, hi in BG_SIZE_CLASSES
                     if hi is None or n < hi)
        e["histogram"][label] += 1
    return out


def _env(values: dict):
    """Set environment variables; returns their old values for _restore."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    return old


def _restore(old: dict) -> None:
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def phase_background(device, sizes: dict, card: str, seed: int) -> dict:
    """The background heal plane over the S3 server (module docstring,
    step 11): the data scanner's normal, tracker-skipping and deep cycles,
    the auto-heal monitor's global heal after a drive replacement, a health
    trip healed onto the re-onlined drive, an admin heal sequence, a
    restart, and the health wrapper's cost."""
    import json as _json
    import uuid
    import numpy as np
    from minio_tpu_torch.erasure.streaming import PreallocSink
    from minio_tpu_torch.objectlayer import ErasureSets, ServerPools
    from minio_tpu_torch.objectlayer.metadata import hash_order
    from minio_tpu_torch.obs import metrics as mx
    from minio_tpu_torch.runtime.dispatch import global_queue
    from minio_tpu_torch.scanner import autoheal, usage
    from minio_tpu_torch.scanner.scanner import DEEP_SCAN_EVERY
    from minio_tpu_torch.scanner.tracker import UpdateTracker, global_tracker
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.storage import health
    from minio_tpu_torch.storage.xlstorage import META_BUCKET, XLStorage

    n_big, big_bytes = sizes["big"]
    n_small, small_bytes = sizes["small"]
    n_disks = OL_SETS * (K + M)
    root = _disk_root("background")
    disk_dirs = [os.path.join(root, f"d{i:02d}") for i in range(n_disks)]
    gen = np.random.default_rng(seed + 5)
    dep = str(uuid.UUID(bytes=gen.bytes(16)))
    q = global_queue(device)
    # a tripped drive is probed every second
    old_env = _env({"MINIO_TPU_HEALTH_COOLDOWN_S": "1"})

    def build():
        sets = ErasureSets([XLStorage(d) for d in disk_dirs], OL_SETS,
                           K + M, dep, default_parity=M, block_size=BLOCK,
                           device=device)
        return sets, ServerPools([sets])

    t0 = time.monotonic()
    sets, pool = build()
    srv = S3Server(pool, "127.0.0.1", 0, access_key=S3_ACCESS_KEY,
                   secret_key=S3_SECRET_KEY, region=S3_REGION, device=device)
    srv.start_background()
    srv.start_background_services()
    client = _S3Client(srv.port)
    result = {"deployment": f"1 pool x {OL_SETS} sets x {K + M} drives",
              "disks": n_disks, "geometry": f"{K}+{M}", "block": BLOCK,
              "card": card, "setup_s": time.monotonic() - t0,
              "health_wrapper": type(sets.sets[0].disks[0]).__name__,
              "cut": "one process over local disk directories; the "
                     "scanner's cycles driven by the script; " + CUT_BG_BIG}
    check(result["health_wrapper"] == "DiskHealthCheck",
          "the sets' disks ride no health tracker")

    def run(label, fn, jobs, nbytes, kernels=(), threads=OL_PUT_THREADS):
        _reset(q)
        before = read_launches()
        with _HashClocks() as hashes:
            t0 = time.monotonic()
            with ThreadPoolExecutor(max_workers=threads) as ex:
                res = list(ex.map(fn, jobs))
            wall = time.monotonic() - t0
        row = _phase_row(q, nbytes, wall, hashes)
        after = read_launches()
        row["launches"] = {k: after[k] - before.get(k, 0) for k in after}
        result[label] = row
        if device.type == "cuda":
            for name in kernels:
                check(row["launches"][name] > 0,
                      f"kernel {name} never launched in background {label}")
        return res

    def scanned() -> float:
        return mx.counters_snapshot().get(
            "minio_tpu_scanner_objects_scanned_total", 0.0)

    def wait_for(cond, what, timeout=600.0):
        deadline = time.monotonic() + timeout
        while not cond():
            check(time.monotonic() < deadline, f"timed out: {what}")
            time.sleep(0.01)

    # the data: big objects under two levels of prefixes, small ones under
    # one, spread over the buckets
    bodies: dict = {}
    for j in range(n_big):
        b = BG_BUCKETS[j % len(BG_BUCKETS)]
        bodies[(b, f"y{j % 4}/m{j % 3}/obj-{j:04d}")] = gen.bytes(big_bytes)
    for j in range(n_small):
        b = BG_BUCKETS[j % len(BG_BUCKETS)]
        bodies[(b, f"small/s-{j:04d}")] = gen.bytes(small_bytes)

    def put(key):
        data = bodies[key]
        pool.put_object(key[0], key[1], io.BytesIO(data), len(data))
        return True

    def sizes_of() -> dict:
        return {k: len(v) for k, v in bodies.items()}

    reset_launches()
    for b in BG_BUCKETS:
        pool.make_bucket(b)
    keys = sorted(bodies)
    run("put", put, keys, sum(map(len, bodies.values())),
        ("gf_encode_batched", "highwayhash256_chunks"))

    # 1. a normal cycle: the snapshot, the trees and the histograms equal
    # what the script computes; the admin op serves the same
    sc = srv.scanner
    t0 = time.monotonic()
    n0 = scanned()
    snap = sc.scan_cycle()
    want1 = expected_usage(sizes_of(), 1)
    check(not snap["deep"], "the first cycle is deep")
    check(snap["objects_total"] == len(bodies)
          and snap["size_total"] == sum(map(len, bodies.values())),
          f"usage totals {snap['objects_total']} {snap['size_total']}")
    check(snap["buckets"] == want1, "the usage snapshot differs from the "
          "script's own count")
    st, _h, data = client.request("GET", "/minio/admin/v3/datausageinfo",
                                  query={"depth": "2"})
    check(st == 200, f"datausageinfo: HTTP {st}")
    doc = _json.loads(data)
    check(doc["buckets"] == expected_usage(sizes_of(), 2),
          "datausageinfo's trees differ from the script's own count")
    result["normal_cycle"] = {"wall_s": time.monotonic() - t0,
                              "objects_scanned": scanned() - n0,
                              "objects_total": snap["objects_total"],
                              "size_total": snap["size_total"],
                              "prefixes_depth2": sum(
                                  len(e["prefixes"])
                                  for e in doc["buckets"].values())}
    st, _h, data = client.request("GET", "/minio/v2/metrics/cluster")
    check(st == 200, f"metrics scrape: HTTP {st}")
    fams = lint_exposition(data.decode())
    missing = [f for f in BG_FAMILIES if f not in fams]
    check(not missing, f"scrape lacks {missing}")
    line = next(ln for ln in data.decode().splitlines()
                if ln.startswith("minio_tpu_cluster_usage_object_total "))
    check(float(line.split()[1]) == len(bodies), f"scrape: {line}")
    result["scrape"] = {"families": len(fams), "lint": "passed",
                        "required": list(BG_FAMILIES)}

    # 2. the tracker skip: new objects in one bucket; the next normal cycle
    # walks that bucket only
    new = {(BG_BUCKETS[0], f"new/n-{j:02d}"): gen.bytes(big_bytes)
           for j in range(sizes["new"])}
    bodies.update(new)
    run("put_new", put, sorted(new), len(new) * big_bytes,
        ("gf_encode_batched",))
    t0 = time.monotonic()
    n0 = scanned()
    snap = sc.scan_cycle()
    walked = scanned() - n0
    in_bucket = sum(1 for b, _n in bodies if b == BG_BUCKETS[0])
    check(walked == in_bucket, f"the cycle after the PUTs walked {walked} "
          f"objects, the written bucket holds {in_bucket}")
    check(snap["buckets"] == expected_usage(sizes_of(), 1),
          "the second snapshot differs from the script's own count")
    result["tracker_skip"] = {"wall_s": time.monotonic() - t0,
                              "objects_scanned": walked,
                              "objects_total": snap["objects_total"],
                              "buckets_reused": len(BG_BUCKETS) - 1}

    # 3. the deep cycle: a flipped byte in BG_CORRUPT shard files; the
    # deep verify queues each to the MRF, which heals it
    mrf = srv.mrf
    queued: list = []
    add = mrf.add_partial

    def record(b, o, v="", scan_mode="normal"):
        queued.append((b, o, scan_mode))
        add(b, o, v, scan_mode=scan_mode)

    mrf.add_partial = record
    corrupt = []
    for key in keys[:sizes["corrupt"]]:
        b, name = key
        s = sets.get_hashed_set_index(name)
        i = hash_order(f"{b}/{name}", K + M).index(1)
        d = sets.sets[s].disks[i]
        obj = os.path.join(disk_dirs[s * (K + M) + i], b, name)
        ddir = next(e for e in os.listdir(obj) if e != "xl.meta")
        with open(os.path.join(obj, ddir, "part.1"), "r+b") as f:
            f.seek(32 + 1000)
            c = f.read(1)
            f.seek(32 + 1000)
            f.write(bytes([c[0] ^ 0x5A]))
        corrupt.append((key, d))
    healed0, failed0 = mrf.healed, mrf.failed
    sc.cycle = DEEP_SCAN_EVERY - 1

    def deep(_):
        snap = sc.scan_cycle()
        wait_for(lambda: mrf.healed - healed0 >= len(corrupt)
                 and mrf.stats()["queued"] == 0, "the MRF heals")
        return snap

    (snap,) = run("deep_cycle", deep, [0], 0,
                  ("highwayhash256_chunks", "gf_matmul_batched"), threads=1)
    mrf.add_partial = add
    check(snap["deep"], "the deep cycle was not deep")
    want = sorted((k[0], k[1], "deep") for k, _d in corrupt)
    check(sorted(queued) == want, f"the deep cycle queued {queued}")
    check(mrf.failed == failed0, f"MRF failures: {mrf.stats()}")
    for (b, name), d in corrupt:
        d.verify_file(b, name, d.read_version(b, name))
    result["deep_cycle"].update(
        corrupted=len(corrupt), queued=len(queued),
        mrf_healed=mrf.healed - healed0, verified=len(corrupt),
        janitor=sc.janitor.last_stats)

    # 4. drive replacement: two drives of each set wiped, their healing
    # trackers set, the monitor kicked; the global heal from 128 workers
    mon = srv.autoheal
    timed = _TimedHeals(pool)
    mon.healer.obj = timed
    wiped = []
    for s in range(OL_SETS):
        for i in BG_LOST:
            path = disk_dirs[s * (K + M) + i]
            shutil.rmtree(path)
            XLStorage(path)  # a fresh drive's empty layout
            d = sets.sets[s].disks[i]
            autoheal.set_healing_tracker(d, {"reason": "replaced"})
            wiped.append((s, d))
    passes0 = mon.heal_passes
    healed_before = mon.healer.objects_healed

    def global_heal(_):
        mon.kick()
        wait_for(lambda: mon.heal_passes > passes0
                 and all(autoheal.get_healing_tracker(d) is None
                         for _s, d in wiped), "the global heal")
        return True

    total = sum(map(len, bodies.values()))
    run("global_heal", global_heal, [0], total,
        ("highwayhash256_chunks", "gf_matmul_batched"), threads=1)
    lat = list(timed.walls.values())
    healed = mon.healer.objects_healed - healed_before
    check(healed == len(bodies) and mon.healer.objects_failed == 0,
          f"global heal: {healed} healed, {mon.healer.objects_failed} "
          f"failed of {len(bodies)}")

    def verify(key):
        b, name = key
        s = sets.get_hashed_set_index(name)
        for ws, d in wiped:
            if ws == s:
                d.verify_file(b, name, d.read_version(b, name))
        return True

    # verify_file hashes on the host (the native engine), not on K5
    run("verify_replaced", verify, sorted(bodies), 0)
    result["global_heal"].update(
        objects=len(bodies), objects_healed=healed,
        heal_workers=mon.healer.concurrency,
        heal_p50_ms=_percentile(lat, 0.50) * 1e3,
        heal_p99_ms=_percentile(lat, 0.99) * 1e3,
        heal_max_ms=max(lat) * 1e3, wiped_drives=len(wiped),
        trackers_cleared=True)

    # 5. a health trip: one drive's root renamed away until its tracker
    # trips; PUTs to its set keep write quorum; renamed back, the probe
    # re-onlines it, on_disk_state sets its tracker and the monitor heals
    # the new objects onto it (the MRF is kept out of this step)
    s, i = BG_TRIP
    tripped = sets.sets[s].disks[i]
    path = disk_dirs[s * (K + M) + i]
    partial: list = []
    layers = srv._erasure_layers()
    for layer in layers:
        layer.on_partial = lambda b, o, v="", scan_mode="normal": \
            partial.append(o)
    os.rename(path, path + ".away")
    calls = 0
    while tripped.health_state() == "ok":
        calls += 1
        try:
            tripped.disk_info()
        except Exception:  # noqa: BLE001 — the missing root's error
            pass
    trip = {}
    j = 0
    while len(trip) < sizes["trip"]:
        name = f"trip/t-{j:03d}"
        if sets.get_hashed_set_index(name) == s:
            trip[(BG_BUCKETS[1], name)] = gen.bytes(big_bytes)
        j += 1
    bodies.update(trip)
    run("put_tripped", put, sorted(trip), len(trip) * big_bytes,
        ("gf_encode_batched",))
    check(len(set(partial)) == len(trip),
          f"{len(set(partial))} partial PUTs, want {len(trip)}")
    timed.walls.clear()
    passes0 = mon.heal_passes

    def reonline(_):
        t0 = time.monotonic()
        os.rename(path + ".away", path)
        wait_for(lambda: tripped.health_state() == "ok", "the re-online",
                 60)
        t_ok = time.monotonic()
        wait_for(lambda: mon.heal_passes > passes0
                 and autoheal.get_healing_tracker(tripped) is None,
                 "the heal onto the re-onlined drive")
        for b, name in trip:
            tripped.verify_file(b, name, tripped.read_version(b, name))
        return t_ok - t0, time.monotonic() - t_ok

    ((to_online, to_healed),) = run("trip_heal", reonline, [0], 0,
                                    ("gf_matmul_batched",), threads=1)
    for layer in layers:
        layer.on_partial = mrf.add_partial
    result["trip_heal"].update(
        disk=tripped.endpoint(), disk_info_calls_to_trip=calls,
        trips=tripped.trips, puts=len(trip),
        rename_to_reonline_s=to_online, reonline_to_healed_s=to_healed,
        objects_walked=len(timed.walls))

    # 6. an admin heal sequence of one bucket over signed HTTP, polled by
    # its token
    def admin_heal(_):
        st, _h, data = client.request(
            "GET", f"/minio/admin/v3/heal/{BG_BUCKETS[2]}")
        check(st == 200, f"admin heal: HTTP {st} {data[:200]!r}")
        seq = _json.loads(data)
        polls = 0
        while seq["status"] == "running":
            time.sleep(0.1)
            polls += 1
            st, _h, data = client.request(
                "GET", f"/minio/admin/v3/heal/{BG_BUCKETS[2]}",
                query={"clientToken": seq["clientToken"]})
            check(st == 200, f"heal poll: HTTP {st}")
            seq = _json.loads(data)
        return seq, polls

    ((seq, polls),) = run("admin_heal", admin_heal, [0], 0, threads=1)
    in_bucket = sum(1 for b, _n in bodies if b == BG_BUCKETS[2])
    check(seq["status"] == "done" and seq["scanned"] == in_bucket
          and seq["healed"] == in_bucket and seq["failed"] == 0,
          f"admin heal: {seq}")
    st, _h, data = client.request("GET", "/minio/admin/v3/bg-heal-status")
    bg = _json.loads(data)
    check(st == 200 and bg["autoheal"]["heal_passes"] >= 2,
          f"bg-heal-status: {bg}")
    result["admin_heal"].update(
        bucket=BG_BUCKETS[2], polls=polls,
        sequence={k: seq[k] for k in ("status", "scanned", "healed",
                                      "failed")},
        bg_heal_status=bg)

    # 7. a restart: the first server stops, a crash leaves staging behind,
    # a second server over the same directories recovers it and loads the
    # first's tracker and usage
    last_usage = sc.last_usage
    generation = global_tracker().generation
    client.close()
    srv.shutdown()
    for d in disk_dirs:
        stranded = os.path.join(d, META_BUCKET, "tmp", "crashed-put",
                                "part.1")
        os.makedirs(os.path.dirname(stranded))
        with open(stranded, "wb") as f:
            f.write(b"stranded by a crash")
    before = mx.counters_snapshot()
    t0 = time.monotonic()
    sets2, pool2 = build()
    srv2 = S3Server(pool2, "127.0.0.1", 0, access_key=S3_ACCESS_KEY,
                    secret_key=S3_SECRET_KEY, region=S3_REGION,
                    device=device)
    srv2.start_background()
    srv2.start_background_services()
    restart_s = time.monotonic() - t0
    after = mx.counters_snapshot()

    def delta(key):
        return after.get(key, 0.0) - before.get(key, 0.0)

    recovered = delta("minio_tpu_durability_recovered_tmp_total")
    runs = delta('minio_tpu_durability_recovery_runs_total{phase="startup"}')
    check(recovered >= n_disks and runs == OL_SETS,
          f"startup recovery swept {recovered} entries in {runs} runs")
    check(not any(os.listdir(os.path.join(d, META_BUCKET, "tmp"))
                  for d in disk_dirs), "tmp staging left after the restart")
    check(usage.load_usage(pool2) == last_usage,
          "the second server's usage is not the first's")
    loaded = UpdateTracker()
    loaded.attach_persistence(
        os.path.join(disk_dirs[0], META_BUCKET, "tracker.bin"))
    check(loaded.generation == generation,
          f"tracker generation {loaded.generation}, want {generation}")
    client2 = _S3Client(srv2.port)
    st, _h, data = client2.request("GET", "/minio/admin/v3/datausageinfo",
                                   query={"depth": "1"})
    check(st == 200 and _json.loads(data)["buckets"] ==
          last_usage["buckets"], "the second server serves other usage")
    client2.close()
    srv2.shutdown()
    result["restart"] = {"wall_s": restart_s,
                         "startup_recovery": {
                             "runs": runs, "tmp_swept": recovered,
                             "uploads_expired": delta(
                                 "minio_tpu_durability_expired_uploads"
                                 "_total")},
                         "tracker_generation": generation,
                         "usage_objects": last_usage["objects_total"]}

    # 8. the health wrapper's cost: the object layer's PUT and GET with
    # MINIO_TPU_HEALTH off and on, each turn on a set built under its
    # setting, a warm-up turn then ABBA blocks
    wrap = {("wrap", f"w-{j:03d}"): gen.bytes(big_bytes)
            for j in range(sizes["wrap"])}
    walls = []
    for mode in (BG_WARMUP, *BG_TURNS):
        old = _env({"MINIO_TPU_HEALTH": "0" if mode == "off" else "1"})
        try:
            wsets, wpool = build()
        finally:
            _restore(old)
        kind = type(wsets.sets[0].disks[0])
        check((kind is health.DiskHealthCheck) == (mode == "on"),
              f"MINIO_TPU_HEALTH {mode} built {kind.__name__} disks")
        if not walls:
            wpool.make_bucket("wrap")
        row = {"health": mode}
        for what in ("put", "get"):
            def one(key, what=what):
                if what == "put":
                    wpool.put_object(key[0], key[1], io.BytesIO(wrap[key]),
                                     len(wrap[key]))
                    return True
                sink = PreallocSink()
                wpool.get_object(key[0], key[1], sink)
                return sink.getbuffer() == wrap[key]

            t0 = time.monotonic()
            with ThreadPoolExecutor(max_workers=S3_THREADS) as ex:
                good = list(ex.map(one, sorted(wrap)))
            row[f"{what}_wall_s"] = time.monotonic() - t0
            check(all(good), f"{what} with the wrapper {mode} not exact")
        walls.append(row)
    warmup, walls = walls[0], walls[1:]
    wkeys = ("put_wall_s", "get_wall_s")

    def mean_of(rows, mode, w):
        vals = [r[w] for r in rows if r["health"] == mode]
        return sum(vals) / len(vals)

    blocks = [walls[i:i + 4] for i in range(0, len(walls), 4)]
    ratios = {w: [mean_of(b, "on", w) / mean_of(b, "off", w)
                  for b in blocks] for w in wkeys}
    result["wrapper_on_off"] = {
        "objects": len(wrap), "object_bytes": big_bytes,
        "threads": S3_THREADS, "warmup_dropped": warmup, "turns": walls,
        "on_over_off_by_block": ratios,
        "on_over_off_median": {w: statistics.median(r)
                               for w, r in ratios.items()},
        "on_over_off_spread": {w: [min(r), max(r)]
                               for w, r in ratios.items()}}
    _restore(old_env)

    launches = read_launches()
    result["launches"] = launches
    result["launch_sizes"] = read_launch_sizes()
    if device.type == "cuda":
        for kname in ("gf_matmul_batched", "gf_encode_batched",
                      "highwayhash256_chunks"):
            check(launches[kname] > 0,
                  f"kernel {kname} never launched on the background path")
    shutil.rmtree(root, ignore_errors=True)
    return result


#: the host path: HOST_OBJECTS objects of TPC-H lineitem text (each the
#: first row boundary at or past OBJECT_BYTES, so every body takes the MD5
#: lanes) PUT as .csv with compression on, HOST_RANGES ranged GETs; the
#: hedge segment's straggler delay on one drive of each set and its ABBA
#: turns (hedging on = A); the fault segment's objects
HOST_OBJECTS = 32
HOST_RANGES = 64
HOST_DELAY_MS = 300
HOST_TURNS = ("on", "off", "off", "on")
HOST_FAULT_OBJECTS = 8


def phase_hostpath(device, table: dict, n_objects: int, obj_bytes: int,
                   card: str, seed: int) -> dict:
    """The host pieces of the object path over the S3 server (module
    docstring, step 12): compressed lineitem objects with their MD5 lanes,
    hedged GETs behind a straggler in one ABBA block, and the fault plane's
    kernel, disk, bitrot and crash rules."""
    import hashlib
    import re
    import uuid
    import numpy as np
    from minio_tpu_torch import fault
    from minio_tpu_torch.config import get_config_sys
    from minio_tpu_torch.erasure import streaming
    from minio_tpu_torch.erasure.streaming import BufferSink
    from minio_tpu_torch.objectlayer import ErasureSets, ObjectOptions
    from minio_tpu_torch.objectlayer import ServerPools
    from minio_tpu_torch.objectlayer import datatypes as odt
    from minio_tpu_torch.obs import latency as lat_obs
    from minio_tpu_torch.obs.metrics import counters_snapshot
    from minio_tpu_torch.ops import rs_cuda
    from minio_tpu_torch.runtime.dispatch import global_queue
    from minio_tpu_torch.s3select.message import decode_messages
    from minio_tpu_torch.scanner.janitor import DurabilityJanitor
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.storage.xlstorage import XLStorage
    from minio_tpu_torch.utils import compress as cz
    from minio_tpu_torch.utils.md5simd import global_server

    n_disks = OL_SETS * (K + M)
    root = _disk_root("hostpath")
    disk_dirs = [os.path.join(root, f"d{i:02d}") for i in range(n_disks)]
    gen = np.random.default_rng(seed + 9)
    dep = str(uuid.UUID(bytes=gen.bytes(16)))
    bucket = "hostpath"
    q = global_queue(device)

    def layer():
        sets = ErasureSets([XLStorage(d) for d in disk_dirs], OL_SETS,
                           K + M, dep, default_parity=M, block_size=BLOCK,
                           device=device)
        return sets, ServerPools([sets])

    sets, pool = layer()
    get_config_sys().obj = None
    old_env = _env({"MINIO_TPU_COMPRESSION": "on"})
    fault.clear()
    srv = S3Server(pool, "127.0.0.1", 0, access_key=S3_ACCESS_KEY,
                   secret_key=S3_SECRET_KEY, region=S3_REGION, device=device)
    srv.start_background()
    srv.start_background_services()
    mrf = srv.mrf
    partial: dict = {}
    for el in srv._erasure_layers():
        add = el.on_partial

        def record(b, o, v="", scan_mode="normal", _add=add):
            partial.setdefault(o, []).append(scan_mode)
            _add(b, o, v, scan_mode=scan_mode)

        el.on_partial = record
    client = _S3Client(srv.port)
    text, offs = table["text"], table["offsets"]
    cuts = [0]
    for _ in range(n_objects):
        end = int(np.searchsorted(offs, offs[cuts[-1]] + obj_bytes))
        check(end < len(offs), "the lineitem table is too short for the "
              "host path's objects")
        cuts.append(end)
    names = [f"lineitem/part-{j:03d}.csv" for j in range(n_objects)]
    bodies = {n: bytes(text[offs[cuts[j]]:offs[cuts[j + 1]]])
              for j, n in enumerate(names)}
    rows_of = {n: (cuts[j], cuts[j + 1]) for j, n in enumerate(names)}
    total = sum(map(len, bodies.values()))
    result = {"deployment": f"1 pool x {OL_SETS} sets x {K + M} drives",
              "geometry": f"{K}+{M}", "block": BLOCK, "objects": n_objects,
              "plain_bytes": total, "client_threads": S3_THREADS,
              "card": card, "cut": "one process over local disk "
                                   "directories, clients over loopback"}

    def counters(name: str) -> dict:
        out = {}
        for k, v in counters_snapshot().items():
            if k.startswith(name + "{"):
                out[k[len(name):]] = out.get(k[len(name):], 0) + v
        return out

    def hedges() -> dict:
        c = counters("minio_tpu_hedged_reads_total")
        return {o: sum(v for k, v in c.items() if f'"{o}"' in k)
                for o in ("fired", "won", "lost")}

    def run(label, fn, jobs, nbytes, kernels=(), threads=S3_THREADS):
        _reset(q)
        client.latencies.clear()
        before = read_launches()
        with _HashClocks() as hashes:
            t0 = time.monotonic()
            with ThreadPoolExecutor(max_workers=threads) as ex:
                res = list(ex.map(fn, jobs))
            wall = time.monotonic() - t0
        row = _phase_row(q, nbytes, wall, hashes)
        after = read_launches()
        row["launches"] = {k: after[k] - before.get(k, 0) for k in after}
        lat = list(client.latencies)
        if lat:
            row.update(requests=len(lat),
                       request_p50_ms=_percentile(lat, 0.50) * 1e3,
                       request_p99_ms=_percentile(lat, 0.99) * 1e3)
        result[label] = row
        if device.type == "cuda":
            for name in kernels:
                check(row["launches"][name] > 0,
                      f"kernel {name} never launched in host {label}")
        return res

    def ok(status, want, what):
        check(status == want, f"{what}: HTTP {status}, want {want}")

    def get_exact(name):
        st, _h, data = client.request("GET", f"/{bucket}/{name}")
        ok(st, 200, f"GET {name}")
        check(data == bodies[name], f"GET {name} is not exact")

    reset_launches()
    ok(client.request("PUT", f"/{bucket}")[0], 200, "PUT bucket")

    # (a) compressed objects: PUT (ETag the plaintext's MD5 from the MD5
    # lanes), GET, ranged GETs, HEAD, list, copy, Query A
    def put(name):
        st, h, data = client.request("PUT", f"/{bucket}/{name}",
                                     body=bodies[name])
        ok(st, 200, f"PUT {name}: {data[:200]!r}")
        check(h.get("etag", "").strip('"') ==
              hashlib.md5(bodies[name]).hexdigest(),
              f"PUT {name}: the ETag is not the plaintext's MD5")

    lanes0 = global_server().stats()
    run("put", put, names, total, ("gf_encode_batched",
                                   "highwayhash256_chunks"))
    lanes1 = global_server().stats()
    rounds = lanes1["rounds"] - lanes0["rounds"]
    streams = sum((i + 1) * (a - b) for i, (a, b) in enumerate(
        zip(lanes1["lane_rounds"], lanes0["lane_rounds"])))
    check(rounds > 0, "the MD5 lanes ran no round")
    stored = {}
    for name in names:
        oi = pool.get_object_info(bucket, name)
        check(oi.internal.get(cz.META_COMPRESSION) == cz.ALGO_S2 and
              oi.actual_size == len(bodies[name]),
              f"{name} was not stored as an S2 stream")
        stored[name] = oi.size
    result["compression"] = {
        "algo": cz.ALGO_S2, "stored_bytes": sum(stored.values()),
        "stored_over_plain": sum(stored.values()) / total,
        "md5_lanes": {"rounds": rounds, "streams_per_round":
                      streams / rounds,
                      "bytes": lanes1["bytes_hashed"] -
                      lanes0["bytes_hashed"]}}
    run("get", get_exact, names, total, ("highwayhash256_chunks",))
    rng = np.random.default_rng(seed + 10)
    ranges = []
    for i in range(HOST_RANGES):
        name = names[i % n_objects]
        a = int(rng.integers(0, len(bodies[name]) - 1))
        b = min(len(bodies[name]) - 1, a + int(rng.integers(1, 2 << 20)))
        ranges.append((name, a, b))

    def ranged(r):
        name, a, b = r
        st, h, data = client.request("GET", f"/{bucket}/{name}",
                                     headers={"Range": f"bytes={a}-{b}"})
        ok(st, 206, f"ranged GET {name}")
        check(data == bodies[name][a:b + 1] and h.get("content-range") ==
              f"bytes {a}-{b}/{len(bodies[name])}",
              f"ranged GET {name} {a}-{b} is not exact")
        return b + 1 - a

    run("ranged_get", ranged, ranges,
        sum(b + 1 - a for _, a, b in ranges), ("highwayhash256_chunks",))
    t0 = time.monotonic()
    for name in names:
        st, h, _ = client.request("HEAD", f"/{bucket}/{name}")
        ok(st, 200, f"HEAD {name}")
        check(h.get("content-length") == str(len(bodies[name])),
              f"HEAD {name} does not give the plaintext length")
    st, _h, data = client.request("GET", f"/{bucket}",
                                  query={"list-type": "2",
                                         "prefix": "lineitem/"})
    ok(st, 200, "ListObjectsV2")
    listed = dict(re.findall(rb"<Key>([^<]*)</Key>.*?<Size>(\d+)</Size>",
                             data, re.S))
    check({k.decode(): int(v) for k, v in listed.items()} ==
          {n: len(b) for n, b in bodies.items()},
          "the listing does not give the plaintext sizes")
    copy_name = "copy/part-000.csv"
    st, _h, data = client.request(
        "PUT", f"/{bucket}/{copy_name}",
        headers={"x-amz-copy-source": f"/{bucket}/{names[0]}"})
    ok(st, 200, f"CopyObject: {data[:200]!r}")
    st, _h, data = client.request("GET", f"/{bucket}/{copy_name}")
    ok(st, 200, "GET of the copy")
    check(data == bodies[names[0]], "the copy is not exact")
    check(pool.get_object_info(bucket, copy_name).internal.get(
        cz.META_COMPRESSION) == cz.ALGO_S2, "the copy lost its markers")
    result["read_checks"] = {"wall_s": time.monotonic() - t0,
                             "heads": n_objects, "listed": len(listed),
                             "copy": copy_name}

    def select(name):
        st, _h, data = client.request(
            "POST", f"/{bucket}/{name}",
            query={"select": "", "select-type": "2"}, body=_request(QUERY_A))
        ok(st, 200, f"SelectObjectContent {name}")
        msgs = decode_messages(data)
        recs = b"".join(p for h, p in msgs
                        if h.get(":event-type") == "Records")
        a, b = rows_of[name]
        check(recs == _expected_rows(table, a, b, "A"),
              f"Query A records of {name} differ from the expected rows")
        stats = b"".join(p for h, p in msgs
                         if h.get(":event-type") == "Stats")
        check(b"<BytesScanned>%d</BytesScanned>" % stored[name] in stats,
              f"Query A over {name}: BytesScanned is not the stored size")
        return recs.count(b"\n")

    matched = run("query_a", select, names, total,
                  ("scan_codes", "highwayhash256_chunks"))
    result["query_a"]["rows_matched"] = sum(matched)
    check(sum(matched) > 0, "Query A matched no row")
    result["put"]["plain_gib_s"] = result["put"]["gib_s"]
    result["get"]["plain_gib_s"] = result["get"]["gib_s"]

    # (b) hedged reads: a straggler on one drive of each set, GETs from 32
    # clients with hedging on (the default adaptive threshold) and off,
    # one ABBA block; each turn starts from an empty shard-read window
    slow = [disk_dirs[s * (K + M)] for s in range(OL_SETS)]
    rule_ids = [fault.arm(f"disk:{d}:read_at:delay({HOST_DELAY_MS})")
                for d in slow]
    partial0 = sum(len(v) for v in partial.values())
    turns = []
    for i, setting in enumerate(HOST_TURNS):
        old = _env({"MINIO_TPU_HEDGE": "1" if setting == "on" else "0"})
        lat_obs.reset_window("hedge", op="shard_read")
        streaming._threshold_cache = (0.0, -1.0)
        h0 = hedges()
        thr0 = streaming.hedge_threshold_s()
        label = f"hedge_{i}_{setting}"
        try:
            run(label, get_exact, names, total,
                ("gf_matmul_batched",) if setting == "on" else ())
        finally:
            streaming._threshold_cache = (0.0, -1.0)
            thr1 = streaming.hedge_threshold_s()
            _restore(old)
        reads = lat_obs.get_window("hedge", op="shard_read").percentiles(
            (0.5, 0.95, 0.99))
        h1 = hedges()
        row = result.pop(label)
        turns.append({"setting": setting, "wall_s": row["wall_s"],
                      "get_p50_ms": row["request_p50_ms"],
                      "get_p99_ms": row["request_p99_ms"],
                      "threshold_start_s": thr0, "threshold_end_s": thr1,
                      "shard_read_s": {f"p{int(k * 100)}": v
                                       for k, v in reads.items()},
                      "hedges": {k: h1[k] - h0[k] for k in h1},
                      "k1_launches": row["launches"]["gf_matmul_batched"],
                      "stream_occupancy": row["stream_occupancy"]})
    for rid in rule_ids:
        fault.disarm(rid)
    straggler_partials = sum(len(v) for v in partial.values()) - partial0
    by = {s: [t for t in turns if t["setting"] == s] for s in ("on", "off")}
    result["hedge"] = {
        "delay_ms": HOST_DELAY_MS, "slow_drives": slow, "turns": turns,
        "on_partial": straggler_partials,
        "by_setting": {s: {"get_p50_ms": [t["get_p50_ms"] for t in ts],
                           "get_p99_ms": [t["get_p99_ms"] for t in ts],
                           "wall_s": [t["wall_s"] for t in ts]}
                       for s, ts in by.items()}}
    check(sum(t["hedges"]["fired"] for t in by["on"]) > 0,
          "no hedge fired behind the straggler")
    check(all(t["hedges"]["fired"] == 0 for t in by["off"]),
          "a hedge fired with hedging off")
    check(straggler_partials == 0,
          f"{straggler_partials} on_partial calls for a straggler")
    if device.type == "cuda":
        check(sum(t["k1_launches"] for t in by["on"]) > 0,
              "no hedged block was rebuilt by K1")

    # (c) the fault plane
    faults = {}
    extra = {f"fault/k-{i}.csv": bodies[names[i % n_objects]]
             for i in range(HOST_FAULT_OBJECTS)}
    bodies.update(extra)

    def put_status(name):
        st, _h, _d = client.request("PUT", f"/{bucket}/{name}",
                                    body=bodies[name])
        return st

    # one failed flush: on the card its requests fail (5xx), a CPU queue
    # salvages it; the next requests are right
    _reset(q)
    fault.arm("kernel:device:*:error@count=1")
    with ThreadPoolExecutor(max_workers=len(extra)) as ex:
        statuses = list(ex.map(put_status, sorted(extra)))
    fault.clear()
    st = q.stats()
    if device.type == "cuda":
        check(st["failed_batches"] == 1 and st["salvaged_batches"] == 0,
              f"kernel error: {st['failed_batches']} failed flushes")
        check(any(s >= 500 for s in statuses) and
              all(s == 200 or s >= 500 for s in statuses),
              f"kernel error: statuses {statuses}")
    else:
        check(st["salvaged_batches"] == 1 and all(s == 200
                                                  for s in statuses),
              f"kernel error on the CPU queue: {st['salvaged_batches']} "
              f"salvaged, statuses {statuses}")
    redo = [n for n, s in zip(sorted(extra), statuses) if s != 200]
    for name in redo:
        ok(put_status(name), 200, f"PUT {name} after the failed flush")
    for name in sorted(extra):
        get_exact(name)
    faults["kernel_error"] = {"statuses": statuses,
                              "failed_batches": st["failed_batches"],
                              "failed_items": st["failed_items"],
                              "salvaged_batches": st["salvaged_batches"],
                              "retried": len(redo)}
    # a delayed flush: right bytes
    fault.arm("kernel:device:*:delay(50)@count=8")
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=len(extra)) as ex:
        list(ex.map(get_exact, sorted(extra)))
    faults["kernel_delay"] = {"wall_s": time.monotonic() - t0,
                              "left": len(fault.rules())}
    fault.clear()
    # typed errors on one drive: PUT and GET keep quorum
    bad = disk_dirs[1]
    fault.arm(f"disk:{bad}:*:error(FaultyDisk)")
    more = {f"fault/d-{i}.csv": bodies[names[i % n_objects]]
            for i in range(4)}
    bodies.update(more)
    t0 = time.monotonic()
    for name in sorted(more):
        ok(put_status(name), 200, f"PUT {name} with a faulty drive")
    for name in sorted(more) + names[:4]:
        get_exact(name)
    injected = counters("minio_tpu_fault_injected_total")
    fault.clear()
    # the partial PUTs' heals (and their retries, once the drive's health
    # tracker lets it back) leave the MRF before the bitrot step
    mrf.drain(timeout=120)
    time.sleep(0.5)  # a heal popped just before the drain returned
    faults["disk_error"] = {"drive": bad, "wall_s": time.monotonic() - t0,
                            "injected_since_start": injected,
                            "mrf": mrf.stats()}
    # a bitrot rule on one read: the card's verify catches it, the GET
    # stays exact, the object reaches the MRF deep, and the MRF heals it
    before = mrf.stats()
    target = names[5 % n_objects]
    partial.pop(target, None)
    fault.arm(f"disk:{root}:read_at:bitrot@count=1")
    get_exact(target)
    fault.clear()
    deadline = time.monotonic() + 60
    while "deep" not in partial.get(target, []) and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    check("deep" in partial.get(target, []),
          "the bitrot read did not reach the MRF as a deep heal")
    while mrf.stats()["healed"] <= before["healed"]:
        check(time.monotonic() < deadline, "the MRF did not heal it")
        time.sleep(0.01)
    after = mrf.stats()
    get_exact(target)
    faults["bitrot"] = {"object": target, "on_partial": partial[target],
                        "mrf_healed": after["healed"] - before["healed"]}

    # a crash at pre_meta_write, then startup recovery: the object is
    # absent or whole
    client.close()
    srv.shutdown()
    body = bodies[names[6 % n_objects]]
    fault.arm(f"disk:{root}:pre_meta_write:crash")
    crashed = False
    try:
        pool.put_object(bucket, "crash.csv", io.BytesIO(body), len(body),
                        ObjectOptions())
    except fault.SimulatedCrash:
        crashed = True
    time.sleep(0.3)  # the other disks' commits reach the step too
    fault.clear()
    check(crashed, "the crash rule did not fire")
    sets2, pool2 = layer()
    for es in sets2.sets:
        DurabilityJanitor(es).sweep(tmp_age_s=0.0, reconcile=True,
                                    ddir_age_s=0.0)
    try:
        sink = BufferSink()
        pool2.get_object(bucket, "crash.csv", sink, 0, -1)
        state = "whole" if sink.getvalue() == body else "torn"
    except (odt.ObjectNotFound, odt.InsufficientReadQuorum):
        state = "absent"
    check(state in ("absent", "whole"), f"crash left the object {state}")
    faults["crash"] = {"step": "pre_meta_write", "after_recovery": state}
    result["faults"] = faults
    _restore(old_env)
    get_config_sys().obj = None
    launches = read_launches()
    result["launches"] = launches
    result["launch_sizes"] = read_launch_sizes()
    if device.type == "cuda":
        for kname in ("gf_matmul_batched", "gf_encode_batched",
                      "highwayhash256_chunks", "scan_codes"):
            check(launches[kname] > 0,
                  f"kernel {kname} never launched on the host path")
    shutil.rmtree(root, ignore_errors=True)
    return result


IAM_USERS = 200
IAM_GROUPS = 20
IAM_POLICIES = 40
IAM_SERVICE_ACCOUNTS = 16
IAM_BUCKETS = 40
#: objects per tenant: 4 until the cluster path came (the time limit)
IAM_OBJECTS = 2
CUT_IAM_OBJECTS = (f"{IAM_OBJECTS} objects a tenant, not 4: cut when the "
                   "cluster path came")
IAM_ABBA = 16
IAM_DENIED_BYTES = 64 << 10
IAM_LOST = (0, 9)
IAM_TURNS = ("root", "user", "user", "root")
IAM_GATE_CALLS = 20000
IAM_OPENID_SECRET = "smoke-openid-hs256-secret"
#: the 16 tenants' principal kinds: 8 users, 4 service accounts, 2
#: AssumeRole sessions under a narrowing session policy, 2 web-identity
#: sessions from the HS256 OpenID provider
IAM_KINDS = ("user",) * 8 + ("service_account",) * 4 + \
    ("sts_assume_role",) * 2 + ("sts_web_identity",) * 2


class _Receiver:
    """A loopback HTTP receiver of JSON POSTs (the audit webhook, the event
    webhook): ``record(doc)`` of every body, with its arrival time,
    appended to ``got``. ``stop`` closes the listener (senders then fail
    and retry), ``start`` binds the same port again."""

    def __init__(self, record, path: str):
        self.record = record
        self.path = path
        self.got: list = []
        self.lock = threading.Lock()
        self.port = 0
        self.start()

    def start(self):
        import http.server
        rx = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                doc = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                with rx.lock:
                    rx.got.append((*rx.record(doc), time.time()))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1",
                                                      self.port), H)
        self.port = self.httpd.server_port
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       name="smoke-receiver", daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.port}/{self.path}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)


def _hs256(claims: dict, secret: str) -> str:
    """An HS256 JWT, as a development OpenID provider signs one."""
    import base64
    import hashlib
    import hmac

    def b64(raw: bytes) -> str:
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()

    head = b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = b64(json.dumps(claims).encode())
    sig = hmac.new(secret.encode(), f"{head}.{body}".encode(),
                   hashlib.sha256).digest()
    return f"{head}.{body}.{b64(sig)}"


def phase_iam(device, sizes: dict, card: str, seed: int) -> dict:
    """The multi-tenant path (module docstring, step 13): IAM state made
    over the admin API, 16 principals of four kinds PUT, GET and degraded
    GET in their own buckets, refused in each other's, the bucket analytics
    against the clients' counts, the scanner's reconcile, and the audit log
    on a loopback webhook."""
    import http
    import re
    import urllib.parse
    import numpy as np
    from minio_tpu_torch.config import get_config_sys
    from minio_tpu_torch.madmin import AdminClient
    from minio_tpu_torch.objectlayer import ErasureObjects
    from minio_tpu_torch.obs import bucketstats
    from minio_tpu_torch.obs import logger as obs_logger
    from minio_tpu_torch.obs.metrics import counters_snapshot
    from minio_tpu_torch.runtime.dispatch import global_queue
    from minio_tpu_torch.scanner.scanner import DataScanner
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.storage.xlstorage import XLStorage

    n_obj, obj_bytes, n_abba = sizes["objects"], sizes["bytes"], \
        sizes["abba"]
    n_disks = K + M
    root = _disk_root("iam")
    disk_dirs = [os.path.join(root, f"d{i:02d}") for i in range(n_disks)]
    on_card = device.type == "cuda"
    # the card's entry points take no device argument; the rehearsal names
    # the host
    kw = {} if on_card else {"device": "cpu"}
    layer = ErasureObjects([XLStorage(d) for d in disk_dirs],
                           default_parity=M, block_size=BLOCK, **kw)
    q = global_queue(device)
    get_config_sys().obj = None
    bucketstats.reset()
    receiver = _Receiver(lambda doc: (doc.get("request_id", ""),
                                      doc.get("trace_id", ""),
                                      doc.get("api", "")), "audit")
    old_env = _env({"MINIO_TPU_AUDIT_WEBHOOK_ENDPOINT": receiver.url,
                    "MINIO_TPU_OPENID_HMAC_SECRET": IAM_OPENID_SECRET})
    obs_logger.reset()
    srv = S3Server(layer, "127.0.0.1", 0, access_key=S3_ACCESS_KEY,
                   secret_key=S3_SECRET_KEY, region=S3_REGION, **kw)
    iam = srv.enable_iam()
    srv.start_background()
    host = f"127.0.0.1:{srv.port}"
    result = {"deployment": f"1 set x {n_disks} drives", "geometry":
              f"{K}+{M}", "block": BLOCK, "bitrot": "HighwayHash256S",
              "card": card, "client_threads": S3_THREADS,
              "cut": "one process over local disk directories, clients "
                     "and the audit receiver over loopback; "
                     + CUT_IAM_OBJECTS}
    reset_launches()

    # every request the clients issue, by bucket: requests, body bytes the
    # server took in (a refused request's body is drained unread), bytes
    # on the wire back (status line, headers, body); and the request ids
    acct: dict = {}
    issued: list = []
    lock = threading.Lock()

    def wire_bytes(status: int, headers: dict, data: bytes) -> int:
        line = f"HTTP/1.1 {status} {http.HTTPStatus(status).phrase}\r\n"
        return len(line) + sum(len(f"{k}: {v}\r\n")
                               for k, v in headers.items()) + 2 + len(data)

    def call(client, method, path, body=b"", headers=None, query=None,
             signed=True):
        if signed:
            st, h, data = client.request(method, path, query=query,
                                         body=body, headers=headers)
        else:
            st, h, data = client.send(method, path, body, {
                "host": host, **(headers or {})})
        bucket = path.lstrip("/").split("/", 1)[0]
        with lock:
            issued.append(h.get("x-amz-request-id", ""))
            if bucket:
                row = acct.setdefault(bucket, [0, 0, 0])
                row[0] += 1
                row[1] += len(body) if 200 <= st < 300 else 0
                row[2] += wire_bytes(st, h, data)
        return st, h, data

    def ok(st, want, what):
        check(st == want, f"{what}: HTTP {st}, want {want}")

    admin_calls = [0]
    adm = AdminClient(srv.endpoint(), S3_ACCESS_KEY, S3_SECRET_KEY,
                      region=S3_REGION)

    def admin(fn, *args, **kwargs):
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        admin_calls[0] += 1
        return out, time.monotonic() - t0

    # IAM state over the admin API: every mutation rewrites state.json
    # through the erasure set's config plane
    tenants = [f"t{i:02d}" for i in range(len(IAM_KINDS))]
    buckets = tenants + [f"s{i:02d}" for i in range(len(tenants),
                                                    IAM_BUCKETS)]
    mut_walls: list = []
    for i, b in enumerate(buckets[:IAM_POLICIES]):
        doc = json.dumps({"Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Action": ["s3:*"],
            "Resource": [f"arn:aws:s3:::{b}", f"arn:aws:s3:::{b}/*"]}]})
        mut_walls.append(admin(adm.add_canned_policy, f"p{i:02d}",
                               doc.encode())[1])
    users = [f"u{i:03d}" for i in range(IAM_USERS)]
    secret = {u: f"{u}-secret-{seed % 1000:03d}" for u in users}
    for i, u in enumerate(users):
        # tenants' owners hold their tenant's policy; the AssumeRole
        # parents a broad one their session policy narrows
        kind = IAM_KINDS[i] if i < len(IAM_KINDS) else "spare"
        pol = ["readwrite"] if kind == "sts_assume_role" else \
            [f"p{i:02d}"] if kind in ("user", "service_account") else []
        mut_walls.append(admin(adm.add_user, u, secret[u], pol)[1])
    for g in range(IAM_GROUPS):
        members = users[g::IAM_GROUPS]
        mut_walls.append(admin(adm.add_user_to_group, f"g{g:02d}",
                               members)[1])
        mut_walls.append(admin(adm.set_policy, f"g{g:02d}",
                               [f"p{len(tenants) + g:02d}"],
                               group=True)[1])
    sa_creds = []
    for j in range(IAM_SERVICE_ACCOUNTS):
        parent = users[8 + j] if j < 4 else users[len(IAM_KINDS) + j]
        out, wall = admin(adm.add_service_account, parent)
        mut_walls.append(wall)
        sa_creds.append((out["accessKey"], out["secretKey"]))
    state = layer.get_config("iam/state.json")
    check(len(iam.users) == IAM_USERS + IAM_SERVICE_ACCOUNTS and
          len(iam.groups) == IAM_GROUPS and
          len(iam.policies) == IAM_POLICIES + 4,
          "the IAM state does not hold what the admin calls made")
    result["iam_state"] = {
        "users": IAM_USERS, "groups": IAM_GROUPS,
        "canned_policies": IAM_POLICIES,
        "service_accounts": IAM_SERVICE_ACCOUNTS,
        "mutations": len(mut_walls),
        "mutation_p50_ms": _percentile(mut_walls, 0.50) * 1e3,
        "mutation_p99_ms": _percentile(mut_walls, 0.99) * 1e3,
        "mutation_wall_s": sum(mut_walls),
        "state_json_bytes": len(state),
        "state_json_copies": sum(os.path.exists(os.path.join(
            d, ".minio.sys", "config", "iam", "state.json"))
            for d in disk_dirs)}

    # the buckets, by root, in order (the first top_n are tracked)
    rootc = _S3Client(srv.port)
    for b in buckets:
        ok(call(rootc, "PUT", f"/{b}")[0], 200, f"PUT bucket {b}")

    # the 16 principals' credentials
    principals = []
    for i, kind in enumerate(IAM_KINDS):
        if kind == "user":
            ak, sk = users[i], secret[users[i]]
        elif kind == "service_account":
            ak, sk = sa_creds[i - 8]
        elif kind == "sts_assume_role":
            session = json.dumps({"Statement": [{
                "Effect": "Allow", "Action": ["s3:*"],
                "Resource": [f"arn:aws:s3:::{tenants[i]}",
                             f"arn:aws:s3:::{tenants[i]}/*"]}]})
            parent = _S3Client(srv.port, users[i], secret[users[i]])
            form = urllib.parse.urlencode({
                "Action": "AssumeRole", "Version": "2011-06-15",
                "DurationSeconds": "3600", "Policy": session}).encode()
            st, _h, data = call(parent, "POST", "/", form, {
                "content-type": "application/x-www-form-urlencoded"})
            ok(st, 200, f"AssumeRole of {users[i]}")
            ak = re.search(rb"<AccessKeyId>([^<]+)<", data).group(1)
            sk = re.search(rb"<SecretAccessKey>([^<]+)<", data).group(1)
            ak, sk = ak.decode(), sk.decode()
            parent.close()
        else:
            token = _hs256({"sub": f"tenant-{i}", "exp": int(time.time())
                            + 3600, "policy": f"p{i:02d}"},
                           IAM_OPENID_SECRET)
            form = urllib.parse.urlencode({
                "Action": "AssumeRoleWithWebIdentity",
                "WebIdentityToken": token,
                "Version": "2011-06-15"}).encode()
            st, _h, data = call(rootc, "POST", "/", form, {
                "content-type": "application/x-www-form-urlencoded"},
                signed=False)
            ok(st, 200, f"AssumeRoleWithWebIdentity of tenant {i}")
            ak = re.search(rb"<AccessKeyId>([^<]+)<", data).group(1)
            sk = re.search(rb"<SecretAccessKey>([^<]+)<", data).group(1)
            ak, sk = ak.decode(), sk.decode()
        principals.append((kind, tenants[i], _S3Client(srv.port, ak, sk)))

    gen = np.random.default_rng(seed + 13)
    bodies = {(t, j): gen.bytes(obj_bytes) for t in tenants
              for j in range(n_obj)}
    # object-major: every wave of the 32 threads holds every principal
    # kind, so no kind waits behind another's requests
    jobs = [(p, j) for j in range(n_obj) for p in principals]

    def run(label, fn, items, nbytes, kernels=()):
        _reset(q)
        before = read_launches()
        with _HashClocks() as hashes:
            t0 = time.monotonic()
            with ThreadPoolExecutor(max_workers=S3_THREADS) as ex:
                res = list(ex.map(fn, items))
            wall = time.monotonic() - t0
        row = _phase_row(q, nbytes, wall, hashes)
        after = read_launches()
        row["launches"] = {k: after[k] - before.get(k, 0) for k in after}
        # per principal kind: requests, wall (first start to last end),
        # GiB/s and the request p50/p99
        kinds: dict = {}
        for kind, t0k, t1k, n in res:
            kinds.setdefault(kind, []).append((t0k, t1k, n))
        row["by_kind"] = {k: {
            "requests": len(v),
            "wall_s": max(e for _, e, _ in v) - min(s for s, _, _ in v),
            "gib_s": sum(n for *_, n in v) / 2**30 /
            (max(e for _, e, _ in v) - min(s for s, _, _ in v)),
            "p50_ms": _percentile([e - s for s, e, _ in v], 0.50) * 1e3,
            "p99_ms": _percentile([e - s for s, e, _ in v], 0.99) * 1e3}
            for k, v in sorted(kinds.items())}
        result[label] = row
        if on_card:
            for name in kernels:
                check(row["launches"][name] > 0,
                      f"kernel {name} never launched in iam {label}")
        return res

    def put(job):
        (kind, tenant, client), j = job
        t0 = time.monotonic()
        st, _h, data = call(client, "PUT", f"/{tenant}/obj-{j}",
                            bodies[(tenant, j)])
        ok(st, 200, f"{kind} PUT {tenant}/obj-{j}: {data[:200]!r}")
        return kind, t0, time.monotonic(), obj_bytes

    def get(job):
        (kind, tenant, client), j = job
        t0 = time.monotonic()
        st, _h, data = call(client, "GET", f"/{tenant}/obj-{j}")
        ok(st, 200, f"{kind} GET {tenant}/obj-{j}")
        check(data == bodies[(tenant, j)],
              f"{kind} GET {tenant}/obj-{j} is not exact")
        return kind, t0, time.monotonic(), obj_bytes

    total = len(jobs) * obj_bytes
    run("put", put, jobs, total, ("gf_encode_batched",
                                  "highwayhash256_chunks"))
    run("get", get, jobs, total, ("highwayhash256_chunks",))
    # two drives' copies of every tenant bucket taken away, then back
    aside = os.path.join(root, "offline")
    os.makedirs(aside, exist_ok=True)
    for i in IAM_LOST:
        for t in tenants:
            os.rename(os.path.join(disk_dirs[i], t),
                      os.path.join(aside, f"{i}-{t}"))
    run("degraded_get", get, jobs, total, ("gf_matmul_batched",
                                           "highwayhash256_chunks"))
    for i in IAM_LOST:
        for t in tenants:
            os.rename(os.path.join(aside, f"{i}-{t}"),
                      os.path.join(disk_dirs[i], t))

    # each principal's cross-tenant PUT and GET: 403 AccessDenied, and no
    # encode launched for the refused PUTs
    denied = {"put": [], "get": []}
    denied_body = gen.bytes(IAM_DENIED_BYTES)
    before = read_launches()
    for n, (kind, tenant, client) in enumerate(principals):
        other = tenants[(n + 1) % len(tenants)]
        st, _h, data = call(client, "PUT", f"/{other}/intruder",
                            denied_body)
        denied["put"].append(st)
        check(st == 403 and b"<Code>AccessDenied</Code>" in data,
              f"{kind} PUT into {other}: HTTP {st}")
    after = read_launches()
    k2_denied = after["gf_encode_batched"] - before["gf_encode_batched"]
    check(k2_denied == 0, f"the refused PUTs launched K2 {k2_denied} times")
    for n, (kind, tenant, client) in enumerate(principals):
        other = tenants[(n + 1) % len(tenants)]
        st, _h, data = call(client, "GET", f"/{other}/obj-0")
        denied["get"].append(st)
        check(st == 403 and b"<Code>AccessDenied</Code>" in data,
              f"{kind} GET from {other}: HTTP {st}")
    # an expired STS credential is refused
    parent = _S3Client(srv.port, users[0], secret[users[0]])
    form = urllib.parse.urlencode({"Action": "AssumeRole",
                                   "DurationSeconds": "900"}).encode()
    st, _h, data = call(parent, "POST", "/", form, {
        "content-type": "application/x-www-form-urlencoded"})
    ok(st, 200, "AssumeRole to expire")
    ak = re.search(rb"<AccessKeyId>([^<]+)<", data).group(1).decode()
    sk = re.search(rb"<SecretAccessKey>([^<]+)<", data).group(1).decode()
    expired = _S3Client(srv.port, ak, sk)
    ok(call(expired, "GET", f"/{tenants[0]}/obj-0")[0], 200,
       "GET with the fresh STS credential")
    iam.users[ak].expiration = time.time() - 1
    expired_st, _h, data = call(expired, "GET", f"/{tenants[0]}/obj-0")
    check(expired_st == 403 and b"InvalidAccessKeyId" in data,
          f"an expired STS credential answered HTTP {expired_st}")
    # a public-read bucket policy serves an anonymous GET
    public = buckets[len(tenants)]
    pub_body = gen.bytes(obj_bytes)
    ok(call(rootc, "PUT", f"/{public}/index.bin", pub_body)[0], 200,
       "PUT into the public bucket")
    anon = _S3Client(srv.port)
    ok(call(anon, "GET", f"/{public}/index.bin", signed=False)[0], 403,
       "anonymous GET before the bucket policy")
    pol = json.dumps({"Statement": [{
        "Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
        "Resource": f"arn:aws:s3:::{public}/*"}]}).encode()
    ok(call(rootc, "PUT", f"/{public}", pol, query={"policy": ""})[0], 204,
       "PUT bucket policy")
    anon_st, _h, data = call(anon, "GET", f"/{public}/index.bin",
                             signed=False)
    check(anon_st == 200 and data == pub_body,
          f"anonymous GET: HTTP {anon_st}")
    ok(call(anon, "PUT", f"/{public}/evil", b"x", signed=False)[0], 403,
       "anonymous PUT")
    # the spare buckets past the tracked ones take a small object each
    for b in buckets[bucketstats.top_n():]:
        ok(call(rootc, "PUT", f"/{b}/spare", gen.bytes(1000))[0], 200,
           f"PUT into {b}")
    result["denials"] = {"cross_tenant_put": denied["put"],
                         "cross_tenant_get": denied["get"],
                         "k2_launches_for_refused_puts": k2_denied,
                         "expired_sts": expired_st,
                         "anonymous_public_get": anon_st}

    # one ABBA block: root against an IAM user on the same PUTs; and the
    # policy gate alone, in process
    abba_client = {"root": rootc, "user": principals[0][2]}
    abba_keys = [f"abba/{j}" for j in range(n_abba)]
    abba_body = gen.bytes(obj_bytes)
    turns = []

    def abba_put(arg):
        who, key = arg
        t0 = time.monotonic()
        st, _h, _d = call(abba_client[who], "PUT", f"/{tenants[0]}/{key}",
                          abba_body)
        ok(st, 200, f"{who} PUT {key}")
        return time.monotonic() - t0

    for who in IAM_TURNS:
        t0 = time.monotonic()
        with ThreadPoolExecutor(max_workers=S3_THREADS) as ex:
            lat = list(ex.map(abba_put, [(who, k) for k in abba_keys]))
        wall = time.monotonic() - t0
        turns.append({"principal": who, "wall_s": wall,
                      "gib_s": n_abba * obj_bytes / wall / 2**30,
                      "p50_ms": _percentile(lat, 0.5) * 1e3,
                      "p99_ms": _percentile(lat, 0.99) * 1e3,
                      "mean_ms": statistics.fmean(lat) * 1e3})
    pairs = [(turns[1], turns[0]), (turns[2], turns[3])]
    gate = {}
    user_ak = principals[0][2].access_key
    for who, ak in (("root", S3_ACCESS_KEY), ("user", user_ak)):
        per_call = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(IAM_GATE_CALLS):
                srv.authorize(ak, "s3:PutObject", tenants[0], "abba/0")
            per_call.append((time.perf_counter() - t0) / IAM_GATE_CALLS)
        gate[who] = {"calls": 5 * IAM_GATE_CALLS,
                     "us_per_call_median": statistics.median(per_call) * 1e6,
                     "us_per_call_min": min(per_call) * 1e6,
                     "us_per_call_max": max(per_call) * 1e6}
    result["abba_root_vs_user"] = {
        "turns": turns,
        "user_over_root_wall": [u["wall_s"] / r["wall_s"] for u, r in pairs],
        "gate_cost_per_request_ms": [u["mean_ms"] - r["mean_ms"]
                                     for u, r in pairs],
        "gate_in_process": gate}
    kinds = result["put"]["by_kind"]
    kinds["root"] = {"requests": n_abba * 2,
                     "wall_s": turns[0]["wall_s"] + turns[3]["wall_s"],
                     "gib_s": 2 * n_abba * obj_bytes / 2**30 /
                     (turns[0]["wall_s"] + turns[3]["wall_s"]),
                     "p50_ms": statistics.median(
                         [turns[0]["p50_ms"], turns[3]["p50_ms"]]),
                     "p99_ms": max(turns[0]["p99_ms"], turns[3]["p99_ms"]),
                     "from": "the ABBA block's root turns"}

    # the bucket analytics against the clients' counts
    stats, _ = admin(adm.bucket_stats)
    top_n = stats["top_n"]
    tracked = buckets[:top_n]
    check(stats["tracked"] == len(tracked) and
          set(stats["buckets"]) == set(tracked) | {bucketstats.OVERFLOW},
          f"tracked buckets {sorted(stats['buckets'])}")
    want = {b: acct.get(b, [0, 0, 0]) for b in tracked}
    over = [0, 0, 0]
    for b, row in acct.items():
        if b not in tracked:
            over = [x + y for x, y in zip(over, row)]
    want[bucketstats.OVERFLOW] = over
    got = {b: [r["requests_total"], r["bytes_in"], r["bytes_out"]]
           for b, r in stats["buckets"].items()}
    for b in want:
        check(got[b] == want[b], f"bucketstats of {b}: server {got[b]}, "
                                 f"clients {want[b]}")
    check(over[0] > 0, "no request reached the _overflow_ row")
    # a scanner cycle snaps the live usage to the scanned usage. The live
    # deltas charge an overwrite as a new object (as the JAX package's
    # do): the first reconcile's drift is exactly the ABBA block's
    # overwritten PUTs in its bucket; a second cycle with no traffic in
    # between finds a drift of 0
    live = {b: r["usage"] for b, r in stats["buckets"].items()}
    scanner = DataScanner(layer, sleep_per_object=0)
    snap = scanner.scan_cycle()
    first, _ = admin(adm.bucket_stats)
    overwritten = (len(IAM_TURNS) - 1) * n_abba * obj_bytes
    check(first["drift_bytes"] == {tenants[0]: overwritten},
          f"first reconcile drift {first['drift_bytes']}, want "
          f"{ {tenants[0]: overwritten} }")
    snap = scanner.scan_cycle()
    after_scan, _ = admin(adm.bucket_stats)
    check(after_scan["drift_bytes"] == {},
          f"second reconcile drift {after_scan['drift_bytes']}")
    for b in tracked:
        check(after_scan["buckets"][b]["usage"]["bytes"] ==
              snap["buckets"].get(b, {}).get("size", 0),
              f"usage of {b} after reconcile")
    result["bucketstats"] = {
        "top_n": top_n, "tracked": stats["tracked"],
        "folds": stats["folds"],
        "overflow": {"requests": over[0], "bytes_in": over[1],
                     "bytes_out": over[2]},
        "tenants": {b: {"requests": got[b][0], "bytes_in": got[b][1],
                        "bytes_out": got[b][2]} for b in tenants},
        "matches_clients": True,
        "live_usage_bytes_before_scan": sum(
            u["bytes"] for u in live.values()),
        "scanned_bytes": snap["size_total"],
        "first_reconcile_drift": first["drift_bytes"],
        "reconcile_drift": after_scan["drift_bytes"]}

    # the audit log: one entry per request issued, none dropped
    target = obs_logger.log_sys().audit_target
    n_s3 = len(issued)
    expect = n_s3 + admin_calls[0]
    deadline = time.monotonic() + 120
    while target.sent + target.dropped < expect:
        check(time.monotonic() < deadline,
              f"the audit target sent {target.sent} of {expect}")
        time.sleep(0.05)
    with receiver.lock:
        got_ids = [row[:3] for row in receiver.got]
    dropped = sum(v for k, v in counters_snapshot().items()
                  if k.startswith("minio_tpu_log_target_dropped_total"))
    check(target.dropped == 0 and dropped == 0,
          f"the audit target dropped {target.dropped} entries")
    check(len(got_ids) == expect,
          f"the receiver got {len(got_ids)} audit entries, want {expect}")
    check(all(re.fullmatch("[0-9a-f]{32}", rid) and rid == tid
              for rid, tid, _api in got_ids),
          "an audit entry's request_id is not its trace id")
    check(set(issued) <= {rid for rid, _t, _a in got_ids},
          "a request the clients issued has no audit entry")
    result["audit"] = {"entries": len(got_ids), "s3_requests": n_s3,
                       "admin_requests": admin_calls[0],
                       "sent": target.sent, "dropped": target.dropped,
                       "retries": target.retries}

    for _kind, _t, client in principals:
        client.close()
    for c in (rootc, anon, parent, expired):
        c.close()
    srv.shutdown()
    obs_logger.reset()
    receiver.stop()
    _restore(old_env)
    get_config_sys().obj = None
    bucketstats.reset()
    launches = read_launches()
    result["launches"] = launches
    result["launch_sizes"] = read_launch_sizes()
    if on_card:
        for kname in ("gf_encode_batched", "gf_matmul_batched",
                      "highwayhash256_chunks"):
            check(launches[kname] > 0,
                  f"kernel {kname} never launched on the iam path")
    shutil.rmtree(root, ignore_errors=True)
    return result


BF_REPL = 64
BF_DEGRADED = 16
BF_THROTTLE = 16
BF_THROTTLE_BPS = 64 << 20
#: a second throttled bucket below what the replication pipeline moves on
#: this deployment (17-23 MB/s on an H100 host), so that its throttle
#: binds: objects and limit
BF_BINDING = 4
BF_BINDING_BPS = 8 << 20
BF_COLD = 32
BF_RESTORE = 8
BF_WORM = 16
BF_LOST = (2, 13)
BF_WORKERS = 8
BF_TURNS = ("tier", "local", "local", "tier")
#: the lifecycle pass sees every object this much older than it is: the
#: Transition rule's one day has passed
BF_AGE_S = 2 * 86400
BF_ARN = "arn:minio:sqs:us-east-1:smoke:webhook"
BF_EVENTS = ("s3:ObjectCreated:*", "s3:ObjectRemoved:*",
             "s3:ObjectAccessed:*")


def _notification_xml() -> bytes:
    events = "".join(f"<Event>{e}</Event>" for e in BF_EVENTS)
    return (f"<NotificationConfiguration><QueueConfiguration><Id>smoke</Id>"
            f"<Queue>{BF_ARN}</Queue>{events}</QueueConfiguration>"
            f"</NotificationConfiguration>").encode()


def _sizes_delta(before: dict, after: dict) -> dict:
    """One step's ``read_launch_sizes``: the path's histograms after it
    less those before it."""
    out = {}
    for name, hist in after.items():
        d = {b: v - before.get(name, {}).get(b, 0) for b, v in hist.items()}
        d = {b: v for b, v in d.items() if v}
        if d:
            out[name] = d
    return out


def phase_bucketfeatures(device, sizes: dict, card: str, seed: int) -> dict:
    """The bucket feature planes and events (module docstring, step 14):
    replication to a second server with its lag, a degraded source and a
    DELETE; the bandwidth throttle; lifecycle transition to a tier, GETs
    through it against local ones, restore and expiry; object lock; the
    events of all of it on a loopback webhook with an outage."""
    import calendar
    import urllib.parse
    import numpy as np
    from minio_tpu_torch.bucket import bandwidth as bw
    from minio_tpu_torch.bucket import transition as tx
    from minio_tpu_torch.bucket.lifecycle import LifecycleSys
    from minio_tpu_torch.bucket.replication import ReplicationPool, S3Target
    from minio_tpu_torch.config import get_config_sys
    from minio_tpu_torch.event import WebhookTarget
    from minio_tpu_torch.objectlayer import ErasureObjects
    from minio_tpu_torch.runtime.dispatch import global_queue
    from minio_tpu_torch.scanner.scanner import DataScanner
    from minio_tpu_torch.server import S3Server
    from minio_tpu_torch.storage.xlstorage import XLStorage

    obj_bytes = sizes["bytes"]
    n_disks = K + M
    root = _disk_root("bucketfeatures")
    src_dirs = [os.path.join(root, f"s{i:02d}") for i in range(n_disks)]
    dst_dirs = [os.path.join(root, f"t{i:02d}") for i in range(n_disks)]
    tier_dir = os.path.join(root, "tier")
    on_card = device.type == "cuda"
    kw = {} if on_card else {"device": "cpu"}
    q = global_queue(device)
    get_config_sys().obj = None
    src_layer = ErasureObjects([XLStorage(d) for d in src_dirs],
                               default_parity=M, block_size=BLOCK, **kw)
    dst_layer = ErasureObjects([XLStorage(d) for d in dst_dirs],
                               default_parity=M, block_size=BLOCK, **kw)
    src = S3Server(src_layer, "127.0.0.1", 0, access_key=S3_ACCESS_KEY,
                   secret_key=S3_SECRET_KEY, region=S3_REGION, **kw)
    dst = S3Server(dst_layer, "127.0.0.1", 0, access_key=S3_ACCESS_KEY,
                   secret_key=S3_SECRET_KEY, region=S3_REGION, **kw)
    receiver = _Receiver(lambda doc: (
        doc["EventName"], doc["Key"], doc["Records"][0]["eventTime"]),
        "events")
    notifier = src.enable_events([WebhookTarget("smoke", receiver.url)],
                                 queue_root=os.path.join(root, "events"))
    store = notifier.stores[BF_ARN]
    pool = ReplicationPool(src_layer, workers=BF_WORKERS).start()
    src.enable_replication(pool)
    src.start_background()
    dst.start_background()
    bw._monitor = None
    result = {"deployment": f"source 1 set x {n_disks} drives, target 1 "
                            f"set x {n_disks} drives",
              "geometry": f"{K}+{M}", "block": BLOCK,
              "bitrot": "HighwayHash256S", "card": card,
              "client_threads": S3_THREADS, "replication_workers": BF_WORKERS,
              "cut": "one process over local disk directories; both servers, "
                     "the tier (a directory) and the webhook on loopback; "
                     f"the lifecycle pass sees every object {BF_AGE_S} s "
                     "older than it is (a one-day Transition rule)"}
    reset_launches()
    gen = np.random.default_rng(seed + 16)
    clients = _S3Client(src.port)
    target_client = _S3Client(dst.port)
    #: what the webhook must receive: (event name, bucket/key) per
    #: successful request in a bucket with the notification configuration
    expected: list = []
    exp_lock = threading.Lock()

    def ok(st, want, what):
        check(st == want, f"{what}: HTTP {st}, want {want}")

    def expect(event: str, bucket: str, key: str):
        with exp_lock:
            expected.append((event, f"{bucket}/{key}"))

    def bucket(name: str, lock: bool = False):
        ok(clients.request("PUT", f"/{name}", headers={
            "x-amz-bucket-object-lock-enabled": "true"} if lock else None)[0],
           200, f"PUT bucket {name}")
        ok(clients.request("PUT", f"/{name}", query={"notification": ""},
                           body=_notification_xml())[0], 200,
           f"PUT {name}?notification")

    def put(name: str, key: str, data: bytes, headers=None):
        t0 = time.monotonic()
        st, h, body = clients.request("PUT", f"/{name}/{key}", body=data,
                                      headers=headers)
        ok(st, 200, f"PUT {name}/{key}: {body[:200]!r}")
        expect("s3:ObjectCreated:Put", name, key)
        return time.monotonic() - t0, h

    def get(name: str, key: str, want: bytes):
        t0 = time.monotonic()
        st, h, body = clients.request("GET", f"/{name}/{key}")
        ok(st, 200, f"GET {name}/{key}")
        check(body == want, f"GET {name}/{key} is not exact")
        expect("s3:ObjectAccessed:Get", name, key)
        return time.monotonic() - t0

    # charge (the notify hook, after the PUT's response) and landing (the
    # worker's replica PUT answered) of every replication, by (bucket, key)
    charged: dict = {}
    landed: dict = {}
    orig_event, orig_replicate = pool.on_event, pool._replicate

    def on_event(event, b, oi):
        if event.startswith("s3:ObjectCreated") and b in pool.targets:
            charged[(b, oi.name)] = time.monotonic()
        orig_event(event, b, oi)

    def replicate(b, key, op):
        orig_replicate(b, key, op)
        landed[(b, key, op)] = time.monotonic()

    pool.on_event, pool._replicate = on_event, replicate
    # the throttled reads: (time, bytes) of every MonitoredReader read
    reads: dict = {}
    orig_read = bw.MonitoredReader.read

    def timed_read(self, n=-1):
        data = orig_read(self, n)
        reads.setdefault(self.bucket, []).append((time.monotonic(),
                                                  len(data)))
        return data

    bw.MonitoredReader.read = timed_read
    # when each bucket's throttle was made: its first window opens then,
    # not at its first read (a token bucket starts full)
    made: dict = {}
    orig_throttle = bw.Monitor.throttle

    def timed_throttle(self, bucket_name, bytes_per_second):
        made.setdefault(bucket_name, time.monotonic())
        return orig_throttle(self, bucket_name, bytes_per_second)

    bw.Monitor.throttle = timed_throttle

    def step(label: str, fn, kernels=()):
        """One step inside the plane's instruments: its wall, the queue's
        flushes, stream occupancy and lanes' busy ratio, and its K1, K2
        and K5 launches by size."""
        _reset(q)
        before, sizes0 = read_launches(), read_launch_sizes()
        with _HashClocks() as hashes:
            t0 = time.monotonic()
            extra = fn() or {}
            wall = time.monotonic() - t0
        row = _phase_row(q, extra.pop("bytes", 0), wall, hashes)
        after = read_launches()
        row["launches"] = {k: after[k] - before.get(k, 0) for k in after}
        row["launch_sizes"] = {
            k: v for k, v in _sizes_delta(sizes0,
                                          read_launch_sizes()).items()
            if k in ("gf_matmul_batched", "gf_encode_batched",
                     "highwayhash256_chunks")}
        row.update(extra)
        result[label] = row
        if on_card:
            for name in kernels:
                check(row["launches"][name] > 0,
                      f"kernel {name} never launched in {label}")
        return row

    def wait_landed(keys, what, timeout=600):
        deadline = time.monotonic() + timeout
        while not all(k in landed for k in keys):
            check(pool.failed == 0, f"{pool.failed} replications failed")
            check(time.monotonic() < deadline,
                  f"{what}: {sum(k in landed for k in keys)} of "
                  f"{len(keys)} replicas landed")
            time.sleep(0.01)

    def lag_row(keys, nbytes):
        lags = [landed[(b, k, "put")] - charged[(b, k)] for b, k in keys]
        span = max(landed[(b, k, "put")] for b, k in keys) - \
            min(charged[(b, k)] for b, k in keys)
        return {"replicas": len(keys), "lag_p50_s": _percentile(lags, 0.5),
                "lag_p99_s": _percentile(lags, 0.99), "lag_max_s": max(lags),
                "replicated_gib_s": nbytes / span / 2**30,
                "charge_to_last_landed_s": span}

    # (a) replication: PUT, replica lag, bytes and ETags, degraded source,
    # delete replication
    n_repl, n_deg = sizes["repl"], sizes["degraded"]
    bucket("repl")
    pool.set_target("repl", S3Target(dst.endpoint(), S3_ACCESS_KEY,
                                     S3_SECRET_KEY, "repl"))
    bodies = {f"r{i:03d}": gen.bytes(obj_bytes) for i in range(n_repl)}

    def replication():
        with ThreadPoolExecutor(max_workers=S3_THREADS) as ex:
            lat = [t for t, _h in ex.map(lambda k: put("repl", k, bodies[k]),
                                         bodies)]
        keys = [("repl", k) for k in bodies]
        wait_landed([(b, k, "put") for b, k in keys], "replication")
        return {"bytes": len(bodies) * obj_bytes,
                "put_p50_ms": _percentile(lat, 0.5) * 1e3,
                "put_p99_ms": _percentile(lat, 0.99) * 1e3,
                **lag_row(keys, len(bodies) * obj_bytes)}

    step("replication", replication, ("gf_encode_batched",
                                      "highwayhash256_chunks"))
    etags = 0
    for k, want in bodies.items():
        st, h, data = target_client.request("GET", f"/repl/{k}")
        ok(st, 200, f"GET replica repl/{k}")
        check(data == want, f"replica repl/{k} is not exact")
        st, hs, _ = clients.request("HEAD", f"/repl/{k}")
        check(hs["etag"] == h["etag"],
              f"replica ETag {h['etag']} != source {hs['etag']}")
        etags += 1
    result["replication"]["replicas_exact_with_source_etag"] = etags
    # a degraded source: two drives' copies of the bucket away, then the
    # pool attached and resynced, so every read rebuilds (K1)
    bucket("repl-deg")
    deg = {f"d{i:03d}": gen.bytes(obj_bytes) for i in range(n_deg)}
    for k, v in deg.items():
        put("repl-deg", k, v)
    aside = os.path.join(root, "offline")
    os.makedirs(aside, exist_ok=True)
    for i in BF_LOST:
        os.rename(os.path.join(src_dirs[i], "repl-deg"),
                  os.path.join(aside, f"{i}"))

    def degraded():
        pool.set_target("repl-deg", S3Target(dst.endpoint(), S3_ACCESS_KEY,
                                             S3_SECRET_KEY, "repl-deg"))
        t0 = time.monotonic()
        for k in deg:
            charged[("repl-deg", k)] = t0
        check(pool.resync("repl-deg") == len(deg), "resync count")
        keys = [("repl-deg", k) for k in deg]
        wait_landed([(b, k, "put") for b, k in keys], "degraded resync")
        return {"bytes": len(deg) * obj_bytes, "drives_away": list(BF_LOST),
                **lag_row(keys, len(deg) * obj_bytes)}

    step("replication_degraded_source", degraded,
         ("gf_matmul_batched", "gf_encode_batched",
          "highwayhash256_chunks"))
    for i in BF_LOST:
        os.rename(os.path.join(aside, f"{i}"),
                  os.path.join(src_dirs[i], "repl-deg"))
    for k, want in deg.items():
        st, _h, data = target_client.request("GET", f"/repl-deg/{k}")
        check(st == 200 and data == want, f"replica repl-deg/{k}")
    # a DELETE with delete replication reaches the target
    gone = next(iter(bodies))
    st, _h, _d = clients.request("DELETE", f"/repl/{gone}")
    ok(st, 204, "DELETE repl object")
    expect("s3:ObjectRemoved:Delete", "repl", gone)
    wait_landed([("repl", gone, "delete")], "delete replication")
    st, _h, _d = target_client.request("GET", f"/repl/{gone}")
    check(st == 404, f"the replicated delete left the target's copy "
                     f"(HTTP {st})")
    result["replication"]["delete_reached_target"] = True
    result["replication"]["pool"] = {"replicated": pool.replicated,
                                     "failed": pool.failed}

    # (b) the bandwidth throttle: at a DR link's 64 MiB/s, and at a limit
    # below the pipeline's own rate, where it binds
    def throttled(name: str, limit: int, n: int):
        bucket(name)
        pool.set_target(name, S3Target(
            dst.endpoint(), S3_ACCESS_KEY, S3_SECRET_KEY, name,
            bandwidth_limit=limit))
        thr = {f"b{i:03d}": gen.bytes(obj_bytes) for i in range(n)}
        with ThreadPoolExecutor(max_workers=S3_THREADS) as ex:
            list(ex.map(lambda k: put(name, k, thr[k]), thr))
        keys = [(name, k) for k in thr]
        wait_landed([(b, k, "put") for b, k in keys], name)
        rs = reads[name]
        # the throttle's windows: the first opens when it is made, each
        # later one when a read takes a refill, at least a window after
        # the one before, so by a time t at most int((t - t0) / WINDOW_S)
        # + 1 windows' bytes can have been read
        t0 = made[name]
        per_window = max(1, int(limit * bw.WINDOW_S))
        moved, worst = 0, 0.0
        for t, n in rs:
            moved += n
            allowed = per_window * (int((t - t0) / bw.WINDOW_S) + 1)
            worst = max(worst, moved / allowed)
        span = rs[-1][0] - t0
        allowed_rate = per_window * (int(span / bw.WINDOW_S) + 1) / span
        check(worst <= 1.0, f"the throttle let {worst:.3f} of its windows' "
                            f"bytes through")
        rate = moved / span
        check(rate <= allowed_rate,
              f"throttled rate {rate} B/s over the windows' {allowed_rate}")
        return {"bytes": moved, "limit_bytes_s": limit,
                "measured_bytes_s": rate, "measured_over_limit":
                rate / limit, "windows_allow_bytes_s": allowed_rate,
                "throttled_span_s": span, "reads": len(rs),
                "worst_share_of_window_grants": worst,
                "monitor": bw.global_monitor().report([name]),
                **lag_row(keys, moved)}

    step("bandwidth_throttle", lambda: throttled(
        "throttle", sizes["throttle_bps"], sizes["throttle"]),
        ("gf_encode_batched", "highwayhash256_chunks"))
    step("bandwidth_throttle_binding", lambda: throttled(
        "throttle-low", sizes["binding_bps"], sizes["binding"]),
        ("gf_encode_batched", "highwayhash256_chunks"))

    # (c) lifecycle and transition to a tier
    n_cold = sizes["cold"]
    st, _h, data = clients.request(
        "PUT", "/minio/admin/v3/tier", body=json.dumps(
            {"kind": "fs", "name": "COLD", "dir": tier_dir}).encode())
    ok(st, 200, f"admin tier add: {data[:200]!r}")
    bucket("cold")
    bucket("hot")
    ok(clients.request("PUT", "/cold", query={"lifecycle": ""}, body=(
        b"<LifecycleConfiguration><Rule><ID>to-cold</ID><Status>Enabled"
        b"</Status><Filter><Prefix></Prefix></Filter><Transition><Days>1"
        b"</Days><StorageClass>COLD</StorageClass></Transition></Rule>"
        b"</LifecycleConfiguration>"))[0], 200, "PUT cold?lifecycle")
    half = n_cold // 2
    cold = {f"{'a' if i < half else 'b'}-{i:03d}": gen.bytes(obj_bytes)
            for i in range(n_cold)}
    hot = {f"h-{i:03d}": gen.bytes(obj_bytes) for i in range(n_cold)}
    with ThreadPoolExecutor(max_workers=S3_THREADS) as ex:
        list(ex.map(lambda kv: put("cold", *kv), cold.items()))
        list(ex.map(lambda kv: put("hot", *kv), hot.items()))

    class Aged(LifecycleSys):
        def apply(self, b, oi):
            oi.mod_time -= BF_AGE_S
            return super().apply(b, oi)

    lc = Aged(src_layer, src.bucket_meta, src.transition)
    scanner = DataScanner(src_layer, sleep_per_object=0, lifecycle=lc)

    def transition():
        scanner.scan_cycle()
        done = src.transition.transitioned
        check(done == n_cold, f"{done} of {n_cold} objects transitioned")
        for k in cold:
            oi = src_layer.get_object_info("cold", k)
            check(tx.is_transitioned(oi) and oi.size == 0,
                  f"cold/{k} is not a stub")
        tier_bytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _d, fs in os.walk(tier_dir) for f in fs)
        check(tier_bytes == n_cold * obj_bytes, f"tier holds {tier_bytes}")
        return {"bytes": n_cold * obj_bytes, "transitioned": done,
                "tier_bytes": tier_bytes}

    row = step("transition", transition, ("highwayhash256_chunks",))
    row["per_object_s"] = row["wall_s"] / n_cold
    # transitioned GETs against local GETs in ABBA turns, the webhook
    # down through the second turn (its deliveries queue, then drain)
    turns = []

    def abba():
        for n, which in enumerate(BF_TURNS):
            b, objs = ("cold", cold) if which == "tier" else ("hot", hot)
            if n == 1:
                receiver.stop()
                outage["stopped"] = time.time()
            t0 = time.monotonic()
            with ThreadPoolExecutor(max_workers=S3_THREADS) as ex:
                lat = list(ex.map(lambda kv: get(b, *kv), objs.items()))
            wall = time.monotonic() - t0
            if n == 1:
                outage["queued_at_restart"] = store._count
                receiver.start()
                outage["restarted"] = time.time()
            turns.append({"turn": which, "wall_s": wall,
                          "gib_s": len(objs) * obj_bytes / wall / 2**30,
                          "p50_ms": _percentile(lat, 0.5) * 1e3,
                          "p99_ms": _percentile(lat, 0.99) * 1e3})
        return {"bytes": 2 * n_cold * 2 * obj_bytes, "turns": turns,
                "tier_over_local_p50": [
                    turns[0]["p50_ms"] / turns[1]["p50_ms"],
                    turns[3]["p50_ms"] / turns[2]["p50_ms"]],
                "tier_over_local_p99": [
                    turns[0]["p99_ms"] / turns[1]["p99_ms"],
                    turns[3]["p99_ms"] / turns[2]["p99_ms"]]}

    outage: dict = {}
    step("transitioned_get_abba", abba, ("highwayhash256_chunks",))
    restored = list(cold)[:sizes["restore"]]

    def restore():
        lat = []
        for k in restored:
            t0 = time.monotonic()
            st, _h, data = clients.request(
                "POST", f"/cold/{k}", query={"restore": ""},
                body=b"<RestoreRequest><Days>2</Days></RestoreRequest>")
            ok(st, 202, f"restore cold/{k}: {data[:200]!r}")
            lat.append(time.monotonic() - t0)
        for k in restored:
            oi = src_layer.get_object_info("cold", k)
            check(oi.size == obj_bytes and tx.is_restored(oi),
                  f"cold/{k} is not restored")
        return {"bytes": len(restored) * obj_bytes, "restored": len(lat),
                "restore_p50_ms": _percentile(lat, 0.5) * 1e3,
                "restore_p99_ms": _percentile(lat, 0.99) * 1e3}

    step("restore", restore, ("gf_encode_batched", "highwayhash256_chunks"))
    for k in restored:
        get("cold", k, cold[k])
    # expiry of the b- half: its stubs and its tier copies go
    ok(clients.request("PUT", "/cold", query={"lifecycle": ""}, body=(
        b"<LifecycleConfiguration><Rule><ID>expire-b</ID><Status>Enabled"
        b"</Status><Filter><Prefix>b-</Prefix></Filter><Expiration><Date>"
        b"2020-01-01T00:00:00Z</Date></Expiration></Rule>"
        b"</LifecycleConfiguration>"))[0], 200, "PUT cold?lifecycle expiry")

    def expire():
        scanner.scan_cycle()
        gone = [k for k in cold if k.startswith("b-")]
        check(lc.expired == len(gone), f"{lc.expired} expired")
        for k in gone:
            st, _h, _d = clients.request("HEAD", f"/cold/{k}")
            check(st == 404, f"cold/{k} after expiry: HTTP {st}")
        tier_bytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _d, fs in os.walk(tier_dir) for f in fs)
        check(tier_bytes == (n_cold - len(gone)) * obj_bytes,
              f"tier holds {tier_bytes} after expiry")
        return {"expired": lc.expired, "tier_bytes_after": tier_bytes}

    step("expiry", expire)

    # (d) object lock: COMPLIANCE by default, GOVERNANCE with its bypass,
    # a legal hold on and off
    bucket("worm", lock=True)
    ok(clients.request("PUT", "/worm", query={"object-lock": ""}, body=(
        b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
        b"</ObjectLockEnabled><Rule><DefaultRetention><Mode>COMPLIANCE"
        b"</Mode><Days>1</Days></DefaultRetention></Rule>"
        b"</ObjectLockConfiguration>"))[0], 200, "PUT worm?object-lock")
    worm = {f"w{i:03d}": gen.bytes(obj_bytes) for i in range(sizes["worm"])}
    bypass = {"x-amz-bypass-governance-retention": "true"}

    def lock():
        vids = {}
        with ThreadPoolExecutor(max_workers=S3_THREADS) as ex:
            for k, (_t, h) in zip(worm, ex.map(
                    lambda kv: put("worm", *kv), worm.items())):
                vids[k] = h["x-amz-version-id"]
        denied = []
        for k, vid in vids.items():
            for hdr in (None, bypass):
                st, _h, data = clients.request(
                    "DELETE", f"/worm/{k}", query={"versionId": vid},
                    headers=hdr)
                check(st == 403, f"DELETE worm/{k} version: HTTP {st}")
                denied.append(st)
        until = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                              time.gmtime(time.time() + 86400))
        _t, h = put("worm", "gov", b"governance", {
            "x-amz-object-lock-mode": "GOVERNANCE",
            "x-amz-object-lock-retain-until-date": until})
        gvid = h["x-amz-version-id"]
        sts = {}
        sts["governance_delete"] = clients.request(
            "DELETE", "/worm/gov", query={"versionId": gvid})[0]
        sts["hold_on"] = clients.request(
            "PUT", "/worm/gov", query={"legal-hold": ""},
            body=b"<LegalHold><Status>ON</Status></LegalHold>")[0]
        sts["held_bypass_delete"] = clients.request(
            "DELETE", "/worm/gov", query={"versionId": gvid},
            headers=bypass)[0]
        sts["hold_off"] = clients.request(
            "PUT", "/worm/gov", query={"legal-hold": ""},
            body=b"<LegalHold><Status>OFF</Status></LegalHold>")[0]
        sts["bypass_delete"] = clients.request(
            "DELETE", "/worm/gov", query={"versionId": gvid},
            headers=bypass)[0]
        check(sts == {"governance_delete": 403, "hold_on": 200,
                      "held_bypass_delete": 403, "hold_off": 200,
                      "bypass_delete": 204}, f"object lock: {sts}")
        expect("s3:ObjectRemoved:Delete", "worm", "gov")
        st, _h, data = clients.request("GET", "/worm/w000",
                                       query={"retention": ""})
        check(st == 200 and b"<Mode>COMPLIANCE</Mode>" in data,
              "default retention")
        return {"bytes": len(worm) * obj_bytes, "versions": len(vids),
                "version_deletes_denied": len(denied), **sts}

    step("object_lock", lock, ("gf_encode_batched",
                               "highwayhash256_chunks"))

    # (e) the events of (a)-(d): every one delivered, none lost
    def drained():
        deadline = time.monotonic() + 120
        while True:
            with receiver.lock:
                n = len(receiver.got)
            if n >= len(expected) and store._count == 0:
                return
            check(time.monotonic() < deadline,
                  f"the webhook got {n} of {len(expected)} events, "
                  f"{store._count} queued")
            time.sleep(0.05)

    drained()
    with receiver.lock:
        got = list(receiver.got)
    from collections import Counter
    want_c = Counter(expected)
    got_c = Counter((e, k) for e, k, _t, _a in got)
    lost = sum((want_c - got_c).values())
    extra = sum((got_c - want_c).values())
    check(lost == 0, f"{lost} events lost: {list((want_c - got_c))[:5]}")
    check(extra == 0, f"{extra} events never issued")

    def event_s(stamp: str) -> float:
        base, _, ms = stamp.rstrip("Z").partition(".")
        return calendar.timegm(time.strptime(base, "%Y-%m-%dT%H:%M:%S")) + \
            int(ms or 0) / 1e3

    lat = [a - event_s(t) for _e, _k, t, a in got]
    calm = [a - event_s(t) for _e, _k, t, a in got
            if not outage["stopped"] - 1 <= event_s(t) <= outage["restarted"]]
    result["events"] = {
        "expected": len(expected), "received": len(got), "lost": lost,
        "sent": store.delivered, "queued_at_restart":
        outage["queued_at_restart"], "redelivered":
        outage["queued_at_restart"], "send_failures": store.send_failures,
        "skipped": store.failed_puts, "outage_s":
        outage["restarted"] - outage["stopped"],
        "by_kind": dict(Counter(e for e, _k in expected)),
        "delivery_p50_ms": _percentile(lat, 0.5) * 1e3,
        "delivery_p99_ms": _percentile(lat, 0.99) * 1e3,
        "delivery_p50_ms_outside_outage": _percentile(calm, 0.5) * 1e3
        if calm else None,
        "delivery_p99_ms_outside_outage": _percentile(calm, 0.99) * 1e3
        if calm else None}
    check(store.failed_puts == 0, "the queue store skipped events")
    check(outage["queued_at_restart"] > 0,
          "no event queued during the webhook's outage")

    bw.MonitoredReader.read = orig_read
    bw.Monitor.throttle = orig_throttle
    for c in (clients, target_client):
        c.close()
    src.shutdown()
    dst.shutdown()
    receiver.stop()
    scanner.stop()
    get_config_sys().obj = None
    bw._monitor = None
    launches = read_launches()
    result["launches"] = launches
    result["launch_sizes"] = read_launch_sizes()
    if on_card:
        for kname in ("gf_encode_batched", "gf_matmul_batched",
                      "highwayhash256_chunks"):
            check(launches[kname] > 0,
                  f"kernel {kname} never launched on the bucket feature "
                  f"path")
    shutil.rmtree(root, ignore_errors=True)
    return result


#: the cluster path: CL_NODES node processes of CL_DRIVES drives each
#: (32 drives: two sets of 16, each over two nodes, at 8+8), CL_OBJECTS
#: objects of OBJECT_BYTES PUT from CL_CLIENTS client threads over the
#: nodes' listeners, CL_OUTAGE_PUTS PUTs per set while CL_KILLED is down,
#: and one drive of each set replaced (CL_WIPED, (node, drive)): the owning
#: nodes stop, the drive is wiped, the nodes restart over it and an admin
#: heal of the bucket rebuilds its shards
CL_NODES = 4
CL_DRIVES = 8
CL_OBJECTS = 128
CL_CLIENTS = 32
CL_OUTAGE_PUTS = 4
CL_KILLED = 1
CL_WIPED = ((0, 0), (2, 0))
#: the ceiling of the nodes' RPC reconnect probe, in seconds
CL_PING_MAX_S = 1
CL_BOOT_S = 300


def _stats_of(path: str, after: float, proc, timeout: float = 60) -> dict:
    """A node's counters (``--stats-file``) once written after ``after``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path) and os.path.getmtime(path) >= after:
            try:
                with open(path) as f:
                    return json.load(f)
            except ValueError:
                pass  # caught between write and rename: read again
        check(proc.poll() is None, f"node died before its stats: {path}")
        time.sleep(0.05)
    raise PhaseError(f"no stats from {path}")


def _node_stats(proc, path: str) -> dict:
    """Ask a node for its counters (SIGUSR1) and read them."""
    import signal
    t0 = time.time() - 0.01
    proc.send_signal(signal.SIGUSR1)
    return _stats_of(path, t0, proc)


def _marks_after(rep: dict, url: str, key: str, after: float) -> list:
    """The wall times at which a node's RPC clients toward ``url`` last
    went offline (``key`` "offline_at") or came back ("online_at"), of
    those later than ``after``."""
    return [t for t in rep["peer_marks"].get(url, {}).get(key, [])
            if t >= after]


def _merge_reports(reports: list) -> dict:
    """The kernels' launches (by kernel, by size, K1's by o), the RPC
    methods' calls and latencies, and the lock acquisitions summed over
    several node reports."""
    launches, sizes = {}, {}
    rpc: dict = {}
    for rep in reports:
        k = rep["kernels"]
        for name, n in k["launches"].items():
            launches[name] = launches.get(name, 0) + n
        for field, suffix, fmt in (("launch_sizes", "", "<={}"),
                                   ("launch_rows", "_by_o", "o={}"),
                                   ("launch_pkgs", "_by_p", "<={}")):
            for name, hist in k[field].items():
                dst = sizes.setdefault(name + suffix, {})
                for b, v in hist.items():
                    key = b if name == "scan_codes" else fmt.format(b)
                    dst[key] = dst.get(key, 0) + v
        for svc, methods in rep["rpc"].items():
            for m, st in methods.items():
                row = rpc.setdefault(svc, {}).setdefault(
                    m, {"calls": 0, "errors": 0, "seconds": []})
                row["calls"] += st["calls"]
                row["errors"] += st["errors"]
                row["seconds"] += st["seconds"]
    return {"launches": launches, "launch_sizes": sizes, "rpc": rpc}


def _rpc_table(rpc: dict) -> dict:
    """{service: {method: calls, errors, p50/p99 ms}} of merged RPC rows."""
    out = {}
    for svc, methods in rpc.items():
        for m, st in sorted(methods.items()):
            secs = st["seconds"]
            out.setdefault(svc, {})[m] = {
                "calls": st["calls"], "errors": st["errors"],
                "p50_ms": _percentile(secs, 0.5) * 1e3 if secs else None,
                "p99_ms": _percentile(secs, 0.99) * 1e3 if secs else None}
    return out


def phase_cluster(device, sizes: dict, card: str, seed: int) -> dict:
    """A distributed deployment on one card: CL_NODES processes of
    ``python -m minio_tpu_torch.server`` with the full endpoint list, each
    serving CL_DRIVES drive directories (see the module docstring, step
    15). Every count is each process's own from its start; the path's
    launches are the sum over the processes (the killed node's counted up
    to its kill, from its stats just before)."""
    import signal
    import uuid

    import numpy as np
    from minio_tpu_torch.utils.siphash import sip_hash_mod
    n_nodes, n_drives = sizes["nodes"], sizes["drives"]
    n_obj, obj_bytes = sizes["objects"], sizes["bytes"]
    root = _disk_root("cluster")
    ports = []
    for _ in range(n_nodes):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            ports.append(sk.getsockname()[1])
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    drive = {(n, d): os.path.join(root, f"n{n}", f"d{d}")
             for n in range(n_nodes) for d in range(n_drives)}
    for path in drive.values():
        os.makedirs(path)
    # host-major: set s spans the nodes of its 16 (or fewer) drives
    endpoints = [f"{urls[n]}{drive[(n, d)]}" for n in range(n_nodes)
                 for d in range(n_drives)]
    stats = [os.path.join(root, f"stats{n}.json") for n in range(n_nodes)]
    logs = [os.path.join(root, f"node{n}.log") for n in range(n_nodes)]
    env = dict(os.environ, MINIO_TPU_ROOT_USER=S3_ACCESS_KEY,
               MINIO_TPU_ROOT_PASSWORD=S3_SECRET_KEY,
               MINIO_TPU_RPC_PING_MAX_S=str(CL_PING_MAX_S),
               PYTHONPATH=HERE)
    dev_args = ["--device", "cpu"] if device.type == "cpu" else []

    def spawn(n: int):
        with open(logs[n], "a") as log:
            return subprocess.Popen(
                [sys.executable, "-m", "minio_tpu_torch.server", *dev_args,
                 "--address", f"127.0.0.1:{ports[n]}", "--block-size",
                 str(BLOCK), "--stats-file", stats[n], *endpoints],
                cwd=HERE, env=env,
                stdout=subprocess.DEVNULL, stderr=log)

    def ready(n: int, proc, timeout: float = CL_BOOT_S) -> float:
        import http.client
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if proc.poll() is not None:
                with open(logs[n]) as f:
                    tail = f.read()[-3000:]
                raise PhaseError(f"node {n} exited {proc.returncode}: "
                                 f"{tail}")
            c = http.client.HTTPConnection("127.0.0.1", ports[n], timeout=5)
            try:
                c.request("GET", "/minio/health/cluster")
                if c.getresponse().status == 200:
                    return time.monotonic() - t0
            except OSError:
                pass
            finally:
                c.close()
            time.sleep(0.1)
        raise PhaseError(f"node {n} not ready in {timeout} s")

    procs: list = [None] * n_nodes
    clients = [_S3Client(p) for p in ports]
    out: dict = {"cut": f"{n_nodes} node processes on one card (one "
                        "host, loopback network)"}
    reports = []
    try:
        t0 = time.monotonic()
        for n in range(n_nodes):
            procs[n] = spawn(n)
        boot = [ready(n, procs[n]) for n in range(n_nodes)]
        out["boot_s"] = {"all": time.monotonic() - t0, "by_node": boot}
        with open(os.path.join(drive[(0, 0)], ".minio.sys",
                               "format.json")) as f:
            fmt = json.load(f)
        sets = fmt["xl"]["sets"]
        per_set = len(sets[0])
        dep = uuid.UUID(fmt["id"]).bytes
        parity = per_set // 2
        set_nodes = [sorted({i // n_drives for i in range(
            s * per_set, (s + 1) * per_set)}) for s in range(len(sets))]
        out["layout"] = {
            "sets": len(sets), "drives_per_set": per_set,
            "geometry": f"{per_set - parity}+{parity}",
            "drives_by_node": [
                {f"node{n}": sum(1 for i in range(s * per_set,
                                                  (s + 1) * per_set)
                                 if i // n_drives == n)
                 for n in set_nodes[s]} for s in range(len(sets))]}
        gen = np.random.default_rng(seed + 17)
        names = [f"obj-{i:04d}" for i in range(n_obj)]
        bodies = {nm: gen.bytes(obj_bytes) for nm in names}
        set_of = {nm: sip_hash_mod(nm, len(sets), dep) for nm in names}
        st, _h, data = clients[0].request("PUT", "/cluster")
        check(st == 200, f"bucket create: HTTP {st} {data[:200]!r}")

        def put(i: int) -> tuple:
            nm = names[i]
            st, h, data = clients[i % n_nodes].request(
                "PUT", f"/cluster/{nm}", body=bodies[nm])
            return nm, st, h.get("etag", "").strip('"'), data

        # (a) PUT through the four listeners
        for c in clients:
            c.latencies.clear()
        t0 = time.monotonic()
        with ThreadPoolExecutor(sizes["clients"]) as ex:
            puts = list(ex.map(put, range(n_obj)))
        wall = time.monotonic() - t0
        etags = {}
        for nm, st, etag, data in puts:
            check(st == 200, f"PUT {nm}: HTTP {st} {data[:200]!r}")
            etags[nm] = etag
        lat = [x for c in clients for x in c.latencies]
        out["put"] = {"objects": n_obj, "wall_s": wall,
                      "gib_s": n_obj * obj_bytes / wall / 2**30,
                      "p50_ms": _percentile(lat, 0.5) * 1e3,
                      "p99_ms": _percentile(lat, 0.99) * 1e3}
        after_put = [_node_stats(procs[n], stats[n]) for n in range(n_nodes)]
        locks = [x for r in after_put for x in r["locks"]["seconds"]]
        out["put"]["dsync_lock"] = {
            "acquired": sum(r["locks"]["acquired"] for r in after_put),
            "timed_out": sum(r["locks"]["timed_out"] for r in after_put),
            "p50_ms": _percentile(locks, 0.5) * 1e3,
            "p99_ms": _percentile(locks, 0.99) * 1e3}

        def get(i: int, via: list) -> tuple:
            nm = names[i]
            n = via[i]
            st, h, data = clients[n].request("GET", f"/cluster/{nm}")
            return nm, st, h.get("etag", "").strip('"'), data

        def get_all(via: list, step: str) -> dict:
            for c in clients:
                c.latencies.clear()
            t0 = time.monotonic()
            with ThreadPoolExecutor(sizes["clients"]) as ex:
                got = list(ex.map(lambda i: get(i, via), range(n_obj)))
            wall = time.monotonic() - t0
            for nm, st, etag, data in got:
                check(st == 200, f"{step} GET {nm}: HTTP {st}")
                check(data == bodies[nm], f"{step} GET {nm}: bytes differ")
                check(etag == etags[nm], f"{step} GET {nm}: ETag differs")
            lat = [x for c in clients if c.latencies for x in c.latencies]
            return {"objects": n_obj, "wall_s": wall,
                    "gib_s": n_obj * obj_bytes / wall / 2**30,
                    "p50_ms": _percentile(lat, 0.5) * 1e3,
                    "p99_ms": _percentile(lat, 0.99) * 1e3}

        # (b) GET of each through a node other than its writer
        out["get"] = get_all([(i + 1) % n_nodes for i in range(n_obj)],
                             "cross-node")

        # (c) a node dies: its counters first, then SIGKILL. The survivors
        # serve the degraded GETs; each one's clients toward the dead node
        # record when they went offline, read from its stats after
        killed = sizes["killed"]
        reports.append(_node_stats(procs[killed], stats[killed]))
        survivors = [n for n in range(n_nodes) if n != killed]
        t_kill = time.time()
        procs[killed].send_signal(signal.SIGKILL)
        procs[killed].wait(timeout=60)
        via = [survivors[i % len(survivors)] for i in range(n_obj)]
        out["degraded_get"] = get_all(via, "degraded")
        offline_s = {}
        for n in survivors:
            marks = _marks_after(_node_stats(procs[n], stats[n]),
                                 urls[killed], "offline_at", t_kill)
            check(bool(marks), f"node {n} never marked node {killed} "
                               "offline")
            offline_s[f"node{n}"] = min(marks) - t_kill
        out["degraded_get"]["offline_marked_s"] = offline_s
        # PUTs during the outage, to every set: a set keeps its write
        # quorum (data + 1 when parity equals data, else data) with the
        # killed node's drives gone, or refuses
        outage = {}
        for s in range(len(sets)):
            lost = sum(1 for i in range(s * per_set, (s + 1) * per_set)
                       if i // n_drives == killed)
            data_n = per_set - parity
            quorum = data_n + 1 if data_n == parity else data_n
            want_ok = per_set - lost >= quorum
            cand = (f"outage-{s}-{j:04d}" for j in range(10**6))
            chosen = []
            for nm in cand:
                if sip_hash_mod(nm, len(sets), dep) == s:
                    chosen.append(nm)
                    if len(chosen) == sizes["outage_puts"]:
                        break
            statuses = []
            for j, nm in enumerate(chosen):
                body = gen.bytes(obj_bytes)
                bodies[nm] = body
                st, _h, _d = clients[survivors[j % len(survivors)]].request(
                    "PUT", f"/cluster/{nm}", body=body)
                statuses.append(st)
            ok = sum(1 for st in statuses if st == 200)
            check(ok == (len(statuses) if want_ok else 0),
                  f"set {s} with {per_set - lost} of {per_set} drives "
                  f"(write quorum {quorum}) answered {statuses}")
            outage[f"set{s}"] = {"drives_live": per_set - lost,
                                 "write_quorum": quorum,
                                 "statuses": statuses,
                                 "stored": [nm for nm, st in
                                            zip(chosen, statuses)
                                            if st == 200]}
        out["outage_puts"] = outage

        # (d) the node comes back over the same drives and port; a peer has
        # reconnected once every client of it that went offline after the
        # kill is back
        t_restart = time.time()
        procs[killed] = spawn(killed)
        ready_s = ready(killed, procs[killed])
        reconnect_s = {}
        while len(reconnect_s) < len(survivors) and \
                time.time() - t_restart < 120:
            for n in survivors:
                if f"node{n}" in reconnect_s:
                    continue
                row = _node_stats(procs[n], stats[n])["peer_marks"].get(
                    urls[killed], {})
                pairs = [(off, on) for off, on in zip(
                    row.get("offline_at", []), row.get("online_at", []))
                    if off >= t_kill]
                if pairs and all(on >= off for off, on in pairs):
                    reconnect_s[f"node{n}"] = max(
                        on for _off, on in pairs) - t_restart
            time.sleep(0.25)
        check(len(reconnect_s) == len(survivors),
              f"peers reconnected to node {killed}: {sorted(reconnect_s)}")
        out["restart"] = {"ready_s": ready_s, "reconnected_s": reconnect_s}
        for s_row in outage.values():
            for nm in s_row["stored"]:
                st, _h, data = clients[killed].request("GET",
                                                       f"/cluster/{nm}")
                check(st == 200 and data == bodies[nm],
                      f"outage object {nm} through the restarted node")

        # (e) one drive of each set replaced, as tests/test_cluster_heal_oop.py
        # does: the owning nodes stop (their counters first), the drive is
        # copied aside and wiped, the nodes restart over it (their start
        # formats it into its slot), and an admin heal of the bucket through
        # the first of them rebuilds its shards. The heal-shard seconds are
        # those each node recorded after this point
        owners = sorted({n for n, _d in sizes["wiped"]})

        def heal_passes(n: int) -> int:
            return _admin_json(clients[n], "bg-heal-status")["autoheal"][
                "heal_passes"]

        passes0 = {n: heal_passes(n) for n in range(n_nodes)
                   if n not in owners}
        before = {}
        for n in range(n_nodes):
            rep = _node_stats(procs[n], stats[n])
            if n in owners:
                reports.append(rep)
            else:
                before[n] = len(rep["heal_shard_seconds"])
        for n in owners:
            procs[n].send_signal(signal.SIGKILL)
            procs[n].wait(timeout=60)
        wiped = {}
        for n, d in sizes["wiped"]:
            path = drive[(n, d)]
            keep = path + ".orig"
            shutil.copytree(path, keep)
            wiped[(n, d)] = keep
            for entry in os.listdir(path):
                full = os.path.join(path, entry)
                if os.path.isdir(full):
                    shutil.rmtree(full)
                else:
                    os.unlink(full)
        t_replace = time.monotonic()
        for n in owners:
            procs[n] = spawn(n)
            clients[n].close()  # its connections reached the old process
            clients[n] = _S3Client(ports[n])
        replace_ready = {f"node{n}": ready(n, procs[n]) for n in owners}
        t_heal = time.monotonic()
        seq = _admin_json(clients[owners[0]], "heal/cluster", "POST")
        while seq["status"] == "running" and time.monotonic() - t_heal < 600:
            time.sleep(0.1)
            seq = _admin_json(clients[owners[0]], "heal/cluster", "POST",
                              clientToken=seq["clientToken"])
        heal_wall = time.monotonic() - t_heal
        check(seq["status"] == "done" and seq["failed"] == 0,
              f"admin heal: {seq['status']}, {seq['failed']} failed, "
              f"{seq['error']!r}")
        want = n_obj + sum(len(r["stored"]) for r in outage.values())
        check(seq["scanned"] == want,
              f"admin heal scanned {seq['scanned']} of {want} objects")
        same = differ = missing = 0
        shard_bytes = 0
        for (n, d), keep in wiped.items():
            for nm in names:
                src = os.path.join(keep, "cluster", nm)
                if not os.path.isdir(src):
                    continue
                for sub, _dirs, files in os.walk(src):
                    for f in files:
                        a = os.path.join(sub, f)
                        b = os.path.join(drive[(n, d)], os.path.relpath(
                            a, keep))
                        if not os.path.exists(b):
                            missing += 1
                            continue
                        with open(a, "rb") as fa, open(b, "rb") as fb:
                            ba, bb = fa.read(), fb.read()
                        if ba == bb:
                            same += 1
                            shard_bytes += len(ba)
                        else:
                            differ += 1
        check(missing == 0 and differ == 0 and same > 0,
              f"healed files: {same} identical, {differ} differ, "
              f"{missing} missing")
        heal_rows = [_node_stats(procs[n], stats[n])
                     for n in range(n_nodes)]
        # the restarted nodes' drives re-online on the peers' health
        # trackers, which set their healing trackers and wake the nodes'
        # auto-heal monitors: the global heals (128 workers) that ran
        # beside the admin heal in this step
        passes = {f"node{n}": heal_passes(n) - passes0.get(n, 0)
                  for n in range(n_nodes)}
        shard_s = [x for n, r in enumerate(heal_rows)
                   for x in r["heal_shard_seconds"][before.get(n, 0):]]
        check(len(shard_s) > 0, "no shard heal recorded")
        out["heal"] = {
            "drives": [f"node{n}/d{d}" for n, d in wiped],
            "trigger": f"admin heal of the bucket through node{owners[0]}",
            "restart_ready_s": replace_ready,
            "replace_to_healed_s": time.monotonic() - t_replace,
            "wall_s": heal_wall,
            "objects_scanned": seq["scanned"],
            "objects_healed": seq["healed"],
            "global_heal_passes": passes,
            "files_identical": same, "shard_bytes": shard_bytes,
            "gib_s": shard_bytes / heal_wall / 2**30,
            "shard_heals": len(shard_s),
            "heal_shard_p50_s": _percentile(shard_s, 0.5),
            "heal_shard_p99_s": _percentile(shard_s, 0.99)}
        # the bytes still read back whole after the heal
        out["get_after_heal"] = get_all([i % n_nodes for i in range(n_obj)],
                                        "after heal")
        final = [_node_stats(procs[n], stats[n]) for n in range(n_nodes)]
        reports += final
        merged = _merge_reports(reports)
        out["launches"] = merged["launches"]
        out["launch_sizes"] = merged["launch_sizes"]
        out["rpc"] = _rpc_table(merged["rpc"])
        for rep in reports:
            d = rep["dispatch"]
            check(d["failed_batches"] == 0 and d["salvaged_batches"] == 0
                  and d["obs_errors"] == 0,
                  f"node {rep['endpoint']}: dispatch {d}")
        path_wall = time.time() - t_kill
        out["processes"] = [{
            "endpoint": rep["endpoint"], "pid": rep["pid"],
            "memory": rep.get("memory"),
            "stream_occupancy_s": {
                dev: o["union_s"] for dev, o in rep["occupancy"].items()},
            "flushes": rep["dispatch"]["batches"],
            "items": rep["dispatch"]["items"]} for rep in final]
        out["steps_c_to_e_wall_s"] = path_wall
        for name in ("gf_encode_batched", "gf_matmul_batched",
                     "highwayhash256_chunks"):
            check(out["launches"].get(name, 0) > 0 or device.type == "cpu",
                  f"{name} never launched on the cluster path")
        out["card"] = card
    finally:
        for c in clients:
            c.close()
        for proc in procs:
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs:
            if proc is None:
                continue
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        shutil.rmtree(root, ignore_errors=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase at a tiny size on the host with "
                    "the plain versions; exits 3 and never prints ok")
    ap.add_argument("--seed", type=int, default=20261016,
                    help="seed of the objects and the customer keys")
    args = ap.parse_args()
    t_start = time.monotonic()
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import minio_tpu_torch  # noqa: F401 — the port must be beside us
    except ImportError:
        print("minio_tpu_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    rehearsal = args.cpu_rehearsal
    device = torch.device("cpu" if rehearsal else "cuda")
    # the servers' scanners never cycle on their own timer: the background
    # path drives its cycles, and no other path's walls take one
    os.environ["MINIO_TPU_SCANNER_INTERVAL_S"] = "86400"
    # the rehearsal's lineitem rows (~48,000) still fill the four scan
    # blocks of its kernels phase
    scale, n_sel = (0.008, 8) if rehearsal else (SELECT_SCALE, SELECT_OBJECTS)
    # the rehearsal's MUR3 objects of 2.1 MiB still hold an unaligned tail;
    # its 1 MiB SSE objects end in a 256-byte ciphertext block (those 333
    # bytes short, in a short package)
    n_obj, obj_bytes, sse_bytes = (4, int(2.1 * 2**20), 1 << 20) \
        if rehearsal else (N_OBJECTS, OBJECT_BYTES, OBJECT_BYTES)
    # the object layer path: big objects, their bytes, small objects,
    # their bytes, the multipart object's parts (S3's 5 MiB floor holds
    # for every part but the last)
    ol_sizes = (4, int(2.1 * 2**20), 4, OL_SMALL_BYTES,
                (5 << 20, 333)) if rehearsal else \
        (OL_BIG, OBJECT_BYTES, OL_SMALL, OL_SMALL_BYTES, OL_PARTS)
    # the S3 server path: plain and SSE-C objects (count, bytes), CSV
    # objects, the multipart object's parts
    s3_sizes = {"big": (4, int(2.1 * 2**20)), "sse": (2, 1 << 20),
                "csv": 2, "parts": (5 << 20, 333)} if rehearsal else \
        {"big": (S3_BIG, OBJECT_BYTES), "sse": (S3_SSE, OBJECT_BYTES),
         "csv": S3_CSV, "parts": S3_PARTS}
    # the SSE-KMS path: objects per group and their bytes
    kms_sizes = (2, 1 << 20) if rehearsal else (KMS_OBJECTS, OBJECT_BYTES)
    # the obs path: objects and their bytes
    obs_sizes = (4, 1 << 20) if rehearsal else (S3_BIG, OBJECT_BYTES)
    # the background path: big and small objects (count, bytes), the
    # objects PUT between two cycles, the corrupted shards, the PUTs while
    # a drive is tripped, the wrapper's objects
    bg_sizes = {"big": (8, int(1.1 * 2**20)), "small": (4, OL_SMALL_BYTES),
                "new": 2, "corrupt": 2, "trip": 2, "wrap": 4} \
        if rehearsal else \
        {"big": (BG_BIG, OBJECT_BYTES), "small": (BG_SMALL, OL_SMALL_BYTES),
         "new": BG_NEW, "corrupt": BG_CORRUPT, "trip": BG_TRIP_PUTS,
         "wrap": BG_WRAP}
    # the host path: objects and the bytes each reaches at least (the
    # rehearsal's lineitem text holds ~6 MB: one object, whose 4 MiB still
    # take the MD5 lanes)
    host_sizes = (1, OBJECT_BYTES) if rehearsal else \
        (HOST_OBJECTS, OBJECT_BYTES)
    # the iam path: objects per tenant, their bytes, the ABBA block's PUTs
    iam_sizes = {"objects": 1, "bytes": 64 << 10, "abba": 2} if rehearsal \
        else {"objects": IAM_OBJECTS, "bytes": OBJECT_BYTES,
              "abba": IAM_ABBA}
    # the bucket feature path: objects per step, their bytes, the
    # throttle's limit (the rehearsal's 256 KiB/s moves its 2 x 64 KiB
    # over two windows)
    bf_sizes = {"repl": 4, "degraded": 2, "throttle": 2, "cold": 4,
                "restore": 1, "worm": 2, "bytes": 64 << 10,
                "throttle_bps": 256 << 10, "binding": 2,
                "binding_bps": 128 << 10} if rehearsal else \
        {"repl": BF_REPL, "degraded": BF_DEGRADED, "throttle": BF_THROTTLE,
         "cold": BF_COLD, "restore": BF_RESTORE, "worm": BF_WORM,
         "bytes": OBJECT_BYTES, "throttle_bps": BF_THROTTLE_BPS,
         "binding": BF_BINDING, "binding_bps": BF_BINDING_BPS}
    # the cluster path: the same 4 nodes, 2 drives each in the rehearsal
    cl_sizes = {"nodes": CL_NODES, "drives": 2 if rehearsal else CL_DRIVES,
                "objects": 8 if rehearsal else CL_OBJECTS,
                "bytes": (256 << 10) if rehearsal else OBJECT_BYTES,
                "clients": 8 if rehearsal else CL_CLIENTS,
                "outage_puts": 2 if rehearsal else CL_OUTAGE_PUTS,
                "killed": CL_KILLED, "wiped": CL_WIPED}
    phase = "build"
    try:
        phase_build(rehearsal)
        phase = "card"
        card = phase_card(rehearsal)
        phase = "native"
        phase_native(rehearsal)
        phase = "lineitem"
        t0 = time.monotonic()
        table = lineitem(args.seed, scale)
        emit({"phase": "lineitem", "scale_factor": scale,
              "rows": table["rows"],
              "bytes": len(table["text"]),
              "seconds": time.monotonic() - t0})
        phase = "kernels"
        rows = phase_kernels(device, rehearsal, table)
        phase = "main_path"
        res = phase_main(device, n_obj if rehearsal else MUR3_OBJECTS,
                         obj_bytes, args.seed)
        if rehearsal:
            res["cut"] = f"{n_obj} objects of {obj_bytes} bytes"
        emit({"phase": "main_path", "card": card, **res})
        phase = "sse_path"
        sres = phase_sse(device, n_obj if rehearsal else SSE_OBJECTS,
                         sse_bytes, args.seed)
        if rehearsal:
            sres["cut"] = f"{n_obj} objects of {sse_bytes} bytes"
        emit({"phase": "sse_path", "card": card, **sres})
        phase = "select_path"
        selres = phase_select(device, table, n_sel, args.seed)
        if rehearsal:
            selres["cut"] = f"{table['rows']} rows in {n_sel} objects"
        emit({"phase": "select_path", "card": card, **selres})
        phase = "objectlayer_path"
        olres = phase_objectlayer(device, *ol_sizes, args.seed)
        if rehearsal:
            olres["cut"] += (f"; {ol_sizes[0]} objects of {ol_sizes[1]} "
                             f"bytes, {ol_sizes[2]} small")
        emit({"phase": "objectlayer_path", "card": card, **olres})
        phase = "s3server_path"
        s3res = phase_s3server(device, table, s3_sizes, args.seed)
        if rehearsal:
            s3res["cut"] += f"; {s3_sizes}"
        emit({"phase": "s3server_path", "card": card, **s3res})
        phase = "sse_kms_path"
        kmsres = phase_ssekms(device, *kms_sizes, args.seed)
        if rehearsal:
            kmsres["cut"] += f"; {kms_sizes[0]} objects of {kms_sizes[1]}"
        emit({"phase": "sse_kms_path", "card": card, **kmsres})
        phase = "obs_path"
        obsres = phase_obs(device, *obs_sizes, card, args.seed)
        if rehearsal:
            obsres["cut"] += f"; {obs_sizes[0]} objects of {obs_sizes[1]}"
        emit({"phase": "obs_path", **obsres})
        phase = "background_path"
        bgres = phase_background(device, bg_sizes, card, args.seed)
        if rehearsal:
            bgres["cut"] += f"; {bg_sizes}"
        emit({"phase": "background_path", **bgres})
        phase = "hostpath_path"
        hostres = phase_hostpath(device, table, *host_sizes, card,
                                 args.seed)
        if rehearsal:
            hostres["cut"] += f"; {host_sizes[0]} objects of about " \
                              f"{host_sizes[1]} bytes"
        emit({"phase": "hostpath_path", **hostres})
        phase = "iam_path"
        iamres = phase_iam(device, iam_sizes, card, args.seed)
        if rehearsal:
            iamres["cut"] += f"; {iam_sizes}"
        emit({"phase": "iam_path", **iamres})
        phase = "bucketfeatures_path"
        bfres = phase_bucketfeatures(device, bf_sizes, card, args.seed)
        if rehearsal:
            bfres["cut"] += f"; {bf_sizes}"
        emit({"phase": "bucketfeatures_path", **bfres})
        phase = "cluster_path"
        clres = phase_cluster(device, cl_sizes, card, args.seed)
        if rehearsal:
            clres["cut"] += f"; {cl_sizes}"
        emit({"phase": "cluster_path", **clres})
        paths = {"mur3x256s_path": res, "sse_hh256s_path": sres,
                 "select_path": selres, "objectlayer_path": olres,
                 "s3server_path": s3res, "sse_kms_path": kmsres,
                 "obs_path": obsres, "background_path": bgres,
                 "hostpath_path": hostres, "iam_path": iamres,
                 "bucketfeatures_path": bfres, "cluster_path": clres}
        for name, row in rows.items():
            by_path = {p: r["launches"][name] for p, r in paths.items()}
            row["launches"] = sum(by_path.values())
            row["launches_by_path"] = by_path
            for key, field in ((name, "launch_sizes_by_path"),
                               (f"{name}_by_o", "launch_rows_by_path"),
                               (f"{name}_by_p", "launch_pkgs_by_path")):
                if key in res["launch_sizes"]:
                    row[field] = {p: r["launch_sizes"].get(key, {})
                                  for p, r in paths.items()}
        emit({"phase": "launch_sizes", **{
            name: row["launch_sizes_by_path"] for name, row in rows.items()
            if "launch_sizes_by_path" in row}, **{
            f"{name}_by_o": row["launch_rows_by_path"]
            for name, row in rows.items() if "launch_rows_by_path" in row},
            **{f"{name}_by_p": row["launch_pkgs_by_path"]
               for name, row in rows.items()
               if "launch_pkgs_by_path" in row}})
    except Exception as e:  # noqa: BLE001 — report the phase, exit non-zero
        import traceback
        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    finally:
        from minio_tpu_torch.erasure.streaming import shutdown_pools
        from minio_tpu_torch.runtime.dispatch import shutdown_global
        shutdown_global()
        shutdown_pools()
    # the script's own seconds, from argument parsing to here (the build
    # included, the interpreter's start-up not)
    emit({"phase": "done", "script_seconds": time.monotonic() - t_start})
    emit({"kernels": list(rows.values())})
    if rehearsal:
        print("cpu rehearsal done; no result", file=sys.stderr)
        return 3
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
