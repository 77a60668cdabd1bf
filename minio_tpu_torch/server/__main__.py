"""CLI entry: ``python -m minio_tpu_torch.server [--address HOST:PORT[,
HOST:PORT...]] [--device {cuda,cpu}] DIR...`` — the port of ``python -m minio_tpu.server``
(reference cmd/server-main.go:404) for the local erasure modes: the disk
arguments (ellipses patterns like ``/data/disk{1...8}`` expand) form one
erasure set or several sets of 4-16 drives, and several ellipses arguments
form one pool each. The erasure work runs on the CUDA card unless
``--device cpu`` is given; without a card that fails at start. Root
credentials: MINIO_TPU_ROOT_USER/_PASSWORD (MINIO_ROOT_USER/_PASSWORD also
honored; default minioadmin/minioadmin). The admin ``service`` op
restarts the server (the same ``python -m minio_tpu_torch.server``
command line, re-executed) or stops it. Several comma-separated
``--address`` bindings are served by one server (the reference's
multi-address listener).

``http://host:port/path`` endpoint arguments select the distributed mode:
every node process gets the same full endpoint list, serves the drives
whose URL matches its ``--address`` and reaches the rest over the storage
RPC (``dist/node.py``), its sets at ``--block-size`` bytes a block
(default 4 MiB). ``--stats-file PATH`` makes a distributed node
write its counters (``Node.report``: kernel launches by shape, RPC calls
and latencies by method, lock acquisitions, the card's occupancy and
memory) to PATH on SIGUSR1 and when it exits on SIGTERM or SIGINT.
``MINIO_TPU_ETCD_ENDPOINTS`` (with ``MINIO_TPU_DOMAIN``) federates a
local-mode server's buckets through etcd (``dist/federation.py``).

Not ported, each with the ROADMAP item it waits for: the one-disk FS mode
and ``--gateway`` (Queue 1 item 10)."""
from __future__ import annotations

import argparse
import os
import sys


def _root_creds() -> tuple[str, str]:
    ak = os.environ.get("MINIO_TPU_ROOT_USER") \
        or os.environ.get("MINIO_ROOT_USER") or "minioadmin"
    sk = os.environ.get("MINIO_TPU_ROOT_PASSWORD") \
        or os.environ.get("MINIO_ROOT_PASSWORD") or "minioadmin"
    return ak, sk


def build_layer(dirs: list[str], parity, device):
    """The object layer the disk arguments describe, and its banner: one
    pool per argument when every argument is an ellipses pattern and
    there are several (reference server pool expansion,
    cmd/endpoint-ellipses.go / erasure-server-pool.go), else one set or
    several sets of the expanded disks."""
    from ..dist.ellipses import expand_endpoints
    from ..dist.topology import pick_set_layout
    from ..objectlayer import ErasureObjects, ErasureSets, ServerPools
    from ..storage import XLStorage

    def sets_of(paths):
        set_count, per_set = pick_set_layout(len(paths))
        return ErasureSets([XLStorage(p) for p in paths], set_count,
                           per_set, default_parity=parity, device=device)

    if len(dirs) > 1 and all("{" in d for d in dirs):
        pools = [sets_of(expand_endpoints([spec])) for spec in dirs]
        return ServerPools(pools), f"erasure: {len(pools)} pools"
    paths = expand_endpoints(dirs)
    set_count, per_set = pick_set_layout(len(paths))
    if set_count == 1:
        layer = ErasureObjects([XLStorage(p) for p in paths],
                               default_parity=parity, device=device)
    else:
        layer = sets_of(paths)
    return layer, f"erasure: {set_count} set(s) x {per_set} drives"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="minio-tpu-torch server")
    ap.add_argument("dirs", nargs="+", help="disk directories or "
                    "ellipses patterns like /data/disk{1...8}; "
                    "http://host:port/path endpoints = distributed mode")
    ap.add_argument("--address", default="0.0.0.0:9000",
                    help="host:port to listen on (comma-separated for "
                         "several)")
    ap.add_argument("--region", default="us-east-1")
    ap.add_argument("--parity", type=int, default=None,
                    help="parity drives per set (default: drives/2)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the erasure, hash, cipher and scan work "
                         "runs (default: the CUDA card)")
    ap.add_argument("--gateway", default=None,
                    help="gateway mode (not ported)")
    ap.add_argument("--block-size", type=int, default=None,
                    help="distributed mode: the sets' erasure block in "
                         "bytes (default 4 MiB)")
    ap.add_argument("--stats-file", default="",
                    help="distributed mode: write the node's counters "
                         "here on SIGUSR1 and at exit")
    args = ap.parse_args(argv)
    if args.gateway:
        ap.error("--gateway is not ported (ROADMAP Queue 1 item 10)")
    argv = argv if argv is not None else sys.argv[1:]
    if any(d.startswith(("http://", "https://")) for d in args.dirs):
        if "," in args.address:
            ap.error("multi-addr --address is not supported in distributed "
                     "mode; pass the single URL this node serves")
        return serve_distributed(args, argv)
    if len(args.dirs) > 1 and any("{" in d for d in args.dirs) and \
            not all("{" in d for d in args.dirs):
        # the reference rejects mixed ellipses/non-ellipses endpoint args
        # (cmd/endpoint-ellipses.go)
        ap.error("invalid endpoint args: all disk args must use ellipses "
                 "patterns ({...}) or none may; mixing patterns and "
                 "plain paths is not supported")
    from ..dist.ellipses import expand_endpoints
    if len(args.dirs) == 1 and len(expand_endpoints(args.dirs)) == 1:
        ap.error("the one-disk FS mode is not ported (ROADMAP Queue 1 "
                 "item 7); give 2 or more disks")
    parsed = []
    for a in args.address.split(","):
        h, _, p = a.rpartition(":")
        try:
            parsed.append((h or "0.0.0.0", int(p)))
        except ValueError:
            ap.error(f"invalid --address entry {a!r} (expected host:port)")
    (host, port), extra = parsed[0], parsed[1:]
    from ..utils.device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")
    obj, banner = build_layer(args.dirs, args.parity, device)
    ak, sk = _root_creds()
    from . import S3Server
    srv = S3Server(obj, host, port, args.region, access_key=ak,
                   secret_key=sk, device=device, extra_addresses=extra)
    if extra:
        banner += f"; +{len(extra)} extra listener(s)"
    if os.environ.get("MINIO_TPU_ETCD_ENDPOINTS"):
        # the advertise address is resolved only when federation is
        # configured (gethostbyname can fail on minimal containers)
        import socket
        from ..dist.federation import federation_from_env
        adv = host if host not in ("", "0.0.0.0") else \
            socket.gethostbyname(socket.gethostname())
        fed = federation_from_env(adv, port)
        if fed is not None:
            srv.enable_federation(fed)
            banner += f"; federated via etcd (domain {fed.domain})"
    install_service_hook(srv, argv)
    srv.start_background_services()
    print(f"{banner} on {device}; listening on {args.address}",
          file=sys.stderr)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()


def serve_distributed(args, argv: list) -> None:
    """Distributed startup: build the Node from the full endpoint list,
    identify ourselves by --address, serve until SIGTERM or SIGINT."""
    import signal
    import socket
    import threading

    from ..dist.node import Node
    from ..objectlayer.erasure_objects import DEFAULT_BLOCK_SIZE
    from ..utils.device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")
    ak, sk = _root_creds()
    host, _, port = args.address.rpartition(":")
    host = host or "0.0.0.0"

    def build(local_url: str) -> Node:
        return Node(args.dirs, local_url=local_url, address=host,
                    port=int(port), access_key=ak, secret_key=sk,
                    region=args.region, default_parity=args.parity,
                    device=device,
                    block_size=args.block_size or DEFAULT_BLOCK_SIZE)

    node = build(f"http://{host}:{port}")
    on_port = {e.url for e in node.endpoints
               if e.url and e.url.rsplit(":", 1)[-1] == port}
    if not node.local_disks and on_port:
        # --address 0.0.0.0 (or a host alias) matches no endpoint URL;
        # retry with the endpoint on our port whose host names this
        # machine — silently owning zero disks makes a cluster that
        # comes up dead
        local_names = {"127.0.0.1", "localhost", socket.gethostname(),
                       socket.getfqdn()}
        candidates = {u for u in on_port
                      if u.split("//", 1)[-1].rsplit(":", 1)[0]
                      in local_names}
        if len(candidates) == 1:
            node = build(candidates.pop())
    if not node.local_disks:
        sys.exit(f"error: --address {args.address} matches no endpoint "
                 f"URL; pass the URL this node serves (endpoints: "
                 f"{sorted({str(e.url) for e in node.endpoints})})")
    done = threading.Event()

    def write_stats(*_):
        if not args.stats_file:
            return
        import json
        tmp = f"{args.stats_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(node.report(), f)
        os.replace(tmp, args.stats_file)

    signal.signal(signal.SIGUSR1, write_stats)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    node.start()
    install_service_hook(node.server, argv)
    print(f"distributed node {node.local_url} on {device}: "
          f"{node.set_count} set(s) x {node.drives_per_set} drives, "
          f"{len(node.local_disks)} local", file=sys.stderr, flush=True)
    try:
        while not done.wait(3600):
            pass
        write_stats()
    finally:
        node.shutdown()


def install_service_hook(srv, argv: list) -> None:
    """``mc admin service restart/stop`` (reference cmd/service.go, JAX
    ``_install_service_hook``): restart re-executes ``python -m
    minio_tpu_torch.server`` with the same arguments, so configuration and
    environment changes load; stop exits at once."""
    def service_signal(action: str):
        if action == "restart":
            os.execv(sys.executable, [sys.executable, "-m",
                                      "minio_tpu_torch.server", *argv])
        os._exit(0)

    srv.on_service_signal = service_signal


if __name__ == "__main__":
    main()
