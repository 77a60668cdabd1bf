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

Not ported, each with the ROADMAP item it waits for: the one-disk FS mode,
``http://`` distributed endpoints (Queue 1 item 9), and ``--gateway``
(Queue 1 item 10)."""
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
                    "ellipses patterns like /data/disk{1...8}")
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
    args = ap.parse_args(argv)
    if args.gateway:
        ap.error("--gateway is not ported (ROADMAP Queue 1 item 10)")
    if any(d.startswith(("http://", "https://")) for d in args.dirs):
        ap.error("distributed endpoints are not ported (ROADMAP Queue 1 "
                 "item 9)")
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
    install_service_hook(srv, argv if argv is not None else sys.argv[1:])
    srv.start_background_services()
    print(f"{banner} on {device}; listening on {args.address}",
          file=sys.stderr)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()


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
