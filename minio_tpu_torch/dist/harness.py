"""In-process multi-node topology harness, the port of
minio_tpu/dist/harness.py: N
``dist.node.Node`` server processes' worth of cluster — separate HTTP
listeners on localhost ports, storage REST RPC between them, dsync
quorum locks — inside ONE test process, with node-level chaos hooks
(:mod:`minio_tpu_torch.fault.node`) pre-wired: every node is registered
for ``node_kill``/``node_restart`` and carries the restart spec a fresh
``Node`` needs.

``device`` reaches every node (the card unless the caller passes
``"cpu"``) and ``block_size`` every node's sets. The nodes
of one process share its dispatch queue. It is NOT a deployment surface —
a real cluster runs one process per node (``python -m
minio_tpu_torch.server http://...``, as chip_smoke.py's cluster path
does).
"""
from __future__ import annotations

import os
import socket
import threading
import uuid

from ..fault import node as fault_node
from ..objectlayer.erasure_objects import DEFAULT_BLOCK_SIZE
from .node import Node


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


class LocalCluster:
    """``nodes`` x ``disks_per_node`` erasure cluster on localhost.

    Node i's chaos-registry name is ``cluster.name(i)``; convenience
    wrappers :meth:`kill`/:meth:`restart` target by index. Start is
    concurrent (format negotiation needs every node answering)."""

    def __init__(self, root: str, nodes: int = 4, disks_per_node: int = 2,
                 parity: int | None = 2, access_key: str = "minioadmin",
                 secret_key: str = "minioadmin",
                 start_timeout_s: float = 120.0, device=None,
                 block_size: int = DEFAULT_BLOCK_SIZE):
        self.root = root
        self.n = nodes
        self.access_key, self.secret_key = access_key, secret_key
        self._tag = uuid.uuid4().hex[:8]
        self.ports = [free_port() for _ in range(nodes)]
        self.urls = [f"http://127.0.0.1:{p}" for p in self.ports]
        args: list[str] = []
        for ni in range(nodes):
            for di in range(disks_per_node):
                d = os.path.join(root, f"n{ni}", f"d{di}")
                os.makedirs(d, exist_ok=True)
                args.append(f"{self.urls[ni]}{d}")
        self.nodes: list[Node] = []
        specs = []
        for ni in range(nodes):
            spec = dict(endpoint_args=list(args),
                        local_url=self.urls[ni], address="127.0.0.1",
                        port=self.ports[ni], access_key=access_key,
                        secret_key=secret_key, default_parity=parity,
                        device=device, block_size=block_size)
            specs.append(spec)
            node = Node(**spec)
            node._restart_spec = dict(spec)
            self.nodes.append(node)
        errs: list[BaseException | None] = [None] * nodes

        def boot(i: int) -> None:
            try:
                self.nodes[i].start(wait_format_timeout=start_timeout_s)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errs[i] = e
        ths = [threading.Thread(target=boot, args=(i,), daemon=True,
                                name=f"dist-node-boot-{i}")
               for i in range(nodes)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=start_timeout_s)
        bad = [f"node{i}: {e!r}" for i, e in enumerate(errs)
               if e is not None]
        dead = [i for i, nd in enumerate(self.nodes) if nd.obj is None]
        if bad or dead:
            self.shutdown()
            raise RuntimeError(
                f"cluster failed to start (errors: {bad or '-'}; "
                f"no object layer: {dead or '-'})")
        for i, node in enumerate(self.nodes):
            fault_node.register_node(self.name(i), node)

    # -- addressing -----------------------------------------------------------

    def name(self, i: int) -> str:
        return f"lc-{self._tag}-n{i}"

    def endpoint(self, i: int = 0) -> str:
        return self.urls[i]

    def live_endpoints(self) -> list[str]:
        return [u for i, u in enumerate(self.urls)
                if self.nodes[i].server is not None]

    # -- chaos ----------------------------------------------------------------

    def kill(self, i: int) -> None:
        """Hard-stop node i (fault.node.node_kill): listener closed,
        peers see connection-refused; disks/staging left untouched."""
        fault_node.node_kill(self.name(i))

    def restart(self, i: int, wait_format_timeout: float = 60.0) -> Node:
        """Process-restart node i over the same endpoints/port; the
        harness's node list tracks the fresh instance."""
        node = fault_node.node_restart(
            self.name(i), wait_format_timeout=wait_format_timeout)
        self.nodes[i] = node
        return node

    def shutdown(self) -> None:
        for i, node in enumerate(self.nodes):
            fault_node.unregister_node(self.name(i))
            try:
                node.shutdown()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
