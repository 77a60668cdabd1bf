"""Node-layer chaos, the port of minio_tpu/fault/node.py — whole-peer
fault operations over the rule registry plus an in-process node harness
surface.

Two kinds of primitive compose here:

* **Wire rules** (armed into the shared :mod:`minio_tpu_torch.fault`
  registry, layer ``node``): :func:`partition` (asymmetric A↛B RPC
  blackhole — calls from matching sources toward the target peer raise
  a transport-class error before touching the wire, and the reconnect
  ping is gated so the peer STAYS offline), :func:`slow_peer` (every
  call toward the peer pays a delay — the peer health EWMA sees it),
  and :func:`isolate` (bidirectional: two partition rules).

* **Process operations** on registered in-process nodes:
  :func:`node_kill` hard-stops a ``dist.node.Node``'s HTTP listener and
  background services (peers see connection-refused — the same signal
  a SIGKILL'd process emits) and :func:`node_restart` brings a fresh
  ``Node`` up over the same endpoints/port. Registration is explicit
  (``register_node``) because only test/loadgen topologies run several
  nodes in one process; a real deployment kills processes.

Every rule armed through here is tagged so :func:`clear_node_faults`
can drop the node layer without disturbing disk/rpc/kernel rules a
test armed separately.
"""
from __future__ import annotations

import threading

from . import arm, registry

#: in-process node table: name -> dist.node.Node (or a restart factory)
_nodes: dict[str, object] = {}
_nodes_lock = threading.Lock()


def register_node(name: str, node) -> None:
    """Make an in-process ``dist.node.Node`` addressable by
    :func:`node_kill`/:func:`node_restart` (test/loadgen topologies)."""
    with _nodes_lock:
        _nodes[name] = node


def unregister_node(name: str) -> None:
    with _nodes_lock:
        _nodes.pop(name, None)


def _get_node(name: str):
    with _nodes_lock:
        node = _nodes.get(name)
    if node is None:
        raise KeyError(f"no registered node {name!r} "
                       f"(known: {sorted(_nodes)})")
    return node


# -- wire rules ---------------------------------------------------------------


def _arm_node(spec_rule) -> str:
    rid = arm(spec_rule)
    with registry()._lock:
        r = registry()._rules.get(rid)
        if r is not None:
            r._node_layer_tag = True
    return rid


def partition(dst_url: str, src_url: str = "*", **mods) -> str:
    """Asymmetric blackhole: calls FROM ``src_url`` (substring; ``*``
    = every caller in this process) TO ``dst_url`` fail with a
    transport-class error. Returns the rule id."""
    action = "partition" if src_url == "*" else f"partition({src_url})"
    return _arm_node(_spec(dst_url, action, **mods))


def isolate(url: str) -> list[str]:
    """Cut a node off in both directions: nobody reaches it, it
    reaches nobody. Two rules — disarm both (or clear_node_faults)."""
    return [partition(url, "*"),
            _arm_node(_spec("*", f"partition({url})"))]


def slow_peer(dst_url: str, ms: float, jitter_ms: float = 0.0,
              **mods) -> str:
    """Every call toward ``dst_url`` pays ``ms`` (+ uniform jitter) of
    extra latency — a sick NIC / saturated peer. The caller's peer
    health EWMA and the latency windows see the slowdown."""
    args = f"{ms:g}" + (f",{jitter_ms:g}" if jitter_ms else "")
    return _arm_node(_spec(dst_url, f"delay({args})", **mods))


def _spec(dst: str, action: str, **mods) -> str:
    tail = "".join(f"@{k.rstrip('_')}={v}" for k, v in mods.items())
    return f"node:{dst}:*:{action}{tail}"


def clear_node_faults() -> int:
    """Disarm every rule armed through this module (partition /
    slow_peer / isolate); leaves disk/rpc/kernel rules alone."""
    reg = registry()
    with reg._lock:
        stale = [rid for rid, r in reg._rules.items()
                 if getattr(r, "_node_layer_tag", False)]
        for rid in stale:
            del reg._rules[rid]
        reg._recount()
    reg._interrupt()
    return len(stale)


# -- process operations -------------------------------------------------------


def node_kill(name: str) -> None:
    """Hard-stop a registered in-process node: close the HTTP listener
    socket and stop the background plane. In-flight handler threads
    die with their connections; peers observe connection-refused — the
    observable signature of a SIGKILL'd server process. The node's
    disks and staged state stay exactly as they were (that is the
    point: the chaos matrix asserts nothing acknowledged is lost)."""
    node = _get_node(name)
    srv = getattr(node, "server", None)
    if srv is None:
        return
    # stop accept loops + background plane, then CLOSE the listening
    # socket (peers get connection-refused, not a hung connect) and
    # SEVER every established keep-alive connection — a dead process
    # takes its sockets with it
    try:
        node.shutdown()
    finally:
        httpd = getattr(srv, "_httpd", None)
        if httpd is not None:
            try:
                httpd.server_close()
            except OSError:
                pass
        for extra in getattr(srv, "_extra_httpds", []):
            try:
                extra.server_close()
            except OSError:
                pass
        closer = getattr(srv, "hard_close_connections", None)
        if closer is not None:
            closer()
    node.server = None


def node_restart(name: str, wait_format_timeout: float = 60.0):
    """Bring a killed node back: build a FRESH ``dist.node.Node`` over
    the same endpoint args / local URL / port (a process restart, not a
    resume — startup recovery and format re-adoption run exactly like
    a real reboot) and re-register it. Returns the new Node."""
    from ..dist.node import Node
    old = _get_node(name)
    spec = getattr(old, "_restart_spec", None)
    if spec is None:
        raise RuntimeError(
            f"node {name!r} carries no restart spec — construct it via "
            "dist.harness.LocalCluster (or set node._restart_spec)")
    node = Node(**spec)
    node._restart_spec = dict(spec)
    node.start(wait_format_timeout=wait_format_timeout)
    register_node(name, node)
    return node
