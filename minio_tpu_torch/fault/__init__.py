"""The fault-injection plane (chaos harness), the port of
minio_tpu/fault/__init__.py — Basiri et al., "Chaos Engineering" (IEEE
Software 2016): a process-wide registry of injection rules that the
storage and dispatch layers consult at their hot entry points, so tests
and operators can prove that the degraded paths (parity rebuild, quorum
reduce, MRF heal, hedged reads, a failed flush) fire.

A rule targets ``layer x target x op``:

* ``layer``: ``disk`` (storage/xlstorage.py: every op, every shard read,
  the write steps of the commit protocol), ``kernel`` (runtime/dispatch.py:
  every flush), ``rpc`` (dist/rpc.py: every call, keyed by peer URL and
  RPC method) and ``node`` (dist/rpc.py: every call toward a peer, keyed
  by peer URL and calling node; ``fault/node.py`` arms partitions, slow
  peers and isolation there, and kills and restarts in-process nodes).
* ``target``: a substring of the disk endpoint / peer URL, or ``*``; the
  ``kernel`` layer's target is ``device``.
* ``op``: a storage op (``read_all``, ``read_at``, ``rename_data``, a
  write step, ...), a dispatch op (``encode``, ``masked``, ``fused``, ...),
  an RPC method, or ``*``. For the ``node`` layer the op slot carries a
  source-node URL substring, passed as the action's argument:
  ``node:http://B:*:partition(http://A)``.

Actions: ``error(<TypedStorageError>)``, ``delay(ms[,jitter_ms])``,
``partition``, ``bitrot`` (the caller corrupts the returned shard bytes),
``hang[(s)]`` (a long stall that ``clear()`` interrupts), ``flaky(p[,seed
[,error]])`` (a typed error with probability p from the rule's seeded RNG:
the same sequence as the JAX package for the same seed), ``crash`` (raises
:class:`SimulatedCrash`, a BaseException no cleanup handler catches: a
kill -9 at a write step) and ``torn`` (the caller truncates its pending
tmp file at a random offset before the commit). Every rule carries an
optional hit budget (``@count=``) and TTL (``@ttl=``).

Arming: this module's ``arm()``/``parse_rule()``, the admin
``/minio/admin/v3/fault`` op and the ``fault`` config subsystem
(``fault.enable``, ``fault.rules`` = ``MINIO_TPU_FAULT_RULES``). Each
injection counts ``minio_tpu_fault_injected_total{layer,action}``.

When nothing is armed on a layer an injection point costs one dict read.
"""
from __future__ import annotations

import itertools
import logging
import os
import random
import re
import threading
import time
from dataclasses import dataclass, field

from ..utils import errors

log = logging.getLogger(__name__)

LAYERS = ("disk", "rpc", "kernel", "node")
ACTIONS = ("error", "delay", "bitrot", "hang", "flaky", "crash", "torn",
           "partition")


class SimulatedCrash(BaseException):
    """Process death at a write step (chaos harness). A BaseException on
    purpose: every cleanup handler in the tree catches Exception, so none
    of the in-process failure paths (tmp cleanup, writer aborts) run, and
    the disks are left as a kill -9 at that instruction would leave
    them."""

#: typed storage errors a rule may raise by name
ERRORS_BY_NAME = {c.__name__: c for c in [
    errors.DiskNotFound, errors.FaultyDisk, errors.DiskFull,
    errors.DiskAccessDenied, errors.FileNotFound, errors.FileCorrupt,
    errors.FileAccessDenied, errors.VolumeNotFound, errors.IsNotRegular,
    errors.RPCError, errors.ErasureReadQuorum, errors.ErasureWriteQuorum,
]}

DEFAULT_HANG_S = 30.0


@dataclass
class FaultRule:
    layer: str
    target: str = "*"
    op: str = "*"
    action: str = "error"
    error: str = "FaultyDisk"
    delay_ms: float = 0.0
    jitter_ms: float = 0.0
    prob: float = 1.0
    hang_s: float = DEFAULT_HANG_S
    count: int = -1          # remaining firings (-1 = unlimited)
    ttl_s: float = 0.0       # 0 = no expiry
    seed: int | None = None
    id: str = ""
    hits: int = 0
    armed_at: float = field(default_factory=time.monotonic)
    _rng: random.Random = field(default=None, repr=False)

    def __post_init__(self):
        if self.layer not in LAYERS:
            raise ValueError(f"unknown fault layer {self.layer!r}")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.action in ("error", "flaky") and \
                self.error not in ERRORS_BY_NAME:
            raise ValueError(f"unknown typed error {self.error!r}")
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"flaky probability {self.prob} not in [0,1]")
        self._rng = random.Random(self.seed)

    def expired(self, now: float) -> bool:
        return (self.ttl_s > 0 and now - self.armed_at > self.ttl_s) \
            or self.count == 0

    def matches(self, target: str, op: str) -> bool:
        if self.target != "*" and self.target not in target:
            return False
        if self.layer == "node":
            # the op slot carries a SOURCE-node URL: substring match,
            # like targets (asymmetric partitions name both ends)
            return self.op == "*" or (bool(op) and self.op in op)
        return self.op in ("*", op)

    def to_dict(self) -> dict:
        return {"id": self.id, "layer": self.layer, "target": self.target,
                "op": self.op, "action": self.action, "error": self.error,
                "delay_ms": self.delay_ms, "jitter_ms": self.jitter_ms,
                "prob": self.prob, "hang_s": self.hang_s,
                "count": self.count, "ttl_s": self.ttl_s,
                "seed": self.seed, "hits": self.hits}


_ACTION_RE = re.compile(
    r"^(?P<action>[a-z]+)(?:\((?P<args>[^)]*)\))?"
    r"(?P<mods>(?:@[a-z]+=[^@]+)*)$")


def parse_rule(spec: str) -> FaultRule:
    """The compact rule grammar:

        <layer>:<target>:<op>:<action>[(<args>)][@count=N][@ttl=S]

    e.g. ``disk:*:read_at:delay(200,50)@ttl=30``,
    ``disk:/data/d3:*:error(FaultyDisk)@count=8``,
    ``rpc:http://peer:9000:readversion:flaky(0.3,42)``,
    ``kernel:*:encode:error(FaultyDisk)@count=1``,
    ``node:http://b:9000:*:partition(http://a:9000)``.
    Empty target/op mean ``*``; the target AND action arguments may
    themselves contain colons (peer URLs) — the action is matched
    anchored at the end, the op is the colon-free segment before it.
    """
    try:
        layer, rest = spec.strip().split(":", 1)
    except ValueError:
        raise ValueError(f"unparseable fault rule {spec!r}") from None
    m_act = re.search(
        r":(?P<act>[a-z]+(?:\([^)]*\))?(?:@[a-z]+=[^@]+)*)$", rest)
    if m_act is None:
        raise ValueError(f"unparseable fault rule {spec!r}")
    act_part = m_act["act"]
    head = rest[:m_act.start()]
    target, sep, op = head.rpartition(":")
    if not sep:
        raise ValueError(f"unparseable fault rule {spec!r}")
    target, op = target or "*", op or "*"
    m = _ACTION_RE.match(act_part)
    if m is None:
        raise ValueError(f"unparseable fault rule {spec!r}")
    action = m["action"]
    args = [a.strip() for a in (m["args"] or "").split(",") if a.strip()]
    kw: dict = {}
    if action == "error" and args:
        kw["error"] = args[0]
    elif action == "delay":
        if not args:
            raise ValueError("delay() needs a milliseconds argument")
        kw["delay_ms"] = float(args[0])
        if len(args) > 1:
            kw["jitter_ms"] = float(args[1])
    elif action == "hang" and args:
        kw["hang_s"] = float(args[0])
    elif action == "flaky":
        if not args:
            raise ValueError("flaky() needs a probability argument")
        kw["prob"] = float(args[0])
        if len(args) > 1:
            kw["seed"] = int(args[1])
        if len(args) > 2:
            kw["error"] = args[2]
    elif action == "partition" and args:
        # the source-node selector rides as the action argument (URLs
        # hold colons, so it cannot survive the op-slot split); it
        # lands in the op field, which node-layer matching reads as a
        # src substring
        op = args[0]
    for mod in (m["mods"] or "").split("@"):
        if not mod:
            continue
        key, _, val = mod.partition("=")
        if key == "count":
            kw["count"] = int(val)
        elif key == "ttl":
            kw["ttl_s"] = float(val)
        elif key == "seed":
            kw["seed"] = int(val)
        else:
            raise ValueError(f"unknown fault rule modifier @{key}")
    return FaultRule(layer=layer, target=target, op=op, action=action, **kw)


class _Bitrot:
    """Sentinel returned by inject(): the caller owns the data and must
    corrupt it via :func:`corrupt`."""


BITROT = _Bitrot()


class _Torn:
    """Returned by inject() for a ``torn`` rule: the caller owns the
    about-to-commit tmp file and must truncate it via
    :func:`torn_truncate` before the rename makes it visible. Carries
    the rule's seeded RNG so the cut offset is reproducible — the same
    determinism contract ``flaky`` keeps (seed via ``@seed=K``)."""

    def __init__(self, rng: random.Random | None = None):
        self.rng = rng


class FaultRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._rules: dict[str, FaultRule] = {}
        self._ids = itertools.count(1)
        #: set (then re-cleared) by clear()/disarm() so armed hang/delay
        #: sleeps wake up instead of stalling tests for the full duration
        self._wake = threading.Event()
        #: per-layer armed flags — the production fast path reads these
        #: without the lock (GIL-atomic dict reads)
        self._armed: dict[str, bool] = {}

    # -- arming ---------------------------------------------------------------

    def arm(self, rule: FaultRule | str) -> str:
        if isinstance(rule, str):
            rule = parse_rule(rule)
        with self._lock:
            rule.id = f"f{next(self._ids)}"
            rule.armed_at = time.monotonic()
            self._rules[rule.id] = rule
            self._recount()
        return rule.id

    def disarm(self, rule_id: str) -> bool:
        with self._lock:
            gone = self._rules.pop(rule_id, None) is not None
            self._recount()
        self._interrupt()
        return gone

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()
            self._recount()
        self._interrupt()

    def _interrupt(self):
        self._wake.set()
        self._wake = threading.Event()

    def _recount(self):
        self._armed = {layer: any(r.layer == layer
                                  for r in self._rules.values())
                       for layer in LAYERS}

    def rules(self) -> list[dict]:
        now = time.monotonic()
        with self._lock:
            self._sweep(now)
            return [r.to_dict() for r in self._rules.values()]

    def armed(self, layer: str | None = None) -> bool:
        if layer is None:
            return any(self._armed.values())
        return self._armed.get(layer, False)

    # -- injection ------------------------------------------------------------

    def _sweep(self, now: float):
        dead = [rid for rid, r in self._rules.items() if r.expired(now)]
        for rid in dead:
            del self._rules[rid]
        if dead:
            self._recount()

    def _match(self, layer: str, target: str, op: str) -> FaultRule | None:
        """First matching live rule, with hit accounting — called under
        no lock on the fast path, under the lock once a layer is armed."""
        now = time.monotonic()
        with self._lock:
            self._sweep(now)
            for r in self._rules.values():
                if r.layer != layer or not r.matches(target, op):
                    continue
                if r.action == "flaky" and r._rng.random() >= r.prob:
                    continue  # coin said pass — later rules still apply
                r.hits += 1
                if r.count > 0:
                    r.count -= 1
                return r
        return None

    def _sleep(self, seconds: float):
        """clear()-interruptible sleep so disarming releases hangs."""
        wake = self._wake
        wake.wait(seconds)

    def inject(self, layer: str, target: str, op: str):
        """Consult the registry at an injection point. Raises a typed
        storage error (``error``/``flaky``), sleeps (``delay``/``hang``),
        returns :data:`BITROT` when the caller must corrupt its payload,
        else returns None. O(1) no-op when nothing is armed on the
        layer."""
        if not self._armed.get(layer, False):
            return None
        r = self._match(layer, target, op)
        if r is None:
            return None
        from ..obs import metrics as mx
        mx.inc("minio_tpu_fault_injected_total", layer=layer,
               action=r.action)
        self._annotate_span(layer, target, op, r)
        if r.action == "delay":
            jitter = r._rng.uniform(0.0, r.jitter_ms) if r.jitter_ms else 0.0
            self._sleep((r.delay_ms + jitter) / 1e3)
            return None
        if r.action == "hang":
            self._sleep(r.hang_s)
            return None
        if r.action == "bitrot":
            return BITROT
        if r.action == "torn":
            return _Torn(r._rng)
        if r.action == "partition":
            # transport-class: the RPC client treats it exactly like a
            # dropped connection (retry budget, then offline marking)
            raise errors.RPCError(
                f"fault-injected partition [{r.id} "
                f"{layer}:{r.target}:{r.op}] {op or '?'} -> {target}")
        if r.action == "crash":
            raise SimulatedCrash(
                f"fault-injected crash [{r.id} {layer}:{r.target}:{r.op}] "
                f"{target} at {op}")
        raise ERRORS_BY_NAME[r.error](
            f"fault-injected [{r.id} {layer}:{r.target}:{r.op}] {target}")

    def blocked(self, layer: str, target: str, op: str) -> bool:
        """Is a live ``partition`` rule standing between op(src) and
        target(dst)? Unlike :meth:`inject` this takes no hit and fires
        no metrics — it gates background probes (the RPC reconnect
        ping) that must not flip a partitioned peer back online."""
        if not self._armed.get(layer, False):
            return False
        now = time.monotonic()
        with self._lock:
            self._sweep(now)
            return any(r.layer == layer and r.action == "partition"
                       and r.matches(target, op)
                       for r in self._rules.values())

    @staticmethod
    def _annotate_span(layer: str, target: str, op: str, r: FaultRule):
        """Record the injection into the live request's span tree (if
        sampled) so a chaos run's traces show exactly where faults
        landed."""
        try:
            from ..obs import spans as sp
            ctx = sp.current()
            if ctx is None or not ctx.sampled:
                return
            sp.record({
                "name": f"fault.{r.action}", "trace_id": ctx.trace_id,
                "span_id": sp.new_span_id(),
                "parent_span_id": ctx.span_id, "time": time.time(),
                "duration_s": 0.0, "error": "",
                "attrs": {"layer": layer, "target": target, "op": op,
                          "rule": r.id}})
        except Exception:  # noqa: BLE001 — obs must never break injection
            log.debug("fault span not recorded", exc_info=True)


_registry = FaultRegistry()


def registry() -> FaultRegistry:
    return _registry


def arm(rule: FaultRule | str) -> str:
    return _registry.arm(rule)


def disarm(rule_id: str) -> bool:
    return _registry.disarm(rule_id)


def clear() -> None:
    _registry.clear()


def rules() -> list[dict]:
    return _registry.rules()


def armed(layer: str | None = None) -> bool:
    return _registry.armed(layer)


def inject(layer: str, target: str, op: str):
    return _registry.inject(layer, target, op)


def blocked(layer: str, target: str, op: str) -> bool:
    return _registry.blocked(layer, target, op)


def torn_truncate(path: str, rng: random.Random | None = None) -> int:
    """The file-mangling half of a ``torn`` rule: truncate ``path`` at a
    random offset strictly inside [0, size), simulating the partial page
    writeback a power cut leaves behind. A directory (a staged dataDir
    about to be renamed) tears one of its files, chosen by the same RNG.
    ``rng`` is the rule's seeded RNG (from the :class:`_Torn` result) so
    a failing cut reproduces; falls back to the global RNG for direct
    callers. Returns the new size (-1 when the target is missing/empty —
    nothing to tear)."""
    if os.path.isdir(path):
        files = sorted(
            os.path.join(r, f)
            for r, _d, fs in os.walk(path) for f in fs)
        if not files:
            return -1
        path = (rng or random).choice(files)
    try:
        size = os.path.getsize(path)
    except OSError:
        return -1
    if size <= 0:
        return -1
    cut = (rng or random).randrange(0, size)
    with open(path, "r+b") as f:
        f.truncate(cut)
    return cut


def corrupt(data: bytes) -> bytes:
    """Flip one byte (the shard-corruption half of a ``bitrot`` rule);
    bitrot readers detect it as a digest mismatch."""
    if not data:
        return data
    out = bytearray(data)
    out[len(out) // 2] ^= 0xFF
    return bytes(out)


def apply_config(cfg) -> None:
    """Declaratively (re-)arm the config KVS rule set (``fault.enable``
    + ``fault.rules``, a ``;``-separated compact-grammar list). Called
    at server start and on every dynamic ``fault`` subsystem change;
    replaces only KVS-sourced rules (admin-armed rules are unmanaged
    here — clear them via the admin op)."""
    try:
        enable = cfg.get("fault", "enable") not in ("0", "off", "false")
        specs = [s for s in cfg.get("fault", "rules").split(";")
                 if s.strip()]
    except KeyError:
        return
    with _registry._lock:
        stale = [rid for rid, r in _registry._rules.items()
                 if getattr(r, "_from_config", False)]
        for rid in stale:
            del _registry._rules[rid]
        _registry._recount()
    # config-driven disarm must release in-flight hang/delay sleeps just
    # like the admin DELETE path does
    _registry._interrupt()
    if not enable:
        return
    for spec in specs:
        try:
            r = parse_rule(spec)
        except ValueError:
            from ..obs.logger import log_sys
            log_sys().event("warning", "fault", f"bad KVS rule {spec!r}")
            continue
        r._from_config = True
        _registry.arm(r)
