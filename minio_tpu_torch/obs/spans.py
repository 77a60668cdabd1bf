"""Request-scoped tracing, the port of minio_tpu/obs/spans.py: span
trees over the flat trace plane (Dapper-style; the reference stamps ``x-amz-request-id`` on every
response and ships flat per-layer traces — this module adds the shared
identity those layers lack).

A ``SpanContext`` (trace_id, span_id, parent_span_id, sampled) rides a
contextvar: the HTTP server opens a root per request, objectlayer /
storage / dispatch / RPC layers open children, and the dispatch queue —
whose flushes serve items from MANY requests — records one kernel span
per flush with *span links* to every coalesced item's context, so
per-request trees stay truthful under batching.

Tail sampling: every request is cheaply tracked (bounded per-trace span
buffers, O(1) appends under one lock), and only traces that breach
their QoS class latency budget (``qos.budget.budget_s``) or fail are
assembled and kept in a bounded slow-trace store — queryable via
``GET /minio/admin/v3/trace?trace_id=...`` and listed by ``?slow=1``.
Peer-side spans of the same trace (propagated over the
``x-minio-tpu-traceparent`` RPC header) land in the peer's fragment
store and merge into the caller's tree on ``?peers=1``.

Disable the whole plane with ``MINIO_TPU_TRACE_SPANS=0``; sizes via
``MINIO_TPU_SLOW_TRACES`` (store capacity) and
``MINIO_TPU_TRACE_FRAGMENTS`` (the peer-fragment store's).
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass

#: RPC header carrying the caller's span context (W3C traceparent
#: shape: ``00-<trace_id>-<span_id>-<flags>``); lowercase because the
#: server's header map is lowercased.
RPC_HEADER = "x-minio-tpu-traceparent"

#: bounded tracking: concurrently-active traces and spans kept per trace
MAX_ACTIVE_TRACES = int(os.environ.get("MINIO_TPU_TRACE_ACTIVE_MAX",
                                       "1024"))
MAX_SPANS_PER_TRACE = int(os.environ.get("MINIO_TPU_TRACE_SPANS_MAX",
                                         "512"))


def enabled() -> bool:
    return os.environ.get("MINIO_TPU_TRACE_SPANS", "1") != "0"


@dataclass
class SpanContext:
    trace_id: str
    span_id: str
    parent_span_id: str = ""
    sampled: bool = True


_current: contextvars.ContextVar[SpanContext | None] = \
    contextvars.ContextVar("minio_tpu_span_ctx", default=None)


def current() -> SpanContext | None:
    """The calling context's span, or None outside any traced request."""
    return _current.get()


def new_trace_id() -> str:
    """32-hex trace id — doubles as the S3 ``x-amz-request-id``."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def to_traceparent(ctx: SpanContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-" \
           f"{'01' if ctx.sampled else '00'}"


def parse_traceparent(value: str) -> SpanContext | None:
    """Header -> the CALLER's context (its span_id becomes the local
    server span's parent). None on anything malformed — a bad header
    must never fail the request it rode in on."""
    try:
        version, trace_id, span_id, flags = value.strip().split("-")
    except (ValueError, AttributeError):
        return None
    if version != "00" or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return SpanContext(trace_id=trace_id, span_id=span_id,
                       sampled=flags == "01")


def wrap_ctx(fn):
    """Bind ``fn`` to the caller's contextvars (span context included)
    so pool-executed storage fan-outs still record into the right
    trace — contextvars do not cross thread-pool submissions on their
    own."""
    ctx = contextvars.copy_context()

    def run(*a, **kw):
        return ctx.run(fn, *a, **kw)

    return run


# --- active-trace span buffers ----------------------------------------------

#: trace_id -> {"spans": [span dicts], "refs": n, "frag": bool}; refs
#: counts concurrent openers (a peer may serve several RPCs of one
#: trace at once) — the last closer stores the buffer.
_active: dict[str, dict] = {}
_lock = threading.Lock()


def _drop(reason: str) -> None:
    try:
        from . import metrics as mx
        mx.inc("minio_tpu_trace_spans_dropped_total", reason=reason)
    except Exception:  # noqa: BLE001 — obs never breaks the hot path
        pass


def _begin(trace_id: str, frag: bool) -> bool:
    """Register (or ref) a trace buffer; False when the active-trace cap
    refuses tracking (the request still runs, just unsampled)."""
    with _lock:
        ent = _active.get(trace_id)
        if ent is not None:
            ent["refs"] += 1
            return True
        if len(_active) >= MAX_ACTIVE_TRACES:
            full = True
        else:
            _active[trace_id] = {"spans": [], "refs": 1, "frag": frag}
            full = False
    if full:
        _drop("active_cap")
        return False
    return True


def _end(trace_id: str) -> list[dict] | None:
    """Deref the buffer; the last closer gets the span list."""
    with _lock:
        ent = _active.get(trace_id)
        if ent is None:
            return None
        ent["refs"] -= 1
        if ent["refs"] > 0:
            return None
        del _active[trace_id]
        return ent["spans"]


def record(span: dict) -> None:
    """Append one finished span to its trace's buffer. A span whose
    trace already finished (dispatch done-callbacks legitimately race
    the request's end: ``Future.set_result`` wakes the waiting request
    thread before invoking callbacks) still attaches to the stored
    slow-trace entry when one was kept; only spans of discarded traces
    drop."""
    tid = span.get("trace_id", "")
    dropped = ""
    with _lock:
        ent = _active.get(tid)
        if ent is None:
            dropped = "trace_gone"
        elif len(ent["spans"]) >= MAX_SPANS_PER_TRACE:
            dropped = "span_cap"
        else:
            ent["spans"].append(span)
    if dropped == "trace_gone":
        late = store().append_late(tid, span)
        if late == "ok":
            return
        if late == "cap":
            dropped = "span_cap"
    if dropped:
        _drop(dropped)


def begin_request(trace_id: str) -> tuple[SpanContext, object]:
    """Open a request root: registers the trace buffer, installs the
    root context. Returns (ctx, token) for ``finish_request``."""
    sampled = enabled() and _begin(trace_id, frag=False)
    ctx = SpanContext(trace_id=trace_id, span_id=new_span_id(),
                      sampled=sampled)
    tok = _current.set(ctx)
    return ctx, tok


def _request_budget_s(cls: str) -> float:
    from ..qos.budget import budget_s
    return budget_s(cls)


def finish_request(ctx: SpanContext, token, *, name: str,
                   duration_s: float, cls: str = "interactive",
                   method: str = "", path: str = "", status: int = 0,
                   error: str = "", node: str = "", remote: str = "",
                   attrs: dict | None = None) -> None:
    """Close a request root: records the root span, pops the buffer and
    makes the tail decision — traces that breached their QoS class
    budget (or errored) are kept in the slow-trace store."""
    try:
        _current.reset(token)
    except ValueError:
        pass  # finished from a different context (teardown paths)
    if not ctx.sampled:
        return
    root = {"name": name, "trace_id": ctx.trace_id,
            "span_id": ctx.span_id, "parent_span_id": "",
            "time": time.time() - duration_s,
            "duration_s": round(duration_s, 6), "error": error,
            "attrs": {k: v for k, v in {
                "method": method, "path": path, "status": status,
                "class": cls, "remote": remote, **(attrs or {}),
            }.items() if v not in ("", 0, None) or k == "status"}}
    spans = _end(ctx.trace_id)
    if spans is None:
        spans = []
    spans.append(root)
    budget = _request_budget_s(cls)
    breached = duration_s > budget
    # 503 SlowDown is EXPECTED backpressure from admission control, not
    # a server failure — a flood of overload rejects must not evict the
    # genuinely slow traces an operator needs during that very overload
    failed = bool(error) or (status >= 500 and status != 503)
    if not (breached or failed):
        return
    store().put({
        "trace_id": ctx.trace_id, "time": root["time"], "name": name,
        "duration_s": round(duration_s, 6), "status": status,
        "class": cls, "budget_s": round(budget, 6),
        "reason": "budget" if breached else "error",
        "slow": True, "node": node, "spans": spans,
    })


@contextlib.contextmanager
def span(name: str, **attrs):
    """One child span of the current context; yields the child's
    SpanContext (None when nothing is being traced — zero-cost path)."""
    parent = _current.get()
    if parent is None or not parent.sampled or not enabled():
        yield None
        return
    child = SpanContext(trace_id=parent.trace_id, span_id=new_span_id(),
                        parent_span_id=parent.span_id, sampled=True)
    tok = _current.set(child)
    t_wall = time.time()
    t0 = time.perf_counter()
    err = ""
    try:
        yield child
    except BaseException as e:
        err = f"{type(e).__name__}: {e}"
        raise
    finally:
        _current.reset(tok)
        try:
            record({"name": name, "trace_id": child.trace_id,
                    "span_id": child.span_id,
                    "parent_span_id": child.parent_span_id,
                    "time": t_wall,
                    "duration_s": round(time.perf_counter() - t0, 6),
                    "error": err,
                    "attrs": {k: v for k, v in attrs.items()
                              if v not in ("", None)}})
        except Exception:  # noqa: BLE001 — obs never fails the work
            pass


@contextlib.contextmanager
def maybe_root(name: str, cls: str = "background", node: str = "",
               **attrs):
    """A child span inside a traced request, or a fresh root trace
    otherwise — heals triggered by a request join its tree, background
    heals get their own tail-sampled trace (so the heal-p99 worst
    sample always has a trace to link to)."""
    if not enabled():
        yield None
        return
    if _current.get() is not None:
        with span(name, **attrs) as c:
            yield c
        return
    ctx, tok = begin_request(new_trace_id())
    t0 = time.perf_counter()
    err = ""
    try:
        yield ctx
    except BaseException as e:
        err = f"{type(e).__name__}: {e}"
        raise
    finally:
        try:
            finish_request(ctx, tok, name=name,
                           duration_s=time.perf_counter() - t0, cls=cls,
                           error=err, node=node, attrs=attrs)
        except Exception:  # noqa: BLE001 — obs never fails the work
            pass


@contextlib.contextmanager
def fragment(ctx_in: SpanContext | None, name: str, node: str = "",
             **attrs):
    """Peer-side server span for an incoming RPC that carried a
    traceparent header: spans recorded underneath share the CALLER's
    trace_id; on close the fragment lands in this node's store, where
    the caller's ``?trace_id=...&peers=1`` query picks it up."""
    if ctx_in is None or not ctx_in.sampled or not enabled():
        yield None
        return
    if not _begin(ctx_in.trace_id, frag=True):
        # cap refused tracking: an unmatched _end() here would deref a
        # CONCURRENT fragment of the same trace mid-flight — serve the
        # RPC untraced instead
        yield None
        return
    child = SpanContext(trace_id=ctx_in.trace_id, span_id=new_span_id(),
                        parent_span_id=ctx_in.span_id, sampled=True)
    tok = _current.set(child)
    t_wall = time.time()
    t0 = time.perf_counter()
    err = ""
    try:
        yield child
    except BaseException as e:
        err = f"{type(e).__name__}: {e}"
        raise
    finally:
        _current.reset(tok)
        try:
            record({"name": name, "trace_id": child.trace_id,
                    "span_id": child.span_id,
                    "parent_span_id": child.parent_span_id,
                    "time": t_wall,
                    "duration_s": round(time.perf_counter() - t0, 6),
                    "error": err,
                    "attrs": {"node": node,
                              **{k: v for k, v in attrs.items()
                                 if v not in ("", None)}}})
            spans = _end(ctx_in.trace_id)
            if spans:
                store().put_fragment(ctx_in.trace_id, spans, node)
        except Exception:  # noqa: BLE001 — obs never fails the work
            pass


# --- slow-trace store --------------------------------------------------------


def assemble(spans: list[dict]) -> list[dict]:
    """Flat span records -> nested tree(s): each node is the span dict
    plus ``children`` (time-ordered). Spans whose parent is absent
    (cross-node fragments before a merge) surface as extra roots."""
    by_id: dict[str, dict] = {}
    for s in spans:
        node = dict(s)
        node["children"] = []
        by_id[s.get("span_id", "")] = node
    roots = []
    for s in spans:
        node = by_id[s.get("span_id", "")]
        parent = by_id.get(s.get("parent_span_id", ""))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda c: c.get("time", 0.0))
    roots.sort(key=lambda c: c.get("time", 0.0))
    return roots


class SlowTraceStore:
    """Bounded keep of assembled slow/error traces plus peer-side
    fragments, newest-first eviction-by-capacity (two separate caps so
    RPC fragment churn can never evict a slow trace)."""

    def __init__(self, cap: int | None = None,
                 frag_cap: int | None = None):
        def _env(name: str, default: int) -> int:
            try:
                return max(4, int(os.environ.get(name, str(default))))
            except ValueError:
                return default
        self.cap = cap if cap is not None else \
            _env("MINIO_TPU_SLOW_TRACES", 128)
        self.frag_cap = frag_cap if frag_cap is not None else \
            _env("MINIO_TPU_TRACE_FRAGMENTS", 256)
        self._slow: OrderedDict[str, dict] = OrderedDict()
        self._frags: OrderedDict[str, dict] = OrderedDict()
        self._lock = threading.Lock()

    def put(self, entry: dict) -> None:
        tid = entry.get("trace_id", "")
        if not tid:
            return
        with self._lock:
            self._slow[tid] = entry
            self._slow.move_to_end(tid)
            while len(self._slow) > self.cap:
                self._slow.popitem(last=False)

    def put_fragment(self, trace_id: str, spans: list[dict],
                     node: str = "") -> None:
        if not trace_id:
            return
        with self._lock:
            ent = self._frags.get(trace_id)
            if ent is None:
                ent = self._frags[trace_id] = {
                    "trace_id": trace_id, "time": time.time(),
                    "node": node, "slow": False, "reason": "fragment",
                    "spans": []}
            room = MAX_SPANS_PER_TRACE - len(ent["spans"])
            ent["spans"].extend(spans[:max(0, room)])
            self._frags.move_to_end(trace_id)
            while len(self._frags) > self.frag_cap:
                self._frags.popitem(last=False)

    def append_late(self, trace_id: str, span: dict) -> str | None:
        """Attach a span that finished after its trace was stored (a
        dispatch callback racing request end). Returns "ok" when
        appended, "cap" when the stored trace is full (the caller
        counts a span_cap drop), None when the trace was never kept."""
        with self._lock:
            for reg in (self._slow, self._frags):
                ent = reg.get(trace_id)
                if ent is not None:
                    if len(ent["spans"]) >= MAX_SPANS_PER_TRACE:
                        return "cap"
                    ent["spans"].append(span)
                    return "ok"
        return None

    def contains(self, trace_id: str) -> bool:
        """O(1) existence probe — the exemplar emitters call this per
        metrics scrape / top-api row, where get()'s span-list copy
        under the store lock would be pure waste."""
        with self._lock:
            return trace_id in self._slow or trace_id in self._frags

    def get(self, trace_id: str) -> dict | None:
        """Stored trace by id; a slow entry and a local fragment of the
        same trace merge into one span list."""
        with self._lock:
            slow = self._slow.get(trace_id)
            frag = self._frags.get(trace_id)
            if slow is None and frag is None:
                return None
            base = dict(slow or frag)
            spans = list(base.get("spans", ()))
            if slow is not None and frag is not None:
                spans += list(frag.get("spans", ()))
            base["spans"] = spans
            return base

    def list_slow(self, n: int = 50) -> list[dict]:
        """Newest-first summaries of kept slow/error traces (full span
        lists stay behind ``get``/``?trace_id=`` — listings stay light)."""
        if n <= 0:
            return []
        with self._lock:
            entries = list(self._slow.values())[-n:]
        return [{k: v for k, v in e.items() if k != "spans"}
                | {"span_count": len(e.get("spans", ()))}
                for e in reversed(entries)]

    def clear(self) -> None:
        with self._lock:
            self._slow.clear()
            self._frags.clear()


_collect_q = None
_collect_lock = threading.Lock()


def schedule_collect(trace_id: str, peers) -> None:
    """Queue a kept trace for peer-fragment collection on ONE bounded
    background worker — a thread per kept trace (and an RPC fan-out
    per peer) would scale with request rate exactly when the node is
    saturated and budget breaches spike. Overflow drops the collection
    (counted), never blocks the request path."""
    global _collect_q
    if _collect_q is None:
        with _collect_lock:
            if _collect_q is None:
                import queue as _qm
                q = _qm.Queue(maxsize=64)
                threading.Thread(target=_collect_loop, args=(q,),
                                 daemon=True,
                                 name="span-frag-collect").start()
                _collect_q = q
    try:
        _collect_q.put_nowait((trace_id, list(peers)))
    except Exception:  # noqa: BLE001 — queue full
        _drop("collect_backlog")


def _collect_loop(q) -> None:
    while True:
        tid, peers = q.get()
        try:
            collect_fragments(tid, peers)
        except Exception:  # noqa: BLE001 — best-effort enrichment,
            _drop("peer_collect")  # but never silently (graftlint GL007)


def collect_fragments(trace_id: str, peers) -> None:
    """Pull every peer's fragment of a just-KEPT trace into the local
    store. Fragments live in each peer's small LRU where steady-state
    RPC churn evicts them within seconds — but the keep decision is
    made here on the caller, so the caller snapshots them immediately
    (one tiny RPC per peer, only for tail-sampled traces). After this,
    ``?trace_id=`` serves the full cross-node tree even long after the
    peers forgot their halves."""
    for peer in peers:
        try:
            frag = peer.trace_tree(trace_id)
        except Exception:  # noqa: BLE001 — peer down: partial tree
            continue
        spans = (frag or {}).get("spans", ())
        if spans:
            store().put_fragment(trace_id, list(spans),
                                 (frag or {}).get("node", ""))


_store: SlowTraceStore | None = None
_store_lock = threading.Lock()


def store() -> SlowTraceStore:
    global _store
    if _store is None:
        with _store_lock:
            if _store is None:
                _store = SlowTraceStore()
    return _store
