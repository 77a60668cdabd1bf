"""Runtime lock-order race detector, the port of minio_tpu/obs/lockrank.py
(the Python stand-in for Go's ``-race`` + the lock-rank assertions the
reference relies on in CI).

With ``MINIO_TPU_LOCKRANK=1``, :func:`install` patches ``threading.Lock`` /
``threading.RLock`` with factories that hand **tracked** locks to code
whose *creating frame* lives in ``minio_tpu_torch`` or the port's tests;
every other caller gets a raw lock, so the interpreter's own locking is
never perturbed. The tracked locks wrap the raw ``_thread`` primitives,
never whatever ``threading.Lock`` was when this module loaded: in a
process where another detector already patched the factories (the JAX
package's, which the test suite installs), the port neither wraps that
detector's locks nor loses them: :func:`uninstall` puts back the
factories :func:`install` replaced.

Each tracked acquire pushes onto a per-thread held-lock stack and adds an
edge ``(top-of-stack site) -> (new site)`` to the global lock-order graph,
where a *site* is the ``file:line`` that created the lock (one node per
static lock site — instance churn does not grow the graph). Two detectors
run on top:

* **Cycle (potential ABBA deadlock)**: when a new edge closes a cycle in
  the order graph, a report records the cycle's sites and the full
  acquisition stack captured at each edge's first observation — i.e.
  where B was first taken while A was held, and vice versa.
* **Lock held across a device flush**: ``runtime/dispatch.py`` calls
  :func:`note_blocking` at its flush boundary; if the flushing thread
  holds any tracked lock, a report names the held locks (with their
  acquisition sites) and the flush stack. A lock held across a flush's
  copies and launches is a convoy generator even when it never
  deadlocks.

A contended acquire is timed into the profiler's lock-wait histogram
(``obs/profiler.lock_wait_end``, the ``minio_tpu_lock_wait_seconds{site}``
family) and marks the waiting thread's samples ``lockwait``.

Hot-path cost per acquire is one thread-local list push and one dict
membership test; full stacks are only captured the first time an edge
appears (edges are as static as the code), so steady state adds no
tracebacks. Reports accumulate in-process (bounded) and are read with
:func:`reports`.

Env knobs:

* ``MINIO_TPU_LOCKRANK`` — "1" lets install() activate.
* ``MINIO_TPU_LOCKRANK_FRAMES`` — stack depth kept per edge (default 8).
* ``MINIO_TPU_LOCKRANK_MAX_REPORTS`` — report ring cap (default 64).
"""
from __future__ import annotations

import _thread
import os
import sys
import threading
import time
import traceback

#: the raw primitives every tracked lock wraps, and the untracked locks of
#: this module and the profiler
_RAW_LOCK = _thread.allocate_lock
_RAW_RLOCK = _thread.RLock

_FRAMES = int(os.environ.get("MINIO_TPU_LOCKRANK_FRAMES", "8"))
_MAX_REPORTS = int(os.environ.get("MINIO_TPU_LOCKRANK_MAX_REPORTS", "64"))

#: module-name prefixes whose lock creations get tracked: the port and its
#: tests
_TRACK_PREFIXES = ("minio_tpu_torch", "tests.test_torch_", "test_torch_")

#: the (Lock, RLock) factories install() replaced; None while not
#: installed
_replaced: tuple | None = None
_enabled = False

# all graph/report state below is guarded by an UNtracked lock
_meta = _RAW_LOCK()
_graph: dict[str, set[str]] = {}          # site -> successor sites
_edge_stacks: dict[tuple[str, str], dict] = {}   # first-sight evidence
_reports: list[dict] = []
_suppressed_reports = 0
_contended: dict[str, int] = {}   # site -> contended-acquire count


class _State(threading.local):
    def __init__(self):
        self.held: list["TrackedLock"] = []
        self.counts: dict[int, int] = {}   # id(lock) -> reentry depth


_state = _State()


def enabled() -> bool:
    return _enabled


def _caller_site(depth: int) -> str:
    try:
        f = sys._getframe(depth)
        return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"
    except Exception:  # pragma: no cover — frame depth off the stack
        return "?"


def _stack() -> str:
    """Formatted acquisition stack, lockrank's own frames dropped."""
    here = os.path.abspath(__file__)
    frames = [f for f in traceback.extract_stack()
              if os.path.abspath(f.filename) != here]
    return "".join(traceback.format_list(frames[-_FRAMES:]))


def _add_report(rep: dict) -> None:
    global _suppressed_reports
    with _meta:
        if len(_reports) < _MAX_REPORTS:
            _reports.append(rep)
        else:
            _suppressed_reports += 1


def _find_path(src: str, dst: str) -> list[str] | None:
    """DFS path src -> dst in the order graph (meta lock held)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _graph.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class TrackedLock:
    """Lock/RLock wrapper feeding the per-thread held stack and the
    global order graph. Supports the full lock protocol plus the private
    Condition hooks (``_is_owned``/``_release_save``/``_acquire_restore``)
    so a tracked lock can back a ``threading.Condition``."""

    __slots__ = ("_inner", "site", "name", "_reentrant")

    def __init__(self, inner, site: str, name: str = "",
                 reentrant: bool = False):
        self._inner = inner
        self.site = site
        self.name = name or site
        self._reentrant = reentrant

    # -- tracking ------------------------------------------------------------

    def _note_acquired(self) -> None:
        if not _enabled:
            return
        try:
            self._note_acquired_inner()
        except Exception:  # detector must never break the locked code
            pass

    def _note_acquired_inner(self) -> None:
        st = _state
        if self._reentrant:
            n = st.counts.get(id(self), 0)
            st.counts[id(self)] = n + 1
            if n:                       # reentry: no new order edge
                return
        if st.held:
            top = st.held[-1]
            if top.site != self.site:
                self._note_edge(top)
        st.held.append(self)

    def _note_edge(self, top: "TrackedLock") -> None:
        edge = (top.site, self.site)
        if edge in _edge_stacks:        # GIL-atomic fast path
            return
        evidence = {
            "edge": f"{top.name} -> {self.name}",
            "thread": threading.current_thread().name,
            "stack": _stack(),
        }
        with _meta:
            if edge in _edge_stacks:
                return
            _edge_stacks[edge] = evidence
            _graph.setdefault(top.site, set()).add(self.site)
            # does the new edge close a cycle? (path new.dst -> new.src)
            path = _find_path(self.site, top.site)
        if path is None:
            return
        cycle = [top.site] + path
        with _meta:
            edges = []
            for a, b in zip(cycle, cycle[1:]):
                ev = _edge_stacks.get((a, b))
                if ev:
                    edges.append(dict(ev))
        _add_report({
            "kind": "lock-order-cycle",
            "locks": sorted({top.name, self.name} |
                            {s for s in cycle}),
            "cycle": cycle,
            "edges": edges,
            "thread": threading.current_thread().name,
        })

    def _note_released(self) -> None:
        if not _enabled:
            return
        st = _state
        if self._reentrant:
            n = st.counts.get(id(self), 0)
            if n > 1:
                st.counts[id(self)] = n - 1
                return
            st.counts.pop(id(self), None)
        # locks are not always released LIFO — remove by identity
        for i in range(len(st.held) - 1, -1, -1):
            if st.held[i] is self:
                del st.held[i]
                break

    # -- lock protocol -------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # uncontended fast path: one extra non-blocking try, no timing
        # machinery (steady-state acquires stay one C call + bookkeeping)
        ok = self._inner.acquire(False)
        if not ok and blocking:
            ok = self._wait_acquire(timeout)
        if ok:
            self._note_acquired()
        return ok

    def _wait_acquire(self, timeout: float) -> bool:
        """Contended blocking acquire: the wait is timed into the
        ``minio_tpu_lock_wait_seconds{site}`` histogram and the thread
        is marked waiting so profiler samples taken meanwhile carry the
        ``lockwait`` flag. The profiler keeps these stats under a RAW lock
        — a tracked one here would recurse into its own
        instrumentation."""
        if not _enabled:
            return self._inner.acquire(True, timeout)
        with _meta:
            # a site that ever blocks a thread is demonstrably contended
            # shared state
            _contended[self.site] = _contended.get(self.site, 0) + 1
        try:
            from . import profiler as _prof
            _prof.lock_wait_begin(self.site)
        except Exception:  # noqa: BLE001 — detector must never break
            _prof = None   # the locked code
        t0 = time.monotonic()
        try:
            return self._inner.acquire(True, timeout)
        finally:
            if _prof is not None:
                try:
                    _prof.lock_wait_end(self.site,
                                        time.monotonic() - t0)
                except Exception:  # noqa: BLE001
                    pass

    def release(self) -> None:
        self._note_released()
        self._inner.release()

    def locked(self) -> bool:
        inner_locked = getattr(self._inner, "locked", None)
        return inner_locked() if inner_locked is not None else False

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"<TrackedLock {self.name} inner={self._inner!r}>"

    # -- threading.Condition integration (RLock only) ------------------------

    def _is_owned(self):
        inner = getattr(self._inner, "_is_owned", None)
        if inner is not None:
            return inner()
        # plain-lock fallback (same probe threading.Condition uses)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        st = _state
        # full release regardless of reentry depth: drop the count FIRST
        # so _note_released takes the remove-from-held path
        count = st.counts.pop(id(self), 1) if self._reentrant else 1
        if self._reentrant:
            st.counts[id(self)] = 1
        self._note_released()
        inner_rs = getattr(self._inner, "_release_save", None)
        inner_state = inner_rs() if inner_rs is not None \
            else self._inner.release()
        return (inner_state, count)

    def _acquire_restore(self, state):
        inner_state, count = state
        inner_ar = getattr(self._inner, "_acquire_restore", None)
        if inner_ar is not None:
            inner_ar(inner_state)
        else:
            self._inner.acquire()
        self._note_acquired()
        if self._reentrant and count > 1:
            _state.counts[id(self)] = count


def _should_track() -> bool:
    """Does the frame creating this lock belong to tracked code?
    (factory frame 0 -> patched Lock() caller frame 2)."""
    try:
        mod = sys._getframe(2).f_globals.get("__name__", "")
    except Exception:  # pragma: no cover
        return False
    return mod.startswith(_TRACK_PREFIXES)


def _lock_factory():
    inner = _RAW_LOCK()
    if not _enabled or not _should_track():
        return inner
    return TrackedLock(inner, _caller_site(2))


def _rlock_factory():
    inner = _RAW_RLOCK()
    if not _enabled or not _should_track():
        return inner
    return TrackedLock(inner, _caller_site(2), reentrant=True)


def tracked(name: str, reentrant: bool = False) -> TrackedLock:
    """Explicitly named tracked lock (tests, long-lived subsystem
    locks that want readable cycle reports)."""
    inner = _RAW_RLOCK() if reentrant else _RAW_LOCK()
    # the NAME is the graph node: two named locks created by one line
    # (or one factory) must stay distinct order-graph sites
    return TrackedLock(inner, name, name=name, reentrant=reentrant)


def install() -> bool:
    """Patch the threading lock factories, remembering the ones replaced.
    Idempotent; no-op unless MINIO_TPU_LOCKRANK=1. Locks created before
    the call stay untracked: install before building the servers whose
    locks should be tracked."""
    global _replaced, _enabled
    if os.environ.get("MINIO_TPU_LOCKRANK", "0") != "1":
        return False
    _enabled = True
    if _replaced is None:
        _replaced = (threading.Lock, threading.RLock)
        threading.Lock = _lock_factory
        threading.RLock = _rlock_factory
    return True


def uninstall() -> None:
    """Put back the factories install() replaced and stop tracking
    (existing TrackedLock instances keep working, silently)."""
    global _replaced, _enabled
    _enabled = False
    if _replaced is not None:
        threading.Lock, threading.RLock = _replaced
        _replaced = None


def note_blocking(what: str) -> None:
    """Hook for known-blocking boundaries (device flush): report if the
    calling thread holds any tracked lock. Zero-cost when disabled."""
    if not _enabled:
        return
    held = _state.held
    if not held:
        return
    _add_report({
        "kind": "lock-held-across-blocking",
        "what": what,
        "locks": [lk.name for lk in held],
        "lock_sites": [lk.site for lk in held],
        "stack": _stack(),
        "thread": threading.current_thread().name,
    })


def held_names() -> list[str]:
    return [lk.name for lk in _state.held]


def contended_sites() -> dict[str, int]:
    """``file:line`` lock-creation sites whose acquires have ever
    blocked, with counts — runtime evidence that the lock guards real
    cross-thread state."""
    with _meta:
        return dict(_contended)


def reports(kind: str | None = None) -> list[dict]:
    with _meta:
        out = [dict(r) for r in _reports]
    return [r for r in out if kind is None or r["kind"] == kind]


def suppressed_report_count() -> int:
    with _meta:
        return _suppressed_reports


def clear() -> None:
    """Drop accumulated graph + reports (test isolation)."""
    global _suppressed_reports
    with _meta:
        _graph.clear()
        _edge_stacks.clear()
        _reports.clear()
        _contended.clear()
        _suppressed_reports = 0


def stats() -> dict:
    with _meta:
        return {
            "sites": len(_graph),
            "edges": len(_edge_stacks),
            "reports": len(_reports),
            "contended_sites": len(_contended),
            "suppressed": _suppressed_reports,
            "enabled": _enabled,
        }
