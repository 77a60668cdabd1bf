"""Continuous profiling plane, the port of minio_tpu/obs/profiler.py:
always-on host CPU/GIL/lock sampling with subsystem + QoS attribution.

The card idles over 99% of every path while the host's Python sets the
walls; stage attribution (obs/attribution.py) only sees instrumented
stages. This module answers "where does host CPU actually go"
*systematically*: a daemon thread walks ``sys._current_frames()`` at a
low configurable rate (default ~19 Hz — off-beat, so it cannot alias
against the 10/100 Hz poll loops in the tree), folds stacks into capped
aggregate counts, and classifies every sample three ways:

* **thread role** — dispatcher / completer / flusher / scanner /
  http-worker / pool-worker, resolved through a thread-name table (the
  port's thread names, each given the role the JAX package gives its
  counterpart);
* **subsystem** — the leafmost in-``minio_tpu_torch`` frame's package
  (``erasure``, ``storage``, ``runtime``, ...), the names the JAX package
  gives its counterpart files;
* **QoS class + op** — joined through a per-thread tag registry the
  request path (``server/s3api.py``) and the dispatch flush path
  (``runtime/dispatch.py``) update. Context variables are NOT visible
  cross-thread, which is exactly what a sampling profiler needs to be —
  hence a plain ident-keyed dict with GIL-atomic updates.

Samples taken while a thread is blocked in a tracked lock acquire
(``obs/lockrank.TrackedLock`` reports contended waits here and into the
``minio_tpu_lock_wait_seconds{site}`` histogram) are marked ``lockwait``
— GIL convoys and hot mutexes show up as a share, with a
top-contended-sites report naming the lock sites.

Served at ``GET /minio/admin/v3/profile`` (``fmt=folded|speedscope|top``,
``seconds=`` for a fresh high-rate window, ``breach=<class>`` for a stored
breach capture), exposed as the ``minio_tpu_profiler_*`` metric group
(samples, drops, overhead self-measure), and wired to the SLO plane: a
burn-rate breach (``obs/slo.report``) auto-captures a high-rate profile
window keyed by the breaching class. :func:`agg_snapshot` /
:func:`delta_report` give a measured section the base aggregate's growth
at no added cost.

Config subsystem ``profiler`` (dynamic): ``enable`` / ``hz`` / ``cap`` /
``burst_hz`` / ``burst_s``.

The on-demand ``obs/profiling.py`` cpu sessions delegate to
:func:`start_session` / :func:`stop_session` here, so session lifecycle
(busy errors, the abandoned-session reaper) exists exactly once. On a
distributed node the admin ``profile?peers=1`` fans the top report out
over the peer RPC (``dist/peer.py``'s ``profile``).
"""
from __future__ import annotations

import json
import sys
import threading
import time
from collections import Counter

from .lockrank import _RAW_LOCK

#: sampling defaults (overridable via the ``profiler`` config KVS).
#: 19/97 Hz are prime — they cannot phase-lock onto the tree's 10 ms /
#: 100 ms poll loops and systematically over/under-sample one of them.
DEFAULT_HZ = 19.0
DEFAULT_CAP = 20000.0
DEFAULT_BURST_HZ = 97.0
DEFAULT_BURST_S = 3.0
#: frames kept per folded stack
MAX_STACK_DEPTH = 48
#: thread-count derate knee: a pass walks EVERY thread, so the duty
#: cycle scales with the thread count — above this many threads the
#: effective rate shrinks proportionally (hz * knee/threads), keeping
#: the <2% overhead bound regardless of how pool-heavy the process is
#: (shares stay unbiased; only the sample density drops)
DERATE_THREADS = 120.0
#: a legacy start()/download session abandoned by its client auto-halts
#: after this long (results stay collectable; the next start() reaps it)
MAX_SESSION_S = 300.0
#: per-class cooldown between breach-triggered burst captures
BREACH_COOLDOWN_S = 60.0
#: fixed bucket bounds of the lock-wait histogram (seconds)
LOCK_WAIT_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                     5.0)
#: cap on distinct tracked lock sites (sites are as static as the code;
#: this only guards against pathological dynamic site names)
MAX_LOCK_SITES = 1024

SPEEDSCOPE_SCHEMA = "https://www.speedscope.app/file-format-schema.json"


_apply_registered = False


def _register_apply() -> None:
    """Invalidate the shared ~5s config cache on dynamic ``profiler``
    changes (same pattern as obs/slo.py): an operator's set-config-kv
    must take effect on the next read, not a TTL later. Idempotent."""
    global _apply_registered
    if _apply_registered:
        return
    from ..config import get_config_sys

    def _invalidate(_cfg) -> None:
        from ..qos.budget import _cfg_cache
        for key in [k for k in list(_cfg_cache) if k[0] == "profiler"]:
            _cfg_cache.pop(key, None)

    get_config_sys().on_apply("profiler", _invalidate)
    _apply_registered = True


def _cfg(key: str, env: str, default: float) -> float:
    """profiler.<key> through the dynamic config KVS (env > stored >
    default), with the same short-TTL registry cache the QoS budgets
    use — the sampler reads these every pass."""
    from ..qos.budget import _config_float
    _register_apply()
    return _config_float("profiler", key, env, default)


def enabled() -> bool:
    return _cfg("enable", "MINIO_TPU_PROFILER", 1.0) != 0.0


def base_hz() -> float:
    return max(0.5, _cfg("hz", "MINIO_TPU_PROFILER_HZ", DEFAULT_HZ))


def stack_cap() -> int:
    return max(16, int(_cfg("cap", "MINIO_TPU_PROFILER_CAP",
                            DEFAULT_CAP)))


def burst_hz() -> float:
    return max(1.0, _cfg("burst_hz", "MINIO_TPU_PROFILER_BURST_HZ",
                         DEFAULT_BURST_HZ))


def burst_s() -> float:
    return max(0.2, _cfg("burst_s", "MINIO_TPU_PROFILER_BURST_S",
                         DEFAULT_BURST_S))


# -- thread role registry -----------------------------------------------------

#: name-substring -> role, first match wins: the port's thread names,
#: each with the role the JAX package's table gives its counterpart
#: (``minio-tpu-dispatch``, ``minio-tpu-complete``,
#: ``minio-tpu-fsync-flusher``, ...). The interactive lane's completer,
#: ``minio-tpu-torch-ia-complete``, matches none, as its counterpart
#: ``minio-tpu-ia-complete`` matches none of the JAX table: "other". An
#: unnamed thread can only ever classify as "other".
_ROLE_PATTERNS: tuple[tuple[str, str], ...] = (
    ("minio-tpu-torch-dispatch", "dispatcher"),
    ("minio-tpu-torch-complete", "completer"),
    ("minio-torch-fsync-flusher", "flusher"),
    ("data-scanner", "scanner"),
    ("auto-heal", "scanner"),
    ("mrf-healer", "scanner"),
    ("heal-seq", "scanner"),
    # CPython's ThreadingMixIn names request threads
    # "Thread-N (process_request_thread)"
    ("process_request_thread", "http-worker"),
    ("minio-tpu-http", "http-listener"),
    ("ThreadPoolExecutor", "pool-worker"),
)

def thread_role(name: str) -> str:
    for pat, role in _ROLE_PATTERNS:
        if pat in name:
            return role
    return "other"


# -- per-thread QoS tag registry ----------------------------------------------

#: ident -> (qos class, op). Plain dict, GIL-atomic single-key updates;
#: the sampler reads it cross-thread (contextvars cannot be).
_tags: dict[int, tuple[str, str]] = {}


def set_task_tag(cls: str, op: str) -> None:
    """Tag the calling thread's current work for sample attribution.
    The request path and the dispatch flush path call this at work
    start and :func:`clear_task_tag` at work end."""
    _tags[threading.get_ident()] = (cls, op)


def clear_task_tag() -> None:
    _tags.pop(threading.get_ident(), None)


# -- lock-wait observability --------------------------------------------------

#: ident -> site while blocked in a tracked acquire (sampler marks
#: such samples "lockwait")
_waiting: dict[int, str] = {}
#: site -> [count, total_s, max_s, bucket counts] under _wait_lock (a
#: RAW lock: this is called from inside TrackedLock.acquire, where a
#: tracked lock would recurse into its own instrumentation)
_wait_lock = _RAW_LOCK()
_wait_stats: dict[str, list] = {}
_wait_dropped = 0


def lock_wait_begin(site: str) -> None:
    _waiting[threading.get_ident()] = site


def lock_wait_end(site: str, seconds: float) -> None:
    global _wait_dropped
    _waiting.pop(threading.get_ident(), None)
    with _wait_lock:
        st = _wait_stats.get(site)
        if st is None:
            if len(_wait_stats) >= MAX_LOCK_SITES:
                _wait_dropped += 1
                return
            st = _wait_stats[site] = [0, 0.0, 0.0,
                                      [0] * (len(LOCK_WAIT_BUCKETS) + 1)]
        st[0] += 1
        st[1] += seconds
        if seconds > st[2]:
            st[2] = seconds
        for i, edge in enumerate(LOCK_WAIT_BUCKETS):
            if seconds <= edge:
                st[3][i] += 1
                break
        else:
            st[3][-1] += 1


def lock_report(n: int = 10) -> list[dict]:
    """Top contended tracked-lock sites by total wait seconds."""
    with _wait_lock:
        rows = [{"site": site, "waits": st[0],
                 "wait_seconds_total": round(st[1], 6),
                 "max_wait_s": round(st[2], 6)}
                for site, st in _wait_stats.items()]
    rows.sort(key=lambda r: -r["wait_seconds_total"])
    return rows[:n]


def lock_wait_snapshot() -> dict:
    """Per-site histogram state for the metrics exposition."""
    with _wait_lock:
        return {site: {"count": st[0], "sum": st[1],
                       "buckets": list(st[3])}
                for site, st in _wait_stats.items()}


# -- sample aggregation -------------------------------------------------------


class _Agg:
    """One bounded folded-stack aggregate plus the classification side
    counters. ``feed`` runs on the sampler thread only — no lock."""

    __slots__ = ("cap", "stacks", "leaves", "roles", "subsystems",
                 "classes", "ops", "samples", "passes", "lockwait",
                 "drops", "started_at", "started_mono", "hz")

    def __init__(self, cap: int, hz: float):
        self.cap = cap
        self.hz = hz
        self.stacks: Counter = Counter()
        self.leaves: Counter = Counter()
        self.roles: Counter = Counter()
        self.subsystems: Counter = Counter()
        self.classes: Counter = Counter()
        self.ops: Counter = Counter()
        self.samples = 0
        self.passes = 0
        self.lockwait = 0
        self.drops = 0
        self.started_at = time.time()
        self.started_mono = time.monotonic()

    def feed(self, sig: str, leaf: str, role: str, subsys: str,
             tag: tuple[str, str] | None, waiting: bool) -> None:
        self.samples += 1
        self.roles[role] += 1
        self.subsystems[subsys] += 1
        if tag is not None:
            self.classes[tag[0]] += 1
            self.ops[tag[1]] += 1
        if waiting:
            self.lockwait += 1
        if sig in self.stacks or len(self.stacks) < self.cap:
            self.stacks[sig] += 1
            self.leaves[leaf] += 1
        else:
            self.drops += 1

    def duration_s(self) -> float:
        return max(1e-9, time.monotonic() - self.started_mono)


#: the package directory whose frames classify (a frame of the JAX
#: package, when one runs beside the port, classifies as "host")
_PKG_DIR = "/minio_tpu_torch/"


def _classify_frame_file(filename: str) -> str | None:
    """Subsystem of one frame's file, or None when outside the port: the
    first path segment under ``minio_tpu_torch/`` (the file stem for
    package-root modules), the name the JAX package gives the counterpart
    file under ``minio_tpu/``."""
    i = filename.rfind(_PKG_DIR)
    if i < 0:
        return None
    rest = filename[i + len(_PKG_DIR):]
    seg, _, tail = rest.partition("/")
    if not tail:  # package-root module: minio_tpu_torch/x.py -> x
        seg = seg[:-3] if seg.endswith(".py") else seg
    return seg


def _fold(frame) -> tuple[str, str, str]:
    """(folded frames root->leaf, leaf frame, subsystem) for one
    thread's current frame."""
    parts: list[str] = []
    subsys = None
    f = frame
    depth = 0
    while f is not None and depth < MAX_STACK_DEPTH:
        code = f.f_code
        parts.append(f"{code.co_filename.rsplit('/', 1)[-1]}"
                     f":{code.co_name}")
        if subsys is None:
            subsys = _classify_frame_file(code.co_filename)
        f = f.f_back
        depth += 1
    parts.reverse()
    leaf = parts[-1] if parts else "?"
    return ";".join(parts), leaf, subsys or "host"


# -- the sampler --------------------------------------------------------------


class _Sampler(threading.Thread):
    """The always-on daemon: one ``sys._current_frames()`` walk per
    tick, feeding the base aggregate at ``profiler.hz`` and any
    attached captures at their own (possibly higher) rates. Runs at the
    fastest attached rate and subsamples the base — one walk serves
    everyone, so a burst never doubles the walk cost."""

    def __init__(self):
        super().__init__(name="minio-tpu-torch-profiler", daemon=True)
        self._halt = threading.Event()
        self.errors = 0
        self.started_mono = time.monotonic()
        #: self-measure: seconds this thread spent inside sample passes
        self.sample_seconds = 0.0
        #: per-thread fold cache: a PARKED thread's frame is unchanged
        #: between passes (same frame object, same f_lasti), so its
        #: folded stack is one dict hit instead of an O(depth) walk —
        #: the difference between O(threads) and O(threads x depth)
        #: per pass in a pool-heavy process (measured 4.3% duty cycle
        #: uncached at 19 Hz with ~400 threads; well under 1% cached)
        self._fold_cache: dict[int, tuple] = {}
        #: tid -> role (name lookups + pattern scans off the per-pass
        #: path; cleared with the fold cache so reused idents self-heal)
        self._role_cache: dict[int, str] = {}
        self._pass_n = 0
        #: thread count of the last pass — the derate input
        self._nthreads = 1

    def run(self):
        me = threading.get_ident()
        next_base = 0.0
        while not self._halt.is_set():
            if not enabled():
                self._halt.wait(0.25)
                continue
            hz = base_hz()
            caps = list(_captures)
            for c in caps:
                hz = max(hz, c.hz)
            # thread-count derate: hold the duty cycle, not the rate
            scale = min(1.0, DERATE_THREADS /
                        max(1.0, float(self._nthreads)))
            hz *= scale
            now = time.monotonic()
            t0 = time.perf_counter()
            # self-measure in THREAD CPU time: a pass's wall clock
            # includes time this thread sat descheduled behind the very
            # workload being profiled, which would overstate the tax
            ct0 = time.thread_time()
            try:
                feed_base = now >= next_base
                if feed_base:
                    next_base = now + 1.0 / (base_hz() * scale)
                self._pass(me, caps, feed_base)
            except Exception:  # noqa: BLE001 — a torn frame walk must
                self.errors += 1  # not kill the always-on sampler
            self.sample_seconds += time.thread_time() - ct0
            _reap_expired(caps, now)
            self._halt.wait(max(0.0, 1.0 / hz -
                                (time.perf_counter() - t0)))

    def _pass(self, me: int, caps: list["Capture"],
              feed_base: bool) -> None:
        now = time.monotonic()
        if feed_base:
            _base.passes += 1
        live = []
        for c in caps:
            if now < c.deadline and now >= c.next_due:
                c.next_due = now + 1.0 / c.hz
                c.agg.passes += 1
                live.append(c)
        self._pass_n += 1
        fold_cache = self._fold_cache
        role_cache = self._role_cache
        if self._pass_n % 256 == 0:
            # periodic self-heal: dead threads' idents get reused, and
            # a rename/re-register must not serve a stale role forever
            fold_cache.clear()
            role_cache.clear()
        names: dict | None = None  # built lazily, only for new tids
        frames = sys._current_frames()
        self._nthreads = len(frames)
        for tid, frame in frames.items():
            if tid == me:
                continue
            role = role_cache.get(tid)
            if role is None:
                if names is None:
                    names = {t.ident: t.name
                             for t in threading.enumerate()}
                role = thread_role(names.get(tid, ""))
                role_cache[tid] = role
            tag = _tags.get(tid)
            waiting = tid in _waiting
            key = (id(frame), frame.f_lasti, id(frame.f_code), role,
                   tag, waiting)
            hit = fold_cache.get(tid)
            if hit is not None and hit[0] == key:
                _, full_sig, leaf, subsys = hit
            else:
                sig, leaf, subsys = _fold(frame)
                full_sig = (
                    f"role:{role};class:{tag[0] if tag else '-'};"
                    f"subsys:{subsys};{sig}"
                    + (";[lockwait]" if waiting else ""))
                fold_cache[tid] = (key, full_sig, leaf, subsys)
            if feed_base:
                _base.feed(full_sig, leaf, role, subsys, tag, waiting)
            for c in live:
                c.agg.feed(full_sig, leaf, role, subsys, tag, waiting)

    def stop(self):
        self._halt.set()


class Capture:
    """One attachable window over the shared sampler, fed at its OWN
    cadence: the sampler loop runs at the fastest attached rate, and a
    slower capture skips the passes it is not due for — its sample
    density honors its hz instead of inheriting the loop's."""

    def __init__(self, hz: float | None = None,
                 max_s: float = MAX_SESSION_S):
        self.hz = hz if hz is not None else burst_hz()
        self.agg = _Agg(stack_cap(), self.hz)
        self.deadline = time.monotonic() + max_s
        self.next_due = 0.0


_state_lock = _RAW_LOCK()
_base = _Agg(int(DEFAULT_CAP), DEFAULT_HZ)
_captures: list[Capture] = []
_sampler: _Sampler | None = None


def ensure_started() -> bool:
    """Start the always-on sampler (idempotent). Returns whether
    SAMPLING is active — False when ``profiler.enable=0`` (the daemon
    may still be alive, idling; a capture attached while disabled
    would collect nothing)."""
    global _sampler, _base
    if not enabled():
        return False
    with _state_lock:
        if _sampler is None or not _sampler.is_alive():
            _base = _Agg(stack_cap(), base_hz())
            _sampler = _Sampler()
            _sampler.start()
    return True


def stop() -> None:
    """Halt the sampler and drop state (test isolation)."""
    global _sampler
    with _state_lock:
        s, _sampler = _sampler, None
        _captures.clear()
    if s is not None:
        s.stop()
        s.join(timeout=2)


def reset() -> None:
    """Fresh base aggregate + lock-wait stats (test isolation; the
    sampler keeps running)."""
    global _base, _wait_dropped
    with _state_lock:
        _base = _Agg(stack_cap(), base_hz())
    with _wait_lock:
        _wait_stats.clear()
        _wait_dropped = 0
    with _breach_lock:
        _breach_profiles.clear()
        _breach_last.clear()


def attach(cap: Capture) -> Capture:
    """Attach a capture window to the running sampler (starting it if
    needed)."""
    ensure_started()
    with _state_lock:
        _captures.append(cap)
    return cap


def detach(cap: Capture) -> _Agg:
    with _state_lock:
        if cap in _captures:
            _captures.remove(cap)
    return cap.agg


def _reap_expired(caps: list[Capture], now: float) -> None:
    """Drop expired captures from the live list (their aggregates stay
    with whoever holds the Capture — the session reaper's half lives
    in start_session)."""
    for c in caps:
        if now >= c.deadline:
            with _state_lock:
                if c in _captures:
                    _captures.remove(c)


def capture_window(seconds: float, hz: float | None = None) -> _Agg:
    """Blocking fresh high-rate window: attach, wait, detach. Refuses
    (ValueError) when ``profiler.enable=0`` — sleeping a full window
    against a halted sampler would return an all-zero report that
    looks like an idle host."""
    if not ensure_started():
        raise ValueError(
            "profiler disabled (profiler.enable=0 / MINIO_TPU_PROFILER"
            "=0) — enable it before requesting a capture window")
    seconds = min(max(0.05, seconds), MAX_SESSION_S)
    cap = Capture(hz=hz, max_s=seconds + 5.0)
    attach(cap)
    try:
        time.sleep(seconds)
    finally:
        detach(cap)
    return cap.agg


def calibrate_spin(seconds: float, stop_event: threading.Event
                   | None = None) -> int:
    """A deterministic busy loop INSIDE minio_tpu_torch/obs — the
    attribution proof's injected hot spot: a profiler sampling this
    thread must report ``calibrate_spin`` as the top frame with subsystem
    ``obs``. Returns the iteration count (so the loop cannot be optimized
    away)."""
    n = 0
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        # pure-arithmetic inner loop: a Python-level call here (even
        # Event.is_set) would own a visible share of the leaf samples
        # and dilute the attribution the test pins
        for _ in range(512):
            n += 1
        if stop_event is not None and stop_event.is_set():
            break
    return n


# -- report rendering ---------------------------------------------------------


def render_folded(agg: _Agg, limit: int = 2000) -> bytes:
    """flamegraph.pl collapsed-stack lines, hottest first. Each line's
    root frames carry the classification (role:/class:/subsys:)."""
    out = [f"# samples: {agg.samples} passes: {agg.passes or '-'} "
           f"hz: {agg.hz:g} drops: {agg.drops}"]
    for stack, n in agg.stacks.most_common(limit):
        out.append(f"{stack} {n}")
    return ("\n".join(out) + "\n").encode()


def render_speedscope(agg: _Agg, name: str = "minio-tpu",
                      limit: int = 2000) -> bytes:
    """speedscope 'sampled' profile document over the folded stacks
    (weights = sample counts)."""
    frames: list[dict] = []
    index: dict[str, int] = {}
    samples: list[list[int]] = []
    weights: list[int] = []
    for stack, n in agg.stacks.most_common(limit):
        row = []
        for fr in stack.split(";"):
            i = index.get(fr)
            if i is None:
                i = index[fr] = len(frames)
                frames.append({"name": fr})
            row.append(i)
        samples.append(row)
        weights.append(n)
    doc = {
        "$schema": SPEEDSCOPE_SCHEMA,
        "name": name,
        "activeProfileIndex": 0,
        "exporter": "minio-tpu-profiler",
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled",
            "name": name,
            "unit": "none",
            "startValue": 0,
            "endValue": sum(weights),
            "samples": samples,
            "weights": weights,
        }],
    }
    return json.dumps(doc).encode()


def _shares(counter: Counter, total: int, top: int = 16) -> dict:
    if not total:
        return {}
    return {k: round(v / total, 4)
            for k, v in counter.most_common(top)}


def report_top(agg: _Agg, n: int = 10) -> dict:
    """The ``fmt=top`` JSON document: top frames/stacks + the
    classification shares + the lock contention report."""
    total = agg.samples
    return {
        "samples": total,
        "duration_s": round(agg.duration_s(), 3),
        # OBSERVED pass rate, not the nominal request: GIL contention,
        # the thread-count derate and per-capture cadencing all lower
        # the real rate, and a samples/hz-derived estimate must not lie
        "sample_hz": round(agg.passes / agg.duration_s(), 2)
        if agg.passes else round(agg.hz, 2),
        "distinct_stacks": len(agg.stacks),
        "drops": agg.drops,
        "top_frames": [{"frame": f, "count": c,
                        "share": round(c / total, 4) if total else 0.0}
                       for f, c in agg.leaves.most_common(n)],
        "top_stacks": [{"stack": s, "count": c}
                       for s, c in agg.stacks.most_common(n)],
        "subsystems": _shares(agg.subsystems, total),
        "roles": _shares(agg.roles, total),
        "classes": _shares(agg.classes, total),
        "ops": _shares(agg.ops, total),
        "lockwait_share": round(agg.lockwait / total, 4) if total
        else 0.0,
        "lock_contention": lock_report(n),
    }


def _copy_counter(c: Counter) -> Counter:
    """Copy a counter the sampler thread may be growing — a new key
    landing mid-iteration raises RuntimeError; retry, then give up
    empty (the delta clamps handle it)."""
    for _ in range(4):
        try:
            return Counter(c)
        except RuntimeError:
            continue
    return Counter()


def agg_snapshot(full: bool = False) -> dict:
    """Point-in-time copy of the base aggregate's counters — the cheap
    half of :func:`delta_report`. ``full`` also copies the folded
    stacks/leaves (top-frames deltas for measured windows)."""
    ensure_started()
    a = _base
    with _wait_lock:
        lock_waits = {site: (st[0], st[1])
                      for site, st in _wait_stats.items()}
    snap = {
        "samples": a.samples,
        "passes": a.passes,
        "lockwait": a.lockwait,
        "drops": a.drops,
        "hz": a.hz,
        "mono": time.monotonic(),
        "subsystems": _copy_counter(a.subsystems),
        "roles": _copy_counter(a.roles),
        "classes": _copy_counter(a.classes),
        "ops": _copy_counter(a.ops),
        "lock_waits": lock_waits,
    }
    if full:
        snap["stacks"] = _copy_counter(a.stacks)
        snap["leaves"] = _copy_counter(a.leaves)
    return snap


def delta_report(before: dict, n: int = 10) -> dict:
    """Attribution report over the base aggregate's growth since
    ``before`` (an :func:`agg_snapshot`). This is the ZERO-ADDED-COST
    window: it rides the always-on sampler instead of attaching a
    capture, so a measured section (a PUT or GET load) pays nothing
    beyond the standing base rate — and crucially,
    a window and its surrounding baseline carry the identical sampling
    tax, so before/during comparisons stay unbiased."""
    after = agg_snapshot(full="stacks" in before)
    samples = max(0, after["samples"] - before["samples"])
    duration = max(1e-9, after["mono"] - before["mono"])
    passes = max(0, after["passes"] - before["passes"])
    # window-scoped lock contention: the cumulative per-site stats are
    # diffed the same way as every other field — without this, a run
    # report would blame its measured phase for preload/setup waits
    lock_rows = []
    for site, (c, s) in after["lock_waits"].items():
        c0, s0 = before.get("lock_waits", {}).get(site, (0, 0.0))
        if c - c0 > 0:
            lock_rows.append({"site": site, "waits": c - c0,
                              "wait_seconds_total": round(s - s0, 6)})
    lock_rows.sort(key=lambda r: -r["wait_seconds_total"])
    out = {
        "samples": samples,
        "duration_s": round(duration, 3),
        # observed pass rate over the window (see report_top)
        "sample_hz": round(passes / duration, 2) if passes
        else round(after["hz"], 2),
        "drops": max(0, after["drops"] - before["drops"]),
        "subsystems": _shares(after["subsystems"] -
                              before["subsystems"], samples),
        "roles": _shares(after["roles"] - before["roles"], samples),
        "classes": _shares(after["classes"] - before["classes"],
                           samples),
        "ops": _shares(after["ops"] - before["ops"], samples),
        "lockwait_share": round(
            max(0, after["lockwait"] - before["lockwait"]) / samples,
            4) if samples else 0.0,
        "lock_contention": lock_rows[:n],
    }
    if "stacks" in before:
        leaves = after["leaves"] - before["leaves"]
        stacks = after["stacks"] - before["stacks"]
        out["top_frames"] = [
            {"frame": f, "count": c,
             "share": round(c / samples, 4) if samples else 0.0}
            for f, c in leaves.most_common(n)]
        out["top_stacks"] = [{"stack": s, "count": c}
                             for s, c in stacks.most_common(n)]
    return out


def base_agg() -> _Agg:
    return _base


def status() -> dict:
    """The metrics group's view: sampler health + self-measured
    overhead (seconds spent walking frames / wall seconds)."""
    s = _sampler
    running = s is not None and s.is_alive()
    # sampler-relative wall: reset() swaps the base aggregate without
    # restarting the sampler, and the duty-cycle self-measure must
    # divide matching numerator/denominator spans
    wall = time.monotonic() - s.started_mono if running else 0.0
    return {
        "enabled": enabled(),
        "running": running,
        "hz": base_hz(),
        "samples_total": _base.samples,
        "dropped_total": _base.drops,
        "distinct_stacks": len(_base.stacks),
        "captures_active": len(_captures),
        "errors": s.errors if s is not None else 0,
        "overhead_ratio": round(s.sample_seconds / wall, 6)
        if running and wall > 0 else 0.0,
        "lockwait_samples_total": _base.lockwait,
        "roles": dict(_base.roles),
        "subsystem_shares": _shares(_base.subsystems, _base.samples),
    }


# -- legacy session lifecycle (the single profiling entry point) --------------

_session_lock = _RAW_LOCK()
_session: dict | None = None


def start_session() -> dict:
    """Begin the one-at-a-time cpu profiling session the legacy admin
    surface (``profiling/start`` + ``profiling/download``,
    ``obs/profiling.py``) drives. A session abandoned past
    ``MAX_SESSION_S`` auto-halts (the sampler detaches it) and is
    REAPED by the next start; a live one raises the busy error."""
    global _session
    if not ensure_started():
        raise ValueError(
            "profiler disabled (profiler.enable=0) — cpu profiling "
            "sessions ride the continuous sampler")
    with _session_lock:
        if _session is not None:
            age = time.monotonic() - _session["started_mono"]
            if age < MAX_SESSION_S:
                raise ValueError(
                    f"profiling already running (cpu, started "
                    f"{age:.0f}s ago — download to collect it)")
            detach(_session["cap"])  # abandoned: reap, discard
            _session = None
        cap = Capture(hz=burst_hz(), max_s=MAX_SESSION_S)
        _session = {"cap": cap, "started_at": time.time(),
                    "started_mono": time.monotonic()}
        started = _session["started_at"]
    attach(cap)
    return {"kind": "cpu", "started_at": started}


def stop_session() -> bytes:
    """End the legacy session and render its report (leaf table +
    collapsed stacks, the historical download format)."""
    global _session
    with _session_lock:
        if _session is None:
            raise ValueError("no profiling session running")
        sess, _session = _session, None
    agg = detach(sess["cap"])
    out = [f"# samples: {agg.samples} (rate {agg.hz:g} Hz)",
           "# --- top leaf functions ---"]
    for name, n in agg.leaves.most_common(50):
        out.append(f"{n:8d} {name}")
    out.append("# --- collapsed stacks (flamegraph.pl format) ---")
    for stack, n in agg.stacks.most_common(500):
        out.append(f"{stack} {n}")
    return ("\n".join(out) + "\n").encode()


def session_active() -> bool:
    with _session_lock:
        return _session is not None


# -- breach-triggered capture -------------------------------------------------

_breach_lock = _RAW_LOCK()
#: class -> stored burst report (one per class, classes are bounded)
_breach_profiles: dict[str, dict] = {}
_breach_last: dict[str, float] = {}


def note_breach(cls: str) -> bool:
    """Called by ``obs/slo.report`` when a class's burn-rate breach
    verdict is on: kick one async high-rate capture keyed by the
    breaching class (cooldown-limited), stored beside the slow-trace
    store and served via ``profile?breach=<class>``. Returns whether a
    capture was started."""
    if not enabled():
        return False
    now = time.monotonic()
    with _breach_lock:
        last = _breach_last.get(cls)
        if last is not None and now - last < BREACH_COOLDOWN_S:
            return False
        _breach_last[cls] = now
    threading.Thread(target=_breach_worker, args=(cls,), daemon=True,
                     name=f"minio-tpu-torch-profiler-burst-{cls}").start()
    return True


def _breach_worker(cls: str) -> None:
    try:
        agg = capture_window(burst_s(), burst_hz())
        rep = report_top(agg)
        rep["class"] = cls
        rep["at"] = time.time()
        with _breach_lock:
            _breach_profiles[cls] = rep
        from . import metrics as mx
        mx.inc("minio_tpu_profiler_breach_captures_total",
               **{"class": cls})
    except Exception:  # noqa: BLE001 — breach capture is best-effort
        from . import metrics as mx
        mx.inc("minio_tpu_profiler_breach_capture_errors_total")


def breach_profile(cls: str) -> dict | None:
    with _breach_lock:
        rep = _breach_profiles.get(cls)
    return dict(rep) if rep is not None else None


def breach_profiles_summary() -> dict:
    """Per-class summaries (no stacks) for the SLO report's link."""
    with _breach_lock:
        return {cls: {"at": rep["at"], "samples": rep["samples"],
                      "duration_s": rep["duration_s"]}
                for cls, rep in _breach_profiles.items()}
