"""Admin profiling + OBD/health info, the port of
minio_tpu/obs/profiling.py (reference cmd/admin-handlers.go
StartProfilingHandler/DownloadProfilingHandler backed by pkg/pprof, and
HealthInfoHandler/ServerOBDInfoHandler backed by pkg/smart, cgroup,
disk).

The Python runtime's stand-ins for Go's pprof:

* ``cpu``     — delegated to the always-on continuous profiler
                (``obs/profiler.py``): a start() attaches a high-rate
                capture window to the shared sampler, download detaches
                it and renders the flamegraph-ready format. Session
                lifecycle — the one-at-a-time busy error and the
                abandoned-session reaper — lives in ``profiler.
                start_session``/``stop_session``.
* ``threads`` — a goroutine-dump analogue: every live thread's stack.
* ``mem``     — tracemalloc snapshot (top allocating sites).

``health_info`` is the ``healthinfo``/``obdinfo`` document: cpu, memory,
process, every local drive's capacity and a 256 KiB write/read probe,
the cluster view, and the device runtime (the dispatch queue's stats and
the card's name)."""
from __future__ import annotations

import io
import sys
import threading
import time
import traceback

_lock = threading.Lock()
_active: dict | None = None


def start(kind: str) -> dict:
    """Begin a profiling session; returns {kind, started_at}. Raises
    ValueError on unknown kind or if a same-kind session is still
    RUNNING. cpu sessions ride the continuous profiler's session
    machinery (busy error + reaper there); mem/threads keep the local
    one-at-a-time slot."""
    global _active
    from . import profiler
    if kind == "cpu":
        # cross-kind exclusivity preserved: a cpu start while a
        # mem/threads session is open would otherwise let the cpu
        # client's download consume the OTHER client's session
        with _lock:
            if _active is not None:
                age = time.monotonic() - _active.get(
                    "started_mono", time.monotonic())
                raise ValueError(
                    f"profiling already running ({_active['kind']}, "
                    f"started {age:.0f}s ago — download to collect "
                    "it)")
        return profiler.start_session()
    with _lock:
        if _active is not None:
            age = time.monotonic() - _active.get(
                "started_mono", time.monotonic())
            raise ValueError(
                f"profiling already running ({_active['kind']}, "
                f"started {age:.0f}s ago — download to collect it)")
        if profiler.session_active():
            raise ValueError(
                "profiling already running (cpu — download to "
                "collect it)")
        if kind == "mem":
            import tracemalloc
            tracemalloc.start(10)
            _active = {"kind": kind}
        elif kind == "threads":
            _active = {"kind": kind}
        else:
            raise ValueError(f"unknown profiler type {kind!r}")
        _active["started_at"] = time.time()     # API timestamp (wall)
        _active["started_mono"] = time.monotonic()  # age arithmetic
        return {"kind": kind, "started_at": _active["started_at"]}


def stop_and_dump() -> tuple[str, bytes]:
    """End the session and return (kind, report bytes). mem/threads
    sessions take precedence when one is open; otherwise the cpu
    session (continuous-profiler capture) is collected."""
    global _active
    with _lock:
        sess, _active = _active, None
    if sess is None:
        from . import profiler
        if profiler.session_active():
            return "cpu", profiler.stop_session()
        raise ValueError("no profiling session running")
    kind = sess["kind"]
    if kind == "mem":
        import tracemalloc
        snap = tracemalloc.take_snapshot()
        tracemalloc.stop()
        lines = [str(s) for s in snap.statistics("lineno")[:100]]
        return kind, ("\n".join(lines) + "\n").encode()
    # threads: always available, also without start()
    return kind, thread_dump()


def thread_dump() -> bytes:
    """Every live thread's stack — the goroutine-dump analogue the
    reference exposes as the 'goroutines' profile."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = io.StringIO()
    for tid, frame in sys._current_frames().items():
        out.write(f"--- thread {tid} ({names.get(tid, '?')}) ---\n")
        traceback.print_stack(frame, file=out)
        out.write("\n")
    return out.getvalue().encode()


def _drive_kernel_stats(path: str) -> dict:
    """Kernel block-device view of the drive backing ``path`` (the
    unprivileged slice of the reference's pkg/smart drive report: SMART
    ioctls need CAP_SYS_RAWIO, but /proc/diskstats exposes the health-
    relevant IO counters — error spikes show as io_time/weighted-io
    divergence)."""
    import os
    try:
        st = os.stat(path)
        major, minor = os.major(st.st_dev), os.minor(st.st_dev)
        with open("/proc/diskstats") as f:
            for ln in f:
                parts = ln.split()
                if len(parts) >= 14 and int(parts[0]) == major and \
                        int(parts[1]) == minor:
                    return {
                        "name": parts[2],
                        "reads_completed": int(parts[3]),
                        "sectors_read": int(parts[5]),
                        "writes_completed": int(parts[7]),
                        "sectors_written": int(parts[9]),
                        "io_in_progress": int(parts[11]),
                        "io_time_ms": int(parts[12]),
                        "weighted_io_time_ms": int(parts[13]),
                    }
    except (OSError, ValueError):
        pass
    return {}


def health_info(server) -> dict:
    """OBD health report (reference getServerOBDInfo subset that applies
    to this runtime): cpu, memory, per-disk capacity + latency probe,
    process info, and the cluster view."""
    import os
    info: dict = {"ts": time.time(), "hostname": os.uname().nodename}
    # cpu
    try:
        info["cpu"] = {"count": os.cpu_count(),
                       "loadavg": list(os.getloadavg())}
    except OSError:
        info["cpu"] = {"count": os.cpu_count()}
    # memory
    mem = {}
    try:
        with open("/proc/meminfo") as f:
            for ln in f:
                k, _, rest = ln.partition(":")
                if k in ("MemTotal", "MemAvailable", "SwapTotal"):
                    mem[k] = int(rest.split()[0]) * 1024
    except OSError:
        pass
    info["memory"] = mem
    # process
    info["process"] = {"pid": os.getpid(),
                       "uptime_s": round(
                           time.monotonic() - _proc_start, 1),
                       "threads": threading.active_count()}
    # drives: capacity + a small write/read latency probe per local disk
    from .metrics import _all_disks
    drives = []
    for d in _all_disks(server.obj):
        # the port's disks name their directory ``root`` (the JAX
        # package's ``base``); a health wrapper forwards it
        base = getattr(d, "root", None)
        if not base:
            continue
        entry: dict = {"path": base}
        try:
            st = os.statvfs(base)
            entry["total_bytes"] = st.f_frsize * st.f_blocks
            entry["free_bytes"] = st.f_frsize * st.f_bavail
        except OSError as e:
            entry["error"] = str(e)
            drives.append(entry)
            continue
        try:
            probe = os.path.join(base, ".minio.sys", "tmp",
                                 f".obd-{os.getpid()}")
            os.makedirs(os.path.dirname(probe), exist_ok=True)
            blob = b"\0" * (256 << 10)
            t0 = time.perf_counter()
            with open(probe, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            entry["write_256k_ms"] = round(
                (time.perf_counter() - t0) * 1e3, 3)
            t0 = time.perf_counter()
            with open(probe, "rb") as f:
                f.read()
            entry["read_256k_ms"] = round(
                (time.perf_counter() - t0) * 1e3, 3)
            os.unlink(probe)
        except OSError as e:
            entry["error"] = str(e)
        smart = _drive_kernel_stats(base)
        if smart:
            entry["device"] = smart
        drives.append(entry)
    info["drives"] = drives
    # cluster view
    try:
        info["cluster"] = server.obj.storage_info()
    except Exception:  # noqa: BLE001
        pass
    # device runtime — no reference analogue: the server's dispatch queue
    # (once one exists) and the card it runs on
    from ..runtime import dispatch
    from . import device
    q = dispatch._queues.get(str(getattr(server, "device", "")))
    if q is not None:
        info["dispatch"] = {**q.stats(), "card": device._card}
    return info


_proc_start = time.monotonic()  # uptime is a duration, not a timestamp
