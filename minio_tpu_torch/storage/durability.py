"""Durable commit pipeline — the port of storage/durability.py: the fsync
policy behind every tmp-write-then-rename commit of the storage layer
(reference cmd/xl-storage.go: RenameData + the O_DSYNC/fdatasync
discipline around xl.meta).

``durable_replace(tmp, dst)`` is the commit primitive of xl.meta writes
and part promotions, ``durable_replace_dir`` that of rename_data's dataDir
move, ``fsync_after_write`` that of in-place appends, ``durable_write`` that
of small whole files (the MRF journal). The stranded-tmp reaper of the JAX
package's ``durable_write`` is not ported. The policy is the config
registry's ``durability.fsync`` (env ``MINIO_TPU_FSYNC`` > stored >
default ``off``), and the flusher's window its ``batch_interval_ms``:

* ``always``  — fsync the tmp file BEFORE the rename (its bytes are on
  media before they become reachable), then fsync the destination's
  parent directory AFTER (the rename itself is on media). A power cut
  can never surface an empty or torn committed file.
* ``batched`` — rename immediately; the file + parent-dir fsyncs are
  coalesced on a flusher thread, bounding the durability window to the
  flusher interval instead of paying two synchronous fsyncs per commit.
* ``off``     — plain rename: atomic against process crash, not against
  power loss. XLMeta's trailing checksum makes a torn survivor
  detectable.
"""
from __future__ import annotations

import os
import threading
import time

FSYNC_ALWAYS = "always"
FSYNC_BATCHED = "batched"
FSYNC_OFF = "off"
FSYNC_MODES = (FSYNC_ALWAYS, FSYNC_BATCHED, FSYNC_OFF)

#: the JAX package's defaults (durability.fsync, batch_interval_ms)
DEFAULT_FSYNC = FSYNC_OFF
DEFAULT_BATCH_INTERVAL_S = 0.02

#: stored/default policy cache (GIL-atomic dict slot). fsync_mode runs on
#: every commit on every disk; reading it through ConfigSys.get's lock
#: would let one admin set-config-kv (which holds that lock across
#: multi-disk persistence) stall every in-flight write. ConfigSys refreshes
#: it on load and on every dynamic ``durability`` change; the environment
#: is checked per call, so MINIO_TPU_FSYNC keeps winning.
_mode_cache: dict = {"stored": None}


def refresh_mode_cache(cfg=None) -> None:
    """Re-resolve the stored/default fsync policy. ConfigSys passes
    itself: falling back to get_config_sys() from inside its construction
    would re-enter the registry's global lock."""
    if cfg is None:
        from ..config import get_config_sys
        cfg = get_config_sys()
    _mode_cache["stored"] = cfg.get_stored_or_default("durability", "fsync")


def fsync_mode() -> str:
    """Effective policy: env > stored config > default. An unknown value
    falls back to ``off`` with a warning (once per value): a typo must not
    silently disable what the operator believes is on."""
    mode = os.environ.get("MINIO_TPU_FSYNC")
    if mode is None:
        if _mode_cache["stored"] is None:
            refresh_mode_cache()
        mode = _mode_cache["stored"]
    mode = (mode or DEFAULT_FSYNC).strip().lower()
    if mode in FSYNC_MODES:
        return mode
    from ..obs.logger import log_sys
    log_sys().log_once(
        f"fsync-mode:{mode}", "warning", "durability",
        f"unknown fsync mode {mode!r} — falling back to 'off' "
        f"(valid: {', '.join(FSYNC_MODES)})")
    return FSYNC_OFF


def _batch_interval_s() -> float:
    """The flusher's coalescing window, ``durability.batch_interval_ms``."""
    from ..config import get_config_sys
    try:
        ms = float(get_config_sys().get("durability", "batch_interval_ms"))
    except ValueError:
        return DEFAULT_BATCH_INTERVAL_S
    return max(0.001, ms / 1e3)


def fsync_path(path: str, strict: bool = False) -> bool:
    """fsync a file or directory by path (O_RDONLY open is enough to fsync
    both on Linux). A path that cannot be OPENED returns False — a
    concurrent delete/rename won a benign race, not a durability hole. A
    path that opens but cannot be FSYNCED is a failed writeback (EIO),
    re-raised when ``strict``: the ``always``-mode commit path must surface
    it as a write failure, never report a commit durable that is not."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return False
    try:
        try:
            os.fsync(fd)
        except OSError:
            if strict:
                raise
            return False
    finally:
        os.close(fd)
    return True


class _Flusher:
    """Coalesced-fsync worker for ``batched`` mode: commits enqueue their
    destination path; the loop drains the pending set every
    ``durability.batch_interval_ms`` and fsyncs each file plus its parent
    directory once, however many commits landed in the window."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        #: ordered de-duped work: path str, or ("tree", dir) to expand
        self._pending: dict = {}
        self._busy = False
        self._thread: threading.Thread | None = None
        self.flushed = 0

    def _ensure_thread(self):
        t = self._thread
        if t is not None and t.is_alive():
            return
        t = threading.Thread(target=self._loop, daemon=True,
                             name="minio-torch-fsync-flusher")
        self._thread = t
        t.start()

    def enqueue(self, dst: str) -> None:
        with self._cv:
            self._pending[dst] = None
            self._ensure_thread()
            self._cv.notify_all()

    def enqueue_tree(self, dst: str) -> None:
        """Defer fsync of every file under ``dst`` (a just-committed
        directory) to the flusher, which expands the walk at flush time."""
        with self._cv:
            self._pending[("tree", dst)] = None
            self._ensure_thread()
            self._cv.notify_all()

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def flush(self, timeout: float = 10.0) -> bool:
        """Barrier: wait until everything enqueued before the call is on
        media."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    def _loop(self):
        while True:
            with self._cv:
                if not self._pending:
                    self._cv.wait(timeout=60.0)
                    if not self._pending:
                        continue
            # coalescing window: let racing commits pile into the batch
            time.sleep(_batch_interval_s())
            with self._cv:
                batch = list(self._pending)
                self._pending.clear()
                self._busy = True
            try:
                files: dict[str, None] = {}
                dirs: dict[str, None] = {}
                for dst in batch:
                    if isinstance(dst, tuple):  # ("tree", dir) marker
                        troot = dst[1]
                        # the PARENT's dirent is what makes the rename
                        # that landed this tree durable
                        dirs[os.path.dirname(troot) or "."] = None
                        for root, _ds, fs in os.walk(troot):
                            for f in fs:
                                files[os.path.join(root, f)] = None
                            dirs[root] = None
                    else:
                        files[dst] = None
                        dirs[os.path.dirname(dst) or "."] = None
                ok = sum(fsync_path(f) for f in files)
                for d in dirs:
                    fsync_path(d)
                self.flushed += ok
            except Exception as e:  # noqa: BLE001 — flusher must survive
                from ..obs.logger import log_sys
                log_sys().log_once(
                    f"fsync-flusher:{type(e).__name__}", "warning",
                    "durability", f"batched fsync failed: {e!r}")
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()


_flusher = _Flusher()


def flusher() -> _Flusher:
    return _flusher


def status() -> dict:
    """Live durability-plane state (the metrics' durability group)."""
    return {"fsync": fsync_mode(),
            "pending": _flusher.pending_count(),
            "flushed_total": _flusher.flushed}


def durable_replace(tmp: str, dst: str, mode: str | None = None) -> None:
    """Commit ``tmp`` over ``dst`` under the fsync policy. Raises OSError
    exactly like ``os.replace``."""
    m = mode if mode in FSYNC_MODES else fsync_mode()
    if m == FSYNC_ALWAYS:
        fsync_path(tmp, strict=True)
        os.replace(tmp, dst)
        fsync_path(os.path.dirname(dst) or ".", strict=True)
    elif m == FSYNC_BATCHED:
        os.replace(tmp, dst)
        _flusher.enqueue(dst)
    else:
        os.replace(tmp, dst)


def durable_replace_dir(src: str, dst: str, mode: str | None = None) -> None:
    """Directory commit (rename_data's dataDir move). ``always`` syncs the
    dir inodes (the shard content was fsynced when each stream closed);
    ``batched`` renames and enqueues ONE tree marker covering the files,
    ``dst`` itself and its parent."""
    m = mode if mode in FSYNC_MODES else fsync_mode()
    if m == FSYNC_ALWAYS:
        fsync_path(src, strict=True)
        os.replace(src, dst)
        fsync_path(os.path.dirname(dst) or ".", strict=True)
    else:
        os.replace(src, dst)
        if m == FSYNC_BATCHED:
            _flusher.enqueue_tree(dst)


def fsync_after_write(path: str, mode: str | None = None) -> None:
    """Durability for in-place writes that have no tmp+rename shape
    (append_file): ``always`` fsyncs now, ``batched`` hands the path to the
    flusher, ``off`` is a no-op."""
    m = mode if mode in FSYNC_MODES else fsync_mode()
    if m == FSYNC_ALWAYS:
        fsync_path(path, strict=True)
    elif m == FSYNC_BATCHED:
        _flusher.enqueue(path)


#: durable_write's tmp prefix (the JAX package's): distinctive, so no
#: user-named destination is ever taken for a stranded tmp
_TMP_PREFIX = ".graft-tmp."


def durable_write(path: str, data: bytes, mode: str | None = None) -> None:
    """Whole-file write + durable commit: a tmp beside ``path``,
    ``durable_replace`` over it, the tmp unlinked on failure (the MRF
    journal's writer). Raises OSError like ``os.replace``."""
    d, base = os.path.split(path)
    tmp = os.path.join(
        d or ".",
        f"{_TMP_PREFIX}{base}.{os.getpid()}.{threading.get_ident()}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        durable_replace(tmp, path, mode)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
