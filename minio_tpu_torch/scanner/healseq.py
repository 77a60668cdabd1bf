"""Heal sequences, the port of minio_tpu/scanner/healseq.py (reference
healSequence, cmd/admin-heal-ops.go: the state machine behind ``mc admin
heal``): an admin-triggered heal runs in the background under a client
token; repeated calls with the token poll status and progress instead of
starting a second sweep; one sequence per path prefix at a time.

Sequences run under ``qos.background()``; their rebuilds (K1) and verifies
(K5) stay on the card, whose queue never moves work to the host."""
from __future__ import annotations

import threading
import time
import uuid

from .. import qos
from ..obs import trace as _trc


class HealSequence:
    def __init__(self, objlayer, bucket: str = "", prefix: str = "",
                 dry_run: bool = False):
        self.obj = objlayer
        self.bucket = bucket
        self.prefix = prefix
        self.dry_run = dry_run
        self.token = uuid.uuid4().hex
        self.status = "running"
        self.started = time.time()
        self.finished = 0.0
        self.scanned = 0
        self.healed = 0
        self.failed = 0
        self.error = ""
        #: rolling window of recent per-object results (bounded like the
        #: reference's item channel)
        self.recent: list[dict] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"heal-seq-{self.token[:8]}")

    def start(self) -> "HealSequence":
        self._thread.start()
        return self

    def _buckets(self):
        if self.bucket:
            return [self.bucket]
        return [b.name for b in self.obj.list_buckets()]

    def _run(self):
        with qos.background():
            self._run_inner()

    def _run_inner(self):
        try:
            for bucket in self._buckets():
                if self._stop.is_set():
                    break
                try:
                    self.obj.heal_bucket(bucket, dry_run=self.dry_run)
                except Exception:  # noqa: BLE001
                    pass
                for oi in self.obj.iter_objects(bucket, self.prefix):
                    if self._stop.is_set():
                        break
                    self.scanned += 1
                    self.recent.append(self._heal_one(bucket, oi.name))
                    if len(self.recent) > 256:
                        del self.recent[:128]
            self.status = "stopped" if self._stop.is_set() else "done"
        except Exception as e:  # noqa: BLE001
            self.status = "error"
            self.error = str(e)
        finally:
            self.finished = time.time()

    def _heal_one(self, bucket: str, name: str) -> dict:
        t0 = time.perf_counter()
        err = ""
        try:
            r = self.obj.heal_object(bucket, name, dry_run=self.dry_run)
            healthy = all(s == "ok" for s in r.after_state)
            self.healed += 1 if healthy else 0
            self.failed += 0 if healthy else 1
            return {"bucket": bucket, "object": name,
                    "before": r.before_state, "after": r.after_state}
        except Exception as e:  # noqa: BLE001
            err = str(e)
            self.failed += 1
            return {"bucket": bucket, "object": name, "error": err}
        finally:
            _trc.publish_scanner(func="heal.object", path=f"{bucket}/{name}",
                                 duration_s=time.perf_counter() - t0,
                                 error=err)

    def stop(self):
        self._stop.set()

    def summary(self) -> dict:
        return {
            "clientToken": self.token,
            "status": self.status,
            "bucket": self.bucket, "prefix": self.prefix,
            "dryRun": self.dry_run,
            "started": self.started, "finished": self.finished or None,
            "scanned": self.scanned, "healed": self.healed,
            "failed": self.failed, "error": self.error,
            "items": list(self.recent[-64:]),
        }


class HealSequenceManager:
    """Registry of running and finished sequences keyed by token; at most
    one active sequence per (bucket, prefix) path (the reference refuses
    overlapping heal sequences on the same path)."""

    def __init__(self, objlayer):
        self.obj = objlayer
        self._lock = threading.Lock()
        self._by_token: dict[str, HealSequence] = {}

    def start(self, bucket: str = "", prefix: str = "",
              dry_run: bool = False) -> HealSequence:
        with self._lock:
            for seq in self._by_token.values():
                if seq.status == "running" and seq.bucket == bucket and \
                        seq.prefix == prefix:
                    if seq.dry_run != dry_run:
                        # a real heal must not silently alias onto a
                        # running dry run (or the reverse)
                        raise ValueError(
                            "a heal sequence with a different dryRun "
                            "setting is already running on this path")
                    return seq  # already running on this path
            seq = HealSequence(self.obj, bucket, prefix, dry_run).start()
            self._by_token[seq.token] = seq
            # bound the registry: drop the oldest finished sequences
            if len(self._by_token) > 32:
                done = sorted(
                    (s for s in self._by_token.values()
                     if s.status != "running"),
                    key=lambda s: s.finished)
                for s in done[:len(self._by_token) - 32]:
                    self._by_token.pop(s.token, None)
            return seq

    def get(self, token: str) -> HealSequence | None:
        with self._lock:
            return self._by_token.get(token)
