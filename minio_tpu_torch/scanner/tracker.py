"""Data update tracker, the port of minio_tpu/scanner/tracker.py (reference
cmd/data-update-tracker.go:39-104): the write path marks touched (bucket,
top-level prefix) pairs; the scanner skips subtrees that saw no writes
since its last sweep instead of re-walking the whole namespace every
cycle.

Persisted rotating bloom filters: marks land in the current generation's
bloom; each scanner cycle rotates it into a bounded history and completed
sweeps drop the generations they covered, so false positives are the only
failure mode (a bloom can claim clean data dirty, an extra walk, but never
hide a write). State is saved to disk periodically and at every cycle
boundary, so a restarted node resumes the skip logic instead of treating
the world as clean; the marks of the last unsaved interval are the
accepted crash window, as in the reference's best-effort save cadence.

``tracker.bin`` is the JAX package's format byte for byte (either package
loads the other's), written through this package's
``storage.durability.durable_write``. ``global_tracker()`` is this
package's own process singleton, apart from the JAX package's.
"""
from __future__ import annotations

import hashlib
import os
import struct
import threading

from ..storage.durability import durable_write

#: bloom geometry: 2^20 bits (128 KiB) x 4 hashes. The tracked universe is
#: (bucket, top-prefix) pairs, thousands not millions, so the
#: false-positive rate stays negligible (<1e-9 at 10k entries).
M_BITS = 1 << 20
K_HASHES = 4

#: rotated generations kept when no sweep completes (scanner stalled);
#: beyond this the two oldest merge (OR): still false-positive-only
MAX_HISTORY = 16

#: marks between automatic persistence flushes
SAVE_EVERY = 1024

_MAGIC = b"MTUT1\n"


class BloomFilter:
    __slots__ = ("bits",)

    def __init__(self, bits: bytes | None = None):
        self.bits = bytearray(M_BITS // 8) if bits is None \
            else bytearray(bits)

    def _positions(self, key: bytes):
        d = hashlib.blake2b(key, digest_size=16).digest()
        for i in range(K_HASHES):
            yield int.from_bytes(d[4 * i: 4 * i + 4], "little") % M_BITS

    def add(self, key: bytes) -> None:
        for p in self._positions(key):
            self.bits[p >> 3] |= 1 << (p & 7)

    def test(self, key: bytes) -> bool:
        return all(self.bits[p >> 3] & (1 << (p & 7))
                   for p in self._positions(key))

    def union(self, other: "BloomFilter") -> None:
        # big-int OR, not a 128Ki-iteration Python byte loop (load() and
        # history merges run this under the tracker lock)
        merged = int.from_bytes(self.bits, "little") | \
            int.from_bytes(other.bits, "little")
        self.bits = bytearray(merged.to_bytes(len(self.bits), "little"))


def _bucket_key(bucket: str) -> bytes:
    return b"b\x00" + bucket.encode()


def _prefix_key(bucket: str, top: str) -> bytes:
    return b"p\x00" + bucket.encode() + b"\x00" + top.encode()


def _merge_overflow(history: list) -> None:
    """Cap the history at MAX_HISTORY by OR-ing the two oldest
    generations (in place; history is in ascending generation order)."""
    while len(history) > MAX_HISTORY:
        (_g0, f0), (g1, f1) = history[0], history[1]
        f1.union(f0)
        history[:2] = [(g1, f1)]


class UpdateTracker:
    def __init__(self, persist_path: str | None = None):
        self._lock = threading.Lock()
        self._cur = BloomFilter()
        self._history: list[tuple[int, BloomFilter]] = []  # (gen, bloom)
        self.generation = 0
        self._persist_path = persist_path
        self._marks_since_save = 0
        self._save_thread: threading.Thread | None = None

    # -- marking / queries ----------------------------------------------------

    def mark(self, bucket: str, object: str = "") -> None:
        top = object.split("/", 1)[0] if object else ""
        with self._lock:
            self._cur.add(_bucket_key(bucket))
            self._cur.add(_prefix_key(bucket, top))
            self._marks_since_save += 1
            flush = self._persist_path is not None and \
                self._marks_since_save >= SAVE_EVERY
        if flush:
            # background flush: the write path must not pay a serialization
            # and a disk write per SAVE_EVERY marks
            self._save_async()

    def _save_async(self) -> None:
        with self._lock:
            t = self._save_thread
            if t is not None and t.is_alive():
                return
            t = threading.Thread(target=self.save, daemon=True,
                                 name="tracker-save")
            self._save_thread = t
        # start the local handle: re-reading the attribute could start a
        # thread a racing marker already started
        t.start()

    def _blooms(self) -> list[BloomFilter]:
        return [self._cur] + [f for _, f in self._history]

    def bucket_dirty(self, bucket: str) -> bool:
        key = _bucket_key(bucket)
        with self._lock:
            return any(f.test(key) for f in self._blooms())

    def prefix_dirty(self, bucket: str, top: str) -> bool:
        key = _prefix_key(bucket, top)
        with self._lock:
            return any(f.test(key) for f in self._blooms())

    # -- cycle rotation -------------------------------------------------------

    def begin_cycle(self) -> int:
        """Rotate the current bloom into history under a new generation;
        marks landing mid-sweep go to the fresh current bloom and survive
        end_cycle."""
        with self._lock:
            self.generation += 1
            self._history.append((self.generation, self._cur))
            self._cur = BloomFilter()
            _merge_overflow(self._history)
            gen = self.generation
        self.save()
        return gen

    def end_cycle(self, gen: int) -> None:
        """A sweep that started at ``gen`` has covered every generation
        <= gen: drop them."""
        with self._lock:
            self._history = [(g, f) for g, f in self._history if g > gen]
        self.save()

    # -- persistence ----------------------------------------------------------

    def attach_persistence(self, path: str, load: bool = True) -> None:
        """Point the tracker at its on-disk state file; an existing file is
        loaded so dirtiness survives restarts."""
        self._persist_path = path
        if load:
            self.load()

    def save(self) -> None:
        path = self._persist_path
        if not path:
            return
        with self._lock:
            self._marks_since_save = 0
            blob = bytearray(_MAGIC)
            blob += struct.pack("<IQI", M_BITS, self.generation,
                                len(self._history))
            blob += self._cur.bits
            for g, f in self._history:
                blob += struct.pack("<Q", g)
                blob += f.bits
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            durable_write(path, bytes(blob))
        except OSError:  # persistence is best-effort (the reference's too)
            pass

    def load(self) -> bool:
        path = self._persist_path
        if not path:
            return False
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return False
        try:
            if not blob.startswith(_MAGIC):
                raise ValueError("bad magic")
            off = len(_MAGIC)
            m_bits, gen, n_hist = struct.unpack_from("<IQI", blob, off)
            if m_bits != M_BITS:
                raise ValueError("bloom geometry changed")
            off += struct.calcsize("<IQI")
            nb = M_BITS // 8
            cur = BloomFilter(blob[off: off + nb])
            off += nb
            hist = []
            for _ in range(n_hist):
                (g,) = struct.unpack_from("<Q", blob, off)
                off += 8
                hist.append((g, BloomFilter(blob[off: off + nb])))
                off += nb
        except (ValueError, struct.error):
            return False  # corrupt file: start clean
        with self._lock:
            # merge, don't replace: marks recorded before attach survive
            self._cur.union(cur)
            self._history.extend(hist)
            # the overflow merge assumes ascending generation order, and
            # loaded entries may interleave with live ones: re-sort and
            # re-cap while still holding the lock
            self._history.sort(key=lambda gf: gf[0])
            _merge_overflow(self._history)
            self.generation = max(self.generation, gen)
        return True


_global = UpdateTracker()


def global_tracker() -> UpdateTracker:
    return _global
