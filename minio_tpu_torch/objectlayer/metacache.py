"""Metacache listing, the port of objectlayer/metacache.py: per-disk sorted
metadata walks merged with
version-quorum resolution, persisted as reusable block streams
(reference cmd/metacache.go:42, cmd/metacache-stream.go:79,
cmd/metacache-server-pool.go:59, cmd/metacache-walk.go,
cmd/metacache-entries.go).

Walk layer: every StorageAPI exposes ``walk_versions`` (marker and prefix
pushed down into the directory descent — O(page) touched per page),
``merged_entries`` lazily k-way-merges the streams with ``heapq.merge``,
and resolution picks the journal a write-quorum majority agrees on.

Emission rule (cmd/metacache-entries.go resolve analogue): a committed
write lands its journal on >= n//2+1 disks (write quorum), and a committed
delete removes it from >= n//2+1, so an entry is emitted iff found on
``min(n//2+1, live_disks)`` walked disks — stale ghosts (<= parity copies)
are dropped without any per-key RPC fan-out.

Persistence layer (MetacacheStore): the first lister of a (bucket, prefix)
becomes the builder — a background walk runs to COMPLETION (not just the
consumed page, matching the reference's listPathAsync), resolving entries
and publishing 5,000-entry zlib-compressed msgpack blocks under
``.minio.sys/buckets/<bucket>/.metacache/<root-hash>/block-N``, each
replicated to two live disks; a manifest at a FIXED per-(bucket, prefix)
path is written when the walk ends, so any cluster node that shares the
disks (locally or via the storage REST clients) discovers and serves the
finished cache without walking. Consumers tail the build through an
in-memory frontier, so first-page latency does not wait for a block flush.

The blocks and manifests are the JAX package's bytes (MessagePack through
utils/msgpack.py, then zlib): a cache either package persists is served
by the other.

Divergences from the reference, as in the JAX package: blocks are
plain replicated cache files rather than erasure-coded objects (losing
one merely falls back to a walk), and invalidation is a local per-bucket
write sequence (strict on the writing node) plus a TTL bound on
cross-node staleness — the reference likewise serves finished caches
only within a freshness window (cmd/metacache.go metacacheMaxRunningAge).
"""
from __future__ import annotations

import hashlib
import heapq
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterator

from ..storage.xlmeta import XLMeta
from ..utils import errors
from ..utils import msgpack


@dataclass
class MetaCacheEntry:
    """One merged namespace entry: the object name plus every walked
    disk's raw xl.meta bytes."""
    name: str
    raws: list[bytes] = field(default_factory=list)

    _meta: XLMeta | None = None

    _win_raw: bytes | None = None

    def resolve(self) -> XLMeta | None:
        """The agreed version journal: byte-identical fast path first
        (no parse per replica), else parse all and take the journal with
        the newest latest-version mod_time (any disk that accepted the
        last committed write has it; stale disks lose the comparison).
        Records the winning raw bytes in ``_win_raw`` (the persistence
        layer stores them without re-parsing). Returns None when no
        replica parses."""
        if self._meta is not None:
            return self._meta
        first = self.raws[0]
        if all(r == first for r in self.raws[1:]):
            try:
                self._meta = XLMeta.load(first)
                self._win_raw = first
            except errors.FileCorrupt:
                self._meta = None
            return self._meta
        best: XLMeta | None = None
        best_t = -1.0
        for raw in self.raws:
            try:
                m = XLMeta.load(raw)
            except errors.FileCorrupt:
                continue
            t = m.latest_mod_time()
            if t > best_t or (t == best_t and best is not None
                              and len(m.versions) > len(best.versions)):
                best, best_t = m, t
                self._win_raw = raw
        self._meta = best
        return best


def merged_entries(disks: list, bucket: str, prefix: str = "",
                   marker: str = "") -> Iterator[MetaCacheEntry]:
    """Lazily merge every online disk's sorted walk_versions stream and
    group by name, applying the write-quorum emission rule. Raises
    ErasureReadQuorum when no disk can walk at all; VolumeNotFound
    propagates (bucket existence is a harder error than a sick disk)."""
    streams = []
    vol_missing = 0
    total = len(disks)
    for d in disks:
        if d is None:
            continue
        try:
            it = iter(d.walk_versions(bucket, prefix, marker))
            first = next(it, None)
        except errors.VolumeNotFound:
            vol_missing += 1
            continue
        except errors.StorageError:
            continue

        def stream(first_item, rest):
            if first_item is not None:
                yield first_item
            try:
                yield from rest
            except errors.StorageError:
                return  # disk died mid-walk: its remaining votes vanish

        streams.append(stream(first, it))
    if not streams:
        if vol_missing:
            raise errors.VolumeNotFound(bucket)
        raise errors.ErasureReadQuorum()
    need = min(total // 2 + 1, len(streams))
    merged = heapq.merge(*streams, key=lambda t: t[0])
    cur: MetaCacheEntry | None = None
    for name, raw in merged:
        if cur is not None and name != cur.name:
            if len(cur.raws) >= need:
                yield cur
            cur = None
        if cur is None:
            cur = MetaCacheEntry(name=name)
        cur.raws.append(raw)
    if cur is not None and len(cur.raws) >= need:
        yield cur


# --- persistence -----------------------------------------------------------

#: Entries per persisted block (reference cmd/metacache-stream.go writes
#: 5000-object blocks).
BLOCK_SIZE = 5000
#: Finished caches older than this are not served (cross-node staleness
#: bound; reference metacacheMaxRunningAge is one minute).
CACHE_TTL_S = 60.0
#: Replicas per block — cache loss is only a walk, not data loss.
BLOCK_COPIES = 2
#: How long a failed manifest probe suppresses re-probing (bounds the
#: per-restart disk fan-out of uncached delimiter pages).
NEG_MANIFEST_TTL_S = 5.0

from ..storage.xlstorage import META_BUCKET  # noqa: E402


def _cache_dir(bucket: str, root: str) -> str:
    h = hashlib.sha1(f"{bucket}\x00{root}".encode()).hexdigest()[:20]
    return f"buckets/{bucket}/.metacache/{h}"


def _pack_block(build_id: str, entries: list[tuple[str, bytes]]) -> bytes:
    return zlib.compress(
        msgpack.packb({"v": 1, "id": build_id, "e": entries}), 1)


def _unpack_block(raw: bytes, build_id: str) -> list[tuple[str, bytes]]:
    try:
        d = msgpack.unpackb(zlib.decompress(raw))
        if d.get("v") != 1 or d.get("id") != build_id:
            raise errors.FileCorrupt(
                "metacache block from a different build")
        return [(name, raw_meta) for name, raw_meta in d["e"]]
    except errors.StorageError:
        raise
    except Exception as e:  # noqa: BLE001 — truncated/corrupt replica
        raise errors.FileCorrupt(f"metacache block undecodable: {e}") \
            from e


@dataclass
class _BlockInfo:
    n: int
    first: str
    last: str
    count: int
    disks: list  # disk indices holding a replica


class _CacheState:
    """One cache build / finished cache for a (bucket, root) pair."""

    def __init__(self, bucket: str, root: str, build_id: str, seq: int):
        self.bucket = bucket
        self.root = root
        self.build_id = build_id
        self.seq = seq
        self.created = time.time()
        self.blocks: list[_BlockInfo] = []
        self.pending: list[tuple[str, bytes]] = []  # frontier (unflushed)
        self.ended = False
        self.error: BaseException | None = None
        self.cv = threading.Condition()
        self.remote = False  # loaded from a manifest another node wrote

    def usable(self, cur_seq: int, dirty_at: float = 0.0) -> bool:
        if self.error is not None:
            return False
        # wall clock is CORRECT here: `created` is persisted in the
        # manifest and compared against other nodes' clocks/dirty marks,
        # so a monotonic stamp would be meaningless across processes
        if time.time() - self.created > CACHE_TTL_S:
            return False
        # a locally-observed write after creation invalidates. Local
        # states compare write sequences; manifests loaded from disk
        # (possibly another node's build) carry only their creation time,
        # so they must postdate this node's last write to the bucket —
        # cross-node writes are bounded by the TTL alone.
        if self.remote:
            return self.created > dirty_at
        return self.seq == cur_seq

    def manifest_bytes(self) -> bytes:
        return msgpack.packb({
            "v": 1, "id": self.build_id, "bucket": self.bucket,
            "root": self.root, "created": self.created,
            "blocks": [{"n": b.n, "first": b.first, "last": b.last,
                        "count": b.count, "disks": list(b.disks)}
                       for b in self.blocks],
        })

    @classmethod
    def from_manifest(cls, raw: bytes) -> "_CacheState":
        try:
            d = msgpack.unpackb(raw)
        except ValueError as e:
            raise errors.FileCorrupt(f"metacache manifest: {e}") from e
        if d.get("v") != 1:
            raise errors.FileCorrupt("metacache manifest version")
        st = cls(d["bucket"], d["root"], d["id"], -1)
        st.created = d["created"]
        st.blocks = [_BlockInfo(b["n"], b["first"], b["last"], b["count"],
                                list(b["disks"])) for b in d["blocks"]]
        st.ended = True
        st.remote = True
        return st


class MetacacheStore:
    """Persisted-listing coordinator for one erasure set.

    ``iter_entries`` is the only entry point: it serves (name,
    raw-journal, parsed-meta-or-None) triples after ``marker`` from a
    finished or in-progress cache when one is usable, becomes the
    builder when none is, and falls back to the plain merged walk
    whenever anything about the cache path fails."""

    def __init__(self, objlayer):
        self.obj = objlayer  # ErasureObjects (for .disks)
        self._lock = threading.Lock()
        self._states: dict[tuple[str, str], _CacheState] = {}
        self._seqs: dict[str, int] = {}  # bucket -> local write sequence
        self._dirty_at: dict[str, float] = {}  # bucket -> last write time
        # negative manifest-probe memo: (bucket, prefix) -> probe time.
        # Without it, every collapsed-subtree restart of a delimiter page
        # fans a failing read_all to all live disks.
        self._no_manifest: dict[tuple[str, str], float] = {}
        self._builders = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="minio-torch-metacache")
        self._building = 0
        # small decompressed-block LRU: (dir, n) -> entries
        self._block_cache: dict[tuple[str, int], list] = {}
        self._block_cache_cap = 8
        # telemetry
        self.serves_cached = 0
        self.serves_walked = 0
        self.builds = 0

    # --- invalidation ----------------------------------------------------

    def on_write(self, bucket: str) -> None:
        """Bump the bucket's write sequence; caches built before it stop
        being served on this node. Cheap enough for every mutation."""
        with self._lock:
            self._seqs[bucket] = self._seqs.get(bucket, 0) + 1
            self._dirty_at[bucket] = time.time()

    def _seq(self, bucket: str) -> int:
        with self._lock:
            return self._seqs.get(bucket, 0)

    def _dirty(self, bucket: str) -> float:
        with self._lock:
            return self._dirty_at.get(bucket, 0.0)

    # --- block/manifest IO ----------------------------------------------

    def _live_disk_indices(self) -> list[int]:
        return [i for i, d in enumerate(self.obj.disks) if d is not None]

    def _write_block(self, cdir: str, st: _CacheState, n: int,
                     entries: list[tuple[str, bytes]]) -> _BlockInfo:
        raw = _pack_block(st.build_id, entries)
        live = self._live_disk_indices()
        if not live:
            raise errors.ErasureWriteQuorum()
        wrote = []
        for j in range(len(live)):
            i = live[(n + j) % len(live)]
            try:
                self.obj.disks[i].write_all(
                    META_BUCKET, f"{cdir}/block-{n}", raw)
                wrote.append(i)
            except errors.StorageError:
                continue
            if len(wrote) >= BLOCK_COPIES:
                break
        if not wrote:
            raise errors.ErasureWriteQuorum()
        return _BlockInfo(n, entries[0][0], entries[-1][0], len(entries),
                          wrote)

    def _read_block(self, cdir: str, st: _CacheState, b: _BlockInfo
                    ) -> list[tuple[str, bytes]]:
        # keyed by build id: rebuilds reuse the same directory, and a
        # stale decompressed block must not outlive its build
        key = (cdir, st.build_id, b.n)
        cached = self._block_cache.get(key)
        if cached is not None:
            return cached
        last: BaseException = errors.FileNotFound(f"{cdir}/block-{b.n}")
        for i in list(b.disks) + self._live_disk_indices():
            d = self.obj.disks[i] if 0 <= i < len(self.obj.disks) else None
            if d is None:
                continue
            try:
                entries = _unpack_block(
                    d.read_all(META_BUCKET, f"{cdir}/block-{b.n}"),
                    st.build_id)
                with self._lock:
                    self._block_cache[key] = entries
                    while len(self._block_cache) > self._block_cache_cap:
                        self._block_cache.pop(
                            next(iter(self._block_cache)))
                return entries
            except errors.StorageError as e:
                last = e
        raise last

    def _write_manifest(self, cdir: str, st: _CacheState) -> None:
        raw = st.manifest_bytes()
        wrote = 0
        for i in self._live_disk_indices():
            try:
                self.obj.disks[i].write_all(META_BUCKET,
                                            f"{cdir}/manifest", raw)
                wrote += 1
            except errors.StorageError:
                continue
        if wrote == 0:
            raise errors.ErasureWriteQuorum()

    def _load_manifest(self, bucket: str, root: str) -> _CacheState | None:
        cdir = _cache_dir(bucket, root)
        for i in self._live_disk_indices():
            try:
                st = _CacheState.from_manifest(
                    self.obj.disks[i].read_all(META_BUCKET,
                                               f"{cdir}/manifest"))
                if st.bucket == bucket and st.root == root:
                    return st
            except errors.StorageError:
                continue
        return None

    # --- build -----------------------------------------------------------

    def _build(self, st: _CacheState) -> None:
        cdir = _cache_dir(st.bucket, st.root)
        try:
            buf: list[tuple[str, bytes]] = []
            n = 0
            for entry in merged_entries(self.obj.disks, st.bucket,
                                        st.root, ""):
                meta = entry.resolve()
                if meta is None or not meta.versions:
                    continue
                # store the WINNING journal bytes (resolution happened
                # above; replaying consumers just XLMeta.load them)
                win = self._winning_raw(entry)
                if win is None:
                    continue
                buf.append((entry.name, win))
                with st.cv:
                    st.pending.append((entry.name, win))
                    st.cv.notify_all()
                if len(buf) >= BLOCK_SIZE:
                    bi = self._write_block(cdir, st, n, buf)
                    with st.cv:
                        st.blocks.append(bi)
                        st.pending = st.pending[len(buf):]
                        st.cv.notify_all()
                    buf = []
                    n += 1
            if buf:
                bi = self._write_block(cdir, st, n, buf)
                with st.cv:
                    st.blocks.append(bi)
                    st.pending = st.pending[len(buf):]
                    st.cv.notify_all()
            with st.cv:
                st.ended = True
                st.cv.notify_all()
            self._write_manifest(cdir, st)
        except BaseException as e:  # noqa: BLE001 — cache is best-effort
            with st.cv:
                st.error = e
                st.ended = True
                st.cv.notify_all()
        finally:
            with self._lock:
                self._building -= 1

    @staticmethod
    def _winning_raw(entry: MetaCacheEntry) -> bytes | None:
        """The raw journal bytes matching entry.resolve()'s winner."""
        return None if entry.resolve() is None else entry._win_raw

    # --- serve -----------------------------------------------------------

    def iter_entries(self, bucket: str, prefix: str = "", marker: str = "",
                     build: bool = True
                     ) -> Iterator[tuple[str, bytes, object]]:
        """(name, winning-raw-journal, parsed-XLMeta-or-None) triples with
        name > marker, under ``prefix``. The walk path hands back the
        XLMeta it already parsed for quorum resolution (so local
        consumers don't re-parse); block-served entries carry None and
        the consumer parses the raw. Cache path when possible, else
        plain walk.

        ``build=False`` serves from an existing cache but never starts a
        background build: delimiter pages restart the stream past each
        collapsed subtree, and kicking a full-namespace walk for what the
        caller will mostly skip would break the O(page) property the walk
        layer guarantees (the reference separates recursive and
        non-recursive cache scopes for the same reason)."""
        if bucket == META_BUCKET:
            # system-bucket traffic (configs, these cache blocks...) is
            # small, write-heavy and self-referential: never cache it
            yield from self._walk(bucket, prefix, marker)
            return
        st = self._get_or_start(bucket, prefix, build)
        if st is None:
            yield from self._walk(bucket, prefix, marker)
            return
        last = marker
        try:
            for name, raw in self._serve(st, marker):
                yield name, raw, None
                last = name
        except errors.StorageError:
            # cache path failed mid-stream: continue transparently from
            # the last yielded name via the plain walk. Drop the state
            # only if its build FINISHED — popping a running build would
            # let a second builder start into the same cache directory
            # and clobber the first's block files.
            with self._lock:
                if self._states.get((bucket, prefix)) is st and st.ended:
                    self._states.pop((bucket, prefix), None)
            yield from self._walk(bucket, prefix, last)

    def _walk(self, bucket: str, prefix: str, marker: str
              ) -> Iterator[tuple[str, bytes, object]]:
        self.serves_walked += 1
        for entry in merged_entries(self.obj.disks, bucket, prefix,
                                    marker):
            meta = entry.resolve()
            if meta is not None and entry._win_raw is not None:
                yield entry.name, entry._win_raw, meta

    def _get_or_start(self, bucket: str, prefix: str, build: bool = True
                      ) -> _CacheState | None:
        cur_seq = self._seq(bucket)
        dirty = self._dirty(bucket)
        with self._lock:
            st = self._states.get((bucket, prefix))
            if st is not None:
                if st.usable(cur_seq, dirty):
                    return st
                if not st.ended:
                    # an in-progress build invalidated by a newer write:
                    # let it finish for its own consumers, walk for ours
                    return None
                self._states.pop((bucket, prefix), None)
        # a finished cache another node built?
        loaded = None
        with self._lock:
            neg_at = self._no_manifest.get((bucket, prefix), 0.0)
        if time.time() - neg_at > NEG_MANIFEST_TTL_S:
            try:
                loaded = self._load_manifest(bucket, prefix)
            except Exception:  # noqa: BLE001 — any surprise: walk
                loaded = None
            if loaded is None:
                with self._lock:
                    self._no_manifest[(bucket, prefix)] = time.time()
                    while len(self._no_manifest) > 512:
                        self._no_manifest.pop(
                            next(iter(self._no_manifest)))
        if loaded is not None and loaded.usable(cur_seq, dirty):
            with self._lock:
                self._states[(bucket, prefix)] = loaded
            return loaded
        if not build:
            return None
        # become the builder (bounded: beyond 2 concurrent builds the
        # extra listings just walk)
        with self._lock:
            raced = self._states.get((bucket, prefix))
            if raced is not None:
                # another lister installed a state while we were probing
                # the manifest: two builds would clobber each other's
                # block files in the shared cache directory
                return raced if raced.usable(cur_seq, dirty) else None
            if self._building >= 2:
                return None
            self._building += 1
            self._prune_locked()
            st = _CacheState(bucket, prefix,
                             hashlib.sha1(
                                 f"{bucket}|{prefix}|{cur_seq}|"
                                 f"{time.time_ns()}".encode()
                             ).hexdigest()[:16], cur_seq)
            self._states[(bucket, prefix)] = st
            self.builds += 1
        self._builders.submit(self._build, st)
        return st

    def _prune_locked(self) -> None:
        """Drop TTL-expired finished states (called under _lock) and
        best-effort delete their on-disk block directories, so distinct
        listed prefixes don't accumulate state or .minio.sys garbage."""
        now = time.time()
        dead = [(k, s) for k, s in self._states.items()
                if s.ended and now - s.created > CACHE_TTL_S]
        for k, s in dead:
            del self._states[k]
        if dead:
            def rm(dead=dead):
                for (bkt, root), _s in dead:
                    cdir = _cache_dir(bkt, root)
                    for d in self.obj.disks:
                        if d is None:
                            continue
                        try:
                            d.delete_path(META_BUCKET, cdir,
                                          recursive=True)
                        except Exception:  # noqa: BLE001 — best effort
                            pass
            self._builders.submit(rm)

    def _serve(self, st: _CacheState, marker: str
               ) -> Iterator[tuple[str, bytes]]:
        self.serves_cached += 1
        cdir = _cache_dir(st.bucket, st.root)
        bi = 0
        # skip whole blocks below the marker
        while bi < len(st.blocks) and st.blocks[bi].last <= marker \
                and marker:
            bi += 1
        while True:
            with st.cv:
                have_block = bi < len(st.blocks)
            if have_block:
                for name, raw in self._read_block(cdir, st, st.blocks[bi]):
                    if marker and name <= marker:
                        continue
                    yield name, raw
                bi += 1
                continue
            # at the frontier: drain pending entries / wait for progress
            with st.cv:
                while True:
                    if bi < len(st.blocks):
                        break  # a new block appeared: outer loop reads it
                    # only entries NEWER than what we already yielded
                    # count as progress (pending is append-ordered, so
                    # its last name is its max): a consumer that has
                    # drained the frontier must WAIT here, not re-copy
                    # the same entries in a busy spin until the builder
                    # ends — on a sub-block namespace that spin burned
                    # ~45k lock acquisitions per listing (9M across one
                    # scanner cycle at 200 objects) and starved the
                    # builder it was waiting on
                    if st.pending and (not marker or
                                       st.pending[-1][0] > marker):
                        pend = list(st.pending)
                        break
                    if st.ended:
                        if st.error is not None and not st.remote:
                            raise errors.FaultyDisk(
                                f"metacache build failed: {st.error}")
                        return
                    if not st.cv.wait(timeout=30):
                        raise errors.FaultyDisk(
                            "metacache build stalled")
                if bi < len(st.blocks):
                    continue
            # yield the frontier outside the lock, then re-sync: entries
            # we yielded may since have been flushed into a block — skip
            # that block if it only contains what we already emitted
            last_name = marker
            for name, raw in pend:
                if last_name and name <= last_name:
                    continue
                yield name, raw
                last_name = name
            marker = last_name
            with st.cv:
                while bi < len(st.blocks) and \
                        st.blocks[bi].last <= marker:
                    bi += 1
