"""Hierarchical data-usage accounting, the port of
minio_tpu/scanner/usage.py (reference cmd/data-usage-cache.go:
dataUsageEntry tree keyed by folder, compacted below an object-count
threshold, size histogram per node, persisted each scanner cycle and
resumed on restart).

One ``UsageTree`` per bucket: nested folder nodes carrying {objects,
versions, size, histogram}, inserted during the scanner crawl, compacted
bottom-up (subtrees under ``COMPACT_LEAST`` objects collapse into their
parent), and persisted as a MessagePack blob per bucket under the config
plane. The admin DataUsageInfo op reads the persisted trees, so a restart
serves per-prefix breakdowns without a fresh walk.

The JAX package packs the tree with the ``msgpack`` wheel; this module
packs it with ``utils.msgpack``, whose subset gives the same bytes for the
tree's nested ``[int, int, int, list, map]`` nodes, so either package
reads the other's ``tree-<bucket>.bin``."""
from __future__ import annotations

import json

from ..utils import errors
from ..utils import msgpack

USAGE_PATH = "data-usage/usage.json"
TREE_PATH = "data-usage/tree-{bucket}.bin"

#: Subtrees with fewer objects than this collapse into their parent
#: (reference dataScannerCompactLeastObject = 500).
COMPACT_LEAST = 500
#: Folder-node budget per bucket tree before compaction kicks in
#: (reference dataUsageCompactAtFolders order of magnitude).
MAX_NODES = 10000
#: Maximum folder depth tracked before entries aggregate at the cap.
MAX_DEPTH = 8

#: Size-class boundaries (reference ObjectsHistogramIntervals,
#: cmd/data-usage-utils.go): label -> inclusive upper bound.
HISTOGRAM_INTERVALS = [
    ("LESS_THAN_1024_B", 1024 - 1),
    ("BETWEEN_1024_B_AND_1_MB", (1 << 20) - 1),
    ("BETWEEN_1_MB_AND_10_MB", (10 << 20) - 1),
    ("BETWEEN_10_MB_AND_64_MB", (64 << 20) - 1),
    ("BETWEEN_64_MB_AND_128_MB", (128 << 20) - 1),
    ("BETWEEN_128_MB_AND_512_MB", (512 << 20) - 1),
    ("GREATER_THAN_512_MB", None),
]


def histogram_bucket(size: int) -> int:
    for i, (_label, hi) in enumerate(HISTOGRAM_INTERVALS):
        if hi is None or size <= hi:
            return i
    return len(HISTOGRAM_INTERVALS) - 1


class UsageNode:
    __slots__ = ("objects", "versions", "size", "hist", "children")

    def __init__(self):
        self.objects = 0
        self.versions = 0
        self.size = 0
        self.hist = [0] * len(HISTOGRAM_INTERVALS)
        self.children: dict[str, UsageNode] = {}

    def _add_self(self, size: int, versions: int) -> None:
        self.objects += 1
        self.versions += versions
        self.size += size
        self.hist[histogram_bucket(size)] += 1


class UsageTree:
    """Per-bucket folder tree. add() charges the object to every node on
    its folder path, so any node's counters describe its whole subtree."""

    def __init__(self):
        self.root = UsageNode()

    def add(self, object_name: str, size: int, versions: int = 1) -> None:
        node = self.root
        node._add_self(size, versions)
        parts = object_name.split("/")[:-1][:MAX_DEPTH]
        for part in parts:
            node = node.children.setdefault(part, UsageNode())
            node._add_self(size, versions)

    def node_count(self) -> int:
        def count(node: UsageNode) -> int:
            return 1 + sum(count(c) for c in node.children.values())

        return count(self.root)

    def compact(self, least: int = COMPACT_LEAST,
                max_nodes: int = MAX_NODES) -> None:
        """Bound the tree: while it holds more than ``max_nodes`` folder
        nodes, collapse subtrees smaller than ``least`` objects into their
        parent (counters are already included upward: compaction only
        drops child detail), doubling ``least`` until it fits. Small
        namespaces keep full detail."""
        least = max(1, least)
        while self.node_count() > max_nodes:
            def walk(node: UsageNode) -> None:
                for name in list(node.children):
                    child = node.children[name]
                    if child.objects < least:
                        del node.children[name]
                    else:
                        walk(child)

            walk(self.root)
            # every child holds >= 1 object, so least must exceed 1 for a
            # pass to guarantee progress; growing it geometrically makes
            # termination unconditional
            least = max(2, least * 2)

    def prefixes(self, depth: int = 2) -> dict[str, dict]:
        """Flatten to {'prefix/': {objects, size, versions}} down to
        ``depth`` folder levels."""
        out: dict[str, dict] = {}

        def walk(node: UsageNode, path: str, d: int) -> None:
            for name, child in sorted(node.children.items()):
                p = f"{path}{name}/"
                out[p] = {"objects": child.objects, "size": child.size,
                          "versions": child.versions}
                if d + 1 < depth:
                    walk(child, p, d + 1)

        walk(self.root, "", 0)
        return out

    def histogram(self) -> dict[str, int]:
        return {label: self.root.hist[i]
                for i, (label, _hi) in enumerate(HISTOGRAM_INTERVALS)}

    # --- (de)serialization ---------------------------------------------------

    def to_bytes(self) -> bytes:
        def enc(node: UsageNode):
            return [node.objects, node.versions, node.size, node.hist,
                    {k: enc(v) for k, v in node.children.items()}]

        return msgpack.packb({"v": 1, "root": enc(self.root)})

    @classmethod
    def from_bytes(cls, raw: bytes) -> "UsageTree":
        doc = msgpack.unpackb(raw)
        if not isinstance(doc, dict) or doc.get("v") != 1:
            raise ValueError("usage tree version")

        def dec(data) -> UsageNode:
            n = UsageNode()
            n.objects, n.versions, n.size = data[0], data[1], data[2]
            n.hist = list(data[3])[:len(HISTOGRAM_INTERVALS)]
            n.hist += [0] * (len(HISTOGRAM_INTERVALS) - len(n.hist))
            n.children = {k: dec(v) for k, v in data[4].items()}
            return n

        t = cls()
        t.root = dec(doc["root"])
        return t


# --- persistence -------------------------------------------------------------


def save_usage(objlayer, usage: dict) -> None:
    objlayer.put_config(USAGE_PATH, json.dumps(usage).encode())


def load_usage(objlayer) -> dict:
    try:
        return json.loads(objlayer.get_config(USAGE_PATH))
    except (errors.StorageError, ValueError):
        return {"last_update": 0, "objects_total": 0, "size_total": 0,
                "buckets": {}}


def save_tree(objlayer, bucket: str, tree: UsageTree) -> None:
    objlayer.put_config(TREE_PATH.format(bucket=bucket), tree.to_bytes())


def load_tree(objlayer, bucket: str) -> UsageTree | None:
    try:
        return UsageTree.from_bytes(
            objlayer.get_config(TREE_PATH.format(bucket=bucket)))
    except (errors.StorageError, ValueError):
        return None


def delete_tree(objlayer, bucket: str) -> None:
    try:
        objlayer.delete_config(TREE_PATH.format(bucket=bucket))
    except errors.StorageError:
        pass


def data_usage_info(objlayer, depth: int = 2) -> dict:
    """The admin DataUsageInfo document (reference madmin.DataUsageInfo):
    the persisted snapshot enriched with per-prefix breakdowns and size
    histograms from the persisted trees. No namespace walk happens here,
    so it answers at once, even right after a restart."""
    doc = load_usage(objlayer)
    for bucket, stats in doc.get("buckets", {}).items():
        tree = load_tree(objlayer, bucket)
        if tree is not None:
            stats["prefixes"] = tree.prefixes(depth)
            stats["histogram"] = tree.histogram()
    return doc
