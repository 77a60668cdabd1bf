"""Erasure codec wrapper — the port of erasure/codec.py: geometry, the
reference's shard-size math, and the blockwise encode/decode entry points,
with the GF(256) math on the device codec (ops/rs_torch.ReedSolomon) and
the batched entry points on the dispatch queue (runtime/dispatch.py).

Shard-size math is bit-identical to the JAX package (and the reference):
- ShardSize            = ceil(blockSize / dataBlocks)
- ShardFileSize(total) = fullBlocks*ShardSize + ceil(last/k)
- ShardFileOffset      = endBlock*ShardSize + ceil(tail/k)

The kernels need 4-byte-aligned shards; alignment padding is internal to
encode/decode, so shards on disk keep the exact reference sizes.
"""
from __future__ import annotations

from concurrent.futures import Future

import numpy as np

from ..ops.rs_torch import ReedSolomon, get_codec, pack_shards, unpack_shards
from ..utils.device import resolve_device


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def shard_file_size(total_length: int, block_size: int,
                    data_blocks: int) -> int:
    """Final erasure-shard file size for an object of ``total_length``
    bytes in blocks of ``block_size`` over ``data_blocks`` shards (-1 for
    an unknown length) — the geometry math alone, with no codec."""
    if total_length == 0:
        return 0
    if total_length < 0:
        return -1
    full, last = divmod(total_length, block_size)
    size = full * ceil_div(block_size, data_blocks)
    if last:
        size += ceil_div(last, data_blocks)
    return size


def _chain(fut: Future, fn) -> Future:
    out = Future()

    def cb(f):
        try:
            out.set_result(fn(f.result()))
        except Exception as e:  # noqa: BLE001 — surfaces at .result()
            out.set_exception(e)

    fut.add_done_callback(cb)
    return out


def _as_u8(data) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else np.asarray(data, dtype=np.uint8)


class Erasure:
    """Erasure codec for one (data, parity, block_size) geometry on one
    device (``None`` = the CUDA card; ``"cpu"`` runs the plain versions).
    ``queue`` defaults to the device's process-wide dispatch queue, so
    concurrent requests coalesce into shared launches."""

    def __init__(self, data_blocks: int, parity_blocks: int, block_size: int,
                 matrix_kind: str = "vandermonde", device=None, queue=None):
        if data_blocks <= 0 or parity_blocks < 1:
            raise ValueError(
                f"invalid erasure geometry {data_blocks}+{parity_blocks}")
        if data_blocks + parity_blocks > 256:
            raise ValueError("total shard count exceeds 256")
        self.data_blocks = data_blocks
        self.parity_blocks = parity_blocks
        self.block_size = block_size
        self.device = resolve_device(device)
        self.codec: ReedSolomon = get_codec(data_blocks, parity_blocks,
                                            matrix_kind, self.device)
        self._queue = queue

    @property
    def queue(self):
        if self._queue is None:
            from ..runtime.dispatch import global_queue
            self._queue = global_queue(self.device)
        return self._queue

    # --- shard-size math ----------------------------------------------------

    def shard_size(self) -> int:
        """Size of each shard for one full block."""
        return ceil_div(self.block_size, self.data_blocks)

    def shard_file_size(self, total_length: int) -> int:
        """Final erasure-shard file size for an object of ``total_length``
        bytes."""
        return shard_file_size(total_length, self.block_size,
                               self.data_blocks)

    def shard_file_offset(self, start_offset: int, length: int,
                          total_length: int) -> int:
        """Offset within the shard file where a read ending at
        start_offset+length stops."""
        shard_size = self.shard_size()
        shard_file_size = self.shard_file_size(total_length)
        end_shard = (start_offset + length) // self.block_size
        till_offset = end_shard * shard_size + shard_size
        if till_offset > shard_file_size:
            till_offset = shard_file_size
        return till_offset

    # --- blockwise encode/decode -------------------------------------------

    def _split_padded(self, buf: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                                      int]:
        """(shards [k, true], 4-aligned padded shards, true shard length):
        the split stride is the exact reference shard length ceil(len/k);
        kernel alignment padding is trailing zeros per shard, so parity
        truncated back to the true length matches the exact-size parity."""
        true_shard = ceil_div(buf.size, self.data_blocks)
        shards = self.codec.split(buf, true_shard)
        pad = (-true_shard) % 4
        padded = np.concatenate(
            [shards, np.zeros((self.data_blocks, pad), np.uint8)], axis=1) \
            if pad else shards
        return shards, padded, true_shard

    def encode_data(self, data) -> list[np.ndarray]:
        """Split one block into k data shards, compute m parity shards on
        the device, return all k+m (reference EncodeData)."""
        buf = _as_u8(data)
        if buf.size == 0:
            return [np.empty(0, np.uint8)
                    for _ in range(self.data_blocks + self.parity_blocks)]
        shards, padded, true_shard = self._split_padded(buf)
        parity = self.codec.encode(padded)
        return [shards[i] for i in range(self.data_blocks)] + \
               [parity[i][:true_shard] for i in range(self.parity_blocks)]

    # --- async batched entry points (ride the dispatch queue) ---------------

    def encode_data_async(self, data) -> Future:
        """Like encode_data but Future[list[shard]]; the parity math
        coalesces with other in-flight blocks on the dispatch queue."""
        buf = _as_u8(data)
        if buf.size == 0:
            out = Future()
            out.set_result(self.encode_data(buf))
            return out
        shards, padded, true_shard = self._split_padded(buf)
        fut = self.queue.encode(self.codec, pack_shards(padded))

        def finish(parity_words):
            parity = unpack_shards(parity_words)
            return [shards[i] for i in range(self.data_blocks)] + \
                   [parity[i][:true_shard]
                    for i in range(self.parity_blocks)]
        return _chain(fut, finish)

    def encode_hashed_async(self, data, chunk_size: int, algo: int = 0
                            ) -> Future:
        """Fused encode+hash for one block: Future[(data uint8 [k, S],
        parity uint8 [m, S], digests uint8 [k+m, nc*32])] — the per-chunk
        bitrot digests of every data AND parity shard come from the same
        flush as the parity. Needs ``shard_len % chunk_size == 0`` (tail
        blocks take the host-hash route)."""
        buf = _as_u8(data)
        true_shard = ceil_div(buf.size, self.data_blocks)
        if buf.size == 0 or true_shard % chunk_size:
            raise ValueError("encode_hashed needs chunk-aligned shards")
        shards = self.codec.split(buf, true_shard)
        from .bitrot import HIGHWAY_KEY
        fut = self.queue.encode_hashed(
            self.codec, pack_shards(shards), HIGHWAY_KEY, chunk_size, algo)

        def finish(res):
            parity_words, digs = res
            return shards, unpack_shards(parity_words), \
                np.ascontiguousarray(digs).view(np.uint8).reshape(
                    self.data_blocks + self.parity_blocks, -1)
        return _chain(fut, finish)

    def _present(self, aligned: list) -> tuple[int, ...]:
        present = tuple(i for i, s in enumerate(aligned)
                        if s is not None)[: self.data_blocks]
        if len(present) < self.data_blocks:
            raise ValueError(
                f"cannot rebuild: {len(present)} shards present, "
                f"need {self.data_blocks}")
        return present

    def rebuild_targets_async(self, shards: list, targets: tuple[int, ...]
                              ) -> Future:
        """Rebuild the ``targets`` shard indices (<= parity count, data or
        parity) from any k present shards; Future[list aligned with
        targets]. Batches across loss patterns via per-item masks."""
        if len(targets) > self.parity_blocks:
            raise ValueError(
                f"{len(targets)} targets > parity {self.parity_blocks}: "
                "unrecoverable")
        aligned, true_len = self._aligned(shards)
        present = self._present(aligned)
        gathered = np.stack([aligned[i] for i in present])
        masks = self.codec.target_masks_np(present, tuple(targets))
        fut = self.queue.masked(self.codec, pack_shards(gathered), masks)

        def finish(out_words):
            out = unpack_shards(out_words)
            return [out[i][:true_len] for i in range(len(targets))]
        return _chain(fut, finish)

    def rebuild_targets_verified_async(self, shards: list, digests: list,
                                       targets: tuple[int, ...],
                                       chunk_size: int, algo: int = 0,
                                       hash_out: bool = False) -> Future:
        """Fused bitrot-verify + rebuild: like rebuild_targets_async, but
        each chosen source shard's per-chunk digests (``digests`` aligned
        with ``shards``) are verified on the device in the same flush.
        Future -> (rebuilt list aligned with targets, corrupt: tuple of
        shard indices whose digests mismatched). When corrupt is non-empty
        the rebuilt data is garbage — callers drop those sources and retry
        (the reference's replacement-read pattern). ``hash_out`` appends
        the rebuilt shards' chunk digests, uint8 [len(targets), nc*32]."""
        from .bitrot import HIGHWAY_KEY
        if len(targets) > self.parity_blocks:
            raise ValueError(
                f"{len(targets)} targets > parity {self.parity_blocks}: "
                "unrecoverable")
        aligned, true_len = self._aligned(shards)
        if true_len % chunk_size:
            raise ValueError("shard length is not a bitrot-chunk multiple")
        present = self._present(aligned)
        gathered = np.stack([aligned[i] for i in present])
        digs = np.stack([np.frombuffer(digests[i], dtype=np.uint32)
                         for i in present])
        masks = self.codec.target_masks_np(present, tuple(targets))
        fut = self.queue.fused(self.codec, pack_shards(gathered), masks, digs,
                               HIGHWAY_KEY, chunk_size, algo, hash_out)

        def finish(res):
            out_words, valid = res[0], res[1]
            corrupt = tuple(present[i] for i in np.nonzero(~valid)[0])
            out = unpack_shards(out_words)
            rebuilt = [out[i][:true_len] for i in range(len(targets))]
            if not hash_out:
                return rebuilt, corrupt
            return rebuilt, corrupt, np.ascontiguousarray(res[2]).view(
                np.uint8).reshape(len(targets), -1)
        return _chain(fut, finish)

    def verify_digests_async(self, shards: list, digests: list,
                             chunk_size: int, algo: int = 0) -> Future:
        """Device digest check of the k data shards of a healthy read:
        Future[corrupt tuple of data-shard indices]."""
        from .bitrot import HIGHWAY_KEY
        k = self.data_blocks
        aligned, true_len = self._aligned(shards[:k])
        if true_len % chunk_size:
            raise ValueError("shard length is not a bitrot-chunk multiple")
        words = pack_shards(np.stack(aligned))
        digs = np.stack([np.frombuffer(digests[i], dtype=np.uint32)
                         for i in range(k)])
        fut = self.queue.verify(self.codec, words, digs, HIGHWAY_KEY,
                                chunk_size, algo)
        return _chain(fut, lambda valid: tuple(
            int(i) for i in np.nonzero(~valid)[0]))

    def decode_data_blocks_async(self, shards: list) -> Future:
        """Async DecodeDataBlocks: missing data shards rebuilt on the
        dispatch queue; complete shard lists resolve immediately."""
        missing = tuple(i for i in range(self.data_blocks)
                        if shards[i] is None)
        if not missing:
            out = Future()
            out.set_result(list(shards))
            return out
        fut = self.rebuild_targets_async(shards, missing)

        def finish(rebuilt):
            out = list(shards)
            for t, arr in zip(missing, rebuilt):
                out[t] = arr
            return out
        return _chain(fut, finish)

    def decode_data_blocks_verified_async(self, shards: list, digests: list,
                                          chunk_size: int, algo: int = 0
                                          ) -> Future:
        """Device-verified DecodeDataBlocks: every source shard's digests
        are checked on the device — with the rebuild of the missing data
        shards in the same flush when the read is degraded, alone when all
        k data shards arrived. Future -> (shard list with data filled,
        corrupt indices)."""
        missing = tuple(i for i in range(self.data_blocks)
                        if shards[i] is None)
        if not missing:
            return _chain(
                self.verify_digests_async(shards, digests, chunk_size, algo),
                lambda corrupt: (list(shards), corrupt))
        fut = self.rebuild_targets_verified_async(shards, digests, missing,
                                                  chunk_size, algo)

        def finish(res):
            rebuilt, corrupt = res
            out = list(shards)
            for t, arr in zip(missing, rebuilt):
                out[t] = arr
            return out, corrupt
        return _chain(fut, finish)

    def decode_data_blocks(self, shards: list) -> list:
        """Reconstruct missing *data* shards only (reference
        DecodeDataBlocks). Input: length k+m list, None for missing."""
        aligned, true_len = self._aligned(shards)
        out = self.codec.reconstruct(aligned, data_only=True)
        return self._unaligned(out, true_len)

    @staticmethod
    def _aligned(shards):
        """Pad present shards to 4-byte alignment for the packed kernels;
        returns (padded_shards, true_len)."""
        lens = {s.shape[-1] for s in shards if s is not None}
        if not lens:
            raise ValueError("no shards present")
        if len(lens) != 1:
            raise ValueError(f"inconsistent shard sizes {sorted(lens)}")
        (true_len,) = lens
        pad = (-true_len) % 4
        if pad == 0:
            return list(shards), true_len
        return [None if s is None else
                np.concatenate([np.asarray(s, np.uint8),
                                np.zeros(pad, np.uint8)]) for s in shards], \
            true_len

    @staticmethod
    def _unaligned(shards, true_len):
        return [None if s is None else s[:true_len] for s in shards]
