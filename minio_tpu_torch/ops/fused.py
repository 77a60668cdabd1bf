"""Device launches that combine the GF(256) shard math with the bitrot hash —
the port of ops/fused.py:

- **verify + rebuild** (``fused_fn_for``): digest every source shard's
  chunks AND rebuild the requested target shards; the host reads the
  validity mask and re-reads only when a digest mismatched.
- **encode + hash** (``encode_hashed_fn_for``): the m parity shards AND the
  per-chunk digests of all k+m shards, so a PUT never hashes payload bytes
  on the host.
- **verify** (``verify_fn_for``): the digest check alone, for healthy reads
  whose k data shards need no rebuild.

On the card each is a sequence of kernel launches on one stream (the GF
kernel and the hash kernel) plus a PyTorch equality reduction; one fused
kernel that hashes from the tile it encodes is later work. Hash ids follow
the JAX package's native ALGO_* ids: 0 = HighwayHash-256 (K5,
ops/hh_cuda.py), 1 = MUR3X256 (K3, ops/mur3_cuda.py).
"""
from __future__ import annotations

import torch

from . import hh_cuda, hh_torch, mur3_cuda
from .mur3_torch import seeds_from_key

#: the JAX package's native ALGO_* wire ids
ALGO_HIGHWAY = 0
ALGO_MUR3 = 1

#: (key -> kernel key words, hash kernel, chunk alignment in bytes) per id:
#: the MUR3 kernel walks 16-byte packets, the HighwayHash kernel takes any
#: 4-byte multiple (its 32-byte packets plus the remainder)
_HASHES = {
    ALGO_HIGHWAY: (hh_torch.key_words, hh_cuda.highwayhash256_chunks, 4),
    ALGO_MUR3: (seeds_from_key, mur3_cuda.mur3x256_chunks, 16),
}


def chunk_align(algo: int) -> int:
    """The byte multiple a chunk needs for the device hash ``algo``."""
    return _HASHES[algo][2]


def _hash_fn(algo: int, key: bytes):
    """The device hash of ``algo`` bound to ``key``: (nbytes, words
    [..., nbytes//4]) -> digests [..., 8]."""
    if algo not in _HASHES:
        raise NotImplementedError(f"no device hash for algorithm id {algo}")
    key_fn, kernel, _ = _HASHES[algo]
    kw = key_fn(key)
    return lambda nbytes, words: kernel(kw, nbytes, words)


def _chunks(words: torch.Tensor, chunk_nbytes: int) -> torch.Tensor:
    """[B, r, W] words -> [B, r, nc, chunk words] view."""
    B, r, W = words.shape
    nc = W * 4 // chunk_nbytes
    return words.reshape(B, r, nc, W // nc)


def _check_chunk(shard_nbytes: int, chunk_nbytes: int) -> None:
    if not chunk_nbytes or shard_nbytes % chunk_nbytes:
        raise ValueError("shard length is not a bitrot-chunk multiple")


def verify_fn_for(key: bytes, shard_nbytes: int, chunk_nbytes: int,
                  algo: int = 0):
    """(words [B, k, W], digests [B, k, nc*8]) -> valid bool [B, k]."""
    _check_chunk(shard_nbytes, chunk_nbytes)
    hash_fn = _hash_fn(algo, key)

    def verify(words, digests):
        B, k, _ = words.shape
        computed = hash_fn(chunk_nbytes, _chunks(words, chunk_nbytes))
        return torch.all(computed.reshape(B, k, -1) == digests, dim=-1)
    return verify


def fused_fn_for(key: bytes, shard_nbytes: int, backend_mm,
                 chunk_nbytes: int | None = None, algo: int = 0,
                 hash_out: bool = False):
    """Validated fused verify+rebuild for one (key, shard, chunk, algo):
    (masks [B, 8, o, k], words [B, k, W], digests [B, k, nc*8]) ->
    (rebuilt [B, o, W], valid bool [B, k]). ``backend_mm`` is the batched
    per-element GF product (rs_cuda.gf_matmul_batched). ``hash_out`` adds
    the rebuilt shards' own digests [B, o, nc*8] (a heal frames its output
    with them, as a PUT frames with encode_hashed's)."""
    if not chunk_nbytes:
        chunk_nbytes = shard_nbytes
    verify = verify_fn_for(key, shard_nbytes, chunk_nbytes, algo)
    hash_fn = _hash_fn(algo, key)

    def fused(masks, words, digests):
        valid = verify(words, digests)
        out = backend_mm(masks, words)
        if not hash_out:
            return out, valid
        digs = hash_fn(chunk_nbytes, _chunks(out, chunk_nbytes))
        return out, valid, digs.reshape(out.shape[0], out.shape[1], -1)
    return fused


def encode_hashed_fn_for(key: bytes, shard_nbytes: int, encode_mm,
                         chunk_nbytes: int, algo: int = 0):
    """Fused encode+hash: words [B, k, W] -> (parity [B, m, W], digests
    [B, k+m, nc*8]). ``encode_mm`` is the codec's batched fixed-matrix
    encode (ReedSolomon.encode_words_batch)."""
    _check_chunk(shard_nbytes, chunk_nbytes)
    hash_fn = _hash_fn(algo, key)

    def encode_hashed(words):
        B, k, _ = words.shape
        parity = encode_mm(words)
        # data and parity digested in place, no concatenated copy of the
        # payload: only the 32-byte digests are joined
        digs = [hash_fn(chunk_nbytes, _chunks(t, chunk_nbytes))
                .reshape(B, t.shape[1], -1) for t in (words, parity)]
        return parity, torch.cat(digs, dim=1)
    return encode_hashed
