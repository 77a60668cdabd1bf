"""Bit-sliced GF(256) Reed-Solomon in PyTorch — the port of ops/rs_jax.py.

Shard bytes are packed 4 per 32-bit word. Multiplying every byte of a packed
word by the field generator (x2 in GF(256)/0x11D) is a SWAR shift/xor with
cross-byte carry masking; a multiply by an arbitrary coefficient is the XOR
of the x2 chain selected by its bits, and with the coefficient bits expanded
to full-word masks (gf256.coeff_masks) a shard-matrix product is 8 rounds of
AND/XOR on words.

Words travel as ``torch.int32`` tensors holding the uint32 bit patterns:
PyTorch's uint32 has no shifts, adds or multiplies, and int32 ``>>`` is
arithmetic (``0x80808080 >> 7`` gives ``0xff010101``). The plain versions
here therefore compute in int64 on values kept below 2**32, and the int32
form of ``gf2x_packed`` masks its right shift.

``ReedSolomon`` keeps the JAX codec's surface. On a CUDA device its products
run the hand-written kernels of ops/rs_cuda.py; on the CPU the same wrappers
take the plain versions below.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import gf256, rs_cuda
from ..utils.device import resolve_device

_HI = 0x80808080
_LO7 = 0xFEFEFEFE
_LSB = 0x01010101
_RED = 0x1D  # 0x11D mod x^8
_M32 = 0xFFFFFFFF


def _s32(v: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


def to_u32_i64(t: torch.Tensor) -> torch.Tensor:
    """int32 (or uint32) words -> int64 holding the unsigned value."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.to(torch.int64) & _M32


def to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding values in [0, 2**32) -> int32 with the same bits."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def gf2x_packed(x: torch.Tensor) -> torch.Tensor:
    """Multiply every byte of 32-bit packed words by 2 in GF(256).

    int64 inputs hold unsigned words; int32 inputs hold their bits, and the
    arithmetic right shift is masked back to one bit per byte."""
    if x.dtype == torch.int32:
        hi = x & _s32(_HI)
        lo = (x << 1) & _s32(_LO7)
        return lo ^ (((hi >> 7) & _LSB) * _RED)
    hi = x & _HI
    lo = (x << 1) & _LO7
    return lo ^ ((hi >> 7) * _RED)


def gf_matmul_packed(masks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """GF(256) matrix product on packed shards: masks [..., 8, o, i] x
    words [..., i, W] -> int32 [..., o, W] (leading dims broadcast).

    Horner over the bit planes, as the TPU kernel evaluates it:
    acc = x2(acc) ^ XOR_j (masks[b, :, j] & x[j]) for b = 7..0."""
    m = to_u32_i64(masks)
    p = to_u32_i64(x)
    o, i = m.shape[-2], m.shape[-1]
    if p.shape[-2] != i:
        raise ValueError(f"masks take {i} inputs, words have {p.shape[-2]}")
    lead = torch.broadcast_shapes(m.shape[:-3], p.shape[:-2])
    acc = torch.zeros(lead + (o, p.shape[-1]), dtype=torch.int64,
                      device=p.device)
    for b in range(7, -1, -1):
        if b != 7:
            acc = gf2x_packed(acc)
        mb = m[..., b, :, :]
        for j in range(i):
            acc ^= mb[..., :, j:j + 1] & p[..., j:j + 1, :]
    return to_i32(acc)


def pack_shards(shards: np.ndarray) -> np.ndarray:
    """uint8 [..., S] -> uint32 [..., S//4] (S must be a multiple of 4)."""
    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    if shards.shape[-1] % 4:
        raise ValueError(f"shard size {shards.shape[-1]} not a multiple of 4")
    return shards.view(np.uint32)


def unpack_shards(words: np.ndarray) -> np.ndarray:
    """uint32 [..., W] -> uint8 [..., 4W] (always writable: heal/repair
    callers patch shard bytes)."""
    out = np.ascontiguousarray(words)
    if not out.flags.writeable:
        out = out.copy()
    return out.view(np.uint8)


def words_to_device(words: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bits on ``device``."""
    w = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(w).to(device)


def words_to_host(t: torch.Tensor) -> np.ndarray:
    """int32 (or uint32) word tensor -> uint32 numpy array."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.cpu().numpy().view(np.uint32)


class ReedSolomon:
    """Systematic RS(k, m) codec with the reference Encoder's surface
    (Encode / ReconstructData / Reconstruct / Verify / Split). Shard arrays
    are uint8 [S] with S % 4 == 0. ``matrix`` takes an explicit uint8
    (k+m, k) systematic encode matrix (e.g. one read back from another
    codec); by default it is built from ``matrix_kind``."""

    def __init__(self, k: int, m: int, matrix_kind: str = "vandermonde",
                 device=None, matrix: np.ndarray | None = None):
        if m < 1:
            raise ValueError(f"parity shard count must be >= 1, got {m}")
        self.k = k
        self.m = m
        self.n = k + m
        self.device = resolve_device(device)
        if matrix is None:
            matrix = gf256.build_matrix(k, m, matrix_kind)
        matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        if matrix.shape != (self.n, k) or not np.array_equal(
                matrix[:k], np.eye(k, dtype=np.uint8)):
            raise ValueError("encode matrix must be systematic (k+m, k)")
        self.matrix = matrix
        self.parity_rows = np.ascontiguousarray(matrix[k:])
        if self.device.type == "cuda":
            # K2's library for this matrix: built now, never in a flush
            rs_cuda.prepare_encode(self.parity_rows)
        self._decode_cache: dict[tuple[int, ...], np.ndarray] = {}
        self._mask_cache: dict[tuple, torch.Tensor] = {}
        self._np_mask_cache: dict[tuple, np.ndarray] = {}

    # -- encode --------------------------------------------------------------

    def encode_words(self, w: torch.Tensor) -> torch.Tensor:
        """Device-level encode: int32 words [k, W] -> [m, W]."""
        return self.encode_words_batch(w[None])[0]

    def encode_words_batch(self, w: torch.Tensor) -> torch.Tensor:
        """Batched device-level encode: int32 [B, k, W] -> [B, m, W] (the
        fixed-matrix kernel)."""
        return rs_cuda.gf_encode_batched(self.parity_rows, w)

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data uint8 [k, S] -> parity uint8 [m, S]."""
        w = words_to_device(pack_shards(data), self.device)
        return unpack_shards(words_to_host(self.encode_words(w)))

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """data uint8 [B, k, S] -> parity uint8 [B, m, S] in one launch."""
        w = words_to_device(pack_shards(data), self.device)
        return unpack_shards(words_to_host(self.encode_words_batch(w)))

    # -- reconstruct ---------------------------------------------------------

    def _mm(self, masks: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """[8, o, i] masks x [i, W] words through the per-element kernel."""
        return rs_cuda.gf_matmul_batched(masks[None], w[None])[0]

    def _decode_mat(self, present: tuple[int, ...]) -> np.ndarray:
        mat = self._decode_cache.get(present)
        if mat is None:
            mat = gf256.decode_matrix(self.matrix, self.k, present)
            self._decode_cache[present] = mat
        return mat

    def _cached_masks(self, key: tuple, build) -> torch.Tensor:
        """Device-resident coefficient masks cached per loss pattern."""
        masks = self._mask_cache.get(key)
        if masks is None:
            masks = words_to_device(gf256.coeff_masks(build()), self.device)
            self._mask_cache[key] = masks
        return masks

    def rebuild_rows(self, present: tuple[int, ...],
                     targets: tuple[int, ...]) -> np.ndarray:
        """[len(targets), k] matrix mapping the k chosen present shards to
        any target shards (data or parity): data rows come from the decode
        matrix, parity rows from parity_matrix @ decode_matrix."""
        dec = self._decode_mat(present)
        rows = np.empty((len(targets), self.k), dtype=np.uint8)
        for i, t in enumerate(targets):
            if t < self.k:
                rows[i] = dec[t]
            else:
                rows[i] = gf256.gf_matmul_ref(
                    self.parity_rows[t - self.k: t - self.k + 1], dec)[0]
        return rows

    def target_masks_np(self, present: tuple[int, ...],
                        targets: tuple[int, ...]) -> np.ndarray:
        """Host-side uint32 [8, o, k] masks (o = len(targets)) for
        rebuilding ``targets`` from ``present``; cached per pattern."""
        if len(targets) > self.m:
            raise ValueError(
                f"{len(targets)} targets > parity {self.m}: unrecoverable")
        key = ("np-tgt", present, targets)
        masks = self._np_mask_cache.get(key)
        if masks is None:
            masks = gf256.coeff_masks(self.rebuild_rows(present, targets))
            self._np_mask_cache[key] = masks
        return masks

    def _choose_present(self, shards: list) -> tuple[int, ...]:
        present = tuple(i for i, s in enumerate(shards) if s is not None)
        if len(present) < self.k:
            raise ValueError(
                f"cannot reconstruct: {len(present)} shards present, "
                f"need {self.k}")
        return present[: self.k]

    def reconstruct(self, shards: list, data_only: bool = False) -> list:
        """Fill in missing entries of a length-(k+m) shard list (returns a
        new list). ``data_only`` mirrors the reference's ReconstructData:
        parity gaps stay None."""
        shards = list(shards)
        if len(shards) != self.n:
            raise ValueError(f"expected {self.n} shards, got {len(shards)}")
        missing_data = [i for i in range(self.k) if shards[i] is None]
        missing_parity = [i for i in range(self.k, self.n)
                          if shards[i] is None]
        if not missing_data and (data_only or not missing_parity):
            return shards

        if missing_data:
            chosen = self._choose_present(shards)
            w = words_to_device(
                pack_shards(np.stack([shards[i] for i in chosen])),
                self.device)
            masks = self._cached_masks(
                (chosen, tuple(missing_data)),
                lambda: self._decode_mat(chosen)[missing_data, :])
            out = unpack_shards(words_to_host(self._mm(masks, w)))
            for row, i in enumerate(missing_data):
                shards[i] = out[row]

        if missing_parity and not data_only:
            data = np.stack(shards[: self.k])
            masks = self._cached_masks(
                ("parity", tuple(missing_parity)),
                lambda: self.parity_rows[
                    [i - self.k for i in missing_parity], :])
            out = unpack_shards(words_to_host(self._mm(
                masks, words_to_device(pack_shards(data), self.device))))
            for row, i in enumerate(missing_parity):
                shards[i] = out[row]
        return shards

    def reconstruct_batch(self, shards: np.ndarray, present: np.ndarray
                          ) -> np.ndarray:
        """Batched heal: reconstruct ALL n shards for B objects in one
        launch. shards uint8 [B, k+m, S] with garbage in missing slots;
        present bool [B, k+m]. Per element, an (n, k) rebuild matrix maps
        its first k present shards to all n shards (o = n rows)."""
        B = shards.shape[0]
        gathered = np.empty((B, self.k) + shards.shape[2:], dtype=np.uint8)
        masks = np.empty((B, 8, self.n, self.k), dtype=np.uint32)
        for b in range(B):
            idx = tuple(int(i) for i in np.nonzero(present[b])[0][: self.k])
            if len(idx) < self.k:
                raise ValueError(f"batch element {b}: insufficient shards")
            gathered[b] = shards[b, list(idx)]
            dec = self._decode_mat(idx)
            full = np.zeros((self.n, self.k), dtype=np.uint8)
            full[: self.k] = dec
            full[self.k:] = gf256.gf_matmul_ref(self.parity_rows, dec)
            masks[b] = gf256.coeff_masks(full)
        out = rs_cuda.gf_matmul_batched(
            words_to_device(masks, self.device),
            words_to_device(pack_shards(gathered), self.device))
        return unpack_shards(words_to_host(out))

    # -- verify --------------------------------------------------------------

    def verify(self, shards: np.ndarray) -> bool:
        """shards uint8 [k+m, S] -> True iff parity matches data."""
        shards = np.asarray(shards, dtype=np.uint8)
        w = words_to_device(pack_shards(shards[: self.k]), self.device)
        want = words_to_device(pack_shards(shards[self.k:]), self.device)
        return bool(torch.equal(self.encode_words(w), want))

    # -- split (reference Encoder.Split) -------------------------------------

    def split(self, data, shard_size: int | None = None) -> np.ndarray:
        """Zero-pad ``data`` to k*shard_size and reshape into [k, shard_size].

        shard_size defaults to ceil(len/k) rounded up to 4-byte alignment.
        """
        buf = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) \
            else np.asarray(data, np.uint8)
        if shard_size is None:
            shard_size = -(-len(buf) // self.k)
            shard_size += (-shard_size) % 4
        total = self.k * shard_size
        if len(buf) > total:
            raise ValueError("data longer than k * shard_size")
        out = np.zeros(total, dtype=np.uint8)
        out[: len(buf)] = buf
        return out.reshape(self.k, shard_size)


def get_codec(k: int, m: int, matrix_kind: str = "vandermonde",
              device=None) -> ReedSolomon:
    """Process-wide codec cache per (geometry, matrix kind, device)."""
    return _cached_codec(k, m, matrix_kind, str(resolve_device(device)))


@functools.lru_cache(maxsize=64)
def _cached_codec(k: int, m: int, matrix_kind: str, device: str
                  ) -> ReedSolomon:
    return ReedSolomon(k, m, matrix_kind, device)
