// HighwayHash-256 bitrot digests for Hopper: the device hash of the
// HighwayHash256S algorithm, the default of the erasure path.
//
// Replaces minio_tpu/ops/hh_jax.py (_hash256_core / hash256_device_words).
// That is plain jnp, not a Pallas kernel, but it is the device hash of the
// default main path, fused by ops/fused.py into the encode, verify and
// rebuild launches. The TPU has no 64-bit integers, so hh_jax.py carries
// every lane as a (lo, hi) uint32 pair, multiplies in 16-bit limbs and
// builds the zipper merge from masked shifts across the halves. Hopper has
// native 64-bit lanes: K5 highwayhash256_chunks keeps the 16 uint64 state
// words in registers, multiplies with one 32x32->64 multiply
// (IMAD.WIDE.U32), and does each half of a zipper merge as byte
// permutes (__byte_perm, 3 per 64-bit addend).
//
// One thread per chunk: the 32-byte packet chain is sequential within a
// chunk, as in K3 (csrc/mur3x256.cu). The thread walks its nbytes/32
// packets, then the remainder (nbytes % 32, a multiple of 4 here) with the
// reference's padded remainder packet, then the 10 finalize rounds and the
// modular reduction, so a chunk of any 4-byte-multiple length, a bitrot
// file's short tail chunk included, needs no host hash.
//
// What bounds it on this card: the bytes (each chunk read once, 32 bytes
// of digest written) over 3.35 TB/s, against the int32 operations over
// the SMs' issue rate, 33.5 T/s (its XORs also over the ALU pipe's
// 16.7 T/s), counting a 64-bit add or XOR as 2, the wide multiply as 2
// and a byte permute as 1: 96 per packet (per lane 14: two adds into v1,
// two multiplies, two XORs, one add into v0; per zipper merge 6 permutes
// and two adds) and ~1,018 per chunk for the 10 finalize rounds, the key
// set-up and the modular reduction. At 10,240 chunks of 16 KiB that is
// 168 MB, 0.050 ms, against 514 M operations, 0.015 ms: bound by bytes.
// As for K3, 10,240 threads are ~2.4 warps per SM, too few to hide the
// load latency; the loop is unrolled so several packets' loads are in
// flight, with 64-thread blocks spread over all SMs. Splitting a chunk's
// 4 lanes over threads with shuffles is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

__constant__ uint64_t kInit0[4] = {
    0xdbe6d5d5fe4cce2full, 0xa4093822299f31d0ull, 0x13198a2e03707344ull,
    0x243f6a8885a308d3ull};
__constant__ uint64_t kInit1[4] = {
    0x3bd39e10cb0ef593ull, 0xc0acf169b5f18a8cull, 0xbe5466cf34e90c6cull,
    0x452821e638d01377ull};

struct State {
  uint64_t v0[4], v1[4], mul0[4], mul1[4];
};

__device__ __forceinline__ uint64_t make64(uint32_t lo, uint32_t hi) {
  return (uint64_t)lo | ((uint64_t)hi << 32);
}

__device__ __forceinline__ uint64_t swap32(uint64_t x) {
  return (x >> 32) | (x << 32);
}

// ZipperMergeAndAdd(v1, v0, add1, add0) of the reference: with a = v0 and
// b = v1 as bytes a0..a7, b0..b7 (a0 least significant),
// add0 += [a3 b4 a2 a5 b6 a1 b7 a0] and add1 += [b3 a4 b2 b5 b1 a6 b0 a7].
__device__ __forceinline__ void zipper_add(uint64_t v1, uint64_t v0,
                                           uint64_t& add1, uint64_t& add0) {
  const uint32_t aL = (uint32_t)v0, aH = (uint32_t)(v0 >> 32);
  const uint32_t bL = (uint32_t)v1, bH = (uint32_t)(v1 >> 32);
  add0 += make64(__byte_perm(__byte_perm(aL, aH, 0x5203), bH, 0x3240),
                 __byte_perm(aL, bH, 0x0716));
  add1 += make64(__byte_perm(__byte_perm(bL, bH, 0x5203), aH, 0x3240),
                 __byte_perm(bL, aH, 0x7061));
}

__device__ __forceinline__ uint64_t mul32(uint64_t lo_of, uint64_t hi_of) {
  return (uint64_t)(uint32_t)lo_of * (uint32_t)(hi_of >> 32);
}

__device__ __forceinline__ void update(State& s, const uint64_t lanes[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.v1[i] += s.mul0[i] + lanes[i];
    s.mul0[i] ^= mul32(s.v1[i], s.v0[i]);
    s.v0[i] += s.mul1[i];
    s.mul1[i] ^= mul32(s.v0[i], s.v1[i]);
  }
  zipper_add(s.v1[1], s.v1[0], s.v0[1], s.v0[0]);
  zipper_add(s.v1[3], s.v1[2], s.v0[3], s.v0[2]);
  zipper_add(s.v0[1], s.v0[0], s.v1[1], s.v1[0]);
  zipper_add(s.v0[3], s.v0[2], s.v1[3], s.v1[2]);
}

__device__ __forceinline__ void update_words(State& s, const uint32_t w[8]) {
  const uint64_t lanes[4] = {make64(w[0], w[1]), make64(w[2], w[3]),
                             make64(w[4], w[5]), make64(w[6], w[7])};
  update(s, lanes);
}

__device__ __forceinline__ void modular_reduction(uint64_t a3_unmasked,
                                                  uint64_t a2, uint64_t a1,
                                                  uint64_t a0, uint64_t& m1,
                                                  uint64_t& m0) {
  const uint64_t a3 = a3_unmasked & 0x3fffffffffffffffull;
  m1 = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
  m0 = a0 ^ (a2 << 1) ^ (a2 << 2);
}

// kVec: the chunk's packets are 16-byte aligned (base aligned and
// nbytes % 16 == 0), so each packet moves as two uint4 loads
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    hh256_kernel(const uint32_t* __restrict__ data, uint32_t* __restrict__ out,
                 long long n, int nbytes, uint64_t k0, uint64_t k1,
                 uint64_t k2, uint64_t k3) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int nwords = nbytes / 4;
  const uint32_t* p = data + c * nwords;
  const uint64_t key[4] = {k0, k1, k2, k3};
  State s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.mul0[i] = kInit0[i];
    s.mul1[i] = kInit1[i];
    s.v0[i] = kInit0[i] ^ key[i];
    s.v1[i] = kInit1[i] ^ swap32(key[i]);
  }
  const int packets = nbytes / 32;
#pragma unroll 4
  for (int q = 0; q < packets; ++q) {
    uint32_t w[8];
    if (kVec) {
      const uint4* src = reinterpret_cast<const uint4*>(p + q * 8);
      const uint4 a = __ldg(src), b = __ldg(src + 1);
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = __ldg(p + q * 8 + j);
    }
    update_words(s, w);
  }
  const int rem = nbytes & 31;
  if (rem) {
    // the reference's UpdateRemainder for a remainder of whole words
    const uint64_t add = ((uint64_t)rem << 32) + (uint64_t)rem;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s.v0[i] += add;
      const uint32_t lo = (uint32_t)s.v1[i], hi = (uint32_t)(s.v1[i] >> 32);
      s.v1[i] = make64(__funnelshift_l(lo, lo, rem),
                       __funnelshift_l(hi, hi, rem));
    }
    const int nw = rem / 4;
    const uint32_t* t = p + packets * 8;
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = j < nw ? __ldg(t + j) : 0u;
    if (rem & 16) w[7] = __ldg(t + nw - 1);  // last 4 bytes -> bytes 28-31
    update_words(s, w);
  }
#pragma unroll 1
  for (int r = 0; r < 10; ++r) {
    const uint64_t perm[4] = {swap32(s.v0[2]), swap32(s.v0[3]),
                              swap32(s.v0[0]), swap32(s.v0[1])};
    update(s, perm);
  }
  uint64_t h[4];
  modular_reduction(s.v1[1] + s.mul1[1], s.v1[0] + s.mul1[0],
                    s.v0[1] + s.mul0[1], s.v0[0] + s.mul0[0], h[1], h[0]);
  modular_reduction(s.v1[3] + s.mul1[3], s.v1[2] + s.mul1[2],
                    s.v0[3] + s.mul0[3], s.v0[2] + s.mul0[2], h[3], h[2]);
  uint4* o = reinterpret_cast<uint4*>(out + c * 8);
  o[0] = make_uint4((uint32_t)h[0], (uint32_t)(h[0] >> 32), (uint32_t)h[1],
                    (uint32_t)(h[1] >> 32));
  o[1] = make_uint4((uint32_t)h[2], (uint32_t)(h[2] >> 32), (uint32_t)h[3],
                    (uint32_t)(h[3] >> 32));
}

}  // namespace

// K5: data u32 [n][nbytes/4] (nbytes % 4 == 0) -> out u32 [n][8] (16-byte
// aligned), digest words h0.lo, h0.hi, ..., h3.hi as the reference's
// 32-byte digest.
extern "C" int hh256_chunks(const void* data, void* out, long long n,
                            int nbytes, unsigned long long k0,
                            unsigned long long k1, unsigned long long k2,
                            unsigned long long k3, void* stream) {
  if (n <= 0 || nbytes <= 0 || nbytes % 4) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const bool vec =
      nbytes % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* d = static_cast<const uint32_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (vec)
    hh256_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        d, o, n, nbytes, k0, k1, k2, k3);
  else
    hh256_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        d, o, n, nbytes, k0, k1, k2, k3);
  return (int)cudaGetLastError();
}
