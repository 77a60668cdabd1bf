// HighwayHash-256 bitrot digests for Hopper: the device hash of the
// HighwayHash256S algorithm, the default of the erasure path.
//
// Replaces minio_tpu/ops/hh_jax.py (_hash256_core / hash256_device_words).
// That is plain jnp, not a Pallas kernel, but it is the device hash of the
// default main path, fused by ops/fused.py into the encode, verify and
// rebuild launches. The TPU has no 64-bit integers, so hh_jax.py carries
// every lane as a (lo, hi) uint32 pair, multiplies in 16-bit limbs and
// builds the zipper merge from masked shifts across the halves. Hopper has
// native 64-bit lanes: K5 highwayhash256_chunks keeps the state words in
// registers, multiplies with one 32x32->64 multiply (IMAD.WIDE.U32), and
// does each half of a zipper merge as byte permutes (__byte_perm, 3 per
// 64-bit addend).
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
// No wgmma: the work is chains of 64-bit integer adds, multiplies and
// permutes, not products of matrices.
//
// The design. A chunk's 32-byte packets form one chain (the digest format
// is fixed on disk), but the chain has two independent halves: the packet
// update is lane-local except the zipper merges, which pair lanes {0, 1}
// and lanes {2, 3} and never cross the pairs. So two neighbouring threads
// hash a chunk: thread 2c owns lanes 0 and 1 (bytes 0-15 of each packet),
// thread 2c+1 lanes 2 and 3 (bytes 16-31), each with its 8 state words in
// registers and no communication in the packet loop. Only the 10 finalize
// rounds' permute crosses the pairs: each round swaps v0 with the partner,
// four __shfl_xor_sync. Each thread then reduces its half and writes 16
// bytes of the digest. The remainder packet (nbytes % 32, a multiple of 4)
// stays lane-local: each thread reads the remainder words it needs from
// device memory, the last word moved to bytes 28-31 when the remainder
// holds 16 bytes or more.
//
// The packets reach the threads through the shared-memory ring of
// csrc/chunk_ring.cuh (bulk copies on mbarriers, a producer warp), so the
// chain never waits on a load of its own; the launch plan spreads the
// chunks over every SM, two CTAs on each. How the ring was sized: Little's
// law at 3.35 TB/s / 132 SMs and ~1 us of loaded latency asks for ~25 KB
// in flight per SM; at 10,240 chunks of 16 KiB each CTA holds 39 chunks in
// 2 stages of 1 KiB tiles (82 KB of shared memory): 80 KB in flight per SM
// while the other stage is hashed. A sweep on the card (tiles of 512 B to
// 4 KiB, 2-8 stages, 1-3 CTAs per SM) put two CTAs per SM ahead of one by
// ~1.4x at that shape, and large tiles ahead at small chunk counts, where
// a chunk's whole 16 KiB can be in flight. Rows that bulk copies cannot
// take (nbytes % 16 != 0, an unaligned view) run the direct-load case of
// the same kernel: the same two threads per chunk, each loading its packet
// words from device memory.
#include "chunk_ring.cuh"

namespace {

// The two lanes of a thread's pair, lane 2h + i in slot i.
struct Half {
  uint64_t v0[2], v1[2], mul0[2], mul1[2];
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

// The reference's Update for the pair's two lanes of a packet.
__device__ __forceinline__ void update(Half& s, uint64_t lane0,
                                       uint64_t lane1) {
  const uint64_t lanes[2] = {lane0, lane1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.v1[i] += s.mul0[i] + lanes[i];
    s.mul0[i] ^= mul32(s.v1[i], s.v0[i]);
    s.v0[i] += s.mul1[i];
    s.mul1[i] ^= mul32(s.v0[i], s.v1[i]);
  }
  zipper_add(s.v1[1], s.v1[0], s.v0[1], s.v0[0]);
  zipper_add(s.v0[1], s.v0[0], s.v1[1], s.v1[0]);
}

__device__ __forceinline__ void update(Half& s, uint4 w) {
  update(s, make64(w.x, w.y), make64(w.z, w.w));
}

__device__ __forceinline__ void modular_reduction(uint64_t a3_unmasked,
                                                  uint64_t a2, uint64_t a1,
                                                  uint64_t a0, uint64_t& m1,
                                                  uint64_t& m0) {
  const uint64_t a3 = a3_unmasked & 0x3fffffffffffffffull;
  m1 = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
  m0 = a0 ^ (a2 << 1) ^ (a2 << 2);
}

// The thread's 16 bytes of packet q of a chunk read straight from device
// memory, as 4-byte words (rows the ring cannot take need not be 16-byte
// aligned).
__device__ __forceinline__ uint4 direct_packet(const uint32_t* p, int q,
                                               int half) {
  const uint32_t* w = p + q * 8 + half * 4;
  return make_uint4(__ldg(w), __ldg(w + 1), __ldg(w + 2), __ldg(w + 3));
}

// kBulk: the chunk rows come through the shared-memory ring (nbytes % 16
// == 0 and 16-byte aligned data); else each thread loads its words from
// device memory.
template <bool kBulk>
__global__ void __launch_bounds__(ring::kMaxThreads, 2)
    hh256_kernel(const uint32_t* __restrict__ data, uint32_t* __restrict__ out,
                 long long n, int nbytes, int per_cta, int stages, int tile,
                 int pitch, uint64_t k0, uint64_t k1, uint64_t k2,
                 uint64_t k3) {
  extern __shared__ __align__(128) char smem[];
  long long first;
  int count;
  ring::cta_chunks(n, first, count);
  const char* rows = reinterpret_cast<const char*>(data) + first * nbytes;
  const int consumers = ring::consumer_threads(per_cta);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  char* rng = smem + ring::kHeader;
  if (kBulk) {
    ring::setup(full, empty, stages, consumers / 32);
    if ((int)threadIdx.x >= consumers) {
      ring::produce(rows, count, nbytes, per_cta, stages, tile, pitch, rng,
                    full, empty);
      return;
    }
  }
  // every thread of a hashing warp runs the whole chain (the finalize
  // shuffles need the full warp); one past the CTA's chunks hashes chunk 0
  // again and writes nothing
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const bool live = r < count;
  const int rr = live ? r : 0;
  const uint32_t* p = reinterpret_cast<const uint32_t*>(rows) +
                      (size_t)rr * (nbytes / 4);
  const uint64_t key[2] = {half ? k2 : k0, half ? k3 : k1};
  const uint64_t init0[2] = {
      half ? 0x13198a2e03707344ull : 0xdbe6d5d5fe4cce2full,
      half ? 0x243f6a8885a308d3ull : 0xa4093822299f31d0ull};
  const uint64_t init1[2] = {
      half ? 0xbe5466cf34e90c6cull : 0x3bd39e10cb0ef593ull,
      half ? 0x452821e638d01377ull : 0xc0acf169b5f18a8cull};
  Half s;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.mul0[i] = init0[i];
    s.mul1[i] = init1[i];
    s.v0[i] = init0[i] ^ key[i];
    s.v1[i] = init1[i] ^ swap32(key[i]);
  }
  const int packets = nbytes / 32;
  if (kBulk) {
    const int nt = ring::tiles(nbytes, tile);
    for (int t = 0; t < nt; ++t) {
      const int st = ring::acquire(full, t, stages);
      const char* src = ring::row(rng, st, rr, per_cta, pitch) + half * 16;
      const int q1 = min(tile, nbytes - t * tile) / 32;
#pragma unroll 4
      for (int q = 0; q < q1; ++q)
        update(s, *reinterpret_cast<const uint4*>(src + q * 32));
      ring::release(empty, st);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < packets; ++q)
      update(s, direct_packet(p, q, half));
  }
  const int rem = nbytes & 31;
  if (rem) {
    // the reference's UpdateRemainder for a remainder of whole words
    const uint64_t add = ((uint64_t)rem << 32) + (uint64_t)rem;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s.v0[i] += add;
      const uint32_t lo = (uint32_t)s.v1[i], hi = (uint32_t)(s.v1[i] >> 32);
      s.v1[i] = make64(__funnelshift_l(lo, lo, rem),
                       __funnelshift_l(hi, hi, rem));
    }
    const int nw = rem / 4;
    const uint32_t* tail = p + packets * 8;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = half * 4 + j;
      w[j] = k < nw ? __ldg(tail + k) : 0u;
    }
    // the remainder's last 4 bytes go to bytes 28-31
    if (half && (rem & 16)) w[3] = __ldg(tail + nw - 1);
    update(s, make_uint4(w[0], w[1], w[2], w[3]));
  }
#pragma unroll 1
  for (int rd = 0; rd < 10; ++rd) {
    // lane i takes the swapped v0 of lane i ^ 2, which the partner holds
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[2 * i] = __shfl_xor_sync(0xffffffffu, (uint32_t)s.v0[i], 1);
      o[2 * i + 1] =
          __shfl_xor_sync(0xffffffffu, (uint32_t)(s.v0[i] >> 32), 1);
    }
    update(s, make64(o[1], o[0]), make64(o[3], o[2]));
  }
  if (!live) return;
  uint64_t h0, h1;
  modular_reduction(s.v1[1] + s.mul1[1], s.v1[0] + s.mul1[0],
                    s.v0[1] + s.mul0[1], s.v0[0] + s.mul0[0], h1, h0);
  reinterpret_cast<uint4*>(out + (first + r) * 8)[half] =
      make_uint4((uint32_t)h0, (uint32_t)(h0 >> 32), (uint32_t)h1,
                 (uint32_t)(h1 >> 32));
}

}  // namespace

// K5: data u32 [n][nbytes/4] (nbytes % 4 == 0) -> out u32 [n][8] (16-byte
// aligned), digest words h0.lo, h0.hi, ..., h3.hi as the reference's
// 32-byte digest. grid, per_cta, stages, tile and pitch are the launch plan
// (ops/hh_cuda.py launch_plan); rows that bulk copies cannot take run the
// direct-load case, which reads only grid and per_cta.
extern "C" int hh256_chunks(const void* data, void* out, long long n,
                            int nbytes, int grid, int per_cta, int stages,
                            int tile, int pitch, unsigned long long k0,
                            unsigned long long k1, unsigned long long k2,
                            unsigned long long k3, void* stream) {
  if (nbytes % 4 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const bool bulk =
      nbytes % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
  if (!ring::plan_ok(n, nbytes, grid, per_cta, stages, tile, pitch, bulk))
    return (int)cudaErrorInvalidValue;
  // a tile holds whole packets unless it is the chunk's only one
  if (bulk && tile < nbytes && tile % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* d = static_cast<const uint32_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  const int threads = ring::consumer_threads(per_cta);
  if (bulk) {
    const size_t smem = ring::smem_bytes(per_cta, stages, pitch);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          hh256_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          ring::kSmemMax);
      if (e != cudaSuccess) return (int)e;
    }
    hh256_kernel<true><<<grid, threads + 32, smem, s>>>(
        d, o, n, nbytes, per_cta, stages, tile, pitch, k0, k1, k2, k3);
  } else {
    hh256_kernel<false><<<grid, threads, 0, s>>>(
        d, o, n, nbytes, per_cta, stages, tile, pitch, k0, k1, k2, k3);
  }
  return (int)cudaGetLastError();
}
