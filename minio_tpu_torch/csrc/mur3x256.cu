// MUR3X256 bitrot digests for Hopper: two seeded MurmurHash3_x86_128
// instances per chunk, digest words = instance 0 h1..h4, instance 1 h1..h4.
//
// Replaces the Pallas kernel of minio_tpu/ops/mur3_pallas.py
// (_make_kernel / _jitted, via hash256_device_words). There the chunks are
// lanes and the 16-byte packet chain is the sequential inner grid axis,
// with the 8 state words carried in VMEM scratch between grid steps. Blocks
// of a CUDA grid run in no order, so that axis becomes a loop inside the
// thread. Nothing carries between blocks.
//
// What bounds it on this card: the bytes (each chunk read once: N * nbytes)
// over 3.35 TB/s, and the 44 integer ops per packet (12 for the
// seed-independent k-mix, shared by both instances, and 16 per instance)
// over the SMs' issue rate, 33.5 T/s, its 8 XORs also over the ALU pipe's
// 16.7 T/s. At the main path's 10,240 chunks of 16 KiB that is 168 MB,
// 50 us, against 461 M ops, 14 us: bytes bound. No wgmma: the work is
// 32-bit multiply-rotate chains, not products of matrices.
//
// The design. A chunk's packets form one chain per instance (the digest
// format is fixed on disk), but the two seeded instances are independent
// and share only the k-mix. So K3 mur3x256_chunks runs two neighbouring
// threads per chunk: thread 2c runs instance 0, thread 2c+1 instance 1.
// Both read the same 16-byte packet (a shared-memory broadcast) and both
// compute its k-mix: 28 ops per packet per thread instead of 44 in one.
// Thread 2c writes out[2c], thread 2c+1 out[2c+1]. The packets come through
// the shared-memory ring of csrc/chunk_ring.cuh (bulk copies on mbarriers,
// a producer warp) with K5's launch plan (csrc/highwayhash.cu): at 10,240
// chunks of 16 KiB, two CTAs per SM of 39 chunks each, 2 stages of 1 KiB
// tiles, 80 KB in flight per SM. The wrapper takes only 16-byte-multiple
// chunks of 16-byte-aligned data, which bulk copies always take.
#include "chunk_ring.cuh"

namespace {

constexpr uint32_t C1 = 0x239B961Bu, C2 = 0xAB0E9789u, C3 = 0x38B34AE5u,
                   C4 = 0xA1E38B93u;
constexpr uint32_t A1 = 0x561CCD1Bu, A2 = 0x0BCAA747u, A3 = 0x96CD1C35u,
                   A4 = 0x32AC3B17u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

struct State {
  uint32_t h1, h2, h3, h4;
};

__device__ __forceinline__ void update(State& s, uint4 w) {
  const uint32_t k1 = rotl(w.x * C1, 15) * C2;
  const uint32_t k2 = rotl(w.y * C2, 16) * C3;
  const uint32_t k3 = rotl(w.z * C3, 17) * C4;
  const uint32_t k4 = rotl(w.w * C4, 18) * C1;
  s.h1 ^= k1;
  s.h1 = (rotl(s.h1, 19) + s.h2) * 5u + A1;
  s.h2 ^= k2;
  s.h2 = (rotl(s.h2, 17) + s.h3) * 5u + A2;
  s.h3 ^= k3;
  s.h3 = (rotl(s.h3, 15) + s.h4) * 5u + A3;
  s.h4 ^= k4;
  s.h4 = (rotl(s.h4, 13) + s.h1) * 5u + A4;
}

__device__ __forceinline__ uint4 finish(State s, uint32_t len) {
  s.h1 ^= len; s.h2 ^= len; s.h3 ^= len; s.h4 ^= len;
  s.h1 += s.h2 + s.h3 + s.h4;
  s.h2 += s.h1; s.h3 += s.h1; s.h4 += s.h1;
  s.h1 = fmix(s.h1); s.h2 = fmix(s.h2); s.h3 = fmix(s.h3); s.h4 = fmix(s.h4);
  s.h1 += s.h2 + s.h3 + s.h4;
  s.h2 += s.h1; s.h3 += s.h1; s.h4 += s.h1;
  return make_uint4(s.h1, s.h2, s.h3, s.h4);
}

__global__ void __launch_bounds__(ring::kMaxThreads, 2)
    mur3x256_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
                    long long n, int nbytes, int per_cta, int stages,
                    int tile, int pitch, uint32_t seed1, uint32_t seed2) {
  extern __shared__ __align__(128) char smem[];
  long long first;
  int count;
  ring::cta_chunks(n, first, count);
  const int consumers = ring::consumer_threads(per_cta);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  char* rng = smem + ring::kHeader;
  ring::setup(full, empty, stages, consumers / 32);
  if ((int)threadIdx.x >= consumers) {
    ring::produce(reinterpret_cast<const char*>(data) + first * nbytes,
                  count, nbytes, per_cta, stages, tile, pitch, rng, full,
                  empty);
    return;
  }
  // every thread of a hashing warp takes part in the ring's releases; one
  // past the CTA's chunks reads chunk 0's rows and writes nothing
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const bool live = r < count;
  const int rr = live ? r : 0;
  const uint32_t seed = half ? seed2 : seed1;
  State s{seed, seed, seed, seed};
  const int nt = ring::tiles(nbytes, tile);
  for (int t = 0; t < nt; ++t) {
    const int st = ring::acquire(full, t, stages);
    const uint4* src = reinterpret_cast<const uint4*>(
        ring::row(rng, st, rr, per_cta, pitch));
    const int q1 = min(tile, nbytes - t * tile) / 16;
#pragma unroll 8
    for (int q = 0; q < q1; ++q) update(s, src[q]);
    ring::release(empty, st);
  }
  if (live) out[2 * (first + r) + half] = finish(s, (uint32_t)nbytes);
}

}  // namespace

// K3: data u32 [n][nbytes/4] (16-byte aligned, nbytes % 16 == 0) ->
// out u32 [n][8]. grid, per_cta, stages, tile and pitch are the launch plan
// (ops/hh_cuda.py launch_plan).
extern "C" int mur3_chunks(const void* data, void* out, long long n,
                           int nbytes, int grid, int per_cta, int stages,
                           int tile, int pitch, unsigned seed1,
                           unsigned seed2, void* stream) {
  if (nbytes % 16 || reinterpret_cast<uintptr_t>(data) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      !ring::plan_ok(n, nbytes, grid, per_cta, stages, tile, pitch, true))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ring::smem_bytes(per_cta, stages, pitch);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mur3x256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ring::kSmemMax);
    if (e != cudaSuccess) return (int)e;
  }
  mur3x256_kernel<<<grid, ring::consumer_threads(per_cta) + 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), static_cast<uint4*>(out), n, nbytes,
      per_cta, stages, tile, pitch, seed1, seed2);
  return (int)cudaGetLastError();
}
