// MUR3X256 bitrot digests for Hopper: two seeded MurmurHash3_x86_128
// instances per chunk, digest words = instance 0 h1..h4, instance 1 h1..h4.
//
// Replaces the Pallas kernel of minio_tpu/ops/mur3_pallas.py
// (_make_kernel / _jitted, via hash256_device_words). There the chunks are
// lanes and the 16-byte packet chain is the sequential inner grid axis,
// with the 8 state words carried in VMEM scratch between grid steps. Blocks
// of a CUDA grid run in no order, so that axis becomes a loop inside the
// thread: K3 mur3x256_chunks runs one thread per chunk, which walks its
// nbytes/16 packets with 16-byte loads and keeps both instances' state in
// registers. Nothing carries between threads or blocks.
//
// What bounds it on this card: the bytes (each chunk read once: N * nbytes)
// over 3.35 TB/s, and the 44 integer ops per packet (12 for the
// seed-independent k-mix, shared by both instances, and 16 per instance)
// over the SMs' issue rate, 33.5 T/s, its 8 XORs also over the ALU pipe's
// 16.7 T/s. At the main path's 10,240 chunks of 16 KiB that is 168 MB,
// 50 us, against 461 M ops, 14 us: bytes bound. But a
// chunk is a sequential dependency chain, and
// 10,240 threads are only ~2.4 warps per SM, too few to hide the memory
// latency of neighbouring threads' loads 16 KiB apart (each warp load
// touches 32 separate sectors). The design keeps the loop unrolled so
// several packets' loads are in flight per thread and uses 64-thread blocks
// so the 160 blocks spread over all 132 SMs. Splitting the chain across
// threads needs a different hash and is out of scope: the digest format is
// fixed on disk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
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

__device__ __forceinline__ void update(State& s, uint32_t k1, uint32_t k2,
                                       uint32_t k3, uint32_t k4) {
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

__global__ void __launch_bounds__(kThreads)
    mur3x256_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
                    long long n, int packets, uint32_t seed1, uint32_t seed2,
                    uint32_t nbytes) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const uint4* p = data + c * packets;
  State a{seed1, seed1, seed1, seed1};
  State b{seed2, seed2, seed2, seed2};
#pragma unroll 8
  for (int q = 0; q < packets; ++q) {
    const uint4 w = __ldg(p + q);
    const uint32_t k1 = rotl(w.x * C1, 15) * C2;
    const uint32_t k2 = rotl(w.y * C2, 16) * C3;
    const uint32_t k3 = rotl(w.z * C3, 17) * C4;
    const uint32_t k4 = rotl(w.w * C4, 18) * C1;
    update(a, k1, k2, k3, k4);
    update(b, k1, k2, k3, k4);
  }
  out[2 * c] = finish(a, nbytes);
  out[2 * c + 1] = finish(b, nbytes);
}

}  // namespace

// K3: data u32 [n][nbytes/4] (16-byte aligned, nbytes % 16 == 0) ->
// out u32 [n][8].
extern "C" int mur3_chunks(const void* data, void* out, long long n,
                           int nbytes, unsigned seed1, unsigned seed2,
                           void* stream) {
  if (n <= 0 || nbytes <= 0 || nbytes % 16) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  mur3x256_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), static_cast<uint4*>(out), n,
      nbytes / 16, seed1, seed2, (uint32_t)nbytes);
  return (int)cudaGetLastError();
}
