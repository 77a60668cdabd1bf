// The shared-memory ring that feeds the two bitrot-hash kernels, K3
// (csrc/mur3x256.cu) and K5 (csrc/highwayhash.cu).
//
// A CTA owns a run of whole chunks, `count` of them, at most `per_cta`.
// Its last warp is the producer: it keeps `stages` tiles in flight, each
// tile `tile` bytes of every chunk row of the CTA, copied from device
// memory into shared memory by 1-D bulk copies (cp.async.bulk, the TMA's
// non-tensor form; one copy per row, issued by the producer's 32 lanes in
// turn), which complete on that stage's `full` mbarrier. The other warps
// hash, two threads per chunk, and release a stage on its `empty` mbarrier
// (one arrival per warp). Rows sit `pitch` bytes apart, with pitch % 128 ==
// 32: the 16-byte reads of the 4 chunks a quarter warp touches then fall
// on distinct banks.
//
// The launch plan (ops/hh_cuda.py launch_plan) picks per_cta, stages and
// tile, and spreads the n chunks over `grid` CTAs, two per SM, as evenly
// as the grid allows (cta_chunks below), so that any n reaches every SM: a
// 256-chunk flush runs on 256 CTAs, not on 4.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

// the barrier header in front of the ring (full[stages], empty[stages])
constexpr int kHeader = 128;
constexpr int kMaxStages = 8;
// 2 threads per chunk, at most 256 chunks per CTA, plus the producer
// warp; the kernels ask for two such CTAs per SM (__launch_bounds__)
constexpr int kMaxThreads = 2 * 256 + 32;
constexpr int kSmemMax = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that lasts
// ~2 s (2^32 cycles) can only be a broken protocol: it traps, so that the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) start = now;
    if (now - start > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// This CTA's chunks [first, first + count): n split over the grid as
// evenly as it goes (count is n / grid or one more, never 0 as grid <= n).
__device__ __forceinline__ void cta_chunks(long long n, long long& first,
                                           int& count) {
  first = (long long)blockIdx.x * n / gridDim.x;
  count = (int)((long long)(blockIdx.x + 1) * n / gridDim.x - first);
}

__device__ __forceinline__ int tiles(int nbytes, int tile) {
  return (nbytes + tile - 1) / tile;
}

// The row of chunk r of stage s.
__device__ __forceinline__ char* row(char* ring, int s, int r, int per_cta,
                                     int pitch) {
  return ring + ((size_t)s * per_cta + r) * pitch;
}

// Sets up the barriers (thread 0), before every thread's first use.
__device__ __forceinline__ void setup(uint64_t* full, uint64_t* empty,
                                      int stages, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      init(&full[s], 1);
      init(&empty[s], consumer_warps);
    }
    fence_init();
  }
  __syncthreads();
}

// The producer warp: tile t of every row into stage t % stages, once the
// hashing warps released that stage's previous tile. `rows` is the CTA's
// first chunk; rows are nbytes apart (nbytes % 16 == 0, 16-byte aligned).
__device__ __forceinline__ void produce(const char* rows, int count,
                                        int nbytes, int per_cta, int stages,
                                        int tile, int pitch, char* ring,
                                        uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  const int nt = tiles(nbytes, tile);
  for (int t = 0; t < nt; ++t) {
    const int s = t % stages;
    const int tb = min(tile, nbytes - t * tile);
    if (lane == 0) {
      // a fresh barrier counts its phase "before 0" as complete, so the
      // first round's waits (parity 1) pass at once
      wait(&empty[s], ((t / stages) & 1) ^ 1);
      expect_tx(&full[s], (uint32_t)count * (uint32_t)tb);
    }
    __syncwarp();
    for (int r = lane; r < count; r += 32)
      bulk_copy(row(ring, s, r, per_cta, pitch),
                rows + (size_t)r * nbytes + (size_t)t * tile, (uint32_t)tb,
                &full[s]);
  }
}

// A hashing warp: waits for tile t's stage and returns its index (the
// parity of round t / stages).
__device__ __forceinline__ int acquire(uint64_t* full, int t, int stages) {
  const int s = t % stages;
  wait(&full[s], (t / stages) & 1);
  return s;
}

// A hashing warp is done with stage s: one arrival for the warp.
__device__ __forceinline__ void release(uint64_t* empty, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) arrive(&empty[s]);
}

// The launch geometry: hashing threads (whole warps, two per chunk) and
// the dynamic shared memory of a ring.
__host__ __device__ inline int consumer_threads(int per_cta) {
  return (2 * per_cta + 31) / 32 * 32;
}

inline size_t smem_bytes(int per_cta, int stages, int pitch) {
  return kHeader + (size_t)stages * per_cta * pitch;
}

// Whether a plan holds n chunks of nbytes: the grid covers them with at
// most per_cta each, and (for the ring) the tiles and rows fit.
inline bool plan_ok(long long n, int nbytes, int grid, int per_cta,
                    int stages, int tile, int pitch, bool bulk) {
  if (n <= 0 || nbytes <= 0 || grid <= 0 || grid > n || per_cta <= 0 ||
      per_cta > (kMaxThreads - 32) / 2)
    return false;
  if ((n + grid - 1) / grid > per_cta) return false;
  if (!bulk) return true;
  if (stages <= 0 || stages > kMaxStages || tile <= 0 || tile % 16 ||
      pitch < tile || pitch % 16)
    return false;
  return smem_bytes(per_cta, stages, pitch) <= (size_t)kSmemMax;
}

}  // namespace ring
