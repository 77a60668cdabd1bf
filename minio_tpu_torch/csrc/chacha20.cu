// ChaCha20 keystream XOR for Hopper: the SSE package cipher's device lane.
//
// Replaces both Pallas kernels of minio_tpu/ops/chacha_pallas.py:
// _make_multi_kernel / multi_fn_for (many objects, each under its own key:
// the dispatch op sse_xor) and _make_kernel / _jitted (one object's
// packages: xor_packages_device), the latter as this kernel with one item.
//
// Package p of item i owns nb + 1 64-byte blocks, nb = words / 16: block 0
// is counter 0, whose first 8 keystream words are the package's Poly1305
// one-time key; block j >= 1 is counter j and XORs data block j - 1. Key
// and nonce come straight from the item and package index of the block,
// read from [I][8] and [I][P][3]: nothing is expanded per block on the
// host. (The TPU kernel repeats the key per lane only because its tiles
// are (8, 128) vregs, and it pads the lane count to a tile multiple.)
//
// The work per data block: 992 int32 operations (the rounds' 320 adds,
// 320 XORs and 320 rotates, a rotate being one funnel shift, then 16
// feed-forward adds and 16 XORs with the payload) against 128 bytes moved
// over 3.35 TB/s. Adds, shifts and rotates can issue on the ALU or the FMA
// pipe (IMAD forms); the 336 XORs only on the ALU pipe.
//
// Two layouts, picked per launch by ops/chacha_cuda.py launch_plan (the C
// entry takes the plan's values):
//
// one thread per block (the large launches: the sse_xor flush of 128
//   items x 16 packages x 64 KiB) — the 16-word state in registers through
//   the 10 double rounds, the feed-forward and the XOR; the payload moves
//   as four 16-byte loads and stores per thread when data and out are
//   16-byte aligned. At that shape ~2.08 G operations over the SMs' issue
//   rate (128 lanes/clk/SM, 33.5 T/s) take 0.062 ms and 0.71 G XORs over
//   the ALU pipe's 16.7 T/s 0.042 ms, against 268 MB, 0.080 ms: bound by
//   bytes, with 2.1 M threads to fill the card.
//
// four threads per block (the launches the paths make: I = 1 for most of
//   them, one object's packages) — at I = 1, P = 16, W = 16384 the one-
//   thread layout runs 16,400 threads, one CTA of 4 warps per SM, each
//   thread a chain of ~960 dependent operations with 4-way ILP, and loads
//   its payload only after it: the round trip follows the rounds. The
//   bytes take 0.63 us; launch, the key and payload round trips and the
//   rounds bound the shape. Here thread c of a block's aligned group of 4
//   lanes holds column c of the state (words c, 4+c, 8+c, 12+c): the
//   column rounds run in the thread, and the diagonal rounds rotate rows
//   1-3 by 1, 2 and 3 lanes with __shfl_sync inside the group, and back
//   (6 shuffles per double round). That is 4x the threads (16 warps per SM
//   at I = 1) and a chain a quarter as long per thread, and each thread
//   issues its payload loads (4 words, 16 bytes apart: a group covers the
//   block's 64 contiguous bytes) before the rounds, so the payload's round
//   trip overlaps them. Counter 0's group writes the Poly1305 key, 2 words
//   a thread. The cost: a block's instructions double (566 SASS
//   instructions a thread against 1,220 for one thread per block: the
//   shuffles, the per-lane selects, one QR chain per thread), and the
//   rounds' ALU work already spreads over every scheduler at I = 1. So the
//   layout wins only while one thread per block leaves schedulers idle
//   (I <= 3 here); the plan takes one thread per block above.
// chip_smoke.py prints the SASS both layouts build to, by pipe.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define QR(a, b, c, d)                \
  a += b; d = rotl(d ^ a, 16);        \
  c += d; b = rotl(b ^ c, 12);        \
  a += b; d = rotl(d ^ a, 8);         \
  c += d; b = rotl(b ^ c, 7);

// kVec: data and out are 16-byte aligned, so each block moves as 4 x uint4
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    chacha20_kernel(const uint32_t* __restrict__ keys,
                    const uint32_t* __restrict__ nonces,
                    const uint32_t* __restrict__ data,
                    uint32_t* __restrict__ out, uint32_t* __restrict__ poly,
                    long long lanes, int lanes_per_pkg, int pkgs, int words) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= lanes) return;
  const long long pkg = t / lanes_per_pkg;  // item * pkgs + package
  const uint32_t ctr = (uint32_t)(t - pkg * lanes_per_pkg);
  const uint32_t* k = keys + (pkg / pkgs) * 8;
  const uint32_t* n = nonces + pkg * 3;
  uint32_t s[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                    __ldg(k + 0), __ldg(k + 1), __ldg(k + 2), __ldg(k + 3),
                    __ldg(k + 4), __ldg(k + 5), __ldg(k + 6), __ldg(k + 7),
                    ctr, __ldg(n + 0), __ldg(n + 1), __ldg(n + 2)};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = s[i];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    QR(x[0], x[4], x[8], x[12]);
    QR(x[1], x[5], x[9], x[13]);
    QR(x[2], x[6], x[10], x[14]);
    QR(x[3], x[7], x[11], x[15]);
    QR(x[0], x[5], x[10], x[15]);
    QR(x[1], x[6], x[11], x[12]);
    QR(x[2], x[7], x[8], x[13]);
    QR(x[3], x[4], x[9], x[14]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] += s[i];
  if (ctr == 0) {
    uint32_t* pk = poly + pkg * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) pk[i] = x[i];
    return;
  }
  const long long off = pkg * words + (long long)(ctr - 1) * 16;
  if (kVec) {
    const uint4* src = reinterpret_cast<const uint4*>(data + off);
    uint4* dst = reinterpret_cast<uint4*>(out + off);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint4 w = __ldg(src + q);
      w.x ^= x[4 * q];
      w.y ^= x[4 * q + 1];
      w.z ^= x[4 * q + 2];
      w.w ^= x[4 * q + 3];
      dst[q] = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) out[off + i] = __ldg(data + off + i) ^ x[i];
  }
}

// Row k of the state across a block's 4 lanes: lane c gets lane (c + k) & 3's.
__device__ __forceinline__ uint32_t from_lane(uint32_t v, int c, int k) {
  return __shfl_sync(0xffffffffu, v, (c + k) & 3, 4);
}

// Four threads per 64-byte block (see the top of the file). Every thread of
// a warp reaches the shuffles: a group past the last block computes a copy
// of the last block and stores nothing.
__global__ void __launch_bounds__(kThreads)
    chacha20_quad_kernel(const uint32_t* __restrict__ keys,
                         const uint32_t* __restrict__ nonces,
                         const uint32_t* __restrict__ data,
                         uint32_t* __restrict__ out,
                         uint32_t* __restrict__ poly, long long lanes,
                         int lanes_per_pkg, int pkgs, int words) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int c = threadIdx.x & 3;
  const bool valid = (t >> 2) < lanes;
  const long long lane = valid ? t >> 2 : lanes - 1;
  const long long pkg = lane / lanes_per_pkg;  // item * pkgs + package
  const uint32_t ctr = (uint32_t)(lane - pkg * lanes_per_pkg);
  const bool xors = valid && ctr != 0;
  const long long off = pkg * words + (long long)(ctr - 1) * 16 + c;
  uint32_t d0 = 0u, d1 = 0u, d2 = 0u, d3 = 0u;
  if (xors) {
    d0 = __ldg(data + off);
    d1 = __ldg(data + off + 4);
    d2 = __ldg(data + off + 8);
    d3 = __ldg(data + off + 12);
  }
  const uint32_t* k = keys + (pkg / pkgs) * 8;
  const uint32_t s0 = c == 0 ? 0x61707865u : c == 1 ? 0x3320646Eu
                    : c == 2 ? 0x79622D32u : 0x6B206574u;
  const uint32_t s1 = __ldg(k + c);
  const uint32_t s2 = __ldg(k + 4 + c);
  const uint32_t s3 = c == 0 ? ctr : __ldg(nonces + pkg * 3 + c - 1);
  uint32_t a = s0, b = s1, cc = s2, d = s3;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    QR(a, b, cc, d);
    b = from_lane(b, c, 1);
    cc = from_lane(cc, c, 2);
    d = from_lane(d, c, 3);
    QR(a, b, cc, d);
    b = from_lane(b, c, 3);
    cc = from_lane(cc, c, 2);
    d = from_lane(d, c, 1);
  }
  a += s0;
  b += s1;
  cc += s2;
  d += s3;
  if (!valid) return;
  if (ctr == 0) {
    poly[pkg * 8 + c] = a;
    poly[pkg * 8 + 4 + c] = b;
    return;
  }
  out[off] = d0 ^ a;
  out[off + 4] = d1 ^ b;
  out[off + 8] = d2 ^ cc;
  out[off + 12] = d3 ^ d;
}

__global__ void empty_kernel() {}

}  // namespace

// K4: keys u32 [items][8], nonces u32 [items][pkgs][3], data u32
// [items][pkgs][words] (words % 16 == 0) -> out u32 [items][pkgs][words],
// poly u32 [items][pkgs][8], at the geometry of chacha_cuda.launch_plan:
// threads per 64-byte block (1 or 4), threads per CTA, CTAs. A plan whose
// grid does not cover every block is refused.
extern "C" int chacha20_xor(const void* keys, const void* nonces,
                            const void* data, void* out, void* poly,
                            long long items, int pkgs, int words,
                            int lanes_per_block, int threads, unsigned grid,
                            void* stream) {
  if (items <= 0 || pkgs <= 0 || words <= 0 || words % 16)
    return (int)cudaErrorInvalidValue;
  const int lanes_per_pkg = words / 16 + 1;
  const long long lanes = items * pkgs * (long long)lanes_per_pkg;
  if ((lanes_per_block != 1 && lanes_per_block != 4) || threads != kThreads ||
      (long long)grid * threads < lanes * lanes_per_block)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const uint32_t* n = static_cast<const uint32_t*>(nonces);
  const uint32_t* d = static_cast<const uint32_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* p = static_cast<uint32_t*>(poly);
  if (lanes_per_block == 4)
    chacha20_quad_kernel<<<grid, kThreads, 0, s>>>(k, n, d, o, p, lanes,
                                                  lanes_per_pkg, pkgs, words);
  else if ((reinterpret_cast<uintptr_t>(data) |
            reinterpret_cast<uintptr_t>(out)) % 16 == 0)
    chacha20_kernel<true><<<grid, kThreads, 0, s>>>(
        k, n, d, o, p, lanes, lanes_per_pkg, pkgs, words);
  else
    chacha20_kernel<false><<<grid, kThreads, 0, s>>>(
        k, n, d, o, p, lanes, lanes_per_pkg, pkgs, words);
  return (int)cudaGetLastError();
}

// An empty kernel at a plan's grid and block: what a launch of that
// geometry costs with no work in it.
extern "C" int chacha20_empty(unsigned grid, int threads, void* stream) {
  empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
