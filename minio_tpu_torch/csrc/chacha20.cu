// ChaCha20 keystream XOR for Hopper: the SSE package cipher's device lane.
//
// Replaces both Pallas kernels of minio_tpu/ops/chacha_pallas.py:
// _make_multi_kernel / multi_fn_for (many objects, each under its own key:
// the dispatch op sse_xor) and _make_kernel / _jitted (one object's
// packages: xor_packages_device), the latter as this kernel with one item.
//
// K4 chacha20_xor runs one thread per 64-byte block ("lane"). Package p of
// item i owns nb + 1 lanes, nb = words / 16: lane 0 is counter 0, whose
// first 8 keystream words are the package's Poly1305 one-time key; lane
// j >= 1 is counter j and XORs data block j - 1. The 16-word state lives
// in registers through the 10 double rounds, the feed-forward and the XOR.
// Key and nonce come straight from the item and package index of the lane,
// read from [I][8] and [I][P][3]: nothing is expanded per lane on the
// host. (The TPU kernel repeats the key per lane only because its tiles
// are (8, 128) vregs, and it pads the lane count to a tile multiple.)
//
// What bounds it on this card: per data block 992 int32 operations (the
// rounds' 320 adds, 320 XORs and 320 rotates, a rotate being one funnel
// shift, then 16 feed-forward adds and 16 XORs with the payload) against
// 128 bytes moved over 3.35 TB/s. Adds, shifts and rotates can issue on
// the ALU or the FMA pipe (IMAD forms); the 336 XORs only on the ALU pipe.
// At the sse_xor flush shape (128 items x 16 packages x 64 KiB) that is
// ~2.08 G operations over the SMs' issue rate (128 lanes/clk/SM, 33.5 T/s),
// 0.062 ms, and 0.71 G XORs over the ALU pipe's 16.7 T/s, 0.042 ms,
// against 268 MB, 0.080 ms: bound by bytes. Every lane is independent, so
// 2.1 M threads fill the card; the design keeps the state in registers and
// issues the payload as four 16-byte loads and stores per thread.
// chip_smoke.py prints the SASS this builds to, by pipe.
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

}  // namespace

// K4: keys u32 [items][8], nonces u32 [items][pkgs][3], data u32
// [items][pkgs][words] (words % 16 == 0) -> out u32 [items][pkgs][words],
// poly u32 [items][pkgs][8].
extern "C" int chacha20_xor(const void* keys, const void* nonces,
                            const void* data, void* out, void* poly,
                            long long items, int pkgs, int words,
                            void* stream) {
  if (items <= 0 || pkgs <= 0 || words <= 0 || words % 16)
    return (int)cudaErrorInvalidValue;
  const int lanes_per_pkg = words / 16 + 1;
  const long long lanes = items * pkgs * (long long)lanes_per_pkg;
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const bool vec = (reinterpret_cast<uintptr_t>(data) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const uint32_t* n = static_cast<const uint32_t*>(nonces);
  const uint32_t* d = static_cast<const uint32_t*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* p = static_cast<uint32_t*>(poly);
  if (vec)
    chacha20_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        k, n, d, o, p, lanes, lanes_per_pkg, pkgs, words);
  else
    chacha20_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        k, n, d, o, p, lanes, lanes_per_pkg, pkgs, words);
  return (int)cudaGetLastError();
}
