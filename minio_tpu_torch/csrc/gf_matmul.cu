// GF(2^8)/0x11D shard-matrix products on 32-bit packed words with
// coefficients known only at run time, for Hopper.
//
// Replaces the Pallas kernels of minio_tpu/ops/rs_pallas.py:
//   K1 gf_matmul_batched  <- _dyn_batch_kernel / _gf_matmul_batched (and
//                            _dyn_kernel / gf_matmul_pallas as B = 1):
//                            per-element coefficient masks, the rebuild of
//                            heal, degraded GET and the fused verify+rebuild.
// (K2, the product by one fixed encode matrix, compiles that matrix into
// its kernel: csrc/gf_encode.cu.)
//
// Algorithm: Horner over the 8 bit planes with the SWAR x2 on the
// accumulator, as the TPU evaluates it:
//   acc = x2(acc) ^ XOR_j (mask[b][r][j] & x[j])    for b = 7 .. 0
// where mask[b][r][j] is all ones iff bit b of coefficient (r, j) is set.
// (mask & x) ^ acc is one LOP3, so a row costs 8*i LOP3 plus 7 x2 (~5 ops)
// per word, with no table lookups: a log/exp or split-nibble table would
// need 4-8 shared-memory lookups per word per coefficient, each costing an
// instruction slot like a LOP3 does.
//
// Layout: one thread per V neighbouring words of every row (V = 4 through
// 16-byte loads when W % 4 == 0 and x and out are 16-byte aligned, else 1), neighbouring threads on
// neighbouring words, so each input row is read once with coalesced loads.
// blockIdx.y is the batch element. The i input words stay in registers
// (template bound IMAX >= i), and the o output rows are produced one at a
// time from them, so any o works (reconstruct_batch asks for o = n = 20)
// and each output row is written once. The ragged edge is masked by
// thread; W need not be padded.
//
// Coefficients are read warp-uniformly: K1 stages its element's [8][o][i]
// masks in shared memory (a broadcast read).
//
// Bounds at the main shapes (B = 128, i = 16, W = 16384), with integer ops
// at the SMs' issue rate, 128 lanes/clk/SM * 132 SMs * 1.98 GHz = 33.5 T/s,
// and the bitwise logic (LOP3: XOR, AND), which only the ALU pipe runs, at
// half of that, 16.7 T/s: every coefficient bit costs a LOP3, and each of
// the 7 doublings 5 ops, 3 of them logic: B*W*o*(8*i + 21) logic ops. At
// o = 2, 151 MB (45 us) against 0.63 G logic ops (37 us): bound by bytes.
// At o = 20 (reconstruct_batch), 6.2 G logic ops (374 us): bound by
// operations.
// The design spends no operation on address math inside the bit loop and
// none on table lookups.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t gf2x(uint32_t a) {
  const uint32_t hi = a & 0x80808080u;
  return ((a << 1) & 0xFEFEFEFEu) ^ ((hi >> 7) * 0x1Du);
}

template <int V>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&v)[V]) {
  if constexpr (V == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) v[t] = p[t];
  }
}

template <int V>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) p[t] = v[t];
  }
}

struct SmemMasks {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t operator()(int idx) const { return p[idx]; }
};

// One element: x [i][W] -> out [o][W], masks indexed [b][r][j].
template <int IMAX, int V, class Masks>
__device__ __forceinline__ void gf_rows(const Masks& mk,
                                        const uint32_t* __restrict__ x,
                                        uint32_t* __restrict__ out, int o,
                                        int i, long long W) {
  const long long w0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (w0 >= W) return;
  uint32_t p[IMAX][V];
#pragma unroll
  for (int j = 0; j < IMAX; ++j) {
    if (j < i) {
      load_words<V>(x + (long long)j * W + w0, p[j]);
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t) p[j][t] = 0u;
    }
  }
  for (int r = 0; r < o; ++r) {
    uint32_t acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] = 0u;
#pragma unroll
    for (int b = 7; b >= 0; --b) {
      if (b != 7) {
#pragma unroll
        for (int t = 0; t < V; ++t) acc[t] = gf2x(acc[t]);
      }
      const int base = (b * o + r) * i;
#pragma unroll
      for (int j = 0; j < IMAX; ++j) {
        if (j < i) {
          const uint32_t m = mk(base + j);
#pragma unroll
          for (int t = 0; t < V; ++t) acc[t] ^= m & p[j][t];
        }
      }
    }
    store_words<V>(out + (long long)r * W + w0, acc);
  }
}

template <int IMAX, int V>
__global__ void __launch_bounds__(kThreads)
    gf_matmul_batched_kernel(const uint32_t* __restrict__ masks,
                             const uint32_t* __restrict__ x,
                             uint32_t* __restrict__ out, int o, int i,
                             long long W) {
  extern __shared__ uint32_t s_masks[];
  const long long e = blockIdx.y;
  const int nm = 8 * o * i;
  const uint32_t* gm = masks + e * nm;
  for (int t = threadIdx.x; t < nm; t += blockDim.x) s_masks[t] = gm[t];
  __syncthreads();
  gf_rows<IMAX, V>(SmemMasks{s_masks}, x + e * i * W, out + e * o * W, o, i,
                   W);
}

template <int IMAX, int V>
cudaError_t launch_matmul(const uint32_t* masks, const uint32_t* x,
                          uint32_t* out, int B, int o, int i, long long W,
                          cudaStream_t s) {
  const size_t smem = sizeof(uint32_t) * 8 * (size_t)o * i;
  auto kern = gf_matmul_batched_kernel<IMAX, V>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long groups = (W + V - 1) / V;
  dim3 grid((unsigned)((groups + kThreads - 1) / kThreads), (unsigned)B);
  kern<<<grid, kThreads, smem, s>>>(masks, x, out, o, i, W);
  return cudaGetLastError();
}

// Picks (IMAX, V) for i and W: 16-byte words per thread when W % 4 == 0,
// both x and out are 16-byte aligned (a view may start at any word) and the
// i*4 input registers fit; one word per thread otherwise.
template <class F>
cudaError_t dispatch(int i, long long W, const void* x, const void* out,
                     F&& f) {
  const bool vec = (W % 4) == 0 &&
                   (((uintptr_t)x | (uintptr_t)out) & 15u) == 0;
  if (i <= 4) return vec ? f.template go<4, 4>() : f.template go<4, 1>();
  if (i <= 8) return vec ? f.template go<8, 4>() : f.template go<8, 1>();
  if (i <= 16) return vec ? f.template go<16, 4>() : f.template go<16, 1>();
  if (i <= 32) return f.template go<32, 1>();
  return cudaErrorInvalidValue;
}

struct MatmulCall {
  const uint32_t* masks; const uint32_t* x; uint32_t* out;
  int B, o, i; long long W; cudaStream_t s;
  template <int IMAX, int V> cudaError_t go() {
    return launch_matmul<IMAX, V>(masks, x, out, B, o, i, W, s);
  }
};

bool bad_shape(int B, int o, int i, long long W) {
  return B <= 0 || B > 65535 || o <= 0 || i <= 0 || i > 32 || W <= 0;
}

}  // namespace

// K1: masks u32 [B][8][o][i], x u32 [B][i][W] -> out u32 [B][o][W].
extern "C" int gfk_matmul_batched(const void* masks, const void* x, void* out,
                                  int B, int o, int i, long long W,
                                  void* stream) {
  if (bad_shape(B, o, i, W) || 8LL * o * i * 4 > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  MatmulCall c{static_cast<const uint32_t*>(masks),
               static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
               B, o, i, W, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(i, W, x, out, c);
}
