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
// Algorithm: Horner over the 8 bit planes with the SWAR x2, as the TPU
// evaluates it:
//   acc = x2(acc) ^ XOR_j (mask[b][r][j] & x[j])    for b = 7 .. 0
// where mask[b][r][j] is all ones iff bit b of coefficient (r, j) is set.
// (mask & x) ^ sum is one LOP3, so a row costs 8*i LOP3 plus 7 x2 (~5 ops)
// per word, with no table lookups: a log/exp or split-nibble table would
// need 4-8 shared-memory lookups per word per coefficient, each costing an
// instruction slot like a LOP3 does.
//
// What bounds it. With integer ops at the SMs' issue rate, 128 lanes/clk/SM
// * 132 SMs * 1.98 GHz = 33.5 T/s, and the bitwise logic (LOP3), which
// only the ALU pipe runs, at half of that, 16.7 T/s, a launch costs
// B*W*o*(8*i + 21) logic ops against 4*B*W*(i + o) bytes:
// - the 128-element flushes (i = 16, W = 16384): at o = 2, 151 MB (45 us)
//   against 0.63 G logic ops (37 us), bound by bytes; at o = 20
//   (reconstruct_batch), 6.2 G logic ops (374 us), bound by operations;
// - the batches the paths launch (B <= 8, o of 1 or 2): B = 1 moves 1.18 MB
//   (0.35 us) and its bit loops take 0.29 us spread over every SM; what
//   bounds it is latency: the launch, one device-memory round trip and the
//   bit loops' dependent chains.
//
// Layout (the geometry of ops/rs_cuda.py matmul_plan, passed to the C
// entry): a CTA of T threads (32, 64 or 128) in S slices (1, 2 or 4) of
// G = T / S threads, whole warps, over the CTA's G*V neighbouring words of
// one element (V = 1, 2 or 4 words per thread, through 8- or 16-byte loads
// when aligned); blockIdx.y is the element. Slice s takes inputs [s*J,
// (s+1)*J), J = ceil(i/S): the product by a fixed coefficient is linear
// over XOR, so the slices' Horner partials XOR to the exact result. They
// meet in shared memory and the CTA writes each output word once. What the
// design does about each bound:
// - one round trip: a thread issues its J*V input loads first; the masks
//   follow with cp.async into shared memory (as [8*o][S][JP], JP = J
//   rounded up to a power of two, zero past a slice's inputs, so a slice
//   reads four masks with one 16-byte broadcast) while they are in flight.
// - short chains: the 8 planes' sums over a thread's inputs do not depend
//   on each other and are built input by input, as the loads land; only
//   the 7 doublings chain.
// - the card filled at small B: the plan takes 16-byte words and 128-thread
//   CTAs for the large flushes (bytes), and for the small batches narrower
//   words, smaller CTAs and then slices, until the launch runs at least two
//   CTAs per SM (B = 1 at W = 16384: 512 CTAs, against the 32 of one
//   16-byte thread per 4 words). Slices repeat the doublings (21 logic ops
//   per row-word each), so they come last.
// Index math is shifts and masks (T, S, V and JP are powers of two), and
// none of it is inside the bit loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 128;

__device__ __forceinline__ uint32_t gf2x(uint32_t a) {
  const uint32_t hi = a & 0x80808080u;
  return ((a << 1) & 0xFEFEFEFEu) ^ ((hi >> 7) * 0x1Du);
}

template <int V>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&v)[V]) {
  if constexpr (V == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (V == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// cp.async of one word into shared memory, zero-filled when !full.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src,
                                          bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// log2 of a power of two.
__device__ __forceinline__ int log2i(int n) { return __ffs(n) - 1; }

// One CTA (see the top of the file). Shared memory: the masks [8*o][S][JP]
// words, then, when S > 1, the partial rows [S][o][G*V].
template <int JMAX, int V>
__global__ void __launch_bounds__(kMaxThreads)
    gf_matmul_batched_kernel(const uint32_t* __restrict__ masks,
                             const uint32_t* __restrict__ x,
                             uint32_t* __restrict__ out, int o, int i,
                             long long W, int S) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = blockDim.x;
  const int gl = log2i(T / S);  // log2 G
  const int s = threadIdx.x >> gl;
  const int g = threadIdx.x & ((1 << gl) - 1);
  const int J = (i + S - 1) / S;
  const int jl = J <= 4 ? 2 : 32 - __clz(J - 1);  // log2 JP
  const int j0 = s * J;
  const int nj = min(J, i - j0);
  const long long e = blockIdx.y;
  const int cwl = gl + log2i(V);  // log2 of the CTA's words, G * V
  const long long cw0 = (long long)blockIdx.x << cwl;
  const long long w0 = cw0 + (long long)g * V;
  const bool live = w0 < W;
  const uint32_t* xe = x + e * i * W;

  uint32_t p[JMAX][V];
#pragma unroll
  for (int jj = 0; jj < JMAX; ++jj) {
    if (jj < nj && live) {
      load_words<V>(xe + (long long)(j0 + jj) * W + w0, p[jj]);
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t) p[jj][t] = 0u;
    }
  }

  // the masks of element e, [8][o][i], to [8*o][S][JP], zero past each
  // slice's inputs, while the loads above are in flight
  const int rl = log2i(S) + jl;  // log2 of a row's words, S * JP
  const int nm = (8 * o) << rl;
  const uint32_t* gm = masks + e * 8 * o * i;
  for (int t = threadIdx.x; t < nm; t += T) {
    const int row = t >> rl;  // b * o + r
    const int sl = (t >> jl) & (S - 1);
    const int jj = t & ((1 << jl) - 1);
    const bool full = jj < J && sl * J + jj < i;
    cp_async4(smem + t, gm + (full ? row * i + sl * J + jj : 0), full);
  }
  cp_async_wait_all();
  __syncthreads();

  // Per row, the 8 planes' sums over the thread's inputs, input by input,
  // then Horner over the sums: acc = x2(acc) ^ sum[b] for b = 7 .. 0.
  const uint4* ms = reinterpret_cast<const uint4*>(smem);
  uint32_t* part = smem + nm;
  for (int r = 0; r < o; ++r) {
    uint32_t sum[8][V];
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int t = 0; t < V; ++t) sum[b][t] = 0u;
#pragma unroll
    for (int q = 0; q < JMAX / 4; ++q) {
      if (4 * q < nj) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const uint4 m =
              ms[((((b * o + r) << log2i(S)) + s) << (jl - 2)) + q];
#pragma unroll
          for (int t = 0; t < V; ++t)
            sum[b][t] ^= (m.x & p[4 * q][t]) ^ (m.y & p[4 * q + 1][t]) ^
                         (m.z & p[4 * q + 2][t]) ^ (m.w & p[4 * q + 3][t]);
        }
      }
    }
    uint32_t acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) {
      acc[t] = sum[7][t];
#pragma unroll
      for (int b = 6; b >= 0; --b) acc[t] = gf2x(acc[t]) ^ sum[b][t];
    }
    if (S == 1) {
      if (live) store_words<V>(out + (e * o + r) * W + w0, acc);
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t)
        part[((s * o + r) << cwl) + g * V + t] = acc[t];
    }
  }
  if (S == 1) return;
  __syncthreads();
  const int cw = 1 << cwl;
  for (int idx = threadIdx.x; idx < o << cwl; idx += T) {
    const int r = idx >> cwl;
    const int w = idx & (cw - 1);
    uint32_t v = 0u;
    for (int sl = 0; sl < S; ++sl) v ^= part[((sl * o + r) << cwl) + w];
    if (cw0 + w < W) out[(e * o + r) * W + cw0 + w] = v;
  }
}

struct MatmulCall {
  const uint32_t* masks; const uint32_t* x; uint32_t* out;
  int B, o, i; long long W; int S, threads; unsigned grid_x; int smem;
  cudaStream_t s;
  template <int JMAX, int V> cudaError_t go() {
    auto kern = gf_matmul_batched_kernel<JMAX, V>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    kern<<<dim3(grid_x, (unsigned)B), threads, smem, s>>>(masks, x, out, o,
                                                          i, W, S);
    return cudaGetLastError();
  }
};

// The template bound on a thread's inputs (4, 8, 16, 32) at or above n.
int bound(int n) { return n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32; }

// The kernel for a slice's J inputs and V (J * V <= 64: the input words
// live in registers).
cudaError_t dispatch(int J, int V, MatmulCall& c) {
  switch (bound(J) * 8 + V) {
    case 4 * 8 + 1: return c.go<4, 1>();
    case 4 * 8 + 2: return c.go<4, 2>();
    case 4 * 8 + 4: return c.go<4, 4>();
    case 8 * 8 + 1: return c.go<8, 1>();
    case 8 * 8 + 2: return c.go<8, 2>();
    case 8 * 8 + 4: return c.go<8, 4>();
    case 16 * 8 + 1: return c.go<16, 1>();
    case 16 * 8 + 2: return c.go<16, 2>();
    case 16 * 8 + 4: return c.go<16, 4>();
    case 32 * 8 + 1: return c.go<32, 1>();
    case 32 * 8 + 2: return c.go<32, 2>();
  }
  return cudaErrorInvalidValue;
}

__global__ void empty_kernel() {}

}  // namespace

// K1: masks u32 [B][8][o][i], x u32 [B][i][W] -> out u32 [B][o][W], at the
// geometry of rs_cuda.matmul_plan: V words per thread, S slices, threads
// per CTA, grid_x CTAs per element, dynamic shared memory bytes. A plan
// that does not cover W, or misses the kernel's shared memory or
// alignment, is refused.
extern "C" int gfk_matmul_batched(const void* masks, const void* x, void* out,
                                  int B, int o, int i, long long W, int V,
                                  int S, int threads, unsigned grid_x,
                                  int smem, void* stream) {
  if (B <= 0 || B > 65535 || o <= 0 || i <= 0 || i > 32 || W <= 0 ||
      smem > 227 * 1024 || (V != 1 && V != 2 && V != 4) || W % V != 0 ||
      (((uintptr_t)x | (uintptr_t)out) & (4u * V - 1)) != 0 ||
      (threads != 32 && threads != 64 && threads != 128) ||
      (S != 1 && S != 2 && S != 4) || threads / S < 32)
    return (int)cudaErrorInvalidValue;
  const int J = (i + S - 1) / S;
  int JP = 4;
  while (JP < J) JP *= 2;
  const long long need =
      4LL * o * (8LL * S * JP + (S > 1 ? (long long)threads * V : 0));
  if (J * V > 64 || (long long)grid_x * (threads / S) * V < W || smem < need)
    return (int)cudaErrorInvalidValue;
  MatmulCall c{static_cast<const uint32_t*>(masks),
               static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
               B, o, i, W, S, threads, grid_x, smem,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(J, V, c);
}

// An empty kernel at a plan's grid, block and shared memory: what a launch
// of that geometry costs with no work in it.
extern "C" int gfk_empty(unsigned grid_x, unsigned grid_y, int threads,
                         int smem, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  empty_kernel<<<dim3(grid_x, grid_y), threads, smem,
                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
