// K2 gf_encode_batched for Hopper: the product of a batch of shard words by
// one fixed GF(2^8)/0x11D encode matrix, with the matrix compiled into the
// kernel. One library is built per matrix (ops/rs_cuda.py prepare_encode):
//
//   nvcc ... -DGFK_O=<rows> -DGFK_I=<inputs> -DGFK_MAT=0x<o*i bytes, hex>
//
// GFK_MAT holds the coefficients row-major as one run of hex digits (two
// per byte; nvcc splits a -D value at commas, so the run has none). It is
// only ever stringized and read by constexpr functions, so every
// coefficient bit is known while the kernel is compiled.
//
// Replaces the Pallas kernels of minio_tpu/ops/rs_pallas.py that bake the
// matrix in at trace time: _make_static_batch_kernel / _static_batch_call
// (rs_pallas.py:263, :300, the batched encode of every PUT flush) and
// _make_static_kernel / _static_call (:185, :224; here B = 1).
//
// Algorithm: Horner over the 8 bit planes with the SWAR x2 on the
// accumulator, as the TPU evaluates it,
//   acc = x2(acc) ^ XOR_{j: bit b of c_rj set} x_j     for b = 7 .. 0,
// fully unrolled by template recursion with `if constexpr`: an unset bit
// emits no instruction, and the doublings start at the row's highest set
// plane. The set bits' words fold into the accumulator two at a time (one
// 3-input LOP3 per pair).
//
// What bounds it on this card (B = 128, W = 16384 words): the bytes,
// 4*B*W*(i+o) read and written once, 168 MB at 16+4 (50 us at 3.35 TB/s).
// The 16+4 parity matrix has 65 of 128 bits set per row: 216 logic ops
// and 272 ops in all per word column, 0.45 G logic ops (27 us on the ALU
// pipe at 16.7 T/s) and 0.57 G ops (17 us at the 33.5 T/s issue rate),
// both under the bytes. 8+4 and 12+4 need fewer still (144 and 176 logic
// ops per column) against their own bytes. Reading the bits as data (from
// __constant__ memory, say) would spend a LOP3 on every one, set or not
// (8*i per row-word, 596 per column at 16+4: 75 us), and make the kernel
// operation-bound.
//
// Layout: one thread per V neighbouring words of every row (V = 4 through
// 16-byte loads when W % 4 == 0, both x and out are 16-byte aligned and
// i <= 16, else V = 1), neighbouring threads on neighbouring words, so each
// input row is read once with coalesced loads; blockIdx.y is the batch
// element. The i input words stay in registers and the o output rows are
// produced one at a time from them, each written once; the ragged edge is
// masked by thread.
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(GFK_O) || !defined(GFK_I) || !defined(GFK_MAT)
#error "build with -DGFK_O=<rows> -DGFK_I=<inputs> -DGFK_MAT=0x<hex bytes>"
#endif

#define GFK_STR2(x) #x
#define GFK_STR(x) GFK_STR2(x)

namespace {

constexpr int kThreads = 128;
constexpr int kO = GFK_O;
constexpr int kI = GFK_I;
// i <= 16 keeps V = 4 words of every input in registers
constexpr int kVecMaxI = 16;

static_assert(kO >= 1 && kI >= 1 && kI <= 32, "GFK_O >= 1, 1 <= GFK_I <= 32");
static_assert(sizeof(GFK_STR(GFK_MAT)) == 3 + 2 * kO * kI,
              "GFK_MAT must hold GFK_O * GFK_I bytes as hex digits");
static_assert(GFK_STR(GFK_MAT)[0] == '0' && GFK_STR(GFK_MAT)[1] == 'x',
              "GFK_MAT starts with 0x");

__host__ __device__ constexpr int hex_digit(char c) {
  return c <= '9' ? c - '0' : (c | 32) - 'a' + 10;
}

// Coefficient (r, j) of the matrix, at compile time.
__host__ __device__ constexpr int coef(int r, int j) {
  return hex_digit(GFK_STR(GFK_MAT)[2 + 2 * (r * kI + j)]) * 16 +
         hex_digit(GFK_STR(GFK_MAT)[3 + 2 * (r * kI + j)]);
}

__host__ __device__ constexpr bool bit(int r, int b, int j) {
  return (coef(r, j) >> b) & 1;
}

// The highest bit plane with a set bit in row r (-1: an all-zero row).
__host__ __device__ constexpr int top_plane(int r) {
  int top = -1;
  for (int j = 0; j < kI; ++j)
    for (int b = 7; b > top; --b)
      if (bit(r, b, j)) top = b;
  return top;
}

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

// acc ^= x_j for every j >= J whose bit b of row r is set.
template <int R, int B, int J, int V>
__device__ __forceinline__ void fold(uint32_t (&acc)[V],
                                     const uint32_t (&p)[kI][V]) {
  if constexpr (J < kI) {
    if constexpr (bit(R, B, J)) {
#pragma unroll
      for (int t = 0; t < V; ++t) acc[t] ^= p[J][t];
    }
    fold<R, B, J + 1, V>(acc, p);
  }
}

// Planes B .. 0 of row r: a doubling below the row's top plane, then the
// plane's set bits.
template <int R, int B, int V>
__device__ __forceinline__ void planes(uint32_t (&acc)[V],
                                       const uint32_t (&p)[kI][V]) {
  if constexpr (B >= 0) {
    if constexpr (B < top_plane(R)) {
#pragma unroll
      for (int t = 0; t < V; ++t) acc[t] = gf2x(acc[t]);
    }
    fold<R, B, 0, V>(acc, p);
    planes<R, B - 1, V>(acc, p);
  }
}

template <int R, int V>
__device__ __forceinline__ void rows(const uint32_t (&p)[kI][V],
                                     uint32_t* __restrict__ out, long long W) {
  if constexpr (R < kO) {
    uint32_t acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] = 0u;
    planes<R, 7, V>(acc, p);
    store_words<V>(out + (long long)R * W, acc);
    rows<R + 1, V>(p, out, W);
  }
}

// x u32 [B][kI][W] -> out u32 [B][kO][W]
template <int V>
__global__ void __launch_bounds__(kThreads)
    gf_encode_kernel(const uint32_t* __restrict__ x,
                     uint32_t* __restrict__ out, long long W) {
  const long long e = blockIdx.y;
  const long long w0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (w0 >= W) return;
  const uint32_t* xe = x + e * kI * W + w0;
  uint32_t p[kI][V];
#pragma unroll
  for (int j = 0; j < kI; ++j) load_words<V>(xe + (long long)j * W, p[j]);
  rows<0, V>(p, out + e * kO * W + w0, W);
}

template <int V>
cudaError_t launch(const uint32_t* x, uint32_t* out, int B, long long W,
                   cudaStream_t s) {
  const long long groups = (W + V - 1) / V;
  dim3 grid((unsigned)((groups + kThreads - 1) / kThreads), (unsigned)B);
  gf_encode_kernel<V><<<grid, kThreads, 0, s>>>(x, out, W);
  return cudaGetLastError();
}

}  // namespace

// K2: x u32 [B][i][W] -> out u32 [B][o][W] by the matrix this library was
// built for; o and i must be its GFK_O and GFK_I.
extern "C" int gfk_encode(const void* x, void* out, int B, int o, int i,
                          long long W, void* stream) {
  if (o != kO || i != kI || B <= 0 || B > 65535 || W <= 0 ||
      (W + kThreads - 1) / kThreads > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  uint32_t* op = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = kI <= kVecMaxI && W % 4 == 0 &&
                   (((uintptr_t)x | (uintptr_t)out) & 15u) == 0;
  return (int)(vec ? launch<4>(xp, op, B, W, s) : launch<1>(xp, op, B, W, s));
}
