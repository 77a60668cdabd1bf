// S3 Select CSV predicate scan for Hopper: the select_scan lane's kernel.
//
// Replaces the Pallas kernel of minio_tpu/ops/scan_pallas.py
// (_make_scan_kernel / scan_fn_for.run, with its _parse_col automaton and
// _eval_program stack machine) and its jnp structural index
// (_cells_one_block, which the JAX package runs outside the Pallas kernel).
//
// K6 scan_codes is two launches on one stream, counted as one by the
// wrapper:
// 1. newline_kernel, one CTA of 1024 threads per block: each thread counts
//    the newlines of its 1/1024 of the block (16-byte loads, __vcmpeq4), a
//    shared-memory scan gives each thread the rank of its first newline,
//    and a second pass writes the position of the newline that ends row r
//    into nl_pos[b][r] for r < max_rows (L where row r has none). It
//    replaces the JAX index's cumsums and out-of-range scatters.
// 2. scan_kernel, one thread per (block, row): row r starts after the
//    newline that ends row r - 1. The thread walks its row's bytes once, up
//    to the last referenced field, and keeps each referenced field's
//    [start, end) in registers (at most kMaxCols pairs). It then parses
//    each such cell right to left (the TPU kernel's automaton over a
//    16-byte slot: optional sign, at most 9 digits, spaces around) and,
//    when every cell parsed, runs the predicate program: codes 0, MATCH (1)
//    or RESIDUAL (2). A field whose end the row never reaches is missing
//    and fails the parse, so a row past the block's newline count reads 2,
//    as the Pallas path gives it.
//
// The program is data, not code: the TPU unrolls each WHERE clause at trace
// time, but an nvcc build per query would cost seconds. K6 interprets an op
// table int32 [n_ops][4] = (opcode, slot, k or lo or IN count, hi or IN
// offset) with the IN options in a separate int32 array (an IN list is not
// bounded by the op count); the stack of booleans is one 64-bit mask, as a
// program has at most kMaxOps ops. The table sits in shared memory.
//
// The parse accumulates in uint32_t (a 10th digit wraps, defined for an
// unsigned type, and fails the parse anyway).
//
// What bounds it on this card: each block byte must be read once (134 MB
// at the select path's flush of 128 x 1 MiB, 0.040 ms at 3.35 TB/s); the
// operations (a compare per byte, a few per parsed cell byte and program
// op) are far below the instruction rate. This first design reads each block
// twice in the newline pass, from one CTA per block (128 of the 132 SMs at
// the flush), and walks each row from one thread, so a warp's loads are
// ~32 rows apart and scattered: latency- and sector-bound, not
// bandwidth-bound. A fused structural index (warps reading the block in
// coalesced 16-byte loads, rows found with ballots) is the later design.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kIndexThreads = 1024;
constexpr int kMaxCols = 8;
constexpr int kMaxOps = 64;
constexpr int kCellW = 16;

enum : int {
  kLt = 0, kLe, kGt, kGe, kEq, kNe, kBetween, kIn, kAnd, kOr, kNot, kConst
};

__device__ __forceinline__ bool is_space(uint32_t b) {
  return b == 32 || b == 9 || b == 13 || b == 11 || b == 12;
}

// int(cell.strip()) for a cell of at most kCellW bytes and at most 9
// digits; false when it does not parse. ce < 0 marks a missing field. A NUL
// byte is not padding here (the TPU slot poisons it): it fails like any
// other non-digit.
__device__ __forceinline__ bool parse_cell(const uint8_t* __restrict__ p,
                                           int cs, int ce, int* out) {
  const int ln = ce - cs;
  if (ce < 0 || ln <= 0 || ln > kCellW) return false;
  uint32_t val = 0, pw = 1;
  int ndig = 0;
  bool neg = false;
  int phase = 0;  // 0 trailing spaces, 1 digits, 2 after a sign, 3 leading
  for (int j = ce - 1; j >= cs; --j) {
    const uint32_t b = p[j];
    const bool dig = b - 48u < 10u;
    if (phase == 0) {
      if (is_space(b)) continue;
      if (!dig) return false;
      phase = 1;
    } else if (phase == 1) {
      if (!dig) {
        if (b == 45 || b == 43) {
          neg = b == 45;
          phase = 2;
        } else if (is_space(b)) {
          phase = 3;
        } else {
          return false;
        }
        continue;
      }
    } else {
      if (!is_space(b)) return false;
      phase = 3;
      continue;
    }
    val += (b - 48u) * pw;
    pw *= 10u;
    ++ndig;
  }
  if (phase == 0 || ndig > 9) return false;
  *out = neg ? -(int)val : (int)val;
  return true;
}

// nl_pos[b][r] = the position of the newline that ends row r of block b,
// L if there is none, for r < max_rows. kVec: L % 16 == 0 and the blocks
// are 16-byte aligned, so each thread reads its bytes as uint4.
template <bool kVec>
__global__ void __launch_bounds__(kIndexThreads)
    newline_kernel(const uint8_t* __restrict__ blocks, int L, int max_rows,
                   int* __restrict__ nl_pos) {
  __shared__ int ranks[kIndexThreads];
  const int t = threadIdx.x;
  const uint8_t* blk = blocks + blockIdx.x * (long long)L;
  int* nl = nl_pos + blockIdx.x * (long long)max_rows;
  const int chunk = ((L + kIndexThreads - 1) / kIndexThreads + 15) & ~15;
  const int lo = min(L, t * chunk), hi = min(L, lo + chunk);
  int n = 0;
  if (kVec) {
    for (int p = lo; p < hi; p += 16) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(blk + p));
      n += (__popc(__vcmpeq4(w.x, 0x0A0A0A0Au)) +
            __popc(__vcmpeq4(w.y, 0x0A0A0A0Au)) +
            __popc(__vcmpeq4(w.z, 0x0A0A0A0Au)) +
            __popc(__vcmpeq4(w.w, 0x0A0A0A0Au))) >> 3;
    }
  } else {
    for (int p = lo; p < hi; ++p) n += __ldg(blk + p) == 10;
  }
  // inclusive scan of the counts over the CTA (Hillis-Steele)
  ranks[t] = n;
  __syncthreads();
  for (int o = 1; o < kIndexThreads; o <<= 1) {
    const int v = t >= o ? ranks[t - o] : 0;
    __syncthreads();
    ranks[t] += v;
    __syncthreads();
  }
  const int total = ranks[kIndexThreads - 1];
  int r = ranks[t] - n;  // rank of this thread's first newline
  if (kVec) {
    for (int p = lo; p < hi && r < max_rows; p += 16) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(blk + p));
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t m = __vcmpeq4(words[k], 0x0A0A0A0Au);
        while (m && r < max_rows) {
          const int byte = (__ffs(m) - 1) >> 3;
          nl[r++] = p + 4 * k + byte;
          m &= ~(0xFFu << (8 * byte));
        }
      }
    }
  } else {
    for (int p = lo; p < hi && r < max_rows; ++p)
      if (__ldg(blk + p) == 10) nl[r++] = p;
  }
  for (int q = total + t; q < max_rows; q += kIndexThreads) nl[q] = L;
}

__global__ void __launch_bounds__(kThreads)
    scan_kernel(const uint8_t* __restrict__ blocks,
                const int* __restrict__ nl_pos, const int4* __restrict__ ops,
                const int* __restrict__ opts, long long rows_total,
                int max_rows, int L, int n_cols, int last_col, int n_ops,
                int delim, int c0, int c1, int c2, int c3, int c4, int c5,
                int c6, int c7, int* __restrict__ out) {
  __shared__ int4 sops[kMaxOps];
  for (int i = threadIdx.x; i < n_ops; i += blockDim.x) sops[i] = ops[i];
  __syncthreads();
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows_total) return;
  const long long b = t / max_rows;
  const int r = (int)(t - b * max_rows);
  const uint8_t* blk = blocks + b * (long long)L;
  const int* nl = nl_pos + b * (long long)max_rows;
  const int cols[kMaxCols] = {c0, c1, c2, c3, c4, c5, c6, c7};

  int start = r == 0 ? 0 : min(__ldg(nl + r - 1) + 1, L);
  const int stop = __ldg(nl + r);  // L: the row has no newline
  int cs[kMaxCols], ce[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) cs[c] = ce[c] = -1;
  // walk the row: field f spans [fstart, p) when byte p ends it
  int f = 0, fstart = start;
  for (int p = start; f <= last_col; ++p) {
    bool ends;
    if (p >= stop) {
      if (stop >= L) break;  // no newline: the last field never ends
      ends = true;
    } else {
      ends = __ldg(blk + p) == delim;
    }
    if (!ends) continue;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < n_cols && cols[c] == f) {
        cs[c] = fstart;
        ce[c] = p;
      }
    }
    if (p >= stop) break;
    ++f;
    fstart = p + 1;
  }

  int vals[kMaxCols];
  bool fail = false;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    vals[c] = 0;
    if (c < n_cols && !fail) fail = !parse_cell(blk, cs[c], ce[c], &vals[c]);
  }
  if (fail) {
    out[t] = 2;
    return;
  }
  uint64_t stack = 0;  // bit 0 is the top
  for (int i = 0; i < n_ops; ++i) {
    const int4 op = sops[i];
    int v = vals[0];
#pragma unroll
    for (int c = 1; c < kMaxCols; ++c)
      if (op.y == c) v = vals[c];
    bool bit;
    switch (op.x) {
      case kLt: bit = v < op.z; break;
      case kLe: bit = v <= op.z; break;
      case kGt: bit = v > op.z; break;
      case kGe: bit = v >= op.z; break;
      case kEq: bit = v == op.z; break;
      case kNe: bit = v != op.z; break;
      case kBetween: bit = v >= op.z && v <= op.w; break;
      case kIn: {
        bit = false;
        for (int k = 0; k < op.z; ++k) bit |= __ldg(opts + op.w + k) == v;
        break;
      }
      case kAnd:
      case kOr: {
        const bool top = stack & 1, below = (stack >> 1) & 1;
        stack >>= 2;
        bit = op.x == kAnd ? (below && top) : (below || top);
        break;
      }
      case kNot:
        bit = !(stack & 1);
        stack >>= 1;
        break;
      default:  // kConst
        bit = op.z != 0;
        break;
    }
    stack = (stack << 1) | (uint64_t)bit;
  }
  out[t] = (int)(stack & 1);
}

}  // namespace

// K6: blocks u8 [B][L], nl_pos i32 [B][max_rows] (scratch), ops i32
// [n_ops][4], opts i32 (IN options, at least one element) on the card, cols
// i32 [n_cols] on the host -> out i32 [B][max_rows]. The wrapper checks the
// program (balanced, slots < n_cols); delim must not be the newline.
extern "C" int scan_codes(const void* blocks, void* nl_pos, const void* ops,
                          int n_ops, const void* opts, const void* cols,
                          int n_cols, int delim, long long nblocks, int L,
                          int max_rows, void* out, void* stream) {
  if (nblocks <= 0 || nblocks > 0x7FFFFFFFLL || L <= 0 || max_rows <= 0 ||
      n_ops <= 0 || n_ops > kMaxOps || n_cols <= 0 || n_cols > kMaxCols ||
      delim == 10)
    return (int)cudaErrorInvalidValue;
  const int* cp = static_cast<const int*>(cols);
  int c[kMaxCols] = {-1, -1, -1, -1, -1, -1, -1, -1};
  int last = 0;
  for (int i = 0; i < n_cols; ++i) {
    if (cp[i] < 0) return (int)cudaErrorInvalidValue;
    c[i] = cp[i];
    last = cp[i] > last ? cp[i] : last;
  }
  const long long rows = nblocks * (long long)max_rows;
  const long long grid = (rows + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x = static_cast<const uint8_t*>(blocks);
  int* nl = static_cast<int*>(nl_pos);
  if (L % 16 == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0)
    newline_kernel<true><<<(unsigned)nblocks, kIndexThreads, 0, s>>>(
        x, L, max_rows, nl);
  else
    newline_kernel<false><<<(unsigned)nblocks, kIndexThreads, 0, s>>>(
        x, L, max_rows, nl);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<(unsigned)grid, kThreads, 0, s>>>(
      x, nl, static_cast<const int4*>(ops), static_cast<const int*>(opts),
      rows, max_rows, L, n_cols, last, n_ops, delim, c[0], c[1], c[2], c[3],
      c[4], c[5], c[6], c[7], static_cast<int*>(out));
  return (int)cudaGetLastError();
}
