// S3 Select CSV predicate scan for Hopper: the select_scan lane's kernel.
//
// Replaces the Pallas kernel of minio_tpu/ops/scan_pallas.py
// (_make_scan_kernel / scan_fn_for.run, scan_pallas.py:210 and :259, with
// its _parse_col automaton and _eval_program stack machine) and its jnp
// structural index (_cells_one_block, scan_pallas.py:68, which the JAX
// package runs outside the Pallas kernel).
//
// K6 scan_codes is one pass over the bytes. Each block of L bytes is cut
// into tiles of T bytes (ops/scan_cuda.py tile_plan: 12 KiB, so a 1 MiB
// block is 86 tiles and Query A's 16-block flush 1,376 CTAs over the 132
// SMs, kCtasPerSm of them resident on each). A CTA takes the next tile
// from an atomic ticket (not from blockIdx, so a tile only ever waits on
// tiles already running) and:
// 1. copies the tile and a halo of H bytes before it (512 B) into shared
//    memory: one cp.async.bulk on an mbarrier (csrc/chunk_ring.cuh), or
//    direct loads for what bulk copies cannot take (L % 16, unaligned);
// 2. builds the window's newline bitmap, one bit per byte (16-byte
//    shared-memory reads, __vcmpeq4);
// 3. counts the tile's newlines (a run of bitmap words per thread, a
//    block-wide prefix sum) and lists the tile's row ends in shared memory
//    (row j of the tile ends at its j-th newline; a row belongs to the
//    tile holding its terminating newline);
// 4. publishes its newline count in a per-(block, tile) status word (flag
//    AGGREGATE; the block's first tile publishes it as INCLUSIVE), and
//    finds where its first row starts when the window holds that (after
//    the halo's last newline, or at the block's start);
// 5. gives row j to thread j % kThreads: the row's fields, up to the last
//    referenced column, from the delimiters of its bytes in shared memory
//    (its first 32 bytes as one mask from 9 word loads, __vcmpeq4, then
//    word by word); each referenced cell parsed right to left (at most 9
//    digits, an optional sign, spaces around: the TPU kernel's automaton);
//    then the WHERE program: codes 0, MATCH (1) or RESIDUAL (2). A thread's
//    first kHeld rows are parsed before the rank is known, their codes
//    held in registers, while the tiles before this one publish;
// 6. finds the rank of its first row by decoupled look-back: one warp sums
//    its predecessors' status words back to the nearest INCLUSIVE prefix
//    (32 words a step) and publishes its own inclusive prefix. No byte is
//    read twice from device memory: a count-then-parse pass would read
//    every byte twice and cap the kernel near half its bound;
// 7. writes the codes of the rows whose rank is under max_rows. A row that
//    starts before the halo (a row longer than the halo, found from the
//    block's start, the halo's newlines or a warp's backward search of
//    device memory) walks its bytes in device memory, one byte at a time;
//    it is rare at lineitem's ~125-byte rows. The
//    block's last tile also takes the bytes after the last newline (their
//    fields must end at a delimiter; the last one never ends) and writes
//    RESIDUAL to every rank past them up to max_rows, as the Pallas path
//    gives those rows.
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
// at the select path's flush of 128 x 1 MiB, 0.040 ms at 3.35 TB/s; the
// halo is re-read, mostly from L2, as its bytes were the previous tile's);
// the operations (a compare per byte, a few per parsed cell byte and
// program op) are far below the instruction rate. The design reads each
// byte once in bulk copies and keeps every later access in shared memory;
// the only device-memory scratch is the status words and the ticket. What
// it does not reach yet (PERF.md): a CTA lives ~10 us per tile, most of it
// in the rows' dependent chains (fields, parse, program: ~6,000 cycles a
// row), and ~7-10 resident CTAs per SM do not hide that.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_ring.cuh"

namespace {

constexpr int kThreads = 128;
// resident CTAs per SM the kernel is built for: at most 64 registers a
// thread, which it needs without spilling (the shared memory of
// tile_plan's default plan fits 11 CTAs; 10 with 48 registers spill and
// gain ~3%)
constexpr int kCtasPerSm = 8;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 8;
constexpr int kMaxOps = 64;
constexpr int kCellW = 16;
// IN options kept in shared memory (the rest are read from device memory)
constexpr int kMaxOpts = 64;
// rows a thread parses before the look-back, their codes held in registers
constexpr int kHeld = 4;
// the tile's row ends kept in a list (window positions), so that rows go to
// threads round-robin; a tile with more rows takes the rest by bitmap word
constexpr int kList = 512;
// the tile plan's limits: tiles and halos are whole bitmap words
constexpr int kMaxTile = 16384;
constexpr int kMaxHalo = 4096;
// a status word: flag in the top 2 bits, a newline count in the low 30
constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kInclusive = 2u << 30;
constexpr uint32_t kCount = (1u << 30) - 1;
// a look-back that waits ~2 s (2^32 cycles) can only be a broken protocol:
// it traps, so the launch fails instead of hanging the card
constexpr long long kSpinLimit = 1ll << 32;

enum : int {
  kLt = 0, kLe, kGt, kGe, kEq, kNe, kBetween, kIn, kAnd, kOr, kNot, kConst
};

struct Params {
  const uint8_t* blocks;
  const int4* ops;
  const int* opts;
  int* out;
  uint32_t* status;  // [nblocks][tiles] status words, then the ticket
  int L, max_rows, n_ops, n_opts, n_cols, last_col, delim, tile, halo, tiles;
  int cols[kMaxCols];
  uint64_t fieldmask;  // bit f: field f < 64 is a referenced column
};

// Dynamic shared memory of a plan (tile_plan's smem_bytes): the window, its
// newline bitmap, and kSlack bytes that a row's 36-byte read near the
// window's end may touch.
constexpr int kSlack = 64;
__host__ __device__ inline int smem_bytes(int tile, int halo) {
  return tile + halo + 4 * ((tile + halo) / 32) + kSlack;
}

__device__ __forceinline__ bool is_space(uint32_t b) {
  return b == 32 || b == 9 || b == 13 || b == 11 || b == 12;
}

// int(cell.strip()) for a cell of at most kCellW bytes and at most 9
// digits; false when it does not parse. ce < 0 marks a missing field. A NUL
// byte is not padding here (the TPU slot poisons it): it fails like any
// other non-digit. p is the window in shared memory or the block.
__device__ __forceinline__ bool parse_cell(const uint8_t* p, int cs, int ce,
                                           int* out) {
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

// Field f of a row spans [a, b): keep it for every referenced column f.
__device__ __forceinline__ void keep_field(const Params& P, int f, int a,
                                           int b, int (&cs)[kMaxCols],
                                           int (&ce)[kMaxCols]) {
  if (f < 64 && !((P.fieldmask >> f) & 1)) return;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < P.n_cols && P.cols[c] == f) {
      cs[c] = a;
      ce[c] = b;
    }
  }
}

// Bit i set for each byte i of w equal to the byte of pat (pat repeated).
__device__ __forceinline__ uint32_t byte_hits(uint32_t w, uint32_t pat) {
  return ((__vcmpeq4(w, pat) & 0x01010101u) * 0x10204080u) >> 28;
}

// The referenced fields of the row [s, e) of the window, read from shared
// memory 4 bytes at a time (delimiters found with __vcmpeq4) up to the
// last referenced column; `term`: the row ends at a newline at e (else its
// last field never ends). The first 32 bytes of the row become one
// delimiter mask from 9 loads issued together, so a warp's rows walk their
// leading fields without diverging; a row whose referenced fields reach
// further goes on word by word.
__device__ __forceinline__ void fields_from_window(
    const Params& P, const uint8_t* win, uint32_t dpat, int s, int e,
    bool term, int (&cs)[kMaxCols], int (&ce)[kMaxCols]) {
  int f = 0, fstart = s;
  if (s < e) {
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(win);
    uint64_t m64 = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i)
      m64 |= (uint64_t)byte_hits(w32[(s >> 2) + i], dpat) << (4 * i);
    uint32_t m = (uint32_t)(m64 >> (s & 3));
    if (e - s < 32) m &= (1u << (e - s)) - 1;
    for (; m && f <= P.last_col; m &= m - 1) {
      const int p = s + __ffs(m) - 1;
      keep_field(P, f, fstart, p, cs, ce);
      ++f;
      fstart = p + 1;
    }
    if (f <= P.last_col && e - s > 32) {  // past the first 32 bytes
      int w = (s + 32) >> 2;
      const int we = (e - 1) >> 2;
      m = byte_hits(w32[w], dpat) & (0xFu << ((s + 32) & 3));
      for (;;) {
        while (m == 0 && w < we) m = byte_hits(w32[++w], dpat);
        if (m == 0) break;
        const int p = (w << 2) + __ffs(m) - 1;
        m &= m - 1;
        if (p >= e) break;
        keep_field(P, f, fstart, p, cs, ce);
        ++f;
        fstart = p + 1;
        if (f > P.last_col) break;
      }
    }
  }
  if (term && f <= P.last_col) keep_field(P, f, fstart, e, cs, ce);
}

// The same from the block's bytes in device memory (a row that starts
// before the window).
__device__ __forceinline__ void fields_from_bytes(
    const Params& P, const uint8_t* __restrict__ blk, int s, int e, bool term,
    int (&cs)[kMaxCols], int (&ce)[kMaxCols]) {
  int f = 0, fstart = s;
  for (int p = s; f <= P.last_col; ++p) {
    bool ends;
    if (p >= e) {
      if (!term) break;  // no newline: the last field never ends
      ends = true;
    } else {
      ends = __ldg(blk + p) == P.delim;
    }
    if (!ends) continue;
    keep_field(P, f, fstart, p, cs, ce);
    if (p >= e) break;
    ++f;
    fstart = p + 1;
  }
}

// The window position of the last newline before `pos`; bits at and above
// pos are ignored. -1 when the window holds none.
__device__ __forceinline__ int last_newline_before(const uint32_t* nlb,
                                                   int pos) {
  if (pos <= 0) return -1;
  int w = (pos - 1) >> 5;
  uint32_t m = nlb[w] & (0xFFFFFFFFu >> (31 - ((pos - 1) & 31)));
  while (m == 0 && w > 0) m = nlb[--w];
  return m ? (w << 5) + 31 - __clz(m) : -1;
}

// a[i] for a run-time i (-1 past the end), without indexing: the array
// stays in registers
template <int N>
__device__ __forceinline__ int pick(const int (&a)[N], int i) {
  int v = -1;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (i == c) v = a[c];
  return v;
}

template <int N>
__device__ __forceinline__ void put(int (&a)[N], int i, int v) {
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (i == c) a[c] = v;
}

// The WHERE program over a row's values: MATCH (1) or 0. Every thread runs
// the same op at a time, so the branches are uniform; the comparisons are
// one mask indexed by the opcode (no jump table).
__device__ __forceinline__ int run_program(const Params& P, const int4* sops,
                                           const int* sopts,
                                           const int (&vals)[kMaxCols]) {
  uint64_t stack = 0;  // bit 0 is the top
#pragma unroll 1
  for (int i = 0; i < P.n_ops; ++i) {
    const int4 op = sops[i];
    const int v = pick(vals, op.y);
    uint32_t bit;
    if (op.x <= kBetween) {
      const uint32_t m = (uint32_t)(v < op.z) | (uint32_t)(v <= op.z) << 1 |
                         (uint32_t)(v > op.z) << 2 |
                         (uint32_t)(v >= op.z) << 3 |
                         (uint32_t)(v == op.z) << 4 |
                         (uint32_t)(v != op.z) << 5 |
                         (uint32_t)(v >= op.z && v <= op.w) << 6;
      bit = (m >> op.x) & 1;
    } else if (op.x == kIn) {
      bit = 0;
      for (int k = 0; k < op.z; ++k) {
        const int q = op.w + k;
        bit |= (q < kMaxOpts ? sopts[q] : __ldg(P.opts + q)) == v;
      }
    } else if (op.x == kNot) {
      bit = !(stack & 1);
      stack >>= 1;
    } else if (op.x == kConst) {
      bit = op.z != 0;
    } else {  // kAnd, kOr
      const uint32_t top = stack & 1, below = (stack >> 1) & 1;
      stack >>= 2;
      bit = op.x == kAnd ? (below & top) : (below | top);
    }
    stack = (stack << 1) | bit;
  }
  return (int)(stack & 1);
}

// A tile in shared memory: the program, and the window of the block [ws,
// ws + nbytes) with its newline bitmap; dpat is the delimiter byte
// repeated.
struct Tile {
  const int4* sops;
  const int* sopts;
  const uint8_t* win;
  const uint32_t* nlb;
  const uint8_t* blk;
  uint32_t dpat;
  int ws, nbytes;
};

// The code of a row of the tile: it ends at the newline at window position
// e (term), or (in the block's last tile) it is the bytes after the
// block's last newline (e = nbytes). It starts after the newline at window
// position prev, or, with prev < 0 (no newline before it in the window),
// at `first`, the block position where the tile's first row starts: -1
// while that is not known (the row starts before the window and the
// look-back has not run), and the code is then -1.
__device__ __forceinline__ int job_code(const Params& P, const Tile t, int prev,
                                     int e, bool term, int first) {
  const int s = prev >= 0 ? t.ws + prev + 1 : first;  // block position
  if (s < 0) return -1;
  if (term && s == t.ws + e) return 2;  // an empty row: no cell parses
  int cs[kMaxCols], ce[kMaxCols];
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) cs[i] = ce[i] = -1;
  const uint8_t* p = t.win;
  if (s >= t.ws) {
    fields_from_window(P, t.win, t.dpat, s - t.ws, e, term, cs, ce);
  } else {
    fields_from_bytes(P, t.blk, s, t.ws + e, term, cs, ce);
    p = t.blk;
  }
  int vals[kMaxCols] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll 1
  for (int c = 0; c < P.n_cols; ++c) {
    int v;
    if (!parse_cell(p, pick(cs, c), pick(ce, c), &v)) return 2;
    put(vals, c, v);
  }
  return run_program(P, t.sops, t.sopts, vals);
}

__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

// A status word carries all it publishes (no other data is ordered
// behind it), so a plain volatile store needs no fence.
__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  *reinterpret_cast<volatile uint32_t*>(p) = v;
}

// Warp 0 of tile k > 0, whose count c is published as an aggregate: the
// newlines of the block before the tile (decoupled look-back over the
// block's status words st); publishes the tile's inclusive prefix.
__device__ __forceinline__ int look_back(uint32_t* st, int k, int c) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int j = k - 1;; j -= 32) {
    const int idx = j - lane;
    uint32_t s = idx >= 0 ? load_status(st + idx) : kInclusive;
    long long start = 0;
    while (__any_sync(0xFFFFFFFFu, (s >> 30) == 0)) {
      if ((s >> 30) == 0) s = load_status(st + idx);
      const long long now = clock64();
      if (start == 0) start = now;
      if (now - start > kSpinLimit) __trap();
    }
    const uint32_t inc = __ballot_sync(0xFFFFFFFFu, (s >> 30) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    int v = lane <= stop ? (int)(s & kCount) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    excl += v;
    if (inc) break;
  }
  if (lane == 0) store_status(st + k, kInclusive | (uint32_t)(excl + c));
  return excl;
}

// Warp 0: the block position of the last newline before `hi` (-1 if none),
// searched backwards in device memory 512 bytes a step.
template <bool kBulk>
__device__ __forceinline__ int last_newline_in_memory(
    const uint8_t* __restrict__ blk, int hi) {
  const int lane = threadIdx.x & 31;
  while (hi > 0) {
    const int lo = max(0, hi - 512);
    const int p0 = lo + 16 * lane;
    int best = -1;
    if (p0 < hi) {
      if (kBulk) {  // lo and hi are multiples of 16
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(blk + p0));
        const uint32_t m = byte_hits(q.x, 0x0A0A0A0Au) |
                           byte_hits(q.y, 0x0A0A0A0Au) << 4 |
                           byte_hits(q.z, 0x0A0A0A0Au) << 8 |
                           byte_hits(q.w, 0x0A0A0A0Au) << 12;
        if (m) best = p0 + 31 - __clz(m);
      } else {
        const int q1 = min(hi, p0 + 16);
        for (int q = p0; q < q1; ++q)
          if (__ldg(blk + q) == 10) best = q;
      }
    }
    best = __reduce_max_sync(0xFFFFFFFFu, best);
    if (best >= 0) return best;
    hi = lo;
  }
  return -1;
}

// One CTA, one tile (see the note at the top).
template <bool kBulk>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    scan_tiles_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int4 sops[kMaxOps];
  __shared__ int sopts[kMaxOpts];
  __shared__ uint64_t bar;
  __shared__ int s_ticket, s_excl, s_first;
  __shared__ int s_warp[kWarps];
  __shared__ uint16_t s_ends[kList];

  const int T = P.tile;
  uint8_t* win = smem;
  uint32_t* nlb = reinterpret_cast<uint32_t*>(smem + T + P.halo);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    s_ticket = atomicAdd(P.status + (long long)gridDim.x, 1u);
    if (kBulk) {
      ring::init(&bar, 1);
      ring::fence_init();
    }
  }
  for (int i = threadIdx.x; i < P.n_ops; i += kThreads) sops[i] = P.ops[i];
  for (int i = threadIdx.x; i < min(P.n_opts, kMaxOpts); i += kThreads)
    sopts[i] = P.opts[i];
  __syncthreads();
  const int ticket = s_ticket;
  const long long b = ticket / P.tiles;
  const int k = ticket - (int)(b * P.tiles);
  const uint8_t* blk = P.blocks + b * (long long)P.L;
  const int ts = k * T, te = min(P.L, ts + T);
  const int ws = max(0, ts - P.halo);
  const int nbytes = te - ws;
  const int tw0 = (ts - ws) >> 5;       // the tile's first bitmap word
  const int tw = (te - ts + 31) >> 5;   // the tile's bitmap words

  // 1. the window [ws, te) into shared memory
  if (kBulk) {
    if (threadIdx.x == 0) {
      ring::expect_tx(&bar, (uint32_t)nbytes);
      ring::bulk_copy(win, blk + ws, (uint32_t)nbytes, &bar);
    }
    ring::wait(&bar, 0);
  } else {
    for (int i = threadIdx.x; i < nbytes; i += kThreads)
      win[i] = __ldg(blk + ws + i);
    __syncthreads();
  }

  // 2. the newline bitmap, 32 bytes a word
  const int nw = (nbytes + 31) >> 5;
  for (int w = threadIdx.x; w < nw; w += kThreads) {
    const uint4* q = reinterpret_cast<const uint4*>(win + 32 * w);
    const uint4 x0 = q[0], x1 = q[1];
    const uint32_t v[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    uint32_t nm = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) nm |= byte_hits(v[i], 0x0A0A0A0Au) << (4 * i);
    const int valid = nbytes - 32 * w;
    if (valid < 32) nm &= (1u << valid) - 1;
    nlb[w] = nm;
  }
  __syncthreads();

  // 3. the tile's newlines: a run of words per thread, and the rank in the
  // tile of the first newline of each run (a block-wide prefix sum)
  const int per = (tw + kThreads - 1) / kThreads;
  const int w_lo = min(tw, (int)threadIdx.x * per);
  const int w_hi = min(tw, w_lo + per);
  int cnt = 0;
  for (int w = w_lo; w < w_hi; ++w) cnt += __popc(nlb[tw0 + w]);
  int inc = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int run0 = inc - cnt, c = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    if (i < warp) run0 += s_warp[i];
    c += s_warp[i];
  }
  {  // the list of the tile's row ends
    int i = run0;
    for (int w = w_lo; w < w_hi && i < kList; ++w) {
      for (uint32_t m = nlb[tw0 + w]; m && i < kList; m &= m - 1, ++i)
        s_ends[i] = (uint16_t)(((tw0 + w) << 5) + __ffs(m) - 1);
    }
  }
  const bool last = k == P.tiles - 1;
  uint32_t* st = P.status + b * P.tiles;

  // 4. warp 0 publishes the tile's count (inclusive for the block's first
  // tile, else an aggregate) and finds where the tile's first row starts
  // when the window holds that: after the halo's last newline, or at the
  // block's start
  if (warp == 0) {
    if (lane == 0)
      store_status(st + k, (k == 0 ? kInclusive : kAggregate) | (uint32_t)c);
    int first = ws == 0 ? 0 : -1;
    for (int base = tw0 - 1; base >= 0; base -= 32) {
      const int w = base - lane;
      const uint32_t m = w >= 0 ? nlb[w] : 0u;
      const uint32_t hit = __ballot_sync(0xFFFFFFFFu, m != 0);
      if (hit) {
        const int l = __ffs(hit) - 1;
        const uint32_t mm = __shfl_sync(0xFFFFFFFFu, m, l);
        first = ws + ((base - l) << 5) + 31 - __clz(mm) + 1;
        break;
      }
    }
    if (lane == 0) s_first = first;
  }
  __syncthreads();

  // 5. the tile's jobs: its rows (row j ends at the tile's j-th newline)
  // and, in the block's last tile, the bytes after the block's last
  // newline (job c). Job j goes to thread j % kThreads; a thread's first
  // kHeld jobs are parsed before the look-back, their codes held in
  // registers, while the tiles before this one publish
  const Tile t{sops, sopts, win, nlb, blk, (uint32_t)P.delim * 0x01010101u,
               ws, nbytes};
  const int listed = min(c, kList);
  // listed jobs: the listed rows, and the last bytes when the tile's rows
  // all fit the list; the newline before job j (-1 for the first)
  const int njobs = listed + (int)(last && c <= kList);
  const auto prev_of = [&](int j) { return j > 0 ? (int)s_ends[j - 1] : -1; };
  const int first0 = s_first;
  int held[kHeld];
#pragma unroll
  for (int r = 0; r < kHeld; ++r) {
    const int j = threadIdx.x + r * kThreads;
    held[r] = -1;
    if (j < njobs)
      held[r] = j < listed
                    ? job_code(P, t, prev_of(j), s_ends[j], true, first0)
                    : job_code(P, t, prev_of(j), nbytes, false, first0);
  }

  // 6. warp 0: the rank of the tile's first row (look-back), and where that
  // row starts when the window does not hold it: at the block's start if
  // no newline comes before the tile, else after the last one, searched
  // in device memory
  if (warp == 0) {
    const int excl = k == 0 ? 0 : look_back(st, k, c);
    int first = first0;
    if (first < 0) {
      if (excl == 0) {
        first = 0;
      } else if (excl < P.max_rows && c + (int)last > 0) {
        first = last_newline_in_memory<kBulk>(blk, ws) + 1;
      }
    }
    if (lane == 0) {
      s_excl = excl;
      s_first = first;
    }
  }
  __syncthreads();

  // 7. the codes of the jobs with a rank under max_rows: the held ones
  // (parsed now if their start was not known), the listed ones past them,
  // and the rows past the list (a tile of short rows: each thread takes
  // those ending in its words); then RESIDUAL for the block's ranks past
  // its last row
  const int excl = s_excl;
  const int lim = P.max_rows - excl;  // tile ranks below lim are written
  int* out = P.out + b * (long long)P.max_rows + excl;
  const int jl = min(njobs, lim);
#pragma unroll
  for (int r = 0; r < kHeld; ++r) {
    const int j = threadIdx.x + r * kThreads;
    if (j < jl) {
      out[j] = held[r] >= 0 ? held[r]
               : j < listed ? job_code(P, t, prev_of(j), s_ends[j], true,
                                       s_first)
                            : job_code(P, t, prev_of(j), nbytes, false,
                                       s_first);
    }
  }
  for (int j = threadIdx.x + kHeld * kThreads; j < jl; j += kThreads) {
    out[j] = j < listed
                 ? job_code(P, t, prev_of(j), s_ends[j], true, s_first)
                 : job_code(P, t, prev_of(j), nbytes, false, s_first);
  }
  if (c > kList && kList < lim) {
    int i = run0;
    for (int w = w_lo; w < w_hi && i < lim; ++w) {
      for (uint32_t m = nlb[tw0 + w]; m && i < lim; m &= m - 1, ++i) {
        if (i < kList) continue;
        const int e = ((tw0 + w) << 5) + __ffs(m) - 1;
        out[i] = job_code(P, t, last_newline_before(nlb, e), e, true,
                          s_first);
      }
    }
    if (last && w_lo < tw && w_hi == tw && c < lim)
      out[c] = job_code(P, t, last_newline_before(nlb, nbytes), nbytes,
                        false, s_first);
  }
  if (last) {
    for (int r = c + 1 + (int)threadIdx.x; r < lim; r += kThreads)
      out[r] = 2;
  }
}

}  // namespace

// K6: blocks u8 [B][L]; status u32 [B * tiles + 1] zeroed (scratch: the
// status words, then the ticket); ops i32 [n_ops][4], opts i32 [n_opts]
// (IN options, at least one element) on the card; cols i32 [n_cols] on the
// host; the tile plan (tile, halo: multiples of 32) -> out i32
// [B][max_rows]. The wrapper checks the program (balanced, slots <
// n_cols); delim must not be the newline.
extern "C" int scan_codes(const void* blocks, void* status, const void* ops,
                          int n_ops, const void* opts, int n_opts,
                          const void* cols, int n_cols, int delim,
                          long long nblocks, int L, int max_rows, int tile,
                          int halo, void* out, void* stream) {
  if (nblocks <= 0 || L <= 0 || L >= (1 << 30) || max_rows <= 0 ||
      n_ops <= 0 || n_ops > kMaxOps || n_opts <= 0 || n_cols <= 0 ||
      n_cols > kMaxCols || delim < 0 || delim > 255 || delim == 10 ||
      tile < 32 || tile > kMaxTile || tile % 32 || halo < 0 ||
      halo > kMaxHalo || halo % 32)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (L + tile - 1) / tile;
  const long long grid = nblocks * tiles;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  Params P;
  P.blocks = static_cast<const uint8_t*>(blocks);
  P.ops = static_cast<const int4*>(ops);
  P.opts = static_cast<const int*>(opts);
  P.out = static_cast<int*>(out);
  P.status = static_cast<uint32_t*>(status);
  P.L = L;
  P.max_rows = max_rows;
  P.n_ops = n_ops;
  P.n_opts = n_opts;
  P.n_cols = n_cols;
  P.delim = delim;
  P.tile = tile;
  P.halo = halo;
  P.tiles = (int)tiles;
  const int* cp = static_cast<const int*>(cols);
  P.last_col = 0;
  P.fieldmask = 0;
  for (int i = 0; i < kMaxCols; ++i) P.cols[i] = -1;
  for (int i = 0; i < n_cols; ++i) {
    if (cp[i] < 0) return (int)cudaErrorInvalidValue;
    P.cols[i] = cp[i];
    P.last_col = cp[i] > P.last_col ? cp[i] : P.last_col;
    if (cp[i] < 64) P.fieldmask |= 1ull << cp[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes(tile, halo);
  if (L % 16 == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0)
    scan_tiles_kernel<true><<<(unsigned)grid, kThreads, smem, s>>>(P);
  else
    scan_tiles_kernel<false><<<(unsigned)grid, kThreads, smem, s>>>(P);
  return (int)cudaGetLastError();
}
