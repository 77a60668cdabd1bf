// Multi-buffer MD5: 8 independent streams hashed lane-parallel with AVX2.
//
// MD5 is a strict sequential chain per stream, so one stream can never go
// faster than the scalar round latency — but a storage server ingests many
// PUT streams at once, and their chains are independent. The reference
// ships exactly this as minio/md5-simd (reference go.mod; used by
// pkg/hash/reader.go's ETag path): 8 AVX2 lanes, each lane one stream.
// This is the C++ equivalent feeding minio_tpu/utils/md5simd.py's hash
// server; ETag MD5 is the measured dominant CPU cost of concurrent PUTs
// (2.4 cpu-s/GiB vs 1.1 for encode+hash+write on the bench host).
//
// Layout: states is nlanes x 4 uint32 (A,B,C,D per lane, row-major).
// Each lane processes nblocks[i] 64-byte blocks from datas[i]; lanes step
// together through max(nblocks) rounds and a lane's state update is
// masked off once its own block count is exhausted (idle lanes re-read
// their last block — harmless, their result is blended away).
#include <cstdint>
#include <cstring>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

const uint32_t kInit[4] = {0x67452301u, 0xefcdab89u, 0x98badcfeu,
                           0x10325476u};

// K table (floor(abs(sin(i+1)) * 2^32))
const uint32_t K[64] = {
    0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
    0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
    0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
    0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
    0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
    0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
    0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
    0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
    0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
    0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
    0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};

const int S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17,
                   22, 5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20, 5, 9,
                   14, 20, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4,
                   11, 16, 23, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21,
                   6, 10, 15, 21};

#define MD5S_STEP(FEXPR, G, SH, KC)                \
  do {                                             \
    uint32_t f_ = (FEXPR);                         \
    uint32_t t_ = a + f_ + (KC) + w[(G)];          \
    t_ = (t_ << (SH)) | (t_ >> (32 - (SH)));       \
    a = d;                                         \
    d = c;                                         \
    c = b;                                         \
    b += t_;                                       \
  } while (0)

void md5_block_scalar(uint32_t st[4], const uint8_t* p) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t w[16];
  std::memcpy(w, p, 64);
#pragma GCC unroll 16
  for (int i = 0; i < 16; i++)
    MD5S_STEP(d ^ (b & (c ^ d)), i, S[i], K[i]);
#pragma GCC unroll 16
  for (int i = 16; i < 32; i++)
    MD5S_STEP(c ^ (d & (b ^ c)), (5 * i + 1) & 15, S[i], K[i]);
#pragma GCC unroll 16
  for (int i = 32; i < 48; i++)
    MD5S_STEP(b ^ c ^ d, (3 * i + 5) & 15, S[i], K[i]);
#pragma GCC unroll 16
  for (int i = 48; i < 64; i++)
    MD5S_STEP(c ^ (b | ~d), (7 * i) & 15, S[i], K[i]);
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
}

#undef MD5S_STEP

#if defined(__AVX2__)

inline __m256i rotl32(__m256i x, int s) {
  return _mm256_or_si256(_mm256_slli_epi32(x, s),
                         _mm256_srli_epi32(x, 32 - s));
}

// One 64-byte block step for 8 lanes. w[16] holds the transposed message
// words (w[j] = lane0..7's word j). Fully unrolled per 16-round group so
// K[i], S[i] and the message-word index are immediates — the branchy
// rolled form measured ~3x slower (round indices defeat constant folding).
#define MD5_STEP(FEXPR, G, SH, KC)                                       \
  do {                                                                   \
    __m256i f_ = (FEXPR);                                                \
    __m256i t_ = _mm256_add_epi32(                                       \
        _mm256_add_epi32(a, f_),                                         \
        _mm256_add_epi32(_mm256_set1_epi32((int)(KC)), w[(G)]));         \
    t_ = rotl32(t_, (SH));                                               \
    a = d;                                                               \
    d = c;                                                               \
    c = b;                                                               \
    b = _mm256_add_epi32(b, t_);                                         \
  } while (0)

#define F1 _mm256_xor_si256(d, _mm256_and_si256(b, _mm256_xor_si256(c, d)))
#define F2 _mm256_xor_si256(c, _mm256_and_si256(d, _mm256_xor_si256(b, c)))
#define F3 _mm256_xor_si256(b, _mm256_xor_si256(c, d))
#define F4 \
  _mm256_xor_si256( \
      c, _mm256_or_si256(b, _mm256_xor_si256(d, _mm256_set1_epi32(-1))))

void md5_block_x8(__m256i st[4], const __m256i w[16]) {
  __m256i a = st[0], b = st[1], c = st[2], d = st[3];
#pragma GCC unroll 16
  for (int i = 0; i < 16; i++) MD5_STEP(F1, i, S[i], K[i]);
#pragma GCC unroll 16
  for (int i = 16; i < 32; i++)
    MD5_STEP(F2, (5 * i + 1) & 15, S[i], K[i]);
#pragma GCC unroll 16
  for (int i = 32; i < 48; i++)
    MD5_STEP(F3, (3 * i + 5) & 15, S[i], K[i]);
#pragma GCC unroll 16
  for (int i = 48; i < 64; i++) MD5_STEP(F4, (7 * i) & 15, S[i], K[i]);
  st[0] = _mm256_add_epi32(st[0], a);
  st[1] = _mm256_add_epi32(st[1], b);
  st[2] = _mm256_add_epi32(st[2], c);
  st[3] = _mm256_add_epi32(st[3], d);
}

#undef F1
#undef F2
#undef F3
#undef F4
#undef MD5_STEP

// Transpose 8 lanes' 64-byte blocks into 16 word vectors via two-level
// unpack (gathers are slower on most cores).
inline void load_words_x8(const uint8_t* const p[8], __m256i w[16]) {
  for (int q = 0; q < 4; q++) {  // 4 groups of 4 words
    __m128i r0 = _mm_loadu_si128((const __m128i*)(p[0] + 16 * q));
    __m128i r1 = _mm_loadu_si128((const __m128i*)(p[1] + 16 * q));
    __m128i r2 = _mm_loadu_si128((const __m128i*)(p[2] + 16 * q));
    __m128i r3 = _mm_loadu_si128((const __m128i*)(p[3] + 16 * q));
    __m128i r4 = _mm_loadu_si128((const __m128i*)(p[4] + 16 * q));
    __m128i r5 = _mm_loadu_si128((const __m128i*)(p[5] + 16 * q));
    __m128i r6 = _mm_loadu_si128((const __m128i*)(p[6] + 16 * q));
    __m128i r7 = _mm_loadu_si128((const __m128i*)(p[7] + 16 * q));
    __m128i t0 = _mm_unpacklo_epi32(r0, r1), t1 = _mm_unpackhi_epi32(r0, r1);
    __m128i t2 = _mm_unpacklo_epi32(r2, r3), t3 = _mm_unpackhi_epi32(r2, r3);
    __m128i t4 = _mm_unpacklo_epi32(r4, r5), t5 = _mm_unpackhi_epi32(r4, r5);
    __m128i t6 = _mm_unpacklo_epi32(r6, r7), t7 = _mm_unpackhi_epi32(r6, r7);
    __m128i lo0 = _mm_unpacklo_epi64(t0, t2);  // word q*4+0 lanes 0-3
    __m128i lo1 = _mm_unpacklo_epi64(t4, t6);  // word q*4+0 lanes 4-7
    __m128i hi0 = _mm_unpackhi_epi64(t0, t2);  // word q*4+1 lanes 0-3
    __m128i hi1 = _mm_unpackhi_epi64(t4, t6);
    __m128i lo2 = _mm_unpacklo_epi64(t1, t3);  // word q*4+2
    __m128i lo3 = _mm_unpacklo_epi64(t5, t7);
    __m128i hi2 = _mm_unpackhi_epi64(t1, t3);  // word q*4+3
    __m128i hi3 = _mm_unpackhi_epi64(t5, t7);
    w[4 * q + 0] = _mm256_set_m128i(lo1, lo0);
    w[4 * q + 1] = _mm256_set_m128i(hi1, hi0);
    w[4 * q + 2] = _mm256_set_m128i(lo3, lo2);
    w[4 * q + 3] = _mm256_set_m128i(hi3, hi2);
  }
}

#endif  // __AVX2__

}  // namespace

extern "C" {

// Lane i consumes segments
// seg_off[i] .. seg_off[i+1]-1 of (seg_ptrs, seg_blocks) back to back.
// One call hashes every queued buffer of up to 8 streams — the Python
// hash server needs exactly one GIL-released call per scheduling round,
// which matters on few-core hosts where the worker's GIL reacquisition
// between small calls convoys with the producer threads.
void md5_multi_segments(uint32_t* states, const uint8_t* const* seg_ptrs,
                        const long* seg_blocks, const int* seg_off,
                        int nlanes) {
  static const uint8_t zero_block[64] = {0};
  struct Lane {
    const uint8_t* p;
    long rem;   // blocks left in current segment
    int seg;    // current segment index (global)
    int end;    // one past last segment (global)
  };
  Lane ln[8];
  int active = 0;
  for (int i = 0; i < nlanes; i++) {
    ln[i] = {zero_block, 0, seg_off[i], seg_off[i + 1]};
    while (ln[i].seg < ln[i].end && seg_blocks[ln[i].seg] == 0) ln[i].seg++;
    if (ln[i].seg < ln[i].end) {
      ln[i].p = seg_ptrs[ln[i].seg];
      ln[i].rem = seg_blocks[ln[i].seg];
      active++;
    }
  }
  for (int i = nlanes; i < 8; i++) ln[i] = {zero_block, 0, 0, 0};

#if defined(__AVX2__)
  if (nlanes > 2) {
    __m256i st[4];
    {
      uint32_t cur[8][4];
      for (int i = 0; i < 8; i++)
        std::memcpy(cur[i], i < nlanes ? states + 4 * i : kInit, 16);
      for (int j = 0; j < 4; j++)
        st[j] =
            _mm256_setr_epi32(cur[0][j], cur[1][j], cur[2][j], cur[3][j],
                              cur[4][j], cur[5][j], cur[6][j], cur[7][j]);
    }
    __m256i w[16];
    const uint8_t* p[8];
    while (active > 0) {
      // unmasked fast run: every lane has blocks; length = min(rem)
      if (active == nlanes) {
        long run = ln[0].rem;
        for (int i = 1; i < nlanes; i++)
          if (ln[i].rem < run) run = ln[i].rem;
        for (int i = 0; i < 8; i++) p[i] = ln[i].p;
        for (long b = 0; b < run; b++) {
          load_words_x8(p, w);
          md5_block_x8(st, w);
          for (int i = 0; i < nlanes; i++) p[i] += 64;
        }
        for (int i = 0; i < nlanes; i++) {
          ln[i].p = p[i];
          ln[i].rem -= run;
        }
      } else {
        // masked single block: some lanes already drained
        uint32_t mask_arr[8];
        for (int i = 0; i < 8; i++) {
          p[i] = ln[i].rem > 0 ? ln[i].p : zero_block;
          mask_arr[i] = ln[i].rem > 0 ? 0xffffffffu : 0u;
        }
        __m256i prev[4] = {st[0], st[1], st[2], st[3]};
        load_words_x8(p, w);
        md5_block_x8(st, w);
        __m256i mask = _mm256_loadu_si256((const __m256i*)mask_arr);
        for (int j = 0; j < 4; j++)
          st[j] = _mm256_blendv_epi8(prev[j], st[j], mask);
        for (int i = 0; i < nlanes; i++)
          if (ln[i].rem > 0) {
            ln[i].p += 64;
            ln[i].rem--;
          }
      }
      // refill drained lanes from their next segment
      for (int i = 0; i < nlanes; i++) {
        if (ln[i].rem > 0 || ln[i].seg >= ln[i].end) continue;
        do {
          ln[i].seg++;
        } while (ln[i].seg < ln[i].end && seg_blocks[ln[i].seg] == 0);
        if (ln[i].seg < ln[i].end) {
          ln[i].p = seg_ptrs[ln[i].seg];
          ln[i].rem = seg_blocks[ln[i].seg];
        } else {
          active--;
        }
      }
    }
    alignas(32) uint32_t out[4][8];
    for (int j = 0; j < 4; j++)
      _mm256_store_si256((__m256i*)out[j], st[j]);
    for (int i = 0; i < nlanes; i++)
      for (int j = 0; j < 4; j++) states[4 * i + j] = out[j][i];
    return;
  }
#endif
  for (int i = 0; i < nlanes; i++)
    for (int s = seg_off[i]; s < seg_off[i + 1]; s++) {
      const uint8_t* q = seg_ptrs[s];
      for (long b = 0; b < seg_blocks[s]; b++, q += 64)
        md5_block_scalar(states + 4 * i, q);
    }
}

void md5_init_state(uint32_t* state) { std::memcpy(state, kInit, 16); }

// Finalize: append padding + 8-byte little-endian bit length, producing
// the 16-byte digest. tail_len < 64.
void md5_finish(uint32_t* state, const uint8_t* tail, long tail_len,
                unsigned long long total_bytes, uint8_t* out16) {
  uint8_t buf[128];
  std::memset(buf, 0, sizeof(buf));
  std::memcpy(buf, tail, (size_t)tail_len);
  buf[tail_len] = 0x80;
  long blocks = (tail_len + 9 <= 64) ? 1 : 2;
  unsigned long long bits = total_bytes * 8ull;
  std::memcpy(buf + 64 * blocks - 8, &bits, 8);
  const uint8_t* q = buf;
  for (long b = 0; b < blocks; b++, q += 64) md5_block_scalar(state, q);
  std::memcpy(out16, state, 16);
}

}  // extern "C"
