// CPU Reed-Solomon GF(256) encode baseline + fallback path.
//
// This is the same algorithm the reference's hot loop runs on the host
// (klauspost/reedsolomon's AVX2/SSSE3 galois-mul: split each byte into
// nibbles, multiply via two 16-entry shuffle lookup tables, XOR-accumulate
// across input shards — cf. cmd/erasure-coding.go:70 relying on go.mod:41).
// It serves two purposes in the TPU framework:
//   1. the CPU fallback codec when no TPU is attached, and
//   2. the measured AVX2 baseline denominator for bench.py's vs_baseline.
//
// Built with -mavx2 when available; plain C++ fallback otherwise.

#include <cstdint>
#include <cstring>

#ifdef __AVX2__
#include <immintrin.h>
#endif

namespace {

// GF(2^8), primitive polynomial 0x11D (same field as gf256.py).
struct Tables {
  uint8_t mul[256][256];
  uint8_t lo[256][16];  // lo[c][v]  = c * v        (low nibble)
  uint8_t hi[256][16];  // hi[c][v]  = c * (v << 4) (high nibble)
  Tables() {
    uint8_t exp[512];
    int log[256];
    int x = 1;
    for (int i = 0; i < 255; i++) {
      exp[i] = (uint8_t)x;
      log[x] = i;
      x <<= 1;
      if (x & 0x100) x ^= 0x11D;
    }
    for (int i = 255; i < 510; i++) exp[i] = exp[i - 255];
    for (int a = 0; a < 256; a++)
      for (int b = 0; b < 256; b++)
        mul[a][b] = (a && b) ? exp[log[a] + log[b]] : 0;
    for (int c = 0; c < 256; c++)
      for (int v = 0; v < 16; v++) {
        lo[c][v] = mul[c][v];
        hi[c][v] = mul[c][v << 4];
      }
  }
};

const Tables T;

}  // namespace

extern "C" {

// out[o][S] ^= or = matrix[o][i] (x) data[i][S].  Flat row-major buffers.
void gf256_encode(const uint8_t* matrix, int rows_out, int rows_in,
                  const uint8_t* data, uint8_t* out, long shard_len) {
  for (int o = 0; o < rows_out; o++) {
    uint8_t* dst = out + (long)o * shard_len;
    std::memset(dst, 0, (size_t)shard_len);
    for (int i = 0; i < rows_in; i++) {
      uint8_t c = matrix[o * rows_in + i];
      if (c == 0) continue;
      const uint8_t* src = data + (long)i * shard_len;
      long p = 0;
#ifdef __AVX2__
      const __m256i tlo =
          _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)T.lo[c]));
      const __m256i thi =
          _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)T.hi[c]));
      const __m256i mask = _mm256_set1_epi8(0x0F);
      for (; p + 32 <= shard_len; p += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i*)(src + p));
        __m256i l = _mm256_and_si256(v, mask);
        __m256i h = _mm256_and_si256(_mm256_srli_epi64(v, 4), mask);
        __m256i r = _mm256_xor_si256(_mm256_shuffle_epi8(tlo, l),
                                     _mm256_shuffle_epi8(thi, h));
        __m256i acc = _mm256_loadu_si256((const __m256i*)(dst + p));
        _mm256_storeu_si256((__m256i*)(dst + p), _mm256_xor_si256(acc, r));
      }
#endif
      const uint8_t* mrow = T.mul[c];
      for (; p < shard_len; p++) dst[p] ^= mrow[src[p]];
    }
  }
}

int gf256_has_avx2(void) {
#ifdef __AVX2__
  return 1;
#else
  return 0;
#endif
}

}  // extern "C"
