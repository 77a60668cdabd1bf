// Snappy blocks and CRC32C for the S2/snappy frame format of transparent
// object compression (utils/compress.py). The JAX package runs the same
// two functions in pure Python (utils/snappy.py, a byte-at-a-time CRC32C):
// this file computes the same bytes at native speed, so a stream either
// package writes for one input is byte for byte the other's.
//
// snappy_compress is the greedy compressor of utils/snappy.py, step for
// step: at each visited position i the 4 bytes there look up the last
// visited position holding the same 4 bytes (an exact table, not a lossy
// hash); a candidate within 65,535 bytes starts a match, extended while
// bytes agree up to 64 long; the pending literal goes out first, then the
// copy (tag 1 when 4 <= len <= 11 and offset < 2048, else tag 2); the
// position advances past the match, or by one. Positions a match skips are
// never entered in the table.
//
// snappy_decompress decodes every element kind of the snappy block format
// (literals, copies with 1-, 2- and 4-byte offsets, overlapping copies
// byte by byte) and fails on the cases utils/snappy.py raises for.
//
// crc32c is CRC-32/Castagnoli (reflected, polynomial 0x82F63B78): the
// SSE4.2 instruction where the build targets it, else slicing by 8.
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

uint32_t g_crc_tab[8][256];
bool g_crc_init = false;

void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    g_crc_tab[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      g_crc_tab[t][i] =
          (g_crc_tab[t - 1][i] >> 8) ^ g_crc_tab[0][g_crc_tab[t - 1][i] & 0xFF];
  g_crc_init = true;
}

struct InitCrc {
  InitCrc() { crc_init(); }
} g_init_crc;

inline size_t put_literal(uint8_t* out, size_t o, const uint8_t* src,
                          size_t lo, size_t hi) {
  size_t ln = hi - lo - 1;
  if (ln < 60) {
    out[o++] = uint8_t(ln << 2);
  } else if (ln < (1u << 8)) {
    out[o++] = 60 << 2;
    out[o++] = uint8_t(ln);
  } else if (ln < (1u << 16)) {
    out[o++] = 61 << 2;
    out[o++] = uint8_t(ln);
    out[o++] = uint8_t(ln >> 8);
  } else if (ln < (1u << 24)) {
    out[o++] = 62 << 2;
    out[o++] = uint8_t(ln);
    out[o++] = uint8_t(ln >> 8);
    out[o++] = uint8_t(ln >> 16);
  } else {
    out[o++] = 63 << 2;
    out[o++] = uint8_t(ln);
    out[o++] = uint8_t(ln >> 8);
    out[o++] = uint8_t(ln >> 16);
    out[o++] = uint8_t(ln >> 24);
  }
  std::memcpy(out + o, src + lo, hi - lo);
  return o + (hi - lo);
}

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

}  // namespace

extern "C" {

uint32_t crc32c(const uint8_t* p, long n) {
  uint32_t c = 0xFFFFFFFFu;
#if defined(__SSE4_2__)
  uint64_t c64 = c;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c64 = _mm_crc32_u64(c64, v);
    p += 8;
    n -= 8;
  }
  c = uint32_t(c64);
  while (n-- > 0) c = _mm_crc32_u8(c, *p++);
#else
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = g_crc_tab[7][lo & 0xFF] ^ g_crc_tab[6][(lo >> 8) & 0xFF] ^
        g_crc_tab[5][(lo >> 16) & 0xFF] ^ g_crc_tab[4][lo >> 24] ^
        g_crc_tab[3][hi & 0xFF] ^ g_crc_tab[2][(hi >> 8) & 0xFF] ^
        g_crc_tab[1][(hi >> 16) & 0xFF] ^ g_crc_tab[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) c = g_crc_tab[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
#endif
  return c ^ 0xFFFFFFFFu;
}

// Upper bound of snappy_compress's output for n input bytes.
long snappy_max_compressed(long n) { return 32 + n + n / 6; }

// Compresses src[0:n) into out (at least snappy_max_compressed(n) bytes);
// returns the compressed length. n must be below 2^31.
long snappy_compress(const uint8_t* src, long n, uint8_t* out) {
  size_t o = 0;
  uint64_t v = uint64_t(n);
  while (v >= 0x80) {
    out[o++] = uint8_t((v & 0x7F) | 0x80);
    v >>= 7;
  }
  out[o++] = uint8_t(v);
  if (n < 4) {
    if (n > 0) o = put_literal(out, o, src, 0, size_t(n));
    return long(o);
  }
  // exact map from the 4 bytes at a visited position to that position:
  // open addressing over (key, position) pairs, at most half full
  size_t cap = 1024;
  while (cap < size_t(n) * 2) cap <<= 1;
  thread_local std::vector<uint32_t> keys;
  thread_local std::vector<int32_t> pos;
  if (keys.size() < cap) {
    keys.resize(cap);
    pos.resize(cap);
  }
  std::fill(pos.begin(), pos.begin() + cap, -1);
  const size_t mask = cap - 1;
  long i = 0, lit = 0;
  while (i + 4 <= n) {
    uint32_t key = load32(src + i);
    size_t h = (uint32_t(key * 0x1E35A7BDu) >> 7) & mask;
    while (pos[h] >= 0 && keys[h] != key) h = (h + 1) & mask;
    long cand = pos[h];
    keys[h] = key;
    pos[h] = int32_t(i);
    if (cand >= 0 && i - cand <= 0xFFFF) {
      long ln = 4;
      while (i + ln < n && ln < 64 && src[cand + ln] == src[i + ln]) ln++;
      if (lit < i) o = put_literal(out, o, src, size_t(lit), size_t(i));
      long off = i - cand;
      if (ln <= 11 && off < 2048) {
        out[o++] = uint8_t(1 | ((ln - 4) << 2) | ((off >> 8) << 5));
        out[o++] = uint8_t(off & 0xFF);
      } else {
        out[o++] = uint8_t(2 | ((ln - 1) << 2));
        out[o++] = uint8_t(off & 0xFF);
        out[o++] = uint8_t(off >> 8);
      }
      i += ln;
      lit = i;
    } else {
      i += 1;
    }
  }
  if (lit < n) o = put_literal(out, o, src, size_t(lit), size_t(n));
  return long(o);
}

// The uncompressed length a snappy block declares, or -1 when its varint
// is truncated or over 2^32.
long snappy_uncompressed_length(const uint8_t* src, long n) {
  uint64_t out = 0;
  int shift = 0;
  for (long i = 0; i < n && shift < 35; i++) {
    out |= uint64_t(src[i] & 0x7F) << shift;
    if (!(src[i] & 0x80)) return out > 0xFFFFFFFFull ? -1 : long(out);
    shift += 7;
  }
  return -1;
}

// Decodes the snappy block src[0:n) into dst (cap bytes, the declared
// length); returns the decoded length, or a negative code: -1 truncated
// varint, -2 truncated literal, -3 truncated copy offset, -4 invalid copy
// offset, -5 a length other than the declared one.
long snappy_decompress(const uint8_t* src, long n, uint8_t* dst, long cap) {
  long total = -1, i = 0;
  {
    uint64_t v = 0;
    int shift = 0;
    for (; i < n; i++) {
      v |= uint64_t(src[i] & 0x7F) << shift;
      shift += 7;
      if (!(src[i] & 0x80)) {
        i++;
        total = long(v);
        break;
      }
      if (shift > 35) return -1;
    }
    if (total < 0) return -1;
  }
  if (total > cap) return -5;
  long o = 0;
  while (i < n) {
    uint8_t tag = src[i++];
    int kind = tag & 3;
    if (kind == 0) {
      long ln = tag >> 2;
      if (ln >= 60) {
        int nb = int(ln) - 59;
        if (i + nb > n) return -2;
        ln = 0;
        for (int b = 0; b < nb; b++) ln |= long(src[i + b]) << (8 * b);
        i += nb;
      }
      ln += 1;
      if (i + ln > n) return -2;
      if (o + ln > total) return -5;
      std::memcpy(dst + o, src + i, size_t(ln));
      o += ln;
      i += ln;
      continue;
    }
    long ln, off;
    if (kind == 1) {
      if (i >= n) return -3;
      ln = ((tag >> 2) & 0x7) + 4;
      off = (long(tag >> 5) << 8) | src[i];
      i += 1;
    } else if (kind == 2) {
      if (i + 2 > n) return -3;
      ln = (tag >> 2) + 1;
      off = long(src[i]) | (long(src[i + 1]) << 8);
      i += 2;
    } else {
      if (i + 4 > n) return -3;
      ln = (tag >> 2) + 1;
      off = long(load32(src + i));
      i += 4;
    }
    if (off == 0 || off > o) return -4;
    if (o + ln > total) return -5;
    if (off >= ln) {
      std::memcpy(dst + o, dst + o - off, size_t(ln));
      o += ln;
    } else {
      for (long b = 0; b < ln; b++, o++) dst[o] = dst[o - off];
    }
  }
  return o == total ? o : -5;
}

}  // extern "C"
