// AES-256-GCM (NIST SP 800-38D, 96-bit nonces, 16-byte tags) with AES-NI
// and PCLMULQDQ: the host engine of the SSE package cipher AES256-GCM, the
// OEK envelope of such objects and the KMS's data-key seal. The JAX package
// gets the same function from the `cryptography` wheel; the port may not
// depend on it, so this file is its own engine, byte-identical to it.
//
// Only the functions below carry the target attribute, so the file builds
// at every step of the g++ flag ladder; aesgcm_cpu_ok() says whether this
// CPU may call them (the Python binding checks it before the first call and
// raises otherwise: there is no table-driven fallback, whose key-dependent
// lookups leak timing).
//
// Layout: J0 = nonce || 0^31 1; the payload is CTR from inc32(J0); the tag
// is E(K, J0) ^ GHASH_H(A || pad || C || pad || len64(A) || len64(C)) with
// H = E(K, 0^128). GHASH folds one block at a time (carry-less multiply of
// byte-reflected operands, then the shift-and-reduce of Gueron and
// Kounavis, Intel white paper 323640); CTR runs four blocks at a time.
//
// The package entries (aesgcm_seal_pkgs / aesgcm_open_pkgs) take a block of
// SSE packages in one call and derive each package's nonce and AAD as
// minio_tpu/crypto/sse.py _nonce/_aad do:
//   nonce_i = base_iv[0:8] || BE32(seq0 + i)
//   aad_i   = "minio-tpu-sse-v1" || BE32(seq0 + i)
#include <immintrin.h>

#include <cstdint>
#include <cstring>

#define AESGCM_TARGET __attribute__((target("aes,pclmul,sse4.1")))

namespace {

struct Aes256 {
  __m128i rk[15];
};

#define AES256_ASSIST(t1, t2, t3, rcon, ks, i)                       \
  do {                                                               \
    __m128i t4;                                                      \
    t2 = _mm_aeskeygenassist_si128(t3, rcon);                        \
    t2 = _mm_shuffle_epi32(t2, 0xff);                                \
    t4 = _mm_slli_si128(t1, 4);                                      \
    t1 = _mm_xor_si128(t1, t4);                                      \
    t4 = _mm_slli_si128(t4, 4);                                      \
    t1 = _mm_xor_si128(t1, t4);                                      \
    t4 = _mm_slli_si128(t4, 4);                                      \
    t1 = _mm_xor_si128(t1, t4);                                      \
    t1 = _mm_xor_si128(t1, t2);                                      \
    ks[i] = t1;                                                      \
    if (i < 14) {                                                    \
      t4 = _mm_aeskeygenassist_si128(t1, 0x00);                      \
      t2 = _mm_shuffle_epi32(t4, 0xaa);                              \
      t4 = _mm_slli_si128(t3, 4);                                    \
      t3 = _mm_xor_si128(t3, t4);                                    \
      t4 = _mm_slli_si128(t4, 4);                                    \
      t3 = _mm_xor_si128(t3, t4);                                    \
      t4 = _mm_slli_si128(t4, 4);                                    \
      t3 = _mm_xor_si128(t3, t4);                                    \
      t3 = _mm_xor_si128(t3, t2);                                    \
      ks[i + 1] = t3;                                                \
    }                                                                \
  } while (0)

AESGCM_TARGET void aes256_expand(const uint8_t key[32], Aes256* a) {
  __m128i t1 = _mm_loadu_si128((const __m128i*)key);
  __m128i t3 = _mm_loadu_si128((const __m128i*)(key + 16));
  __m128i t2;
  __m128i* ks = a->rk;
  ks[0] = t1;
  ks[1] = t3;
  AES256_ASSIST(t1, t2, t3, 0x01, ks, 2);
  AES256_ASSIST(t1, t2, t3, 0x02, ks, 4);
  AES256_ASSIST(t1, t2, t3, 0x04, ks, 6);
  AES256_ASSIST(t1, t2, t3, 0x08, ks, 8);
  AES256_ASSIST(t1, t2, t3, 0x10, ks, 10);
  AES256_ASSIST(t1, t2, t3, 0x20, ks, 12);
  AES256_ASSIST(t1, t2, t3, 0x40, ks, 14);
}

AESGCM_TARGET inline __m128i aes256_block(const Aes256& a, __m128i x) {
  x = _mm_xor_si128(x, a.rk[0]);
  for (int r = 1; r < 14; r++) x = _mm_aesenc_si128(x, a.rk[r]);
  return _mm_aesenclast_si128(x, a.rk[14]);
}

AESGCM_TARGET inline __m128i bswap128(__m128i x) {
  const __m128i m =
      _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  return _mm_shuffle_epi8(x, m);
}

// a * b in GF(2^128) on byte-reflected operands (GHASH's bit order)
AESGCM_TARGET inline __m128i gfmul(__m128i a, __m128i b) {
  __m128i t2, t3, t4, t5, t6, t7, t8, t9;
  t3 = _mm_clmulepi64_si128(a, b, 0x00);
  t4 = _mm_clmulepi64_si128(a, b, 0x10);
  t5 = _mm_clmulepi64_si128(a, b, 0x01);
  t6 = _mm_clmulepi64_si128(a, b, 0x11);
  t4 = _mm_xor_si128(t4, t5);
  t5 = _mm_slli_si128(t4, 8);
  t4 = _mm_srli_si128(t4, 8);
  t3 = _mm_xor_si128(t3, t5);
  t6 = _mm_xor_si128(t6, t4);
  // shift the 256-bit product left by one
  t7 = _mm_srli_epi32(t3, 31);
  t8 = _mm_srli_epi32(t6, 31);
  t3 = _mm_slli_epi32(t3, 1);
  t6 = _mm_slli_epi32(t6, 1);
  t9 = _mm_srli_si128(t7, 12);
  t8 = _mm_slli_si128(t8, 4);
  t7 = _mm_slli_si128(t7, 4);
  t3 = _mm_or_si128(t3, t7);
  t6 = _mm_or_si128(t6, t8);
  t6 = _mm_or_si128(t6, t9);
  // reduce modulo x^128 + x^7 + x^2 + x + 1
  t7 = _mm_slli_epi32(t3, 31);
  t8 = _mm_slli_epi32(t3, 30);
  t9 = _mm_slli_epi32(t3, 25);
  t7 = _mm_xor_si128(t7, t8);
  t7 = _mm_xor_si128(t7, t9);
  t8 = _mm_srli_si128(t7, 4);
  t7 = _mm_slli_si128(t7, 12);
  t3 = _mm_xor_si128(t3, t7);
  t2 = _mm_srli_epi32(t3, 1);
  t4 = _mm_srli_epi32(t3, 2);
  t5 = _mm_srli_epi32(t3, 7);
  t2 = _mm_xor_si128(t2, t4);
  t2 = _mm_xor_si128(t2, t5);
  t2 = _mm_xor_si128(t2, t8);
  t3 = _mm_xor_si128(t3, t2);
  return _mm_xor_si128(t6, t3);
}

// X <- (X ^ block) * H over len bytes, the last block zero-padded
AESGCM_TARGET inline __m128i ghash(__m128i x, __m128i h, const uint8_t* p,
                                   long len) {
  long i = 0;
  for (; i + 16 <= len; i += 16) {
    __m128i b = bswap128(_mm_loadu_si128((const __m128i*)(p + i)));
    x = gfmul(_mm_xor_si128(x, b), h);
  }
  if (i < len) {
    alignas(16) uint8_t last[16] = {0};
    memcpy(last, p + i, len - i);
    __m128i b = bswap128(_mm_load_si128((const __m128i*)last));
    x = gfmul(_mm_xor_si128(x, b), h);
  }
  return x;
}

// counter block with its low 32 bits (big-endian) set to ctr
AESGCM_TARGET inline __m128i ctr_block(const uint8_t nonce[12],
                                       uint32_t ctr) {
  alignas(16) uint8_t b[16];
  memcpy(b, nonce, 12);
  b[12] = (uint8_t)(ctr >> 24);
  b[13] = (uint8_t)(ctr >> 16);
  b[14] = (uint8_t)(ctr >> 8);
  b[15] = (uint8_t)ctr;
  return _mm_load_si128((const __m128i*)b);
}

// dst = src ^ keystream from counter 2 (inc32 of J0)
AESGCM_TARGET void ctr_xor(const Aes256& a, const uint8_t nonce[12],
                           const uint8_t* src, uint8_t* dst, long len) {
  uint32_t ctr = 2;
  long i = 0;
  for (; i + 64 <= len; i += 64, ctr += 4) {
    __m128i k0 = aes256_block(a, ctr_block(nonce, ctr));
    __m128i k1 = aes256_block(a, ctr_block(nonce, ctr + 1));
    __m128i k2 = aes256_block(a, ctr_block(nonce, ctr + 2));
    __m128i k3 = aes256_block(a, ctr_block(nonce, ctr + 3));
    const __m128i* s = (const __m128i*)(src + i);
    __m128i* d = (__m128i*)(dst + i);
    _mm_storeu_si128(d, _mm_xor_si128(_mm_loadu_si128(s), k0));
    _mm_storeu_si128(d + 1, _mm_xor_si128(_mm_loadu_si128(s + 1), k1));
    _mm_storeu_si128(d + 2, _mm_xor_si128(_mm_loadu_si128(s + 2), k2));
    _mm_storeu_si128(d + 3, _mm_xor_si128(_mm_loadu_si128(s + 3), k3));
  }
  for (; i < len; i += 16, ctr++) {
    alignas(16) uint8_t ks[16];
    _mm_store_si128((__m128i*)ks, aes256_block(a, ctr_block(nonce, ctr)));
    long n = len - i < 16 ? len - i : 16;
    for (long j = 0; j < n; j++) dst[i + j] = src[i + j] ^ ks[j];
  }
}

// the 16-byte tag over aad and ciphertext ct
AESGCM_TARGET void gcm_tag(const Aes256& a, __m128i h,
                           const uint8_t nonce[12], const uint8_t* aad,
                           long aad_len, const uint8_t* ct, long ct_len,
                           uint8_t tag[16]) {
  __m128i x = _mm_setzero_si128();
  x = ghash(x, h, aad, aad_len);
  x = ghash(x, h, ct, ct_len);
  alignas(16) uint8_t lens[16];
  uint64_t abits = (uint64_t)aad_len * 8, cbits = (uint64_t)ct_len * 8;
  for (int j = 0; j < 8; j++) {
    lens[j] = (uint8_t)(abits >> (56 - 8 * j));
    lens[8 + j] = (uint8_t)(cbits >> (56 - 8 * j));
  }
  x = ghash(x, h, lens, 16);
  __m128i s = _mm_xor_si128(bswap128(x), aes256_block(a, ctr_block(nonce, 1)));
  _mm_storeu_si128((__m128i*)tag, s);
}

AESGCM_TARGET inline __m128i hash_key(const Aes256& a) {
  return bswap128(aes256_block(a, _mm_setzero_si128()));
}

// 0 when the tags agree; no early exit on the first differing byte
inline int tag_diff(const uint8_t* a, const uint8_t* b) {
  uint8_t d = 0;
  for (int j = 0; j < 16; j++) d |= a[j] ^ b[j];
  return d != 0;
}

const char kPkgAad[16] = {'m', 'i', 'n', 'i', 'o', '-', 't', 'p',
                          'u', '-', 's', 's', 'e', '-', 'v', '1'};

inline void pkg_nonce_aad(const uint8_t base_iv[8], uint32_t seq,
                          uint8_t nonce[12], uint8_t aad[20]) {
  memcpy(nonce, base_iv, 8);
  memcpy(aad, kPkgAad, 16);
  for (int j = 0; j < 4; j++)
    nonce[8 + j] = aad[16 + j] = (uint8_t)(seq >> (24 - 8 * j));
}

}  // namespace

extern "C" {

// 1 when this CPU has AES-NI, PCLMULQDQ and SSE4.1
int aesgcm_cpu_ok() {
  __builtin_cpu_init();
  return __builtin_cpu_supports("aes") && __builtin_cpu_supports("pclmul") &&
         __builtin_cpu_supports("sse4.1");
}

// out[0:len+16] = ciphertext || tag of pt[0:len]
AESGCM_TARGET void aesgcm_seal(const uint8_t* key, const uint8_t* nonce,
                               const uint8_t* aad, long aad_len,
                               const uint8_t* pt, long len, uint8_t* out) {
  Aes256 a;
  aes256_expand(key, &a);
  ctr_xor(a, nonce, pt, out, len);
  gcm_tag(a, hash_key(a), nonce, aad, aad_len, out, len, out + len);
}

// sealed[0:len+16] -> out[0:len]; 0 on success, -1 (nothing written) when
// the tag does not verify
AESGCM_TARGET int aesgcm_open(const uint8_t* key, const uint8_t* nonce,
                              const uint8_t* aad, long aad_len,
                              const uint8_t* sealed, long len, uint8_t* out) {
  Aes256 a;
  aes256_expand(key, &a);
  uint8_t tag[16];
  gcm_tag(a, hash_key(a), nonce, aad, aad_len, sealed, len, tag);
  if (tag_diff(tag, sealed + len)) return -1;
  ctr_xor(a, nonce, sealed, out, len);
  return 0;
}

// seal n SSE packages src[i][0:lens[i]] into dst[i][0:lens[i]+16]; only
// the first 8 bytes of base_iv are read
AESGCM_TARGET void aesgcm_seal_pkgs(const uint8_t* key,
                                    const uint8_t* base_iv, uint32_t seq0,
                                    const uint8_t* const* src,
                                    const long* lens, int n,
                                    uint8_t* const* dst) {
  Aes256 a;
  aes256_expand(key, &a);
  __m128i h = hash_key(a);
  for (int i = 0; i < n; i++) {
    uint8_t nonce[12], aad[20];
    pkg_nonce_aad(base_iv, seq0 + (uint32_t)i, nonce, aad);
    ctr_xor(a, nonce, src[i], dst[i], lens[i]);
    gcm_tag(a, h, nonce, aad, 20, dst[i], lens[i], dst[i] + lens[i]);
  }
}

// open n sealed packages src[i][0:lens[i]] (tags included) into
// dst[i][0:lens[i]-16]. Every tag is checked before any plaintext is
// written: returns -1 when all verify, else the index of the first package
// whose tag (or length) does not, with dst untouched.
AESGCM_TARGET int aesgcm_open_pkgs(const uint8_t* key, const uint8_t* base_iv,
                                   uint32_t seq0, const uint8_t* const* src,
                                   const long* lens, int n,
                                   uint8_t* const* dst) {
  Aes256 a;
  aes256_expand(key, &a);
  __m128i h = hash_key(a);
  int bad = -1;
  for (int i = 0; i < n; i++) {
    uint8_t nonce[12], aad[20], tag[16];
    if (lens[i] < 16) {
      if (bad < 0) bad = i;
      continue;
    }
    pkg_nonce_aad(base_iv, seq0 + (uint32_t)i, nonce, aad);
    gcm_tag(a, h, nonce, aad, 20, src[i], lens[i] - 16, tag);
    if (tag_diff(tag, src[i] + lens[i] - 16) && bad < 0) bad = i;
  }
  if (bad >= 0) return bad;
  for (int i = 0; i < n; i++) {
    uint8_t nonce[12], aad[20];
    pkg_nonce_aad(base_iv, seq0 + (uint32_t)i, nonce, aad);
    ctr_xor(a, nonce, src[i], dst[i], lens[i] - 16);
  }
  return -1;
}

}  // extern "C"
