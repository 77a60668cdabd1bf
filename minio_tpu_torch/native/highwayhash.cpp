// HighwayHash — C++ implementation of Google's keyed hash, re-implemented
// from the published algorithm specification. This is the TPU-build's native
// analogue of the reference's assembly-backed minio/highwayhash module
// (SURVEY.md §2.10; used as the default streaming bitrot algorithm
// HighwayHash256S, cmd/bitrot.go:33-51).
//
// Two engines, same algorithm (outputs are bit-identical, pinned by the
// published hh64 test vectors in highwayhash.py):
//   - scalar: portable u64 reference transcription (kept as ground truth)
//   - AVX2: the 4 u64 lanes of the state live in one __m256i each; the
//     32x32->64 multiply is _mm256_mul_epu32 and the byte "zipper merge" is
//     one _mm256_shuffle_epi8 per half — this is the layout the algorithm
//     was designed for and is ~6-8x the scalar rate on one core.
//
// Exposed C ABI (ctypes-consumed by minio_tpu.native):
//   hh256(key, data, len, out32)                   one-shot 256-bit digest
//   hh256_batch(key, data, n, stride, len, out)    n equal-size chunks
//   hh256_multi(key, ptrs, lens, n, out)           n scattered chunks
//   hh64(key, data, len) -> uint64                 published test vectors
#include <cstdint>
#include <cstring>
#include <cstddef>

#ifdef __AVX2__
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// scalar engine (reference transcription)
// ---------------------------------------------------------------------------

struct State {
  uint64_t v0[4];
  uint64_t v1[4];
  uint64_t mul0[4];
  uint64_t mul1[4];
};

inline uint64_t Read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // little-endian hosts only (x86/arm LE)
  return v;
}

// state initialization constants from the published algorithm
const uint64_t kInit0[4] = {0xdbe6d5d5fe4cce2full, 0xa4093822299f31d0ull,
                            0x13198a2e03707344ull, 0x243f6a8885a308d3ull};
const uint64_t kInit1[4] = {0x3bd39e10cb0ef593ull, 0xc0acf169b5f18a8cull,
                            0xbe5466cf34e90c6cull, 0x452821e638d01377ull};

inline void Reset(const uint64_t key[4], State* s) {
  for (int i = 0; i < 4; ++i) {
    s->mul0[i] = kInit0[i];
    s->mul1[i] = kInit1[i];
    s->v0[i] = kInit0[i] ^ key[i];
    s->v1[i] = kInit1[i] ^ ((key[i] >> 32) | (key[i] << 32));
  }
}

inline void ZipperMergeAndAdd(const uint64_t v1, const uint64_t v0,
                              uint64_t* add1, uint64_t* add0) {
  *add0 += (((v0 & 0xff000000ull) | (v1 & 0xff00000000ull)) >> 24) |
           (((v0 & 0xff0000000000ull) | (v1 & 0xff000000000000ull)) >> 16) |
           (v0 & 0xff0000ull) | ((v0 & 0xff00ull) << 32) |
           ((v1 & 0xff00000000000000ull) >> 8) | (v0 << 56);
  *add1 += (((v1 & 0xff000000ull) | (v0 & 0xff00000000ull)) >> 24) |
           (v1 & 0xff0000ull) | ((v1 & 0xff0000000000ull) >> 16) |
           ((v1 & 0xff00ull) << 24) | ((v0 & 0xff000000000000ull) >> 8) |
           ((v1 & 0xffull) << 48) | (v0 & 0xff00000000000000ull);
}

inline void Update(const uint64_t lanes[4], State* s) {
  for (int i = 0; i < 4; ++i) {
    s->v1[i] += s->mul0[i] + lanes[i];
    s->mul0[i] ^= (s->v1[i] & 0xffffffffull) * (s->v0[i] >> 32);
    s->v0[i] += s->mul1[i];
    s->mul1[i] ^= (s->v0[i] & 0xffffffffull) * (s->v1[i] >> 32);
  }
  ZipperMergeAndAdd(s->v1[1], s->v1[0], &s->v0[1], &s->v0[0]);
  ZipperMergeAndAdd(s->v1[3], s->v1[2], &s->v0[3], &s->v0[2]);
  ZipperMergeAndAdd(s->v0[1], s->v0[0], &s->v1[1], &s->v1[0]);
  ZipperMergeAndAdd(s->v0[3], s->v0[2], &s->v1[3], &s->v1[2]);
}

inline void UpdatePacket(const uint8_t* packet, State* s) {
  uint64_t lanes[4] = {Read64(packet), Read64(packet + 8),
                       Read64(packet + 16), Read64(packet + 24)};
  Update(lanes, s);
}

inline void Rotate32By(const uint64_t count, uint64_t lanes[4]) {
  // count is always in [1, 31] here (only called for non-empty remainders)
  for (int i = 0; i < 4; ++i) {
    uint32_t half0 = static_cast<uint32_t>(lanes[i] & 0xffffffffull);
    uint32_t half1 = static_cast<uint32_t>(lanes[i] >> 32);
    lanes[i] = static_cast<uint64_t>(
        (half0 << count) | (half0 >> (32 - count)));
    lanes[i] |= static_cast<uint64_t>(
                    (half1 << count) | (half1 >> (32 - count)))
                << 32;
  }
}

// builds the padded 32-byte packet for a short trailing remainder; shared by
// both engines (byte shuffling, not worth vectorizing)
inline void RemainderPacket(const uint8_t* bytes, const size_t size_mod32,
                            uint8_t packet[32]) {
  const size_t size_mod4 = size_mod32 & 3;
  const uint8_t* remainder = bytes + (size_mod32 & ~3ull);
  std::memset(packet, 0, 32);
  for (size_t i = 0; i < (size_mod32 & ~3ull); ++i) packet[i] = bytes[i];
  if (size_mod32 & 16) {
    for (int i = 0; i < 4; ++i)
      packet[28 + i] = remainder[i + size_mod4 - 4];
  } else if (size_mod4) {
    packet[16 + 0] = remainder[0];
    packet[16 + 1] = remainder[size_mod4 >> 1];
    packet[16 + 2] = remainder[size_mod4 - 1];
  }
}

inline void UpdateRemainder(const uint8_t* bytes, const size_t size_mod32,
                            State* s) {
  uint8_t packet[32];
  RemainderPacket(bytes, size_mod32, packet);
  for (int i = 0; i < 4; ++i)
    s->v0[i] += (static_cast<uint64_t>(size_mod32) << 32) + size_mod32;
  Rotate32By(size_mod32, s->v1);
  UpdatePacket(packet, s);
}

inline void ProcessAll(const uint64_t key[4], const uint8_t* data,
                       size_t size, State* s) {
  Reset(key, s);
  size_t i = 0;
  for (; i + 32 <= size; i += 32) UpdatePacket(data + i, s);
  if (size & 31) UpdateRemainder(data + i, size & 31, s);
}

inline void Permute(const uint64_t v[4], uint64_t* permuted) {
  permuted[0] = (v[2] >> 32) | (v[2] << 32);
  permuted[1] = (v[3] >> 32) | (v[3] << 32);
  permuted[2] = (v[0] >> 32) | (v[0] << 32);
  permuted[3] = (v[1] >> 32) | (v[1] << 32);
}

inline void PermuteAndUpdate(State* s) {
  uint64_t permuted[4];
  Permute(s->v0, permuted);
  Update(permuted, s);
}

inline void ModularReduction(uint64_t a3_unmasked, uint64_t a2, uint64_t a1,
                             uint64_t a0, uint64_t* m1, uint64_t* m0) {
  const uint64_t a3 = a3_unmasked & 0x3fffffffffffffffull;
  *m1 = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
  *m0 = a0 ^ (a2 << 1) ^ (a2 << 2);
}

inline void Finalize256(State* s, uint64_t hash[4]) {
  for (int i = 0; i < 10; ++i) PermuteAndUpdate(s);
  ModularReduction(s->v1[1] + s->mul1[1], s->v1[0] + s->mul1[0],
                   s->v0[1] + s->mul0[1], s->v0[0] + s->mul0[0], &hash[1],
                   &hash[0]);
  ModularReduction(s->v1[3] + s->mul1[3], s->v1[2] + s->mul1[2],
                   s->v0[3] + s->mul0[3], s->v0[2] + s->mul0[2], &hash[3],
                   &hash[2]);
}

inline void hh256_scalar(const uint64_t key[4], const uint8_t* data,
                         size_t size, uint8_t out[32]) {
  State s;
  ProcessAll(key, data, size, &s);
  uint64_t hash[4];
  Finalize256(&s, hash);
  std::memcpy(out, hash, 32);
}

#ifdef __AVX2__

// ---------------------------------------------------------------------------
// AVX2 engine: one __m256i per state row, 64-bit lane i == scalar index i
// ---------------------------------------------------------------------------

struct VState {
  __m256i v0, v1, mul0, mul1;
};

// byte indices (per 128-bit lane) realizing ZipperMergeAndAdd on a (lo,hi)
// u64 pair: low-half result [a3 b4 a2 a5 b6 a1 b7 a0], high-half
// [b3 a4 b2 b5 b1 a6 b0 a7] where a = lane bytes 0-7, b = 8-15 (derived from
// the scalar mask arithmetic above)
inline __m256i ZipperShuffle() {
  return _mm256_setr_epi8(3, 12, 2, 5, 14, 1, 15, 0, 11, 4, 10, 13, 9, 6, 8,
                          7, 3, 12, 2, 5, 14, 1, 15, 0, 11, 4, 10, 13, 9, 6,
                          8, 7);
}

inline void VReset(const uint64_t key[4], VState* s) {
  const __m256i init0 = _mm256_loadu_si256((const __m256i*)kInit0);
  const __m256i init1 = _mm256_loadu_si256((const __m256i*)kInit1);
  const __m256i k = _mm256_loadu_si256((const __m256i*)key);
  // (key >> 32) | (key << 32) == swap 32-bit halves of each u64 lane
  const __m256i krot = _mm256_shuffle_epi32(k, 0xB1);
  s->mul0 = init0;
  s->mul1 = init1;
  s->v0 = _mm256_xor_si256(init0, k);
  s->v1 = _mm256_xor_si256(init1, krot);
}

inline void VUpdate(const __m256i lanes, VState* s) {
  const __m256i zip = ZipperShuffle();
  s->v1 = _mm256_add_epi64(s->v1, _mm256_add_epi64(s->mul0, lanes));
  s->mul0 = _mm256_xor_si256(
      s->mul0, _mm256_mul_epu32(s->v1, _mm256_srli_epi64(s->v0, 32)));
  s->v0 = _mm256_add_epi64(s->v0, s->mul1);
  s->mul1 = _mm256_xor_si256(
      s->mul1, _mm256_mul_epu32(s->v0, _mm256_srli_epi64(s->v1, 32)));
  s->v0 = _mm256_add_epi64(s->v0, _mm256_shuffle_epi8(s->v1, zip));
  s->v1 = _mm256_add_epi64(s->v1, _mm256_shuffle_epi8(s->v0, zip));
}

inline void VUpdatePacket(const uint8_t* packet, VState* s) {
  VUpdate(_mm256_loadu_si256((const __m256i*)packet), s);
}

inline void VUpdateRemainder(const uint8_t* bytes, const size_t size_mod32,
                             VState* s) {
  alignas(32) uint8_t packet[32];
  RemainderPacket(bytes, size_mod32, packet);
  const uint64_t sz = ((uint64_t)size_mod32 << 32) + size_mod32;
  s->v0 = _mm256_add_epi64(s->v0, _mm256_set1_epi64x((long long)sz));
  // rotate the 32-bit halves of v1 left by size_mod32 (in [1, 31])
  const int c = (int)size_mod32;
  s->v1 = _mm256_or_si256(_mm256_slli_epi32(s->v1, c),
                          _mm256_srli_epi32(s->v1, 32 - c));
  VUpdatePacket(packet, s);
}

inline void VPermuteAndUpdate(VState* s) {
  // permuted = [swap32(v0[2]), swap32(v0[3]), swap32(v0[0]), swap32(v0[1])]
  const __m256i p = _mm256_shuffle_epi32(
      _mm256_permute4x64_epi64(s->v0, 0x4E), 0xB1);
  VUpdate(p, s);
}

inline void VFinalize256(VState* s, uint8_t out[32]) {
  for (int i = 0; i < 10; ++i) VPermuteAndUpdate(s);
  alignas(32) uint64_t v0[4], v1[4], mul0[4], mul1[4], hash[4];
  _mm256_store_si256((__m256i*)v0, s->v0);
  _mm256_store_si256((__m256i*)v1, s->v1);
  _mm256_store_si256((__m256i*)mul0, s->mul0);
  _mm256_store_si256((__m256i*)mul1, s->mul1);
  ModularReduction(v1[1] + mul1[1], v1[0] + mul1[0], v0[1] + mul0[1],
                   v0[0] + mul0[0], &hash[1], &hash[0]);
  ModularReduction(v1[3] + mul1[3], v1[2] + mul1[2], v0[3] + mul0[3],
                   v0[2] + mul0[2], &hash[3], &hash[2]);
  std::memcpy(out, hash, 32);
}

inline void hh256_avx2(const uint64_t key[4], const uint8_t* data,
                       size_t size, uint8_t out[32]) {
  VState s;
  VReset(key, &s);
  size_t i = 0;
  for (; i + 32 <= size; i += 32) VUpdatePacket(data + i, &s);
  if (size & 31) VUpdateRemainder(data + i, size & 31, &s);
  VFinalize256(&s, out);
}

// two chunks interleaved: the per-packet dependency chain is latency-bound,
// so running two independent states hides most of it (~1.6x on one core)
inline void hh256_avx2_x2(const uint64_t key[4], const uint8_t* d0, size_t n0,
                          const uint8_t* d1, size_t n1, uint8_t* out0,
                          uint8_t* out1) {
  VState s0, s1;
  VReset(key, &s0);
  VReset(key, &s1);
  const size_t w0 = n0 & ~(size_t)31, w1 = n1 & ~(size_t)31;
  const size_t common = w0 < w1 ? w0 : w1;
  size_t i = 0;
  for (; i < common; i += 32) {
    VUpdatePacket(d0 + i, &s0);
    VUpdatePacket(d1 + i, &s1);
  }
  for (size_t j = i; j < w0; j += 32) VUpdatePacket(d0 + j, &s0);
  for (size_t j = i; j < w1; j += 32) VUpdatePacket(d1 + j, &s1);
  if (n0 & 31) VUpdateRemainder(d0 + w0, n0 & 31, &s0);
  if (n1 & 31) VUpdateRemainder(d1 + w1, n1 & 31, &s1);
  VFinalize256(&s0, out0);
  VFinalize256(&s1, out1);
}

#endif  // __AVX2__

inline void hh256_one(const uint64_t key[4], const uint8_t* data, size_t size,
                      uint8_t out[32]) {
#ifdef __AVX2__
  hh256_avx2(key, data, size, out);
#else
  hh256_scalar(key, data, size, out);
#endif
}

// n scattered chunks, pairwise-interleaved on AVX2
inline void hh256_many(const uint64_t key[4], const uint8_t* const* ptrs,
                       const long* lens, int n, uint8_t* out) {
  int i = 0;
#ifdef __AVX2__
  for (; i + 2 <= n; i += 2)
    hh256_avx2_x2(key, ptrs[i], (size_t)lens[i], ptrs[i + 1],
                  (size_t)lens[i + 1], out + (size_t)i * 32,
                  out + (size_t)(i + 1) * 32);
#endif
  for (; i < n; ++i) hh256_one(key, ptrs[i], (size_t)lens[i], out + (size_t)i * 32);
}

}  // namespace

extern "C" {

void hh256(const uint64_t key[4], const uint8_t* data, long size,
           uint8_t out[32]) {
  hh256_one(key, data, static_cast<size_t>(size), out);
}

// Hash n independent chunks laid out with a fixed stride (chunk i starts at
// data + i*stride, each `size` bytes); out receives n 32-byte digests.
void hh256_batch(const uint64_t key[4], const uint8_t* data, int n,
                 long stride, long size, uint8_t* out) {
  int i = 0;
#ifdef __AVX2__
  for (; i + 2 <= n; i += 2)
    hh256_avx2_x2(key, data + (size_t)i * stride, (size_t)size,
                  data + (size_t)(i + 1) * stride, (size_t)size,
                  out + (size_t)i * 32, out + (size_t)(i + 1) * 32);
#endif
  for (; i < n; ++i)
    hh256_one(key, data + (size_t)i * stride, (size_t)size,
              out + (size_t)i * 32);
}

// Hash n chunks at arbitrary addresses/lengths.
void hh256_multi(const uint64_t key[4], const uint8_t* const* ptrs,
                 const long* lens, int n, uint8_t* out) {
  hh256_many(key, ptrs, lens, n, out);
}

// scalar engine kept callable for the cross-engine equivalence test
void hh256_ref(const uint64_t key[4], const uint8_t* data, long size,
               uint8_t out[32]) {
  hh256_scalar(key, data, static_cast<size_t>(size), out);
}

uint64_t hh64(const uint64_t key[4], const uint8_t* data, long size) {
  State s;
  ProcessAll(key, data, static_cast<size_t>(size), &s);
  for (int i = 0; i < 4; ++i) PermuteAndUpdate(&s);
  return s.v0[0] + s.v1[0] + s.mul0[0] + s.mul1[0];
}

}  // extern "C"
