// MUR3X256 — the TPU-build's native streaming-bitrot hash: two
// independently-seeded MurmurHash3_x86_128 instances (Austin Appleby's
// public-domain algorithm, re-implemented from the spec) concatenated into
// a 256-bit digest.
//
// Why this exists: the reference's default bitrot algorithm (HighwayHash)
// was chosen because it is fast on AVX2 — a hardware-fit decision. The TPU
// has no uint64, so HighwayHash on device costs ~8x its GF math in (lo,hi)
// uint32 emulation. MurmurHash3_x86_128 is built ENTIRELY from u32
// multiply/rotate/add/xor — exactly the VPU's native ops — so the fused
// verify+reconstruct launch (BASELINE config 4) hashes at VPU rate. Same
// hardware-fit reasoning, this hardware. HighwayHash remains supported for
// objects written with it.
//
// Bit-identical implementations: this file (CPU), minio_tpu/ops/mur3_jax.py
// (device), and the pure-Python fallback in minio_tpu/native/mur3py.py —
// pinned against each other and recorded vectors in tests.
//
// Exposed C ABI (ctypes-consumed by minio_tpu.native):
//   mur3x256(seed_key, data, len, out32)                one-shot digest
//   mur3x256_batch(seed_key, data, n, stride, len, out) n equal chunks
//   mur3x256_many(seed_key, ptrs, lens, n, out)         n scattered chunks
// seed_key is the 32-byte bitrot key; seeds = LE u32 words 0 and 4.
#include <cstdint>
#include <cstring>

namespace mur3 {

inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);  // little-endian hosts
  return v;
}

const uint32_t c1 = 0x239b961bu, c2 = 0xab0e9789u, c3 = 0x38b34ae5u,
               c4 = 0xa1e38b93u;

// One MurmurHash3_x86_128 over data[0:len] with the given seed; out[4] u32.
inline void x86_128(uint32_t seed, const uint8_t* data, long len,
                    uint32_t out[4]) {
  uint32_t h1 = seed, h2 = seed, h3 = seed, h4 = seed;
  const long nblocks = len / 16;
  for (long i = 0; i < nblocks; i++) {
    const uint8_t* p = data + i * 16;
    uint32_t k1 = read32(p), k2 = read32(p + 4), k3 = read32(p + 8),
             k4 = read32(p + 12);
    k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h1 ^= k1;
    h1 = rotl32(h1, 19); h1 += h2; h1 = h1 * 5 + 0x561ccd1bu;
    k2 *= c2; k2 = rotl32(k2, 16); k2 *= c3; h2 ^= k2;
    h2 = rotl32(h2, 17); h2 += h3; h2 = h2 * 5 + 0x0bcaa747u;
    k3 *= c3; k3 = rotl32(k3, 17); k3 *= c4; h3 ^= k3;
    h3 = rotl32(h3, 15); h3 += h4; h3 = h3 * 5 + 0x96cd1c35u;
    k4 *= c4; k4 = rotl32(k4, 18); k4 *= c1; h4 ^= k4;
    h4 = rotl32(h4, 13); h4 += h1; h4 = h4 * 5 + 0x32ac3b17u;
  }
  // tail
  const uint8_t* tail = data + nblocks * 16;
  uint32_t k1 = 0, k2 = 0, k3 = 0, k4 = 0;
  switch (len & 15) {
    case 15: k4 ^= (uint32_t)tail[14] << 16; [[fallthrough]];
    case 14: k4 ^= (uint32_t)tail[13] << 8; [[fallthrough]];
    case 13: k4 ^= (uint32_t)tail[12];
             k4 *= c4; k4 = rotl32(k4, 18); k4 *= c1; h4 ^= k4;
             [[fallthrough]];
    case 12: k3 ^= (uint32_t)tail[11] << 24; [[fallthrough]];
    case 11: k3 ^= (uint32_t)tail[10] << 16; [[fallthrough]];
    case 10: k3 ^= (uint32_t)tail[9] << 8; [[fallthrough]];
    case 9:  k3 ^= (uint32_t)tail[8];
             k3 *= c3; k3 = rotl32(k3, 17); k3 *= c4; h3 ^= k3;
             [[fallthrough]];
    case 8:  k2 ^= (uint32_t)tail[7] << 24; [[fallthrough]];
    case 7:  k2 ^= (uint32_t)tail[6] << 16; [[fallthrough]];
    case 6:  k2 ^= (uint32_t)tail[5] << 8; [[fallthrough]];
    case 5:  k2 ^= (uint32_t)tail[4];
             k2 *= c2; k2 = rotl32(k2, 16); k2 *= c3; h2 ^= k2;
             [[fallthrough]];
    case 4:  k1 ^= (uint32_t)tail[3] << 24; [[fallthrough]];
    case 3:  k1 ^= (uint32_t)tail[2] << 16; [[fallthrough]];
    case 2:  k1 ^= (uint32_t)tail[1] << 8; [[fallthrough]];
    case 1:  k1 ^= (uint32_t)tail[0];
             k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h1 ^= k1;
  }
  h1 ^= (uint32_t)len; h2 ^= (uint32_t)len;
  h3 ^= (uint32_t)len; h4 ^= (uint32_t)len;
  h1 += h2 + h3 + h4; h2 += h1; h3 += h1; h4 += h1;
  h1 = fmix32(h1); h2 = fmix32(h2); h3 = fmix32(h3); h4 = fmix32(h4);
  h1 += h2 + h3 + h4; h2 += h1; h3 += h1; h4 += h1;
  out[0] = h1; out[1] = h2; out[2] = h3; out[3] = h4;
}

inline void digest256(const uint8_t key[32], const uint8_t* data, long len,
                      uint8_t out[32]) {
  uint32_t s1, s2;
  std::memcpy(&s1, key, 4);
  std::memcpy(&s2, key + 16, 4);
  uint32_t h[8];
  x86_128(s1, data, len, h);
  x86_128(s2 ^ 0x9e3779b9u, data, len, h + 4);
  std::memcpy(out, h, 32);
}

}  // namespace mur3

extern "C" {

void mur3x256(const uint8_t key[32], const uint8_t* data, long len,
              uint8_t out[32]) {
  mur3::digest256(key, data, len, out);
}

void mur3x256_batch(const uint8_t key[32], const uint8_t* data, int n,
                    long stride, long len, uint8_t* out) {
  for (int i = 0; i < n; i++)
    mur3::digest256(key, data + (size_t)i * stride, len, out + (size_t)i * 32);
}

void mur3x256_many(const uint8_t key[32], const uint8_t* const* ptrs,
                   const long* lens, int n, uint8_t* out) {
  for (int i = 0; i < n; i++)
    mur3::digest256(key, ptrs[i], lens[i], out + (size_t)i * 32);
}

}  // extern "C"
