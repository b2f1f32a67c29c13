// Attention dropout's keep mask: one pure function of (seed, plane, query,
// key, p), evaluated where it is used, never stored.
//
// The reference draws `keep = bernoulli(1 - p)` over the softmax weights
// [B, H, S, S] and applies `where(keep, w / (1 - p), 0)` before `w . V`
// (paddle_tpu/ops/fused.py, the XLA composite).  The port regenerates the
// same kind of mask inside the flash-attention forward, dq and dk/dv
// kernels from a counter-based generator, so the backward needs no stored
// mask and the plain PyTorch version (ops/kernels/flash_attention.py
// `dropout_keep_plain`) reproduces it bit for bit.
//
// Generator: Philox4x32-10 (Salmon et al., SC'11; the Random123 constants).
// Key: the call's 64-bit seed.  Counter: (key group k / 8, query q, plane
// b * H + h, step).  `step` is 0, or the 32-bit word at a device pointer the
// call names: the training engine's step counter, which its host writes
// before every step, so one captured CUDA graph draws a new mask at every
// replay with keys that stay launch parameters (the reference draws a new
// key for every step, `split_key`).  One call gives 128 bits, eight 16-bit
// draws: draw e is
// the low (e even) or high (e odd) half of word e / 2 and belongs to key
// 8 * group + e.  (q, k) is kept when its draw is >= round(p * 2^16), so
// the effective p lies within 2^-17 of the requested one; the kept weights
// are scaled by 1 / (1 - p) of the requested p, as in the reference.  The
// layout does not depend on any kernel's tiles, so every kernel, and every
// variant of it, sees the same mask.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ptt {

struct Dropout {
  // the key of each of the ten rounds (the seed's low and high words,
  // bumped by the Weyl constants), made once on the host: the kernels read
  // them as launch parameters instead of adding them up for every call
  uint32_t key[10][2];
  uint32_t threshold;    // round(p * 2^16): a lower draw drops its pair
  float scale;           // 1 / (1 - p)
  const uint32_t* step;  // the counter's fourth word, or nullptr for 0

  // p in [0, 1]; p == 0 keeps everything (the kernels then take their
  // instantiations without dropout).  `step`: a device pointer or nullptr.
  static Dropout make(unsigned long long seed, float p,
                      const void* step = nullptr) {
    Dropout d;
    d.step = static_cast<const uint32_t*>(step);
    d.key[0][0] = static_cast<uint32_t>(seed);
    d.key[0][1] = static_cast<uint32_t>(seed >> 32);
    for (int i = 1; i < 10; ++i) {
      d.key[i][0] = d.key[i - 1][0] + 0x9E3779B9u;
      d.key[i][1] = d.key[i - 1][1] + 0xBB67AE85u;
    }
    d.threshold = static_cast<uint32_t>(floorf(p * 65536.f + 0.5f));
    d.scale = 1.f / (1.f - p);
    return d;
  }
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c,
                                               const uint32_t (&key)[10][2]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint64_t p0 = static_cast<uint64_t>(0xD2511F53u) * c.x;
    const uint64_t p1 = static_cast<uint64_t>(0xCD9E8D57u) * c.z;
    c = make_uint4(static_cast<uint32_t>(p1 >> 32) ^ c.y ^ key[i][0],
                   static_cast<uint32_t>(p1),
                   static_cast<uint32_t>(p0 >> 32) ^ c.w ^ key[i][1],
                   static_cast<uint32_t>(p0));
  }
  return c;
}

// The keep bits of keys 8 * group .. 8 * group + 7 of query q in plane bh:
// bit e for key 8 * group + e.
__device__ __forceinline__ uint32_t keep_byte(const Dropout& d, int bh,
                                              int q, int group) {
  // one read-only load of a uniform address (an L1 hit after the first)
  const uint32_t step = d.step != nullptr ? __ldg(d.step) : 0u;
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(group), static_cast<uint32_t>(q),
                 static_cast<uint32_t>(bh), step),
      d.key);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  uint32_t bits = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t draw = (w[e >> 1] >> (16 * (e & 1))) & 0xffffu;
    bits |= static_cast<uint32_t>(draw >= d.threshold) << e;
  }
  return bits;
}

// Dropout's keep bits for the CUDA-core kernels' rows of 32 keys: the
// row's four threads (part 0-3) draw the tile's four 8-key groups of query
// qi, one each, and share them; bit j keeps key k0 + j (k0 a multiple of
// 32).
__device__ __forceinline__ uint32_t quad_keep_bits(const Dropout& d, int bh,
                                                   int qi, int k0, int part) {
  uint32_t keep = keep_byte(d, bh, qi, (k0 >> 3) + part) << (8 * part);
  keep |= __shfl_xor_sync(0xffffffffu, keep, 1);
  keep |= __shfl_xor_sync(0xffffffffu, keep, 2);
  return keep;
}

// Dropout's keep bits of 32 queries q0 + i (i = lane) against the 8 * kN
// keys key0 + kk of a warp (key0 a multiple of 8), for a lane that holds
// keys key0 + row + 8 * n: keep[n] bit i keeps (q0 + i, key0 + row + 8n).
// Lane i draws query q0 + i's kN groups; ballots turn the bits around.
template <int kN>
__device__ __forceinline__ void column_keep_bits(uint32_t (&keep)[kN],
                                                 const Dropout& d, int bh,
                                                 int q0, int key0, int row) {
  const int lane = threadIdx.x & 31;
  uint32_t mine[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n)
    mine[n] = keep_byte(d, bh, q0 + lane, (key0 >> 3) + n);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const uint32_t col = __ballot_sync(0xffffffffu, (mine[n] >> kk) & 1u);
      if (row == kk) keep[n] = col;
    }
  }
}

// Dropout's keep bits of a warp's 16 rows over a staged tile of kTileN keys
// at k0 (a multiple of kTileN), for lane (g, t): keep[r][h] holds row
// g + 8r's bits of the keys in half h of the tile, bit 8c + i for key
// h * kTileN / 2 + 8c + 2t + i.  Lane l draws the groups of row l % 16 in
// half l / 16, one Philox call for 8 keys, and four shuffles hand every
// lane its rows' words, so no draw is made twice and none is wasted.
template <int kTileN>
__device__ __forceinline__ void row_keep_bits(uint32_t (&keep)[2][2],
                                              const Dropout& d, int bh,
                                              int row0, int k0, int lane) {
  constexpr int kGroups = kTileN / 16;  // 8-key groups in half a tile
  const int g = lane >> 2, t = lane & 3;
  uint32_t mine = 0;
#pragma unroll
  for (int c = 0; c < kGroups; ++c)
    mine |= keep_byte(d, bh, row0 + (lane & 15),
                      (k0 >> 3) + (lane >> 4) * kGroups + c)
            << (8 * c);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      keep[r][h] =
          __shfl_sync(0xffffffffu, mine, g + 8 * r + 16 * h) >> (2 * t);
  }
}

// Whether accumulator entry (j, e) of a 16 x kTileN score tile is kept.
template <int kTileN>
__device__ __forceinline__ bool row_kept(const uint32_t (&keep)[2][2],
                                         int j, int e) {
  constexpr int kGroups = kTileN / 16;
  return (keep[e >> 1][j / kGroups] >> (8 * (j % kGroups) + (e & 1))) & 1u;
}

}  // namespace ptt
