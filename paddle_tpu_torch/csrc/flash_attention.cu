// Flash-attention forward (FlashAttention-2 style): causal or not, with an
// optional additive float32 bias (the attention mask), over S_q queries and
// S_k keys (self-attention, S_q == S_k; cross-attention and a cached decode
// step, S_q != S_k).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (called
// from `_fwd_call`) in all its forms: causal and not, with and without
// `has_bias`, at any (S_q, S_k).  At the serving path's prefill shapes and
// the training paths' (S = 64 to 1024, 8 or 12 heads of 64) the bound is
// operations, not bytes: each visible (query, key) pair costs 4 * D flops
// against one read of q, k and v.  A decode step (S_q = 1) is bound by the
// bytes of K and V.
//
// Three hand-written kernels; the C entry picks one from the dtype and the
// operands' alignment alone:
//
// `flash_fwd_mma_kernel` (bf16 or float16 whose base pointers and
// (b, s, h) strides are 16-byte multiples: every path of the models, AMP's
// float16 included) does both products on the tensor cores,
// `mma.sync.m16n8k16` with 16-bit operands (the element type T, a template
// parameter: one fragment layout for both) and float32 accumulators.  A
// block owns a tile of 16 to 128 query rows of one (batch, head); each warp owns 16 of them and keeps the score tile
// S = Q K^T, the running max and sum and the output accumulator in
// registers for the whole key loop; the block's Q tile stays in shared
// memory beside the streamed tiles.  K and V tiles of 64 keys (32 at
// D = 128) stay 16-bit in shared memory, filled by 16-byte `cp.async` copies
// in two stages, so the next tile is in flight while this one is
// multiplied; rows are padded by 16 bytes, which spreads the eight rows of
// an `ldmatrix` over all 32 banks.  K fragments come from `ldmatrix`, V's
// from `ldmatrix.trans` (its contracted dimension is the row).  The softmax
// runs in float32 on the accumulators, in the reference's order (scale, add
// the bias, causal replace), the row max over the four lanes of a quad; P
// is rounded to T in registers, as the reference rounds it to V's type,
// and is the A operand of P V as it stands.  The bias is read from device
// memory (L2) at each accumulator entry through its four strides and is
// never folded into a 16-bit operand: a row masked by -1e30 everywhere
// absorbs the dot in float32 and stays a uniform average.  Without a bias
// the scale is folded into the exponent (one FFMA and one ex2 an entry).
// Causal (top-left aligned, as the reference's `_causal_mask`: query i sees
// key j iff j <= i, whatever S_q and S_k): the key loop stops at the tile's
// diagonal, a warp skips key tiles wholly above its rows, and the heaviest
// query tiles are scheduled first.
// The query tile shrinks (128, 64, 32, 16 rows) until the grid has a block
// for every SM, so a one-sequence prefill still spreads over the card.  O
// leaves through the block's Q tile in shared memory as 16-byte stores.
//
// `flash_fwd_tf32x3_kernel` (float32 whose base pointers and (b, s, h)
// strides are 16-byte multiples: the fused qkv's slices of BERT's, GPT's and
// the fleet's float32 paths) is the same design with both products on the
// TF32 tensor cores.  One TF32 product keeps 11 bits of each operand and
// misses the float32 parity limit (2e-5 of the largest output) by far; each
// operand is split into two TF32 terms and three products are summed
// (`mma_tf32x3`, mma.cuh), about 21 bits of each operand at a third of the
// TF32 rate (495 / 3 = 165 TFLOP/s against the CUDA cores' 67).  Details
// at the kernel.
//
// `flash_fwd_kernel` (float32 and 16-bit operands that are not 16-byte
// aligned) runs on the CUDA cores:
// one block per (batch*head, 64-row query tile), 256 threads, four threads
// per query row, each owning D/4 interleaved dims of q and of the output
// accumulator.  K and V tiles of 32 keys are staged in shared memory as
// float32; scores stay in registers; the online softmax runs in float32.
//
// All three: scores follow the reference's `_scores`.  The bias is read
// through four element strides (b, h, q, k), 0 where it is broadcast, so a
// [B, 1, 1, S_k] padding mask is never materialised as [B*H, S_q, S_k] as
// the reference's `_fold_mask` does.  A row with no visible key (an all -inf
// bias) gives 0, as the reference's `l_safe` does.  q is read in paddle's
// [B, S_q, H, D] layout, k and v in [B, S_k, H, D], through strides, so the
// slices of the fused qkv projection need no transpose or copy.  O is
// written [B, S_q, H, D] contiguous in the input dtype, LSE [B*H, S_q]
// float32 (natural log) for the backward.  Any S_q, S_k >= 1: the Pallas
// divisibility and block-size refusals were TPU tiling artefacts.  Query
// rows past S_q (a one-token decode step fills one row of a 16-row tile)
// read zeros and write nothing; keys past S_k are masked in the scores and
// staged as zeros.
//
// Dropout (the reference's composite, paddle_tpu/ops/fused.py: keep =
// bernoulli(1 - p), w = where(keep, w / (1 - p), 0) before w . V) is a
// template flag of every kernel, so p = 0 launches the instantiations
// without it.  The keep mask comes from dropout.cuh, a pure function of
// (seed, b * H + h, q, k): the running sum, and so the LSE, are of the
// weights before dropout, and only the operand of P V takes p * z / (1 - p).
// The tensor-core kernels draw a tile's mask once per warp, one Philox call
// per 8 keys of a row, and hands each lane its fragment's bits by shuffles;
// the CUDA-core kernel's four threads of a row draw one 8-key group each.
#include <math.h>

#include <atomic>

#include "common.cuh"
#include "dropout.cuh"
#include "mma.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kThreads = 256;  // 4 threads per query row

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, long long qb, long long qs,
                     long long qh, long long kb, long long ks, long long kh,
                     long long vb, long long vs, long long vh,
                     T* __restrict__ o, float* __restrict__ lse,
                     ptt::Bias bias, int H, int S_q, int S_k, float sm_scale,
                     bool causal, ptt::Dropout drop) {
  constexpr int kPer = D / 4;
  __shared__ float k_tile[kBlockK][D];
  __shared__ float v_tile[kBlockK][D];
  __shared__ float b_tile[kBlockQ][kBlockK + 1];  // +1: rows in other banks

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int qi = q0 + r;
  const bool has_bias = bias.p != nullptr;

  float qreg[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = i * 4 + part;
    qreg[i] = qi < S_q
                  ? ptt::to_f32(q[b * qb + qi * qs + h * qh + d]) * sm_scale
                  : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const long long k_base = b * kb + h * kh, v_base = b * vb + h * vh;
  // causal: keys up to the tile's diagonal; otherwise every key
  const int k_end = causal ? min(S_k, q0 + kBlockQ) : S_k;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = threadIdx.x; e < kBlockK * D; e += kThreads) {
      const int j = e / D, c = e % D, kj = k0 + j;
      k_tile[j][c] = kj < S_k ? ptt::to_f32(k[k_base + kj * ks + c]) : 0.f;
      v_tile[j][c] = kj < S_k ? ptt::to_f32(v[v_base + kj * vs + c]) : 0.f;
    }
    if (has_bias)
      bias.stage<kBlockQ, kBlockK>(b_tile, b, h, q0, k0, S_q, S_k);
    uint32_t keep = 0;  // dropout: bit j keeps key k0 + j
    if constexpr (kDropout) keep = ptt::quad_keep_bits(drop, bh, qi, k0, part);
    __syncthreads();

    float s[kBlockK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) dot += qreg[i] * k_tile[j][i * 4 + part];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (has_bias) dot += b_tile[r][j];
      const int kj = k0 + j;
      s[j] = (kj < S_k && (!causal || kj <= qi)) ? dot : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    // while every score so far is -inf (an all -inf bias), m_use = 0 keeps
    // exp(-inf - m_use) an exact 0 instead of a NaN
    const float m_new = fmaxf(m, m_tile);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    float p_sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float p = expf(s[j] - m_use);
      p_sum += p;  // the sum (and the LSE) is of the weights before dropout
      if constexpr (kDropout) p = (keep >> j) & 1u ? p * drop.scale : 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] += p * v_tile[j][i * 4 + part];
    }
    l = l * alpha + p_sum;
    m = m_new;
  }

  if (qi < S_q) {
    T* orow = o + ((static_cast<long long>(b) * S_q + qi) * H + h) * D;
    const float l_safe = l == 0.f ? 1.f : l;  // no visible key: O = 0
    const float inv_l = 1.f / l_safe;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      orow[i * 4 + part] = ptt::from_f32<T>(acc[i] * inv_l);
    if (part == 0)
      lse[static_cast<long long>(bh) * S_q + qi] =
          (m == -INFINITY ? 0.f : m) + logf(l_safe);
  }
}

template <typename T, bool kDropout>
int launch(const void* q, const void* k, const void* v, long long qb,
           long long qs, long long qh, long long kb, long long ks,
           long long kh, long long vb, long long vs, long long vh, void* o,
           void* lse, const ptt::Bias& bias, int B, int S_q, int S_k, int H,
           int D, float sm_scale, bool causal, const ptt::Dropout& drop,
           cudaStream_t st) {
  const dim3 grid((S_q + kBlockQ - 1) / kBlockQ, B * H);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  float* lp = static_cast<float*>(lse);
#define PTT_FLASH_CASE(DIM)                                                  \
  case DIM:                                                                  \
    flash_fwd_kernel<T, DIM, kDropout><<<grid, kThreads, 0, st>>>(           \
        qp, kp, vp, qb, qs, qh, kb, ks, kh, vb, vs, vh, op, lp, bias, H, S_q, \
        S_k, sm_scale, causal, drop);                                        \
    break;
  switch (D) {
    PTT_FLASH_CASE(16)
    PTT_FLASH_CASE(32)
    PTT_FLASH_CASE(64)
    PTT_FLASH_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_FLASH_CASE
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the tensor-core kernel
// ---------------------------------------------------------------------------
// Keys per staged tile: 64, or 32 at D = 128, whose output accumulator
// leaves the score tile less room in the registers.
template <int D>
constexpr int kKeys = D == 128 ? 32 : 64;

template <typename T>
struct MmaArgs {
  const T* q;
  const T* k;
  const T* v;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
  T* o;
  float* lse;
  ptt::Bias bias;
  int H, S_q, S_k;  // heads; queries and keys of a plane
  float scale;
  bool causal;
  ptt::Dropout drop;
};

// One 16-row tile's online-softmax step over a staged tile's scores, on the
// accumulators.  In: s = Q K^T (raw dots).  Out: s = p (float32), pf = p
// rounded to T as the A operand of P V; m, l and o brought up to date.
// Lane (g, t) holds rows g (entries 0, 1) and g + 8 (entries 2, 3).
//
// kFast (no bias, scale > 0): the max is taken over the raw dots and
// p = 2^(s * c - m * c) with c = scale * log2(e), one FFMA and one ex2 an
// entry; m is kept in raw units.  Otherwise x = s * scale + bias in natural
// units and p = 2^((x - m) * log2(e)): the difference is formed first, so a
// row masked everywhere by -1e30 gives exactly 2^0 whatever the rounding.
// kDropout: m, l (and so the LSE) are of the weights before dropout; only
// pf takes p * z / (1 - p), z the keep bit of `keep`.
template <typename T, int D, bool kFast, bool kDropout>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kKeys<D> / 8][4], uint32_t (&pf)[kKeys<D> / 16][4],
    float (&o)[D / 8][4], float (&m)[2], float (&l)[2], const MmaArgs<T>& a,
    long long bias_base, int r0, int k0, int t, bool edge,
    const uint32_t (&keep)[2][2]) {
  constexpr int kTileN = kKeys<D>;
  if constexpr (!kFast) {
    const bool has_bias = a.bias.p != nullptr;
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = r0 + (e >> 1) * 8, kj = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * a.scale;
        if (has_bias && qi < a.S_q && kj < a.S_k)
          x += a.bias.p[bias_base + qi * a.bias.q + kj * a.bias.k];
        s[j][e] = x;
      }
    }
  }
  if (edge) {  // keys past S_k, or past a row's diagonal
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = r0 + (e >> 1) * 8, kj = k0 + j * 8 + 2 * t + (e & 1);
        if (kj >= a.S_k || (a.causal && kj > qi)) s[j][e] = -INFINITY;
      }
    }
  }
  float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    m_tile[0] = fmaxf(m_tile[0], fmaxf(s[j][0], s[j][1]));
    m_tile[1] = fmaxf(m_tile[1], fmaxf(s[j][2], s[j][3]));
  }
  const float c = kFast ? a.scale * ptt::kLog2e : ptt::kLog2e;
  float m_use[2], alpha[2], p_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
    m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
    // while every score so far is -inf (an all -inf bias), m_use = 0 keeps
    // exp(-inf - m_use) an exact 0 instead of a NaN
    const float m_new = fmaxf(m[r], m_tile[r]);
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ptt::fast_exp2((m[r] - m_use[r]) * c);
    m[r] = m_new;
  }
  const float mc[2] = {m_use[0] * c, m_use[1] * c};
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = kFast
                          ? ptt::fast_exp2(fmaf(s[j][e], c, -mc[e >> 1]))
                          : ptt::fast_exp2((s[j][e] - m_use[e >> 1]) * c);
      s[j][e] = p;
      p_sum[e >> 1] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + p_sum[r];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
  if constexpr (kDropout) {
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] =
            ptt::row_kept<kTileN>(keep, j, e) ? s[j][e] * a.drop.scale : 0.f;
    }
  }
  // two score tiles side by side are one A operand (16-bit T; the float32
  // kernel reads p from s and leaves pf as it was)
  if constexpr (!std::is_same<T, float>::value) {
#pragma unroll
    for (int kk = 0; kk < kTileN / 16; ++kk) {
      pf[kk][0] = ptt::pack16<T>(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = ptt::pack16<T>(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = ptt::pack16<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = ptt::pack16<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  }
}

// kWarps warps, each owning 16 of the block's kWarps * 16 query rows.
template <typename T, int D, int kWarps, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_mma_kernel(MmaArgs<T> a) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kTileM = kWarps * 16;
  constexpr int kTileN = kKeys<D>;
  constexpr int kLd = D + 8;  // padded row, in elements
  constexpr int kKs = D / 16;  // k-steps of Q K^T; pairs of D tiles of P V
  extern __shared__ __align__(16) unsigned char ptt_smem[];
  T* q_s = reinterpret_cast<T*>(ptt_smem);
  T* k_s = q_s + kTileM * kLd;      // [2][kTileN][kLd]
  T* v_s = k_s + 2 * kTileN * kLd;  // [2][kTileN][kLd]

  const int S_q = a.S_q, S_k = a.S_k;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  // causal: the last query tile walks the most keys, so it goes first
  const int q_tile = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = q_tile * kTileM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;  // the warp's first query
  const bool fast = a.bias.p == nullptr && a.scale > 0.f;
  const long long bias_base = b * a.bias.b + h * a.bias.h;

  const T* q_src = a.q + b * a.qb + h * a.qh;
  const T* k_src = a.k + b * a.kb + h * a.kh;
  const T* v_src = a.v + b * a.vb + h * a.vh;
  // causal: keys up to the tile's diagonal; otherwise every key
  const int k_end = a.causal ? min(S_k, q0 + kTileM) : S_k;
  const int n_tiles = (k_end + kTileN - 1) / kTileN;

  ptt::stage_rows<D, kLd, kTileM, kThreads>(q_s, q_src, a.qs, q0, S_q);
  ptt::stage_rows<D, kLd, kTileN, kThreads>(k_s, k_src, a.ks, 0, S_k);
  ptt::stage_rows<D, kLd, kTileN, kThreads>(v_s, v_src, a.vs, 0, S_k);
  ptt::cp_async_commit();

  // the warp's rows of Q: the A operand, read again for every key tile (128
  // registers at D = 64 leave room for four blocks on an SM)
  T* q_w = q_s + warp * 16 * kLd;
  float o[D / 8][4];
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1, k0 = i * kTileN;
    if (i + 1 < n_tiles) {
      const int next = (stage ^ 1) * kTileN * kLd;
      ptt::stage_rows<D, kLd, kTileN, kThreads>(k_s + next, k_src, a.ks,
                                                k0 + kTileN, S_k);
      ptt::stage_rows<D, kLd, kTileN, kThreads>(v_s + next, v_src, a.vs,
                                                k0 + kTileN, S_k);
    }
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();  // tile i has landed; tile i + 1 is in flight
    __syncthreads();
    // causal: a key tile wholly above the warp's rows changes nothing
    if (!a.causal || k0 <= row0 + 15) {
      const T* kt = k_s + stage * kTileN * kLd;
      const T* vt = v_s + stage * kTileN * kLd;
      float s[kTileN / 8][4];
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      // S = Q K^T: B[d][key] is K's row-major tile as it lies
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t qf[4];
        ptt::ldmatrix_x4(
            qf, q_w + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < kTileN / 16; ++jp) {
          uint32_t kf[4];
          ptt::ldmatrix_x4(kf, kt + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                        kLd +
                                   kk * 16 + ((lane >> 3) & 1) * 8);
          ptt::mma16<T>(s[2 * jp], qf, kf[0], kf[1]);
          ptt::mma16<T>(s[2 * jp + 1], qf, kf[2], kf[3]);
        }
      }
      uint32_t pf[kTileN / 16][4];
      uint32_t keep[2][2];
      if constexpr (kDropout)
        ptt::row_keep_bits<kTileN>(keep, a.drop, bh, row0, k0, lane);
      const bool edge =
          k0 + kTileN > S_k || (a.causal && k0 + kTileN - 1 > row0);
      if (fast)
        softmax_tile<T, D, true, kDropout>(s, pf, o, m, l, a, bias_base,
                                           row0 + g, k0, t, edge, keep);
      else
        softmax_tile<T, D, false, kDropout>(s, pf, o, m, l, a, bias_base,
                                            row0 + g, k0, t, edge, keep);
      // O += P V: B[key][d] contracts V's rows, hence the transposed load
#pragma unroll
      for (int kk = 0; kk < kTileN / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < kKs; ++dp) {
          uint32_t vf[4];
          ptt::ldmatrix_x4_trans(
              vf, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
                      dp * 16 + (lane >> 4) * 8);
          ptt::mma16<T>(o[2 * dp], pf[kk], vf[0], vf[1]);
          ptt::mma16<T>(o[2 * dp + 1], pf[kk], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the copy after next
  }

  // O through the warp's own rows of the Q tile, then 16-byte stores; m is
  // in raw units on the fast path
  const float m_scale = fast ? a.scale : 1.f;
  float inv_l[2], lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float l_safe = sum == 0.f ? 1.f : sum;  // no visible key: O = 0
    inv_l[r] = 1.f / l_safe;
    lse[r] = (m[r] == -INFINITY ? 0.f : m[r] * m_scale) + logf(l_safe);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(q_w + g * kLd + j * 8 + 2 * t) =
        ptt::pack16<T>(o[j][0] * inv_l[0], o[j][1] * inv_l[0]);
    *reinterpret_cast<uint32_t*>(q_w + (g + 8) * kLd + j * 8 + 2 * t) =
        ptt::pack16<T>(o[j][2] * inv_l[1], o[j][3] * inv_l[1]);
  }
  __syncwarp();
  ptt::store_rows_16<D, kLd>(
      q_w, a.o + (static_cast<long long>(b) * S_q * a.H + h) * D,
      static_cast<long long>(a.H) * D, row0, S_q);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + g + r * 8;
      if (qi < S_q) a.lse[static_cast<long long>(bh) * S_q + qi] = lse[r];
    }
  }
}

template <typename T, int D, int kWarps, bool kDropout>
int launch_mma_tile(const MmaArgs<T>& a, int B, cudaStream_t st) {
  constexpr int kTileM = kWarps * 16;
  constexpr int kSmem = (kTileM + 4 * kKeys<D>) * (D + 8) * 2;
  static bool configured = false;  // more than 48 KB needs asking for, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<T, D, kWarps, kDropout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * a.H, (a.S_q + kTileM - 1) / kTileM);
  flash_fwd_mma_kernel<T, D, kWarps, kDropout>
      <<<grid, kWarps * 32, kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The largest query tile that still gives every SM a block (and is not
// mostly padding); 16 rows when no tile does.  With dropout at most 64
// rows: an 8-warp tile with dropout needed about 148 registers a thread,
// which left one block (8 warps) an SM to hide the mask's integer work,
// against three 4-warp blocks (0.124 against 0.095 ms at the GPT causal
// shape on the H100).
template <typename T, int D, bool kDropout>
int launch_mma_dim(const MmaArgs<T>& a, int B, cudaStream_t st) {
  const long long bh = static_cast<long long>(B) * a.H;
  const int sms = ptt::sm_count();
  auto fills = [&](int tile) {
    return a.S_q > tile / 2 && bh * ((a.S_q + tile - 1) / tile) >= sms;
  };
  if constexpr (!kDropout) {
    if (fills(128)) return launch_mma_tile<T, D, 8, false>(a, B, st);
  }
  if (fills(64)) return launch_mma_tile<T, D, 4, kDropout>(a, B, st);
  if (fills(32)) return launch_mma_tile<T, D, 2, kDropout>(a, B, st);
  return launch_mma_tile<T, D, 1, kDropout>(a, B, st);
}

template <typename T, bool kDropout>
int launch_mma(const MmaArgs<T>& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch_mma_dim<T, 16, kDropout>(a, B, st);
    case 32:
      return launch_mma_dim<T, 32, kDropout>(a, B, st);
    case 64:
      return launch_mma_dim<T, 64, kDropout>(a, B, st);
    case 128:
      return launch_mma_dim<T, 128, kDropout>(a, B, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// the split-TF32 tensor-core kernel (float32)
// ---------------------------------------------------------------------------
// kWarps warps, each owning 16 of the block's kWarps * 16 query rows, as in
// flash_fwd_mma_kernel; both products are `mma_tf32x3` (mma.cuh): every
// operand x is split into big = tf32(x) and small = tf32(x - big) in
// registers, and a . b = al.bh + ah.bl + ah.bh on the TF32 tensor cores with
// float32 accumulators.  P stays float32 and is split like any operand.
//
// The contraction index is permuted on both sides of each product (k-slot
// t is index 2t, k-slot t + 4 is 2t + 1): a lane's Q fragment is one float2
// of each of its rows, its K fragment one float2 of key g, and its P
// fragment its own score accumulators (columns 2t and 2t + 1) as they
// stand, against V's rows 2t and 2t + 1.  `ldmatrix` does not transpose
// 32-bit elements, so fragments are plain shared-memory reads: K's rows are
// padded by 8 floats (a half-warp's 16 float2 reads cover the 32 banks
// once), V's by 4 (a warp's 32 reads of rows 2t, 2t + 1 and column g fall
// in 32 distinct banks).
//
// The block's Q tile stays in shared memory beside the streamed tiles
// (rows padded as K's), and a fragment is read and split at each use: Q
// split once in the registers took 64 of them at D = 64 (and the compiler
// hoists the split of a register copy out of the key loop), which spilled
// beside P V's fresh accumulators.  K and V tiles of 64 keys (32 at
// D = 128) are staged as float32 by cp.async in two stages, in dynamic
// shared memory (88 KB at D = 64 with the 64-row Q tile), eight rows an
// iteration (an unrolled loop holds an address a row, which spilled).  The
// softmax is `softmax_tile`'s, on the accumulators, with p taken from s as
// float32 (its copy rounded to 16 bits is compiled for 16-bit T alone);
// the bias is added to the float32 scores there and never split.
// O is stored from the registers, a float2 a lane a row.
//
// The tensor cores truncate (round toward zero) when they add to an
// accumulator.  Chained over the key loop, that drifts O toward zero by up
// to an ulp a k-step, and the backward's delta = rowsum(dO * O) turns the
// drift into a systematic error: full-width BERT-base's float32 gradients
// missed the CPU's by 2.2e-3 (a query bias; the limit is 1e-3).  So each
// k-step of P V starts from a zero accumulator (`mma_tf32x3_zero`) and is
// added to O on the CUDA cores, rounded to nearest; Q K^T keeps its D / 8
// k-steps in one accumulator.
template <int D>
constexpr int kLdK = D + 8;
template <int D>
constexpr int kLdV = D + 4;

template <int D, int kWarps, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_tf32x3_kernel(MmaArgs<float> a) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kTileM = kWarps * 16;
  constexpr int kTileN = kKeys<D>;
  constexpr int kLk = kLdK<D>, kLv = kLdV<D>;
  constexpr int kKs = D / 8;            // k-steps of Q K^T; D tiles of P V
  extern __shared__ __align__(16) unsigned char ptt_smem[];
  float* k_s = reinterpret_cast<float*>(ptt_smem);  // [2][kTileN][kLk]
  float* v_s = k_s + 2 * kTileN * kLk;              // [2][kTileN][kLv]
  float* q_s = v_s + 2 * kTileN * kLv;              // [kTileM][kLk]

  const int S_q = a.S_q, S_k = a.S_k;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  // causal: the last query tile walks the most keys, so it goes first
  const int q_tile = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = q_tile * kTileM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;  // the warp's first query
  const bool fast = a.bias.p == nullptr && a.scale > 0.f;
  const long long bias_base = b * a.bias.b + h * a.bias.h;

  const float* q_src = a.q + b * a.qb + h * a.qh;
  const float* k_src = a.k + b * a.kb + h * a.kh;
  const float* v_src = a.v + b * a.vb + h * a.vh;
  // causal: keys up to the tile's diagonal; otherwise every key
  const int k_end = a.causal ? min(S_k, q0 + kTileM) : S_k;
  const int n_tiles = (k_end + kTileN - 1) / kTileN;

  ptt::stage_rows_f32<D, kLk, kTileM, kThreads>(q_s, q_src, a.qs, q0, S_q);
  ptt::stage_rows_f32<D, kLk, kTileN, kThreads>(k_s, k_src, a.ks, 0, S_k);
  ptt::stage_rows_f32<D, kLv, kTileN, kThreads>(v_s, v_src, a.vs, 0, S_k);
  ptt::cp_async_commit();

  // the lane's float2 of the warp's row g (r = 0) and g + 8 (r = 1) at dims
  // 8kk + 2t, + 1: step kk's k-slots t and t + 4 of Q's A fragment
  const float* q_w = q_s + (warp * 16 + g) * kLk + 2 * t;
  float o[kKs][4];
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
#pragma unroll
  for (int j = 0; j < kKs; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1, k0 = i * kTileN;
    if (i + 1 < n_tiles) {
      ptt::stage_rows_f32<D, kLk, kTileN, kThreads>(
          k_s + (stage ^ 1) * kTileN * kLk, k_src, a.ks, k0 + kTileN, S_k);
      ptt::stage_rows_f32<D, kLv, kTileN, kThreads>(
          v_s + (stage ^ 1) * kTileN * kLv, v_src, a.vs, k0 + kTileN, S_k);
    }
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();  // tile i has landed; tile i + 1 is in flight
    __syncthreads();
    // a warp wholly past S_q, or (causal) a key tile wholly above the
    // warp's rows, changes nothing
    if (row0 < S_q && (!a.causal || k0 <= row0 + 15)) {
      const float* kt = k_s + stage * kTileN * kLk;
      const float* vt = v_s + stage * kTileN * kLv;
      float s[kTileN / 8][4];
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      // S = Q K^T: B[d][key] is key g's float2 at dims 8kk + 2t, + 1
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t a_hi[4], a_lo[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 x =
              *reinterpret_cast<const float2*>(q_w + r * 8 * kLk + kk * 8);
          ptt::split_tf32(x.x, a_hi[r], a_lo[r]);
          ptt::split_tf32(x.y, a_hi[r + 2], a_lo[r + 2]);
        }
#pragma unroll
        for (int j = 0; j < kTileN / 8; ++j) {
          const float2 x = *reinterpret_cast<const float2*>(
              kt + (j * 8 + g) * kLk + kk * 8 + 2 * t);
          uint32_t b_hi[2], b_lo[2];
          ptt::split_tf32(x.x, b_hi[0], b_lo[0]);
          ptt::split_tf32(x.y, b_hi[1], b_lo[1]);
          ptt::mma_tf32x3(s[j], a_hi, a_lo, b_hi, b_lo);
        }
      }
      uint32_t unused_pf[kTileN / 16][4];  // 16-bit P: not written here
      uint32_t keep[2][2];
      if constexpr (kDropout)
        ptt::row_keep_bits<kTileN>(keep, a.drop, bh, row0, k0, lane);
      const bool edge =
          k0 + kTileN > S_k || (a.causal && k0 + kTileN - 1 > row0);
      if (fast)
        softmax_tile<float, D, true, kDropout>(s, unused_pf, o, m, l, a,
                                               bias_base, row0 + g, k0, t,
                                               edge, keep);
      else
        softmax_tile<float, D, false, kDropout>(s, unused_pf, o, m, l, a,
                                                bias_base, row0 + g, k0, t,
                                                edge, keep);
      // O += P V: the lane's p (keys 8j + 2t, + 1 of rows g, g + 8) against
      // V's rows 8j + 2t and 8j + 2t + 1 at column 8dp + g
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j) {
        uint32_t a_hi[4], a_lo[4];
        ptt::split_tf32(s[j][0], a_hi[0], a_lo[0]);
        ptt::split_tf32(s[j][2], a_hi[1], a_lo[1]);
        ptt::split_tf32(s[j][1], a_hi[2], a_lo[2]);
        ptt::split_tf32(s[j][3], a_hi[3], a_lo[3]);
        const float* v0 = vt + (j * 8 + 2 * t) * kLv + g;
#pragma unroll
        for (int dp = 0; dp < kKs; ++dp) {
          uint32_t b_hi[2], b_lo[2];
          ptt::split_tf32(v0[dp * 8], b_hi[0], b_lo[0]);
          ptt::split_tf32(v0[kLv + dp * 8], b_hi[1], b_lo[1]);
          float step[4];  // this k-step from zero, added to O rounded
          ptt::mma_tf32x3_zero(step, a_hi, a_lo, b_hi, b_lo);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[dp][e] += step[e];
        }
      }
    }
    __syncthreads();  // the stage is free for the copy after next
  }

  // m is in raw units on the fast path
  const float m_scale = fast ? a.scale : 1.f;
  float inv_l[2], lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float l_safe = sum == 0.f ? 1.f : sum;  // no visible key: O = 0
    inv_l[r] = 1.f / l_safe;
    lse[r] = (m[r] == -INFINITY ? 0.f : m[r] * m_scale) + logf(l_safe);
  }
  const long long o_row = static_cast<long long>(a.H) * D;
  float* o_dst = a.o + (static_cast<long long>(b) * S_q * a.H + h) * D + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + g + 8 * r;
    if (qi < S_q) {
#pragma unroll
      for (int j = 0; j < kKs; ++j)
        *reinterpret_cast<float2*>(o_dst + qi * o_row + j * 8) = make_float2(
            o[j][2 * r] * inv_l[r], o[j][2 * r + 1] * inv_l[r]);
      if (t == 0) a.lse[static_cast<long long>(bh) * S_q + qi] = lse[r];
    }
  }
}

template <int D, int kWarps, bool kDropout>
int launch_tf32x3_tile(const MmaArgs<float>& a, int B, cudaStream_t st) {
  constexpr int kTileM = kWarps * 16;
  constexpr int kSmem =
      (2 * kKeys<D> * (kLdK<D> + kLdV<D>) + kTileM * kLdK<D>) * 4;
  static bool configured = false;  // more than 48 KB needs asking for, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tf32x3_kernel<D, kWarps, kDropout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * a.H, (a.S_q + kTileM - 1) / kTileM);
  flash_fwd_tf32x3_kernel<D, kWarps, kDropout>
      <<<grid, kWarps * 32, kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The largest query tile of 64, 32 or 16 rows that still gives every SM a
// block (and is not mostly padding), as launch_mma_dim picks; 16 rows when
// no tile does.
template <int D, bool kDropout>
int launch_tf32x3_dim(const MmaArgs<float>& a, int B, cudaStream_t st) {
  const long long bh = static_cast<long long>(B) * a.H;
  const int sms = ptt::sm_count();
  auto fills = [&](int tile) {
    return a.S_q > tile / 2 && bh * ((a.S_q + tile - 1) / tile) >= sms;
  };
  if (fills(64)) return launch_tf32x3_tile<D, 4, kDropout>(a, B, st);
  if (fills(32)) return launch_tf32x3_tile<D, 2, kDropout>(a, B, st);
  return launch_tf32x3_tile<D, 1, kDropout>(a, B, st);
}

template <bool kDropout>
int launch_tf32x3(const MmaArgs<float>& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch_tf32x3_dim<16, kDropout>(a, B, st);
    case 32:
      return launch_tf32x3_dim<32, kDropout>(a, B, st);
    case 64:
      return launch_tf32x3_dim<64, kDropout>(a, B, st);
    case 128:
      return launch_tf32x3_dim<128, kDropout>(a, B, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// launches of each variant since the library was loaded: [simt, mma,
// tf32x3]
enum Variant { kSimt = 0, kMma = 1, kTf32x3 = 2, kVariants = 3 };
std::atomic<long long> variant_launches[kVariants];

template <typename T>
int dispatch_mma(const void* q, const void* k, const void* v, long long qb,
                 long long qs, long long qh, long long kb, long long ks,
                 long long kh, long long vb, long long vs, long long vh,
                 void* o, void* lse, const ptt::Bias& bias, int B, int S_q,
                 int S_k, int H, int D, float sm_scale, bool causal,
                 const ptt::Dropout& drop, bool dropout, cudaStream_t st) {
  const MmaArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), qb, qs, qh, kb, ks, kh, vb,
                     vs, vh, static_cast<T*>(o), static_cast<float*>(lse),
                     bias, H, S_q, S_k, sm_scale, causal, drop};
  return dropout ? launch_mma<T, true>(a, B, D, st)
                 : launch_mma<T, false>(a, B, D, st);
}

}  // namespace

// q: [B, S_q, H, D], k and v: [B, S_k, H, D], with the given element
// strides over (b, s, h) and unit stride over d; o: [B, S_q, H, D]
// contiguous; lse: [B*H, S_q] float32.  bias: NULL, or float32
// [B, H, S_q, S_k] with element strides (bias_b, bias_h, bias_q, bias_k),
// any of them 0.  causal: 0 or 1 (top-left: query i sees key j <= i).
// dropout_p in [0, 1]: the weights' dropout (dropout.cuh) with the 64-bit
// `seed` and `step` (NULL, or a device pointer to the Philox counter's
// fourth word); 0 launches the kernels without it.
extern "C" int ptt_flash_attention_fwd(
    const void* q, const void* k, const void* v, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, void* o, void* lse, const void* bias,
    long long bias_b, long long bias_h, long long bias_q, long long bias_k,
    int B, int S_q, int S_k, int H, int D, float sm_scale, int causal,
    unsigned long long seed, const void* step, float dropout_p, int dtype,
    void* stream) {
  if (B <= 0 || S_q <= 0 || S_k <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ptt::Bias bs{static_cast<const float*>(bias), bias_b, bias_h, bias_q,
                     bias_k};
  if ((dtype != ptt::kF32 && dtype != ptt::kBF16 && dtype != ptt::kF16) ||
      !(dropout_p >= 0.f) || dropout_p > 1.f)
    return static_cast<int>(cudaErrorInvalidValue);
  const ptt::Dropout drop = ptt::Dropout::make(seed, dropout_p, step);
  const bool dropout = dropout_p > 0.f;
  const int esize = dtype == ptt::kF32 ? 4 : 2;
  const bool aligned = ptt::aligned_16(q, qb, qs, qh, esize) &&
                       ptt::aligned_16(k, kb, ks, kh, esize) &&
                       ptt::aligned_16(v, vb, vs, vh, esize) &&
                       ptt::aligned_16(o, 0, 0, 0);
  const Variant variant = !aligned              ? kSimt
                          : dtype == ptt::kF32 ? kTf32x3
                                               : kMma;
  ++variant_launches[variant];
  if (variant == kTf32x3) {
    const MmaArgs<float> a{static_cast<const float*>(q),
                           static_cast<const float*>(k),
                           static_cast<const float*>(v), qb, qs, qh, kb, ks,
                           kh, vb, vs, vh, static_cast<float*>(o),
                           static_cast<float*>(lse), bs, H, S_q, S_k,
                           sm_scale, causal != 0, drop};
    return dropout ? launch_tf32x3<true>(a, B, D, st)
                   : launch_tf32x3<false>(a, B, D, st);
  }
#define PTT_FLASH_ARGS                                                     \
  q, k, v, qb, qs, qh, kb, ks, kh, vb, vs, vh, o, lse, bs, B, S_q, S_k, H, \
      D, sm_scale, causal != 0, drop
  if (variant == kMma)
    return dtype == ptt::kF16
               ? dispatch_mma<__half>(PTT_FLASH_ARGS, dropout, st)
               : dispatch_mma<__nv_bfloat16>(PTT_FLASH_ARGS, dropout, st);
  if (dtype == ptt::kF32)
    return dropout ? launch<float, true>(PTT_FLASH_ARGS, st)
                   : launch<float, false>(PTT_FLASH_ARGS, st);
  if (dtype == ptt::kF16)
    return dropout ? launch<__half, true>(PTT_FLASH_ARGS, st)
                   : launch<__half, false>(PTT_FLASH_ARGS, st);
  return dropout ? launch<__nv_bfloat16, true>(PTT_FLASH_ARGS, st)
                 : launch<__nv_bfloat16, false>(PTT_FLASH_ARGS, st);
#undef PTT_FLASH_ARGS
}

namespace {

// One thread per (plane, query, 8-key group): the keep mask as 0 / 1 bytes.
__global__ void dropout_mask_kernel(unsigned char* __restrict__ out,
                                    ptt::Dropout d, long long rows, int S_q,
                                    int S_k) {
  const int groups = (S_k + 7) / 8;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= rows * groups) return;
  const long long row = i / groups;  // plane * S_q + query
  const int group = static_cast<int>(i % groups);
  const uint32_t bits = ptt::keep_byte(d, static_cast<int>(row / S_q),
                                       static_cast<int>(row % S_q), group);
  unsigned char* dst = out + row * S_k + 8 * group;
  for (int e = 0; e < 8 && 8 * group + e < S_k; ++e)
    dst[e] = (bits >> e) & 1u;
}

}  // namespace

// The keep mask the attention kernels apply with (seed, step, dropout_p),
// as bytes (1 = kept) over [planes, S_q, S_k] (planes = B * H, in b * H + h
// order): the mask through the kernels' own device function, for the
// tests to hold against the plain version.
extern "C" int ptt_flash_dropout_mask(void* out, unsigned long long seed,
                                      const void* step, float dropout_p,
                                      int planes, int S_q, int S_k,
                                      void* stream) {
  if (planes <= 0 || S_q <= 0 || S_k <= 0) return 0;
  if (!(dropout_p >= 0.f) || dropout_p > 1.f)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(planes) * S_q;
  const long long n = rows * ((S_k + 7) / 8);
  dropout_mask_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(out),
      ptt::Dropout::make(seed, dropout_p, step), rows, S_q, S_k);
  return static_cast<int>(cudaGetLastError());
}

// How many launches took the CUDA-core kernel (variant 0), the 16-bit
// tensor-core kernel (variant 1) or the split-TF32 kernel (variant 2) since
// the library was loaded.
extern "C" long long ptt_flash_attention_fwd_variant_launches(int variant) {
  return variant >= 0 && variant < kVariants
             ? variant_launches[variant].load()
             : -1;
}
