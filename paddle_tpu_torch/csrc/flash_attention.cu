// Flash-attention forward (FlashAttention-2 style): causal or not, with an
// optional additive float32 bias (the attention mask).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (called
// from `_fwd_call`) in all its forms: causal and not, with and without
// `has_bias`.  At the serving path's prefill shapes and the training paths'
// (S = 128 to 1024, 12 heads of 64) the bound is operations, not bytes:
// each visible (query, key) pair costs 4 * D flops against one read of q,
// k and v.
//
// Two hand-written kernels; the C entry picks one from the dtype and the
// operands' alignment alone:
//
// `flash_fwd_mma_kernel` (bf16 whose base pointers and (b, s, h) strides
// are 16-byte multiples: every path of the models) does both products on
// the tensor cores, `mma.sync.m16n8k16` with bf16 operands and float32
// accumulators.  A block owns a tile of 16 to 128 query rows of one
// (batch, head); each warp owns 16 of them and keeps the score tile
// S = Q K^T, the running max and sum and the output accumulator in
// registers for the whole key loop; the block's Q tile stays in shared
// memory beside the streamed tiles.  K and V tiles of 64 keys (32 at
// D = 128) stay bf16 in shared memory, filled by 16-byte `cp.async` copies
// in two stages, so the next tile is in flight while this one is
// multiplied; rows are padded by 16 bytes, which spreads the eight rows of
// an `ldmatrix` over all 32 banks.  K fragments come from `ldmatrix`, V's
// from `ldmatrix.trans` (its contracted dimension is the row).  The softmax
// runs in float32 on the accumulators, in the reference's order (scale, add
// the bias, causal replace), the row max over the four lanes of a quad; P
// is rounded to bf16 in registers, as the reference rounds it to V's type,
// and is the A operand of P V as it stands.  The bias is read from device
// memory (L2) at each accumulator entry through its four strides and is
// never folded into a bf16 operand: a row masked by -1e30 everywhere
// absorbs the dot in float32 and stays a uniform average.  Without a bias
// the scale is folded into the exponent (one FFMA and one ex2 an entry).
// Causal: the key loop stops at the tile's diagonal, a warp skips key tiles
// wholly above its rows, and the heaviest query tiles are scheduled first.
// The query tile shrinks (128, 64, 32, 16 rows) until the grid has a block
// for every SM, so a one-sequence prefill still spreads over the card.  O
// leaves through the block's Q tile in shared memory as 16-byte stores.
//
// `flash_fwd_kernel` (float32, where TF32 would not hold the parity limits,
// and bf16 operands that are not 16-byte aligned) runs on the CUDA cores:
// one block per (batch*head, 64-row query tile), 256 threads, four threads
// per query row, each owning D/4 interleaved dims of q and of the output
// accumulator.  K and V tiles of 32 keys are staged in shared memory as
// float32; scores stay in registers; the online softmax runs in float32.
//
// Both: scores follow the reference's `_scores`.  The bias is read through
// four element strides (b, h, q, k), 0 where it is broadcast, so a
// [B, 1, 1, S] padding mask is never materialised as [B*H, S, S] as the
// reference's `_fold_mask` does.  A row with no visible key (an all -inf
// bias) gives 0, as the reference's `l_safe` does.  q, k and v are read in
// paddle's [B, S, H, D] layout through strides, so the slices of the fused
// qkv projection need no transpose or copy.  O is written [B, S, H, D]
// contiguous in the input dtype, LSE [B*H, S] float32 (natural log) for the
// backward.  Any S >= 1: the Pallas divisibility refusals were TPU tiling
// artefacts.
#include <math.h>

#include <atomic>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kThreads = 256;  // 4 threads per query row

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, long long qb, long long qs,
                     long long qh, long long kb, long long ks, long long kh,
                     long long vb, long long vs, long long vh,
                     T* __restrict__ o, float* __restrict__ lse,
                     ptt::Bias bias, int H, int S, float sm_scale,
                     bool causal) {
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
    qreg[i] = qi < S ? ptt::to_f32(q[b * qb + qi * qs + h * qh + d]) * sm_scale
                     : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const long long k_base = b * kb + h * kh, v_base = b * vb + h * vh;
  // causal: keys up to the tile's diagonal; otherwise every key
  const int k_end = causal ? min(S, q0 + kBlockQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = threadIdx.x; e < kBlockK * D; e += kThreads) {
      const int j = e / D, c = e % D, kj = k0 + j;
      k_tile[j][c] = kj < S ? ptt::to_f32(k[k_base + kj * ks + c]) : 0.f;
      v_tile[j][c] = kj < S ? ptt::to_f32(v[v_base + kj * vs + c]) : 0.f;
    }
    if (has_bias) bias.stage<kBlockQ, kBlockK>(b_tile, b, h, q0, k0, S, S);
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
      s[j] = (kj < S && (!causal || kj <= qi)) ? dot : -INFINITY;
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
      const float p = expf(s[j] - m_use);
      p_sum += p;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] += p * v_tile[j][i * 4 + part];
    }
    l = l * alpha + p_sum;
    m = m_new;
  }

  if (qi < S) {
    T* orow = o + ((static_cast<long long>(b) * S + qi) * H + h) * D;
    const float l_safe = l == 0.f ? 1.f : l;  // no visible key: O = 0
    const float inv_l = 1.f / l_safe;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      orow[i * 4 + part] = ptt::from_f32<T>(acc[i] * inv_l);
    if (part == 0)
      lse[static_cast<long long>(bh) * S + qi] =
          (m == -INFINITY ? 0.f : m) + logf(l_safe);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, long long qb,
           long long qs, long long qh, long long kb, long long ks,
           long long kh, long long vb, long long vs, long long vh, void* o,
           void* lse, const ptt::Bias& bias, int B, int S, int H, int D,
           float sm_scale, bool causal, cudaStream_t st) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  float* lp = static_cast<float*>(lse);
#define PTT_FLASH_CASE(DIM)                                                  \
  case DIM:                                                                  \
    flash_fwd_kernel<T, DIM><<<grid, kThreads, 0, st>>>(                     \
        qp, kp, vp, qb, qs, qh, kb, ks, kh, vb, vs, vh, op, lp, bias, H, S,  \
        sm_scale, causal);                                                   \
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

struct MmaArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
  __nv_bfloat16* o;
  float* lse;
  ptt::Bias bias;
  int H, S;
  float scale;
  bool causal;
};

// One 16-row tile's online-softmax step over a staged tile's scores, on the
// accumulators.  In: s = Q K^T (raw dots).  Out: s = p (float32), pf = p
// rounded to bf16 as the A operand of P V; m, l and o brought up to date.
// Lane (g, t) holds rows g (entries 0, 1) and g + 8 (entries 2, 3).
//
// kFast (no bias, scale > 0): the max is taken over the raw dots and
// p = 2^(s * c - m * c) with c = scale * log2(e), one FFMA and one ex2 an
// entry; m is kept in raw units.  Otherwise x = s * scale + bias in natural
// units and p = 2^((x - m) * log2(e)): the difference is formed first, so a
// row masked everywhere by -1e30 gives exactly 2^0 whatever the rounding.
template <int D, bool kFast>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kKeys<D> / 8][4], uint32_t (&pf)[kKeys<D> / 16][4],
    float (&o)[D / 8][4], float (&m)[2], float (&l)[2], const MmaArgs& a,
    long long bias_base, int r0, int k0, int t, bool edge) {
  constexpr int kTileN = kKeys<D>;
  const int S = a.S;
  if constexpr (!kFast) {
    const bool has_bias = a.bias.p != nullptr;
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = r0 + (e >> 1) * 8, kj = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * a.scale;
        if (has_bias && qi < S && kj < S)
          x += a.bias.p[bias_base + qi * a.bias.q + kj * a.bias.k];
        s[j][e] = x;
      }
    }
  }
  if (edge) {  // keys past S, or past a row's diagonal
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = r0 + (e >> 1) * 8, kj = k0 + j * 8 + 2 * t + (e & 1);
        if (kj >= S || (a.causal && kj > qi)) s[j][e] = -INFINITY;
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
  // two score tiles side by side are one A operand
#pragma unroll
  for (int kk = 0; kk < kTileN / 16; ++kk) {
    pf[kk][0] = ptt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pf[kk][1] = ptt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pf[kk][2] = ptt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pf[kk][3] = ptt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// kWarps warps, each owning 16 of the block's kWarps * 16 query rows.
template <int D, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_mma_kernel(MmaArgs a) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kTileM = kWarps * 16;
  constexpr int kTileN = kKeys<D>;
  constexpr int kLd = D + 8;  // padded row, in elements
  constexpr int kKs = D / 16;  // k-steps of Q K^T; pairs of D tiles of P V
  extern __shared__ __align__(16) unsigned char ptt_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(ptt_smem);
  __nv_bfloat16* k_s = q_s + kTileM * kLd;      // [2][kTileN][kLd]
  __nv_bfloat16* v_s = k_s + 2 * kTileN * kLd;  // [2][kTileN][kLd]

  const int S = a.S;
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

  const __nv_bfloat16* q_src = a.q + b * a.qb + h * a.qh;
  const __nv_bfloat16* k_src = a.k + b * a.kb + h * a.kh;
  const __nv_bfloat16* v_src = a.v + b * a.vb + h * a.vh;
  // causal: keys up to the tile's diagonal; otherwise every key
  const int k_end = a.causal ? min(S, q0 + kTileM) : S;
  const int n_tiles = (k_end + kTileN - 1) / kTileN;

  ptt::stage_rows<D, kLd, kTileM, kThreads>(q_s, q_src, a.qs, q0, S);
  ptt::stage_rows<D, kLd, kTileN, kThreads>(k_s, k_src, a.ks, 0, S);
  ptt::stage_rows<D, kLd, kTileN, kThreads>(v_s, v_src, a.vs, 0, S);
  ptt::cp_async_commit();

  // the warp's rows of Q: the A operand, read again for every key tile (128
  // registers at D = 64 leave room for four blocks on an SM)
  __nv_bfloat16* q_w = q_s + warp * 16 * kLd;
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
                                                k0 + kTileN, S);
      ptt::stage_rows<D, kLd, kTileN, kThreads>(v_s + next, v_src, a.vs,
                                                k0 + kTileN, S);
    }
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();  // tile i has landed; tile i + 1 is in flight
    __syncthreads();
    // causal: a key tile wholly above the warp's rows changes nothing
    if (!a.causal || k0 <= row0 + 15) {
      const __nv_bfloat16* kt = k_s + stage * kTileN * kLd;
      const __nv_bfloat16* vt = v_s + stage * kTileN * kLd;
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
          ptt::mma_bf16(s[2 * jp], qf, kf[0], kf[1]);
          ptt::mma_bf16(s[2 * jp + 1], qf, kf[2], kf[3]);
        }
      }
      uint32_t pf[kTileN / 16][4];
      const bool edge = k0 + kTileN > S || (a.causal && k0 + kTileN - 1 > row0);
      if (fast)
        softmax_tile<D, true>(s, pf, o, m, l, a, bias_base, row0 + g, k0, t,
                              edge);
      else
        softmax_tile<D, false>(s, pf, o, m, l, a, bias_base, row0 + g, k0, t,
                               edge);
      // O += P V: B[key][d] contracts V's rows, hence the transposed load
#pragma unroll
      for (int kk = 0; kk < kTileN / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < kKs; ++dp) {
          uint32_t vf[4];
          ptt::ldmatrix_x4_trans(
              vf, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
                      dp * 16 + (lane >> 4) * 8);
          ptt::mma_bf16(o[2 * dp], pf[kk], vf[0], vf[1]);
          ptt::mma_bf16(o[2 * dp + 1], pf[kk], vf[2], vf[3]);
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
        ptt::pack_bf16(o[j][0] * inv_l[0], o[j][1] * inv_l[0]);
    *reinterpret_cast<uint32_t*>(q_w + (g + 8) * kLd + j * 8 + 2 * t) =
        ptt::pack_bf16(o[j][2] * inv_l[1], o[j][3] * inv_l[1]);
  }
  __syncwarp();
  ptt::store_rows_16<D, kLd>(
      q_w, a.o + (static_cast<long long>(b) * S * a.H + h) * D,
      static_cast<long long>(a.H) * D, row0, S);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + g + r * 8;
      if (qi < S) a.lse[static_cast<long long>(bh) * S + qi] = lse[r];
    }
  }
}

template <int D, int kWarps>
int launch_mma_tile(const MmaArgs& a, int B, cudaStream_t st) {
  constexpr int kTileM = kWarps * 16;
  constexpr int kSmem = (kTileM + 4 * kKeys<D>) * (D + 8) * 2;
  static bool configured = false;  // more than 48 KB needs asking for, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D, kWarps>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * a.H, (a.S + kTileM - 1) / kTileM);
  flash_fwd_mma_kernel<D, kWarps><<<grid, kWarps * 32, kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The largest query tile that still gives every SM a block (and is not
// mostly padding); 16 rows when no tile does.
template <int D>
int launch_mma_dim(const MmaArgs& a, int B, cudaStream_t st) {
  const long long bh = static_cast<long long>(B) * a.H;
  const int sms = ptt::sm_count();
  auto fills = [&](int tile) {
    return a.S > tile / 2 && bh * ((a.S + tile - 1) / tile) >= sms;
  };
  if (fills(128)) return launch_mma_tile<D, 8>(a, B, st);
  if (fills(64)) return launch_mma_tile<D, 4>(a, B, st);
  if (fills(32)) return launch_mma_tile<D, 2>(a, B, st);
  return launch_mma_tile<D, 1>(a, B, st);
}

int launch_mma(const MmaArgs& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch_mma_dim<16>(a, B, st);
    case 32:
      return launch_mma_dim<32>(a, B, st);
    case 64:
      return launch_mma_dim<64>(a, B, st);
    case 128:
      return launch_mma_dim<128>(a, B, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// launches of each variant since the library was loaded: [simt, mma]
std::atomic<long long> variant_launches[2];

}  // namespace

// q, k, v: [B, S, H, D] with the given element strides over (b, s, h) and
// unit stride over d; o: [B, S, H, D] contiguous; lse: [B*H, S] float32.
// bias: NULL, or float32 [B, H, S, S] with element strides (bias_b, bias_h,
// bias_q, bias_k), any of them 0.  causal: 0 or 1.
extern "C" int ptt_flash_attention_fwd(
    const void* q, const void* k, const void* v, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, void* o, void* lse, const void* bias,
    long long bias_b, long long bias_h, long long bias_q, long long bias_k,
    int B, int S, int H, int D, float sm_scale, int causal, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ptt::Bias bs{static_cast<const float*>(bias), bias_b, bias_h, bias_q,
                     bias_k};
  if (dtype != ptt::kF32 && dtype != ptt::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool mma = dtype == ptt::kBF16 && ptt::aligned_16(q, qb, qs, qh) &&
                   ptt::aligned_16(k, kb, ks, kh) &&
                   ptt::aligned_16(v, vb, vs, vh) &&
                   ptt::aligned_16(o, 0, 0, 0);
  ++variant_launches[mma];
  if (mma) {
    using bf16 = __nv_bfloat16;
    const MmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), qb, qs, qh, kb, ks, kh, vb,
                    vs, vh, static_cast<bf16*>(o), static_cast<float*>(lse),
                    bs, H, S, sm_scale, causal != 0};
    return launch_mma(a, B, D, st);
  }
  if (dtype == ptt::kF32)
    return launch<float>(q, k, v, qb, qs, qh, kb, ks, kh, vb, vs, vh, o, lse,
                         bs, B, S, H, D, sm_scale, causal != 0, st);
  return launch<__nv_bfloat16>(q, k, v, qb, qs, qh, kb, ks, kh, vb, vs, vh, o,
                               lse, bs, B, S, H, D, sm_scale, causal != 0,
                               st);
}

// How many launches took the CUDA-core kernel (variant 0) or the
// tensor-core kernel (variant 1) since the library was loaded.
extern "C" long long ptt_flash_attention_fwd_variant_launches(int variant) {
  return variant == 0 || variant == 1 ? variant_launches[variant].load() : -1;
}
