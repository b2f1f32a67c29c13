// Flash-attention forward (FlashAttention-2 style): causal or not, with an
// optional additive float32 bias (the attention mask).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (called
// from `_fwd_call`) in all its forms: causal and not, with and without
// `has_bias`.  At the serving path's prefill shapes and BERT's (S = 128,
// 12 heads of 64) the work is small and the bound is operations, not
// bytes: each query row costs 4 * keys * D flops against one read of q, k
// and v.
//
// Design for the card (not the TPU's block-by-block grid): one block per
// (batch*head, 64-row query tile), 256 threads, four threads per query row,
// each owning D/4 interleaved dims of q and of the output accumulator (so a
// warp reading one shared-memory key row touches four consecutive banks).
// K and V tiles of 32 keys are staged in shared memory as float32; scores
// stay in registers; the online softmax (running max m, normaliser l)
// runs in float32.  Scores follow the reference's `_scores`: scale, add the
// bias, then the causal replace.  Causal: the key loop stops at the tile's
// diagonal and the diagonal tile is masked; otherwise it runs over all S
// keys.  The bias is read through four element strides (b, h, q, k), 0
// where it is broadcast, so a [B, 1, 1, S] padding mask is never
// materialised as [B*H, S, S] as the reference's `_fold_mask` does; its
// 64 x 32 tile is staged in shared memory beside K and V.  A row with no
// visible key (an all -inf bias) gives 0, as the reference's `l_safe`
// does.  q, k and v are read in paddle's [B, S, H, D] layout through
// strides, so the slices of the fused qkv projection need no transpose or
// copy.  O is written [B, S, H, D] contiguous in the input dtype, LSE
// [B*H, S] float32 for the backward.  Any S >= 1: the Pallas divisibility
// refusals were TPU tiling artefacts.  No tensor cores yet (no
// wgmma/TMA): right and simple first.
#include <math.h>

#include "common.cuh"

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
  if (dtype == ptt::kF32)
    return launch<float>(q, k, v, qb, qs, qh, kb, ks, kh, vb, vs, vh, o, lse,
                         bs, B, S, H, D, sm_scale, causal != 0, st);
  if (dtype == ptt::kBF16)
    return launch<__nv_bfloat16>(q, k, v, qb, qs, qh, kb, ks, kh, vb, vs, vh,
                                 o, lse, bs, B, S, H, D, sm_scale,
                                 causal != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
