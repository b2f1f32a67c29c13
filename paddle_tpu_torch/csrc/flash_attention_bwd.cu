// Causal flash-attention backward (FlashAttention-2 style), no mask: dq,
// and dk/dv, as two kernels.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py `_dq_kernel` and
// `_dkv_kernel` (both called from `_bwd_call`) on their causal, unmasked
// form.  At the training path's shapes (B = 8, S = 1024, 12 heads of 64)
// the bound is operations: each (query, key) pair below the diagonal costs
// 6 * D flops in dq and 8 * D in dk/dv, against one read of q, k, v, dO and
// the row statistics.
//
// Design for the card.  The two reductions run in two kernels, as in the
// Pallas code, and neither uses atomics, so every gradient is summed in
// one fixed order and is the same from run to run:
// - dq: one block per (batch*head, 64-query tile).  The block walks the
//   key tiles from 0 up to the diagonal, staging 32 keys of K and V in
//   shared memory, and keeps its rows' q, dO and dq accumulator in
//   registers.
// - dk/dv: one block per (batch*head, 64-key tile).  The block walks the
//   query tiles from the diagonal down to S, staging 32 queries of Q and dO
//   plus their LSE and delta in shared memory, and keeps its rows' k, v and
//   the dk, dv accumulators in registers.
// Both recompute p = exp(s - lse) in float32 from the forward's LSE and
// accumulate in float32; delta = rowsum(dO * O) is computed by the caller
// in PyTorch (as the Pallas caller computes it in XLA).  Four threads own
// a row, each with D/4 interleaved dims (a warp reading a shared-memory
// row hits four consecutive banks), and two shuffles finish each dot
// product.  Every tensor is read through its (batch, seq, head) element
// strides with a unit stride over D, so the slices of the fused qkv
// projection are read in place and dq, dk, dv are written straight into
// the slices of one packed [B, S, 3, H, D] gradient.  Any S >= 1.  No
// tensor cores yet (no wgmma/TMA): right and simple first.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlockRows = 64;  // rows a block owns (queries or keys)
constexpr int kTile = 32;       // rows of the streamed operand per step
constexpr int kThreads = 256;   // 4 threads per owned row

struct Strides {
  long long b, s, h;
};

__host__ __device__ inline long long offset(const Strides& st, int b, int s,
                                            int h) {
  return b * st.b + s * st.s + h * st.h;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, S]
  const float* delta;  // [B*H, S]
  void* d0;            // dq (dq kernel) or dk (dk/dv kernel)
  void* d1;            // dv (dk/dv kernel)
  Strides sq, sk, sv, sdo, sd0, sd1;
  int H, S;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  constexpr int kPer = D / 4;
  __shared__ float k_tile[kTile][D];
  __shared__ float v_tile[kTile][D];
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const int bh = blockIdx.y, S = a.S;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kBlockRows;
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int qi = q0 + r;
  const bool row_ok = qi < S;

  float qreg[kPer], doreg[kPer], acc[kPer];
  const long long q_off = offset(a.sq, b, qi, h);
  const long long do_off = offset(a.sdo, b, qi, h);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = i * 4 + part;
    qreg[i] = row_ok ? ptt::to_f32(q[q_off + d]) * a.scale : 0.f;
    doreg[i] = row_ok ? ptt::to_f32(dout[do_off + d]) : 0.f;
    acc[i] = 0.f;
  }
  const long long row = static_cast<long long>(bh) * S + qi;
  const float lse = row_ok ? a.lse[row] : 0.f;
  const float delta = row_ok ? a.delta[row] : 0.f;

  const long long k_base = offset(a.sk, b, 0, h);
  const long long v_base = offset(a.sv, b, 0, h);
  const int k_end = min(S, q0 + kBlockRows);  // causal: keys to the diagonal
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int j = e / D, c = e % D, kj = k0 + j;
      k_tile[j][c] = kj < S ? ptt::to_f32(k[k_base + kj * a.sk.s + c]) : 0.f;
      v_tile[j][c] = kj < S ? ptt::to_f32(v[v_base + kj * a.sv.s + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s += qreg[i] * k_tile[j][i * 4 + part];
        dp += doreg[i] * v_tile[j][i * 4 + part];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      // kj <= qi < S: a visible key of a real row; everything else is 0
      const float p = (row_ok && k0 + j <= qi) ? expf(s - lse) : 0.f;
      const float ds = p * (dp - delta) * a.scale;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] += ds * k_tile[j][i * 4 + part];
    }
  }

  if (row_ok) {
    T* dq = static_cast<T*>(a.d0) + offset(a.sd0, b, qi, h);
#pragma unroll
    for (int i = 0; i < kPer; ++i) dq[i * 4 + part] = ptt::from_f32<T>(acc[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  constexpr int kPer = D / 4;
  __shared__ float q_tile[kTile][D];
  __shared__ float do_tile[kTile][D];
  __shared__ float lse_tile[kTile];
  __shared__ float delta_tile[kTile];
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const int bh = blockIdx.y, S = a.S;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kBlockRows;
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int kj = k0 + r;
  const bool row_ok = kj < S;

  float kreg[kPer], vreg[kPer], dk[kPer], dv[kPer];
  const long long k_off = offset(a.sk, b, kj, h);
  const long long v_off = offset(a.sv, b, kj, h);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = i * 4 + part;
    kreg[i] = row_ok ? ptt::to_f32(k[k_off + d]) * a.scale : 0.f;
    vreg[i] = row_ok ? ptt::to_f32(v[v_off + d]) : 0.f;
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  const long long q_base = offset(a.sq, b, 0, h);
  const long long do_base = offset(a.sdo, b, 0, h);
  const long long stat_base = static_cast<long long>(bh) * S;
  // causal: only queries at or after this tile's first key see it
  for (int q0 = k0; q0 < S; q0 += kTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int i = e / D, c = e % D, qi = q0 + i;
      q_tile[i][c] = qi < S ? ptt::to_f32(q[q_base + qi * a.sq.s + c]) : 0.f;
      do_tile[i][c] =
          qi < S ? ptt::to_f32(dout[do_base + qi * a.sdo.s + c]) : 0.f;
    }
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      lse_tile[threadIdx.x] = qi < S ? a.lse[stat_base + qi] : 0.f;
      delta_tile[threadIdx.x] = qi < S ? a.delta[stat_base + qi] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        s += kreg[c] * q_tile[i][c * 4 + part];
        dp += vreg[c] * do_tile[i][c * 4 + part];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const int qi = q0 + i;
      // kj <= qi < S: a real key seen by a real query; else 0
      const float p =
          (row_ok && kj <= qi && qi < S) ? expf(s - lse_tile[i]) : 0.f;
      const float ds = p * (dp - delta_tile[i]) * a.scale;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        dv[c] += p * do_tile[i][c * 4 + part];
        dk[c] += ds * q_tile[i][c * 4 + part];
      }
    }
  }

  if (row_ok) {
    T* dkp = static_cast<T*>(a.d0) + offset(a.sd0, b, kj, h);
    T* dvp = static_cast<T*>(a.d1) + offset(a.sd1, b, kj, h);
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      dkp[c * 4 + part] = ptt::from_f32<T>(dk[c]);
      dvp[c * 4 + part] = ptt::from_f32<T>(dv[c]);
    }
  }
}

template <typename T, bool kDq>
int launch(const Args& a, int B, int D, cudaStream_t st) {
  const dim3 grid((a.S + kBlockRows - 1) / kBlockRows, B * a.H);
#define PTT_FLASH_BWD_CASE(DIM)                                            \
  case DIM:                                                                \
    if constexpr (kDq)                                                     \
      flash_dq_kernel<T, DIM><<<grid, kThreads, 0, st>>>(a);               \
    else                                                                   \
      flash_dkv_kernel<T, DIM><<<grid, kThreads, 0, st>>>(a);              \
    break;
  switch (D) {
    PTT_FLASH_BWD_CASE(16)
    PTT_FLASH_BWD_CASE(32)
    PTT_FLASH_BWD_CASE(64)
    PTT_FLASH_BWD_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_FLASH_BWD_CASE
  return static_cast<int>(cudaGetLastError());
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <bool kDq>
int dispatch(const Args& a, int B, int D, int dtype, void* stream) {
  if (B <= 0 || a.S <= 0 || a.H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) return launch<float, kDq>(a, B, D, st);
  if (dtype == ptt::kBF16) return launch<__nv_bfloat16, kDq>(a, B, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, dout, dq: [B, S, H, D] with unit stride over d; `strides` is a
// host array of their (b, s, h) element strides, in that order (15
// values).  lse, delta: [B*H, S] float32.
extern "C" int ptt_flash_attention_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, const long long* strides,
                                      int B, int S, int H, int D,
                                      float sm_scale, int dtype,
                                      void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr,
         strides_at(strides, 0), strides_at(strides, 1),
         strides_at(strides, 2), strides_at(strides, 3),
         strides_at(strides, 4), Strides{0, 0, 0}, H, S, sm_scale};
  return dispatch<true>(a, B, D, dtype, stream);
}

// As above, with dk and dv as the outputs; `strides` holds the (b, s, h)
// strides of q, k, v, dout, dk, dv (18 values).
extern "C" int ptt_flash_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv,
                                       const long long* strides, int B,
                                       int S, int H, int D, float sm_scale,
                                       int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dk, dv,
         strides_at(strides, 0), strides_at(strides, 1),
         strides_at(strides, 2), strides_at(strides, 3),
         strides_at(strides, 4), strides_at(strides, 5), H, S, sm_scale};
  return dispatch<false>(a, B, D, dtype, stream);
}
