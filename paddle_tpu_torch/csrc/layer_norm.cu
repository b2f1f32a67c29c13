// LayerNorm forward over the last dim.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py `_ln_kernel` (called from
// `_ln_fwd_call`).  Bound by bytes: x is read and y written once per
// element, with a handful of flops each.  Two-pass statistics in float32
// match the Pallas kernel's mean-then-centred-variance formula.  Any row
// count and any width: the Pallas `rows % 8` refusal was a TPU tiling
// artefact.
//
// Two hand-written kernels; the C entry picks one from the width and the
// pointers' alignment alone, and counts the choice:
//
// `layer_norm_warp_kernel` (x, y, w and b on 16-byte boundaries, the width a
// multiple of one 16-byte vector and at most 256 of them: every path of the
// models) gives each row one warp, eight rows a block.  The row is read
// once, as 16-byte vectors (8 bf16 or 4 float32, lane i taking vectors
// i, i + 32, ...: three a lane at N = 768 bf16), into registers, where it
// stays packed; both passes of the statistics run on those registers and
// finish with warp shuffles, with no shared memory and no block barrier;
// y leaves as 16-byte vectors.  w and b are loaded as vectors beside x
// (a float32 w and b beside 16-bit x, two 16-byte vectors each for a
// vector of x, are read in the last pass instead).
//
// x and y are float32, bfloat16 or float16; w and b are x's type, or
// float32 beside 16-bit x (AMP-O1: a float32 LayerNorm weight meets a
// 16-bit activation, as BERT's MLM head does under `auto_cast`).  The
// Pallas kernel reads both as float32 (layer_norm.py:27), and so does each
// kernel here: W, the weight's type, is a template parameter, and y is
// written in x's type.
//
// `layer_norm_fwd_kernel` (every other width or alignment) gives each row a
// block of 256 threads (512 from N = 4096) with scalar loads; the row is
// read three times (mean, centred variance, normalise), the second and
// third reads hitting L1/L2, and each statistic takes a block-wide sum.
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

template <typename T, typename W>
__global__ void layer_norm_fwd_kernel(const T* __restrict__ x,
                                      const W* __restrict__ w,
                                      const W* __restrict__ b,
                                      T* __restrict__ y,
                                      float* __restrict__ mean_out,
                                      float* __restrict__ rstd_out, int n,
                                      float eps) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * n;
  T* yr = y + row * n;

  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += ptt::to_f32(xr[i]);
  const float mean = ptt::block_sum(s, red) / n;

  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = ptt::to_f32(xr[i]) - mean;
    ss += d * d;
  }
  const float rstd = rsqrtf(ptt::block_sum(ss, red) / n + eps);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float xh = (ptt::to_f32(xr[i]) - mean) * rstd;
    yr[i] = ptt::from_f32<T>(xh * ptt::to_f32(w[i]) + ptt::to_f32(b[i]));
  }
  if (threadIdx.x == 0) {
    if (mean_out != nullptr) mean_out[row] = mean;
    if (rstd_out != nullptr) rstd_out[row] = rstd;
  }
}

constexpr int kRowsPerBlock = 8;  // one warp a row
constexpr int kMaxVecs = 8;       // 16-byte vectors a lane, at most

// kVecs: 16-byte vectors a lane holds, ceil(n / kN / 32).
template <typename T, typename W, int kVecs>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    layer_norm_warp_kernel(const T* __restrict__ x, const W* __restrict__ w,
                           const W* __restrict__ b, T* __restrict__ y,
                           float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, long long rows,
                           int n, float eps) {
  using V = ptt::Vec16<T>;
  constexpr int kN = V::kN;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int nv = n / kN;  // vectors in a row
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * n);

  // the row stays as the 16-byte vectors it was read in, unpacked again in
  // each pass: half the registers of float copies
  // w and b of x's type are held beside x from the start; float32 ones
  // (twice the registers) are read in the last pass, from L1
  constexpr bool kHold = sizeof(W) == sizeof(T);
  uint4 xv[kVecs];
  ptt::VecN<W, kN> wv[kHold ? kVecs : 1], bv[kHold ? kVecs : 1];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = i * 32 + lane;
    if (kVecs * 32 <= nv || c < nv) {
      xv[i] = xr[c];
      if constexpr (kHold) {
        wv[i].load(w + c * kN);
        bv[i].load(b + c * kN);
      }
    }
  }
  float f[kN];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (kVecs * 32 <= nv || i * 32 + lane < nv) {
      V::unpack(xv[i], f);
#pragma unroll
      for (int e = 0; e < kN; ++e) s += f[e];
    }
  }
  const float mean = ptt::warp_sum(s) / n;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (kVecs * 32 <= nv || i * 32 + lane < nv) {
      V::unpack(xv[i], f);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float d = f[e] - mean;
        ss += d * d;
      }
    }
  }
  const float rstd = rsqrtf(ptt::warp_sum(ss) / n + eps);

  uint4* yr = reinterpret_cast<uint4*>(y + row * n);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = i * 32 + lane;
    if (kVecs * 32 <= nv || c < nv) {
      float wf[kN], bf[kN];
      V::unpack(xv[i], f);
      if constexpr (kHold) {
        wv[i].unpack(wf);
        bv[i].unpack(bf);
      } else {
        wv[0].load(w + c * kN);
        wv[0].unpack(wf);
        bv[0].load(b + c * kN);
        bv[0].unpack(bf);
      }
#pragma unroll
      for (int e = 0; e < kN; ++e) f[e] = (f[e] - mean) * rstd * wf[e] + bf[e];
      yr[c] = V::pack(f);
    }
  }
  if (lane == 0) {
    if (mean_out != nullptr) mean_out[row] = mean;
    if (rstd_out != nullptr) rstd_out[row] = rstd;
  }
}

template <typename T, typename W>
int launch_warp(const T* x, const W* w, const W* b, T* y, float* mean,
                float* rstd, long long rows, int n, float eps,
                cudaStream_t st) {
  const int vecs = (n / ptt::Vec16<T>::kN + 31) / 32;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  switch (vecs) {
#define PTT_LN_CASE(K)                                                      \
  case K:                                                                   \
    layer_norm_warp_kernel<T, W, K><<<blocks, kRowsPerBlock * 32, 0, st>>>( \
        x, w, b, y, mean, rstd, rows, n, eps);                              \
    break;
    PTT_LN_CASE(1)
    PTT_LN_CASE(2)
    PTT_LN_CASE(3)
    PTT_LN_CASE(4)
    PTT_LN_CASE(5)
    PTT_LN_CASE(6)
    PTT_LN_CASE(7)
    PTT_LN_CASE(8)
#undef PTT_LN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch(const void* x, const void* w, const void* b, void* y, void* mean,
           void* rstd, long long rows, int n, float eps, bool warp,
           cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const W* wt = static_cast<const W*>(w);
  const W* bt = static_cast<const W*>(b);
  T* yt = static_cast<T*>(y);
  float* mt = static_cast<float*>(mean);
  float* rt = static_cast<float*>(rstd);
  if (warp)
    return launch_warp<T, W>(xt, wt, bt, yt, mt, rt, rows, n, eps, st);
  const int threads = n >= 4096 ? 512 : 256;
  layer_norm_fwd_kernel<T, W><<<rows, threads, 0, st>>>(xt, wt, bt, yt, mt,
                                                         rt, n, eps);
  return static_cast<int>(cudaGetLastError());
}

// launches of each variant since the library was loaded: [block, warp]
std::atomic<long long> variant_launches[2];

}  // namespace

// x, y: [rows, n] contiguous in `dtype`; w, b: [n] contiguous in
// `wdtype`, which is `dtype` or float32 beside a 16-bit `dtype`;
// mean/rstd: [rows] float32 or null.
extern "C" int ptt_layer_norm_fwd(const void* x, const void* w, const void* b,
                                  void* y, void* mean, void* rstd,
                                  long long rows, int n, float eps, int dtype,
                                  int wdtype, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const bool mixed = dtype != ptt::kF32 && wdtype == ptt::kF32;
  if ((dtype != ptt::kF32 && dtype != ptt::kBF16 && dtype != ptt::kF16) ||
      (wdtype != dtype && !mixed))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_vec = dtype == ptt::kF32 ? 4 : 8;  // elements in 16 bytes
  const bool warp = n % per_vec == 0 && n <= 32 * kMaxVecs * per_vec &&
                    ptt::aligned_16(x) && ptt::aligned_16(w) &&
                    ptt::aligned_16(b) && ptt::aligned_16(y);
  ++variant_launches[warp];
#define PTT_LN_ARGS x, w, b, y, mean, rstd, rows, n, eps, warp, st
  if (dtype == ptt::kF32) return launch<float, float>(PTT_LN_ARGS);
  if (dtype == ptt::kBF16)
    return mixed ? launch<__nv_bfloat16, float>(PTT_LN_ARGS)
                 : launch<__nv_bfloat16, __nv_bfloat16>(PTT_LN_ARGS);
  return mixed ? launch<__half, float>(PTT_LN_ARGS)
               : launch<__half, __half>(PTT_LN_ARGS);
#undef PTT_LN_ARGS
}

// How many launches took the block-per-row kernel (variant 0) or the
// warp-per-row vector kernel (variant 1) since the library was loaded.
extern "C" long long ptt_layer_norm_variant_launches(int variant) {
  return variant == 0 || variant == 1 ? variant_launches[variant].load() : -1;
}
